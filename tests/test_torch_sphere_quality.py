"""The check functions of chip_smoke.py's phase 15 (the trained full-sphere
sampler) against the formulas of the JAX package's
tests/test_train_spherical.py, given the same numpy draws and grid: the
transmitted share and the in-range share of the draws (:214-217), the
median sample <-> pdf gap (:232), the (theta, phi) grid and the grid KL
(:138-153, theta over the whole sphere), and the target's own transmitted
share, which for the transmissive toy of :190-202 is its lobe weighting,
0.7 / 1.7. All equal to 1e-6. JAX's test computes the shares and the KL
inline, so for those the expected side is its lines transcribed and the
cases check the transcription only; the grid, the median and the toy
target go through jnp and the JAX package's `ggx_shading_spherical`."""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from bsdf_diffusion_sampling_tpu.bsdf import ggx_shading_spherical

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-6


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _draws(seed: int, n: int = 1 << 14):
    """theta of a full-sphere sampler's draws, a few outside (0, pi), and a
    forward and a reverse pdf a few percent apart, float32 as the card's."""
    rng = np.random.default_rng(seed)
    theta = np.where(rng.random(n) < 0.45, rng.normal(2.2, 0.5, n), rng.normal(0.9, 0.4, n)).astype(np.float32)
    pdf_fwd = rng.gamma(2.0, 0.3, n).astype(np.float32) + np.float32(1e-3)
    pdf_rev = (pdf_fwd * (1 + rng.normal(0.0, 0.05, n))).astype(np.float32)
    return theta, pdf_fwd, pdf_rev


def _jax_grid(nt: int, nphi: int) -> np.ndarray:
    """tests/test_train_spherical.py:138-142 with theta up to pi - 0.02."""
    theta = jnp.linspace(0.02, jnp.pi - 0.02, nt)
    phi = jnp.linspace(-jnp.pi + 0.01, jnp.pi - 0.01, nphi)
    tt, pp = jnp.meshgrid(theta, phi, indexing="ij")
    return np.asarray(jnp.stack([tt.ravel(), pp.ravel()], axis=-1))


def _jax_toy(wi, grid) -> np.ndarray:
    """The transmissive toy target of tests/test_train_spherical.py:190-198."""
    wo = jnp.asarray(grid)
    wi = jnp.broadcast_to(jnp.asarray(wi, jnp.float32), wo.shape)
    refl = ggx_shading_spherical(wi, wo, roughness=0.5, diffuse_prob=0.4)
    trans = ggx_shading_spherical(wi, wo.at[..., 0].set(jnp.pi - wo[..., 0]), roughness=0.5, diffuse_prob=0.4)
    return np.asarray((refl + 0.7 * trans) * jnp.sin(wo[..., 0]))


def _jax_kl(p_tgt, q) -> float:
    """tests/test_train_spherical.py:148-153."""
    p_tgt = np.asarray(p_tgt, np.float64)
    q = np.maximum(np.asarray(q, np.float64), 1e-12)
    p_tgt /= p_tgt.sum()
    q /= q.sum()
    return float(np.sum(p_tgt * np.log(p_tgt / q + 1e-30)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_shares(smoke, seed):
    theta, _, _ = _draws(seed)
    frac_trans = (theta > np.pi / 2).mean()
    in_range = ((theta > -0.3) & (theta < np.pi + 0.3)).mean()
    assert abs(smoke.transmitted_fraction(theta) - frac_trans) <= TOL
    assert abs(smoke.in_range_fraction(theta) - in_range) <= TOL
    assert 0.2 < frac_trans < 0.6 and in_range < 1.0  # the draws reach both sides of each gate


@pytest.mark.parametrize("seed", [0, 1])
def test_median_gap(smoke, seed):
    _, pdf_fwd, pdf_rev = _draws(seed)
    want = float(jnp.median(jnp.abs(jnp.asarray(pdf_rev) / jnp.asarray(pdf_fwd) - 1.0)))
    assert abs(smoke.median_gap(pdf_rev, pdf_fwd) - want) <= TOL


def test_sphere_grid(smoke):
    got = smoke.sphere_grid(*smoke.SPHERE_GRID)
    want = _jax_grid(*smoke.SPHERE_GRID)
    assert got.shape == want.shape == (48 * 96, 2) and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("wi", [(0.7, 0.0), (0.5, -0.3)])
def test_grid_kl(smoke, wi):
    grid = _jax_grid(*smoke.SPHERE_GRID)
    p = _jax_toy(wi, grid)
    rng = np.random.default_rng(3)
    for q in (p, p * np.exp(rng.normal(0.0, 0.3, p.shape)), np.ones_like(p), _jax_toy((wi[0] + 0.4, wi[1]), grid)):
        want = _jax_kl(p, q)
        assert abs(smoke.grid_kl(p, q) - want) <= TOL * max(1.0, abs(want))
    assert smoke.grid_kl(p, p) == pytest.approx(0.0, abs=TOL)


@pytest.mark.parametrize("wi", [(0.7, 0.0), (0.5, -0.3)])
def test_target_share_is_the_toys_lobe_weighting(smoke, wi):
    """The grid is symmetric about the equator, so the toy's transmitted
    share over it is its lobe weighting, the JAX_TOY_TRANSMITTED that
    phase 15 scales JAX's window by."""
    grid = _jax_grid(*smoke.SPHERE_FINE)
    share = smoke.weighted_transmitted(_jax_toy(wi, grid), grid[:, 0])
    assert abs(share - smoke.JAX_TOY_TRANSMITTED) <= TOL
    assert smoke.JAX_TOY_TRANSMITTED == pytest.approx(0.7 / 1.7)
    assert math.isclose(smoke.GATE_TRANSMITTED[0] * share / smoke.JAX_TOY_TRANSMITTED, 0.2, rel_tol=1e-5)
