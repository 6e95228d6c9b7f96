"""The port's `ode/flow.py` (the plain reference the kernels are held
against) against the JAX package's, on the same weights, inputs and eps.

JAX's `ode_sample` draws x0 with eps = normal(key, (n, 2)); the port is
handed that eps. Tolerances: float32 on both sides, summed in other orders;
T=4 Euler steps and products of dets amplify ulps, so x is held to 1e-5
absolute and pdfs to 1e-4 relative.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.ode import flow as jflow
from bsdf_diffusion_sampling_tpu_torch.ode import flow as tflow

from _torch_port import T, disk_setup, tt

X_ATOL = 1e-5
PDF_RTOL = 1e-4


def _sample_jax(s, key):
    return jflow.ode_sample("disk", s.v, s.b, jnp.asarray(s.omega), s.cond, key, T)


def test_ode_sample_from_same_eps_matches_jax():
    s = disk_setup()
    key = jax.random.key(11)
    x, pdf = _sample_jax(s, key)
    eps = tt(jax.random.normal(key, (s.n, 2)))
    tx, tpdf = tflow.ode_sample("disk", s.tv, s.tb, s.t_omega, s.t_cond, T, eps=eps)
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), atol=X_ATOL)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(pdf), rtol=PDF_RTOL)


def test_ode_sample_from_given_x0():
    s = disk_setup()
    eps = tt(s.rng.standard_normal((s.n, 2)))
    x0 = tflow.get_base("disk").sample(s.tb, s.t_omega, eps)
    a = tflow.ode_sample("disk", s.tv, s.tb, s.t_omega, s.t_cond, T, eps=eps)
    b = tflow.ode_sample("disk", s.tv, s.tb, s.t_omega, s.t_cond, T, x0=x0)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tflow.ode_sample("disk", s.tv, s.tb, s.t_omega, s.t_cond, T)


def test_velocity_and_jac_matches_jax():
    s = disk_setup()
    x = s.rng.uniform(-0.7, 0.7, (s.n, 2)).astype(np.float32)
    got = tflow._velocity_and_jac("disk", s.tv, tt(x), 0.5, s.t_cond)
    want = jflow._velocity_and_jac("disk", s.v, jnp.asarray(x), jnp.float32(0.5), s.cond)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-5)


def test_ode_pdf_matches_jax():
    s = disk_setup()
    x = s.rng.uniform(-0.7, 0.7, (s.n, 2)).astype(np.float32)
    want = jflow.ode_pdf("disk", s.v, s.b, jnp.asarray(x), jnp.asarray(s.omega), s.cond, T)
    got = tflow.ode_pdf("disk", s.tv, s.tb, tt(x), s.t_omega, s.t_cond, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PDF_RTOL)


@pytest.mark.parametrize("newton_iters", [1, 2])
def test_ode_pdf_exact_matches_jax(newton_iters):
    """At samples of the sampler itself, away from degenerate Jacobians, so
    the port's det guard never fires and JAX's unguarded solve agrees."""
    s = disk_setup()
    x, _ = _sample_jax(s, jax.random.key(12))
    want = jflow.ode_pdf_exact("disk", s.v, s.b, x, jnp.asarray(s.omega), s.cond, T,
                               newton_iters=newton_iters)
    got = tflow.ode_pdf_exact("disk", s.tv, s.tb, tt(x), s.t_omega, s.t_cond, T,
                              newton_iters=newton_iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PDF_RTOL)


def test_ode_sample_only_matches_jax():
    s = disk_setup()
    x0 = s.rng.uniform(-0.7, 0.7, (s.n, 2)).astype(np.float32)
    want = jflow.ode_sample_only("disk", s.v, jnp.asarray(x0), s.cond, T)
    got = tflow.ode_sample_only("disk", s.tv, tt(x0), s.t_cond, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=X_ATOL)


def test_sample_pdf_contract():
    """The exact query at a draw gives back the draw's own pdf (median rel
    < 1e-3), and far closer than reverse Euler does (the contract of
    tests/test_fused_sample_pdf.py:116-140)."""
    s = disk_setup()
    eps = tt(s.rng.standard_normal((s.n, 2)))
    x, pdf = tflow.ode_sample("disk", s.tv, s.tb, s.t_omega, s.t_cond, T, eps=eps)
    exact = tflow.ode_pdf_exact("disk", s.tv, s.tb, x, s.t_omega, s.t_cond, T)
    rev = tflow.ode_pdf("disk", s.tv, s.tb, x, s.t_omega, s.t_cond, T)
    gap_exact = float((exact / pdf - 1).abs().median())
    gap_rev = float((rev / pdf - 1).abs().median())
    assert gap_exact < 1e-3, gap_exact
    assert gap_exact < gap_rev
    x_back, _ = tflow.newton_inverse("disk", s.tv, x, s.t_cond, T)
    x0 = tflow.get_base("disk").sample(s.tb, s.t_omega, eps)
    torch.testing.assert_close(x_back, x0, atol=1e-4, rtol=0)
