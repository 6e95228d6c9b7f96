"""The port's ensemble MCMC (`data/mcmc.py`) against the JAX package's.

The two draw from other streams, so the sampler is held to its
distribution, at the JAX package's own tolerances
(tests/test_mcmc.py:9-25, tests/test_mcmc_external.py:46-56); the support
masks and log densities are held to JAX's on the same points: masks
exactly, log values to 1e-5.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.bsdf import analytic as ja
from bsdf_diffusion_sampling_tpu.data import mcmc as jm
from bsdf_diffusion_sampling_tpu.utils import validation as jv
from bsdf_diffusion_sampling_tpu_torch.bsdf import analytic as ta
from bsdf_diffusion_sampling_tpu_torch.core.prng import root_generator
from bsdf_diffusion_sampling_tpu_torch.data import mcmc as tm
from bsdf_diffusion_sampling_tpu_torch.utils import validation as tv
from bsdf_diffusion_sampling_tpu_torch.utils.reference_np import ggx_pdf_grid_np

from _torch_port import tt

OMEGA_I = np.array([0.35, 0.0], np.float32)
RES = 12


def _targets(domain):
    """(port, JAX) target densities: GGX on the disk and the hemisphere; on
    the full sphere, a smooth lobe that is positive below the horizon too."""
    if domain == "disk":
        return (lambda wi, wo: ta.ggx_shading_disk(wi, wo, 0.4)), (lambda wi, wo: ja.ggx_shading_disk(wi, wo, 0.4))
    if domain == "spherical":
        return ((lambda wi, wo: ta.ggx_shading_spherical(wi, wo, 0.5) * torch.sin(wo[:, 0])),
                (lambda wi, wo: ja.ggx_shading_spherical(wi, wo, 0.5) * jnp.sin(wo[:, 0])))
    return ((lambda wi, wo: torch.sin(wo[:, 0]) * (1.5 + torch.cos(wi[:, 0] - wo[:, 0]))),
            (lambda wi, wo: jnp.sin(wo[:, 0]) * (1.5 + jnp.cos(wi[:, 0] - wo[:, 0]))))


def _points(domain, r_min, r_max, n=2048):
    """Points inside, outside and on the band's edges and the support's."""
    rng = np.random.default_rng(3)
    if domain == "disk":
        r_i = np.concatenate([rng.uniform(0, 1.1, n - 4), [r_min, r_max, np.nextafter(np.float32(r_max), 2),
                                                            np.nextafter(np.float32(r_min), 2)]])
        a_i = rng.uniform(-math.pi, math.pi, n)
        r_o = np.concatenate([rng.uniform(0, 1.05, n - 2), [1.0, 1.0 + 1e-6]])
        a_o = rng.uniform(-math.pi, math.pi, n)
        p = np.stack([r_i * np.cos(a_i), r_i * np.sin(a_i), r_o * np.cos(a_o), r_o * np.sin(a_o)], -1)
        p[-4:, 1] = 0.0  # radii exactly at the bounds
        p[-4:, 0] = r_i[-4:]
    else:
        top = math.pi / 2 if domain == "spherical" else math.pi
        p = np.stack([np.concatenate([rng.uniform(0, top, n - 4), [r_min, r_max, 0.0, top]]),
                      rng.uniform(-3.3, 3.3, n), rng.uniform(-0.1, top + 0.1, n), rng.uniform(-3.3, 3.3, n)], -1)
        p[:8, 3] = [math.pi, -math.pi, 0.0, top, 3.14, -3.14, 1.0, 2.0]
        p[8:12, 2] = [0.0, top, top - 1e-3, 1e-3]
    return p.astype(np.float32)


@pytest.mark.parametrize("domain", ["disk", "spherical", "sphere_full"])
@pytest.mark.parametrize("band", [0, 3])
def test_domain_log_prob_matches_jax(domain, band):
    """Band `band` of 4: its bounds are edges of the points' grid."""
    edge = (1.0 if domain == "disk" else (math.pi if domain == "sphere_full" else math.pi / 2)) / 4
    r_min, r_max = band * edge, (band + 1) * edge
    p = _points(domain, np.float32(r_min), np.float32(r_max))
    t_fn, j_fn = _targets(domain)
    got = tm.make_domain_log_prob(t_fn, domain)(tt(p), torch.tensor(r_min, dtype=torch.float32),
                                                 torch.tensor(r_max, dtype=torch.float32)).numpy()
    want = np.asarray(jm.make_domain_log_prob(j_fn, domain)(jnp.asarray(p), jnp.float32(r_min),
                                                           jnp.float32(r_max)))
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    inside = np.isfinite(want)
    assert 0 < inside.sum() < len(p)
    np.testing.assert_allclose(got[inside], want[inside], atol=1e-5, rtol=1e-5)


def test_ensemble_recovers_gaussian():
    """The correlated 2-D Gaussian of tests/test_mcmc.py:9-25, to its tolerances."""
    cov = np.array([[1.0, 0.6], [0.6, 0.8]])
    prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32)

    def log_prob(x):
        return -0.5 * torch.einsum("ni,ij,nj->n", x, prec, x)

    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 2)).astype(np.float32)) * 3.0
    chain, acc = tm.ensemble_mcmc(root_generator(1, "cpu"), log_prob, x0, nsteps=2500, burn_in=500)
    assert chain.shape == (2500, 64, 2)
    assert 0.1 < float(acc) < 0.9
    s = chain.reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.08)


def test_ensemble_meets_ggx_pdf_grid():
    """The GGX lobe at a fixed omega_i, 64 walkers x 2500 sweeps, against
    the normalised pdf grid at KL < 0.05 (tests/test_mcmc_external.py:56).
    The grid holds each cell's integral (8 x 8 points a cell), which the
    histogram estimates: the cell centres' values, which `ggx_pdf_grid_np`
    gives, differ from it by enough to put a chain of either package near
    KL 0.05 on their own. The port's centre grid equals `ggx_pdf_grid_np`."""
    wi = tt(OMEGA_I)

    def density(x):
        inside = (x**2).sum(-1) < 1.0
        f = ta.ggx_shading_disk(wi.expand(x.shape[0], 2), torch.where(inside[:, None], x, 0.0), roughness=0.4)
        return torch.where(inside, torch.clamp(f, min=0.0), 0.0)

    def log_prob(x):
        f = density(x)
        return torch.where(f > 0, torch.log(torch.clamp(f, min=1e-38)), -math.inf)

    lo, hi = (-1.0, -1.0), (1.0, 1.0)
    centres = tv.pdf_grid_2d(density, lo, hi, bins=RES, device="cpu")
    ref = ggx_pdf_grid_np(OMEGA_I.astype(np.float64), 0.4, res=RES)
    np.testing.assert_allclose(centres / centres.sum(), ref / ref.sum(), rtol=1e-5, atol=1e-7)
    g = root_generator(3, "cpu")
    x0 = -0.5 * wi + 0.05 * torch.randn((64, 2), generator=g)
    chain, acc = tm.ensemble_mcmc(g, log_prob, x0, nsteps=2500, burn_in=500)
    assert 0.1 < float(acc) < 0.9
    hist = tv.histogram_grid_2d(chain.reshape(-1, 2).numpy(), lo, hi, bins=RES)
    kl = tv.kl_divergence_grid(hist, tv.pdf_grid_2d(density, lo, hi, bins=RES, device="cpu", sub=8))
    assert kl < 0.05, kl


@pytest.mark.parametrize("domain", ["disk", "sphere_full"])
def test_batched_bands_stay_in_their_band(domain):
    bands, walkers = 4, 20
    edge = (1.0 if domain == "disk" else math.pi) / bands
    r_min = torch.arange(bands, dtype=torch.float32) * edge
    r_max = r_min + edge
    t_fn, _ = _targets(domain)
    log_prob = tm.make_domain_log_prob(t_fn, domain)
    g = root_generator(5, "cpu")
    # starting points spread over the middle half of each band
    r0 = r_min[:, None] + edge * (0.25 + 0.5 * torch.rand((bands, walkers), generator=g))
    a0 = torch.rand((bands, walkers), generator=g) - 0.5
    if domain == "disk":
        x0 = torch.stack([r0 * torch.cos(a0), r0 * torch.sin(a0), 0.3 * torch.rand((bands, walkers), generator=g)
                          - 0.15, 0.3 * torch.rand((bands, walkers), generator=g) - 0.15], -1)
    else:
        x0 = torch.stack([r0, a0, 0.3 + torch.rand((bands, walkers), generator=g), torch.rand((bands, walkers),
                                                                                             generator=g)], -1)
    assert bool(torch.isfinite(log_prob(x0.reshape(-1, 4), r_min.repeat_interleave(walkers),
                                        r_max.repeat_interleave(walkers))).all())
    chain, acc = tm.ensemble_mcmc(g, log_prob, x0, nsteps=300, burn_in=50, log_prob_args=(r_min, r_max))
    assert chain.shape == (300, bands, walkers, 4) and 0.05 < float(acc) < 0.95
    coord = (chain[..., :2] ** 2).sum(-1).sqrt() if domain == "disk" else chain[..., 0]
    lo, hi = r_min[None, :, None], r_max[None, :, None]
    assert bool(((coord > lo - 1e-6) & (coord <= hi + 1e-6)).all())
    # each band's walkers spread over their band, not stuck at the start
    assert bool((coord.std(dim=(0, 2)) > 0.05 * edge).all())


def test_graph_needs_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tm.ensemble_mcmc(root_generator(0, "cpu"), lambda x: -(x**2).sum(-1), torch.zeros(4, 2), 10, graph=True)


def test_validation_matches_jax():
    rng = np.random.default_rng(2)
    s = rng.normal(0, 0.4, (4000, 2)).astype(np.float32)
    lo, hi = (-1.0, -1.0), (1.0, 1.0)
    h = tv.histogram_grid_2d(s, lo, hi, bins=16)
    np.testing.assert_array_equal(h, jv.histogram_grid_2d(s, lo, hi, bins=16))
    grid_t = tv.pdf_grid_2d(lambda p: torch.exp(-(p**2).sum(-1)), lo, hi, bins=16, device="cpu")
    grid_j = jv.pdf_grid_2d(lambda p: jnp.exp(-(p**2).sum(-1)), lo, hi, bins=16)
    np.testing.assert_allclose(grid_t, grid_j, rtol=1e-6)
    assert tv.kl_divergence_grid(h, grid_t) == pytest.approx(jv.kl_divergence_grid(h, grid_j), rel=1e-6)
