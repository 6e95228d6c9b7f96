"""The port's analytic distributions (`utils/distributions1d.py`) against
the JAX package's: pdf and icdf at rtol 1e-5 (atol 1e-6) on the same
points, and samples from explicit uniforms: the port's `sample_from` of the
lattice JAX's `stratified_uniform(key, n)` draws equals JAX's
`sample(key, n)` to the same tolerance. The port's own draws from a
`torch.Generator` are held to scipy by the KS test of the JAX package's
tests/test_utils.py (p > 1e-3).
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from bsdf_diffusion_sampling_tpu.utils import distributions1d as jd
from bsdf_diffusion_sampling_tpu_torch.core.prng import root_generator
from bsdf_diffusion_sampling_tpu_torch.utils import distributions1d as td

RTOL, ATOL = 1e-5, 1e-6


def _custom(lib):
    return lambda x: lib.exp(-((x - 0.3) ** 2) / 0.02) + 0.5 * lib.exp(-((x + 0.4) ** 2) / 0.05) + 0.05


FAMILIES = {
    "uniform": (jd.Uniform(-1.0, 2.0), td.Uniform(-1.0, 2.0), (-1.5, 2.5)),
    "gaussian": (jd.Gaussian(0.3, 0.7), td.Gaussian(0.3, 0.7), (-3.0, 3.5)),
    "truncated_gaussian": (jd.TruncatedGaussian(0.2, 0.5, -0.5, 1.0), td.TruncatedGaussian(0.2, 0.5, -0.5, 1.0),
                           (-1.0, 1.5)),
    "beta": (jd.Beta(2.5, 1.5), td.Beta(2.5, 1.5), (-0.2, 1.2)),
    "straight_line": (jd.StraightLine(), td.StraightLine(), (-0.2, 1.2)),
    "custom": (jd.CustomDistribution(_custom(jnp), -1.0, 1.0), td.CustomDistribution(_custom(torch), -1.0, 1.0),
               (-1.2, 1.2)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pdf_icdf_and_samples_match_jax(family):
    jdist, tdist, (lo, hi) = FAMILIES[family]
    x = np.linspace(lo, hi, 1001, dtype=np.float32)
    np.testing.assert_allclose(tdist.pdf(torch.from_numpy(x)).numpy(), np.asarray(jdist.pdf(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    u = np.random.default_rng(0).uniform(1e-6, 1 - 1e-6, 4096).astype(np.float32)
    np.testing.assert_allclose(tdist.icdf(torch.from_numpy(u)).numpy(), np.asarray(jdist.icdf(jnp.asarray(u))),
                               rtol=RTOL, atol=ATOL)
    key = jax.random.key(3)
    lattice = torch.from_numpy(np.array(jd.stratified_uniform(key, 4096)))
    np.testing.assert_allclose(tdist.sample_from(lattice).numpy(), np.asarray(jdist.sample(key, 4096)),
                               rtol=RTOL, atol=ATOL)


def test_two_d_combination_matches_jax():
    jdist = jd.TwoDCombination(jd.Gaussian(0.0, 0.4), jd.Beta(2.0, 3.0))
    tdist = td.TwoDCombination(td.Gaussian(0.0, 0.4), td.Beta(2.0, 3.0))
    xy = np.random.default_rng(1).uniform(-0.5, 1.0, (2048, 2)).astype(np.float32)
    np.testing.assert_allclose(tdist.pdf(torch.from_numpy(xy)).numpy(), np.asarray(jdist.pdf(jnp.asarray(xy))),
                               rtol=RTOL, atol=ATOL)
    kx, ky = jax.random.split(jax.random.key(4))
    ux, uy = (torch.from_numpy(np.array(jd.stratified_uniform(k, 2048))) for k in (kx, ky))
    np.testing.assert_allclose(tdist.sample_from(ux, uy).numpy(), np.asarray(jdist.sample(jax.random.key(4), 2048)),
                               rtol=RTOL, atol=ATOL)
    s = tdist.sample(root_generator(0, "cpu"), 1000)
    assert s.shape == (1000, 2) and bool(torch.isfinite(s).all())


def test_stratified_uniform_coverage():
    u = td.stratified_uniform(root_generator(0, "cpu"), 1000)
    assert u.shape == (1000,) and u.device == torch.device("cpu")
    assert len(np.unique((u.numpy() * 1000).astype(int))) == 1000  # each stratum once
    assert not torch.equal(u, torch.sort(u).values)  # shuffled


@pytest.mark.parametrize("dist, cdf", [
    (td.Uniform(0.2, 0.8), scipy.stats.uniform(0.2, 0.6).cdf),
    (td.Gaussian(0.3, 0.5), scipy.stats.norm(0.3, 0.5).cdf),
    (td.Beta(2.0, 3.0), scipy.stats.beta(2.0, 3.0).cdf),
    (td.TruncatedGaussian(0.0, 1.0, -0.5, 1.5), scipy.stats.truncnorm(-0.5, 1.5).cdf),
    (td.StraightLine(), lambda v: np.clip(v, 0, 1) ** 2),
], ids=["uniform", "gaussian", "beta", "truncated_gaussian", "straight_line"])
def test_port_draws_match_scipy(dist, cdf):
    x = dist.sample(root_generator(1, "cpu"), 20_000).numpy()
    assert scipy.stats.kstest(x, cdf).pvalue > 1e-3
