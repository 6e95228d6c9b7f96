"""The port's tabulated inverse-CDF sampler (`data/tabulated.py`) and its
native host twin (`native/samplewilib.py`) against the JAX package's.

- `build_tabulated`: the same vertex grids on both sides; the disk mask's
  zeros exactly, pmf and CDF to 1e-6 relative (the row sums run in other
  orders, float32);
- `domain_grid`: 1e-6 relative (the two linspaces round the symmetric
  [-pi, pi] range differently, by an ulp);
- `tabulated_pdf` and `sample_tabulated_from_uniforms`: given JAX's table
  and the uniforms `sample_tabulated` draws from its key (split, then (B, n)
  and (B, n, 2) uniforms), equal to JAX's to the bit;
- `sample_tabulated` and `online_sampling`: the distribution, as the JAX
  package's tests/test_tabulated.py holds its own (KL of the histogram
  against the pmf under 0.05, the lobe's mass over 0.95);
- `samplewi_native`: the JAX wrapper's output to the bit for the same pdf
  and seed; the copied source equal to the JAX package's from its
  `#include` lines on.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.data import tabulated as jtab
from bsdf_diffusion_sampling_tpu.native.samplewilib import samplewi_native as jsamplewi
from bsdf_diffusion_sampling_tpu_torch.core.prng import root_generator
from bsdf_diffusion_sampling_tpu_torch.data import tabulated as ttab
from bsdf_diffusion_sampling_tpu_torch.native.samplewilib import samplewi_native
from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build

REPO = Path(__file__).resolve().parents[1]


def _vertices(domain, res, b=3, seed=0):
    grid = ttab.domain_grid(domain, res, device="cpu").numpy()
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-0.5, 0.5, (b, 1, 2)) * (grid.max(0) - grid.min(0)) * 0.5 + grid.mean(0)
    d2 = ((grid[None] - mu) ** 2).sum(-1)
    v = np.exp(-d2 / (2 * 0.3 ** 2)) + 0.01 * rng.random(d2.shape)
    return v.reshape(b, res + 1, res + 1).astype(np.float32)


def _port_table(jt):
    return ttab.Tabulated2D(*(torch.from_numpy(np.array(a)) for a in jt))  # a copy of JAX's table


@pytest.mark.parametrize("domain", ["disk", "hemisphere", "sphere"])
def test_build_and_pdf_match_jax(domain):
    res = 32
    np.testing.assert_allclose(ttab.domain_grid(domain, res, device="cpu").numpy(),
                               np.asarray(jtab.domain_grid(domain, res)), rtol=1e-6, atol=1e-7)
    v = _vertices(domain, res)
    jt, tt_ = jtab.build_tabulated(jnp.asarray(v), domain), ttab.build_tabulated(torch.from_numpy(v), domain)
    jpmf = np.asarray(jt.pmf)
    assert tt_.pmf.shape == jpmf.shape == (3, res, res)
    np.testing.assert_array_equal(tt_.pmf.numpy() == 0, jpmf == 0)
    np.testing.assert_allclose(tt_.pmf.numpy(), jpmf, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tt_.cdf.numpy(), np.asarray(jt.cdf), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tt_.lo.numpy(), np.asarray(jt.lo))
    np.testing.assert_array_equal(tt_.hi.numpy(), np.asarray(jt.hi))
    if domain == "disk":  # the mask: cells whose centre has x^2 + y^2 > 0.995
        c = (np.arange(res) + 0.5) / res * 2 - 1
        assert (jpmf[:, (c[:, None] ** 2 + c[None] ** 2) > 0.995] == 0).all()
    x = np.asarray(jtab.sample_tabulated(jax.random.key(1), jt, 512))
    np.testing.assert_array_equal(ttab.tabulated_pdf(_port_table(jt), torch.from_numpy(x)).numpy(),
                                  np.asarray(jtab.tabulated_pdf(jt, jnp.asarray(x))))


@pytest.mark.parametrize("domain", ["disk", "sphere"])
def test_sample_from_jax_uniforms_is_exact(domain):
    """JAX's `sample_tabulated` draws split(key) -> uniform(k_u, (B, n)),
    uniform(k_j, (B, n, 2)); fed those, the port's sampler returns its
    samples to the bit."""
    res, n = 24, 4096
    jt = jtab.build_tabulated(jnp.asarray(_vertices(domain, res, seed=2)), domain)
    key = jax.random.key(5)
    k_u, k_j = jax.random.split(key)
    u = torch.from_numpy(np.array(jax.random.uniform(k_u, (3, n), jnp.float32)))
    jit = torch.from_numpy(np.array(jax.random.uniform(k_j, (3, n, 2), jnp.float32)))
    x = ttab.sample_tabulated_from_uniforms(_port_table(jt), u, jit)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jtab.sample_tabulated(key, jt, n)))


def test_sample_tabulated_histogram_and_domain():
    res, n = 32, 1 << 16
    tab = ttab.build_tabulated(torch.from_numpy(_vertices("disk", res, b=1, seed=3)), "disk")
    x = ttab.sample_tabulated(root_generator(0, "cpu"), tab, n)
    assert x.shape == (1, n, 2)
    hist, _, _ = np.histogram2d(x[0, :, 0].numpy(), x[0, :, 1].numpy(), bins=res, range=[[-1, 1], [-1, 1]])
    q, p = hist / hist.sum(), tab.pmf[0].numpy()
    mask = p > p.max() * 1e-4
    assert float(np.sum(p[mask] * np.log((p[mask] + 1e-12) / (q[mask] + 1e-12)))) < 0.05
    assert bool((ttab.tabulated_pdf(tab, x) > 0).all())
    hemi = ttab.build_tabulated(torch.from_numpy(_vertices("hemisphere", res, b=1)), "hemisphere")
    y = ttab.sample_tabulated(root_generator(1, "cpu"), hemi, 4096)[0]
    assert float(y[:, 0].min()) >= 0.0 and float(y[:, 0].max()) <= np.pi / 2
    assert float(y[:, 1].min()) >= -np.pi and float(y[:, 1].max()) <= np.pi


def test_online_sampling_distribution():
    """JAX tests/test_tabulated.py::test_online_sampling_end_to_end, on the port."""

    def pdf_fn(wi, wo):  # a mirror lobe on the disk: peak at wo == -wi
        return torch.exp(-((wo + wi) ** 2).sum(-1) / 0.05)

    omega_i, omega_o = ttab.online_sampling(pdf_fn, "disk", root_generator(0, "cpu"), n_wi=8,
                                            n_samples_per_wi=2048, res=64)
    assert omega_i.shape == omega_o.shape == (8 * 2048, 2)
    assert len(torch.unique(omega_i, dim=0)) == 8
    assert float((((omega_o + omega_i) ** 2).sum(-1) < 0.05 * 9).float().mean()) > 0.95


def test_domain_grid_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttab.domain_grid("disk", 8)


def test_samplewi_native_matches_jax_to_the_bit():
    rng = np.random.default_rng(4)
    pdf = rng.random((6, 24, 24)).astype(np.float32)
    pdf[:, :3] = 0.0
    for seed in (0, 7):
        x = samplewi_native(pdf, 3000, seed=seed)
        np.testing.assert_array_equal(x, jsamplewi(pdf, 3000, seed=seed))
        assert x.shape == (6, 3000, 2) and x.dtype == np.float32 and np.abs(x).max() <= 1.0
    np.testing.assert_array_equal(samplewi_native(pdf.reshape(6, -1), 10, 1), jsamplewi(pdf.reshape(6, -1), 10, 1))
    with pytest.raises(ValueError, match="zero"):
        samplewi_native(np.zeros((1, 16 * 16), np.float32), 8)
    with pytest.raises(ValueError, match="square"):
        samplewi_native(np.ones((1, 15), np.float32), 8)


def test_samplewi_source_is_the_jax_package_code():
    """The copy differs from the JAX package's source only in its header
    comment, above the first `#include`."""
    def code(text):
        return text[re.search(r"^#include", text, re.M).start():]

    mine = (cuda_build.CSRC / "samplewi.cpp").read_text()
    theirs = (REPO / "bsdf_diffusion_sampling_tpu" / "native" / "samplewi.cpp").read_text()
    assert code(mine) == code(theirs) and mine != theirs
