"""The port's validation metrics against the JAX package's
`utils/validation.py`: `sampler_vs_pdf_kl`, `image_mse` and `relative_mse`
to 1e-12 on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsdf_diffusion_sampling_tpu.utils.validation as jv
import bsdf_diffusion_sampling_tpu_torch.utils as tu
import bsdf_diffusion_sampling_tpu_torch.utils.validation as tv

TOL = 1e-12
MU, SIGMA = np.array([0.2, -0.1]), np.array([0.3, 0.45])


def _gauss_pdf(xp):
    """The same float64 numpy density behind either package's point type, so
    that the comparison holds the metric's composition, not two exp()s."""
    def pdf(p):
        z = (np.asarray(p, np.float64) - MU) / SIGMA
        return xp.asarray((np.exp(-0.5 * (z ** 2).sum(-1)) / (2 * np.pi * SIGMA.prod())).astype(np.float32))
    return pdf


@pytest.mark.parametrize("bins", [16, 48])
def test_sampler_vs_pdf_kl_matches_jax(bins):
    rng = np.random.default_rng(1)
    samples = rng.normal(MU, SIGMA, (20000, 2)) * np.array([1.1, 0.9])  # a little off the pdf
    lo, hi = (-1.0, -1.0), (1.0, 1.0)
    got = tv.sampler_vs_pdf_kl(samples, _gauss_pdf(torch), lo, hi, bins, device="cpu")
    want = jv.sampler_vs_pdf_kl(samples, _gauss_pdf(jnp), lo, hi, bins)
    assert got > 0.0 and abs(got - want) <= TOL
    # sub > 1 averages each cell: a different, still positive, number
    assert tv.sampler_vs_pdf_kl(samples, _gauss_pdf(torch), lo, hi, bins, device="cpu", sub=4) > 0.0


@pytest.mark.parametrize("shape", [(8, 6, 3), (5, 4)])
def test_image_errors_match_jax(shape):
    rng = np.random.default_rng(2)
    a = rng.lognormal(0.0, 1.0, shape).astype(np.float32)
    b = (a * rng.uniform(0.8, 1.2, shape)).astype(np.float32)
    assert abs(tu.image_mse(a, b) - jv.image_mse(a, b)) <= TOL
    assert abs(tu.relative_mse(a, b) - jv.relative_mse(a, b)) <= TOL
    assert abs(tu.relative_mse(a, b, eps=0.5) - jv.relative_mse(a, b, eps=0.5)) <= TOL
    with pytest.raises(ValueError, match="shape mismatch"):
        tu.image_mse(a, b[:-1])
