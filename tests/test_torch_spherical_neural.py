"""The slice's sampler: the port's spherical and full-sphere
`neural_sample` / `neural_pdf` against the JAX package's, through its
Pallas kernels in interpret mode (fused=True, tile=8: K4 for the draw, K3
for the reverse-Euler pdf) and through its XLA path (fused=False), with
`pdf_exact` True (the Newton solve, plain on both sides) and False. The
port is handed what JAX draws from its key (`render/neural.py:159-162`):
the Gaussian eps and the von Mises uniforms.

Tolerances: float32 on both sides in other orders, T=8 steps of the 4 x 32
net: directions to 2e-5 absolute, solid-angle pdfs to 2e-4 relative (the
JAX package's own kernel-vs-XLA test holds 2e-5 and 5e-4).
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsdf_diffusion_sampling_tpu.ops.fused_ode as jfused
from bsdf_diffusion_sampling_tpu.core.config import SamplerConfig as JSamplerConfig
from bsdf_diffusion_sampling_tpu.geometry.coords import cart_to_spher
from bsdf_diffusion_sampling_tpu.models.base_density import _spherical_heads
from bsdf_diffusion_sampling_tpu.render import neural as jneural
from bsdf_diffusion_sampling_tpu_torch.core.config import SamplerConfig
from bsdf_diffusion_sampling_tpu_torch.geometry import coords as tcoords
from bsdf_diffusion_sampling_tpu_torch.models import velocity as tvelocity
from bsdf_diffusion_sampling_tpu_torch.ode import flow as tflow
from bsdf_diffusion_sampling_tpu_torch.ops import fused_ode as tfused
from bsdf_diffusion_sampling_tpu_torch.render import neural as tneural

from _torch_port import jax_spherical_draw, sph_setup, tt

jfused._INTERPRET = jax.default_backend() == "cpu"

X_ATOL = 2e-5
PDF_RTOL = 2e-4
N = 256


def _wi(rng, n):
    """Local incident directions, cos(theta) in [0.15, 0.95]; the first 8 point down."""
    u = rng.random((n, 2))
    ct = 0.15 + 0.8 * u[:, 0]
    st = np.sqrt(1.0 - ct * ct)
    wi = np.stack([st * np.cos(2 * np.pi * u[:, 1]), st * np.sin(2 * np.pi * u[:, 1]), ct], -1).astype(np.float32)
    wi[:8, 2] *= -1.0
    return wi


@pytest.fixture(scope="module")
def s():
    s = sph_setup(n=N, seed=8)
    s.wi = _wi(s.rng, N)
    s.key = jax.random.key(23)
    heads = _spherical_heads(s.b, cart_to_spher(jnp.asarray(s.wi)))
    s.eps_g, s.u_von, s.phi = jax_spherical_draw(s.key, heads, N)
    return s


def _nbs(s, domain, exact, fused):
    jnb = jneural.make_neural_bsdf(domain, s.cfg, s.v, s.b, None, sampler_cfg=JSamplerConfig(pdf_exact=exact),
                                   fused=fused, tile=8)
    tnb = tneural.make_neural_bsdf(domain, s.cfg, s.tv, s.tb, sampler_cfg=SamplerConfig(pdf_exact=exact),
                                   device="cpu")
    return jnb, tnb


@pytest.mark.parametrize("fused", [True, False], ids=["pallas_interpret", "xla"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "reverse"])
@pytest.mark.parametrize("domain", ["spherical", "sphere_full"])
def test_neural_sample_and_pdf_match_jax(s, domain, exact, fused):
    jnb, tnb = _nbs(s, domain, exact, fused)
    assert (tnb.T, tnb.firefly_clamp) == (jnb.T, jnb.firefly_clamp) == (8, 3.5 if domain == "sphere_full" else 30.0)
    wi = jnp.asarray(s.wi)
    jwo, jpdf = jneural.neural_sample(jnb, s.key, wi)
    jpdf_q = jneural.neural_pdf(jnb, wi, jwo)
    # the draw from the key's uniforms, and from (eps_g, phi) as the kernel takes it
    for draw in ((s.eps_g, s.u_von), torch.stack([s.eps_g, s.phi], -1)):
        wo, pdf = tneural.neural_sample(tnb, draw, tt(s.wi))
        np.testing.assert_allclose(wo.numpy(), np.asarray(jwo), atol=X_ATOL)
        np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=PDF_RTOL, atol=1e-7)
    pdf_q = tneural.neural_pdf(tnb, tt(s.wi), tt(jwo))
    np.testing.assert_allclose(pdf_q.numpy(), np.asarray(jpdf_q), rtol=PDF_RTOL, atol=1e-7)
    assert torch.all(pdf[:8] == 0) and torch.all(pdf_q[:8] == 0)  # downward wi
    assert 0 < int((pdf > 0).sum()) < N
    below = np.asarray(jwo)[:, 2] < 0
    if domain == "sphere_full":  # draws below the surface count, and their pdf is queried
        assert below.any() and (pdf_q.numpy()[below & (s.wi[:, 2] > 0)] > 0).any()
    else:
        assert not (pdf.numpy()[below] > 0).any() and not (pdf_q.numpy()[below] > 0).any()


def test_exact_pdf_gives_back_the_draws_pdf(s):
    """pdf(sample()) gives back the draw's own pdf (median rel < 1e-3), the
    draws from a torch.Generator (the production seed path, K4's stream)."""
    _, tnb = _nbs(s, "sphere_full", True, False)
    wo, pdf = tneural.neural_sample(tnb, torch.Generator().manual_seed(3), tt(s.wi))
    pdf_q = tneural.neural_pdf(tnb, tt(s.wi), wo)
    ok = pdf > 1e-6
    assert int(ok.sum()) > N // 4
    assert float((pdf_q[ok] / pdf[ok] - 1).abs().median()) < 1e-3


@pytest.mark.parametrize("domain", ["spherical", "sphere_full"])
def test_exact_pdf_on_the_cpu_is_the_plain_newton_solve(s, domain):
    """On CPU tensors the exact query takes K2s's plain version and
    launches nothing: `neural_pdf` is, to the bit, what `ode_pdf_exact`
    gives times the pole factor, masked, at the draws and at directions
    all over the sphere."""
    _, tnb = _nbs(s, domain, True, False)
    wi = tt(s.wi)
    wo, _ = tneural.neural_sample(tnb, (s.eps_g, s.u_von), wi)
    wo = torch.cat([wo, torch.nn.functional.normalize(torch.from_numpy(s.rng.normal(size=(N, 3))).float(), dim=-1)])
    wi = torch.cat([wi, wi])
    tfused.reset_launches()
    got = tneural.neural_pdf(tnb, wi, wo)
    assert not any(tfused.launches.values())
    omega_i, x = tcoords.cart_to_spher(wi), tcoords.cart_to_spher(wo)
    pdf = tflow.ode_pdf_exact(domain, tnb.v_params, tnb.base_params, x, omega_i,
                              tvelocity.encode_condition(omega_i, tnb.cfg), tnb.T, newton_iters=tnb.pdf_newton_iters)
    jac = torch.clamp(1.0 / torch.clamp(torch.sin(x[:, 0]), min=tnb.pole_sin_eps), 0.0, 1e6)
    valid = (wi[:, 2] > 0) & ((wo[:, 2] > 0) | (domain == "sphere_full"))
    want = torch.where(valid, torch.clamp(pdf * jac, min=0.0), 0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int((got > 0).sum()) > N // 2


def test_pole_guard_and_theta_range(s):
    """Draws at theta <= 0, theta >= theta_max or sin theta <= 5e-5 carry
    pdf 0; the 1/sin theta factor is clipped at 1e6, as in JAX."""
    for domain, theta_max in (("spherical", np.pi / 2), ("sphere_full", np.pi)):
        jnb, tnb = _nbs(s, domain, True, False)
        theta = np.array([-0.1, 1e-5, 0.3, theta_max - 1e-6, theta_max + 0.1, np.pi - 1e-5], np.float32)
        phi = np.zeros_like(theta)
        wo = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
        wi = np.tile(np.array([[0.2, 0.1, 0.97]], np.float32), (len(theta), 1))
        want = jneural.neural_pdf(jnb, jnp.asarray(wi), jnp.asarray(wo.astype(np.float32)))
        got = tneural.neural_pdf(tnb, tt(wi), tt(wo))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PDF_RTOL, atol=1e-7)


def test_firefly_clamp_by_domain(s):
    rgb = s.rng.uniform(0, 10, (N, 3)).astype(np.float32)
    for domain in ("spherical", "sphere_full"):
        jnb, tnb = _nbs(s, domain, True, False)
        np.testing.assert_array_equal(tneural.firefly_filter(tnb, tt(rgb)).numpy(),
                                      np.asarray(jneural.firefly_filter(jnb, jnp.asarray(rgb))))
