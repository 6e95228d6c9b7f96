"""The port's spherical pieces against the JAX package, on the same
weights and inputs: the von Mises sampler and log-density, the spherical
base density, the spherical ODE (`ode/flow.py`), and the plain versions of
K4 (spherical sample+pdf) and K3 (transport) against the JAX package's
Pallas kernels run in interpret mode (tile=8), as its own tests run them.
Also the in-kernel draw stream of K4 (Philox) as the CPU wrappers reproduce
it, and the wrappers' CPU/CUDA routing.

Tolerances, float32 on both sides in other orders: log I0 to 1e-6
relative; von Mises draws from the same uniforms to 1e-5 on the circle
(1e-4 at kappa outside [e^-2, e^4], where the algorithm is ill-conditioned);
base log-probs to 1e-5; x to 2e-5 absolute and pdfs / dets to 2e-4
relative (the JAX package's own kernel-vs-XLA test holds 2e-5 and 5e-4),
T=8 steps of the 4 x 32 net; 1e-4 for the T=128 / T=256 primal transports,
where 128-256 steps of rounding add up.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsdf_diffusion_sampling_tpu.ops.fused_ode as jfused
from bsdf_diffusion_sampling_tpu.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu.models import base_density as jbd
from bsdf_diffusion_sampling_tpu.models import velocity_init
from bsdf_diffusion_sampling_tpu.models import von_mises as jvm
from bsdf_diffusion_sampling_tpu.ode import flow as jflow
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.models import base_density as tbd
from bsdf_diffusion_sampling_tpu_torch.models import von_mises as tvm
from bsdf_diffusion_sampling_tpu_torch.ode import flow as tflow
from bsdf_diffusion_sampling_tpu_torch.ops import fused_ode as tfused

from _torch_port import disk_setup, jax_spherical_draw, sph_setup, tt

jfused._INTERPRET = jax.default_backend() == "cpu"

X_ATOL = 2e-5
PDF_RTOL = 2e-4
T = 8
N = 256


def circ(a, b) -> float:
    """max |a - b| on the circle."""
    d = np.remainder(np.asarray(a, np.float64) - np.asarray(b, np.float64) + np.pi, 2 * np.pi) - np.pi
    return float(np.abs(d).max())


@pytest.fixture(scope="module")
def s():
    s = sph_setup(n=N, seed=5)
    s.heads = jbd._spherical_heads(s.b, jnp.asarray(s.omega))
    s.key = jax.random.key(17)
    s.eps_g, s.u_von, s.phi = jax_spherical_draw(s.key, s.heads, N)
    s.w = tfused.prepack_spherical(s.tv, s.tb)
    return s


# ------------------------------------------------------------- von Mises


def test_log_i0_matches_jax():
    x = np.concatenate([np.linspace(0.0, 20.0, 2001), [3.75, np.nextafter(3.75, 4.0), 1e-3, 150.0, 4e3]])
    x = x.astype(np.float32)
    np.testing.assert_allclose(tvm.log_i0(tt(x)).numpy(), np.asarray(jvm.log_i0(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


def test_von_mises_log_prob_matches_jax():
    rng = np.random.default_rng(1)
    x, loc = rng.uniform(-np.pi, np.pi, (2, 512)).astype(np.float32)
    kappa = rng.uniform(1e-3, 30.0, 512).astype(np.float32)
    got = tvm.von_mises_log_prob(tt(x), tt(loc), tt(kappa)).numpy()
    want = jvm.von_mises_log_prob(jnp.asarray(x), jnp.asarray(loc), jnp.asarray(kappa))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_von_mises_sample_from_the_same_uniforms():
    """JAX draws its uniforms from the key; the port is handed them. Wide
    range of kappa, locations outside [-pi, pi), and kappa < 1e-6. Draws
    agree to 1e-5 on the circle for kappa in [e^-2, e^4]; beyond it the
    algorithm itself is ill-conditioned (tau - sqrt(2 tau) cancels at small
    kappa, acos(f) at f -> 1 for large kappa turns an ulp of f into ~1e-5
    rad), so the extremes are held to 1e-4."""
    n = 2048
    rng = np.random.default_rng(2)
    loc = rng.uniform(-7.0, 7.0, n).astype(np.float32)
    kappa = np.exp(rng.uniform(-4.0, 6.0, n)).astype(np.float32)
    kappa[:8] = 1e-8
    key = jax.random.key(3)
    want = np.asarray(jvm.von_mises_sample(key, jnp.asarray(loc), jnp.asarray(kappa)))
    u = tt(jax.random.uniform(key, (16, 3, n), minval=1e-7, maxval=1.0 - 1e-7))
    got = tvm.von_mises_sample(u, tt(loc), tt(kappa)).numpy()
    moderate = (kappa >= np.exp(-2.0)) & (kappa <= np.exp(4.0))
    assert moderate.sum() > n // 2
    assert circ(got[moderate], want[moderate]) <= 1e-5
    assert circ(got, want) <= 1e-4
    assert np.all(got >= -np.pi) and np.all(got < np.pi)


def test_von_mises_no_accept_keeps_round_zero():
    """When no round accepts, both keep round 0's angle (the XLA sampler's
    argmax over an all-False mask); u1 = 1 - 1e-7 rejects every round."""
    n = 64
    rng = np.random.default_rng(4)
    u = rng.uniform(0.01, 0.99, (16, 3, n)).astype(np.float32)
    u[:, 1] = np.float32(1.0 - 1e-7)
    loc = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    kappa = rng.uniform(0.5, 5.0, n).astype(np.float32)
    got = tvm.von_mises_sample(tt(u), tt(loc), tt(kappa)).numpy()
    # JAX's own function on the same uniforms, as its body computes them
    tau = 1.0 + np.sqrt(1.0 + 4.0 * kappa.astype(np.float64) ** 2)
    rho = (tau - np.sqrt(2.0 * tau)) / (2.0 * kappa)
    r = (1.0 + rho * rho) / (2.0 * rho)
    f = (1.0 + r * np.cos(np.pi * u[0, 0])) / (r + np.cos(np.pi * u[0, 0]))
    round0 = np.sign(u[0, 2] - 0.5) * np.arccos(np.clip(f, -1.0, 1.0)) + loc
    assert circ(got, round0) <= 1e-4


# ------------------------------------------------------------------ base


def test_spherical_heads_and_log_prob_match_jax(s):
    got = tbd._spherical_heads(s.tb, s.t_omega)
    for g, w in zip(got, s.heads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    x = np.stack([s.rng.uniform(-0.5, 2.0, N), s.rng.uniform(-np.pi, np.pi, N)], -1).astype(np.float32)
    want = jbd.spherical_base_log_prob(s.b, jnp.asarray(x), jnp.asarray(s.omega))
    np.testing.assert_allclose(tbd.spherical_base_log_prob(s.tb, tt(x), s.t_omega).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_spherical_base_sample_matches_jax(s):
    want = np.asarray(jbd.spherical_base_sample(s.b, jnp.asarray(s.omega), s.key))
    got = tbd.spherical_base_sample(s.tb, s.t_omega, (s.eps_g, s.u_von)).numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-5)
    assert circ(got[:, 1], want[:, 1]) <= 1e-5
    assert circ(got[:, 1], s.phi.numpy()) <= 1e-5
    g = tbd.spherical_base_sample(s.tb, s.t_omega, torch.Generator().manual_seed(1))
    assert g.shape == (N, 2) and torch.isfinite(g).all()


# ------------------------------------------------------------------- ODE


@pytest.mark.parametrize("fn", ["ode_sample", "ode_pdf", "ode_pdf_exact", "ode_sample_only"])
def test_spherical_ode_matches_jax(s, fn):
    om, c = jnp.asarray(s.omega), s.cond
    jx, jpdf = jflow.ode_sample("spherical", s.v, s.b, om, c, s.key, T)
    if fn == "ode_sample":
        x, pdf = tflow.ode_sample("spherical", s.tv, s.tb, s.t_omega, s.t_cond, T, eps=(s.eps_g, s.u_von))
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=X_ATOL)
        np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=PDF_RTOL)
    elif fn == "ode_sample_only":
        x0 = jbd.spherical_base_sample(s.b, om, s.key)
        want = jflow.ode_sample_only("spherical", s.v, x0, c, T)
        got = tflow.ode_sample_only("spherical", s.tv, tt(x0), s.t_cond, T)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=X_ATOL)
    else:
        want = getattr(jflow, fn)("spherical", s.v, s.b, jx, om, c, T)
        got = getattr(tflow, fn)("spherical", s.tv, s.tb, tt(jx), s.t_omega, s.t_cond, T)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PDF_RTOL, atol=1e-7)
        if fn == "ode_pdf_exact":  # the exact query gives back the draw's own pdf
            ok = np.asarray(jpdf) > 1e-6
            assert np.median(np.abs(got.numpy()[ok] / np.asarray(jpdf)[ok] - 1)) < 1e-3


# ----------------------------------------------------------- K4 plain


def test_plain_k4_matches_jax_kernel(s):
    packed = jfused.prepack_spherical(s.v, s.b)
    eps = np.stack([s.eps_g.numpy(), s.phi.numpy()], -1)
    jx, jpdf, jx0 = jfused.fused_sample_pdf_spherical_packed(packed, s.cond, 0, T, tile=8, eps=jnp.asarray(eps))
    x, pdf, x0 = tfused.sample_pdf_spherical_plain(s.w, s.t_cond, T, eps=tt(eps))
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), atol=X_ATOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=X_ATOL)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=PDF_RTOL)
    # from the kernel's own x0 the plain version gives the same draw
    x2, pdf2, _ = tfused.sample_pdf_spherical_plain(s.w, s.t_cond, T, x0=tt(jx0))
    np.testing.assert_allclose(x2.numpy(), np.asarray(jx), atol=X_ATOL)
    np.testing.assert_allclose(pdf2.numpy(), np.asarray(jpdf), rtol=PDF_RTOL)


# ----------------------------------------------------------- K2s plain


@pytest.fixture(scope="module", params=["spherical", "sphere_full"])
def q(request):
    """The exact query's inputs on one domain: the end points of the JAX
    package's draws."""
    q = sph_setup(n=N, seed=6, domain=request.param)
    q.domain = request.param
    q.w = tfused.prepack_spherical(q.tv, q.tb)
    q.jx, q.jpdf = jflow.ode_sample(q.domain, q.v, q.b, jnp.asarray(q.omega), q.cond, jax.random.key(19), T)
    return q


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_plain_k2s_matches_ode_pdf_exact(q, iters):
    """K2s's plain version is the port's `ode_pdf_exact` to the bit (the
    base heads from cond_enc's first 14 columns, which are PE(omega_i, 3
    bands)) and the JAX package's to PDF_RTOL, at each number of Newton
    iterations."""
    x = tt(q.jx)
    pdf, x0 = tfused.pdf_spherical_plain(q.w, x, q.t_cond, T, newton_iters=iters)
    port = tflow.ode_pdf_exact(q.domain, q.tv, q.tb, x, q.t_omega, q.t_cond, T, newton_iters=iters)
    torch.testing.assert_close(pdf, port, rtol=0, atol=0)
    torch.testing.assert_close(x0, tflow.newton_inverse(q.domain, q.tv, x, q.t_cond, T, iters)[0], rtol=0, atol=0)
    want = jflow.ode_pdf_exact(q.domain, q.v, q.b, q.jx, jnp.asarray(q.omega), q.cond, T, newton_iters=iters)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(want), rtol=PDF_RTOL, atol=1e-7)


def test_plain_k2s_gives_back_the_draws_pdf(s):
    """Queried at K4's plain draws, the exact query inverts each draw's own
    forward map: it gives back the draw's x0 and pdf."""
    x, pdf, x0 = tfused.sample_pdf_spherical_plain(s.w, s.t_cond, T, eps=torch.stack([s.eps_g, s.phi], -1))
    pdf_q, x0_q = tfused.pdf_spherical_plain(s.w, x, s.t_cond, T)
    np.testing.assert_allclose(x0_q.numpy(), x0.numpy(), atol=X_ATOL)
    ok = pdf > 1e-6
    assert int(ok.sum()) > N // 2
    np.testing.assert_allclose(pdf_q[ok].numpy(), pdf[ok].numpy(), rtol=PDF_RTOL)


def test_cpu_k2s_wrapper_takes_the_plain_version(q):
    tfused.reset_launches()
    for iters in (0, 2):
        got = tfused.fused_pdf_spherical(q.w, tt(q.jx), q.t_cond, T, newton_iters=iters)
        for g, w in zip(got, tfused.pdf_spherical_plain(q.w, tt(q.jx), q.t_cond, T, newton_iters=iters)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tfused.launches["fused_pdf_spherical"] == 0 and not any(tfused.launches.values())


@pytest.mark.parametrize("case", ["device", "x_shape", "width", "domain", "newton_iters"])
def test_k2s_raises_instead_of_falling_back(s, case):
    """Off the CPU the wrapper launches K2s or raises: on a device that is
    not CUDA, on query points of another shape, on nets other than the
    spherical 4 x 32 it is built for, on negative Newton iterations."""
    meta = s.t_cond.to("meta")
    x, w, iters, match = torch.empty((N, 2), device="meta"), s.w, 2, "CUDA"
    if case == "x_shape":
        x, match = torch.empty((N, 3), device="meta"), "x: expected"
    elif case == "width":
        wide = velocity_init(jax.random.key(0), ModelConfig(domain="spherical", velocity_hidden=64, velocity_layers=4))
        w, match = tfused.prepack_spherical(params_from_jax(wide, "cpu"), s.tb), "built for"
    elif case == "domain":
        d = disk_setup(n=N, seed=3)
        w, match = tfused.prepack_disk(d.tv, d.tb), "built for"
    elif case == "newton_iters":
        iters, match = -1, "newton_iters"
    tfused.reset_launches()
    with pytest.raises(ValueError, match=match):
        tfused.fused_pdf_spherical(w, x, meta, T, newton_iters=iters)
    assert not any(tfused.launches.values())


# ----------------------------------------------------------- K3 plain


def _k3_case(domain, seed, n, hidden=32, layers=None):
    if domain == "disk":
        d = disk_setup(n=n, seed=seed)
        x0 = np.asarray(jbd.disk_base_sample(d.b, jnp.asarray(d.omega), jax.random.key(seed)))
        return d.v, d.cond, d.t_cond, x0
    cfg = ModelConfig(domain="spherical", velocity_hidden=hidden, velocity_layers=layers)
    d = sph_setup(n=n, seed=seed)
    v = jax.tree.map(lambda w: w * 0.5, velocity_init(jax.random.key(seed + 1), cfg))
    x0 = np.asarray(jbd.spherical_base_sample(d.b, jnp.asarray(d.omega), jax.random.key(seed)))
    return v, d.cond, d.t_cond, x0


@pytest.mark.parametrize("domain,layers", [("disk", 3), ("spherical", 4)])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("with_jac", [True, False], ids=["det", "primal"])
def test_plain_k3_matches_jax_kernel(domain, layers, reverse, with_jac):
    t = 4 if domain == "disk" else T
    v, cond, t_cond, x = _k3_case(domain, 6, 128, layers=layers)
    if reverse:  # reverse from the forward transport's end points, as the pdf query runs it
        x = np.asarray(jflow.ode_sample_only(domain, v, jnp.asarray(x), cond, t))
    jx, jdet = jfused.fused_ode_transport(domain, v, jnp.asarray(x), cond, t, reverse=reverse, with_jac=with_jac,
                                          tile=8)
    w = tfused.prepack_velocity(params_from_jax(v, "cpu"))
    assert w.domain == domain
    got, det = tfused.transport_plain(domain, w, tt(x), t_cond, t, reverse=reverse, with_jac=with_jac)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), atol=X_ATOL)
    if with_jac:
        np.testing.assert_allclose(det.numpy(), np.asarray(jdet), rtol=PDF_RTOL)
    else:  # the kernel leaves the det lane 0; so does the port
        assert not np.asarray(jdet).any() and not det.any()


@pytest.mark.parametrize("domain,t,hidden,layers", [("spherical", 128, 64, 6), ("disk", 256, 32, 3)],
                         ids=["spherical_6x64_T128", "disk_3x32_T256"])
def test_plain_k3_long_primal_matches_jax_kernel(domain, t, hidden, layers):
    """Rectify's pair generation: primal only, long T (looped in the TPU
    kernel), the 6 x 64 spherical teacher; n = 64 keeps interpret mode short."""
    v, cond, t_cond, x0 = _k3_case(domain, 7, 64, hidden, layers)
    jx, _ = jfused.fused_ode_transport(domain, v, jnp.asarray(x0), cond, t, with_jac=False, tile=8)
    w = tfused.prepack_velocity(params_from_jax(v, "cpu"))
    got, det = tfused.transport_plain(domain, w, tt(x0), t_cond, t, with_jac=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), atol=1e-4)
    assert not det.any()


# ------------------------------------------------------------- wrappers


def test_prepack_spherical_layout(s):
    """Velocity W0 (26, 32), W1..W3, W_out (32, 2), then the base W0 (14,
    16), b0, W1 (16, 4), b1: 4,276 floats."""
    assert (s.w.hidden, s.w.layers, s.w.domain) == (32, 4, "spherical")
    assert s.w.flat.numel() == 26 * 32 + 3 * 32 * 32 + 32 * 2 + 14 * 16 + 16 + 16 * 4 + 4
    assert torch.equal(s.w.flat[:26 * 32].reshape(26, 32), s.tv[0]["w"])
    assert torch.equal(s.w.flat[-4:], s.tb["net"][1]["b"])
    vel = tfused.prepack_velocity(s.tv)
    assert torch.equal(vel.flat, s.w.flat[:vel.flat.numel()]) and vel.base_params is None
    with pytest.raises(ValueError):
        tfused.prepack_disk(s.tv, s.tb)


def test_cpu_wrappers_take_the_plain_versions(s):
    tfused.reset_launches()
    eps = torch.stack([s.eps_g, s.phi], -1)
    got = tfused.fused_sample_pdf_spherical(s.w, s.t_cond, T, eps=eps)
    for g, w in zip(got, tfused.sample_pdf_spherical_plain(s.w, s.t_cond, T, eps=eps)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for reverse in (False, True):
        for jac in (True, False):
            got = tfused.fused_transport_packed(s.w, "sphere_full", got[0], s.t_cond, T, reverse=reverse,
                                                with_jac=jac)
            want = tfused.transport_plain("spherical", s.w, got[0], s.t_cond, T, reverse=reverse, with_jac=jac)
            assert got[0].shape == want[0].shape
    x, pdf, x0 = tfused.fused_sample_pdf_spherical(s.w, s.t_cond, T, seed=99)
    torch.testing.assert_close(x0, tfused.spherical_x0_from_seed(s.w, s.t_cond, 99), rtol=0, atol=0)
    assert not any(tfused.launches.values())
    with pytest.raises(ValueError):
        tfused.fused_sample_pdf_spherical(s.w, s.t_cond, T)


def test_non_cuda_device_raises_instead_of_falling_back(s):
    meta = s.t_cond.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_sample_pdf_spherical(s.w, meta, T, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_transport_packed(s.w, "spherical", torch.empty((N, 2), device="meta"), meta, T)
    with pytest.raises(ValueError, match="not built"):  # the 6 x 64 teacher runs primal only
        teacher = velocity_init(jax.random.key(0), ModelConfig(domain="spherical", velocity_hidden=64,
                                                               velocity_layers=6))
        tfused.fused_ode_transport("spherical", params_from_jax(teacher, "cpu"), torch.empty((N, 2), device="meta"),
                                   meta, 128, with_jac=True)
    assert not any(tfused.launches.values())


def test_philox_known_answer_with_counter_words():
    """Philox4x32-10 on counter (0x243f6a88, 0x85a308d3, 0x13198a2e,
    0x03707344) under key (0xa4093822, 0x299f31d0): the Random123
    known-answer vector, which exercises all four counter words."""
    words = tfused._philox4x32_10(np.array([0x243F6A88], np.uint64), np.array([0x85A308D3], np.uint64),
                                  0xA4093822, 0x299F31D0, c2=0x13198A2E, c3=0x03707344)
    assert [int(w[0]) for w in words] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_philox_spherical_draws():
    """K4's stream: eps_g standard normal; 16 x 3 uniforms a sample inside
    [1e-7, 1 - 1e-7]; deterministic in the seed; each sample's words apart
    from its neighbours'."""
    n = 1 << 15
    eps_g, u = tfused.philox_spherical_draws(12345, n)
    assert eps_g.shape == (n,) and u.shape == (16, 3, n) and u.dtype == torch.float32
    tol = 5.0 / np.sqrt(n)
    assert abs(float(eps_g.mean())) < tol and abs(float(eps_g.std()) - 1.0) < tol
    assert float(u.min()) >= np.float32(1e-7) and float(u.max()) <= np.float32(1.0) - np.float32(1e-7)
    assert abs(float(u.mean()) - 0.5) < tol
    e2, u2 = tfused.philox_spherical_draws(12345, 100)
    assert torch.equal(e2, eps_g[:100]) and torch.equal(u2, u[..., :100])
    assert not torch.equal(tfused.philox_spherical_draws(12346, 100)[1], u2)
