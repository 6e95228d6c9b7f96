"""The port's differentiable transport, `ops/fused_ode.py::fused_transport_diff`
(an autograd.Function: K3 with the det forward, the plain
`ode/flow.py::transport_with_det` rematerialised for the backward), held
against the JAX package's `fused_transport_diff` (its Pallas K3 in interpret
mode, tile 8, and the XLA VJP of `_xla_transport_with_det`) on the same
numpy-made inputs.

Tolerances: gradients rtol 2e-4, atol 1e-6 (tests/test_diff.py:66-67); the
pixel loss's gradient rtol 2e-3, atol 1e-6 (tests/test_diff.py:170-171);
the central differences h = 3e-3, rtol 5e-2, atol 1e-5
(tests/test_diff.py:118-128), and in fp64 through the plain transport,
rtol 1e-3 with no atol. On the CPU the Function's forward is K3's plain
version, which keeps float64, so `torch.autograd.gradcheck` runs on it.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsdf_diffusion_sampling_tpu.ops.fused_ode as jfused
from bsdf_diffusion_sampling_tpu.bsdf import ggx_shading_disk as j_ggx_shading_disk
from bsdf_diffusion_sampling_tpu.models.base_density import _disk_heads
from bsdf_diffusion_sampling_tpu.models.velocity import encode_condition
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.ode.flow import transport_with_det
from bsdf_diffusion_sampling_tpu_torch.ops import fused_ode as tfused

from _torch_port import disk_setup, sph_setup, tt

jfused._INTERPRET = jax.default_backend() == "cpu"

REPO = Path(__file__).resolve().parent.parent
CASES = {"disk 3x32 T=4": ("disk", 4, False), "spherical 4x32 T=8": ("spherical", 8, False),
         "spherical 4x32 T=8 reverse": ("spherical", 8, True)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _case(domain: str, n: int = 256):
    """Weights, cond and x0 for one domain: disk x0 ~ 0.3 N(0, 1); spherical
    x0 = (theta in [0.2, 1.3], phi in [-3, 3])."""
    s = disk_setup(n) if domain == "disk" else sph_setup(n)
    if domain == "disk":
        x0 = (0.3 * s.rng.standard_normal((n, 2))).astype(np.float32)
    else:
        x0 = np.stack([s.rng.uniform(0.2, 1.3, n), s.rng.uniform(-3.0, 3.0, n)], -1).astype(np.float32)
    return s, x0


def _jax_grads(transport, s, x0):
    def loss(p, x, c):
        xo, det = transport(p, x, c)
        return jnp.sum(xo**2) + jnp.sum((det - 1.0) ** 2)

    value, (gv, gx, gc) = jax.value_and_grad(loss, argnums=(0, 1, 2))(s.v, jnp.asarray(x0), s.cond)
    return float(value), [np.asarray(layer["w"]) for layer in gv] + [np.asarray(gx), np.asarray(gc)]


def _port_grads(domain, T, reverse, s, x0):
    ws = [layer["w"].clone().requires_grad_() for layer in s.tv]
    x = tt(x0).requires_grad_()
    c = s.t_cond.clone().requires_grad_()
    xo, det = tfused.fused_transport_diff(domain, [{"w": w} for w in ws], x, c, T, reverse)
    loss = (xo**2).sum() + ((det - 1.0) ** 2).sum()
    return float(loss.detach()), [t.numpy() for t in torch.autograd.grad(loss, [*ws, x, c])]


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("case", list(CASES))
def test_transport_gradients_match_jax(case, oracle):
    """Gradients of sum(x^2) + sum((det - 1)^2) with respect to every weight,
    x0 and cond_enc."""
    domain, T, reverse = CASES[case]
    s, x0 = _case(domain)
    if oracle == "pallas_interpret":
        def transport(p, x, c):
            return jfused.fused_transport_diff(domain, p, x, c, T, reverse, 8)
    else:
        def transport(p, x, c):
            return jfused._xla_transport_with_det(domain, p, x, c, T, reverse)
    want_value, want = _jax_grads(transport, s, x0)
    got_value, got = _port_grads(domain, T, reverse, s, x0)
    np.testing.assert_allclose(got_value, want_value, rtol=1e-5)
    assert len(got) == len(want) == len(s.tv) + 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-6)


def _jax_pixel_loss(transport, v, b, wi_img, eps, cfg, T):
    """tests/test_diff.py:72-100's pixel loss with its transport given."""
    npix, s, _ = eps.shape
    wi = jnp.repeat(wi_img, s, axis=0)
    cond = encode_condition(wi, cfg)
    loc, ls = _disk_heads(b, wi)
    e = eps.reshape(-1, 2)
    x0 = loc + e * jnp.exp(ls)
    log_p0 = jnp.sum(-ls - 0.5 * e**2, axis=-1) - jnp.log(2.0 * jnp.pi)
    x, det = transport(v, x0, cond)
    pdf = jnp.exp(log_p0) / det
    lum = jnp.exp(-4.0 * jnp.sum((x - jnp.array([0.2, -0.3])) ** 2, axis=-1))
    r = jnp.linalg.norm(x, axis=-1, keepdims=True)
    x_safe = x * (jnp.minimum(r, 0.95) / jnp.maximum(r, 1e-6))
    f = j_ggx_shading_disk(wi, x_safe, roughness=0.6, diffuse_prob=0.3)
    img = (lum * f / jnp.maximum(pdf, 1e-3)).reshape(npix, s).mean(axis=1)
    return jnp.mean(img**2)


def _pixel_inputs(npix: int, s: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    wi_img = rng.uniform(-0.5, 0.5, (npix, 2)).astype(np.float32)
    eps = rng.standard_normal((npix, s, 2)).astype(np.float32)
    return wi_img, eps


def test_pixel_loss_gradient_matches_jax():
    """chip_smoke.py's pixel loss through the port's Function against the
    JAX pixel loss through its `fused_transport_diff` (interpret mode), on
    the same wi and eps."""
    smoke = _chip_smoke()
    d = disk_setup()
    npix, s, T = 64, 8, 4
    wi_img, eps = _pixel_inputs(npix, s)

    def j_transport(p, x0, c):
        return jfused.fused_transport_diff("disk", p, x0, c, T, False, 8)

    want_value, want = jax.value_and_grad(
        lambda p: _jax_pixel_loss(j_transport, p, d.b, jnp.asarray(wi_img), jnp.asarray(eps), d.cfg, T))(d.v)
    ws = [layer["w"].clone().requires_grad_() for layer in d.tv]
    value = smoke.pixel_loss([{"w": w} for w in ws], d.tb, tt(wi_img), tt(eps), T,
                             lambda p, x0, c: tfused.fused_transport_diff("disk", p, x0, c, T))
    got = torch.autograd.grad(value, ws)
    np.testing.assert_allclose(float(value), float(want_value), rtol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w["w"]), rtol=2e-3, atol=1e-6)


def test_pixel_gradient_vs_finite_differences():
    """tests/test_diff.py:103-128 on the port: the gradient of the pixel
    loss through the Function against central differences along 3 random
    unit directions, in fp32 as the JAX test takes them, and in fp64 through
    the plain transport."""
    smoke = _chip_smoke()
    d = disk_setup()
    npix, s, T = 256, 8, 4
    wi_img, eps = _pixel_inputs(npix, s, seed=4)
    shapes = [tuple(layer["w"].shape) for layer in d.tv]
    flat = torch.cat([layer["w"].reshape(-1) for layer in d.tv])

    def loss(f, transport):
        v, at = [], 0
        for shape in shapes:
            v.append({"w": f[at:at + math.prod(shape)].reshape(shape)})
            at += math.prod(shape)
        b = {"net": [{k: t.to(f.dtype) for k, t in layer.items()} for layer in d.tb["net"]]}
        return smoke.pixel_loss(v, b, tt(wi_img).to(f.dtype), tt(eps).to(f.dtype), T, transport)

    def k3(p, x0, c):
        return tfused.fused_transport_diff("disk", p, x0, c, T)

    def plain(p, x0, c):
        return transport_with_det("disk", p, x0, c, T)

    leaf = flat.clone().requires_grad_()
    value = loss(leaf, k3)
    assert math.isfinite(float(value))
    (grad,) = torch.autograd.grad(value, leaf)
    rng = np.random.default_rng(0)
    h = 3e-3
    with torch.no_grad():
        for _ in range(3):
            dv = rng.standard_normal(flat.shape[0])
            dv /= np.linalg.norm(dv)
            d32, d64 = torch.from_numpy(dv.astype(np.float32)), torch.from_numpy(dv)
            fd = (float(loss(flat + h * d32, k3)) - float(loss(flat - h * d32, k3))) / (2 * h)
            f64 = flat.double()
            fd64 = (float(loss(f64 + h * d64, plain)) - float(loss(f64 - h * d64, plain))) / (2 * h)
            ad = float(grad.double() @ d64)
            np.testing.assert_allclose(ad, fd, rtol=5e-2, atol=1e-5)
            np.testing.assert_allclose(ad, fd64, rtol=1e-3, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_gradcheck_float64(case):
    """torch.autograd.gradcheck of the Function in float64 at n = 8, T = 2
    (fast mode: a random projection of the Jacobian, every input at once)."""
    domain, _, reverse = CASES[case]
    s, x0 = _case(domain, n=8)
    ws = [layer["w"].double().requires_grad_() for layer in s.tv]
    x = torch.from_numpy(x0).double().requires_grad_()
    c = s.t_cond.double().requires_grad_()

    def fn(x, c, *ws):
        return tfused.fused_transport_diff(domain, [{"w": w} for w in ws], x, c, 2, reverse)

    assert torch.autograd.gradcheck(fn, (x, c, *ws), fast_mode=True)


def test_teacher_has_no_det_instantiation():
    """K3 is built for the 6 x 64 teacher without the det only, so the
    differentiable transport refuses it, on any device."""
    s = sph_setup(8)
    k1 = jax.random.key(1)
    from bsdf_diffusion_sampling_tpu.core.config import ModelConfig
    from bsdf_diffusion_sampling_tpu.models import velocity_init

    teacher = params_from_jax(velocity_init(k1, ModelConfig(domain="spherical", velocity_hidden=64,
                                                            velocity_layers=6)), "cpu")
    with pytest.raises(ValueError, match="no det instantiation"):
        tfused.fused_transport_diff("spherical", teacher, tt(np.zeros((8, 2))), s.t_cond, 8)


def test_forward_saves_no_step_activations():
    """The Function's graph holds the inputs only: what autograd saved for
    the backward is x0, cond_enc and the weights."""
    s, x0 = _case("disk", n=16)
    ws = [layer["w"].clone().requires_grad_() for layer in s.tv]
    x = tt(x0).requires_grad_()
    xo, _ = tfused.fused_transport_diff("disk", [{"w": w} for w in ws], x, s.t_cond, 4)
    saved = xo.grad_fn.saved_tensors
    assert len(saved) == 2 + len(ws)
    assert sum(t.numel() for t in saved) == x.numel() + s.t_cond.numel() + sum(w.numel() for w in ws)
