"""Whether 3xTF32 tensor-core products keep the kernels' transports to
their fp32 gates, checked on the CPU before any card runs it.

K1, K4 and K3 (`csrc/ode_mlp_tc.cuh`) run the hidden products of the
velocity MLP on TF32 tensor cores with each operand split a = hi + lo,
hi = tf32(a), lo = tf32(a - hi), and take hi*hi + hi*lo + lo*hi with fp32
sums; layer 0 and the output layer stay fp32. This file emulates that:
`tf32` rounds as `cvt.rna.tf32.f32` does (to nearest, ties away from 0,
the low 13 mantissa bits cleared), and `transport_3xtf32` is the kernels'
transport (forward or reverse; with the det, two tangent streams carried
across the T steps and one 2x2 det at the end; without it, K3's primal
transport) with the hidden products so split. The emulation
isolates the split: its sigmoid is exact (`torch.sigmoid`), where the
kernels take `__expf` and `__frcp_rn`, so it does not bound the shipped
kernels. Their own precision check is chip_smoke.py's `check_strong`,
which holds K1, K4 and K3 to their gates on weights like these.

Held, on numpy-seeded weights and x0, for K1's net (disk 3 x 32, T = 4,
4,096 rows), K4's (spherical 4 x 32, T = 8, 4,096 rows), K3's on the render
path (the same net in reverse with the det, T = 8, from the forward
transport's end points, 4,096 rows) and K3's teacher (spherical 6 x 64
primal, T = 128, 1,024 rows), with weights that move x by O(1) as a
trained flow does (`_weights`):
- against the port's fp32 `ode/flow.py::transport_with_det`, x to a
  quarter of the card's kernel-vs-plain gate and the det to a quarter of
  its relative gate (`chip_smoke.py`: disk 1e-5 / 1e-4, spherical
  2e-5 / 2e-4), so that the kernels keep room for their own rounding;
- against the JAX package's XLA transport
  (`ops/fused_ode.py::_xla_transport_with_det`, its `_velocity_and_jac` and
  `_step_det` over the T steps) at the tolerances of
  tests/test_torch_ode.py: x 1e-5 absolute, det 1e-4 relative (x only for
  the primal transport, which takes no det).
Single-pass TF32 (hi*hi only) is printed beside it and not gated: it keeps
about three decimal digits, and at these weights misses the gates (x ~1e-3
off).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.ops.fused_ode import _xla_transport_with_det
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition
from bsdf_diffusion_sampling_tpu_torch.ode.flow import transport_with_det

# (domain, hidden, layers, T, reverse, with the det, rows, card gate on x,
# card gate on the det/pdf, relative)
NETS = {"K1 disk 3x32": ("disk", 32, 3, 4, False, True, 4096, 1e-5, 1e-4),
        "K4 spherical 4x32": ("spherical", 32, 4, 8, False, True, 4096, 2e-5, 2e-4),
        "K3 spherical 4x32 reverse det T=8": ("spherical", 32, 4, 8, True, True, 4096, 2e-5, 2e-4),
        "K3 spherical 6x64 primal T=128": ("spherical", 64, 6, 128, False, False, 1024, 2e-5, 2e-4)}
X_ATOL_JAX = 1e-5  # tests/test_torch_ode.py
DET_RTOL_JAX = 1e-4
GAIN = 1.5


def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as `cvt.rna.tf32.f32`: to nearest, ties away
    from zero, on the magnitude bits; the low 13 mantissa bits cleared."""
    u = a.contiguous().numpy().view(np.uint32)
    r = ((u.astype(np.uint64) + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return torch.from_numpy(r.view(np.float32).copy())


def mm_3xtf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xh, wh = tf32(x), tf32(w)
    xl, wl = tf32(x - xh), tf32(w - wh)
    return xl @ wh + xh @ wl + xh @ wh


def mm_1xtf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return tf32(x) @ tf32(w)


def _silu_and_slope(z: torch.Tensor):
    s = torch.sigmoid(z)
    return z * s, s * (1.0 + z * (1.0 - s))


def _encode(domain: str, x: torch.Tensor, m: torch.Tensor):
    """The net's x columns and the carried tangents through the encoding:
    disk (x0, x1); spherical (theta, sin phi, cos phi), whose tangent is
    (m0, cos phi m1, -sin phi m1). m: (N, 2 streams, 2)."""
    if domain == "disk":
        return x, m
    sp, cp = torch.sin(x[:, 1]), torch.cos(x[:, 1])
    xe = torch.stack([x[:, 0], sp, cp], -1)
    mi = torch.stack([m[..., 0], cp[:, None] * m[..., 1], -sp[:, None] * m[..., 1]], -1)
    return xe, mi


def transport_3xtf32(domain: str, v_params: list, x: torch.Tensor, cond: torch.Tensor, T: int, mm=mm_3xtf32,
                     reverse: bool = False, with_jac: bool = True):
    """The kernels' transport: T Euler steps, forward (alpha = t/T, x +=
    v/T) or reverse (alpha = 1 - t/T, x -= v/T); with `with_jac` the two
    tangent streams d(state)/d(x_start) carried and one det at the end,
    else the primal alone and det None. The hidden products through `mm`,
    layer 0 and the output layer in fp32."""
    w0 = v_params[0]["w"]
    xe_cols = w0.shape[0] - 1 - cond.shape[1]
    cp = cond @ w0[xe_cols + 1:]  # the step-invariant part of layer 0
    h = 1.0 / T
    sg = -h if reverse else h
    m = torch.eye(2).expand(x.shape[0], 2, 2).clone()
    for t in range(T):
        alpha = 1.0 - t * h if reverse else t * h
        xe, mi = _encode(domain, x, m)
        z = xe @ w0[:xe_cols] + alpha * w0[xe_cols] + cp
        a, d = _silu_and_slope(z)
        if with_jac:
            g = d[:, None] * (mi @ w0[:xe_cols])  # (N, 2, H)
        for layer in v_params[1:-1]:
            z = mm(a, layer["w"])
            a, d = _silu_and_slope(z)
            if with_jac:
                g = d[:, None] * mm(g.reshape(-1, g.shape[-1]), layer["w"]).reshape(g.shape)
        if with_jac:
            m = m + sg * (g @ v_params[-1]["w"])
        x = x + sg * (a @ v_params[-1]["w"])
    if not with_jac:
        return x, None
    return x, m[:, 0, 0] * m[:, 1, 1] - m[:, 1, 0] * m[:, 0, 1]


def _weights(rng: np.random.Generator, d_in: int, hidden: int, layers: int) -> list:
    """Uniform velocity weights of variance GAIN^2 / d_in. At GAIN = 1.5 the
    transport moves x by O(1) with its dets away from 0, as a trained flow
    does (`test_the_weights_move_x_by_order_one`). chip_smoke.py's main
    weights (Kaiming x 0.5) move x by ~1e-3 only, where even single-pass
    TF32 stays inside the gates; its `check_strong` uses weights like
    these."""
    dims = [d_in] + [hidden] * layers + [2]
    return [{"w": (GAIN * math.sqrt(3.0 / a) * rng.uniform(-1, 1, (a, b))).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def _setup(domain: str, hidden: int, layers: int, T: int, reverse: bool, n: int, seed: int = 0):
    """Weights, their tensors, the transport's start points and cond_enc.
    A reverse transport starts from the fp32 forward transport's end points,
    as the pdf query starts from a sample."""
    rng = np.random.default_rng(seed)
    cfg = ModelConfig(domain=domain, velocity_hidden=hidden, velocity_layers=layers)
    if domain == "disk":
        omega = rng.uniform(-0.6, 0.6, (n, 2))
        x0 = rng.normal(0.0, 0.35, (n, 2))
    else:
        omega = np.stack([rng.uniform(0.1, 1.4, n), rng.uniform(-3.0, 3.0, n)], -1)
        x0 = np.stack([rng.uniform(0.1, 1.5, n), rng.uniform(-math.pi, math.pi, n)], -1)
    cond = encode_condition(torch.from_numpy(omega.astype(np.float32)), cfg)
    v = _weights(rng, cfg.velocity_in_dim, hidden, layers)
    tv = [{"w": torch.from_numpy(layer["w"])} for layer in v]
    x = torch.from_numpy(x0.astype(np.float32))
    if reverse:
        with torch.no_grad():
            x = transport_with_det(domain, tv, x, cond, T)[0]
    return v, tv, x, cond


def _jax_transport_with_det(domain: str, v: list, x: np.ndarray, cond: np.ndarray, T: int, reverse: bool):
    """(x, det product) of the JAX package's `_xla_transport_with_det`."""
    jv = [{"w": jnp.asarray(layer["w"])} for layer in v]
    run = jax.jit(_xla_transport_with_det, static_argnums=(0, 4, 5))
    x_end, det = run(domain, jv, jnp.asarray(x), jnp.asarray(cond), T, reverse)
    return np.asarray(x_end), np.asarray(det)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs()).max())


@pytest.fixture(scope="module", params=list(NETS), ids=list(NETS))
def net(request):
    domain, hidden, layers, T, reverse, jac, n, gate_x, gate_det = NETS[request.param]
    v, tv, x0, cond = _setup(domain, hidden, layers, T, reverse, n)
    with torch.no_grad():
        ref = transport_with_det(domain, tv, x0, cond, T, reverse=reverse)
        tc = transport_3xtf32(domain, tv, x0, cond, T, reverse=reverse, with_jac=jac)
        one = transport_3xtf32(domain, tv, x0, cond, T, mm=mm_1xtf32, reverse=reverse, with_jac=jac)
    return dict(name=request.param, domain=domain, T=T, reverse=reverse, jac=jac, gate_x=gate_x,
                gate_det=gate_det, v=v, tv=tv, x0=x0, cond=cond, ref=ref, tc=tc, one=one)


def test_3xtf32_holds_a_quarter_of_the_card_gates(net):
    (x, det), (xr, detr), (x1, det1) = net["tc"], net["ref"], net["one"]
    err_x = float((x - xr).abs().max())
    err_det = _rel(det, detr) if net["jac"] else 0.0
    one_det = f", det {_rel(det1, detr):.3g}" if net["jac"] else ""
    print(f"\n{net['name']}: 3xTF32 x {err_x:.3g} abs, det {err_det:.3g} rel; "
          f"single-pass TF32 (not gated) x {float((x1 - xr).abs().max()):.3g}{one_det}")
    assert bool(torch.isfinite(x).all()) and (not net["jac"] or bool(torch.isfinite(det).all()))
    assert err_x <= net["gate_x"] / 4, err_x
    assert err_det <= net["gate_det"] / 4, err_det


def test_3xtf32_matches_the_jax_transport(net):
    x, det = net["tc"]
    jx, jdet = _jax_transport_with_det(net["domain"], net["v"], net["x0"].numpy(), net["cond"].numpy(), net["T"],
                                       net["reverse"])
    np.testing.assert_allclose(x.numpy(), jx, atol=X_ATOL_JAX)
    if net["jac"]:
        np.testing.assert_allclose(det.numpy(), jdet, rtol=DET_RTOL_JAX)


def test_the_weights_move_x_by_order_one(net):
    x, det = net["ref"]
    moved = float((x - net["x0"]).abs().max())
    print(f"\n{net['name']}: x moves up to {moved:.3g}, dets in [{float(det.min()):.3g}, {float(det.max()):.3g}]")
    assert 0.5 <= moved <= 10.0
    if net["jac"]:
        assert 0.1 <= float(det.min()) and float(det.max()) <= 10.0


def test_carried_tangents_equal_the_step_det_product(net):
    """With fp32 products the emulated transport is the plain one (with the
    det, the carried tangents give the per-step det product): the 3xTF32
    numbers above measure the split alone."""
    with torch.no_grad():
        x, det = transport_3xtf32(net["domain"], net["tv"], net["x0"], net["cond"], net["T"], mm=torch.matmul,
                                  reverse=net["reverse"], with_jac=net["jac"])
    xr, detr = net["ref"]
    # two fp32 transports, summed in other orders: their rounding adds up
    # like a random walk over the steps, so the bound grows as sqrt(T / 8)
    assert float((x - xr).abs().max()) <= 1e-6 * math.sqrt(max(1.0, net["T"] / 8))
    assert not net["jac"] or _rel(det, detr) <= 1e-5


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    vals = torch.tensor([one, one + ulp / 2, one + ulp / 2 - 2.0 ** -23, -(one + ulp / 2), one + 1.5 * ulp, -0.0],
                        dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one, -(one + ulp), one + 2 * ulp, -0.0])
    assert torch.equal(tf32(vals), want)
    assert (tf32(torch.randn(1000)).numpy().view(np.uint32) & 0x1FFF == 0).all()
    a = torch.randn(1000)
    hi = tf32(a)
    lo = tf32(a - hi)
    assert float(((hi + lo - a).abs() / a.abs()).max()) <= 2.0 ** -21
