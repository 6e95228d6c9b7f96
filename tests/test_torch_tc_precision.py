"""Whether 3xTF32 tensor-core products keep the sample+pdf transport to
the kernels' fp32 gates, checked on the CPU before any card runs it.

K1 and K4 (`csrc/ode_mlp_tc.cuh`) run the hidden 32 x 32 products of the
velocity MLP on TF32 tensor cores with each operand split a = hi + lo,
hi = tf32(a), lo = tf32(a - hi), and take hi*hi + hi*lo + lo*hi with fp32
sums; layer 0 and the output layer stay fp32. This file emulates that:
`tf32` rounds as `cvt.rna.tf32.f32` does (to nearest, ties away from 0,
the low 13 mantissa bits cleared), and `transport_3xtf32` is the kernels'
forward-mode transport (two tangent streams carried across the T steps,
one 2x2 det at the end) with the hidden products so split. The emulation
isolates the split: its sigmoid is exact (`torch.sigmoid`), where the
kernels take `__expf` and `__frcp_rn`, so it does not bound the shipped
kernels. Their own precision check is chip_smoke.py's `check_strong`,
which holds K1 and K4 to their gates on weights like these.

Held, on 4,096 rows of numpy-seeded weights and x0, for K1's net (disk
3 x 32, T = 4) and K4's (spherical 4 x 32, T = 8), with weights that move
x by O(1) as a trained flow does (`_weights`):
- against the port's fp32 `ode/flow.py::transport_with_det`, x to a
  quarter of the card's kernel-vs-plain gate and the det to a quarter of
  its relative gate (`chip_smoke.py`: disk 1e-5 / 1e-4, spherical
  2e-5 / 2e-4), so that the kernels keep room for their own rounding;
- against the JAX package's XLA transport (`ode/flow.py`: the scan of
  `ode_sample_only` for x, its `_velocity_and_jac` and `_step_det` for the
  det product) at the tolerances of tests/test_torch_ode.py: x 1e-5
  absolute, det 1e-4 relative.
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

from bsdf_diffusion_sampling_tpu.ode import flow as jflow
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition
from bsdf_diffusion_sampling_tpu_torch.ode.flow import transport_with_det

N = 4096
# (domain, hidden, layers, T, card gate on x, card gate on the det/pdf, relative)
NETS = {"K1 disk 3x32": ("disk", 32, 3, 4, 1e-5, 1e-4),
        "K4 spherical 4x32": ("spherical", 32, 4, 8, 2e-5, 2e-4)}
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


def transport_3xtf32(domain: str, v_params: list, x: torch.Tensor, cond: torch.Tensor, T: int, mm=mm_3xtf32):
    """The kernels' transport: T forward Euler steps with the two tangent
    streams d(state)/d(x_start) carried, one det at the end; the hidden
    products through `mm`, layer 0 and the output layer in fp32."""
    w0 = v_params[0]["w"]
    xe_cols = w0.shape[0] - 1 - cond.shape[1]
    cp = cond @ w0[xe_cols + 1:]  # the step-invariant part of layer 0
    h = 1.0 / T
    m = torch.eye(2).expand(x.shape[0], 2, 2).clone()
    for t in range(T):
        xe, mi = _encode(domain, x, m)
        z = xe @ w0[:xe_cols] + (t * h) * w0[xe_cols] + cp
        g = mi @ w0[:xe_cols]  # (N, 2, H)
        a, d = _silu_and_slope(z)
        g = d[:, None] * g
        for layer in v_params[1:-1]:
            z = mm(a, layer["w"])
            g = mm(g.reshape(-1, g.shape[-1]), layer["w"]).reshape(g.shape)
            a, d = _silu_and_slope(z)
            g = d[:, None] * g
        v, tv = a @ v_params[-1]["w"], g @ v_params[-1]["w"]
        m = m + h * tv
        x = x + h * v
    det = m[:, 0, 0] * m[:, 1, 1] - m[:, 1, 0] * m[:, 0, 1]
    return x, det


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


def _setup(domain: str, hidden: int, layers: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    cfg = ModelConfig(domain=domain, velocity_hidden=hidden, velocity_layers=layers)
    if domain == "disk":
        omega = rng.uniform(-0.6, 0.6, (N, 2))
        x0 = rng.normal(0.0, 0.35, (N, 2))
    else:
        omega = np.stack([rng.uniform(0.1, 1.4, N), rng.uniform(-3.0, 3.0, N)], -1)
        x0 = np.stack([rng.uniform(0.1, 1.5, N), rng.uniform(-math.pi, math.pi, N)], -1)
    cond = encode_condition(torch.from_numpy(omega.astype(np.float32)), cfg)
    v = _weights(rng, cfg.velocity_in_dim, hidden, layers)
    tv = [{"w": torch.from_numpy(layer["w"])} for layer in v]
    return v, tv, torch.from_numpy(x0.astype(np.float32)), cond


def _jax_transport_with_det(domain: str, v: list, x0: np.ndarray, cond: np.ndarray, T: int):
    """x from the JAX package's `ode_sample_only`, the det product from its
    own step: `_velocity_and_jac` and `_step_det` over the forward steps."""
    jv = [{"w": jnp.asarray(layer["w"])} for layer in v]
    x_end = jflow.ode_sample_only(domain, jv, jnp.asarray(x0), jnp.asarray(cond), T)
    step = jax.jit(lambda x, a: jflow._velocity_and_jac(domain, jv, x, a, jnp.asarray(cond)))
    x, det = jnp.asarray(x0), jnp.ones(x0.shape[0], jnp.float32)
    for t in range(T):
        vel, j0, j1 = step(x, jnp.float32(t / T))
        det = det * jflow._step_det(j0, j1, 1.0 / T, 1.0)
        x = x + (1.0 / T) * vel
    return np.asarray(x_end), np.asarray(det)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs()).max())


@pytest.fixture(scope="module", params=list(NETS), ids=list(NETS))
def net(request):
    domain, hidden, layers, T, gate_x, gate_det = NETS[request.param]
    v, tv, x0, cond = _setup(domain, hidden, layers)
    with torch.no_grad():
        ref = transport_with_det(domain, tv, x0, cond, T)
        tc = transport_3xtf32(domain, tv, x0, cond, T)
        one = transport_3xtf32(domain, tv, x0, cond, T, mm=mm_1xtf32)
    return dict(name=request.param, domain=domain, T=T, gate_x=gate_x, gate_det=gate_det, v=v, x0=x0,
                cond=cond, ref=ref, tc=tc, one=one)


def test_3xtf32_holds_a_quarter_of_the_card_gates(net):
    (x, det), (xr, detr), (x1, det1) = net["tc"], net["ref"], net["one"]
    err_x, err_det = float((x - xr).abs().max()), _rel(det, detr)
    print(f"\n{net['name']}: 3xTF32 x {err_x:.3g} abs, det {err_det:.3g} rel; "
          f"single-pass TF32 (not gated) x {float((x1 - xr).abs().max()):.3g}, det {_rel(det1, detr):.3g}")
    assert bool(torch.isfinite(x).all() and torch.isfinite(det).all())
    assert err_x <= net["gate_x"] / 4, err_x
    assert err_det <= net["gate_det"] / 4, err_det


def test_3xtf32_matches_the_jax_transport(net):
    x, det = net["tc"]
    jx, jdet = _jax_transport_with_det(net["domain"], net["v"], net["x0"].numpy(), net["cond"].numpy(), net["T"])
    np.testing.assert_allclose(x.numpy(), jx, atol=X_ATOL_JAX)
    np.testing.assert_allclose(det.numpy(), jdet, rtol=DET_RTOL_JAX)


def test_the_weights_move_x_by_order_one(net):
    x, det = net["ref"]
    moved = float((x - net["x0"]).abs().max())
    print(f"\n{net['name']}: x moves up to {moved:.3g}, dets in [{float(det.min()):.3g}, {float(det.max()):.3g}]")
    assert 0.5 <= moved <= 10.0
    assert 0.1 <= float(det.min()) and float(det.max()) <= 10.0


def test_carried_tangents_equal_the_step_det_product(net):
    """With fp32 products the carried-tangent transport is the plain
    per-step det product: the 3xTF32 numbers above measure the split alone."""
    with torch.no_grad():
        x, det = transport_3xtf32(net["domain"], [{"w": torch.from_numpy(l["w"])} for l in net["v"]],
                                  net["x0"], net["cond"], net["T"], mm=torch.matmul)
    xr, detr = net["ref"]
    assert float((x - xr).abs().max()) <= 1e-6
    assert _rel(det, detr) <= 1e-5


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
