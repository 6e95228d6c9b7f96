"""Whether 3xTF32 tensor-core products keep the kernels' transports and
pdf queries to their fp32 gates, checked on the CPU before any card runs
it.

K1, K2, K4 and K3 (`csrc/ode_mlp_tc.cuh`) run the hidden products of the
velocity MLP on TF32 tensor cores with each operand split a = hi + lo,
hi = tf32(a), lo = tf32(a - hi), and take hi*hi + hi*lo + lo*hi with fp32
sums; layer 0 and the output layer stay fp32. This file emulates that:
`tf32` rounds as `cvt.rna.tf32.f32` does (to nearest, ties away from 0,
the low 13 mantissa bits cleared), and `transport_3xtf32` is the kernels'
transport (forward or reverse; with the det, two tangent streams carried
across the T steps and one 2x2 det at the end; without it, K3's primal
transport) with the hidden products so split; `pdf_query_3xtf32` is K2's
disk pdf query and K2s's spherical one: the exact one (for t = T-1..0 a
reverse-Euler warm start, `newton_iters` closed-form 2x2 Newton updates,
the det at the converged point, pdf = p0 / prod det) or, on the disk, the
reverse one (the reverse transport with the det, pdf = p0 * det). The emulation isolates the split: its sigmoid is
exact (`torch.sigmoid`), where the kernels take `__expf` and `__frcp_rn`,
so it does not bound the shipped kernels. Their own precision check is
chip_smoke.py's `check_strong`, which holds K1, K2, K4 and K3 to their
gates on weights like these (K2s beside them).

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
And for K2's net (disk 3 x 32, T = 4, 4,096 rows), exact at 0, 1 and 2
Newton iterations and reverse, and K2s's (spherical 4 x 32, T = 8, 4,096
rows), exact at 0, 1 and 2 iterations, each queried at the fp32 forward
transport's end points:
- against the port's fp32 `ops/fused_ode.py::pdf_disk_plain` and
  `pdf_spherical_plain`, x0 and the pdf to a quarter of the card's gates
  (disk 2.5e-6 and 2.5e-5 relative, spherical 5e-6 and 5e-5);
- against the JAX package's `ode/flow.py::ode_pdf_exact` (exact) and
  `ode_pdf` (reverse), which return the pdf alone, at
  tests/test_torch_fused_ode.py's K2 tolerance: 1e-4 relative.
Single-pass TF32 (hi*hi only) is printed beside it and not gated: it keeps
about three decimal digits, and at these weights misses the gates (x ~1e-3
off).
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu.models import get_base
from bsdf_diffusion_sampling_tpu.ode import flow as jflow
from bsdf_diffusion_sampling_tpu.ops.fused_ode import _xla_transport_with_det
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.models.base_density import (
    disk_heads_from_enc,
    disk_log_prob_from_heads,
    spherical_heads_from_enc,
    spherical_log_prob_from_heads,
)
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition
from bsdf_diffusion_sampling_tpu_torch.ode.flow import transport_with_det
from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import (
    BASE_COLS,
    pdf_disk_plain,
    pdf_spherical_plain,
    prepack_disk,
    prepack_spherical,
)

# (domain, hidden, layers, T, reverse, with the det, rows, card gate on x,
# card gate on the det/pdf, relative)
NETS = {"K1 disk 3x32": ("disk", 32, 3, 4, False, True, 4096, 1e-5, 1e-4),
        "K4 spherical 4x32": ("spherical", 32, 4, 8, False, True, 4096, 2e-5, 2e-4),
        "K3 spherical 4x32 reverse det T=8": ("spherical", 32, 4, 8, True, True, 4096, 2e-5, 2e-4),
        "K3 spherical 6x64 primal T=128": ("spherical", 64, 6, 128, False, False, 1024, 2e-5, 2e-4)}
X_ATOL_JAX = 1e-5  # tests/test_torch_ode.py
DET_RTOL_JAX = 1e-4
GAIN = 1.5
# The pdf queries: (domain, exact, newton_iters); K2 on the disk, K2s spherical
QUERIES = {"K2 exact newton_iters=0": ("disk", True, 0), "K2 exact newton_iters=1": ("disk", True, 1),
           "K2 exact newton_iters=2": ("disk", True, 2), "K2 reverse": ("disk", False, 0),
           "K2s exact newton_iters=0": ("spherical", True, 0), "K2s exact newton_iters=1": ("spherical", True, 1),
           "K2s exact newton_iters=2": ("spherical", True, 2)}
# each query's net: (hidden layers, T, card gate on x0, card gate on the pdf, relative)
QUERY_NETS = {"disk": (3, 4, 1e-5, 1e-4), "spherical": (4, 8, 2e-5, 2e-4)}
QUERY_ROWS = 4096
PDF_RTOL_JAX = 1e-4  # tests/test_torch_fused_ode.py
DET_GUARD = 1e-20  # csrc/fused_ode.cu, as the JAX kernel's fused_ode.py:925-926


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


def velocity_3xtf32(v_params: list, xe: torch.Tensor, alpha: float, cp: torch.Tensor, mi=None, mm=mm_3xtf32):
    """One velocity evaluation as the kernels take it: (v (N, 2), tv), with
    the hidden products through `mm`, layer 0 (its condition part `cp`
    given) and the output layer in fp32. With input tangents `mi` (N, 2,
    x columns), tv[:, k] = J_enc mi[:, k], else None."""
    w0 = v_params[0]["w"]
    xe_cols = xe.shape[-1]
    z = xe @ w0[:xe_cols] + alpha * w0[xe_cols] + cp
    a, d = _silu_and_slope(z)
    g = None if mi is None else d[:, None] * (mi @ w0[:xe_cols])  # (N, 2, H)
    for layer in v_params[1:-1]:
        z = mm(a, layer["w"])
        a, d = _silu_and_slope(z)
        if g is not None:
            g = d[:, None] * mm(g.reshape(-1, g.shape[-1]), layer["w"]).reshape(g.shape)
    return a @ v_params[-1]["w"], None if g is None else g @ v_params[-1]["w"]


def _cond_part(v_params: list, cond: torch.Tensor) -> torch.Tensor:
    """cond_enc @ W0[x columns + 1:]: the step-invariant part of layer 0."""
    return cond @ v_params[0]["w"][-cond.shape[1]:]


def transport_3xtf32(domain: str, v_params: list, x: torch.Tensor, cond: torch.Tensor, T: int, mm=mm_3xtf32,
                     reverse: bool = False, with_jac: bool = True):
    """The kernels' transport: T Euler steps, forward (alpha = t/T, x +=
    v/T) or reverse (alpha = 1 - t/T, x -= v/T); with `with_jac` the two
    tangent streams d(state)/d(x_start) carried and one det at the end,
    else the primal alone and det None."""
    cp = _cond_part(v_params, cond)
    h = 1.0 / T
    sg = -h if reverse else h
    m = torch.eye(2).expand(x.shape[0], 2, 2).clone()
    for t in range(T):
        alpha = 1.0 - t * h if reverse else t * h
        xe, mi = _encode(domain, x, m)
        v, tv = velocity_3xtf32(v_params, xe, alpha, cp, mi if with_jac else None, mm)
        if with_jac:
            m = m + sg * tv
        x = x + sg * v
    if not with_jac:
        return x, None
    return x, m[:, 0, 0] * m[:, 1, 1] - m[:, 1, 0] * m[:, 0, 1]


def pdf_query_3xtf32(domain: str, v_params: list, base_params: dict, y: torch.Tensor, cond: torch.Tensor, T: int,
                     exact: bool, newton_iters: int, mm=mm_3xtf32):
    """K2's disk pdf query or K2s's spherical one, (pdf, x0) of query points
    y, as the kernels take it. Exact: for t = T-1..0 the warm start g = y -
    h v(y), `newton_iters` guarded 2x2 Newton updates of g + h v(g) = y and
    det(I + h J) at the last g, all in one loop, then y = g; pdf = p0 /
    prod det. Otherwise (disk) the reverse transport with the det; pdf = p0
    * det. The net reads the encoded state, and the identity's tangents
    through the encoding; p0 from the base heads in fp32."""
    if exact:
        cp = _cond_part(v_params, cond)
        h = 1.0 / T
        eye = torch.eye(2).expand(y.shape[0], 2, 2)
        det_acc = torch.ones(y.shape[0])
        for t in range(T - 1, -1, -1):
            alpha = t * h
            g = y - h * velocity_3xtf32(v_params, _encode(domain, y, eye)[0], alpha, cp, mm=mm)[0]
            for it in range(newton_iters + 1):
                xe, mi = _encode(domain, g, eye)
                v, tv = velocity_3xtf32(v_params, xe, alpha, cp, mi, mm)  # tv[:, k] = column k of J
                a, b = 1.0 + h * tv[:, 0, 0], h * tv[:, 1, 0]
                c, d = h * tv[:, 0, 1], 1.0 + h * tv[:, 1, 1]
                det = a * d - b * c
                if it == newton_iters:
                    det_acc = det_acc * det
                    break
                f = g + h * v - y
                dg = torch.where(det.abs() > DET_GUARD, det, torch.ones_like(det))
                g = g - torch.stack([(d * f[:, 0] - b * f[:, 1]) / dg, (-c * f[:, 0] + a * f[:, 1]) / dg], -1)
            y = g
        x0, det = y, det_acc
    else:
        x0, det = transport_3xtf32(domain, v_params, y, cond, T, mm=mm, reverse=True)
    enc = cond[:, :BASE_COLS]
    if domain == "disk":
        p0 = torch.exp(disk_log_prob_from_heads(*disk_heads_from_enc(base_params, enc), x0))
    else:
        p0 = torch.exp(spherical_log_prob_from_heads(spherical_heads_from_enc(base_params, enc), x0))
    return (p0 / det if exact else p0 * det), x0


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
    """Weights, their tensors, the transport's start points, cond_enc and
    omega_i. A reverse transport starts from the fp32 forward transport's
    end points, as the pdf query starts from a sample."""
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
    return v, tv, x, cond, omega.astype(np.float32)


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
    v, tv, x0, cond, _ = _setup(domain, hidden, layers, T, reverse, n)
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


def _plain_query(s: dict, exact: bool, iters: int):
    """The port's fp32 plain version of the query: K2's, or K2s's."""
    if s["domain"] == "disk":
        return pdf_disk_plain(s["w"], s["y"], s["cond"], s["T"], exact=exact, newton_iters=iters)
    return pdf_spherical_plain(s["w"], s["y"], s["cond"], s["T"], newton_iters=iters)


@pytest.fixture(scope="module")
def k2_net():
    """The query nets on O(1)-moving weights, by domain: K2's (disk) and
    K2s's (spherical), each with the JAX package's base of its domain, and
    their query points: the fp32 forward transport's end points."""
    out = {}
    for domain, (layers, T, gate_x, gate_pdf) in QUERY_NETS.items():
        v, tv, y, cond, omega = _setup(domain, 32, layers, T, True, QUERY_ROWS, seed=1)
        b = get_base(domain).init(jax.random.key(1))
        prepack = prepack_disk if domain == "disk" else prepack_spherical
        out[domain] = dict(domain=domain, T=T, gate_x=gate_x, gate_pdf=gate_pdf, v=v, tv=tv, y=y, cond=cond,
                           omega=omega, b=b, w=prepack(tv, params_from_jax(b, "cpu")))
    return out


@pytest.fixture(scope="module", params=list(QUERIES), ids=list(QUERIES))
def k2_query(request, k2_net):
    domain, exact, iters = QUERIES[request.param]
    s = k2_net[domain]
    args = (domain, s["tv"], s["w"].base_params, s["y"], s["cond"], s["T"], exact, iters)
    with torch.no_grad():
        ref = _plain_query(s, exact, iters)
        tc = pdf_query_3xtf32(*args)
        one = pdf_query_3xtf32(*args, mm=mm_1xtf32)
    return dict(name=request.param, exact=exact, iters=iters, ref=ref, tc=tc, one=one, **s)


def test_k2_3xtf32_holds_a_quarter_of_the_card_gates(k2_query):
    (pdf, x0), (pdf_r, x0_r), (pdf_1, x0_1) = k2_query["tc"], k2_query["ref"], k2_query["one"]
    err_x, err_pdf = float((x0 - x0_r).abs().max()), _rel(pdf, pdf_r)
    print(f"\n{k2_query['name']}: 3xTF32 x0 {err_x:.3g} abs, pdf {err_pdf:.3g} rel; single-pass TF32 (not "
          f"gated) x0 {float((x0_1 - x0_r).abs().max()):.3g}, pdf {_rel(pdf_1, pdf_r):.3g}; x moves up to "
          f"{float((x0_r - k2_query['y']).abs().max()):.3g}")
    assert bool(torch.isfinite(pdf).all() and torch.isfinite(x0).all())
    assert bool((pdf_r > 0).all())  # no det changes sign: the map stays invertible
    assert err_x <= k2_query["gate_x"] / 4, err_x
    assert err_pdf <= k2_query["gate_pdf"] / 4, err_pdf


def test_k2_3xtf32_matches_the_jax_pdf(k2_query):
    s = k2_query
    jv = [{"w": jnp.asarray(layer["w"])} for layer in s["v"]]
    args = (s["domain"], jv, s["b"], jnp.asarray(s["y"].numpy()), jnp.asarray(s["omega"]),
            jnp.asarray(s["cond"].numpy()), s["T"])
    want = jflow.ode_pdf_exact(*args, newton_iters=s["iters"]) if s["exact"] else jflow.ode_pdf(*args)
    np.testing.assert_allclose(s["tc"][0].numpy(), np.asarray(want), rtol=PDF_RTOL_JAX)


def test_k2_exact_query_with_fp32_products_is_the_plain_one(k2_net):
    """With fp32 products the emulated Newton loop is the plain
    `newton_inverse` (the updates and the det in one loop there too, by
    another route), for K2's query and K2s's: the 3xTF32 numbers above
    measure the split alone. Two fp32 orders still differ: the spherical
    state reaches |phi| ~ pi, where an ulp is 2.4e-7, and its T = 8 inverse
    of the 4 x 32 net carries the rounding of the plain version's one
    26-column layer-0 product against the kernels' split one; seeds 1-3
    read up to 2.0e-6 in x0 and 3.4e-6 in the pdf, so x0 is held to 4e-6
    there and to 1e-6 on the disk."""
    for domain, s in k2_net.items():
        with torch.no_grad():
            pdf, x0 = pdf_query_3xtf32(domain, s["tv"], s["w"].base_params, s["y"], s["cond"], s["T"], True, 2,
                                       mm=torch.matmul)
            pdf_r, x0_r = _plain_query(s, True, 2)
        assert float((x0 - x0_r).abs().max()) <= (1e-6 if domain == "disk" else 4e-6), domain
        assert _rel(pdf, pdf_r) <= 1e-5, domain
