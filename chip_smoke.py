#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit (`nvcc`):

    python3 chip_smoke.py               # every phase; last line {"ok": true, ...}
    python3 chip_smoke.py --check-only  # build and kernel-vs-plain checks only

Phases, each of which raises on failure:
  1. build the CUDA kernels from `bsdf_diffusion_sampling_tpu_torch/csrc/`;
  2. print the card's name and power limit; turn TF32 off;
  3. make full-width disk weights from a numpy seed, write them with the
     port's `.npz` writer, read them back, and build the neural BSDF;
  4. hold each kernel against its plain PyTorch version on the card, at
     the main path's 2^20 rows and at 2^20 - 37 (a partly masked block);
  5. drive the main path: bounces of neural_sample -> neural_pdf at
     2^20 queries, with the kernels' launch counts read around it;
  6. time each kernel, its plain version and its bound;
  7. print the `kernels` line and the `ok` line.

Imports nothing of JAX: the port stands alone on the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, SamplerConfig
from bsdf_diffusion_sampling_tpu_torch.core.prng import root_generator
from bsdf_diffusion_sampling_tpu_torch.models.base_density import disk_heads_from_enc
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition
from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build
from bsdf_diffusion_sampling_tpu_torch.ops import fused_ode as fo
from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf, neural_pdf, neural_sample
from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import load_pytree, save_pytree

N_MAIN = 1 << 20  # the wavefront of the main path, the checks and the timings
N_RAGGED = N_MAIN - 37  # a size whose last block of 128 threads is partly masked
BOUNCES = 4
RUNS = 7  # timed runs; the median is kept
SEED = 0

# Kernel vs plain, both fp32 on the card. The two sum in other orders, so
# they differ by rounding only: ~1e-7 in x, ~1e-6 relative in the pdf.
TOL_X_ABS = 1e-5
TOL_PDF_REL = 1e-4
# Moments of the in-kernel normals over n draws: the standard errors are
# 1/sqrt(n) for the mean and 1/sqrt(2n) for the std; allow 5/sqrt(n)
# (0.0049 at N_MAIN).
MOMENT_SIGMAS = 5.0
# Main path: a draw is valid when r^2 <= 0.995. With these random weights
# about a quarter of the draws are (0.243 in a 2^14-row rehearsal on the
# CPU); 0.1 is far below that. The pdf query at a draw inverts the draw's own map, so it
# gives back the draw's pdf to Newton tolerance (the contract of the JAX
# package's tests/test_fused_sample_pdf.py:143-171).
MIN_VALID_FRACTION = 0.1
TOL_CONTRACT_MEDIAN = 1e-3

# Published dense fp32 (CUDA-core) rates and memory rates, by card.
PEAKS = {  # name fragment: (fp32 FLOP/s, bytes/s)
    "PCIe": (51.2e12, 2.0e12),
    "NVL": (60e12, 3.9e12),
    "H100": (67e12, 3.35e12),  # SXM
}


def log(msg: str) -> None:
    print(msg, flush=True)


def init_weights(seed: int) -> dict:
    """Full-width disk weights, Kaiming-uniform as the JAX package's
    `models/mlp.py:21-38` draws them; velocity weights scaled by 0.5 so the
    Euler map stays invertible, as the JAX tests do."""
    rng = np.random.default_rng(seed)
    cfg = ModelConfig()

    def layers(dims, bias, scale=1.0):
        out = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            bound = 1.0 / math.sqrt(d_in)
            layer = {"w": (scale * rng.uniform(-bound, bound, (d_in, d_out))).astype(np.float32)}
            if bias:
                layer["b"] = rng.uniform(-bound, bound, (d_out,)).astype(np.float32)
            out.append(layer)
        return out

    v_dims = [cfg.velocity_in_dim] + [cfg.velocity_hidden] * cfg.velocity_layers + [2]
    b_dims = [2 * (2 * cfg.base_pe_bands + 1), cfg.base_hidden, 4]
    return {"base": {"net": layers(b_dims, True)}, "rectified": layers(v_dims, False, 0.5)}


def hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Local directions with cos(theta) in [0.1, 0.95] from uniforms (N, 2)."""
    ct = 0.1 + 0.85 * u[:, 0]
    st = torch.sqrt(1.0 - ct * ct)
    phi = 2.0 * math.pi * u[:, 1]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.where(a == b, 0.0, (a - b).abs() / b.abs()).max())


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def gap_stats(pdf_q: torch.Tensor, pdf: torch.Tensor) -> dict:
    """|pdf_q / pdf - 1| over the rows given: the share that is exactly 0,
    the median, p90 and max."""
    rel = (pdf_q / pdf - 1.0).abs()
    return {"exact_share": float((pdf_q == pdf).float().mean()), "median": float(rel.median()),
            "p90": float(rel.quantile(0.9)), "max": float(rel.max())}


def check_kernels(nb, device, n: int) -> dict:
    """Phase 4: each kernel against its plain version on the same n rows.
    The rows are a prefix of one set of N_MAIN inputs."""
    rng = np.random.default_rng(SEED + 1)
    wi = hemisphere(torch.from_numpy(rng.random((N_MAIN, 2), dtype=np.float32)).to(device))[:n]
    cond = encode_condition(wi[:, :2], nb.cfg)
    eps = torch.from_numpy(rng.standard_normal((N_MAIN, 2), dtype=np.float32)).to(device)[:n]
    w, T = nb.packed, nb.T
    out = {}
    log(f"  n = {n}")

    x, pdf, x0 = fo.fused_sample_pdf_disk(w, cond, T, eps=eps)
    xp, pdfp, x0p = fo.sample_pdf_disk_plain(w, cond, T, eps=eps)
    k1 = {"x_abs": max_abs(x, xp), "x0_abs": max_abs(x0, x0p), "pdf_rel": max_rel(pdf, pdfp)}
    log(f"  K1 eps   vs plain: {k1}")

    seed = 20240601
    xs, pdfs, x0s = fo.fused_sample_pdf_disk(w, cond, T, seed=seed)
    eps_ph = fo.philox_normals(seed, n).to(device)
    _, pdf_at_x0, _ = fo.sample_pdf_disk_plain(w, cond, T, x0=x0s)
    _, _, x0_ph = fo.sample_pdf_disk_plain(w, cond, T, eps=eps_ph)
    loc, ls = disk_heads_from_enc(nb.base_params, cond[:, :fo.BASE_COLS])
    z = (x0s - loc) / torch.exp(ls)
    k1p = {"pdf_rel_at_own_x0": max_rel(pdfs, pdf_at_x0), "x0_abs_vs_plain_philox": max_abs(x0s, x0_ph),
           "z_mean": z.mean(0).tolist(), "z_std": z.std(0).tolist()}
    log(f"  K1 philox vs plain: {k1p}")

    pe, x0e = fo.fused_pdf_disk(w, x, cond, T, exact=True, newton_iters=nb.pdf_newton_iters)
    pep, x0ep = fo.pdf_disk_plain(w, x, cond, T, exact=True, newton_iters=nb.pdf_newton_iters)
    k2 = {"x0_abs": max_abs(x0e, x0ep), "pdf_rel": max_rel(pe, pep)}
    log(f"  K2 exact vs plain: {k2}")
    pr, x0r = fo.fused_pdf_disk(w, x, cond, T, exact=False)
    prp, x0rp = fo.pdf_disk_plain(w, x, cond, T, exact=False)
    k2r = {"x0_abs": max_abs(x0r, x0rp), "pdf_rel": max_rel(pr, prp)}
    log(f"  K2 reverse vs plain: {k2r}")
    # Round trip at the valid draws: the Newton solve lands on each forward
    # step's preimage where the step's float residual is exactly 0, so K2
    # often gives back K1's x0 to the bit.
    valid = (x * x).sum(-1) <= nb.disk_valid_r2
    log(f"  K1 -> K2 exact round trip, valid draws: x0 to the bit "
        f"{float((x0e[valid] == x0[valid]).all(-1).float().mean()):.4f}, pdf gap {gap_stats(pe[valid], pdf[valid])}")

    for name, t in (("x", x), ("pdf", pdf), ("x0", x0), ("x_seed", xs), ("pdf_seed", pdfs),
                    ("pdf_exact", pe), ("pdf_reverse", pr)):
        require(bool(torch.isfinite(t).all()), f"non-finite kernel output {name}")
    require(max(k1["x_abs"], k1["x0_abs"], k2["x0_abs"], k2r["x0_abs"], k1p["x0_abs_vs_plain_philox"])
            <= TOL_X_ABS, "kernel x/x0 differs from the plain version")
    require(max(k1["pdf_rel"], k1p["pdf_rel_at_own_x0"], k2["pdf_rel"], k2r["pdf_rel"]) <= TOL_PDF_REL,
            "kernel pdf differs from the plain version")
    tol_moment = MOMENT_SIGMAS / math.sqrt(n)
    require(all(abs(m) <= tol_moment for m in k1p["z_mean"]), "in-kernel normals: mean off 0")
    require(all(abs(s - 1.0) <= tol_moment for s in k1p["z_std"]), "in-kernel normals: std off 1")
    out["fused_sample_pdf_disk"] = {
        "max_abs_err": max(k1["x_abs"], k1["x0_abs"], k1p["x0_abs_vs_plain_philox"]),
        "max_rel_err": max(k1["pdf_rel"], k1p["pdf_rel_at_own_x0"]),
    }
    out["fused_pdf_disk"] = {
        "max_abs_err": max(k2["x0_abs"], k2r["x0_abs"]),
        "max_rel_err": max(k2["pdf_rel"], k2r["pdf_rel"]),
    }
    return out


def main_path(nb, device) -> dict:
    """Phase 5: bounces of sample -> pdf query at N_MAIN, counts around it."""
    gen = root_generator(SEED + 2, device)
    stats = []
    fo.reset_launches()
    for b in range(BOUNCES):
        before = dict(fo.launches)
        wi = hemisphere(torch.rand((N_MAIN, 2), generator=gen, device=device))
        wo, pdf = neural_sample(nb, gen, wi)
        pdf_q = neural_pdf(nb, wi, wo)
        ok = pdf > 1e-6
        s = {"bounce": b, "valid_fraction": float((pdf > 0).float().mean()),
             "gap": gap_stats(pdf_q[ok], pdf[ok]), "finite": bool(torch.isfinite(wo).all()
                                                                  and torch.isfinite(pdf).all()
                                                                  and torch.isfinite(pdf_q).all())}
        log(f"bounce {s}")
        require(s["finite"], "non-finite main-path output")
        require(s["valid_fraction"] >= MIN_VALID_FRACTION, "too few valid draws")
        require(s["gap"]["median"] < TOL_CONTRACT_MEDIAN, "pdf query disagrees with the sampler's pdf")
        require(all(fo.launches[k] > before[k] for k in fo.launches), "a kernel was not launched this bounce")
        stats.append(s)
    counts = dict(fo.launches)
    log(f"launches on the main path: {counts}")
    return counts


def cuda_ms(fn, runs=RUNS, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def work(nb, n: int) -> dict:
    """Multiply-adds and bytes each kernel's function needs at n rows. The
    condition's part of the first layer is taken once per sample; the
    sigmoids and exps are not counted."""
    h, l, t, it = nb.packed.hidden, nb.packed.layers, nb.T, nb.pdf_newton_iters
    once = fo.COND_DIM * h + fo.BASE_COLS * 16 + 16 * 4  # cond part of W0, base heads
    primal = 3 * h + (l - 1) * h * h + 2 * h
    tangent = 2 * h + (l - 1) * h * h + 2 * h
    step = primal + 2 * tangent
    return {
        # cond_enc and a seed in; x, pdf, x0 out
        "fused_sample_pdf_disk": (n * (once + t * step), n * (4 * fo.COND_DIM + 20)),
        # x and cond_enc in; pdf, x0 out
        "fused_pdf_disk": (n * (once + t * (primal + (it + 1) * step)), n * (4 * fo.COND_DIM + 8 + 12)),
    }


def times(nb, device, name: str) -> dict:
    """Phase 6: kernel, plain version and bound at N_MAIN."""
    flops_peak, bytes_peak = next(v for k, v in PEAKS.items() if k in name)
    rng = np.random.default_rng(SEED + 3)
    wi = hemisphere(torch.from_numpy(rng.random((N_MAIN, 2), dtype=np.float32)).to(device))
    cond = encode_condition(wi[:, :2], nb.cfg)
    eps = torch.from_numpy(rng.standard_normal((N_MAIN, 2), dtype=np.float32)).to(device)
    w, T, it = nb.packed, nb.T, nb.pdf_newton_iters
    seed = torch.tensor([7], dtype=torch.int64, device=device)
    x, _, _ = fo.fused_sample_pdf_disk(w, cond, T, seed=seed)
    runs = {
        "fused_sample_pdf_disk": (lambda: fo.fused_sample_pdf_disk(w, cond, T, seed=seed),
                                  lambda: fo.sample_pdf_disk_plain(w, cond, T, eps=eps)),
        "fused_pdf_disk": (lambda: fo.fused_pdf_disk(w, x, cond, T, exact=True, newton_iters=it),
                           lambda: fo.pdf_disk_plain(w, x, cond, T, exact=True, newton_iters=it)),
    }
    out = {}
    for k, (macs, nbytes) in work(nb, N_MAIN).items():
        t_ops, t_bytes = 2.0 * macs / flops_peak * 1e3, nbytes / bytes_peak * 1e3
        kern, plain = runs[k]
        ms = cuda_ms(kern)
        with torch.no_grad():
            plain_ms = cuda_ms(plain, runs=5, warmup=1)
        out[k] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                  "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                  "meval_per_s": N_MAIN / ms / 1e3, "flop": 2 * macs, "bytes": nbytes}
        log(f"time {k}: {out[k]}")
    # one whole bounce as the main path runs it: the kernels plus the
    # encoding, lifting and masking around them
    gen = root_generator(SEED + 4, device)
    nb_ms = cuda_ms(lambda: neural_pdf(nb, wi, neural_sample(nb, gen, wi)[0]))
    share = (out["fused_sample_pdf_disk"]["ms"] + out["fused_pdf_disk"]["ms"]) / nb_ms
    log(f"time bounce (neural_sample + neural_pdf, N={N_MAIN}): {nb_ms:.4f} ms, "
        f"kernels {100 * share:.1f}% of it")
    return out


KERNELS = {
    "fused_sample_pdf_disk": ("K1 disk sample+pdf",
                              "bsdf_diffusion_sampling_tpu/ops/fused_ode.py:579 _fused_sample_pdf_kernel "
                              "(pallas_call :684)"),
    "fused_pdf_disk": ("K2 disk pdf query",
                       "bsdf_diffusion_sampling_tpu/ops/fused_ode.py:943 _fused_pdf_kernel (pallas_call :1017)"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true", help="stop after the kernel-vs-plain checks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    device = torch.device("cuda", 0)

    t0 = time.time()
    libs = cuda_build.build(["fused_ode.cu"])
    log(f"[1] build: {time.time() - t0:.1f} s")
    for src, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    ptxas {src}: {line.strip()}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[2] {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("    TF32 off for matmul and cuDNN: the plain versions run in full fp32")
    name = torch.cuda.get_device_name(0)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "disk.npz")
        tree = init_weights(SEED)
        save_pytree(path, tree, step=1)
        back, step = load_pytree(path)
    require(step == 1 and all(np.array_equal(a["w"], b["w"]) for a, b in zip(tree["rectified"], back["rectified"])),
            "checkpoint round trip changed the weights")
    nb = make_neural_bsdf("disk", ModelConfig(), back["rectified"], back["base"], sampler_cfg=SamplerConfig(),
                          device=device)
    log(f"[3] weights: velocity {[tuple(l['w'].shape) for l in nb.v_params]}, T={nb.T}, "
        f"pdf_exact={nb.pdf_exact}, newton_iters={nb.pdf_newton_iters}")

    t0 = time.time()
    errs = {}
    for n in (N_MAIN, N_RAGGED):
        for k, e in check_kernels(nb, device, n).items():
            errs[k] = {m: max(v, errs.get(k, {}).get(m, 0.0)) for m, v in e.items()}
    log(f"[4] kernels vs plain at n = {N_MAIN} and {N_RAGGED}: ok {errs} ({time.time() - t0:.1f} s)")
    if args.check_only:
        return 0

    t0 = time.time()
    counts = main_path(nb, device)
    log(f"[5] main path: {BOUNCES} bounces at N={N_MAIN}: ok ({time.time() - t0:.1f} s)")

    t0 = time.time()
    tm = times(nb, device, name)
    log(f"[6] times: ({time.time() - t0:.1f} s)")

    # max_abs_err: x and x0 against the plain version; max_rel_err: the pdf.
    # Both are the larger of the checks at n and n_ragged rows.
    rows = []
    for k, (label, replaces) in KERNELS.items():
        r = tm[k]
        rows.append({"name": k, "label": label, "route": "cuda",
                     "source": "bsdf_diffusion_sampling_tpu_torch/csrc/fused_ode.cu", "replaces": replaces,
                     "launches": counts[k], "max_abs_err": errs[k]["max_abs_err"],
                     "max_rel_err": errs[k]["max_rel_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                     "meval_per_s": r["meval_per_s"], "n": N_MAIN, "n_ragged": N_RAGGED, "T": nb.T})
    require(all(r["launches"] > 0 for r in rows), "a kernel of the main path was never launched")
    log(f"[7] total {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
