#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit (`nvcc`):

    python3 chip_smoke.py               # every phase; last line {"ok": true, ...}
    python3 chip_smoke.py --check-only  # build and kernel-vs-plain checks only

Phases, each of which raises on failure:
  1. build the CUDA kernels from `bsdf_diffusion_sampling_tpu_torch/csrc/`,
     one nvcc per source, all started together; print each kernel's ptxas
     lines and its tensor-core instructions (HMMA, HGMMA) counted in the
     library's SASS by `cuobjdump`; every K1, K2, K4 and K3 instantiation
     must have the three passes of 3xTF32 (a whole number of hidden layers
     of them: 144, 48 or 192 HMMA) and spill nothing;
  2. print the card's name and power limit, and the registers, local bytes
     and blocks an SM of each K1, K2, K4, K3 and K5 instantiation; turn
     TF32 off (the plain versions run in full fp32);
  3. make full-width weights from a numpy seed (disk 3 x 32; spherical
     4 x 32 and its 6 x 64 teacher), write them with the port's `.npz`
     writer, read them back, and build the neural BSDFs;
  4. hold K1, K2 and K4 against their plain PyTorch versions on the card, at
     2^20 rows and at 2^20 - 37 (a partly masked block), K2 exact at 0, 1
     and 2 Newton iterations and reverse, K4 from explicit eps and from its
     in-kernel draw; hold K3 against its plain version
     in every instantiation: disk 3 x 32 and spherical 4 x 32, forward and
     reverse, with and without the det, at 2^20 and 2^20 - 37; spherical
     6 x 64 primal at T = 128 and 256 and disk primal at T = 256, at 2^16
     and 2^16 - 37; K1, K2 (exact and reverse, at K1's end points), K4 and
     K3 (the render's spherical 4 x 32 reverse with the det, and the 6 x 64
     teacher at T = 128 and 256) again, to the same tolerances, on weights
     that move x by O(1), where single-pass TF32 products would show; K1
     and K4 by seed launched on the rows past row0 = 2^19 and 2^19 - 37
     at that row0 (a shard of the wavefront) equal to the bit the whole
     launch's rows;
  5. write the procedural matpreview-size scene (61,648 triangles,
     `.serialized` meshes, XML, EXR envmap, `.bsdf` measured BRDF), and its
     table-material twin (scene_bsdf-style hook, idx 20, albedo (0.4, 0.8,
     0.4)), and load them;
  6. hold K5 against its plain walker on primary, secondary and shadow
     rays (closest and any hit) at 2^20 and 2^20 - 37 rays; print its
     packed layout's bytes;
  7. the sampler paths: bounces of neural_sample -> neural_pdf at 2^20
     queries, disk and spherical (exact pdf, then K3's reverse-Euler pdf),
     with the kernels' launch counts read around each;
  8. the render paths through `cli/render.py` at 512 x 512, depth 12 (after
     a short warm-up render in each): gt, neural-disk and neural-spherical on
     the measured scene at 64 spp; gt and neural-sphere on the table scene
     at 16 spp; then one neural-sphere render with the reverse-Euler pdf
     (K3) through `render()`; the launch counts read around each render,
     and checks of the images;
  9. time each kernel (K2 exact and reverse), its plain version and its
     bound; the plain exact
     spherical pdf; one bounce's stages,
     neural-disk, neural-sphere, and neural-sphere with K3's reverse-Euler
     pdf;
  10. the training path: the MCMC ensemble against a GGX pdf grid (KL <
     0.05) and its ms a sweep with the CUDA graph and eager; `cli/train.py`
     on the phase-5 measured BRDF (disk) at the CLI's widths and batches
     (MCMC 10 bands x 50 walkers x 2,500 sweeps; pretrain 9.8M rows,
     diffusion 4.9M, rectify 2^22 pairs at T = 256; 30 / 30 / 3
     iterations), with the dataset, the losses, K3's launches (one a
     rectify iteration) and its first pairs against the plain transport
     checked; a second call that resumes every stage and takes one rectify
     step; full-sphere training on table material 20 (the 6 x 64 teacher);
     K3 timed at rectify's 2^22 rows; the trained disk checkpoint rendered
     through `cli/render.py` (neural-disk, 16 spp);
  11. gradients through K3 (`fused_transport_diff`) at 2^20 rows, disk
     3 x 32 at T = 4 and spherical 4 x 32 at T = 8 forward and reverse,
     against plain autograd through `transport_with_det` (rtol 2e-3, atol
     1e-6), K3 once a forward and never in the backward; the pixel loss of
     tests/test_diff.py at 512 x 512 x 4 draws against central differences
     along 3 random directions; reference `.pth` state dicts written at the
     reference's widths and rendered through `cli/render.py --weights
     reference` (neural-disk, neural-spherical, neural-sphere; 512 x 512,
     16 spp, depth 4), the neural-sphere with K3's pdf through render(),
     `cli/import_reference.py` on each directory and the neural-disk image
     again from its `final.npz`; `--allow-substitute` at 64 x 64; the zoo's
     U-Net step and mixture bases on the card;
  12. multi-device on the one card: (a) a one-rank NCCL group in this
     process, whose neural-disk render (512 x 512, 16 spp, depth 12) with
     the mesh is bit-equal to the one without, the film's all_reduce once
     a pass; (b) two ranks over gloo (NCCL refuses two ranks on one device)
     started by torch.multiprocessing: gt, neural-disk and
     neural-spherical on the measured scene at 16 spp and neural-sphere
     with K3's pdf on the table scene at 4 spp against the one-process
     renders of the same seed (every pixel within rtol 1e-4 / atol 1e-5,
     sample counts equal, both ranks' images equal, one all_reduce a pass),
     and `cli/train.py` data-parallel from phase 10's datasets, disk 5 / 5 /
     2 and sphere_full 3 / 3 / 1 iterations (the ranks' trees bit-equal,
     losses finite, one all_reduce a step, K3 once a rectify iteration on
     each rank), whose stage files one process then resumes; each rank's
     launches and rows a launch, the collectives, and the ms a pass and an
     iteration of two ranks against one process (two processes that share
     one card: not a scaling figure);
  13. the rest: (a) the anisotropic vndf and luminance warps (4 phi_i x 8
     theta_i slices) at 2^20 queries, invert(sample(u)) == u to 2e-5 and
     eval == the sample's pdf to 2e-4 on >= 99.5% of rows, timed beside the
     isotropic warps; (b) the anisotropic BRDF at 2^20 directions: pdf_brdf
     at its samples (median relative gap < 1e-3), identical phi slices
     equal to the isotropic BRDF, eval responding to phi_i; (c) the
     `synthetic_aniso_rgb` matball through `cli/render.py` at 512 x 512,
     depth 12, 16 spp in gt, neural-disk and neural-spherical (K1, K4 and
     K5 launched as in phase 8), the isotropic material at 16 spp beside
     it, a depth-1 bounce breakdown of neural-disk, aniso and iso; (d) the
     MCMC ensemble on its disk target from `cli/train.py` against the
     pdf grid (KL < 0.05); (e) `online_sampling` of that target (1,024
     omega_i x 129^2 vertices, 1,024 draws each; ms and peak memory), 8 of
     its rows at 2^18 draws against their pmf (KL < 0.01) and 64 rows
     through `samplewi_native` (KL < 0.02); (f) the binary BVH's walk
     against K5 on phase 6's four ray sets at 2^20 rays (flags equal, t
     within 1e-5, shared-edge ties counted), timed beside K5; (g) 2^20
     draws of each `distributions1d` family on the card (KS < 5e-3);
  14. (a) trained quality: `cli/train.py` on the phase-5 measured BRDF
     (disk) at the CLI's widths and batches, MCMC 10 bands x 50 walkers
     x 20,000 sweeps, 2,000 / 5,000 / 500 iterations; at omega_i radii
     0.1, 0.4, 0.7 and 0.9, 2^20 draws through K1 against the oracle (the MCMC's target) and
     against the learned pdf grid from K2 (48 x 48 cells over [-1, 1]^2,
     each the mean of 4 x 4 points): mean KL against the oracle < 0.5 and
     at most half the base density's, the consistency KL < 0.05 at every
     radius; the same KLs for the base density and phase 10's checkpoint;
     both checkpoints rendered through `cli/render.py` (neural-disk, 64
     spp, depth 12) against phase 8's gt and a gt of another seed: the
     trained relMSE below phase 10's, its mean radiance within 10% of gt;
     (b) the 12-ball array scenes (`write_array_scene`, the version-0.5.0
     dialect) at 512 x 512, 16 spp, depth 12: the measured array under the
     envmap in gt and neural-disk with reference-layout weights (K1 12
     times a bounce, K5 twice), the table array under a point light in gt
     and neural-sphere with K3's pdf (K4 12 and K3 24 times a bounce, K5
     three times); every ball seen and not black; each ball's share of
     the wavefront's rays at depths 0 and 1;
  15. print the `training` line, the `differentiable` line, the
     `multidevice` line, the `rest` line, the `quality` line, the `arrays`
     line, the card's line, the `kernels` line (each kernel's row-offset
     status and its launches in the anisotropic, trained-quality and array
     runs beside its numbers) and the `ok` line.

Imports nothing of JAX: the port stands alone on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, SamplerConfig
from bsdf_diffusion_sampling_tpu_torch.core.prng import root_generator
from bsdf_diffusion_sampling_tpu_torch.bsdf.analytic import ggx_shading_disk
from bsdf_diffusion_sampling_tpu_torch.bsdf.marginal2d import warp_eval, warp_invert, warp_sample
from bsdf_diffusion_sampling_tpu_torch.bsdf.materials import BSDF_MATERIALS
from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import (
    eval_brdf,
    load_measured,
    measured_from_tensors,
    pdf_brdf,
    sample_brdf,
)
from bsdf_diffusion_sampling_tpu_torch.data.datasets import generate_brdf_dataset
from bsdf_diffusion_sampling_tpu_torch.data.mcmc import ensemble_mcmc, make_domain_log_prob
from bsdf_diffusion_sampling_tpu_torch.data.tabulated import build_tabulated, domain_grid, online_sampling, sample_tabulated
from bsdf_diffusion_sampling_tpu_torch.geometry.coords import cart_to_spher
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.models.base_density import disk_heads_from_enc, get_base
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition
from bsdf_diffusion_sampling_tpu_torch.models.zoo import gmm_disk_base, mixture_spherical_base, unet_apply, unet_init
from bsdf_diffusion_sampling_tpu_torch.native.samplewilib import samplewi_native
from bsdf_diffusion_sampling_tpu_torch.ode.flow import ode_pdf_exact, transport, transport_with_det
from bsdf_diffusion_sampling_tpu_torch.ops import cuda_build
from bsdf_diffusion_sampling_tpu_torch.ops import fused_ode as fo
from bsdf_diffusion_sampling_tpu_torch.parallel import init_distributed, make_mesh
from bsdf_diffusion_sampling_tpu_torch.cli import import_reference as import_cli
from bsdf_diffusion_sampling_tpu_torch.cli import render as render_cli
from bsdf_diffusion_sampling_tpu_torch.cli import train as train_cli
from bsdf_diffusion_sampling_tpu_torch.render import traverse8 as t8
from bsdf_diffusion_sampling_tpu_torch.render.bvh import intersect as binary_intersect
from bsdf_diffusion_sampling_tpu_torch.render.camera import generate_rays
from bsdf_diffusion_sampling_tpu_torch.render.integrator import (
    _bounce_body,
    _init_wavefront,
    _isect,
    _ray_sort_key,
    _sort_perm,
    draw_bounce,
    neural_matball_sphere,
    render,
    render_pass,
)
from bsdf_diffusion_sampling_tpu_torch.render.lambert import cosine_sample, make_frame, to_world
from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf, neural_pdf, neural_sample
from bsdf_diffusion_sampling_tpu_torch.render.procedural import (
    ANISO_MATERIAL,
    ANISO_PHI,
    ARRAY_LIGHT,
    ARRAY_MATERIALS,
    ARRAY_TABLE,
    TABLE,
    synthetic_measured_tensors,
    write_array_scene,
    write_scene,
)
from bsdf_diffusion_sampling_tpu_torch.render.scene import MAT_BALL, MAT_PLANE, load_scene
from bsdf_diffusion_sampling_tpu_torch.train import stages
from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import load_pytree, save_pytree
from bsdf_diffusion_sampling_tpu_torch.utils import distributions1d as dists
from bsdf_diffusion_sampling_tpu_torch.utils.validation import (
    histogram_grid_2d,
    image_mse,
    kl_divergence_grid,
    pdf_grid_2d,
    relative_mse,
    sampler_vs_pdf_kl,
)

N_MAIN = 1 << 20  # the wavefront of the main path, the checks and the timings
N_RAGGED = N_MAIN - 37  # a size whose last block of 128 threads is partly masked
BOUNCES = 4
RUNS = 7  # timed runs; the median is kept
SEED = 0
# The render: the procedural matpreview-size scene at the CLI's default film,
# one 2^20-ray wavefront a pass (512 x 512 x 4), 16 passes of 12 bounces.
RENDER_RES = 512
RENDER_CHUNK = 4
RENDER_SPP = 64
RENDER_DEPTH = 12
# The table scene's renders (gt, neural-sphere) at fewer spp: each
# neural-sphere bounce runs the plain exact spherical pdf twice on the
# whole wavefront, which keeps the whole run inside a few minutes.
TABLE_SPP = 16
# The row offsets at which K1 and K4 by seed are launched on the tail of a
# wavefront and held to the whole launch's rows (phase 4): the first row
# of the second of two shards of 2^20, and one that is not a multiple of a
# warp or a tile.
ROW0S = (1 << 19, (1 << 19) - 37)
N_LONG = 1 << 16  # rectify's long transports (T = 128, 256) are checked and timed at 2^16 rows

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
# K4 and K3 against their plain versions, given the same x0: the spherical
# net is deeper and T = 8, so the tolerances are 2x the disk ones (the JAX
# package's own kernel-vs-XLA test holds x to 2e-5 and pdfs to 5e-4). K4's
# in-kernel draw against its numpy/PyTorch reproduction: the two take the
# base heads in other orders (FMA chains against a matmul), and Best-Fisher
# amplifies an ulp of the heads: acos(f) near f = -1 (u0 near 1) by
# 1/sqrt(1 - f^2), and a flipped accept changes phi0 by a lot. So theta0
# is held to 2e-5 and phi0 to 1e-3 rad on the circle, on at least 99.99% of
# rows; the share within 2e-5 and the largest phi0 difference are printed.
TOL_SPH_X_ABS = 2e-5
TOL_SPH_PDF_REL = 2e-4
TOL_DRAW_PHI = 1e-3
MIN_DRAW_MATCH = 0.9999

# Published dense rates by card: fp32 on the CUDA cores, memory, and TF32
# on the tensor cores (`bound_tf32_ms`).
PEAKS = {  # name fragment: (fp32 FLOP/s, bytes/s)
    "PCIe": (51.2e12, 2.0e12),
    "NVL": (60e12, 3.9e12),
    "H100": (67e12, 3.35e12),  # SXM
}
TF32_PEAKS = {"PCIe": 378e12, "NVL": 417.5e12, "H100": 495e12}
# The kernels whose MLP runs on the tensor cores (K1, K2, K4, K3), by
# library: the marker of their kernels' names and how many instantiations
# each library has; and the precision of their products. fused_ode.cu's
# marker is in K1's `sample_pdf_disk_kernel` and K2's `pdf_disk_kernel`
# alike: two instantiations of each, each function counted once.
TC_KERNELS = {"fused_ode.cu": ("pdf_disk_kernel", 4), "fused_sph.cu": ("sample_pdf_sph_kernel", 2),
              "fused_transport.cu": ("transport_kernel", 5)}
PRECISION = {"fused_sample_pdf_disk": "3xtf32", "fused_pdf_disk": "3xtf32", "fused_sample_pdf_spherical": "3xtf32",
             "fused_transport": "3xtf32"}
# The mma.sync of one hidden 32 x 32 layer of K1, K4 and the reverse K2: 3
# passes (lo*hi, hi*lo, hi*hi) x 3 streams (primal, two tangents) x 4 n8
# tiles x 4 k8 chunks. The layer loop is not unrolled, so each kernel's SASS
# holds a whole multiple of it; a dropped pass leaves 96 or 48. The exact
# K2 holds one primal evaluation (1 stream) and one with the tangents: 48 +
# 144 = 192, of which a dropped pass leaves 128, 144 or 176. K3's
# (`hmma_a_layer`): 3 passes x S streams (3 with the det, 1 without) x
# (H / 8)^2 tiles: 144, 48, and 192 for its 64-wide primal net.
HMMA_A_LAYER = 3 * 3 * (32 // 8) ** 2
# Velocity weights that move x by O(1) (uniform, variance 1.5^2 / fan-in;
# tests/test_torch_tc_precision.py). The chip's other weights move x by
# ~1e-3 only, where even single-pass TF32 products hold the gates; on these
# they would miss them by ~100x (the CPU emulation), so K1 and K4 are held
# to their gates on these too.
STRONG_SCALE = 1.5 * math.sqrt(3.0)
K3_MAIN = "spherical 4x32 reverse det T=8"  # K3's instantiation on the render path
K3_TEACHER = "spherical 6x64 forward primal T=128"  # rectify's teacher pairs
K3_TEACHER_256 = "spherical 6x64 forward primal T=256"  # the training CLI's T (`cli/train.py`)


def tf32_peak(name: str) -> float:
    return next(v for k, v in TF32_PEAKS.items() if k in name)


def log(msg: str) -> None:
    print(msg, flush=True)


SPH_CFG = render_cli.model_cfg("spherical")  # 4 x 32
TEACHER_CFG = ModelConfig(domain="spherical", velocity_hidden=64, velocity_layers=6)


def init_weights(seed: int, cfg: ModelConfig, teacher: ModelConfig | None = None, v_scale: float = 0.5) -> dict:
    """Full-width weights for `cfg`, Kaiming-uniform as the JAX package's
    `models/mlp.py:21-38` draws them; velocity weights scaled by `v_scale`,
    0.5 so the Euler map stays invertible, as the JAX tests do."""
    rng = np.random.default_rng(seed)

    def layers(dims, bias, scale=1.0):
        out = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            bound = 1.0 / math.sqrt(d_in)
            layer = {"w": (scale * rng.uniform(-bound, bound, (d_in, d_out))).astype(np.float32)}
            if bias:
                layer["b"] = rng.uniform(-bound, bound, (d_out,)).astype(np.float32)
            out.append(layer)
        return out

    def v_dims(c):
        return [c.velocity_in_dim] + [c.velocity_hidden] * c.velocity_layers + [2]

    b_dims = [2 * (2 * cfg.base_pe_bands + 1), cfg.base_hidden, 4]
    tree = {"base": {"net": layers(b_dims, True)}, "rectified": layers(v_dims(cfg), False, v_scale)}
    if teacher is not None:
        tree["teacher"] = layers(v_dims(teacher), False, v_scale)
    return tree


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
    k1o = row_offset_check("K1", lambda c, **kw: fo.fused_sample_pdf_disk(w, c, T, seed=seed, **kw), cond,
                           (xs, pdfs, x0s))

    k2 = {"x0_abs": 0.0, "pdf_rel": 0.0}
    for it in sorted({0, 1, nb.pdf_newton_iters}):  # the sampler's newton_iters is the last
        pe, x0e = fo.fused_pdf_disk(w, x, cond, T, exact=True, newton_iters=it)
        pep, x0ep = fo.pdf_disk_plain(w, x, cond, T, exact=True, newton_iters=it)
        r = {"x0_abs": max_abs(x0e, x0ep), "pdf_rel": max_rel(pe, pep)}
        log(f"  K2 exact, newton_iters {it}, vs plain: {r}")
        require(bool(torch.isfinite(pe).all() and torch.isfinite(x0e).all()),
                f"non-finite K2 exact output at newton_iters {it}")
        k2 = {m: max(v, r[m]) for m, v in k2.items()}
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
        "row_offset_max_abs": k1o,
    }
    out["fused_pdf_disk"] = {
        "max_abs_err": max(k2["x0_abs"], k2r["x0_abs"]),
        "max_rel_err": max(k2["pdf_rel"], k2r["pdf_rel"]),
    }
    return out


def row_offset_check(label: str, kernel, cond: torch.Tensor, whole: tuple) -> float:
    """A seeded kernel launched on rows [row0, n) at `row0` (the launch of
    a shard of the wavefront) must give what the one launch over all n rows
    gave for them, to the bit: each row's draw, transport and pdf depend on
    its global row alone."""
    worst = 0.0
    for row0 in ROW0S:
        part = kernel(cond[row0:], row0=row0)
        diff = max(max_abs(a, b[row0:]) for a, b in zip(part, whole))
        equal = all(torch.equal(a, b[row0:]) for a, b in zip(part, whole))
        log(f"  {label} seeded at row0 = {row0} vs the whole launch's rows: equal {equal}, max abs {diff}")
        require(equal, f"{label} at row0 = {row0} differs from the whole launch's rows by {diff}")
        worst = max(worst, diff)
    return worst


def wrap_abs(d: torch.Tensor) -> torch.Tensor:
    """|d| taken on the circle."""
    return torch.remainder(d + math.pi, 2.0 * math.pi).sub(math.pi).abs()


def sph_inputs(nb, device, n: int, seed: int):
    """cond_enc of upper-hemisphere wi in spherical coordinates, and eps =
    (standard normal, phi uniform on the circle), a prefix of N_MAIN rows."""
    rng = np.random.default_rng(seed)
    wi = hemisphere(torch.from_numpy(rng.random((N_MAIN, 2), dtype=np.float32)).to(device))[:n]
    cond = encode_condition(cart_to_spher(wi), nb.cfg)
    eps = torch.from_numpy(np.stack([rng.standard_normal(N_MAIN), rng.uniform(-math.pi, math.pi, N_MAIN)], -1)
                           .astype(np.float32)).to(device)[:n].contiguous()
    return wi, cond, eps


def check_spherical(nb, device, n: int) -> dict:
    """Phase 4, K4: from explicit eps, against the plain version; from the
    in-kernel draw, the transport and pdf against the plain version at the
    kernel's own x0, and the draw against its reproduction."""
    _, cond, eps = sph_inputs(nb, device, n, SEED + 11)
    w, T = nb.packed, nb.T
    log(f"  n = {n}")
    x, pdf, x0 = fo.fused_sample_pdf_spherical(w, cond, T, eps=eps)
    xp, pdfp, x0p = fo.sample_pdf_spherical_plain(w, cond, T, eps=eps)
    k4 = {"x_abs": max_abs(x, xp), "x0_abs": max_abs(x0, x0p), "pdf_rel": max_rel(pdf, pdfp)}
    log(f"  K4 eps    vs plain: {k4}")

    seed = 20240611
    xs, pdfs, x0s = fo.fused_sample_pdf_spherical(w, cond, T, seed=seed)
    xa, pdfa, _ = fo.sample_pdf_spherical_plain(w, cond, T, x0=x0s)
    x0r = fo.spherical_x0_from_seed(w, cond, seed)
    d_phi = wrap_abs(x0s[:, 1] - x0r[:, 1])
    same = ((x0s[:, 0] - x0r[:, 0]).abs() <= TOL_SPH_X_ABS) & (d_phi <= TOL_DRAW_PHI)
    k4p = {"x_abs_at_own_x0": max_abs(xs, xa), "pdf_rel_at_own_x0": max_rel(pdfs, pdfa),
           "draw_match": float(same.float().mean()), "draw_differ_rows": int((~same).sum()),
           "phi0_within_2e-5": float((d_phi <= TOL_SPH_X_ABS).float().mean()), "phi0_max_diff": float(d_phi.max()),
           "theta0_abs": max_abs(x0s[:, 0], x0r[:, 0]),
           "phi0_in_range": bool(((x0s[:, 1] >= -math.pi) & (x0s[:, 1] < math.pi)).all())}
    log(f"  K4 philox vs plain: {k4p}")
    k4o = row_offset_check("K4", lambda c, **kw: fo.fused_sample_pdf_spherical(w, c, T, seed=seed, **kw), cond,
                           (xs, pdfs, x0s))
    for name, t in (("x", x), ("pdf", pdf), ("x_seed", xs), ("pdf_seed", pdfs)):
        require(bool(torch.isfinite(t).all()), f"non-finite K4 output {name}")
    require(max(k4["x_abs"], k4["x0_abs"], k4p["x_abs_at_own_x0"]) <= TOL_SPH_X_ABS, "K4 x/x0 differs from plain")
    require(max(k4["pdf_rel"], k4p["pdf_rel_at_own_x0"]) <= TOL_SPH_PDF_REL, "K4 pdf differs from plain")
    require(k4p["draw_match"] >= MIN_DRAW_MATCH, "K4's in-kernel draw differs from its reproduction")
    require(k4p["phi0_in_range"], "K4 phi0 outside [-pi, pi)")
    return {"max_abs_err": max(k4["x_abs"], k4["x0_abs"], k4p["x_abs_at_own_x0"]),
            "max_rel_err": max(k4["pdf_rel"], k4p["pdf_rel_at_own_x0"]), "row_offset_max_abs": k4o}


def transport_fp64(domain: str, w, x: torch.Tensor, cond: torch.Tensor, T: int) -> torch.Tensor:
    """The plain primal transport in float64: the yardstick for how far each
    float32 transport (the kernel's, the plain one's) is from the map."""
    with torch.no_grad():
        v64 = [{k: t.double() for k, t in layer.items()} for layer in w.v_params]
        return transport(domain, v64, x.double(), cond.double(), T)


def check_strong(device) -> dict:
    """Phase 4: K1 and K4 against their plain versions from eps at N_MAIN,
    K2 (exact at the sampler's newton_iters, and reverse) queried at the
    plain K1's end points from K1's weights, so that the inverse undoes a
    map that moves x by O(1), and K3 in the render's instantiation and as
    the 6 x 64 teacher (at T = 128 and at the training CLI's T = 256), on
    velocity weights that move x by O(1), to the gates of check_kernels,
    check_spherical and check_transport. Products rounded to single-pass
    TF32 would miss them (~1e-3 in x on the CPU emulation). The teacher
    takes 16x (32x) the render's steps and keeps the spherical gate:
    tests/test_torch_tc_precision.py's emulation of its 3xTF32 products
    lands 1.4e-6 from fp32 at T = 128 (two fp32 orders differ by 1.1e-6)."""
    sc = SamplerConfig()
    rng = np.random.default_rng(SEED + 16)
    wi = hemisphere(torch.from_numpy(rng.random((N_MAIN, 2), dtype=np.float32)).to(device))
    gauss = rng.standard_normal((N_MAIN, 2)).astype(np.float32)
    phi = rng.uniform(-math.pi, math.pi, N_MAIN).astype(np.float32)
    out = {}
    for k, label, cfg, prepack, T, fused, plain, tol_x, tol_pdf in (
            ("fused_sample_pdf_disk", "K1", ModelConfig(), fo.prepack_disk, sc.T_disk, fo.fused_sample_pdf_disk,
             fo.sample_pdf_disk_plain, TOL_X_ABS, TOL_PDF_REL),
            ("fused_sample_pdf_spherical", "K4", SPH_CFG, fo.prepack_spherical, sc.T_spherical,
             fo.fused_sample_pdf_spherical, fo.sample_pdf_spherical_plain, TOL_SPH_X_ABS, TOL_SPH_PDF_REL)):
        tree = init_weights(SEED + 200, cfg, v_scale=STRONG_SCALE)
        w = prepack(params_from_jax(tree["rectified"], device), params_from_jax(tree["base"], device))
        cond = encode_condition(wi[:, :2] if cfg.domain == "disk" else cart_to_spher(wi), cfg)
        eps = torch.from_numpy(gauss if cfg.domain == "disk" else np.stack([gauss[:, 0], phi], -1)).to(device)
        x, pdf, x0 = fused(w, cond, T, eps=eps)
        xp, pdfp, x0p = plain(w, cond, T, eps=eps)
        r = {"x_moved_max": max_abs(xp, x0p), "x_abs": max_abs(x, xp), "x0_abs": max_abs(x0, x0p),
             "pdf_rel": max_rel(pdf, pdfp), "det_sign_flips": int((pdfp <= 0).sum())}
        log(f"  {label} on O(1)-moving weights vs plain: {r}")
        for name, t in (("x", x), ("pdf", pdf), ("x0", x0)):
            require(bool(torch.isfinite(t).all()), f"non-finite {label} output {name} on O(1)-moving weights")
        require(r["x_moved_max"] >= 1.0, f"{label}: the O(1)-moving weights moved x by {r['x_moved_max']} only")
        require(max(r["x_abs"], r["x0_abs"]) <= tol_x, f"{label} x/x0 differs from plain on O(1)-moving weights")
        require(r["pdf_rel"] <= tol_pdf, f"{label} pdf differs from plain on O(1)-moving weights")
        out[k] = {"max_abs_err": max(r["x_abs"], r["x0_abs"]), "max_rel_err": r["pdf_rel"]}
        if label == "K1":
            k2_at = (w, cond, T, xp.contiguous())

    w, cond, T, x_end = k2_at
    out["fused_pdf_disk"] = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for label, exact in (("K2 exact", True), ("K2 reverse", False)):
        pdf, x0 = fo.fused_pdf_disk(w, x_end, cond, T, exact=exact, newton_iters=sc.pdf_newton_iters)
        pdfp, x0p = fo.pdf_disk_plain(w, x_end, cond, T, exact=exact, newton_iters=sc.pdf_newton_iters)
        r = {"x_moved_max": max_abs(x0p, x_end), "x0_abs": max_abs(x0, x0p), "pdf_rel": max_rel(pdf, pdfp),
             "det_sign_flips": int((pdfp <= 0).sum())}
        log(f"  {label} at K1's end points on O(1)-moving weights vs plain: {r}")
        require(bool(torch.isfinite(pdf).all() and torch.isfinite(x0).all()),
                f"non-finite {label} output on O(1)-moving weights")
        require(r["x_moved_max"] >= 1.0, f"{label}: the O(1)-moving weights moved x by {r['x_moved_max']} only")
        require(r["x0_abs"] <= TOL_X_ABS, f"{label} x0 differs from plain on O(1)-moving weights")
        require(r["pdf_rel"] <= TOL_PDF_REL, f"{label} pdf differs from plain on O(1)-moving weights")
        e = out["fused_pdf_disk"]
        e["max_abs_err"], e["max_rel_err"] = max(e["max_abs_err"], r["x0_abs"]), max(e["max_rel_err"], r["pdf_rel"])

    # K3: the render's reverse-Euler pdf transport from the forward end
    # points, and the teacher forward from base-like points
    tree = init_weights(SEED + 201, SPH_CFG, TEACHER_CFG, v_scale=STRONG_SCALE)
    net, teacher = (fo.prepack_velocity(params_from_jax(tree[k], device)) for k in ("rectified", "teacher"))
    cond = encode_condition(cart_to_spher(wi), SPH_CFG)
    x0 = torch.from_numpy(np.stack([rng.uniform(0.1, 1.5, N_MAIN), phi], -1).astype(np.float32)).to(device)
    x_end = fo.transport_plain("spherical", net, x0, cond, sc.T_spherical, with_jac=False)[0].contiguous()
    out["fused_transport"] = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for label, w, x, c, T, reverse, jac in ((K3_MAIN, net, x_end, cond, sc.T_spherical, True, True),
                                            (K3_TEACHER, teacher, x0[:N_LONG], cond[:N_LONG], 128, False, False),
                                            (K3_TEACHER_256, teacher, x0[:N_LONG], cond[:N_LONG], 256, False,
                                             False)):
        xk, dk = fo.fused_transport_packed(w, "spherical", x, c, T, reverse=reverse, with_jac=jac)
        xp, dp = fo.transport_plain("spherical", w, x, c, T, reverse=reverse, with_jac=jac)
        r = {"n": x.shape[0], "x_moved_max": max_abs(xp, x), "x_abs": max_abs(xk, xp),
             "det_rel": max_rel(dk, dp) if jac else 0.0, "det_sign_flips": int((dp <= 0).sum()) if jac else None}
        if not jac:  # the teacher: both fp32 results against an fp64 transport (printed, not gated)
            x64 = transport_fp64("spherical", w, x, c, T)
            r["x_abs_vs_fp64"], r["plain_vs_fp64"] = max_abs(xk.double(), x64), max_abs(xp.double(), x64)
        log(f"  K3 {label} on O(1)-moving weights vs plain: {r}")
        require(bool(torch.isfinite(xk).all() and torch.isfinite(dk).all()),
                f"K3 {label}: non-finite output on O(1)-moving weights")
        require(r["x_moved_max"] >= 1.0, f"K3 {label}: the O(1)-moving weights moved x by {r['x_moved_max']} only")
        require(r["x_abs"] <= TOL_SPH_X_ABS, f"K3 {label}: x differs from plain on O(1)-moving weights")
        require(r["det_rel"] <= TOL_SPH_PDF_REL, f"K3 {label}: det differs from plain on O(1)-moving weights")
        e = out["fused_transport"]
        e["max_abs_err"], e["max_rel_err"] = max(e["max_abs_err"], r["x_abs"]), max(e["max_rel_err"], r["det_rel"])
    return out


def k3_cases(nb_disk, nb_sph, teacher, device) -> list:
    """Every instantiation of K3 on the inputs its callers give it: forward
    from base draws, reverse from the draws' end points. (label, packed
    weights, domain, x, cond, T, reverse, with_jac)."""
    cases = []
    _, cond_s, eps_s = sph_inputs(nb_sph, device, N_MAIN, SEED + 12)
    xs, _, x0s = fo.sample_pdf_spherical_plain(nb_sph.packed, cond_s, nb_sph.T, eps=eps_s)
    rng = np.random.default_rng(SEED + 13)
    wi = hemisphere(torch.from_numpy(rng.random((N_MAIN, 2), dtype=np.float32)).to(device))
    cond_d = encode_condition(wi[:, :2], nb_disk.cfg)
    eps_d = torch.from_numpy(rng.standard_normal((N_MAIN, 2), dtype=np.float32)).to(device)
    xd, _, x0d = fo.sample_pdf_disk_plain(nb_disk.packed, cond_d, nb_disk.T, eps=eps_d)
    for dom, nb, x0, x, cond in (("disk", nb_disk, x0d, xd, cond_d), ("spherical", nb_sph, x0s, xs, cond_s)):
        for reverse in (False, True):
            for jac in (True, False):
                label = f"{dom} {nb.packed.layers}x{nb.packed.hidden} {'reverse' if reverse else 'forward'} " \
                        f"{'det' if jac else 'primal'} T={nb.T}"
                cases.append((label, nb.packed, dom, (x if reverse else x0).contiguous(), cond, nb.T, reverse, jac))
    for label, T in ((K3_TEACHER, 128), (K3_TEACHER_256, 256)):
        cases.append((label, teacher, "spherical", x0s[:N_LONG].contiguous(), cond_s[:N_LONG], T, False, False))
    cases.append(("disk 3x32 forward primal T=256", nb_disk.packed, "disk", x0d[:N_LONG].contiguous(),
                  cond_d[:N_LONG], 256, False, False))
    return cases


def check_transport(cases) -> dict:
    """Phase 4, K3 against its plain version in every instantiation, on all
    of each case's rows and on all but the last 37 (a partly masked warp)."""
    out = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for label, w, dom, x, cond, T, reverse, jac in cases:
        for n in (x.shape[0], x.shape[0] - 37):
            xk, dk = fo.fused_transport_packed(w, dom, x[:n], cond[:n], T, reverse=reverse, with_jac=jac)
            xp, dp = fo.transport_plain(dom, w, x[:n], cond[:n], T, reverse=reverse, with_jac=jac)
            r = {"n": n, "x_abs": max_abs(xk, xp), "det_rel": max_rel(dk, dp) if jac else 0.0,
                 "det_zero": bool((dk == 0).all()) if not jac else None}
            log(f"  K3 {label:38s} vs plain: {r}")
            require(bool(torch.isfinite(xk).all() and torch.isfinite(dk).all()), f"K3 {label}: non-finite output")
            require(r["x_abs"] <= TOL_SPH_X_ABS, f"K3 {label}: x differs from plain")
            require(r["det_rel"] <= TOL_SPH_PDF_REL, f"K3 {label}: det differs from plain")
            require(jac or r["det_zero"], f"K3 {label}: det not 0 without the det")
            out["max_abs_err"] = max(out["max_abs_err"], r["x_abs"])
            out["max_rel_err"] = max(out["max_rel_err"], r["det_rel"])
    return out


def k5_ray_sets(accel, cam, device, n: int, seed: int) -> dict:
    """The four kinds of rays the render traces, n of each (a prefix of one
    2^20 wavefront): primary camera rays at 512 x 512 x 4; secondary rays from
    the primary hits, cosine-distributed about the shading normal; and
    shadow rays from the hits, any hit, to the envmap (t_max 1e6) and to a
    point light (finite t_max), each under a partial `active` mask."""
    gen = root_generator(seed, device)
    u = torch.rand((N_MAIN, 2), generator=gen, device=device) * (1.0 - 1e-7) + 1e-7
    ro, rd, _ = generate_rays(cam.vectors.to(device), RENDER_RES, RENDER_RES, u, N_MAIN // RENDER_RES ** 2)
    ro, rd = ro[:n].contiguous(), rd[:n].contiguous()
    h = t8.intersect8(accel, ro, rd)
    hit = h.t < 1e29
    a = accel.attr_rows[h.prim]
    w0 = (1.0 - h.u - h.v)[:, None]
    nrm = w0 * a[:, 0:3] + h.u[:, None] * a[:, 3:6] + h.v[:, None] * a[:, 6:9]
    nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True).clamp(min=1e-12)
    nrm = torch.where((nrm * rd).sum(-1, keepdim=True) > 0, -nrm, nrm)
    p = ro + rd * torch.where(hit, h.t, 0.0)[:, None] + 1e-3 * nrm
    t, bt = make_frame(nrm)
    d2 = to_world(nrm, t, bt, cosine_sample(torch.rand((n, 2), generator=gen, device=device))[0])
    part = hit & (torch.rand(n, generator=gen, device=device) < 0.8)
    light = torch.tensor([2.0, 4.0, 3.0], device=device)
    dl = light - p
    dist = torch.linalg.vector_norm(dl, dim=-1)
    return {
        "primary": (ro, rd, torch.full((n,), t8.INF, device=device), torch.ones(n, dtype=torch.bool, device=device),
                    False),
        "secondary": (p, d2, torch.full((n,), t8.INF, device=device), hit, False),
        "shadow_env": (p, d2, torch.full((n,), 1e6, device=device), part, True),
        "shadow_point": (p, dl / dist[:, None], dist - 2e-3, part, True),
    }


def check_traverse(accel, cam, device, n: int) -> dict:
    """K5 against its plain walker on each ray set at n rays: t, prim, u, v
    to the bit on >= 99.99% of rays, t within 1e-5 relative wherever both
    hit, hit (or occluded) flags equal on >= 99.99%, no truncation."""
    out = {}
    for name, (ro, rd, t_max, act, any_hit) in k5_ray_sets(accel, cam, device, n, SEED + 5).items():
        rs, ird = t8.safe_dir(rd)
        args = (ro.contiguous(), rs.contiguous(), ird.contiguous(), t_max.contiguous(), act.contiguous(), any_hit)
        tk, pk, uk, vk, nk = t8.traverse8(accel, *args)
        tp, pp, up, vp, npl = t8.traverse8_plain(accel, *args)
        torch.cuda.synchronize()
        same = (tk == tp) & (pk == pp) & (uk == up) & (vk == vp)
        thr = t_max * 0.9999 if any_hit else torch.full_like(t_max, 1e29)
        flag_k, flag_p = act & (tk < thr), act & (tp < thr)
        both = flag_k & flag_p
        t_rel = float(((tk - tp).abs() / tp.abs().clamp(min=1e-30))[both].max()) if bool(both.any()) else 0.0
        t_abs = float((tk - tp).abs()[both].max()) if bool(both.any()) else 0.0
        r = {"rays": n, "active": int(act.sum()), "hits": int(flag_k.sum()), "differ": int((~same).sum()),
             "flag_differ": int((flag_k != flag_p).sum()), "t_rel_max": t_rel, "t_abs_max": t_abs,
             "truncated_kernel": int(nk), "truncated_plain": int(npl)}
        log(f"  K5 {name:12s} vs plain: {r}")
        require(r["differ"] <= 1e-4 * n, f"K5 {name}: t/prim/u/v differ from the plain walker on {r['differ']} rays")
        require(r["flag_differ"] <= 1e-4 * n, f"K5 {name}: hit flags differ on {r['flag_differ']} rays")
        require(t_rel <= 1e-5, f"K5 {name}: t differs by {t_rel:.3g} relative")
        require(r["truncated_kernel"] == 0 and r["truncated_plain"] == 0, f"K5 {name}: truncated")
        out[name] = r
    return out


DISK_SAMPLER = ("fused_sample_pdf_disk", "fused_pdf_disk")


def main_path(nb, device) -> dict:
    """Phase 7: bounces of disk sample -> pdf query at N_MAIN, counts around it."""
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
        require(all(fo.launches[k] > before[k] for k in DISK_SAMPLER), "a kernel was not launched this bounce")
        stats.append(s)
    counts = dict(fo.launches)
    log(f"launches on the disk sampler path: {counts}")
    return counts


def sph_sampler_path(nbs: dict, device) -> dict:
    """Phase 7, spherical: one bounce of neural_sample -> neural_pdf at
    N_MAIN for each pdf route, counts around each: K4 once; K3 once with the
    reverse-Euler pdf, not at all with the exact one (plain PyTorch)."""
    gen = root_generator(SEED + 14, device)
    out = {}
    for route, nb in nbs.items():
        fo.reset_launches()
        wi = hemisphere(torch.rand((N_MAIN, 2), generator=gen, device=device))
        wo, pdf = neural_sample(nb, gen, wi)
        pdf_q = neural_pdf(nb, wi, wo)
        counts = dict(fo.launches)
        ok = pdf > 1e-6
        s = {"domain": nb.domain, "pdf": route, "valid_fraction": float((pdf > 0).float().mean()),
             "gap": gap_stats(pdf_q[ok], pdf[ok]), "launches": counts}
        log(f"spherical sampler path {s}")
        require(bool(torch.isfinite(wo).all() and torch.isfinite(pdf).all() and torch.isfinite(pdf_q).all()),
                "non-finite spherical sampler output")
        require(s["valid_fraction"] >= MIN_VALID_FRACTION, "too few valid spherical draws")
        require(counts["fused_sample_pdf_spherical"] == 1 and counts["fused_sample_pdf_disk"] == 0,
                "K4 not launched once (or K1 launched) for one spherical draw")
        require(counts["fused_transport"] == (1 if route == "reverse" else 0), "K3 launches off for the pdf route")
        if route == "exact":
            require(s["gap"]["median"] < TOL_CONTRACT_MEDIAN, "exact spherical pdf disagrees with the sampler's pdf")
        out[route] = s
    return out


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
        # x and cond_enc in; pdf, x0 out. Exact: a warm start and it + 1
        # evaluations with the tangents a step; reverse: K1's work
        "fused_pdf_disk": (n * (once + t * (primal + (it + 1) * step)), n * (4 * fo.COND_DIM + 8 + 12)),
        "fused_pdf_disk reverse": (n * (once + t * step), n * (4 * fo.COND_DIM + 8 + 12)),
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
        "fused_pdf_disk reverse": (lambda: fo.fused_pdf_disk(w, x, cond, T, exact=False),
                                   lambda: fo.pdf_disk_plain(w, x, cond, T, exact=False)),
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
                  "bound_tf32_ms": 2.0 * macs / tf32_peak(name) * 1e3,
                  "meval_per_s": N_MAIN / ms / 1e3, "flop": 2 * macs, "bytes": nbytes}
        log(f"time {k}: {out[k]}")
    # one whole bounce as the main path runs it: the kernels plus the
    # encoding, lifting and masking around them
    gen = root_generator(SEED + 4, device)
    nb_ms = cuda_ms(lambda: neural_pdf(nb, wi, neural_sample(nb, gen, wi)[0]))
    share = (out["fused_sample_pdf_disk"]["ms"] + out["fused_pdf_disk"]["ms"]) / nb_ms
    log(f"time bounce (neural_sample + neural_pdf, N={N_MAIN}): {nb_ms:.4f} ms, "
        f"kernels {100 * share:.1f}% of it")
    out["fused_pdf_disk"]["reverse"] = out.pop("fused_pdf_disk reverse")  # the kernels line's K2 row
    return out


def net_macs(hidden: int, layers: int, x_enc: int):
    """Multiply-adds of one velocity evaluation once the condition's part of
    layer 0 is taken: (primal, one tangent stream)."""
    deep = (layers - 1) * hidden * hidden + 2 * hidden
    return (x_enc + 1) * hidden + deep, x_enc * hidden + deep


def timed(label: str, kern, plain, macs: int, nbytes: int, n: int, name: str, plain_runs: int = 5) -> dict:
    flops_peak, bytes_peak = next(v for k, v in PEAKS.items() if k in name)
    t_ops, t_bytes = 2.0 * macs / flops_peak * 1e3, nbytes / bytes_peak * 1e3
    ms = cuda_ms(kern)
    with torch.no_grad():
        plain_ms = cuda_ms(plain, runs=plain_runs, warmup=1)
    r = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "bound_tf32_ms": 2.0 * macs / tf32_peak(name) * 1e3, "meval_per_s": n / ms / 1e3,
         "flop": 2 * macs, "bytes": nbytes, "n": n}
    log(f"time {label}: {r}")
    return r



def times_spherical(nb, cases, device, name: str) -> dict:
    """Phase 9: K4 and every K3 instantiation, their plain versions and
    bounds; the plain exact spherical pdf at N_MAIN."""
    wi, cond, eps = sph_inputs(nb, device, N_MAIN, SEED + 15)
    w, T = nb.packed, nb.T
    seed = torch.tensor([11], dtype=torch.int64, device=device)
    primal, tangent = net_macs(w.hidden, w.layers, 3)
    once = fo.COND_DIM * w.hidden + fo.BASE_COLS * 16 + 16 * 4  # cond part of W0, base heads
    out = {"fused_sample_pdf_spherical": timed(
        "fused_sample_pdf_spherical", lambda: fo.fused_sample_pdf_spherical(w, cond, T, seed=seed),
        lambda: fo.sample_pdf_spherical_plain(w, cond, T, eps=eps), N_MAIN * (once + T * (primal + 2 * tangent)),
        N_MAIN * (4 * fo.COND_DIM + 20), N_MAIN, name)}
    for label, wk, dom, x, c, tk, reverse, jac in cases:
        n = x.shape[0]
        p, g = net_macs(wk.hidden, wk.layers, fo.X_ENC[dom])
        r = timed(f"fused_transport {label}",
                  lambda: fo.fused_transport_packed(wk, dom, x, c, tk, reverse=reverse, with_jac=jac),
                  lambda: fo.transport_plain(dom, wk, x, c, tk, reverse=reverse, with_jac=jac),
                  n * (fo.COND_DIM * wk.hidden + tk * (p + 2 * g if jac else p)),
                  n * (8 + 4 * fo.COND_DIM + 8 + 4), n, name, plain_runs=3)
        if label == K3_MAIN:
            out["fused_transport"] = r
    x, _, _ = fo.fused_sample_pdf_spherical(w, cond, T, seed=seed)
    omega = cart_to_spher(wi)
    with torch.no_grad():
        out["exact_pdf_plain_ms"] = cuda_ms(
            lambda: ode_pdf_exact("sphere_full", nb.v_params, nb.base_params, x, omega, cond, T,
                                  newton_iters=nb.pdf_newton_iters), runs=3, warmup=1)
    log(f"time plain exact spherical pdf (ode_pdf_exact, N={N_MAIN}, T={T}): {out['exact_pdf_plain_ms']:.3f} ms")
    return out


# K5's operations per test, counted as the kernel does them: a slab test is
# 6 sub, 6 mul, 10 min/max and 3 compares; a Moller-Trumbore test is 27 mul,
# 17 add/sub, 1 divide and 8 compares (min/max and compares count as fp32
# operations).
K5_BOX_OPS, K5_TRI_OPS = 25, 53
K5_RAY_BYTES = 36 + 4 + 1 + 16  # ro, rd, 1/rd, t_max, active in; t, prim, u, v out


def time_traverse(accel, cam, device, name: str) -> dict:
    """K5, its plain walker and its bound on each ray set at N_MAIN, the
    rays sorted by the render's own key as `render/integrator.py` traces
    them. The bound counts the work the plain walker did on these rays."""
    flops_peak, bytes_peak = next(v for k, v in PEAKS.items() if k in name)
    out = {}
    for set_name, (ro, rd, t_max, act, any_hit) in k5_ray_sets(accel, cam, device, N_MAIN, SEED + 7).items():
        perm, _ = _sort_perm(_ray_sort_key(rd, act))
        rs, ird = t8.safe_dir(rd[perm])
        args = (ro[perm].contiguous(), rs.contiguous(), ird.contiguous(), t_max[perm].contiguous(),
                act[perm].contiguous(), any_hit)
        ms = cuda_ms(lambda: t8.traverse8(accel, *args))
        plain_ms = cuda_ms(lambda: t8.traverse8_plain(accel, *args), runs=3, warmup=1)
        st = t8.traverse8_plain(accel, *args, stats=True)[5]
        ops = K5_BOX_OPS * st.box_tests + K5_TRI_OPS * st.tri_tests
        nbytes = N_MAIN * K5_RAY_BYTES + accel.packed_bytes
        out[set_name] = {"ms": ms, "plain_ms": plain_ms, "t_ops_ms": ops / flops_peak * 1e3,
                         "t_bytes_ms": nbytes / bytes_peak * 1e3, "active": int(act.sum()),
                         "mray_per_s": N_MAIN / ms / 1e3, **st._asdict(), "ops": ops, "bytes": nbytes}
        log(f"time traverse8 {set_name}: {out[set_name]}")
    tot = {k: sum(v[k] for v in out.values()) for k in ("ms", "plain_ms", "t_ops_ms", "t_bytes_ms")}
    tot["bound_ms"] = max(tot["t_ops_ms"], tot["t_bytes_ms"])
    tot["bound_tf32_ms"] = None  # no matrix product
    tot["bound_by"] = "operations" if tot["t_ops_ms"] >= tot["t_bytes_ms"] else "bytes"
    log(f"time traverse8, the four sets together: {tot}")
    return tot


# The renders of phase 8: (scene, mode, spp). `table` is the scene_bsdf-style
# twin of the measured scene.
RENDERS = (("measured", "gt", RENDER_SPP), ("measured", "neural-disk", RENDER_SPP),
           ("measured", "neural-spherical", RENDER_SPP), ("table", "gt", TABLE_SPP),
           ("table", "neural-sphere", TABLE_SPP))
K3_RENDER = ("table", "neural-sphere K3", TABLE_SPP)  # the reverse-Euler pdf, through render()
# launches a bounce each mode must show (K5 at least 2, the others exactly)
EXPECTED = {"gt": {}, "neural-disk": {"fused_sample_pdf_disk": 1},
            "neural-spherical": {"fused_sample_pdf_spherical": 1},
            "neural-sphere": {"fused_sample_pdf_spherical": 1},
            "neural-sphere K3": {"fused_sample_pdf_spherical": 1, "fused_transport": 2}}


def counted(fn):
    """Run fn with every launch count set to 0 just before; the counts just after."""
    fo.reset_launches()
    t8.reset_launches()
    out = fn()
    return out, {**fo.launches, **t8.launches}


def check_render(label: str, img, dt: float, spp: int, counts: dict, depth: int = RENDER_DEPTH,
                 mode: str | None = None, want: dict | None = None) -> dict:
    """Gates of a render: finite, not black, and each kernel's launches a
    bounce as EXPECTED has them for `mode` (the label's second word by
    default), or as `want` has them (K5 exactly, where it names
    "traverse8")."""
    bounces = (spp // RENDER_CHUNK) * depth
    r = {"seconds": dt, "mray_samples_per_s": RENDER_RES * RENDER_RES * spp / dt / 1e6, "spp": spp,
         "bounces": bounces, "launches": counts, "mean_rgb": img.reshape(-1, 3).mean(0).tolist()}
    log(f"render {label}: {r}")
    require(bool(np.isfinite(img).all()) and img.max() > 0, f"render {label}: non-finite or black image")
    require(counts["traverse8"] >= 2 * bounces, f"render {label}: K5 launched {counts['traverse8']} times "
            f"in {bounces} bounces")
    want = EXPECTED[mode or label.split(" ", 1)[1]] if want is None else want
    require("traverse8" not in want or counts["traverse8"] == want["traverse8"] * bounces,
            f"render {label}: K5 launched {counts['traverse8']} times in {bounces} bounces, expected "
            f"{want.get('traverse8')} a bounce")
    for k in fo.launches:
        require(counts[k] == want.get(k, 0) * bounces,
                f"render {label}: {k} launched {counts[k]} times in {bounces} bounces, "
                f"expected {want.get(k, 0)} a bounce")
    return r


def render_main_path(d: str, scenes: dict, weights: dict, sph_tree: dict, device) -> dict:
    """The renders through `cli/render.py`, counts around each, then the
    neural-sphere render with the reverse-Euler pdf (K3) through render()."""

    def cli(scene, mode, spp, depth):
        return render_cli.main(["--scene", scenes[scene], "--bsdf-dir", d, "--material", "synthetic_rgb",
                                "--mode", mode, "--checkpoint", weights.get(mode, ""), "--spp", str(spp),
                                "--spp-chunk", str(RENDER_CHUNK), "--max-depth", str(depth),
                                "--width", str(RENDER_RES), "--height", str(RENDER_RES), "--device", str(device),
                                "--out", os.path.join(d, f"{scene}_{mode}")])

    for scene, mode, _ in RENDERS:  # warm-up: CUDA module loading and the allocator's first blocks
        cli(scene, mode, RENDER_CHUNK, 2)
    out = {}
    for scene, mode, spp in RENDERS:
        (img, dt), counts = counted(lambda: cli(scene, mode, spp, RENDER_DEPTH))
        out[f"{scene} {mode}"] = (img, check_render(f"{scene} {mode}", img, dt, spp, counts))

    scene_t = load_scene(scenes["table"], device=device, width=RENDER_RES, height=RENDER_RES)
    nb = make_neural_bsdf("sphere_full", SPH_CFG, sph_tree["rectified"], sph_tree["base"],
                          sampler_cfg=SamplerConfig(pdf_exact=False), device=device)
    mb = neural_matball_sphere(nb, BSDF_MATERIALS[TABLE[0]], TABLE[1])
    render(scene_t, mb, spp=RENDER_CHUNK, spp_chunk=RENDER_CHUNK, max_depth=2, device=device)

    def k3_render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(scene_t, mb, seed=0, spp=K3_RENDER[2], spp_chunk=RENDER_CHUNK, max_depth=RENDER_DEPTH,
                     device=device)
        return img, time.perf_counter() - t0

    (img, dt), counts = counted(k3_render)
    label = f"{K3_RENDER[0]} {K3_RENDER[1]}"
    out[label] = (img, check_render(label, img, dt, K3_RENDER[2], counts))
    return out


def pixel_materials(accel, cam, device) -> np.ndarray:
    """(H, W) material id seen through each pixel's centre, -1 for the sky."""
    u = torch.ones((RENDER_RES * RENDER_RES, 2), device=device)  # u = 1: no filter offset
    ro, rd, _ = generate_rays(cam.vectors.to(device), RENDER_RES, RENDER_RES, u, 1)
    h = t8.intersect8(accel, ro, rd)
    mat = torch.where(h.t < 1e29, accel.attr_rows[h.prim, 15].to(torch.int64), -1)
    return mat.reshape(RENDER_RES, RENDER_RES).cpu().numpy()


def check_images(images: dict, mats: np.ndarray) -> dict:
    """Every image: the matball differs from the plane. The table scene's:
    the matball's centre is greener than red (the albedo tint). Both scenes
    share their geometry and camera, so one material map serves."""
    ball, plane = mats == MAT_BALL, mats == MAT_PLANE
    rows, cols = np.nonzero(ball)
    r0, r1, c0, c1 = rows.min(), rows.max(), cols.min(), cols.max()
    centre = np.zeros_like(ball)
    centre[(3 * r0 + r1) // 4:(r0 + 3 * r1) // 4, (3 * c0 + c1) // 4:(c0 + 3 * c1) // 4] = True
    centre &= ball
    out = {}
    for label, (img, _) in images.items():
        b, p, c = img[ball].mean(0), img[plane].mean(0), img[centre].mean(0)
        out[label] = {"ball_rgb": b.tolist(), "plane_rgb": p.tolist(), "ball_centre_rgb": c.tolist()}
        require(float(np.abs(b - p).max()) > 0.01, f"render {label}: the matball looks like the plane")
        if label.startswith("table"):
            require(c[1] > c[0], f"render {label}: the matball centre is not greener than red")

    def rel_mse(a, ref):
        return float(np.mean((a - ref) ** 2 / (ref ** 2 + 1e-2)))

    for label in images:
        scene, mode = label.split(" ", 1)
        if mode != "gt":
            out[f"relmse {label} vs gt"] = rel_mse(images[label][0], images[f"{scene} gt"][0])
    out["ball_pixels"], out["plane_pixels"], out["centre_pixels"] = int(ball.sum()), int(plane.sum()), int(centre.sum())
    log(f"images: {out}")
    return out


def bounce_breakdown(label: str, scene, mb, device, depth: int = 1) -> dict:
    """One bounce with matball `mb` at the render's 2^20-ray wavefront,
    timed by stage with CUDA events (median of RUNS); `depth` bounces are
    run first so the rays are the incoherent secondary ones."""
    gen = root_generator(SEED + 6, device)
    n = RENDER_RES * RENDER_RES * RENDER_CHUNK
    state = _init_wavefront(scene.camera.vectors.to(device), torch.rand((n, 2), generator=gen, device=device)
                            * (1 - 1e-7) + 1e-7, width=RENDER_RES, height=RENDER_RES, spp_chunk=RENDER_CHUNK)
    for dd in range(depth):
        state, _ = _bounce_body(scene.accel, scene.envmap, scene.lights, state, draw_bounce(gen, n, (mb,)), dd,
                                matball=(mb,))
    rnd = draw_bounce(gen, n, (mb,))
    stages = []
    for it in range(RUNS + 2):
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        _bounce_body(scene.accel, scene.envmap, scene.lights, state, rnd, depth, matball=(mb,), mark=mark)
        torch.cuda.synchronize()
        if it >= 2:
            stages.append({b[0]: a[1].elapsed_time(b[1]) for a, b in zip(marks[:-1], marks[1:])})
    med = {k: float(np.median([s[k] for s in stages])) for k in stages[0]}
    med["bounce"] = sum(med.values())
    med["alive_in"] = int(state[5].sum())
    log(f"bounce breakdown, {label}, at depth {depth}, n={n}, ms: {med}")
    return med


# ------------------------------------------------------------- training ----

# The training path at the CLI's full widths and batches, few iterations:
# MCMC at 10 bands x 50 walkers x (500 + 2000) sweeps (1,000,000 rows),
# pretrain at 9.8M rows, flow matching at 4.9M, rectify at 2^6 x 2^16 =
# 2^22 pairs a iteration through the teacher's T = 256 transport (K3).
TRAIN_MCMC = {"bands": 10, "walkers": 50, "burnin": 500, "steps": 2000}
TRAIN_ITERS = {"pretrain": 30, "diffusion": 30, "rectify": 3}
TRAIN_SPHERE_RECTIFY = 2
TRAIN_SPP = 16  # the trained checkpoint's neural-disk render
N_RECTIFY = 64 * (1 << 16)  # rectify's pairs a iteration, the CLI's 2^6 omega_i x 2^16
MCMC_CHECK_WI = (0.35, 0.0)  # tests/test_mcmc_external.py's omega_i
MCMC_CHECK_BINS = 12
SWEEP_TIMING = {True: (200, 2200), False: (100, 600)}  # graph or eager: (short, long) runs, sweeps
LOSS_LINE = re.compile(r"^\[([\w-]+)/(\w+)\] step (\d+)/(\d+) loss (\S+)", re.M)


def train_argv(d: str, out: str, domain: str, material: str, iters_rectify: int) -> list:
    return ["--domain", domain, "--material", material, "--bsdf-dir", d, "--out", out, "--device", "cuda",
            *(a for k, v in TRAIN_MCMC.items() for a in (f"--mcmc-{k}", str(v))),
            "--batch-pretrain", "9800000", "--batch-diffusion", "4900000",
            "--iters-pretrain", str(TRAIN_ITERS["pretrain"]), "--iters-diffusion", str(TRAIN_ITERS["diffusion"]),
            "--iters-rectify", str(iters_rectify), "--timestep-rectify", "256", "--num-samples-rectify", "2**16",
            "--batch-wi-rectify", "2**6", "--save-every", "10", "--log-every", "1"]


class Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s: str) -> int:
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


class PairRecorder:
    """Within its block, wraps `train/stages.py::make_rectify_pairgen`: each
    pair generator call's K3 launches are recorded, and the first call keeps
    N_LONG of its pairs (every n / N_LONG-th, so every omega_i block is in)
    with what recomputes them. Nothing is launched here."""

    def __enter__(self):
        self.calls, self.first, self.orig = [], None, stages.make_rectify_pairgen

        def make(domain, cfg, T):
            inner = self.orig(domain, cfg, T)

            def pairgen(teacher, base_params, gen, n_wi, n_per_wi):
                before = fo.launches["fused_transport"]
                x0, x1, wi = inner(teacher, base_params, gen, n_wi, n_per_wi)
                self.calls.append(fo.launches["fused_transport"] - before)
                if self.first is None:
                    sl = slice(None, None, max(x0.shape[0] // N_LONG, 1))
                    self.first = (domain, cfg, T, teacher, x0.shape[0], x0[sl].clone(), x1[sl].clone(),
                                  wi[sl].clone())
                return x0, x1, wi

            return pairgen

        stages.make_rectify_pairgen = make
        return self

    def __exit__(self, *exc):
        stages.make_rectify_pairgen = self.orig


def train_run(argv: list) -> dict:
    """`cli/train.py` with its log kept, the launch counts set to 0 just
    before and read just after, and the pair generator recorded."""
    buf = io.StringIO()
    with PairRecorder() as rec, contextlib.redirect_stdout(Tee(sys.stdout, buf)):
        (params, stats), counts = counted(lambda: train_cli.main(argv))
    return {"params": params, "stats": stats, "counts": counts, "log": buf.getvalue(), "rec": rec}


def check_dataset(path: str, domain: str) -> dict:
    """The cached MCMC dataset: shape, finite, in support, each band's
    omega_i in its band."""
    s = np.load(path)
    bands, steps, walkers = TRAIN_MCMC["bands"], TRAIN_MCMC["steps"], TRAIN_MCMC["walkers"]
    wi, wo = s[:, :2], s[:, 2:]
    if domain == "disk":
        r = np.sqrt((wi.astype(np.float64) ** 2).sum(-1)).reshape(bands, -1)
        edge = np.arange(bands + 1)[:, None] / bands
        in_support = bool(((wo.astype(np.float64) ** 2).sum(-1) <= 1.0).all())
    else:
        r = wi[:, 0].astype(np.float64).reshape(bands, -1)
        edge = np.arange(bands + 1)[:, None] * (math.pi / bands)
        in_support = bool(((wo[:, 0] > 0) & (wo[:, 0] < math.pi) & (np.abs(wo[:, 1]) < math.pi)
                           & (np.abs(wi[:, 1]) < math.pi)).all())
    in_band = bool(((r > edge[:-1] - 1e-6) & (r <= edge[1:] + 1e-6)).all())
    out = {"shape": list(s.shape), "finite": bool(np.isfinite(s).all()), "in_support": in_support,
           "in_band": in_band, "mean_wi_dot_wo": float(np.mean(wi * wo))}
    log(f"  dataset {domain}: {out}")
    require(tuple(s.shape) == (bands * steps * walkers, 4), f"dataset {domain}: shape {s.shape}")
    require(out["finite"] and in_support and in_band, f"dataset {domain}: non-finite or out of support: {out}")
    return out


def check_run(run: dict, domain: str, n_rectify: int, resumed: bool) -> dict:
    """Every logged loss finite; a fresh pretrain's last NLL below its
    first; K3 launched once a rectify iteration and nowhere else; the first
    iteration's pairs recomputed by the plain transport within 2e-5."""
    losses = {}
    for stage, dom, it, _, v in LOSS_LINE.findall(run["log"]):
        losses.setdefault(stage, []).append((int(it), float(v)))
    require(all(math.isfinite(v) for vals in losses.values() for _, v in vals), f"{domain}: a loss is not finite")
    rec = run["rec"]
    k3 = run["counts"]["fused_transport"]
    out = {"losses_logged": {k: len(v) for k, v in losses.items()}, "k3_launches": k3, "k3_per_pairgen": rec.calls,
           "stages": {k: {"iters": v["iters"], "ms_median": v["ms_median"],
                          "peak_gib": v["peak_bytes"] / 2**30 if v["peak_bytes"] is not None else None}
                      for k, v in run["stats"].items() if k != "mcmc"},
           "mcmc_seconds": run["stats"]["mcmc"]["seconds"]}
    require(k3 == n_rectify and rec.calls == [1] * n_rectify,
            f"{domain}: K3 launched {k3} times, {rec.calls} in the pair generator, expected 1 in each of "
            f"{n_rectify} rectify iterations")
    require(all(run["counts"][k] == 0 for k in fo.launches if k != "fused_transport"),
            f"{domain}: another kernel was launched in training: {run['counts']}")
    if not resumed:
        pre = losses["pretrain"]
        out["pretrain_nll_first_last"] = (pre[0][1], pre[-1][1])
        require(pre[0][0] == 0 and pre[-1][1] < pre[0][1], f"{domain}: the pretrain NLL did not fall: {pre}")
    dom, cfg, T, teacher, n, x0, x1, wi = rec.first
    cond = encode_condition(wi, cfg)
    with torch.no_grad():
        xp, _ = fo.transport_plain(dom, teacher, x0, cond, T, with_jac=False)
    x64 = transport_fp64(dom, teacher, x0, cond, T)
    out["pairs"] = {"rows": n, "checked": x0.shape[0], "T": T, "teacher": f"{teacher.layers}x{teacher.hidden}",
                    "x_abs": max_abs(x1, xp), "x_moved_max": max_abs(xp, x0), "x_max": float(xp.abs().max()),
                    "x_abs_vs_fp64": max_abs(x1.double(), x64), "plain_vs_fp64": max_abs(xp.double(), x64)}
    log(f"  {domain}{' resumed' if resumed else ''}: {out}")
    require(bool(torch.isfinite(x1).all()) and out["pairs"]["x_abs"] <= TOL_SPH_X_ABS,
            f"{domain}: rectify pairs differ from the plain transport: {out['pairs']}")
    return out


def mcmc_check(device) -> dict:
    """The ensemble at a fixed omega_i on ggx_shading_disk(roughness 0.4), 64
    walkers x 2500 sweeps, against the pdf grid of each cell's integral at
    KL < 0.05 (against cell centres the KL of any chain stays ~0.045)."""
    wi = torch.tensor(MCMC_CHECK_WI, device=device)

    def density(x):
        inside = (x**2).sum(-1) < 1.0
        f = ggx_shading_disk(wi.expand(x.shape[0], 2), torch.where(inside[:, None], x, 0.0), roughness=0.4)
        return torch.where(inside, torch.clamp(f, min=0.0), 0.0)

    def log_prob(x):
        f = density(x)
        return torch.where(f > 0, torch.log(torch.clamp(f, min=1e-38)), -math.inf)

    g = root_generator(SEED + 20, device)
    x0 = -0.5 * wi + 0.05 * torch.randn((64, 2), generator=g, device=device)
    chain, acc = ensemble_mcmc(g, log_prob, x0, nsteps=2500, burn_in=500)
    lo, hi = (-1.0, -1.0), (1.0, 1.0)
    hist = histogram_grid_2d(chain.reshape(-1, 2).cpu().numpy(), lo, hi, MCMC_CHECK_BINS)
    out = {"walkers": 64, "sweeps": 2500, "burn_in": 500, "acceptance": float(acc),
           "kl": kl_divergence_grid(hist, pdf_grid_2d(density, lo, hi, MCMC_CHECK_BINS, device=device, sub=8)),
           "kl_cell_centres": kl_divergence_grid(hist, pdf_grid_2d(density, lo, hi, MCMC_CHECK_BINS, device=device))}
    log(f"  MCMC check: {out}")
    require(bool(torch.isfinite(chain).all()) and 0.1 < out["acceptance"] < 0.9, f"MCMC check: {out}")
    require(out["kl"] < 0.05, f"MCMC check: KL {out['kl']} against the GGX pdf grid")
    return out


def time_sweeps(d: str, device) -> dict:
    """ms a sweep of the dataset's ensemble (10 bands x 50 walkers on the
    measured disk target), with the CUDA graph and eager: the difference of
    a long and a short run over their sweeps, so the start-up (the first
    chunk, the capture) drops out."""
    pdf_fn = train_cli.make_target_pdf(train_cli.build_parser().parse_args(["--material", "synthetic_rgb",
                                                                             "--bsdf-dir", d]), device)
    bands, walkers = TRAIN_MCMC["bands"], TRAIN_MCMC["walkers"]
    x0 = generate_brdf_dataset(SEED + 21, pdf_fn, nsteps=1, nwalkers=walkers, piecewise=bands, burn_in=100,
                               device=device).reshape(bands, walkers, 4)  # the last sweep: walkers in support
    bounds = (torch.arange(bands, device=device) / bands, torch.arange(1, bands + 1, device=device) / bands)
    log_prob = make_domain_log_prob(pdf_fn, "disk")
    out = {}
    for graph, runs in SWEEP_TIMING.items():
        secs = []
        for n in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ensemble_mcmc(root_generator(SEED + 22, device), log_prob, x0, nsteps=n, log_prob_args=bounds,
                          graph=graph)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out["graph" if graph else "eager"] = 1e3 * (secs[1] - secs[0]) / (runs[1] - runs[0])
    log(f"  MCMC ms a sweep (10 bands x 50 walkers, measured disk target): {out}")
    return out


def time_rectify_k3(teachers: dict, device, name: str) -> dict:
    """K3 at rectify's shape, 2^22 rows and T = 256, with the trained
    teachers, its plain version and its bound."""
    rng = np.random.default_rng(SEED + 23)
    n = N_RECTIFY
    out = {}
    for label, (w, dom) in teachers.items():
        x0 = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32) * 0.3).to(device)
        wi = hemisphere(torch.from_numpy(rng.random((n, 2), dtype=np.float32)).to(device))
        cond = encode_condition(wi[:, :2] if dom == "disk" else cart_to_spher(wi), ModelConfig(domain=dom))
        p, _ = net_macs(w.hidden, w.layers, fo.X_ENC[dom])
        out[label] = timed(f"fused_transport rectify {label} T=256",
                           lambda: fo.fused_transport_packed(w, dom, x0, cond, 256, with_jac=False),
                           lambda: fo.transport_plain(dom, w, x0, cond, 256, with_jac=False),
                           n * (fo.COND_DIM * w.hidden + 256 * p), n * (8 + 4 * fo.COND_DIM + 8 + 4), n, name,
                           plain_runs=2)
    return out


def training_phase(d: str, scenes: dict, device, name: str) -> dict:
    """Phase 10: the MCMC check and sweep times; disk training through
    `cli/train.py` on the phase-5 scene's measured BRDF, its resume, and
    full-sphere training on table material 20; K3 at rectify's shape; the
    trained disk checkpoint rendered through `cli/render.py`."""
    out = {"mcmc_check": mcmc_check(device), "mcmc_sweep_ms": time_sweeps(d, device)}
    runs = {}
    disk_out = os.path.join(d, "train_disk")
    runs["disk"] = train_run(train_argv(d, disk_out, "disk", "synthetic_rgb", TRAIN_ITERS["rectify"]))
    out["disk"] = check_run(runs["disk"], "disk", TRAIN_ITERS["rectify"], resumed=False)
    out["disk"]["dataset"] = check_dataset(os.path.join(disk_out, "mcmc_disk_synthetic_rgb.npy"), "disk")
    resume = train_run(train_argv(d, disk_out, "disk", "synthetic_rgb", TRAIN_ITERS["rectify"] + 1))
    out["disk_resume"] = check_run(resume, "disk", 1, resumed=True)
    for stage, at in (("pretrain", TRAIN_ITERS["pretrain"]), ("diffusion-simpler", TRAIN_ITERS["diffusion"]),
                      ("rectify", TRAIN_ITERS["rectify"])):
        require(f"[{stage}/disk] resumed at step {at}" in resume["log"], f"resume: {stage} did not resume at {at}")
    require(resume["stats"]["rectify/disk"]["iters"] == 1 and resume["stats"]["pretrain/disk"]["iters"] == 0,
            f"resume: took {[(k, v['iters']) for k, v in resume['stats'].items() if k != 'mcmc']} steps")
    sph_out = os.path.join(d, "train_sphere")
    runs["sphere_full"] = train_run(train_argv(d, sph_out, "sphere_full", "table:20", TRAIN_SPHERE_RECTIFY))
    out["sphere_full"] = check_run(runs["sphere_full"], "sphere_full", TRAIN_SPHERE_RECTIFY, resumed=False)
    out["sphere_full"]["dataset"] = check_dataset(os.path.join(sph_out, "mcmc_sphere_full_table_20.npy"),
                                                  "sphere_full")

    teachers = {"disk 3x32": (fo.prepack_velocity(runs["disk"]["params"]["teacher"]), "disk"),
                "spherical 6x64": (fo.prepack_velocity(runs["sphere_full"]["params"]["teacher"]), "spherical")}
    out["k3_rectify"] = time_rectify_k3(teachers, device, name)
    defaults = train_cli.build_parser().parse_args([])
    for (dom, run), k3 in zip(runs.items(), ("disk 3x32", "spherical 6x64")):
        st = {k.split("/")[0]: v["ms_median"] for k, v in run["stats"].items() if k != "mcmc"}
        out[dom]["k3_share_of_rectify"] = out["k3_rectify"][k3]["ms"] / st["rectify"]
        ms = (defaults.iters_pretrain * st["pretrain"]
              + defaults.iters_diffusion * sum(v for k, v in st.items() if k.startswith("diffusion"))
              + defaults.iters_rectify * st["rectify"]
              + (defaults.mcmc_steps + defaults.mcmc_burnin) * out["mcmc_sweep_ms"]["graph"])
        out[dom]["extrapolated_cli_hours"] = ms / 3.6e6
    log(f"  K3's share of a rectify iteration: disk {out['disk']['k3_share_of_rectify']:.3f}, "
        f"sphere_full {out['sphere_full']['k3_share_of_rectify']:.3f}; at the CLI's iterations: disk "
        f"{out['disk']['extrapolated_cli_hours']:.2f} h, sphere_full {out['sphere_full']['extrapolated_cli_hours']:.2f} h")

    def cli(spp, depth):
        return render_cli.main(["--scene", scenes["measured"], "--bsdf-dir", d, "--material", "synthetic_rgb",
                                "--mode", "neural-disk", "--checkpoint", os.path.join(disk_out, "final.npz"),
                                "--spp", str(spp), "--spp-chunk", str(RENDER_CHUNK), "--max-depth", str(depth),
                                "--width", str(RENDER_RES), "--height", str(RENDER_RES), "--device", str(device),
                                "--out", os.path.join(d, "trained_neural-disk")])

    cli(RENDER_CHUNK, 2)  # warm-up
    (img, dt), counts = counted(lambda: cli(TRAIN_SPP, RENDER_DEPTH))
    out["render"] = check_render("trained neural-disk", img, dt, TRAIN_SPP, counts)
    return out


# ------------------------------ gradients, reference weights, the zoo ----

# The differentiable transport at the main path's 2^20 rows: (label, weights
# of phase 3, domain, T, reverse). Gradients against plain autograd through
# `transport_with_det` on the card at tests/test_diff.py:170-171's
# tolerance: |got - want| <= atol + rtol |want| elementwise.
DIFF_CASES = (("disk 3x32 forward T=4", "neural-disk", "disk", 4, False),
              ("spherical 4x32 forward T=8", "neural-spherical", "spherical", 8, False),
              ("spherical 4x32 reverse T=8", "neural-spherical", "spherical", 8, True))
TOL_GRAD_RTOL, TOL_GRAD_ATOL = 2e-3, 1e-6
# tests/test_diff.py:72-128's pixel loss at 512 x 512 pixels x 4 draws (2^20
# rows through K3), its gradient against central differences along random
# unit directions in the velocity weights' space.
PIXEL_RES, PIXEL_S, PIXEL_T = 512, 4, 4
FD_H, FD_RTOL, FD_ATOL, FD_DIRECTIONS = 3e-3, 5e-2, 1e-5, 3
# At these weights the directional derivatives are ~1e-6, so the fp32
# differences above pass on their atol; the same differences in fp64 through
# the plain transport are exact to ~1e-8 relative (a CPU rehearsal read
# 2e-6 against the gradient), and are held to FD64_RTOL with no atol.
FD64_RTOL = 1e-3
# The renders with the reference's weights: 512 x 512, 16 spp, depth cut to
# 4 so that the neural-sphere render (the plain exact spherical pdf, twice
# a bounce) keeps the phase near a minute; phase 8 runs the same kernels at
# depth 12.
REF_SPP, REF_DEPTH = 16, 4
REF_RENDERS = (("measured", "neural-disk"), ("measured", "neural-spherical"), ("table", "neural-sphere"))
REF_MATERIAL = "synthetic_rgb"
SUBSTITUTE_RES = 64
ZOO_BATCH, ZOO_ROWS = 64, 1 << 16


def allclose_ratio(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 where torch.allclose holds."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def diff_inputs(domain: str, device, seed: int):
    """x0 (N_MAIN, 2) and cond_enc: disk x0 ~ 0.3 N(0, 1) at disk-coordinate
    wi; spherical x0 = (theta in [0.2, 1.3], phi in [-3, 3]) at spherical wi."""
    rng = np.random.default_rng(seed)
    wi = hemisphere(torch.from_numpy(rng.random((N_MAIN, 2), dtype=np.float32)).to(device))
    if domain == "disk":
        cond, x0 = encode_condition(wi[:, :2], ModelConfig()), 0.3 * rng.standard_normal((N_MAIN, 2))
    else:
        cond = encode_condition(cart_to_spher(wi), SPH_CFG)
        x0 = np.stack([rng.uniform(0.2, 1.3, N_MAIN), rng.uniform(-3.0, 3.0, N_MAIN)], -1)
    return torch.from_numpy(x0.astype(np.float32)).to(device), cond


def transport_loss(x: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    return (x * x).sum() + ((det - 1.0) ** 2).sum()


def peak_gib(fn):
    """fn's result and the device memory it allocated at its peak, beyond
    what was allocated before it, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - before) / 2**30


def diff_transport(trees: dict, device, name: str) -> dict:
    """Phase 11a: gradients through `fused_transport_diff` against plain
    autograd, K3 once a forward and 0 in the backward, times and peaks."""
    out = {}
    for i, (label, mode, dom, T, reverse) in enumerate(DIFF_CASES):
        ws = [torch.from_numpy(layer["w"]).to(device).requires_grad_() for layer in trees[mode]["rectified"]]
        x0, cond = diff_inputs(dom, device, SEED + 40 + i)
        leaves = [*ws, x0.requires_grad_(), cond.requires_grad_()]
        v = [{"w": w} for w in ws]

        def fwd():
            return fo.fused_transport_diff(dom, v, x0, cond, T, reverse)

        def plain_grads():
            return torch.autograd.grad(transport_loss(*transport_with_det(dom, v, x0, cond, T, reverse=reverse)),
                                       leaves)

        (x, det), fwd_counts = counted(fwd)
        loss = transport_loss(x, det)
        (g, bwd_counts), peak = peak_gib(lambda: counted(lambda: torch.autograd.grad(loss, leaves, retain_graph=True)))
        gp, peak_plain = peak_gib(plain_grads)
        ratio = max(allclose_ratio(a, b, TOL_GRAD_RTOL, TOL_GRAD_ATOL) for a, b in zip(g, gp))
        rel = max(max_rel(a, b) for a, b in zip(g[:len(ws)], gp[:len(ws)]))
        require(fwd_counts["fused_transport"] == 1 and sum(fwd_counts.values()) == 1,
                f"diff {label}: forward launches {fwd_counts}, expected K3 once")
        require(sum(bwd_counts.values()) == 0, f"diff {label}: backward launched {bwd_counts}")
        require(all(bool(torch.isfinite(t).all()) for t in g), f"diff {label}: non-finite gradient")
        require(ratio <= 1.0, f"diff {label}: gradients differ from plain autograd ({ratio:.3g} of the tolerance)")
        hidden = ws[1].shape[0]
        p, t = net_macs(hidden, len(ws) - 1, fo.X_ENC[dom])
        macs, nbytes = N_MAIN * (fo.COND_DIM * hidden + T * (p + 2 * t)), N_MAIN * (8 + 4 * fo.COND_DIM + 12)
        flops_peak, bytes_peak = next(v for k, v in PEAKS.items() if k in name)
        t_ops, t_bytes = 2.0 * macs / flops_peak * 1e3, nbytes / bytes_peak * 1e3
        out[label] = {"n": N_MAIN, "launches_forward": fwd_counts["fused_transport"],
                      "launches_backward": bwd_counts["fused_transport"], "grad_tolerance_used": ratio,
                      "weight_grad_max_rel": rel, "ms": cuda_ms(fwd),
                      "backward_ms": cuda_ms(lambda: torch.autograd.grad(loss, leaves, retain_graph=True), runs=5,
                                             warmup=1),
                      "plain_fwd_bwd_ms": cuda_ms(plain_grads, runs=3, warmup=1),
                      "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "peak_gib": peak, "plain_peak_gib": peak_plain}
        log(f"  diff {label}: {out[label]}")
        del x, det, loss, g, gp
    return out


def pixel_loss(v_params: list, base_params: dict, wi_img: torch.Tensor, eps: torch.Tensor, T: int,
               transport) -> torch.Tensor:
    """tests/test_diff.py:72-100's one-bounce direct-light image: per pixel
    S reparametrised draws of the disk sampler at the pixel's wi (npix, 2),
    eps (npix, S, 2); radiance L_env(x) f(wi, x) / pdf with a Gaussian
    lobe for the environment; the loss is the mean pixel energy.
    `transport(v_params, x0, cond_enc)` gives (x, det)."""
    npix, s, _ = eps.shape
    wi = wi_img.repeat_interleave(s, dim=0)
    cond = encode_condition(wi, ModelConfig())
    loc, ls = disk_heads_from_enc(base_params, cond[:, :fo.BASE_COLS])
    e = eps.reshape(-1, 2)
    x0 = loc + e * torch.exp(ls)
    log_p0 = (-ls - 0.5 * e * e).sum(-1) - math.log(2.0 * math.pi)
    x, det = transport(v_params, x0, cond)
    pdf = torch.exp(log_p0) / det
    lum = torch.exp(-4.0 * ((x - x.new_tensor([0.2, -0.3])) ** 2).sum(-1))
    # inside the unit disk, where disk_to_cart's sqrt(1 - r^2) keeps a finite derivative
    r = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    x_safe = x * (torch.clamp(r, max=0.95) / torch.clamp(r, min=1e-6))
    f = ggx_shading_disk(wi, x_safe, roughness=0.6, diffuse_prob=0.3)
    img = (lum * f / torch.clamp(pdf, min=1e-3)).reshape(npix, s).mean(1)
    return (img * img).mean()


def diff_pixel(tree: dict, device) -> dict:
    """Phase 11b: the pixel loss's gradient through K3 against central
    differences along FD_DIRECTIONS random unit directions."""
    rng = np.random.default_rng(SEED + 45)
    npix = PIXEL_RES * PIXEL_RES
    wi_img = torch.from_numpy(rng.uniform(-0.5, 0.5, (npix, 2)).astype(np.float32)).to(device)
    eps = torch.from_numpy(rng.standard_normal((npix, PIXEL_S, 2)).astype(np.float32)).to(device)
    base = params_from_jax(tree["base"], device)
    shapes = [layer["w"].shape for layer in tree["rectified"]]
    flat = torch.cat([torch.from_numpy(layer["w"]).reshape(-1) for layer in tree["rectified"]]).to(device)

    def k3(p, x0, c):
        return fo.fused_transport_diff("disk", p, x0, c, PIXEL_T)

    def plain(p, x0, c):
        return transport_with_det("disk", p, x0, c, PIXEL_T)

    def loss_at(f, transport=k3):
        v, at = [], 0
        for shape in shapes:
            v.append({"w": f[at:at + math.prod(shape)].reshape(shape)})
            at += math.prod(shape)
        b = {"net": [{k: t.to(f.dtype) for k, t in layer.items()} for layer in base["net"]]}
        return pixel_loss(v, b, wi_img.to(f.dtype), eps.to(f.dtype), PIXEL_T, transport)

    leaf = flat.clone().requires_grad_()

    def value_and_grad():
        val = loss_at(leaf)
        return val, torch.autograd.grad(val, leaf)[0]

    (l0, grad), counts = counted(value_and_grad)
    require(bool(torch.isfinite(l0)) and bool(torch.isfinite(grad).all()), "pixel loss: non-finite value or gradient")
    require(counts["fused_transport"] == 1 and sum(counts.values()) == 1,
            f"pixel loss: launches {counts}, expected K3 once (the forward)")
    checks = []
    with torch.no_grad():
        for _ in range(FD_DIRECTIONS):
            dvec = rng.standard_normal(flat.shape[0])
            dvec = torch.from_numpy((dvec / np.linalg.norm(dvec)).astype(np.float32)).to(device)
            fd = (float(loss_at(flat + FD_H * dvec)) - float(loss_at(flat - FD_H * dvec))) / (2.0 * FD_H)
            f64, d64 = flat.double(), dvec.double()
            fd64 = (float(loss_at(f64 + FD_H * d64, plain)) - float(loss_at(f64 - FD_H * d64, plain))) / (2.0 * FD_H)
            ad = float(grad.double() @ d64)
            checks.append({"ad": ad, "fd": fd, "tolerance_used": abs(ad - fd) / (FD_ATOL + FD_RTOL * abs(fd)),
                           "fd_fp64_plain": fd64, "rel_vs_fd_fp64": abs(ad - fd64) / abs(fd64)})
    out = {"pixels": npix, "samples": PIXEL_S, "rows": npix * PIXEL_S, "T": PIXEL_T, "loss": float(l0.detach()),
           "launches": counts["fused_transport"], "fd": checks, "value_and_grad_ms": cuda_ms(value_and_grad, runs=5)}
    log(f"  diff pixel loss: {out}")
    require(all(c["tolerance_used"] <= 1.0 for c in checks), "pixel loss: gradient disagrees with central differences")
    require(all(c["rel_vs_fd_fp64"] <= FD64_RTOL for c in checks),
            "pixel loss: gradient disagrees with fp64 central differences")
    return out


def reference_state_dict(rng, dims: list, bias: bool, scale: float = 1.0) -> dict:
    """A torch MLP state dict in the reference's layout: linear1..linearN,
    output; (out, in) weights, Kaiming-uniform from `rng`."""
    names = [f"linear{i + 1}" for i in range(len(dims) - 2)] + ["output"]
    sd = {}
    for name, d_in, d_out in zip(names, dims[:-1], dims[1:]):
        bound = 1.0 / math.sqrt(d_in)
        sd[f"{name}.weight"] = torch.from_numpy((scale * rng.uniform(-bound, bound, (d_out, d_in))).astype(np.float32))
        if bias:
            sd[f"{name}.bias"] = torch.from_numpy(rng.uniform(-bound, bound, d_out).astype(np.float32))
    return sd


def write_reference_checkpoints(root: str, seed: int) -> None:
    """The reference's checkpoint directories for REF_MATERIAL (disk, and
    spherical with no pretrain file of its own) and table material 20
    (its own pretrain file, the diffusion nets under the legacy names), at
    the reference's widths: base nets with biases, velocity nets bias-free
    with weights x 0.5 as `init_weights` makes them."""
    rng = np.random.default_rng(seed)
    base, disk, sph, teacher = [14, 16, 4], [25] + [32] * 3 + [2], [26] + [32] * 4 + [2], [26] + [64] * 6 + [2]
    m, legacy = REF_MATERIAL, "neusample_pos_diffusion_brdf_mcmc_pytorch_emcee_onemode"
    files = {f"{m}_disk/brdf_pretrain_network{m}.pth": base, f"{m}_disk/brdf_diffusion_network{m}.pth": disk,
             f"{m}_disk/brdf_rectify_network{m}.pth": disk,
             f"{m}_spherical/brdf_diffusion_network_simpler{m}.pth": sph,
             f"{m}_spherical/brdf_diffusion_network_complex{m}.pth": teacher,
             f"{m}_spherical/brdf_rectify_network{m}.pth": sph,
             "bsdf_20_spherical/brdf_pretrain_network20.pth": base, f"bsdf_20_spherical/{legacy}32.pth": sph,
             f"bsdf_20_spherical/{legacy}64.pth": teacher, "bsdf_20_spherical/brdf_rectify_network20.pth": sph}
    for rel, dims in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        is_base = dims is base
        torch.save(reference_state_dict(rng, dims, bias=is_base, scale=1.0 if is_base else 0.5), path)


def reference_phase(d: str, scenes: dict, device) -> dict:
    """Phase 11c: renders through `cli/render.py --weights reference`, the
    importer on each directory, and the neural-disk render again from the
    imported `final.npz`."""
    root = os.path.join(d, "checkpoints_new")
    write_reference_checkpoints(root, SEED + 50)

    def cli(scene, mode, weights, out):
        return render_cli.main(["--scene", scenes[scene], "--bsdf-dir", d, "--material", REF_MATERIAL, "--mode", mode,
                                *weights, "--spp", str(REF_SPP), "--spp-chunk", str(RENDER_CHUNK), "--max-depth",
                                str(REF_DEPTH), "--width", str(RENDER_RES), "--height", str(RENDER_RES),
                                "--device", str(device), "--out", os.path.join(d, out)])

    ref = ["--weights", "reference", "--reference-ckpts", root]
    out, images = {}, {}
    for scene, mode in REF_RENDERS:
        (img, dt), counts = counted(lambda: cli(scene, mode, ref, f"ref_{scene}_{mode}"))
        images[mode] = img
        out[f"{scene} {mode}"] = check_render(f"reference {scene} {mode}", img, dt, REF_SPP, counts, REF_DEPTH, mode)

    imported = {}
    for material, domain in ((REF_MATERIAL, "disk"), (REF_MATERIAL, "spherical"), ("20", "sphere_full")):
        path = os.path.join(d, f"imported_{domain}.npz")
        tree = import_cli.main(["--checkpoints-root", root, "--material", material, "--domain", domain,
                                "--out", path, "--device", str(device)])
        back, step = load_pytree(path)
        same = all(np.array_equal(a["w"], b["w"].cpu().numpy()) for k in ("diffusion", "teacher", "rectified")
                   for a, b in zip(back[k], tree[k]))
        require(step == 0 and same, f"import {domain}: final.npz does not hold the imported weights")
        imported[domain] = tree

    # K3 on the imported weights: the table scene's neural-sphere render with
    # the reverse-Euler pdf, through render()
    scene_t = load_scene(scenes["table"], device=device, width=RENDER_RES, height=RENDER_RES)
    sph = imported["sphere_full"]
    nb = make_neural_bsdf("sphere_full", SPH_CFG, sph["rectified"], sph["base"],
                          sampler_cfg=SamplerConfig(pdf_exact=False), device=device)
    mb = neural_matball_sphere(nb, BSDF_MATERIALS[TABLE[0]], TABLE[1])

    def k3_render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(scene_t, mb, seed=0, spp=REF_SPP, spp_chunk=RENDER_CHUNK, max_depth=REF_DEPTH, device=device)
        return img, time.perf_counter() - t0

    (img, dt), counts = counted(k3_render)
    out["table neural-sphere K3"] = check_render("reference table neural-sphere K3", img, dt, REF_SPP, counts,
                                                 REF_DEPTH, "neural-sphere K3")

    (img, dt), counts = counted(lambda: cli("measured", "neural-disk",
                                            ["--checkpoint", os.path.join(d, "imported_disk.npz")], "imported_disk"))
    out["imported neural-disk"] = check_render("imported measured neural-disk", img, dt, REF_SPP, counts, REF_DEPTH,
                                               "neural-disk")
    ref_img = images["neural-disk"]
    diff = float(np.abs(img - ref_img).max())
    out["imported_vs_reference"] = {"max_abs": diff, "mean_pixel": float(ref_img.mean()),
                                    "bit_equal": bool(np.array_equal(img, ref_img))}
    log(f"  neural-disk from final.npz vs --weights reference: {out['imported_vs_reference']}")
    require(diff <= 1e-5 * float(ref_img.mean()), "the imported final.npz renders another image than the reference")
    return out


def substitute_phase(d: str, scenes: dict, device) -> dict:
    """Phase 11d: a missing .bsdf raises without --allow-substitute and is
    rendered as chm_mint_rgb, recorded in <out>.meta.json, with it."""
    shutil.copy(os.path.join(d, f"{REF_MATERIAL}.bsdf"), os.path.join(d, "chm_mint_rgb.bsdf"))
    out_path = os.path.join(d, "substituted")
    argv = ["--scene", scenes["measured"], "--bsdf-dir", d, "--material", "aniso_missing", "--mode", "gt",
            "--spp", "1", "--spp-chunk", "1", "--max-depth", "2", "--width", str(SUBSTITUTE_RES), "--height",
            str(SUBSTITUTE_RES), "--device", str(device), "--out", out_path]
    try:
        render_cli.main(argv)
    except FileNotFoundError as e:
        log(f"  without --allow-substitute: FileNotFoundError ({e})")
    else:
        raise AssertionError("a missing .bsdf rendered without --allow-substitute")
    img, _ = render_cli.main(argv + ["--allow-substitute"])
    with open(out_path + ".meta.json") as f:
        meta = json.load(f)
    want = {"material_substitutions": [{"ball": "aniso_missing", "substituted": "chm_mint_rgb"}], "mode": "gt",
            "material": "aniso_missing"}
    require(meta == want, f"substitution record {meta}, expected {want}")
    require(bool(np.isfinite(img).all()) and img.max() > 0, "substituted render: non-finite or black image")
    log(f"  with --allow-substitute: {meta}")
    return meta


def zoo_phase(device) -> dict:
    """Phase 11e: one U-Net training step at batch ZOO_BATCH; the two
    mixture bases' sample and log_prob at ZOO_ROWS rows."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 60)
    params = unet_init(gen)
    leaves = [p for layer in params.values() for p in layer.values()]
    for p in leaves:
        p.requires_grad_()
    x = torch.randn((ZOO_BATCH, 32, 32, 1), generator=gen, device=device)
    alpha = torch.rand((ZOO_BATCH,), generator=gen, device=device)

    def loss():
        return ((unet_apply(params, x, alpha) - x) ** 2).mean()

    l0 = loss()
    grads = torch.autograd.grad(l0, leaves)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p -= 0.05 * g
    l1 = loss()
    l0, l1 = float(l0.detach()), float(l1.detach())
    require(math.isfinite(l0) and l1 < l0, f"U-Net step: loss {l0} -> {l1}")
    out = {"unet": {"batch": ZOO_BATCH, "loss_before": l0, "loss_after": l1,
                    "step_ms": cuda_ms(lambda: torch.autograd.grad(loss(), leaves), runs=3)}}
    for label, base, wi in (("gmm_disk", gmm_disk_base(n_modes=3), (0.2, -0.3)),
                            ("mixture_spherical", mixture_spherical_base(n_modes=2), (0.4, 0.1))):
        p = base.init(gen)
        omega = torch.tensor([wi], device=device).expand(ZOO_ROWS, 2)
        xs = base.sample(p, omega, gen)
        lp = base.log_prob(p, xs, omega)
        require(tuple(xs.shape) == (ZOO_ROWS, 2) and tuple(lp.shape) == (ZOO_ROWS,), f"{label}: shapes")
        require(bool(torch.isfinite(xs).all() and torch.isfinite(lp).all()), f"{label}: non-finite sample or log_prob")
        if label == "mixture_spherical":
            require(bool((xs[:, 1].abs() <= math.pi + 1e-5).all()), f"{label}: phi outside [-pi, pi]")
        out[label] = {"rows": ZOO_ROWS, "mean_log_prob": float(lp.mean())}
    log(f"  zoo on the card: {out}")
    return out


def differentiable_phase(d: str, scenes: dict, trees: dict, device, name: str) -> dict:
    """Phase 11: the differentiable transport, the pixel loss, the reference
    importer and `--weights reference`, `--allow-substitute`, the zoo."""
    return {"transport": diff_transport(trees, device, name), "pixel": diff_pixel(trees["neural-disk"], device),
            "reference": reference_phase(d, scenes, device), "substitute": substitute_phase(d, scenes, device),
            "zoo": zoo_phase(device)}


# ---------------------------------------------------------- multi-device ----

# Phase 12: the sharded render and data-parallel training on the one card.
# NCCL refuses two ranks on one device, so (a) forms a one-rank NCCL group
# in this process, and (b) runs two ranks over gloo (whose all_reduce,
# broadcast and barrier take CUDA tensors), started by torch.multiprocessing
# with a file init; both ranks land on cuda:0. The two share the card: their
# ms are not a scaling figure.
MD_WORLD = 2
MD_SEED = SEED + 30
MD_TIMEOUT = 600  # s for the two ranks together
# (scene, mode, spp): the renders of phase 8's scenes and weights, 512 x 512, depth 12
MD_RENDERS = (("measured", "gt", TABLE_SPP), ("measured", "neural-disk", TABLE_SPP),
              ("measured", "neural-spherical", TABLE_SPP), ("table", "neural-sphere K3", RENDER_CHUNK))
# cli/train.py at the CLI's widths and batches from phase 10's MCMC caches:
# (material, cache directory of phase 10, iterations pretrain / diffusion / rectify)
MD_TRAIN = {"disk": ("synthetic_rgb", "train_disk", (5, 5, 2)),
            "sphere_full": ("table:20", "train_sphere", (3, 3, 1))}
# the sharded film against the one-process film (JAX tests/test_render_sharded.py:33-34)
MD_RTOL, MD_ATOL = 1e-4, 1e-5


class CollectiveCount:
    """Counts every torch.distributed all_reduce, broadcast and barrier
    while it is entered."""

    NAMES = ("all_reduce", "broadcast", "barrier")

    def __enter__(self):
        self.n, self.orig = dict.fromkeys(self.NAMES, 0), {k: getattr(dist, k) for k in self.NAMES}
        for k, fn in self.orig.items():
            def wrapped(*a, _k=k, _fn=fn, **kw):
                self.n[_k] += 1
                return _fn(*a, **kw)
            setattr(dist, k, wrapped)
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(dist, k, fn)


def md_matball(d: str, scene: str, mode: str, weights: dict, device):
    """The matball of a phase-12 render, built as `cli/render.py` builds it
    (the neural-sphere with K3's reverse-Euler pdf as phase 8 builds it)."""
    if mode == "neural-sphere K3":
        tree = load_pytree(weights["neural-sphere"])[0]
        nb = make_neural_bsdf("sphere_full", SPH_CFG, tree["rectified"], tree["base"],
                              sampler_cfg=SamplerConfig(pdf_exact=False), device=device)
        return neural_matball_sphere(nb, BSDF_MATERIALS[TABLE[0]], TABLE[1])
    ball = ({"filename": "synthetic_rgb", "idx": -1} if scene == "measured"
            else {"filename": "", "idx": TABLE[0], "albedo": TABLE[1]})
    args = render_cli.build_parser().parse_args(["--scene", "", "--bsdf-dir", d, "--mode", mode, "--checkpoint",
                                                 weights.get(mode, "")])
    return render_cli.build_matball(ball, args, device)


def md_render(scene, mb, spp: int, device, mesh=None) -> dict:
    """A warm-up, then the timed render with the launches and collectives
    counted around it, then one pass at depth 1 for the film's sample count."""
    render(scene, mb, seed=MD_SEED, spp=RENDER_CHUNK, spp_chunk=RENDER_CHUNK, max_depth=2, device=device, mesh=mesh)

    def timed():
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(scene, mb, seed=MD_SEED, spp=spp, spp_chunk=RENDER_CHUNK, max_depth=RENDER_DEPTH,
                     device=device, mesh=mesh)
        return img, time.perf_counter() - t0

    with CollectiveCount() as cc:
        (img, dt), counts = counted(timed)
    _, cnt, _ = render_pass(scene, (mb,), root_generator(MD_SEED, device), spp_chunk=RENDER_CHUNK, max_depth=1,
                            mesh=mesh)
    passes = spp // RENDER_CHUNK
    return {"img": img, "seconds": dt, "ms_a_pass": 1e3 * dt / passes, "passes": passes, "launches": counts,
            "collectives": cc.n, "cnt": cnt.cpu().numpy()}


def md_train_argv(d: str, domain: str) -> list:
    material, _, (pre, dif, rect) = MD_TRAIN[domain]
    argv = train_argv(d, os.path.join(d, f"md_{domain}"), domain, material, rect)
    for flag, v in (("--iters-pretrain", pre), ("--iters-diffusion", dif)):
        argv[argv.index(flag) + 1] = str(v)
    return argv


# what a rank takes from the parent's module (the sizes, which a rehearsal on
# the CPU cuts in the parent before it starts the ranks)
MD_PLAN = ("RENDER_RES", "RENDER_CHUNK", "RENDER_DEPTH", "TABLE_SPP", "MD_SEED", "MD_RENDERS", "MD_TRAIN")


def md_rank(rank: int, d: str, scenes: dict, weights: dict, plan: dict) -> None:
    """One of phase 12's two gloo ranks: the renders and the training runs
    with this rank's launches and collectives; writes md_rank<r>.json and
    its images and trained parameters under d. `plan`: the parent's
    MD_PLAN values, its device type and each domain's cli/train.py argv."""
    globals().update(plan["sizes"])
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase 2 sets them in the parent
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", init_method=f"file://{os.path.join(d, 'md_gloo')}", world_size=MD_WORLD,
                     rank=rank, device_type=plan["device_type"])
    mesh = make_mesh(device_type=plan["device_type"])
    device = mesh.device
    loaded = {k: load_scene(p, device=device, width=RENDER_RES, height=RENDER_RES) for k, p in scenes.items()}
    out = {"rank": rank, "device": str(device), "renders": {}, "train": {}}
    for scene, mode, spp in MD_RENDERS:
        r = md_render(loaded[scene], md_matball(d, scene, mode, weights, device), spp, device, mesh)
        np.save(os.path.join(d, f"md_rank{rank}_{scene}_{mode}.npy"), r.pop("img"))
        np.save(os.path.join(d, f"md_rank{rank}_{scene}_{mode}_cnt.npy"), r.pop("cnt"))
        out["renders"][f"{scene} {mode}"] = r
    for domain in MD_TRAIN:
        buf = io.StringIO()
        with CollectiveCount() as cc, contextlib.redirect_stdout(Tee(sys.stdout, buf) if rank == 0 else buf):
            (params, stats), counts = counted(lambda: train_cli.main(plan["train_argv"][domain]))
        save_pytree(os.path.join(d, f"md_rank{rank}_{domain}.npz"), params)
        out["train"][domain] = {"collectives": cc.n, "launches": counts, "log": buf.getvalue(),
                                "ms_median": {k: v["ms_median"] for k, v in stats.items() if k != "mcmc"},
                                "iters": {k: v["iters"] for k, v in stats.items() if k != "mcmc"}}
    with open(os.path.join(d, f"md_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def md_spawn(d: str, scenes: dict, weights: dict, device_type: str) -> list:
    """Both ranks, joined within MD_TIMEOUT; a rank that fails or hangs
    fails the phase (the others are ended)."""
    plan = {"sizes": {k: globals()[k] for k in MD_PLAN}, "device_type": device_type,
            "train_argv": {domain: md_train_argv(d, domain) for domain in MD_TRAIN}}
    ctx = torch.multiprocessing.spawn(md_rank, args=(d, scenes, weights, plan), nprocs=MD_WORLD, join=False)
    deadline = time.time() + MD_TIMEOUT
    try:
        while not ctx.join(timeout=2):
            require(time.time() < deadline, f"phase 12: the ranks did not finish within {MD_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [json.load(open(os.path.join(d, f"md_rank{r}.json"))) for r in range(MD_WORLD)]


def md_nccl_one_rank(d: str, scene, weights: dict, device) -> dict:
    """(a) A one-rank NCCL group in this process (gloo in a rehearsal on
    the CPU): the neural-disk render with the mesh is bit-equal to the
    render without, and the film's all_reduce runs once a pass (and the
    truncated flag's once a render)."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    init_distributed(backend=backend, init_method=f"file://{os.path.join(d, 'md_nccl')}", world_size=1, rank=0,
                     device_type=device.type)
    try:
        mesh = make_mesh(device_type=device.type)
        mb = md_matball(d, "measured", "neural-disk", weights, device)
        alone = md_render(scene, mb, TABLE_SPP, device)
        meshed = md_render(scene, mb, TABLE_SPP, device, mesh)
    finally:
        dist.destroy_process_group()
    out = {"backend": backend, "world_size": 1, "spp": TABLE_SPP, "bit_equal": bool(np.array_equal(alone["img"],
                                                                                                  meshed["img"])),
           "max_abs": float(np.abs(alone["img"] - meshed["img"]).max()), "collectives": meshed["collectives"],
           "ms_a_pass": {"mesh": meshed["ms_a_pass"], "no_mesh": alone["ms_a_pass"]},
           "launches": meshed["launches"]}
    log(f"  (a) NCCL, one rank: {out}")
    require(out["bit_equal"], f"NCCL world size 1: the render differs from mesh=None by {out['max_abs']}")
    require(np.array_equal(alone["cnt"], meshed["cnt"]), "NCCL world size 1: the sample counts differ")
    require(meshed["collectives"] == {"all_reduce": meshed["passes"] + 1, "broadcast": 0, "barrier": 0},
            f"NCCL world size 1: collectives {meshed['collectives']}, expected one all_reduce a pass and one more")
    require(alone["launches"] == meshed["launches"], "NCCL world size 1: the launches differ")
    return out


def md_compare(label: str, ranks: list, d: str, one: dict) -> dict:
    """(b) A render of both ranks against the one-process render."""
    scene, mode = label.split(" ", 1)
    imgs = [np.load(os.path.join(d, f"md_rank{r}_{scene}_{mode}.npy")) for r in range(MD_WORLD)]
    cnts = [np.load(os.path.join(d, f"md_rank{r}_{scene}_{mode}_cnt.npy")) for r in range(MD_WORLD)]
    ref = one["img"]
    close = np.isclose(imgs[0], ref, rtol=MD_RTOL, atol=MD_ATOL)
    bad = np.argwhere(~close.all(-1))
    out = {"ranks_bit_equal": all(np.array_equal(imgs[0], im) for im in imgs[1:]),
           "counts_equal": all(np.array_equal(c, one["cnt"]) for c in cnts),
           "pixels_off": int(len(bad)), "first_pixels_off": bad[:5].tolist(),
           "max_abs": float(np.abs(imgs[0] - ref).max()),
           "bit_equal_to_one_process": bool(np.array_equal(imgs[0], ref)),
           "ms_a_pass": {"two_ranks": [r["renders"][label]["ms_a_pass"] for r in ranks],
                         "one_process": one["ms_a_pass"]},
           "collectives_a_rank": [r["renders"][label]["collectives"] for r in ranks],
           # the film's all_reduce a pass (the one more is the truncated flag's, once a render)
           "film_all_reduce_a_pass": [(r["renders"][label]["collectives"]["all_reduce"] - 1)
                                      / r["renders"][label]["passes"] for r in ranks],
           "launches_a_rank": [r["renders"][label]["launches"] for r in ranks],
           "rows_a_launch": RENDER_RES * RENDER_RES * RENDER_CHUNK // MD_WORLD}
    log(f"  (b) {label}: {out}")
    require(out["ranks_bit_equal"], f"{label}: the two ranks' images differ")
    require(out["counts_equal"], f"{label}: the sample counts differ from one process")
    require(out["pixels_off"] == 0, f"{label}: {out['pixels_off']} pixels differ from one process beyond rtol "
            f"{MD_RTOL} / atol {MD_ATOL}, first {out['first_pixels_off']}, max abs {out['max_abs']}")
    for r in ranks:
        rr = r["renders"][label]
        require(rr["collectives"] == {"all_reduce": rr["passes"] + 1, "broadcast": 0, "barrier": 0},
                f"{label}, rank {r['rank']}: collectives {rr['collectives']}")
        check_render(f"{label} rank {r['rank']}", imgs[0], rr["seconds"], rr["passes"] * RENDER_CHUNK,
                     rr["launches"], mode=mode)
    return out


def md_check_training(d: str, ranks: list, training: dict) -> dict:
    """(b) Both ranks' trained trees bit-equal and finite, every logged loss
    finite, one all_reduce a step and two broadcasts a stage (rank 0's step,
    then its state), K3 once a rectify iteration on each rank; then one process resumes their stage
    files and takes one more rectify step."""
    out = {}
    for domain, (material, _, (pre, dif, rect)) in MD_TRAIN.items():
        flat = [dict(np.load(os.path.join(d, f"md_rank{r}_{domain}.npz"))) for r in range(MD_WORLD)]
        equal = all(flat[0].keys() == f.keys() and all(np.array_equal(flat[0][k], f[k]) for k in f) for f in flat[1:])
        finite = all(np.isfinite(v).all() for v in flat[0].values())
        losses = [float(v) for *_, v in LOSS_LINE.findall(ranks[0]["train"][domain]["log"])]
        stages_n = 4 if domain != "disk" else 3
        steps = pre + dif * (stages_n - 2) + rect
        r_out = {"ranks_bit_equal": equal, "finite": finite, "losses_logged": len(losses),
                 "collectives_a_rank": [r["train"][domain]["collectives"] for r in ranks],
                 "all_reduce_a_step": [r["train"][domain]["collectives"]["all_reduce"] / steps for r in ranks],
                 "k3_launches_a_rank": [r["train"][domain]["launches"]["fused_transport"] for r in ranks],
                 "ms_an_iteration": {"two_ranks": [r["train"][domain]["ms_median"] for r in ranks],
                                     "one_process": {k: v["ms_median"] for k, v in training[domain]["stages"].items()}},
                 "rows_a_rank": {"pretrain": 9_800_000 // MD_WORLD, "diffusion": 4_900_000 // MD_WORLD,
                                 "rectify": N_RECTIFY // MD_WORLD}}
        require(equal and finite, f"{domain}: the ranks' trained parameters differ or are not finite")
        require(losses and all(math.isfinite(v) for v in losses), f"{domain}: a logged loss is not finite")
        require(not ranks[1]["train"][domain]["log"].strip(), f"{domain}: rank 1 logged")
        for r in ranks:
            require(r["train"][domain]["collectives"] == {"all_reduce": steps, "broadcast": 2 * stages_n,
                                                          "barrier": 1},
                    f"{domain}, rank {r['rank']}: collectives {r['train'][domain]['collectives']}, expected "
                    f"{steps} all_reduce, {2 * stages_n} broadcast, 1 barrier")
            require(r["train"][domain]["launches"]["fused_transport"] == rect,
                    f"{domain}, rank {r['rank']}: K3 launched {r['train'][domain]['launches']['fused_transport']} "
                    f"times in {rect} rectify iterations")
        argv = md_train_argv(d, domain)
        argv[argv.index("--iters-rectify") + 1] = str(rect + 1)
        resume = train_run(argv)
        for stage, at in (("pretrain", pre), ("diffusion-simpler", dif), ("rectify", rect)):
            require(f"[{stage}/{domain}] resumed at step {at}" in resume["log"],
                    f"{domain}: one process did not resume {stage} at {at}")
        require(resume["stats"][f"rectify/{domain}"]["iters"] == 1, f"{domain}: the resume took more than one step")
        r_out["resumed_in_one_process"] = True
        log(f"  (b) training {domain}: {r_out}")
        out[domain] = r_out
    return out


def multidevice_phase(d: str, scenes: dict, weights: dict, training: dict, device) -> dict:
    """Phase 12: (a) NCCL at world size 1; (b) two gloo ranks on the card
    against one process: the renders, then training from phase 10's
    datasets and one process resuming its stage files. (c), K1 and K4 at a
    row offset, is in phase 4."""
    loaded = {k: load_scene(p, device=device, width=RENDER_RES, height=RENDER_RES) for k, p in scenes.items()}
    out = {"nccl_one_rank": md_nccl_one_rank(d, loaded["measured"], weights, device)}
    one = {f"{scene} {mode}": md_render(loaded[scene], md_matball(d, scene, mode, weights, device), spp, device)
           for scene, mode, spp in MD_RENDERS}
    for domain, (_, cache_dir, _) in MD_TRAIN.items():
        os.makedirs(os.path.join(d, f"md_{domain}"), exist_ok=True)
        for f in os.listdir(os.path.join(d, cache_dir)):
            if f.startswith("mcmc_"):
                shutil.copy(os.path.join(d, cache_dir, f), os.path.join(d, f"md_{domain}", f))
    del loaded
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = md_spawn(d, scenes, weights, device.type)
    out["spawn_seconds"] = time.time() - t0
    out["ranks"] = [{"rank": r["rank"], "device": r["device"]} for r in ranks]
    out["renders"] = {label: md_compare(label, ranks, d, one[label]) for label in one}
    out["training"] = md_check_training(d, ranks, training)
    return out


# ------------------------------------------------------------- the rest ----

# Phase 13: the modules of the last slice. (c) renders the procedural scene
# with the anisotropic material (4 phi_i x 8 theta_i) at 512 x 512, depth 12,
# 16 spp in each of phase 8's measured modes, and the isotropic one beside it
# at the same spp.
REST_N = 1 << 20
REST_SPP = 16
REST_MODES = ("gt", "neural-disk", "neural-spherical")
TOL_WARP_U, TOL_WARP_PDF, MIN_SHARE = 2e-5, 2e-4, 0.995  # tests/test_torch_measured*.py's laws and share
# (e) online_sampling at the CLI-like size: 1,024 omega_i x 129^2 vertices, 1,024 draws each; then 8 of its
# rows at 2^18 draws (64 x 64 bins, the pmf summed 2 x 2), and 64 rows through the native twin at 4,096 draws
# a row, binned 8 x 8 (the pmf summed 16 x 16): finer bins would put the KL's statistical floor, (bins - 1) /
# 2n, near the gate on their own
TAB_N_WI, TAB_RES, TAB_PER_WI = 1024, 128, 1024
TAB_ROWS, TAB_ROW_N, TAB_BINS, TOL_KL_TAB = 8, 1 << 18, 64, 0.01
NATIVE_ROWS, NATIVE_N, NATIVE_BINS, TOL_KL_NATIVE = 64, 4096, 8, 0.02
TOL_KL_MCMC = 0.05
BVH_T_RTOL, TIE_BARY = 1e-5, 1e-6  # tests/test_torch_bvh8.py's T_RTOL; a shared-edge tie's barycentric
TOL_KS = 5e-3


def event_timed(fn):
    """fn's result and its ms between two CUDA events, one call."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def share_close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float) -> float:
    """The share of rows whose every element has |a - b| <= atol + rtol |b|."""
    close = (a - b).abs() <= atol + rtol * b.abs()
    return float(close.reshape(a.shape[0], -1).all(-1).float().mean())


def rest_warps(ab, ib, device) -> dict:
    """(a) The anisotropic vndf and luminance warps at REST_N queries
    (theta in [0, 1.4], phi over the whole circle): invert(sample(u)) == u
    and eval == the sample's pdf on >= MIN_SHARE of rows; ms a call beside
    the isotropic warps of the same size."""
    gen = root_generator(SEED + 40, device)
    u = torch.rand((REST_N, 2), generator=gen, device=device) * (1 - 2e-6) + 1e-6
    theta = torch.rand(REST_N, generator=gen, device=device) * 1.4
    phi = (torch.rand(REST_N, generator=gen, device=device) * 2 - 1) * math.pi
    out = {}
    for w in ("vndf", "luminance"):
        wa, wiso = getattr(ab, w), getattr(ib, w)
        pos, pdf = warp_sample(wa, u, theta, phi)
        uu, _ = warp_invert(wa, pos, theta, phi)
        ev = warp_eval(wa, pos, theta, phi)
        r = {"slices": list(wa.density.shape), "res": list(wa.res),
             "invert_share": share_close(uu, u, 0.0, TOL_WARP_U), "invert_max_abs": max_abs(uu, u),
             "eval_share": share_close(ev, pdf, TOL_WARP_PDF, 0.0), "eval_max_rel": max_rel(ev, pdf),
             "finite": bool(torch.isfinite(pos).all() and torch.isfinite(pdf).all())}
        for kind, wp, ph in (("aniso", wa, phi), ("iso", wiso, None)):
            r[f"ms_sample_{kind}"] = cuda_ms(lambda: warp_sample(wp, u, theta, ph))
            r[f"ms_invert_{kind}"] = cuda_ms(lambda: warp_invert(wp, pos, theta, ph))
            r[f"ms_eval_{kind}"] = cuda_ms(lambda: warp_eval(wp, pos, theta, ph))
        log(f"  (a) {w} warp at n = {REST_N}: {r}")
        require(r["finite"] and r["invert_share"] >= MIN_SHARE and r["eval_share"] >= MIN_SHARE,
                f"aniso {w} warp: invert(sample(u)) or eval off the sample: {r}")
        out[w] = r
    return out


def repeat_phi(tf: dict, pp: int) -> dict:
    """An anisotropic tensor dict whose pp phi_i slices are copies of the
    isotropic one's."""
    out = dict(tf, phi_i=np.linspace(-math.pi, math.pi, pp).astype(np.float32))
    for k in ("vndf", "luminance", "rgb"):
        out[k] = np.repeat(tf[k], pp, axis=0)
    return out


def rest_brdf(ab, ib, device) -> dict:
    """(b) The anisotropic BRDF at REST_N directions: pdf_brdf at the
    sampled directions against the sample's pdf; identical phi slices
    against the isotropic BRDF (tests/test_measured_aniso.py's gates); eval
    responding to phi_i when the slices differ."""
    gen = root_generator(SEED + 41, device)
    wi = hemisphere(torch.rand((REST_N, 2), generator=gen, device=device))
    wo_r = hemisphere(torch.rand((REST_N, 2), generator=gen, device=device))
    u = torch.rand((REST_N, 2), generator=gen, device=device) * (1 - 2e-4) + 1e-4
    wo, pdf = sample_brdf(ab, u, wi)
    ok = pdf > 1e-5
    q = pdf_brdf(ab, wi, wo)
    out = {"valid_share": float(ok.float().mean()), "gap": gap_stats(q[ok], pdf[ok]),
           "finite": bool(torch.isfinite(wo).all() and torch.isfinite(pdf).all() and torch.isfinite(q).all())}
    same = measured_from_tensors(repeat_phi(synthetic_measured_tensors(), ANISO_PHI), device=device)
    f_s, f_i = eval_brdf(same, wi, wo_r), eval_brdf(ib, wi, wo_r)
    p_s, p_i = pdf_brdf(same, wi, wo_r), pdf_brdf(ib, wi, wo_r)
    wo_s, sp_s = sample_brdf(same, u, wi)
    _, sp_i = sample_brdf(ib, u, wi)
    valid = sp_i > 0
    rel = (sp_s[valid] / sp_i[valid] - 1).abs()
    out["identical_slices"] = {
        "eval_close": bool(torch.allclose(f_s, f_i, rtol=2e-4, atol=1e-8)), "eval_max_rel": max_rel(f_s, f_i),
        "pdf_close": bool(torch.allclose(p_s, p_i, rtol=2e-4, atol=1e-8)), "pdf_max_rel": max_rel(p_s, p_i),
        "valid_equal": bool(torch.equal(sp_s > 0, valid)), "sampled_pdf_p99": float(rel.quantile(0.99)),
        "sampled_pdf_max": float(rel.max())}
    n = 4096
    ct = torch.full((n,), 0.7, device=device)
    st = torch.sqrt(1 - ct * ct)

    def at(a):
        return torch.stack([st * torch.cos(a), st * torch.sin(a), ct], -1)

    a1 = torch.linspace(-math.pi, math.pi, n, device=device)
    e1, e2 = eval_brdf(ab, at(a1), at(a1 + 2.8)), eval_brdf(ab, at(a1 + 2.0), at(a1 + 4.8))
    out["phi_response_max_rel"] = float(((e1 - e2).abs() / e1.clamp(min=1e-30)).max())
    log(f"  (b) aniso BRDF at n = {REST_N}: {out}")
    idn = out["identical_slices"]
    require(out["finite"] and out["valid_share"] > 0.5 and out["gap"]["median"] < TOL_CONTRACT_MEDIAN,
            f"aniso BRDF: pdf_brdf at the samples disagrees with the sample pdf: {out}")
    require(idn["eval_close"] and idn["pdf_close"] and idn["valid_equal"] and idn["sampled_pdf_p99"] < 2e-4
            and idn["sampled_pdf_max"] < 0.05, f"aniso BRDF with identical slices differs from the isotropic: {idn}")
    require(out["phi_response_max_rel"] > 1e-2, "aniso BRDF: eval does not respond to phi_i")
    return out


def rest_renders(d: str, scenes: dict, weights: dict, images: dict, device) -> dict:
    """(c) The anisotropic matball through `cli/render.py` in each measured
    mode at REST_SPP, the launches a bounce gated as phase 8's; the
    isotropic material at the same spp beside it; a depth-1 bounce
    breakdown of neural-disk, aniso against iso."""

    def cli(material, mode, spp, depth):
        return render_cli.main(["--scene", scenes["measured"], "--bsdf-dir", d, "--material", material,
                                "--mode", mode, "--checkpoint", weights.get(mode, ""), "--spp", str(spp),
                                "--spp-chunk", str(RENDER_CHUNK), "--max-depth", str(depth),
                                "--width", str(RENDER_RES), "--height", str(RENDER_RES), "--device", str(device),
                                "--out", os.path.join(d, f"rest_{material}_{mode}")])

    for mode in REST_MODES:  # warm-up
        cli(ANISO_MATERIAL, mode, RENDER_CHUNK, 2)
    out = {"renders": {}, "launches": {}}
    for mode in REST_MODES:
        for material in (ANISO_MATERIAL, "synthetic_rgb"):
            (img, dt), counts = counted(lambda: cli(material, mode, REST_SPP, RENDER_DEPTH))
            kind = "aniso" if material == ANISO_MATERIAL else "iso"
            r = check_render(f"{kind} {mode}", img, dt, REST_SPP, counts, mode=mode)
            out["renders"][f"{kind} {mode}"] = {k: r[k] for k in ("seconds", "mray_samples_per_s", "mean_rgb")}
            if kind == "aniso":
                out["launches"][mode] = counts
                aniso_img = img
            else:
                out["renders"][f"aniso {mode}"]["differs_from_iso"] = float(np.abs(aniso_img - img).mean())
        out["renders"][f"iso {mode} phase 8 ({RENDER_SPP} spp)"] = {
            "mray_samples_per_s": images[f"measured {mode}"][1]["mray_samples_per_s"]}
    scene = load_scene(scenes["measured"], device=device)
    args = render_cli.build_parser().parse_args(["--scene", "", "--bsdf-dir", d, "--mode", "neural-disk",
                                                 "--checkpoint", weights["neural-disk"]])
    out["bounce_neural_disk"] = {
        kind: bounce_breakdown(f"neural-disk {kind}", scene,
                               render_cli.build_matball({"filename": mat, "idx": -1}, args, device), device)
        for kind, mat in (("aniso", ANISO_MATERIAL), ("iso", "synthetic_rgb"))}
    log(f"  (c) renders: {out['renders']}")
    return out


def rest_mcmc(d: str, device) -> dict:
    """(d) The ensemble on the anisotropic material's disk target of
    `cli/train.py` at omega_i = MCMC_CHECK_WI (phi_i = 0, between two phi
    slices), 64 walkers x 2,500 sweeps (500 burn-in), against the pdf grid
    of each cell's integral."""
    pdf_fn = train_cli.make_target_pdf(train_cli.build_parser().parse_args(
        ["--material", ANISO_MATERIAL, "--bsdf-dir", d]), device)
    wi = torch.tensor(MCMC_CHECK_WI, device=device)

    def density(x):
        inside = (x ** 2).sum(-1) < 1.0
        f = pdf_fn(wi.expand(x.shape[0], 2), torch.where(inside[:, None], x, 0.0))
        return torch.where(inside, torch.clamp(f, min=0.0), 0.0)

    def log_prob(x):
        f = density(x)
        return torch.where(f > 0, torch.log(torch.clamp(f, min=1e-38)), -math.inf)

    g = root_generator(SEED + 42, device)
    x0 = -0.5 * wi + 0.05 * torch.randn((64, 2), generator=g, device=device)
    chain, acc = ensemble_mcmc(g, log_prob, x0, nsteps=2500, burn_in=500)
    lo, hi = (-1.0, -1.0), (1.0, 1.0)
    hist = histogram_grid_2d(chain.reshape(-1, 2).cpu().numpy(), lo, hi, MCMC_CHECK_BINS)
    out = {"walkers": 64, "sweeps": 2500, "burn_in": 500, "acceptance": float(acc),
           "kl": kl_divergence_grid(hist, pdf_grid_2d(density, lo, hi, MCMC_CHECK_BINS, device=device, sub=8))}
    log(f"  (d) MCMC on the aniso target: {out}")
    require(bool(torch.isfinite(chain).all()) and 0.1 < out["acceptance"] < 0.9, f"aniso MCMC: {out}")
    require(out["kl"] < TOL_KL_MCMC, f"aniso MCMC: KL {out['kl']} against the pdf grid")
    return out


def pool(pmf: np.ndarray, bins: int) -> np.ndarray:
    """(B, R, R) cell masses summed to (B, bins, bins): exact, R / bins cells a side."""
    b, r, _ = pmf.shape
    return pmf.reshape(b, bins, r // bins, bins, r // bins).sum(axis=(2, 4))


def rest_tabulated(d: str, device) -> dict:
    """(e) `online_sampling` of the anisotropic disk target; 8 of its rows
    resampled at 2^18 draws against their pmf; 64 rows through the native
    host twin against theirs."""
    pdf_fn = train_cli.make_target_pdf(train_cli.build_parser().parse_args(
        ["--material", ANISO_MATERIAL, "--bsdf-dir", d]), device)
    gen = root_generator(SEED + 43, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (omega_i, omega_o), peak = peak_gib(lambda: online_sampling(pdf_fn, "disk", gen, TAB_N_WI, TAB_PER_WI,
                                                                res=TAB_RES))
    ms = 1e3 * (time.perf_counter() - t0)
    # omega_i is stratified over the square [-1, 1]^2: the rows outside the
    # unit disk have a zero target and no pmf; the gates read the others
    wi_rows = omega_i[::TAB_PER_WI]
    inside = (wi_rows ** 2).sum(-1) < 1.0
    o = omega_o.reshape(TAB_N_WI, TAB_PER_WI, 2)[inside]
    out = {"n_wi": TAB_N_WI, "res": TAB_RES, "per_wi": TAB_PER_WI, "target_evaluations": TAB_N_WI * (TAB_RES + 1) ** 2,
           "ms": ms, "peak_gib": peak, "shape": list(omega_o.shape), "rows_inside_disk": int(inside.sum()),
           "finite": bool(torch.isfinite(omega_o).all()), "in_disk": bool(((o ** 2).sum(-1)  # a cell whose centre is in overshoots by half its diagonal at most
                             <= (math.sqrt(0.995) + math.sqrt(2.0) / TAB_RES) ** 2 + 1e-6).all())}
    wi_rows = wi_rows[inside]
    grid = domain_grid("disk", TAB_RES, device=device)

    def table(rows):
        n = rows.shape[0]
        vals = pdf_fn(rows.repeat_interleave(grid.shape[0], dim=0), grid.repeat(n, 1))
        return build_tabulated(vals.reshape(n, TAB_RES + 1, TAB_RES + 1), "disk")

    tab = table(wi_rows[:TAB_ROWS])
    x = sample_tabulated(root_generator(SEED + 44, device), tab, TAB_ROW_N).cpu().numpy()
    want = pool(tab.pmf.cpu().double().numpy(), TAB_BINS)
    kls = [kl_divergence_grid(np.histogram2d(x[b, :, 0], x[b, :, 1], bins=TAB_BINS, range=[[-1, 1], [-1, 1]])[0],
                              want[b]) for b in range(TAB_ROWS)]
    out["kl_rows"] = kls
    tab = table(wi_rows[:NATIVE_ROWS])
    pmf = tab.pmf.cpu().numpy()
    samplewi_native(pmf[:1], 8, seed=SEED)  # builds the library
    t0 = time.perf_counter()
    xn = samplewi_native(pmf, NATIVE_N, seed=SEED + 45)
    out["native_ms"], out["native_rows"] = 1e3 * (time.perf_counter() - t0), xn.shape[0]
    joint = np.stack([np.histogram2d(xn[b, :, 0], xn[b, :, 1], bins=NATIVE_BINS, range=[[-1, 1], [-1, 1]])[0]
                      for b in range(xn.shape[0])])
    out["native_kl"] = kl_divergence_grid(joint, pool(pmf.astype(np.float64), NATIVE_BINS))
    log(f"  (e) tabulated sampling: {out}")
    require(out["finite"] and out["in_disk"] and out["shape"] == [TAB_N_WI * TAB_PER_WI, 2],
            f"online_sampling: {out}")
    require(max(kls) < TOL_KL_TAB, f"tabulated rows: KL {kls} against their pmf")
    require(out["native_kl"] < TOL_KL_NATIVE, f"samplewi_native: KL {out['native_kl']} against the pmf")
    return out


def rest_binary_bvh(d: str, scenes: dict, accel8, cam, device) -> dict:
    """(f) The binary BVH's walk against K5 on the four ray sets of phase 6
    at N_MAIN rays: hit (or occluded) flags equal and the closest hit's t
    within BVH_T_RTOL, except on shared-edge ties (a barycentric < TIE_BARY in either hit);
    its ms beside K5's."""
    t0 = time.time()
    bvh = load_scene(scenes["measured"], device=device, wide=False).accel
    out = {"nodes": int(bvh.count.shape[0]), "depth": bvh.max_depth, "build_and_load_s": time.time() - t0}
    for name, (ro, rd, t_max, act, any_hit) in k5_ray_sets(accel8, cam, device, N_MAIN, SEED + 5).items():
        hb, ms = event_timed(lambda: binary_intersect(bvh, ro, rd, t_max, active=act, any_hit=any_hit))
        hk = t8.intersect8(accel8, ro, rd, t_max, active=act, any_hit=any_hit)
        thr = t_max * 0.9999 if any_hit else torch.full_like(t_max, 1e29)
        fb, fk = act & (hb.t < thr), act & (hk.t < thr)
        both = fb & fk
        # an any-hit walk stops at the first hit it accepts, which need not be
        # the nearest: only its flag is compared
        t_off = both & ((hb.t - hk.t).abs() > BVH_T_RTOL * hk.t.abs()) & (not any_hit)
        differ = (fb != fk) | t_off

        def tie(h):
            return torch.minimum(torch.minimum(h.u, h.v), 1 - h.u - h.v) < TIE_BARY

        untied = differ & ~((fb & tie(hb)) | (fk & tie(hk)))
        ms_k5 = cuda_ms(lambda: t8.intersect8(accel8, ro, rd, t_max, active=act, any_hit=any_hit))
        r = {"rays": N_MAIN, "hits": int(fb.sum()), "differ": int(differ.sum()), "shared_edge_ties": int(
            (differ & ~untied).sum()), "untied": int(untied.sum()), "truncated": bool(hb.truncated),
             "ms_binary": ms, "ms_k5": ms_k5}
        log(f"  (f) binary BVH {name:12s} vs K5: {r}")
        require(r["untied"] == 0 and not r["truncated"], f"binary BVH {name}: {r}")
        out[name] = r
    out["ms_binary_four_sets"] = sum(out[k]["ms_binary"] for k in ("primary", "secondary", "shadow_env",
                                                                    "shadow_point"))
    out["ms_k5_four_sets"] = sum(out[k]["ms_k5"] for k in ("primary", "secondary", "shadow_env", "shadow_point"))
    return out


def rest_distributions(device) -> dict:
    """(g) REST_N draws on the card of each `distributions1d` family: the
    empirical CDF against the cumulative pdf (trapezoid on 2^16 + 1 points)."""

    def custom_pdf(x):
        return torch.exp(-((x - 0.3) ** 2) / 0.02) + 0.5 * torch.exp(-((x + 0.4) ** 2) / 0.05) + 0.05

    fams = {"uniform": (dists.Uniform(-1.0, 2.0), (-1.0, 2.0)), "gaussian": (dists.Gaussian(0.3, 0.7), (-5.3, 5.9)),
            "truncated_gaussian": (dists.TruncatedGaussian(0.2, 0.5, -0.5, 1.0), (-0.5, 1.0)),
            "beta": (dists.Beta(2.5, 1.5), (0.0, 1.0)), "straight_line": (dists.StraightLine(), (0.0, 1.0)),
            "custom": (dists.CustomDistribution(custom_pdf, -1.0, 1.0), (-1.0, 1.0))}
    two = dists.TwoDCombination(dists.Gaussian(0.0, 0.4), dists.Beta(2.0, 3.0))
    gen = root_generator(SEED + 46, device)
    out = {}

    def ks(x, dist, lo, hi):
        grid = torch.linspace(lo, hi, (1 << 16) + 1, device=device, dtype=torch.float64)
        p = dist.pdf(grid.float()).double()
        cdf = torch.cat([torch.zeros(1, device=device, dtype=torch.float64),
                         torch.cumsum(0.5 * (p[1:] + p[:-1]) * (grid[1:] - grid[:-1]), 0)])
        ecdf = torch.searchsorted(torch.sort(x).values.double().contiguous(), grid, right=True) / x.shape[0]
        return float((ecdf - cdf / cdf[-1]).abs().max())

    for name, (dist, (lo, hi)) in fams.items():
        x = dist.sample(gen, REST_N)
        require(x.device.type == device.type and bool(torch.isfinite(x).all()), f"{name}: draws")
        out[name] = ks(x, dist, lo, hi)
    xy = two.sample(gen, REST_N)
    out["two_d_x"], out["two_d_y"] = ks(xy[:, 0], two.dist_x, -2.4, 2.4), ks(xy[:, 1], two.dist_y, 0.0, 1.0)
    log(f"  (g) KS of {REST_N} draws on the card: {out}")
    require(max(out.values()) < TOL_KS, f"distributions: KS {out}")
    return out


def rest_phase(d: str, scenes: dict, weights: dict, images: dict, scene, device) -> dict:
    """Phase 13: the anisotropic warps and BRDF, the renders of the
    anisotropic matball, MCMC on its target, tabulated sampling and its
    native twin, the binary BVH against K5, the 1-D distributions."""
    ab = load_measured(os.path.join(d, ANISO_MATERIAL + ".bsdf"), device=device)
    ib = load_measured(os.path.join(d, "synthetic_rgb.bsdf"), device=device)
    out = {}
    for key, fn in (("warps", lambda: rest_warps(ab, ib, device)), ("brdf", lambda: rest_brdf(ab, ib, device)),
                    ("renders", lambda: rest_renders(d, scenes, weights, images, device)),
                    ("mcmc", lambda: rest_mcmc(d, device)), ("tabulated", lambda: rest_tabulated(d, device)),
                    ("binary_bvh", lambda: rest_binary_bvh(d, scenes, scene.accel, scene.camera, device)),
                    ("distributions", lambda: rest_distributions(device))):
        t0 = time.time()
        out[key] = fn()
        out[key]["seconds"] = time.time() - t0
    return out


# ----------------------------------------- trained quality, array scenes ----

# Phase 14a: the procedural measured BRDF's disk sampler trained far enough
# to be judged (`cli/train.py` at the CLI's widths and batches), its draws
# through K1 and its pdf through K2 against the oracle: the density the MCMC
# samples (`make_domain_log_prob` on the measured BRDF), at four incident
# radii on the disk. Both pdf grids average each cell over QUALITY_SUB^2
# points, so a sharp lobe's cell integral, not its centre value, faces the
# histogram (the JAX package's benchmarks/quality_eval.py
# `kl_hist_vs_oracle` takes centre values). The dataset is the CLI's MCMC at
# QUALITY_MCMC_STEPS sweeps (10M rows, half the CLI's default), not phase
# 10's 1M-row cache (2,000 sweeps), which is too small for the gate of half
# the base density's KL: trained on it at 2,000 / 4,000 / 500 iterations on
# an H100, the sampler's mean KL against the oracle was 0.62 of the base's.
QUALITY_MCMC_STEPS = 20_000
QUALITY_ITERS = {"pretrain": 2000, "diffusion": 5000, "rectify": 500}
QUALITY_RADII = (0.1, 0.4, 0.7, 0.9)
QUALITY_DRAWS = 1 << 20
QUALITY_BINS, QUALITY_SUB = 48, 4
QUALITY_SPP = 64  # the renders against GT: phase 8's measured scene, 512 x 512, depth 12
QUALITY_RENDER_SEED = 2  # the neural renders' seed; GT seed A is phase 8's (seed 0), seed B is 1
GATE_KL_ORACLE, GATE_KL_CONSISTENCY, GATE_RADIANCE = 0.5, 0.05, (0.9, 1.1)


def quality_argv(d: str) -> list:
    argv = train_argv(d, os.path.join(d, "quality_disk"), "disk", "synthetic_rgb", QUALITY_ITERS["rectify"])
    for flag, v in (("--mcmc-steps", QUALITY_MCMC_STEPS), ("--iters-pretrain", QUALITY_ITERS["pretrain"]),
                    ("--iters-diffusion", QUALITY_ITERS["diffusion"]), ("--save-every", 1000), ("--log-every", 100)):
        argv[argv.index(flag) + 1] = str(v)
    return argv


def sampler_kls(tree: dict, oracle_log_prob, device, base_only: bool = False) -> dict:
    """At each radius of QUALITY_RADII (omega_i = (r, 0)): QUALITY_DRAWS
    draws of the rectified sampler (K1, T = 4) or of the base density alone,
    KL(histogram of the draws inside the disk || oracle grid) and KL(histogram
    of all draws || the learned pdf grid: K2, exact, or the base's own pdf)."""
    cfg = ModelConfig()
    nb = make_neural_bsdf("disk", cfg, tree["rectified"], tree["base"], device=device)
    base = get_base("disk")
    lo, hi, grid = (-1.0, -1.0), (1.0, 1.0), dict(bins=QUALITY_BINS, device=device, sub=QUALITY_SUB)
    rows = []
    for i, r in enumerate(QUALITY_RADII):
        wi = torch.tensor([[r, 0.0]], device=device)
        wi_n = wi.expand(QUALITY_DRAWS, 2)

        def at(p):
            return wi.expand(p.shape[0], 2)

        if base_only:
            x = base.sample(nb.base_params, wi_n, root_generator(SEED + 60 + i, device))

            def learned(p):
                return torch.exp(base.log_prob(nb.base_params, p, at(p)))
        else:
            x, _, _ = fo.fused_sample_pdf_disk(nb.packed, encode_condition(wi_n, cfg), nb.T, seed=SEED + 60 + i)

            def learned(p):
                return fo.fused_pdf_disk(nb.packed, p.contiguous(), encode_condition(at(p), cfg), nb.T, exact=True)[0]

        x = x.cpu().numpy()
        inside = (x.astype(np.float64) ** 2).sum(-1) < 1.0
        row = {"r": r, "inside": float(inside.mean()), "finite": bool(np.isfinite(x).all()),
               "kl_oracle": sampler_vs_pdf_kl(x[inside], lambda p: torch.exp(oracle_log_prob(
                   torch.cat([at(p), p], -1), 0.0, 1.0)), lo, hi, **grid),
               "kl_consistency": sampler_vs_pdf_kl(x, learned, lo, hi, **grid)}
        rows.append(row)
    out = {"rows": rows, "mean_kl_oracle": float(np.mean([r["kl_oracle"] for r in rows])),
           "max_kl_consistency": max(r["kl_consistency"] for r in rows)}
    require(all(r["finite"] and math.isfinite(r["kl_oracle"]) and math.isfinite(r["kl_consistency"]) for r in rows),
            f"quality: a draw or a KL is not finite: {rows}")
    return out


def quality_phase(d: str, scenes: dict, images: dict, device) -> dict:
    """Phase 14a: train, then the KLs of the trained sampler, its base
    density and phase 10's 30-iteration checkpoint, and neural-disk renders
    of both checkpoints against GT."""
    out_dir = os.path.join(d, "quality_disk")
    t0 = time.time()
    run = train_run(quality_argv(d))
    out = {"train_seconds": time.time() - t0, "iterations": QUALITY_ITERS, "mcmc_sweeps": QUALITY_MCMC_STEPS,
           "run": check_run(run, "disk", QUALITY_ITERS["rectify"], resumed=False)}
    out["ms_an_iteration"] = {k: v["ms_median"] for k, v in out["run"]["stages"].items()}
    log(f"  trained {QUALITY_ITERS} in {out['train_seconds']:.1f} s: ms an iteration {out['ms_an_iteration']}")

    args = train_cli.build_parser().parse_args(["--material", "synthetic_rgb", "--bsdf-dir", d])
    oracle_log_prob = make_domain_log_prob(train_cli.make_target_pdf(args, device), "disk")
    ckpts = {"trained": os.path.join(out_dir, "final.npz"), "phase 10": os.path.join(d, "train_disk", "final.npz")}
    trees = {k: load_pytree(p)[0] for k, p in ckpts.items()}
    with torch.no_grad():
        kls, counts = counted(lambda: sampler_kls(trees["trained"], oracle_log_prob, device))
        out["kl"] = {"trained": kls, "base (trained pretrain)": sampler_kls(trees["trained"], oracle_log_prob, device,
                                                                            base_only=True),
                     "phase 10": sampler_kls(trees["phase 10"], oracle_log_prob, device)}
    out["kl_launches"] = counts
    log(f"  KLs (bins {QUALITY_BINS}, sub {QUALITY_SUB}, {QUALITY_DRAWS} draws a radius): "
        f"{json.dumps(out['kl'])}; launches {counts}")
    require(counts["fused_sample_pdf_disk"] == len(QUALITY_RADII) and counts["fused_pdf_disk"] == len(QUALITY_RADII),
            f"quality: K1 and K2 launched {counts}, expected {len(QUALITY_RADII)} each")

    def cli(mode, seed, checkpoint, label):
        return render_cli.main(["--scene", scenes["measured"], "--bsdf-dir", d, "--material", "synthetic_rgb",
                                "--mode", mode, "--checkpoint", checkpoint, "--spp", str(QUALITY_SPP),
                                "--spp-chunk", str(RENDER_CHUNK), "--max-depth", str(RENDER_DEPTH), "--width",
                                str(RENDER_RES), "--height", str(RENDER_RES), "--seed", str(seed), "--device",
                                str(device), "--out", os.path.join(d, f"quality_{label}")])

    gt_a = images["measured gt"][0]
    imgs, out["renders"] = {"gt seed A": gt_a}, {}
    for label, mode, seed, ckpt in (("trained", "neural-disk", QUALITY_RENDER_SEED, ckpts["trained"]),
                                    ("phase 10", "neural-disk", QUALITY_RENDER_SEED, ckpts["phase 10"]),
                                    ("gt seed B", "gt", 1, "")):
        (img, dt), counts = counted(lambda: cli(mode, seed, ckpt, label.replace(" ", "_")))
        r = check_render(f"quality {label}", img, dt, QUALITY_SPP, counts, mode=mode)
        imgs[label] = img
        out["renders"][label] = {k: r[k] for k in ("seconds", "mray_samples_per_s", "launches")}
    for label, img in imgs.items():
        out["renders"].setdefault(label, {}).update(
            relmse_vs_gt_a=relative_mse(img, gt_a), mse_vs_gt_a=image_mse(img, gt_a),
            mean_radiance_ratio=float(img.mean() / gt_a.mean()))
    log(f"  renders against GT seed A ({QUALITY_SPP} spp): {json.dumps(out['renders'])}")

    trained, base, p10 = out["kl"]["trained"], out["kl"]["base (trained pretrain)"], out["kl"]["phase 10"]
    rend = out["renders"]
    require(trained["mean_kl_oracle"] < GATE_KL_ORACLE and trained["mean_kl_oracle"] <= 0.5 * base["mean_kl_oracle"],
            f"quality: mean KL against the oracle {trained['mean_kl_oracle']:.4f} (base {base['mean_kl_oracle']:.4f})")
    require(trained["max_kl_consistency"] < GATE_KL_CONSISTENCY,
            f"quality: consistency KL {trained['max_kl_consistency']:.4f} at some radius")
    require(rend["trained"]["relmse_vs_gt_a"] < rend["phase 10"]["relmse_vs_gt_a"],
            f"quality: the trained render's relMSE {rend['trained']['relmse_vs_gt_a']:.5f} is not below phase 10's "
            f"{rend['phase 10']['relmse_vs_gt_a']:.5f}")
    ratio = rend["trained"]["mean_radiance_ratio"]
    require(GATE_RADIANCE[0] <= ratio <= GATE_RADIANCE[1], f"quality: mean radiance ratio {ratio:.4f} to GT")
    require(all(math.isfinite(v) for r in rend.values() for v in (r["relmse_vs_gt_a"], r["mse_vs_gt_a"])),
            "quality: an image error is not finite")
    return out


# Phase 14b: the 12-ball array scenes (`write_array_scene`) at 512 x 512,
# depth 12: the measured array under the sky envmap (gt, and neural-disk
# with 12 reference-layout checkpoints: K1 12 times a bounce), the table
# array under one point light (gt, and neural-sphere with K3's
# reverse-Euler pdf through render(): K4 12 and K3 24 times a bounce). The
# neural-sphere with the exact pdf is left out on purpose: its plain exact
# spherical pdf costs ~0.35 s a ball a bounce at 2^20 rays, minutes for 12
# balls over 48 bounces. Each matball runs on the whole wavefront; the
# share of the rays that hit each ball is printed at depths 0 and 1.
ARRAY_SPP = 16
ARRAY_WANT = {"measured gt": {"traverse8": 2}, "measured neural-disk": {"traverse8": 2, "fused_sample_pdf_disk": 12},
              "table gt": {"traverse8": 3},
              "table neural-sphere K3": {"traverse8": 3, "fused_sample_pdf_spherical": 12, "fused_transport": 24}}


def write_disk_references(root: str, materials, seed: int) -> None:
    """The reference's disk checkpoint directory of each material, as
    `write_reference_checkpoints` writes REF_MATERIAL's."""
    rng = np.random.default_rng(seed)
    disk = [25] + [32] * 3 + [2]
    for m in materials:
        os.makedirs(os.path.join(root, f"{m}_disk"), exist_ok=True)
        for stage, dims in (("pretrain", [14, 16, 4]), ("diffusion", disk), ("rectify", disk)):
            pre = stage == "pretrain"
            torch.save(reference_state_dict(rng, dims, bias=pre, scale=1.0 if pre else 0.5),
                       os.path.join(root, f"{m}_disk", f"brdf_{stage}_network{m}.pth"))


def ball_shares(scene, mbs: tuple, device) -> dict:
    """The share of the 2^20-ray wavefront (512 x 512 x 4) whose closest hit
    is each ball, for the camera rays (depth 0) and after one bounce (depth
    1), and the share of rays alive."""
    n = RENDER_RES * RENDER_RES * RENDER_CHUNK
    gen = root_generator(SEED + 70, device)
    state = _init_wavefront(scene.camera.vectors.to(device), torch.rand((n, 2), generator=gen, device=device)
                            * (1 - 1e-7) + 1e-7, width=RENDER_RES, height=RENDER_RES, spp_chunk=RENDER_CHUNK)
    out = {}
    for depth in (0, 1):
        if depth:
            state, _ = _bounce_body(scene.accel, scene.envmap, scene.lights, state, draw_bounce(gen, n, mbs), 0,
                                    matball=mbs)
        alive = state[5]
        h = _isect(scene.accel, state[0], state[1], alive)
        mat = torch.where(alive & (h.t < 1e29), scene.accel.attr_rows[h.prim, 15].to(torch.int64), -1)
        counts = torch.bincount(mat + 1, minlength=MAT_BALL + len(mbs) + 1).cpu().numpy()
        out[f"depth {depth}"] = {"alive": float(alive.float().mean()),
                                 "balls": [float(c) / n for c in counts[MAT_BALL + 1:MAT_BALL + 1 + len(mbs)]]}
    return out


def array_phase(d: str, weights: dict, device) -> dict:
    """Phase 14b: the two 12-ball arrays' renders, launches, per-ball pixels
    and ray shares."""
    film = dict(width=RENDER_RES, height=RENDER_RES, spp=ARRAY_SPP, max_depth=RENDER_DEPTH)
    paths = {"measured": write_array_scene(os.path.join(d, "array_measured"), kind="measured", **film),
             "table": write_array_scene(os.path.join(d, "array_table"), kind="table", point_light=ARRAY_LIGHT, **film)}
    ref_root = os.path.join(d, "array_checkpoints")
    write_disk_references(ref_root, ARRAY_MATERIALS, SEED + 71)
    scenes = {k: load_scene(p, device=device) for k, p in paths.items()}
    out = {k: {"triangles": int(sc.accel.attr_rows.shape[0]), "balls": len(sc.desc.matballs),
               "point_lights": int(sc.lights.shape[0]), "packed_bytes": int(sc.accel.packed_bytes)}
           for k, sc in scenes.items()}
    log(f"  array scenes: {out}")

    def cli(scene, mode, spp, depth, extra=()):
        return render_cli.main(["--scene", paths[scene], "--bsdf-dir", os.path.dirname(paths[scene]), "--mode", mode,
                                *extra, "--spp", str(spp), "--spp-chunk", str(RENDER_CHUNK), "--max-depth",
                                str(depth), "--width", str(RENDER_RES), "--height", str(RENDER_RES), "--device",
                                str(device), "--out", os.path.join(d, f"array_{scene}_{mode}")])

    tree = load_pytree(weights["neural-sphere"])[0]
    nb = make_neural_bsdf("sphere_full", SPH_CFG, tree["rectified"], tree["base"],
                          sampler_cfg=SamplerConfig(pdf_exact=False), device=device)
    table_k3 = tuple(neural_matball_sphere(nb, BSDF_MATERIALS[idx], albedo) for idx, albedo in ARRAY_TABLE)

    def k3_render(spp, depth):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(scenes["table"], table_k3, seed=0, spp=spp, spp_chunk=RENDER_CHUNK, max_depth=depth,
                     device=device)
        return img, time.perf_counter() - t0

    ref = ["--weights", "reference", "--reference-ckpts", ref_root]
    runs = {"measured gt": lambda spp, depth: cli("measured", "gt", spp, depth),
            "measured neural-disk": lambda spp, depth: cli("measured", "neural-disk", spp, depth, ref),
            "table gt": lambda spp, depth: cli("table", "gt", spp, depth),
            "table neural-sphere K3": k3_render}
    out["renders"] = {}
    for label, fn in runs.items():
        fn(RENDER_CHUNK, 2)  # warm-up
        (img, dt), counts = counted(lambda: fn(ARRAY_SPP, RENDER_DEPTH))
        r = check_render(f"array {label}", img, dt, ARRAY_SPP, counts, want=ARRAY_WANT[label])
        scene = scenes[label.split(" ", 1)[0]]
        mats = pixel_materials(scene.accel, scene.camera, device)
        ball_rgb = [img[mats == MAT_BALL + i].mean(0) if (mats == MAT_BALL + i).any() else np.zeros(3)
                    for i in range(len(scene.desc.matballs))]
        r["ball_pixels"] = [int((mats == MAT_BALL + i).sum()) for i in range(len(ball_rgb))]
        r["ball_mean_rgb_min"] = float(min(b.max() for b in ball_rgb))
        require(min(r["ball_pixels"]) > 0 and r["ball_mean_rgb_min"] > 0,
                f"array {label}: a ball is not seen or is black: {r['ball_pixels']}, {ball_rgb}")
        out["renders"][label] = {k: r[k] for k in ("seconds", "mray_samples_per_s", "bounces", "launches",
                                                   "mean_rgb", "ball_pixels", "ball_mean_rgb_min")}
    measured_gt = render_cli.build_parser().parse_args(["--scene", "", "--bsdf-dir", os.path.dirname(paths["measured"]),
                                                        "--mode", "gt"])
    table_gt = render_cli.build_parser().parse_args(["--scene", "", "--mode", "gt"])
    out["ray_shares"] = {
        "measured": ball_shares(scenes["measured"], tuple(render_cli.build_matball(b, measured_gt, device)
                                                          for b in scenes["measured"].desc.matballs), device),
        "table": ball_shares(scenes["table"], tuple(render_cli.build_matball(b, table_gt, device)
                                                    for b in scenes["table"].desc.matballs), device)}
    log(f"  array renders: {json.dumps(out['renders'])}")
    log(f"  per-ball ray shares of the 2^20-ray wavefront: {json.dumps(out['ray_shares'])}")
    return out


KERNELS = {
    "fused_sample_pdf_disk": ("K1 disk sample+pdf",
                              "bsdf_diffusion_sampling_tpu/ops/fused_ode.py:579 _fused_sample_pdf_kernel "
                              "(pallas_call :684)"),
    "fused_pdf_disk": ("K2 disk pdf query",
                       "bsdf_diffusion_sampling_tpu/ops/fused_ode.py:943 _fused_pdf_kernel (pallas_call :1017)"),
    "traverse8": ("K5 BVH traversal, closest and any hit",
                  "bsdf_diffusion_sampling_tpu/render/traverse8.py:251 _traverse_kernel + :63 _turn "
                  "(pallas_call :383)"),
    "fused_sample_pdf_spherical": ("K4 spherical sample+pdf",
                                   "bsdf_diffusion_sampling_tpu/ops/fused_ode.py:1389 _fused_sample_pdf_sph_kernel "
                                   "(pallas_call :1534)"),
    "fused_transport": ("K3 generic transport",
                        "bsdf_diffusion_sampling_tpu/ops/fused_ode.py:181 _fused_ode_kernel (pallas_call :373)"),
}
SOURCES = {"fused_sample_pdf_disk": "fused_ode.cu", "fused_pdf_disk": "fused_ode.cu",
           "traverse8": "traverse8.cu", "fused_sample_pdf_spherical": "fused_sph.cu",
           "fused_transport": "fused_transport.cu"}


def count_opcodes(sass: str, opcodes: tuple = ("HMMA", "HGMMA")) -> dict:
    """{kernel (mangled name): {opcode: count}} in `cuobjdump -sass` output:
    the lines of each `Function :` section whose instruction is one of
    `opcodes`."""
    pats = {op: re.compile(rf"\b{op}\b") for op in opcodes}
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn is not None:
            for op, pat in pats.items():
                counts[fn][op] += bool(pat.search(line))
    return counts


def ptxas_spills(log_text: str) -> dict:
    """{kernel (mangled name): (stack bytes, spill store bytes, spill load
    bytes)} from the `-Xptxas -v` lines of a build log."""
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn is not None:
            out[fn] = tuple(int(v) for v in m.groups())
            fn = None
    return out


def hmma_a_layer(fn: str) -> int:
    """One hidden layer's mma.sync of the kernel with mangled name `fn`:
    K3's `transport_kernel<H, NL, XE, JAC, NW>` takes 3 x S x (H / 8)^2 (S = 3
    with the det, 1 without); K2's `pdf_disk_kernel<H, NL, EXACT>` 48 + 144
    exact (a primal and a tangent evaluation), HMMA_A_LAYER reverse; K1 and
    K4 take HMMA_A_LAYER."""
    m = re.search(r"transport_kernelILi(\d+)ELi\d+ELi\d+ELb([01])E", fn)
    if m is not None:
        return 3 * (3 if m.group(2) == "1" else 1) * (int(m.group(1)) // 8) ** 2
    m = re.search(r"\dpdf_disk_kernelILi\d+ELi\d+ELb([01])E", fn)  # K2; K1's name is sample_pdf_disk_kernel
    if m is not None and m.group(1) == "1":
        return HMMA_A_LAYER // 3 + HMMA_A_LAYER
    return HMMA_A_LAYER


def tc_functions(src: str, names) -> list:
    """The tensor-core kernels of library `src` among the mangled function
    names `names`: those that hold the library's marker, each once."""
    return [fn for fn in names if TC_KERNELS[src][0] in fn]


def tensor_core_evidence(libs: dict) -> None:
    """Phase 1: the tensor-core instructions (HMMA, HGMMA) of each CUDA
    library's kernels, counted in its SASS; each K1, K2, K4 and K3
    instantiation must hold a nonzero whole multiple of its hidden layer's
    count (`hmma_a_layer`), and ptxas must report no spill stores for them."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    for src, path in sorted(libs.items()):
        if not src.endswith(".cu"):
            continue
        counts = count_opcodes(subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                                              check=True).stdout)
        for fn, c in counts.items():
            log(f"    sass {src}: {fn}: {c}")
        if src not in TC_KERNELS:
            continue
        marker, count = TC_KERNELS[src]
        tc = {fn: counts[fn] for fn in tc_functions(src, counts)}
        spills = ptxas_spills(path.with_suffix(".log").read_text())
        spills = {fn: spills[fn] for fn in tc_functions(src, spills)}
        require(len(tc) == count and all(c["HMMA"] > 0 and c["HMMA"] % hmma_a_layer(fn) == 0
                                         for fn, c in tc.items()),
                f"{src}: a {marker} instantiation lacks the 3xTF32 products of whole hidden layers: "
                f"{ {fn: (c['HMMA'], hmma_a_layer(fn)) for fn, c in tc.items()} }")
        require(len(spills) == count and all(v[1] == 0 for v in spills.values()),
                f"{src}: ptxas reports spill stores for {marker}: {spills}")


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
    libs = cuda_build.build(sorted(set(SOURCES.values())))
    log(f"[1] build: {time.time() - t0:.1f} s")
    for src, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    ptxas {src}: {line.strip()}")
    tensor_core_evidence(libs)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[2] {smi}")
    for inst, r in {**fo.kernel_resources(), **t8.kernel_resources()}.items():
        log(f"    resources {inst}: {r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("    TF32 off for matmul and cuDNN: the plain versions run in full fp32")
    name = torch.cuda.get_device_name(0)

    with tempfile.TemporaryDirectory() as d:
        return run(args, d, device, smi, name, t_start)


def run(args, d: str, device, smi: str, name: str, t_start: float) -> int:
    weights = {"neural-disk": os.path.join(d, "disk.npz")}
    for mode in ("neural-spherical", "neural-sphere"):
        weights[mode] = os.path.join(d, "spherical.npz")
    trees = {"neural-disk": init_weights(SEED, ModelConfig()),
             "neural-spherical": init_weights(SEED + 100, SPH_CFG, TEACHER_CFG)}
    back = {}
    for mode, tree in trees.items():
        save_pytree(weights[mode], tree, step=1)
        back[mode], step = load_pytree(weights[mode])
        require(step == 1 and all(np.array_equal(a["w"], b["w"]) for a, b in zip(tree["rectified"],
                                                                                  back[mode]["rectified"])),
                "checkpoint round trip changed the weights")
    nb = make_neural_bsdf("disk", ModelConfig(), back["neural-disk"]["rectified"], back["neural-disk"]["base"],
                          sampler_cfg=SamplerConfig(), device=device)
    sph = back["neural-spherical"]
    nb_sph = {route: make_neural_bsdf("sphere_full", SPH_CFG, sph["rectified"], sph["base"],
                                      sampler_cfg=SamplerConfig(pdf_exact=route == "exact"), device=device)
              for route in ("exact", "reverse")}
    teacher = fo.prepack_velocity(params_from_jax(sph["teacher"], device))
    for b in (nb, nb_sph["exact"]):
        log(f"[3] weights {b.domain}: velocity {[tuple(l['w'].shape) for l in b.v_params]}, T={b.T}, "
            f"pdf_exact={b.pdf_exact}, newton_iters={b.pdf_newton_iters}")
    log(f"    spherical teacher: {teacher.layers} x {teacher.hidden}")

    t0 = time.time()
    errs = {}
    for n in (N_MAIN, N_RAGGED):
        found = check_kernels(nb, device, n)
        found["fused_sample_pdf_spherical"] = check_spherical(nb_sph["exact"], device, n)
        for k, e in found.items():
            errs[k] = {m: max(v, errs.get(k, {}).get(m, 0.0)) for m, v in e.items()}
    cases = k3_cases(nb, nb_sph["exact"], teacher, device)
    errs["fused_transport"] = check_transport(cases)
    for k, e in check_strong(device).items():
        errs[k] = {**errs[k], **{m: max(v, errs[k][m]) for m, v in e.items()}}
    log(f"[4] K1, K2, K4 vs plain at n = {N_MAIN} and {N_RAGGED}, K3 in {len(cases)} instantiations: ok {errs} "
        f"({time.time() - t0:.1f} s)")

    t0 = time.time()
    scenes = {"measured": write_scene(d, width=RENDER_RES, height=RENDER_RES, spp=RENDER_SPP, max_depth=RENDER_DEPTH,
                                      anisotropic=True),
              "table": write_scene(d, width=RENDER_RES, height=RENDER_RES, spp=TABLE_SPP, max_depth=RENDER_DEPTH,
                                   table=TABLE)}
    scene = load_scene(scenes["measured"], device=device)
    acc = scene.accel
    log(f"[5] scene: {acc.attr_rows.shape[0]} triangles, {acc.n_rows} table rows "
        f"({acc.table.numel() * 4 / 1e6:.2f} MB), 8-wide depth {acc.max_depth}; K5's packed layout "
        f"{acc.packed_bytes} bytes ({acc.nodes.shape[0]} node records of 256 bytes, {acc.tris.shape[0]} "
        f"triangles of 48); envmap {tuple(scene.envmap.data.shape)}; table twin {scenes['table']} "
        f"({time.time() - t0:.1f} s)")
    t0 = time.time()
    k5 = [r for n in (N_MAIN, N_RAGGED) for r in check_traverse(scene.accel, scene.camera, device, n).values()]
    log(f"[6] K5 vs plain walker at n = {N_MAIN} and {N_RAGGED}: ok ({time.time() - t0:.1f} s)")
    if args.check_only:
        return 0

    t0 = time.time()
    counts = main_path(nb, device)
    sph_sampler_path(nb_sph, device)
    log(f"[7] sampler paths: {BOUNCES} disk bounces and one spherical bounce a pdf route of neural_sample -> "
        f"neural_pdf at N={N_MAIN}: ok ({time.time() - t0:.1f} s)")

    t0 = time.time()
    images = render_main_path(d, scenes, weights, back["neural-spherical"], device)
    check_images(images, pixel_materials(scene.accel, scene.camera, device))
    log(f"[8] render paths: cli/render.py at {RENDER_RES}x{RENDER_RES}, depth {RENDER_DEPTH}: "
        f"{', '.join(images)}: ok ({time.time() - t0:.1f} s)")

    t0 = time.time()
    tm = times(nb, device, name)
    tm.update(times_spherical(nb_sph["exact"], cases, device, name))
    tm["traverse8"] = time_traverse(scene.accel, scene.camera, device, name)
    table = {"filename": "", "idx": TABLE[0], "albedo": TABLE[1]}
    scene_t = load_scene(scenes["table"], device=device)
    for mode, ball, sc in (("neural-disk", {"filename": "synthetic_rgb", "idx": -1}, scene),
                           ("neural-sphere", table, scene_t)):
        args = render_cli.build_parser().parse_args(["--scene", "", "--bsdf-dir", d, "--mode", mode,
                                                     "--checkpoint", weights[mode]])
        mb = render_cli.build_matball(ball, args, device)
        bounce_breakdown(mode, sc, mb, device)
    # the neural-sphere bounce with K3's reverse-Euler pdf, whose two pdf
    # stages each launch K3 once
    mb = neural_matball_sphere(nb_sph["reverse"], BSDF_MATERIALS[TABLE[0]], TABLE[1])
    _, k3_counts = counted(lambda: bounce_breakdown("neural-sphere K3", scene_t, mb, device))
    require(k3_counts["fused_transport"] == 2 * (RUNS + 3),
            f"neural-sphere K3 bounce breakdown: K3 launched {k3_counts['fused_transport']} times in {RUNS + 3} "
            "bounces, expected 2 a bounce")
    log(f"[9] times: ({time.time() - t0:.1f} s)")

    t0 = time.time()
    training = training_phase(d, scenes, device, name)
    log(f"[10] training: disk and sphere_full through cli/train.py at full batch, the resume, the trained "
        f"checkpoint's render: ok ({time.time() - t0:.1f} s)")

    t0 = time.time()
    diff = differentiable_phase(d, scenes, trees, device, name)
    log(f"[11] gradients through K3 at n = {N_MAIN}, the pixel loss at {PIXEL_RES}x{PIXEL_RES}x{PIXEL_S}, the "
        f"reference importer and --weights reference, --allow-substitute, the zoo: ok ({time.time() - t0:.1f} s)")

    t0 = time.time()
    multidevice = multidevice_phase(d, scenes, weights, training, device)
    multidevice["seconds"] = time.time() - t0
    log(f"[12] multi-device: NCCL at world size 1 bit-equal to no mesh; {MD_WORLD} gloo ranks on the card: "
        f"{len(MD_RENDERS)} renders against one process, disk and sphere_full training, the one-process resume: "
        f"ok ({multidevice['seconds']:.1f} s)")

    t0 = time.time()
    rest = rest_phase(d, scenes, weights, images, scene, device)
    rest["seconds"] = time.time() - t0
    log(f"[13] the rest: aniso warps and BRDF at n = {REST_N}, aniso renders at {REST_SPP} spp, MCMC on the aniso "
        f"target, tabulated sampling and its native twin, the binary BVH against K5, the distributions: ok "
        f"({rest['seconds']:.1f} s)")

    t0 = time.time()
    quality = quality_phase(d, scenes, images, device)
    quality["seconds"] = time.time() - t0
    kl, rend = quality["kl"], quality["renders"]
    log(f"[14a] the trained disk sampler ({QUALITY_ITERS}): mean KL against the oracle "
        f"{kl['trained']['mean_kl_oracle']:.4f} (base {kl['base (trained pretrain)']['mean_kl_oracle']:.4f}, "
        f"phase 10 {kl['phase 10']['mean_kl_oracle']:.4f}), consistency at most "
        f"{kl['trained']['max_kl_consistency']:.4f}, relMSE to GT {rend['trained']['relmse_vs_gt_a']:.5f} "
        f"(phase 10 {rend['phase 10']['relmse_vs_gt_a']:.5f}, GT seed B {rend['gt seed B']['relmse_vs_gt_a']:.5f}): "
        f"ok ({quality['seconds']:.1f} s)")

    t0 = time.time()
    arrays = array_phase(d, weights, device)
    arrays["seconds"] = time.time() - t0
    rates = ", ".join(f"{k} {v['mray_samples_per_s']:.3f}" for k, v in arrays["renders"].items())
    log(f"[14b] the 12-ball arrays at {RENDER_RES}x{RENDER_RES}, {ARRAY_SPP} spp, depth {RENDER_DEPTH}: {rates} "
        f"Mray-samples/s: ok ({arrays['seconds']:.1f} s)")

    # launches: each kernel from the run of the path that runs it, counts
    # set to 0 just before: K1 from the neural-disk render, K4 from the
    # neural-spherical render, K3 from the neural-sphere render with the
    # reverse-Euler pdf, K5 from the neural-disk render, K2 from the disk
    # sampler path. max_abs_err: x and x0 (K1, K2, K4), x (K3), t (K5);
    # max_rel_err: the pdf (K1, K2, K4), the det (K3), t (K5).
    render_counts = {label: r["launches"] for label, (_, r) in images.items()}
    launches = {"fused_sample_pdf_disk": render_counts["measured neural-disk"]["fused_sample_pdf_disk"],
                "fused_pdf_disk": counts["fused_pdf_disk"],
                "traverse8": render_counts["measured neural-disk"]["traverse8"],
                "fused_sample_pdf_spherical":
                    render_counts["measured neural-spherical"]["fused_sample_pdf_spherical"],
                "fused_transport": render_counts["table neural-sphere K3"]["fused_transport"]}
    errs["traverse8"] = {"max_abs_err": max(r["t_abs_max"] for r in k5),
                         "max_rel_err": max(r["t_rel_max"] for r in k5)}
    rows = []
    for k, (label, replaces) in KERNELS.items():
        r = tm[k]
        rows.append({"name": k, "label": label, "route": "cuda",
                     "source": f"bsdf_diffusion_sampling_tpu_torch/csrc/{SOURCES[k]}", "replaces": replaces,
                     "launches": launches[k], "max_abs_err": errs[k]["max_abs_err"],
                     "max_rel_err": errs[k]["max_rel_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                     "bound_tf32_ms": r["bound_tf32_ms"], "precision": PRECISION.get(k, "fp32"),
                     "n": N_MAIN, "n_ragged": N_RAGGED})
        if "reverse" in r:  # K2: the row's times are the exact query's (the sampler's default)
            rows[-1]["reverse"] = {m: r["reverse"][m] for m in ("ms", "plain_ms", "bound_ms", "bound_tf32_ms")}
        if k == "fused_transport":  # the training path: one launch a rectify iteration, at 2^22 rows, T = 256
            rows[-1]["launches_training"] = {run: training[run]["k3_launches"]
                                             for run in ("disk", "disk_resume", "sphere_full")}
            rows[-1]["rectify"] = {label: {m: r[m] for m in ("ms", "plain_ms", "bound_ms", "bound_by", "n")}
                                   for label, r in training["k3_rectify"].items()}
            # the differentiable transport: K3 in each forward, none in the backward
            rows[-1]["diff"] = {**diff["transport"], "pixel_loss": {
                m: diff["pixel"][m] for m in ("rows", "launches", "value_and_grad_ms")}}
        if k == "fused_sample_pdf_disk":  # the render of the freshly trained disk checkpoint
            rows[-1]["launches_trained_render"] = training["render"]["launches"][k]
        # the renders with the reference's weights (phase 11)
        rows[-1]["launches_reference_render"] = {label: r["launches"][k] for label, r in
                                                 diff["reference"].items() if "launches" in r}
        # a launch on a shard of the wavefront (phase 12): K1 and K4 draw at the shard's first global row
        rows[-1]["row_offset"] = ({"row0": list(ROW0S), "max_abs_vs_whole_launch": errs[k]["row_offset_max_abs"],
                                   "equal": errs[k]["row_offset_max_abs"] == 0.0}
                                  if "row_offset_max_abs" in errs[k] else
                                  "none: the kernel draws no random numbers and its rows are independent")
        rows[-1]["launches_a_rank_2_ranks"] = {label: [r[k] for r in c["launches_a_rank"]]
                                               for label, c in multidevice["renders"].items()}
        # the anisotropic material's renders (phase 13), each a 16-spp, depth-12 render
        rows[-1]["launches_aniso_render"] = {mode: c[k] for mode, c in rest["renders"]["launches"].items()}
        # the trained sampler's KLs (phase 14a: K1 draws, K2's pdf grid) and the 12-ball arrays (phase 14b)
        rows[-1]["launches_trained_quality"] = quality["kl_launches"][k]
        rows[-1]["launches_array_render"] = {label: r["launches"][k] for label, r in arrays["renders"].items()}
    require(all(r["launches"] > 0 for r in rows), "a kernel of the main path was never launched")
    log(f"[15] total {time.time() - t_start:.1f} s")
    print(json.dumps({"training": {"card": smi, **training}}))
    print(json.dumps({"differentiable": {"card": smi, **diff}}))
    print(json.dumps({"multidevice": {"card": smi, **multidevice}}))
    print(json.dumps({"rest": {"card": smi, **rest}}))
    print(json.dumps({"quality": {"card": smi, **quality}}))
    print(json.dumps({"arrays": {"card": smi, **arrays}}))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
