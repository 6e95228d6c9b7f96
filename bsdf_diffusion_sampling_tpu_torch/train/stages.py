"""The three training stages: pretrain, flow matching, rectify
(counterpart of the JAX package's `train/stages.py`).

- A step draws its minibatch on the device from the device-resident
  dataset, takes the loss's gradient by autograd and applies
  `torch.optim.Adam` at optax's defaults (betas 0.9 / 0.999, eps 1e-8
  outside the square root, the same bias correction). The MLPs' large
  products are `torch.matmul`, as the JAX package leaves them to XLA.
- Rectify's pairs: stratified omega_i, each repeated n_per_wi times, base
  draws pushed through the teacher's T-step Euler transport. On CUDA
  tensors that transport is K3 (`ops/fused_ode.py::fused_transport_packed`
  without the det, `csrc/fused_transport.cu`); on the CPU, its plain
  version.
- Every iteration draws from its own generator, `iter_generator(stage
  seed, iteration)`, and a stage file holds (params, Adam state, step), so
  a stage killed mid-run resumes at its last save and ends bit-identical
  to an uninterrupted run. The JAX package seeds its diffusion stages with
  Python's `hash(tag)`, which is salted per process; the port's stage
  seeds are `prng.fold_in`'s keyed hash, stable across processes.
- Data parallelism over a `mesh` (`parallel/mesh.py`): parameters and
  Adam state are replicated (broadcast from rank 0 at the start of each
  stage and after a resume); each global batch is padded to a multiple of
  the mesh size, as the JAX package's `_pad` does, and each rank draws its
  share of the rows from its own stream (`host_fold` of the stage seed):
  minibatch indices, base draws, rectify's omega_i, x0 and alphas. The
  gradient tree and the loss go into one flat buffer and one `all_reduce`
  a step averages them (the JAX package's single psum), so every rank
  applies the same Adam update. Only rank 0 writes stage files and logs.
  A step is a `Step`: `draw` makes this rank's rows of a global batch,
  `update` takes the loss on them and the update, so the same explicit
  global batch can go through one process and through the mesh. Without
  a mesh, or on a mesh of one process without a group, every path is the
  one-process path.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.core import prng, trace
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, TrainConfig
from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.geometry.sampling import stratified_disk, stratified_hemisphere_angles
from bsdf_diffusion_sampling_tpu_torch.models.base_density import get_base
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition, velocity_init
from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import PackedWeights, fused_transport_packed, prepack_velocity
from bsdf_diffusion_sampling_tpu_torch.parallel.distributed import host_fold
from bsdf_diffusion_sampling_tpu_torch.parallel.mesh import Mesh, all_reduce_, pad_to_multiple, replicate
from bsdf_diffusion_sampling_tpu_torch.train import checkpoint as ckpt
from bsdf_diffusion_sampling_tpu_torch.train.losses import flow_matching_mse, linspace_alpha, pretrain_nll


@dataclass
class TrainState:
    """A stage's parameters (a tree of leaf tensors that require grad), the
    Adam optimizer over its leaves, and the iterations completed."""

    params: Any
    optimizer: torch.optim.Adam
    step: int = 0


def init_state(params: Any, lr: float) -> TrainState:
    """A fresh state over a copy of `params`, with optax.adam's defaults."""
    params = ckpt.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    return TrainState(params, torch.optim.Adam(ckpt.tree_leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8))


def detached(params: Any) -> Any:
    return ckpt.tree_map(lambda t: t.detach(), params)


def _average_grads(state: TrainState, loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mesh's mean gradient in every leaf's .grad and its mean loss: one
    all_reduce of one flat buffer."""
    leaves = ckpt.tree_leaves(state.params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
    all_reduce_(mesh, flat).div_(mesh.size)
    at = 0
    for p, g in zip(leaves, grads):
        p.grad = flat[at:at + g.numel()].view(g.shape)
        at += g.numel()
    return flat[at]


def _descend(state: TrainState, loss: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None and mesh.group is not None:
        loss = _average_grads(state, loss, mesh)
    state.optimizer.step()
    state.step += 1
    return loss.detach()


class Step(NamedTuple):
    """One stage's step in two parts: `draw(...)` makes this rank's rows of
    one global batch (a tuple of tensors) from its generator, and
    `update(state, batch, mesh)` takes the loss on those rows, the gradient
    averaged over the mesh and the Adam update, and returns the loss (the
    mesh's mean)."""

    draw: Callable
    update: Callable


# ------------------------------------------------------------- pretrain ----


def make_pretrain_step(domain: str) -> Step:
    """draw(dataset (N, 4), gen, batch_size, mesh) -> (rows,): this rank's
    rows of a global minibatch of batch_size."""
    base = get_base(domain)

    def draw(dataset: torch.Tensor, gen: torch.Generator, batch_size: int, mesh: Mesh | None = None):
        rows = batch_size if mesh is None else mesh.block(batch_size)[1]
        idx = torch.randint(0, dataset.shape[0], (rows,), generator=gen, device=dataset.device)
        return (dataset[idx],)

    def update(state: TrainState, batch, mesh: Mesh | None = None):
        return _descend(state, pretrain_nll(base, state.params, batch[0]), mesh)

    return Step(draw, update)


# ------------------------------------------------------------ diffusion ----


def make_diffusion_step(domain: str, cfg: ModelConfig) -> Step:
    """Flow matching: minibatch gather, base draw, MSE, Adam. draw(base_params,
    dataset, gen, batch_size, mesh) -> (omega_i, x1, x0, alpha), alpha this
    rank's rows of the global batch's linspace."""
    base = get_base(domain)

    def draw(base_params: dict, dataset: torch.Tensor, gen: torch.Generator, batch_size: int,
             mesh: Mesh | None = None):
        start, rows = (0, batch_size) if mesh is None else mesh.block(batch_size)
        idx = torch.randint(0, dataset.shape[0], (rows,), generator=gen, device=dataset.device)
        batch = dataset[idx]
        omega_i, x1 = batch[:, 0:2], batch[:, 2:4]
        with torch.no_grad():
            x0 = base.sample(base_params, omega_i, gen)
        alpha = linspace_alpha(batch_size, device=dataset.device)[start:start + rows]
        return omega_i, x1, x0, alpha

    def update(state: TrainState, batch, mesh: Mesh | None = None):
        omega_i, x1, x0, alpha = batch
        cond = encode_condition(omega_i, cfg)
        return _descend(state, flow_matching_mse(domain, state.params, x0, x1, alpha, cond), mesh)

    return Step(draw, update)


# -------------------------------------------------------------- rectify ----


def make_rectify_pairgen(domain: str, cfg: ModelConfig, T: int):
    """(teacher (PackedWeights), base_params, gen, n_wi, n_per_wi) -> (x0,
    x1, omega_i): n_wi stratified omega_i, each repeated n_per_wi times,
    base draws x0 and their T-step transport x1 by the teacher (K3 on CUDA
    tensors). The pairs come in omega_i-block order; the rectify step
    permutes the alphas instead of shuffling the pairs."""
    base = get_base(domain)
    theta_max = math.pi if domain == "sphere_full" else math.pi / 2

    @torch.no_grad()
    def pairgen(teacher: PackedWeights, base_params: dict, gen: torch.Generator, n_wi: int, n_per_wi: int):
        with trace.span("rectify.pairgen"):
            if domain == "disk":
                wi = stratified_disk(gen, n_wi)
            else:
                wi = stratified_hemisphere_angles(gen, n_wi, theta_max)
            omega_i = wi.repeat_interleave(n_per_wi, dim=0)
            x0 = base.sample(base_params, omega_i, gen)
            x1, _ = fused_transport_packed(teacher, domain, x0, encode_condition(omega_i, cfg), T, with_jac=False)
            return x0, x1, omega_i

    return pairgen


def make_rectify_step(domain: str, cfg: ModelConfig) -> Step:
    """Retrain the student on the (x0, x1) pairs. draw(x0, x1, omega_i, gen,
    mesh) -> (x0, x1, omega_i, alpha): `gen` permutes the pair -> alpha
    assignment: alpha_i = perm_i / (n - 1) over pairs in block order is the
    reference's linspace over shuffled pairs, for the cost of one
    permutation (the loss is a mean over pairs). On a mesh of size W, rank
    r's m pairs take the alphas (perm_i W + r) / (n - 1), n = m W: the
    ranks' alphas together are the global batch's linspace."""

    def draw(x0, x1, omega_i, gen: torch.Generator, mesh: Mesh | None = None):
        with trace.span("rectify.update"):
            m = x0.shape[0]
            rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
            perm = torch.randperm(m, generator=gen, device=x0.device) * size + rank
            alpha = (perm.to(x0.dtype) / max(m * size - 1, 1)).reshape(-1, 1)
            return x0, x1, omega_i, alpha

    def update(state: TrainState, batch, mesh: Mesh | None = None):
        with trace.span("rectify.update"):
            x0, x1, omega_i, alpha = batch
            cond = encode_condition(omega_i, cfg)
            return _descend(state, flow_matching_mse(domain, state.params, x0, x1, alpha, cond), mesh)

    return Step(draw, update)


# ------------------------------------------------------------- trainers ----


def _replicate_state(state: TrainState, start: int, mesh: Mesh) -> int:
    """Rank 0's step, parameters and Adam moments on every rank; returns
    the step. Rank 0 alone has read the stage file: its step and Adam count
    cross first, then the other ranks make zero moments where rank 0 has
    moments (or drop theirs where it has none), so that every rank
    broadcasts the same layout."""
    if mesh.group is None:
        return start
    leaves = ckpt.tree_leaves(state.params)
    adam = state.optimizer.state
    have = [p in adam for p in leaves]
    if any(have) and not all(have):
        raise ValueError("the Adam state covers only some of the parameters")
    count = int(float(adam[leaves[0]]["step"])) if all(have) else -1
    head = torch.tensor([start, count], dtype=torch.int64, device=mesh.device)
    torch.distributed.broadcast(head, src=0, group=mesh.group)
    start, count = (int(v) for v in head.tolist())
    for p in leaves:
        if count < 0:
            adam.pop(p, None)
        elif mesh.rank != 0:
            adam[p] = {"step": torch.tensor(float(count)), "exp_avg": torch.zeros_like(p),
                       "exp_avg_sq": torch.zeros_like(p)}
    moments = [adam[p][k] for p in leaves if p in adam for k in ("exp_avg", "exp_avg_sq")]
    replicate(mesh, leaves + moments)
    state.step = start
    return start


class _HostLoss:
    """A loss copied to the host without waiting: on CUDA into pinned memory
    behind an event, read when the event has passed."""

    def __init__(self, loss: torch.Tensor):
        self.event = None
        if loss.is_cuda:
            self.value = torch.empty((), dtype=loss.dtype, pin_memory=True)
            self.value.copy_(loss, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.value = loss

    def __float__(self) -> float:
        with trace.span("train.log_wait"):
            if self.event is not None:
                self.event.synchronize()
            return float(self.value)


def run_stage(
    *,
    name: str,
    state: TrainState,
    step_call: Callable[[TrainState, torch.Generator, int], torch.Tensor],
    iters: int,
    seed: int,
    device,
    checkpoint_path: Optional[str] = None,
    save_every: int = 1000,
    log_every: int = 100,
    log_fn: Callable[[str], None] = print,
    stats: Optional[dict] = None,
    mesh: Mesh | None = None,
) -> TrainState:
    """Resume from `checkpoint_path` if it exists, run the iterations left
    (iteration `it` draws from `iter_generator(seed, it)`), save every
    `save_every` iterations and at the end. The saved step counts completed
    iterations. A log line reports the loss of the previous log point, which
    the device has finished by then, so the loop never waits on it. With
    `stats`, `stats[name]` gets each iteration's ms (CUDA events on the card)
    and the stage's peak device memory. While a profiler records, each
    iteration is the outermost span `train.iteration` (over the rectify
    step's `rectify.pairgen` and `rectify.update`), each save a
    `train.checkpoint` and each wait for a logged loss a `train.log_wait`.

    With a `mesh`, rank 0 alone reads the stage file, its step, parameters
    and Adam moments are broadcast to all, iteration `it` draws from
    `iter_generator(host_fold(seed), it)`, and only rank 0 saves and logs."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    lead = mesh is None or mesh.rank == 0
    log_fn = log_fn if lead else (lambda s: None)
    start = state.step
    if lead and checkpoint_path and os.path.exists(checkpoint_path):
        start = ckpt.load_train_state(checkpoint_path, state.params, state.optimizer)
        state.step = start
        log_fn(f"[{name}] resumed at step {start}")
    if mesh is not None:
        start = _replicate_state(state, start, mesh)
        seed = host_fold(seed, mesh)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    marks = []

    def mark():
        if stats is None:
            return
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    t0 = time.perf_counter()
    pending = None  # (step, loss on its way to the host) from the previous log point
    for it in range(start, iters):
        with trace.span("train.iteration", step=it):
            mark()
            loss = step_call(state, prng.iter_generator(seed, it, device), it)
            if log_every and (it % log_every == 0 or it + 1 == iters):
                if pending is not None:
                    rate = (it + 1 - start) / (time.perf_counter() - t0)
                    log_fn(f"[{name}] step {pending[0]}/{iters} loss {float(pending[1]):.6g} ({rate:.1f} it/s)")
                pending = (it, _HostLoss(loss))
            if lead and checkpoint_path and save_every and (it + 1) % save_every == 0 and it + 1 < iters:
                with trace.span("train.checkpoint"):
                    ckpt.save_train_state(checkpoint_path, state.params, state.optimizer, step=it + 1)
    mark()
    if pending is not None:
        log_fn(f"[{name}] step {pending[0]}/{iters} loss {float(pending[1]):.6g}")
    if lead and checkpoint_path:
        with trace.span("train.checkpoint"):
            ckpt.save_train_state(checkpoint_path, state.params, state.optimizer, step=iters)
    if stats is not None:
        if cuda:
            torch.cuda.synchronize(device)
            ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        else:
            ms = [1e3 * (b - a) for a, b in zip(marks[:-1], marks[1:])]
        stats[name] = {"iters": len(ms), "ms": ms, "ms_median": float(np.median(ms[1:] or ms)) if ms else None,
                       "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None}
        if ms:
            peak = f", peak device memory {stats[name]['peak_bytes'] / 2**30:.2f} GiB" if cuda else ""
            log_fn(f"[{name}] {len(ms)} iterations, {stats[name]['ms_median']:.3f} ms an iteration "
                   f"(median after the first){peak}")
    return state


# ------------------------------------------------------- full pipelines ----


def train_material(
    dataset,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    teacher_cfg: Optional[ModelConfig] = None,
    log_fn: Callable[[str], None] = print,
    device="cuda",
    stats: Optional[dict] = None,
    mesh: Mesh | None = None,
) -> dict:
    """Pretrain -> diffusion -> rectify for one material, on `device` (the
    card unless the caller asks for the CPU). `dataset`: (N, 4) rows of
    (omega_i, omega_o), numpy or a tensor. `teacher_cfg` names the net that
    generates the rectify pairs (the spherical pipelines train a 6 x 64
    teacher beside the student); None self-distils the student (disk).
    Initial weights are drawn on the CPU, so both devices start alike.
    Returns {base, diffusion, teacher, rectified} parameter trees.

    With a `mesh`, every stage runs data-parallel over it (the module
    docstring): each rank passes the whole dataset and its own device, and
    every rank returns the same trees."""
    device = resolve_device(device)
    domain, seed, ckdir = model_cfg.domain, train_cfg.seed, train_cfg.checkpoint_dir
    base = get_base(domain)
    data = torch.as_tensor(dataset, dtype=torch.float32).to(device)
    common = dict(device=device, save_every=train_cfg.save_every, log_every=train_cfg.log_every, log_fn=log_fn,
                  stats=stats, mesh=mesh)
    size = 1 if mesh is None else mesh.size

    def on_device(tree):
        return ckpt.tree_map(lambda t: t.to(device), tree)

    def path(file):
        return os.path.join(ckdir, file) if ckdir else None

    # ---- pretrain
    b_state = init_state(on_device(base.init(prng.stage_generator(seed, "init/base", "cpu"),
                                             hidden=model_cfg.base_hidden, pe_bands=model_cfg.base_pe_bands)),
                         train_cfg.lr_pretrain)
    pre_step = make_pretrain_step(domain)
    bs_pre = pad_to_multiple(train_cfg.batch_pretrain, size)
    run_stage(name=f"pretrain/{domain}", state=b_state, iters=train_cfg.iters_pretrain,
              step_call=lambda s, g, it: pre_step.update(s, pre_step.draw(data, g, bs_pre, mesh), mesh),
              seed=prng.fold_in(seed, "pretrain"), checkpoint_path=path("pretrain.npz"), **common)
    base_params = detached(b_state.params)

    # ---- diffusion (student; and a teacher if configured)
    def train_diffusion(cfg: ModelConfig, tag: str):
        state = init_state(on_device(velocity_init(prng.stage_generator(seed, f"init/{tag}", "cpu"), cfg)),
                           train_cfg.lr_diffusion)
        d_step = make_diffusion_step(domain, cfg)
        bs = pad_to_multiple(train_cfg.batch_diffusion, size)
        run_stage(name=f"diffusion-{tag}/{domain}", state=state, iters=train_cfg.iters_diffusion,
                  step_call=lambda s, g, it: d_step.update(s, d_step.draw(base_params, data, g, bs, mesh), mesh),
                  seed=prng.fold_in(seed, f"diffusion-{tag}"), checkpoint_path=path(f"diffusion_{tag}.npz"),
                  **common)
        return detached(state.params)

    student_params = train_diffusion(model_cfg, "simpler")
    if teacher_cfg is not None:
        teacher_params, teacher_model_cfg = train_diffusion(teacher_cfg, "complex"), teacher_cfg
    else:
        teacher_params, teacher_model_cfg = student_params, model_cfg

    # ---- rectify: pairs from the teacher's transport retrain a copy of the student
    r_state = init_state(student_params, train_cfg.lr_rectify)
    pairgen = make_rectify_pairgen(domain, teacher_model_cfg, train_cfg.timestep_rectify)
    teacher = prepack_velocity(teacher_params)
    r_step = make_rectify_step(domain, model_cfg)
    n_wi = pad_to_multiple(train_cfg.batch_wi_rectify, size) // size  # this rank's omega_i

    def rectify_call(s, g, it):
        x0, x1, wi = pairgen(teacher, base_params, g, n_wi, train_cfg.num_samples_rectify)
        return r_step.update(s, r_step.draw(x0, x1, wi, g, mesh), mesh)

    run_stage(name=f"rectify/{domain}", state=r_state, step_call=rectify_call, iters=train_cfg.iters_rectify,
              seed=prng.fold_in(seed, "rectify"), checkpoint_path=path("rectify.npz"), **common)
    return {"base": base_params, "diffusion": student_params, "teacher": teacher_params,
            "rectified": detached(r_state.params)}
