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
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.core import prng
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, TrainConfig
from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.geometry.sampling import stratified_disk, stratified_hemisphere_angles
from bsdf_diffusion_sampling_tpu_torch.models.base_density import get_base
from bsdf_diffusion_sampling_tpu_torch.models.velocity import encode_condition, velocity_init
from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import PackedWeights, fused_transport_packed, prepack_velocity
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


def _descend(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


# ------------------------------------------------------------- pretrain ----


def make_pretrain_step(domain: str):
    """(state, dataset (N, 4), gen, batch_size) -> loss."""
    base = get_base(domain)

    def step(state: TrainState, dataset: torch.Tensor, gen: torch.Generator, batch_size: int):
        idx = torch.randint(0, dataset.shape[0], (batch_size,), generator=gen, device=dataset.device)
        return _descend(state, pretrain_nll(base, state.params, dataset[idx]))

    return step


# ------------------------------------------------------------ diffusion ----


def make_diffusion_step(domain: str, cfg: ModelConfig):
    """Flow matching: minibatch gather, base draw, MSE, Adam."""
    base = get_base(domain)

    def step(state: TrainState, base_params: dict, dataset: torch.Tensor, gen: torch.Generator, batch_size: int):
        idx = torch.randint(0, dataset.shape[0], (batch_size,), generator=gen, device=dataset.device)
        batch = dataset[idx]
        omega_i, x1 = batch[:, 0:2], batch[:, 2:4]
        with torch.no_grad():
            x0 = base.sample(base_params, omega_i, gen)
        alpha = linspace_alpha(batch_size, device=dataset.device)
        cond = encode_condition(omega_i, cfg)
        return _descend(state, flow_matching_mse(domain, state.params, x0, x1, alpha, cond))

    return step


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
        if domain == "disk":
            wi = stratified_disk(gen, n_wi)
        else:
            wi = stratified_hemisphere_angles(gen, n_wi, theta_max)
        omega_i = wi.repeat_interleave(n_per_wi, dim=0)
        x0 = base.sample(base_params, omega_i, gen)
        x1, _ = fused_transport_packed(teacher, domain, x0, encode_condition(omega_i, cfg), T, with_jac=False)
        return x0, x1, omega_i

    return pairgen


def make_rectify_step(domain: str, cfg: ModelConfig):
    """Retrain the student on the (x0, x1) pairs. `gen` permutes the
    pair -> alpha assignment: alpha_i = perm_i / (n - 1) over pairs in
    block order is the reference's linspace over shuffled pairs, for the
    cost of one permutation (the loss is a mean over pairs)."""

    def step(state: TrainState, x0, x1, omega_i, gen: torch.Generator):
        n = x0.shape[0]
        alpha = (torch.randperm(n, generator=gen, device=x0.device).to(x0.dtype) / max(n - 1, 1)).reshape(-1, 1)
        cond = encode_condition(omega_i, cfg)
        return _descend(state, flow_matching_mse(domain, state.params, x0, x1, alpha, cond))

    return step


# ------------------------------------------------------------- trainers ----


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
) -> TrainState:
    """Resume from `checkpoint_path` if it exists, run the iterations left
    (iteration `it` draws from `iter_generator(seed, it)`), save every
    `save_every` iterations and at the end. The saved step counts completed
    iterations. A log line reports the loss of the previous log point, which
    the device has finished by then, so the loop never waits on it. With
    `stats`, `stats[name]` gets each iteration's ms (CUDA events on the card)
    and the stage's peak device memory."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    start = state.step
    if checkpoint_path and os.path.exists(checkpoint_path):
        start = ckpt.load_train_state(checkpoint_path, state.params, state.optimizer)
        state.step = start
        log_fn(f"[{name}] resumed at step {start}")
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
        mark()
        loss = step_call(state, prng.iter_generator(seed, it, device), it)
        if log_every and (it % log_every == 0 or it + 1 == iters):
            if pending is not None:
                rate = (it + 1 - start) / (time.perf_counter() - t0)
                log_fn(f"[{name}] step {pending[0]}/{iters} loss {float(pending[1]):.6g} ({rate:.1f} it/s)")
            pending = (it, _HostLoss(loss))
        if checkpoint_path and save_every and (it + 1) % save_every == 0 and it + 1 < iters:
            ckpt.save_train_state(checkpoint_path, state.params, state.optimizer, step=it + 1)
    mark()
    if pending is not None:
        log_fn(f"[{name}] step {pending[0]}/{iters} loss {float(pending[1]):.6g}")
    if checkpoint_path:
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
) -> dict:
    """Pretrain -> diffusion -> rectify for one material, on `device` (the
    card unless the caller asks for the CPU). `dataset`: (N, 4) rows of
    (omega_i, omega_o), numpy or a tensor. `teacher_cfg` names the net that
    generates the rectify pairs (the spherical pipelines train a 6 x 64
    teacher beside the student); None self-distils the student (disk).
    Initial weights are drawn on the CPU, so both devices start alike.
    Returns {base, diffusion, teacher, rectified} parameter trees."""
    device = resolve_device(device)
    domain, seed, ckdir = model_cfg.domain, train_cfg.seed, train_cfg.checkpoint_dir
    base = get_base(domain)
    data = torch.as_tensor(dataset, dtype=torch.float32).to(device)
    common = dict(device=device, save_every=train_cfg.save_every, log_every=train_cfg.log_every, log_fn=log_fn,
                  stats=stats)

    def on_device(tree):
        return ckpt.tree_map(lambda t: t.to(device), tree)

    def path(file):
        return os.path.join(ckdir, file) if ckdir else None

    # ---- pretrain
    b_state = init_state(on_device(base.init(prng.stage_generator(seed, "init/base", "cpu"),
                                             hidden=model_cfg.base_hidden, pe_bands=model_cfg.base_pe_bands)),
                         train_cfg.lr_pretrain)
    pre_step = make_pretrain_step(domain)
    run_stage(name=f"pretrain/{domain}", state=b_state, iters=train_cfg.iters_pretrain,
              step_call=lambda s, g, it: pre_step(s, data, g, train_cfg.batch_pretrain),
              seed=prng.fold_in(seed, "pretrain"), checkpoint_path=path("pretrain.npz"), **common)
    base_params = detached(b_state.params)

    # ---- diffusion (student; and a teacher if configured)
    def train_diffusion(cfg: ModelConfig, tag: str):
        state = init_state(on_device(velocity_init(prng.stage_generator(seed, f"init/{tag}", "cpu"), cfg)),
                           train_cfg.lr_diffusion)
        d_step = make_diffusion_step(domain, cfg)
        run_stage(name=f"diffusion-{tag}/{domain}", state=state, iters=train_cfg.iters_diffusion,
                  step_call=lambda s, g, it: d_step(s, base_params, data, g, train_cfg.batch_diffusion),
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

    def rectify_call(s, g, it):
        x0, x1, wi = pairgen(teacher, base_params, g, train_cfg.batch_wi_rectify, train_cfg.num_samples_rectify)
        return r_step(s, x0, x1, wi, g)

    run_stage(name=f"rectify/{domain}", state=r_state, step_call=rectify_call, iters=train_cfg.iters_rectify,
              seed=prng.fold_in(seed, "rectify"), checkpoint_path=path("rectify.npz"), **common)
    return {"base": base_params, "diffusion": student_params, "teacher": teacher_params,
            "rectified": detached(r_state.params)}
