"""One rank of tests/test_torch_distributed.py's two-process gloo group on
the CPU.

    python tests/_torch_dist_worker.py <rank> <world size> <work dir>

The parent writes `<work dir>/inputs.npz` (the scene is in the work dir)
and starts every rank; each forms the group through a file in the work
dir, runs every check of the file once (the bounces last, on
`<work dir>/bounce.npz`, which the parent writes while the ranks work) and
writes what it found to `<work dir>/rank<r>.npz` and
`<work dir>/rank<r>.json`. Imports nothing of
JAX: the ranks run the port alone, as on the card's machine.
"""

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured  # noqa: E402
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, TrainConfig  # noqa: E402
from bsdf_diffusion_sampling_tpu_torch.core.prng import iter_generator, root_generator  # noqa: E402
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax  # noqa: E402
from bsdf_diffusion_sampling_tpu_torch.parallel import (  # noqa: E402
    global_batch_slice,
    host_fold,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti  # noqa: E402
from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf  # noqa: E402
from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene  # noqa: E402
from bsdf_diffusion_sampling_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from bsdf_diffusion_sampling_tpu_torch.train import stages  # noqa: E402

W, H = 32, 24  # the film of tests/test_torch_distributed.py
BATCH_SIZES = (8, 9, 1000, 1001)
SEEDS = (0, 7, 123456789)
STEP_LR = {"pretrain": 3e-4, "diffusion": 1e-3, "rectify": 1e-3}
RESUME_AT, RESUME_ITERS = 2, 4  # the resumed stage: the step rank 0's file holds, the stage's length


class Collectives:
    """Counts every all_reduce, broadcast and barrier through torch.distributed."""

    def __init__(self):
        self.n = {"all_reduce": 0, "broadcast": 0, "barrier": 0}
        for name in self.n:
            orig = getattr(dist, name)

            def counted(*a, _name=name, _orig=orig, **k):
                self.n[_name] += 1
                return _orig(*a, **k)

            setattr(dist, name, counted)

    def total(self) -> int:
        return sum(self.n.values())


def tensors(npz, prefix: str) -> list:
    keys = sorted((k for k in npz.files if k.startswith(prefix)), key=lambda k: int(k[len(prefix):]))
    return [torch.from_numpy(npz[k]) for k in keys]


def matballs(d: str):
    brdf = load_measured(os.path.join(d, "synthetic_rgb.bsdf"), device="cpu")
    weights, _ = ckpt.load_pytree(os.path.join(d, "disk.npz"))
    nb = make_neural_bsdf("disk", ModelConfig(), weights["rectified"], weights["base"], brdf, device="cpu")
    return {"gt": ti.measured_matball(brdf), "neural-disk": ti.neural_matball(nb)}


def step_of(stage: str) -> stages.Step:
    return {"pretrain": lambda: stages.make_pretrain_step("disk"),
            "diffusion": lambda: stages.make_diffusion_step("disk", ModelConfig()),
            "rectify": lambda: stages.make_rectify_step("disk", ModelConfig())}[stage]()


def bounce_randoms(inputs, key: str, r0: int, m: int) -> ti.BounceRandoms:
    rnd = ti.BounceRandoms(*(torch.from_numpy(inputs[f"{key}/{f}"]) for f in ("u_nee", "u_diffuse")),
                           (torch.from_numpy(inputs[f"{key}/ball"]),), torch.from_numpy(inputs[f"{key}/u_rr"]))
    return ti.shard_randoms(rnd, r0, m)


def main() -> None:
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(2)
    multi = init_distributed(backend="gloo", init_method=f"file://{os.path.join(d, 'group')}", world_size=world,
                             rank=rank, device_type="cpu")
    mesh = make_mesh(device_type="cpu")
    counts = Collectives()
    inputs = np.load(os.path.join(d, "inputs.npz"))
    out, info = {}, {"multi": multi, "rank": mesh.rank, "size": mesh.size, "init_again": init_distributed(),
                     "slices": {n: list(global_batch_slice(n)) for n in BATCH_SIZES},
                     "host_fold": [host_fold(s) for s in SEEDS]}

    # the render: one pass a mode, the collectives counted around it
    scene = load_scene(os.path.join(d, "scene_measured.xml"), device="cpu", width=W, height=H)
    balls = matballs(d)
    info["pass_collectives"] = {}
    for mode, mb in balls.items():
        before = counts.total()
        img, cnt, truncated = ti.render_pass(scene, mb, root_generator(int(inputs["render_seed"]), "cpu"),
                                             spp_chunk=4, max_depth=2, mesh=mesh)
        info["pass_collectives"][mode] = {**counts.n, "total": counts.total() - before}
        out[f"render/{mode}/img"], out[f"render/{mode}/cnt"] = img.numpy(), cnt.numpy()
        info[f"truncated/{mode}"] = bool(truncated)

    # one step of each stage on an explicit global batch, in float64
    info["step_collectives"] = {}
    for stage in ("pretrain", "diffusion", "rectify"):
        params = ckpt.tree_map(lambda t: t.double(),
                               params_from_jax(ckpt.load_pytree(os.path.join(d, f"step_{stage}.npz"))[0], "cpu"))
        if stage == "pretrain":
            params["pe_bands"] = 3
        state = stages.init_state(params, STEP_LR[stage])  # float64: tests/test_torch_distributed.py says why
        batch = tuple(tensors(inputs, f"step/{stage}/batch"))
        before = counts.total()
        loss = step_of(stage).update(state, shard_batch(mesh, batch), mesh)
        info["step_collectives"][stage] = counts.total() - before
        info[f"step/{stage}/loss"] = float(loss)
        for (k, value), p in zip(ckpt._flatten(state.params), ckpt.tree_leaves(state.params)):
            out[f"step/{stage}/params{k}"] = value
            out[f"step/{stage}/mu{k}"] = state.optimizer.state[p]["exp_avg"].numpy()
            out[f"step/{stage}/nu{k}"] = state.optimizer.state[p]["exp_avg_sq"].numpy()

    # the same steps in float32, the precision training runs in: the
    # averaged gradient each leaf's .grad holds after the all_reduce
    for stage in ("pretrain", "diffusion", "rectify"):
        params = params_from_jax(ckpt.load_pytree(os.path.join(d, f"step_{stage}.npz"))[0], "cpu")
        if stage == "pretrain":
            params["pe_bands"] = 3
        state = stages.init_state(params, STEP_LR[stage])
        batch = tuple(t.float() for t in tensors(inputs, f"step/{stage}/batch"))
        info[f"step32/{stage}/loss"] = float(step_of(stage).update(state, shard_batch(mesh, batch), mesh))
        for (k, _), p in zip(ckpt._flatten(state.params), ckpt.tree_leaves(state.params)):
            out[f"step32/{stage}/grad{k}"] = p.grad.numpy()

    # replicate: rank 0's leaves, each in its own dtype, on every rank
    tree = {"f64": torch.tensor([1.0 + 2.0**-40, np.pi], dtype=torch.float64) * (rank + 1),
            "i64": torch.tensor([2**53 + 1 + rank, -3], dtype=torch.int64),
            "f32": [torch.full((2, 3), 0.1 * (rank + 1))]}
    for k, t in ckpt._flatten(replicate(mesh, tree)):
        out[f"replicate{k}"] = t

    # a resume that only rank 0 can read: rank 0 writes a stage file two
    # steps in, under a directory of its own, as on hosts that share no disk
    resume_dir = os.path.join(d, f"resume_rank{rank}")
    pre, data = stages.make_pretrain_step("disk"), torch.from_numpy(inputs["train_dataset"])
    params = params_from_jax(ckpt.load_pytree(os.path.join(d, "step_pretrain.npz"))[0], "cpu")
    params["pe_bands"] = 3
    if rank == 0:
        solo = stages.init_state(params, STEP_LR["pretrain"])
        for it in range(RESUME_AT):
            pre.update(solo, pre.draw(data, iter_generator(5, it, "cpu"), 64))
        ckpt.save_train_state(os.path.join(resume_dir, "pretrain.npz"), solo.params, solo.optimizer, RESUME_AT)
    state, logs, before = stages.init_state(params, STEP_LR["pretrain"]), [], dict(counts.n)
    stages.run_stage(name="resume", state=state, iters=RESUME_ITERS, seed=5, device="cpu", save_every=0,
                     step_call=lambda s, g, it: pre.update(s, pre.draw(data, g, 64, mesh), mesh), log_fn=logs.append,
                     checkpoint_path=os.path.join(resume_dir, "pretrain.npz"), mesh=mesh)
    info["resume"] = {"collectives": {k: counts.n[k] - before[k] for k in counts.n}, "logs": logs,
                      "step": state.step, "adam_counts": sorted({float(state.optimizer.state[p]["step"])
                                                                 for p in ckpt.tree_leaves(state.params)})}
    for k, t in ckpt._flatten(state.params):
        out[f"resume{k}"] = t

    # a tiny data-parallel train_material that writes stage files (rank 0)
    cfg = TrainConfig(**json.loads(str(inputs["train_cfg"])))
    logs = []
    before = dict(counts.n)
    params = stages.train_material(torch.from_numpy(inputs["train_dataset"]), ModelConfig(), cfg,
                                   log_fn=logs.append, device="cpu", mesh=mesh)
    info["train_collectives"] = {k: counts.n[k] - before[k] for k in counts.n}
    info["train_logs"] = logs
    for k, t in ckpt._flatten(params):
        out[f"train{k}"] = np.asarray(t)

    # the bounce, fed JAX's state and draws at each depth, on this rank's rows
    # (the parent writes them while the ranks render and train)
    bounce_path = os.path.join(d, "bounce.npz")
    deadline = time.time() + 200
    while not os.path.exists(bounce_path):
        if time.time() > deadline:
            raise TimeoutError("the parent never wrote bounce.npz")
        time.sleep(0.1)
    inputs = np.load(bounce_path)
    before = counts.total()
    for mode in ("gt",):
        for depth in range(int(inputs["depths"])):
            key = f"bounce/{mode}/{depth}"
            state = tensors(inputs, f"{key}/state")
            r0, m = mesh.block(state[0].shape[0])
            state_out, truncated = ti._bounce_body(scene.accel, scene.envmap, scene.lights,
                                                   tuple(x[r0:r0 + m] for x in state),
                                                   bounce_randoms(inputs, key, r0, m), depth,
                                                   matball=(balls[mode],))
            for i, x in enumerate(state_out):
                out[f"{key}/out{i}"] = x.numpy()
            info[f"truncated/{key}"] = bool(truncated)
    info["bounce_collectives"] = counts.total() - before

    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank, flush=True)


if __name__ == "__main__":
    main()
