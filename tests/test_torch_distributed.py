"""The port's multi-process paths (`parallel/`, the ray-sharded render, the
data-parallel stages) on the CPU: two real processes in one gloo group
(`tests/_torch_dist_worker.py`), started once for the whole file, against
one process and against the JAX package.

- The helpers: `global_batch_slice` and `pad_to_multiple` against the JAX
  package's formulas; `host_fold` the identity at world size 1 and a
  distinct seed a rank in the group; `init_distributed` a no-op in one
  process, and raising, never carrying on alone, when it is told to form a
  group it cannot.
- The render: a 2-rank `render_pass` (gt, neural-disk; 32 x 24, spp_chunk
  4, depth 2) against the one-process pass of the same seed: counts
  equal, the image within rtol 1e-4 / atol 1e-5 (JAX
  tests/test_render_sharded.py:33-34), both ranks' films equal.
- The bounce: each rank's `_bounce_body` on its rows of JAX's state and
  draws, against JAX's `_bounce_body(..., mesh=make_mesh(2))` on the
  8-device CPU mesh (the measured matball: the neural-disk bounce with
  JAX's explicit eps is tests/test_torch_integrator.py's, and its draws
  shard as the measured ball's do), at tests/test_torch_integrator.py's tolerances
  (alive flags differ on at most 0.1% of rays; ro, rd, L, beta, prev_pdf
  within 1e-3 relative / 1e-5 absolute on 99.5% of the rays whose flags
  agree).
- The collective audit: no collective in a bounce, one all_reduce a
  render pass, one a training step (and two broadcasts a stage: rank 0's
  step, then its state).
- A data-parallel step of each stage on an explicit global batch equals
  the one-process step in parameters and Adam moments to 1e-6 relative
  (max |difference| over max |value|, a leaf at a time); the ranks'
  parameters are bit-equal. The step runs in float64: Adam's first step
  moves a weight by lr g / (|g| + 1e-8), which turns the float32 rounding
  of a gradient component near 1e-7 (a sum in another order) into a move
  of ~1e-7 (1.4e-6 of its leaf's largest weight in a float32 run);
  float64 leaves the data-parallel arithmetic alone in the comparison.
  In float32, the precision training runs in, the averaged gradient (each
  leaf's .grad after the all_reduce, before Adam) equals the one-process
  gradient within 1e-5 of its leaf's largest component.
- `replicate` hands every rank rank 0's leaves in their own dtypes
  (float64 and int64 to the bit), and a stage file that only rank 0 can
  read (as on hosts that share no disk) resumes every rank at its step.
- A 2-rank `train_material` writes stage files that the port's loader and
  JAX's `load_pytree` read, and one process resumes them.
- K1's and K4's plain draws at a row offset are the slice of the whole
  batch's draw.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from bsdf_diffusion_sampling_tpu.bsdf import measured as jme
from bsdf_diffusion_sampling_tpu.core.config import ModelConfig as JModelConfig
from bsdf_diffusion_sampling_tpu.models import get_base as j_get_base
from bsdf_diffusion_sampling_tpu.models.velocity import velocity_init as j_velocity_init
from bsdf_diffusion_sampling_tpu.parallel import make_mesh as j_make_mesh
from bsdf_diffusion_sampling_tpu.parallel import pad_to_multiple as j_pad_to_multiple
from bsdf_diffusion_sampling_tpu.render import integrator as ji
from bsdf_diffusion_sampling_tpu.render import scene as jscene
from bsdf_diffusion_sampling_tpu.train import checkpoint as j_ckpt
from bsdf_diffusion_sampling_tpu.train.stages import TrainState as JTrainState
from bsdf_diffusion_sampling_tpu_torch import parallel
from bsdf_diffusion_sampling_tpu_torch.bsdf import measured as tme
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, TrainConfig
from bsdf_diffusion_sampling_tpu_torch.core.prng import fold_in, root_generator
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.ops import fused_ode as fo
from bsdf_diffusion_sampling_tpu_torch.parallel.mesh import Mesh
from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti
from bsdf_diffusion_sampling_tpu_torch.render import neural as tneural
from bsdf_diffusion_sampling_tpu_torch.render import procedural
from bsdf_diffusion_sampling_tpu_torch.render import scene as tscene
from bsdf_diffusion_sampling_tpu_torch.train import checkpoint as t_ckpt
from bsdf_diffusion_sampling_tpu_torch.train import stages

from _torch_dist_worker import BATCH_SIZES, H, RESUME_AT, RESUME_ITERS, SEEDS, STEP_LR, W, step_of
from _torch_port import disk_setup

WORLD = 2
DEPTHS = 3  # camera rays, then MIS on env hits from depth 1
RENDER_SEED = 11
STEP_ROWS = 64
MAX_DISCRETE = 1e-3
MIN_CONTINUOUS = 0.995
TRAIN_CFG = dict(batch_pretrain=255, iters_pretrain=3, batch_diffusion=255, iters_diffusion=3, iters_rectify=2,
                 timestep_rectify=4, num_samples_rectify=16, batch_wi_rectify=3, save_every=2, log_every=1, seed=1)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_worker.py")


def _jax_randoms(k_path, depth, n, mode):
    """What JAX's `_bounce_body` draws from its key at this depth, as numpy
    (tests/test_torch_integrator.py's `_jax_randoms`)."""
    k_nee, k_bsdf, k_rr = jax.random.split(jax.random.fold_in(k_path, depth), 3)
    keys = jax.random.split(k_bsdf, 2)
    ball = (jax.random.uniform(keys[1], (n, 2), minval=1e-6, maxval=1.0 - 1e-6) if mode == "gt"
            else jax.random.normal(keys[1], (n, 2)))
    return {"u_nee": jax.random.uniform(k_nee, (n, 2)), "u_diffuse": jax.random.uniform(keys[0], (n, 2)),
            "ball": ball, "u_rr": jax.random.uniform(k_rr, (n,))}


def _unit_disk(rng, n):
    r, phi = 0.9 * np.sqrt(rng.random(n)), rng.uniform(-np.pi, np.pi, n)
    return np.stack([r * np.cos(phi), r * np.sin(phi)], -1).astype(np.float32)


def _step_batches(rng):
    """An explicit global batch of each stage, in `Step.update`'s order."""
    n = STEP_ROWS
    wi, wo, x0 = _unit_disk(rng, n), _unit_disk(rng, n), rng.standard_normal((n, 2)).astype(np.float32) * 0.3
    alpha = rng.random((n, 1), dtype=np.float32)
    return {"pretrain": (np.concatenate([wi, wo], -1),), "diffusion": (wi, wo, x0, alpha),
            "rectify": (x0, wo, wi, alpha)}


def _step_params():
    cfg = JModelConfig(domain="disk")
    return {"pretrain": j_get_base("disk").init(jax.random.key(5)),
            "diffusion": jax.tree.map(lambda w: w * 0.5, j_velocity_init(jax.random.key(6), cfg)),
            "rectify": jax.tree.map(lambda w: w * 0.5, j_velocity_init(jax.random.key(7), cfg))}


def step_state(params, stage: str):
    """A float64 stage state over the port's copy of a JAX parameter tree."""
    params = t_ckpt.tree_map(lambda t: t.double(), params_from_jax(params, "cpu"))
    if stage == "pretrain":
        params["pe_bands"] = 3
    return stages.init_state(params, STEP_LR[stage])


def _spawn(d: str) -> list:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS", "JAX_PLATFORMS")}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return [subprocess.Popen([sys.executable, "-u", WORKER, str(r), str(WORLD), d], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env) for r in range(WORLD)]


def _join(d: str, procs: list) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, f"rank {r} failed:\n{out[-4000:]}"
    return [(dict(np.load(os.path.join(d, f"rank{r}.npz"))), json.load(open(os.path.join(d, f"rank{r}.json"))))
            for r in range(WORLD)]


def _save(path: str, arrays: dict) -> None:
    """np.savez, made visible to the ranks at once (they wait for the name)."""
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' inputs, the ranks started, the JAX bounce under the
    2-device mesh (handed to the ranks when it is done: they render and
    train meanwhile), the one-process references, and the ranks' results."""
    d = str(tmp_path_factory.mktemp("dist"))
    path = procedural.write_scene(d, width=W, height=H)
    s = disk_setup(n=8, seed=4)
    t_ckpt.save_pytree(os.path.join(d, "disk.npz"), {"base": s.tb, "rectified": s.tv}, step=1)
    inputs = {"render_seed": RENDER_SEED}

    # one step of each stage: initial parameters and an explicit global batch
    params = _step_params()
    batches = _step_batches(np.random.default_rng(3))
    for stage in batches:
        t_ckpt.save_pytree(os.path.join(d, f"step_{stage}.npz"), params_from_jax(params[stage], "cpu"))
        for i, x in enumerate(batches[stage]):
            inputs[f"step/{stage}/batch{i}"] = x.astype(np.float64)

    # a tiny data-parallel train_material
    rng = np.random.default_rng(4)
    inputs["train_dataset"] = np.concatenate([_unit_disk(rng, 4096), _unit_disk(rng, 4096)], -1)
    inputs["train_cfg"] = json.dumps({**TRAIN_CFG, "checkpoint_dir": os.path.join(d, "train")})
    _save(os.path.join(d, "inputs.npz"), inputs)
    procs = _spawn(d)

    try:
        # JAX's bounce over the 2-device mesh, fed back its own state at each depth
        js = jscene.load_scene(path, width=W, height=H, wide=False)
        jb = jme.load_measured(os.path.join(d, "synthetic_rgb.bsdf"))
        jmesh, jax_out, bounce = j_make_mesh(WORLD), {}, {"depths": DEPTHS}
        for mode, jmb in (("gt", ji.measured_matball(jb)),):
            state, k_path = ji._init_wavefront(js.camera.vectors, jax.random.key(0), 0, width=W, height=H,
                                               spp_chunk=4, rows=H)
            n = state[0].shape[0]
            for depth in range(DEPTHS):
                key = f"bounce/{mode}/{depth}"
                for i, x in enumerate(state):
                    bounce[f"{key}/state{i}"] = np.asarray(x)
                for f, x in _jax_randoms(k_path, depth, n, mode).items():
                    bounce[f"{key}/{f}"] = np.asarray(x)
                state = ji._bounce_program(js.bvh, js.envmap, js.lights, state, k_path, depth, matball=(jmb,),
                                           mesh=jmesh)
                jax_out[key] = [np.asarray(x) for x in state]
        _save(os.path.join(d, "bounce.npz"), bounce)

        # the one-process references
        ts_ = tscene.load_scene(path, device="cpu", width=W, height=H)
        tb = tme.load_measured(os.path.join(d, "synthetic_rgb.bsdf"), device="cpu")
        tballs = {"gt": ti.measured_matball(tb),
                  "neural-disk": ti.neural_matball(tneural.make_neural_bsdf("disk", ModelConfig(), s.tv, s.tb, tb,
                                                                            device="cpu"))}
        one = {mode: ti.render_pass(ts_, mb, root_generator(RENDER_SEED, "cpu"), spp_chunk=4, max_depth=2)
               for mode, mb in tballs.items()}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks = _join(d, procs)
    return SimpleNamespace(d=d, ranks=ranks, one=one, jax_out=jax_out, params=params, batches=batches,
                           inputs=inputs)


# ---------------------------------------------------------------- helpers


def test_helpers_in_the_group_follow_jax(run):
    for r, (_, info) in enumerate(run.ranks):
        assert info["multi"] and info["init_again"] and (info["rank"], info["size"]) == (r, WORLD)
        for n in BATCH_SIZES:  # JAX `parallel/distributed.py:90-93`: per = n // count, (index * per, per)
            assert info["slices"][str(n)] == [r * (n // WORLD), n // WORLD]
        assert info["host_fold"] == [fold_in(s, r) for s in SEEDS]
    assert len({f for _, info in run.ranks for f in info["host_fold"]}) == WORLD * len(SEEDS)


@pytest.mark.parametrize("n, m", [(1, 1), (7, 2), (8, 2), (255, 4), (2**22 + 1, 8)])
def test_pad_to_multiple_matches_jax(n, m):
    assert parallel.pad_to_multiple(n, m) == j_pad_to_multiple(n, m)


def test_one_process_is_a_mesh_of_one(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.init_distributed() is False and not dist.is_initialized()
    assert all(parallel.host_fold(s) == s for s in SEEDS)
    assert parallel.global_batch_slice(1001) == (0, 1001)
    mesh = parallel.make_mesh(device_type="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device.type) == (None, 0, 1, "cpu")
    assert parallel.make_mesh(-1, device_type="cpu") == mesh
    with pytest.raises(ValueError, match="whole group"):
        parallel.make_mesh(2, device_type="cpu")
    assert parallel.shard_batch(mesh, (torch.arange(5),))[0].tolist() == list(range(5))
    assert set(parallel.__dict__) >= {"DATA_AXIS", "batch_sharding", "make_mesh", "pad_to_multiple", "replicate",
                                      "replicated_sharding", "shard_batch", "global_batch_slice", "host_fold",
                                      "init_distributed"}


def test_a_group_that_cannot_form_raises(monkeypatch):
    """No silent fallback to one process."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK"):
        parallel.init_distributed(world_size=2, device_type="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        parallel.init_distributed(device_type="cpu")
    assert not dist.is_initialized()


def test_a_group_on_the_card_without_one_raises(monkeypatch, tmp_path):
    """`init_distributed` runs the ranks on the card unless told otherwise,
    and never forms a CPU group in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init_distributed(init_method=f"file://{tmp_path / 'group'}", world_size=1, rank=0)
    assert not dist.is_initialized()


def test_a_wavefront_that_does_not_divide_raises(run):
    scene = tscene.load_scene(os.path.join(run.d, "scene_measured.xml"), device="cpu", width=W, height=H)
    mb = ti.measured_matball(tme.load_measured(os.path.join(run.d, "synthetic_rgb.bsdf"), device="cpu"))
    with pytest.raises(ValueError, match="do not divide"):
        ti.render_pass(scene, mb, root_generator(0, "cpu"), spp_chunk=4, max_depth=1,
                       mesh=Mesh(None, 0, 7, torch.device("cpu")))


# ----------------------------------------------------------------- render


@pytest.mark.parametrize("mode", ["gt", "neural-disk"])
def test_sharded_pass_matches_one_process(run, mode):
    img1, cnt1, _ = run.one[mode]
    (o0, i0), (o1, i1) = run.ranks
    np.testing.assert_array_equal(o0[f"render/{mode}/cnt"], cnt1.numpy())
    np.testing.assert_allclose(o0[f"render/{mode}/img"], img1.numpy(), rtol=1e-4, atol=1e-5)
    for key in ("img", "cnt"):  # every rank returns the whole film
        np.testing.assert_array_equal(o0[f"render/{mode}/{key}"], o1[f"render/{mode}/{key}"])
    assert float(img1.mean()) > 0 and not i0[f"truncated/{mode}"] and not i1[f"truncated/{mode}"]


@pytest.mark.parametrize("mode", ["gt"])
def test_sharded_bounce_matches_jax_mesh_bounce(run, mode):
    flips, bad, rows_seen, alive_seen = 0, np.zeros(7), np.zeros(7), []
    for depth in range(DEPTHS):
        key = f"bounce/{mode}/{depth}"
        jout = run.jax_out[key]
        tout = [np.concatenate([o[f"{key}/out{i}"] for o, _ in run.ranks]) for i in range(7)]
        n = jout[0].shape[0]
        ja, ta = jout[5], tout[5]
        flips += int((ja != ta).sum())
        for i in (0, 1, 3, 4, 6):  # ro, rd, L, beta, prev_pdf
            a, b = tout[i].reshape(n, -1), jout[i].reshape(n, -1)
            rows = (ja == ta) & (ja if i != 3 else True)  # L counts on every ray
            bad[i] += (rows & ~np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1)).sum()
            rows_seen[i] += rows.sum()
        np.testing.assert_array_equal(tout[2], jout[2])  # the pixel of each ray
        alive_seen.append(int(ja.sum()))
        assert not any(info[f"truncated/{key}"] for _, info in run.ranks)
    assert flips <= MAX_DISCRETE * DEPTHS * n
    assert (bad <= (1.0 - MIN_CONTINUOUS) * rows_seen).all(), (bad, rows_seen)
    assert alive_seen[0] > n // 3 and alive_seen[1] > 0


# ------------------------------------------------------ collective audit


def test_collective_audit(run):
    for _, info in run.ranks:
        assert info["bounce_collectives"] == 0
        for mode, c in info["pass_collectives"].items():
            assert c["total"] == 1 and c["all_reduce"] >= 1, (mode, c)
        assert info["step_collectives"] == {"pretrain": 1, "diffusion": 1, "rectify": 1}
        steps = TRAIN_CFG["iters_pretrain"] + TRAIN_CFG["iters_diffusion"] + TRAIN_CFG["iters_rectify"]
        assert info["train_collectives"] == {"all_reduce": steps, "broadcast": 6, "barrier": 0}


# -------------------------------------------------------------- training


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("stage", ["pretrain", "diffusion", "rectify"])
def test_data_parallel_step_matches_one_process(run, stage):
    state = step_state(run.params[stage], stage)
    loss = step_of(stage).update(state, tuple(torch.from_numpy(x).double() for x in run.batches[stage]))
    (o0, i0), (o1, i1) = run.ranks
    assert abs(i0[f"step/{stage}/loss"] - float(loss)) <= 1e-6 * abs(float(loss))
    assert i0[f"step/{stage}/loss"] == i1[f"step/{stage}/loss"]
    for (k, value), p in zip(t_ckpt._flatten(state.params), t_ckpt.tree_leaves(state.params)):
        for kind, want in (("params", value), ("mu", state.optimizer.state[p]["exp_avg"].numpy()),
                           ("nu", state.optimizer.state[p]["exp_avg_sq"].numpy())):
            got = o0[f"step/{stage}/{kind}{k}"]
            np.testing.assert_array_equal(got, o1[f"step/{stage}/{kind}{k}"])  # the ranks agree to the bit
            assert _rel(got, want) <= 1e-6, (kind, k, _rel(got, want))


@pytest.mark.parametrize("stage", ["pretrain", "diffusion", "rectify"])
def test_data_parallel_float32_gradient_matches_one_process(run, stage):
    params = params_from_jax(run.params[stage], "cpu")
    if stage == "pretrain":
        params["pe_bands"] = 3
    state = stages.init_state(params, STEP_LR[stage])
    loss = step_of(stage).update(state, tuple(torch.from_numpy(x) for x in run.batches[stage]))
    (o0, i0), (o1, i1) = run.ranks
    assert abs(i0[f"step32/{stage}/loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    for (k, _), p in zip(t_ckpt._flatten(state.params), t_ckpt.tree_leaves(state.params)):
        got, want = o0[f"step32/{stage}/grad{k}"], p.grad.numpy()
        np.testing.assert_array_equal(got, o1[f"step32/{stage}/grad{k}"])
        assert got.dtype == np.float32 and _rel(got, want) <= 1e-5, (k, _rel(got, want))


def test_replicate_keeps_each_dtype(run):
    want = {"['f64']": np.array([1.0 + 2.0**-40, np.pi]), "['i64']": np.array([2**53 + 1, -3]),
            "['f32'][0]": np.full((2, 3), 0.1, np.float32)}
    for o, _ in run.ranks:
        for k, v in want.items():
            assert o[f"replicate{k}"].dtype == v.dtype
            np.testing.assert_array_equal(o[f"replicate{k}"], v)


def test_a_resume_only_rank_0_can_read(run):
    """Rank 0 decides the step: both ranks run the iterations left after
    its file's, and end bit-equal."""
    (o0, i0), (o1, i1) = run.ranks
    for info in (i0, i1):
        r = info["resume"]
        assert r["collectives"] == {"all_reduce": RESUME_ITERS - RESUME_AT, "broadcast": 2, "barrier": 0}
        assert r["step"] == RESUME_ITERS and r["adam_counts"] == [float(RESUME_ITERS)]
    assert f"[resume] resumed at step {RESUME_AT}" in i0["resume"]["logs"] and i1["resume"]["logs"] == []
    assert not os.path.exists(os.path.join(run.d, "resume_rank1"))
    keys = [k for k in o0 if k.startswith("resume")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(o0[k], o1[k])


def test_data_parallel_train_material_ranks_agree(run):
    (o0, i0), (o1, i1) = run.ranks
    keys = [k for k in o0 if k.startswith("train")]
    assert {k.split("]")[0] for k in keys} == {"train['base'", "train['diffusion'", "train['teacher'",
                                               "train['rectified'"}
    for k in keys:
        np.testing.assert_array_equal(o0[k], o1[k])
        assert np.isfinite(o0[k]).all()
    losses = [float(s.split("loss ")[1].split()[0]) for s in i0["train_logs"] if " loss " in s]
    assert losses and all(np.isfinite(losses)) and i1["train_logs"] == []  # only rank 0 logs


def test_stage_files_of_two_ranks_load_and_resume_in_one_process(run):
    ckdir = os.path.join(run.d, "train")
    assert sorted(f for f in os.listdir(ckdir) if f.endswith(".npz")) == ["diffusion_simpler.npz", "pretrain.npz",
                                                                          "rectify.npz"]
    o0, _ = run.ranks[0]
    # the port's loader
    tree, step = t_ckpt.load_pytree(os.path.join(ckdir, "rectify.npz"))
    assert step == TRAIN_CFG["iters_rectify"] and int(tree["opt_state"][0]["count"]) == step
    for (k, v) in t_ckpt._flatten(tree["params"]):
        np.testing.assert_array_equal(v, o0[f"train['rectified']{k}"])
    # JAX's load_pytree with a TrainState template
    jp = j_get_base("disk").init(jax.random.key(0))
    loaded, step = j_ckpt.load_pytree(os.path.join(ckdir, "pretrain.npz"),
                                      JTrainState(jp, optax.adam(1e-3).init(jp), jnp.asarray(0, jnp.int32)))
    assert step == TRAIN_CFG["iters_pretrain"] and int(loaded.opt_state[0].count) == step
    np.testing.assert_array_equal(np.asarray(loaded.params["net"][0]["w"]), o0["train['base']['net'][0]['w']"])
    # one process resumes every stage and takes one more rectify step
    logs = []
    cfg = TrainConfig(**{**TRAIN_CFG, "iters_rectify": TRAIN_CFG["iters_rectify"] + 1, "checkpoint_dir": ckdir})
    params = stages.train_material(run.inputs["train_dataset"], ModelConfig(), cfg, log_fn=logs.append, device="cpu")
    for stage, at in (("pretrain", TRAIN_CFG["iters_pretrain"]), ("diffusion-simpler", TRAIN_CFG["iters_diffusion"]),
                      ("rectify", TRAIN_CFG["iters_rectify"])):
        assert any(f"[{stage}/disk] resumed at step {at}" in s for s in logs), (stage, logs)
    np.testing.assert_array_equal(params["base"]["net"][1]["b"].numpy(), o0["train['base']['net'][1]['b']"])
    assert t_ckpt.load_pytree(os.path.join(ckdir, "rectify.npz"))[1] == TRAIN_CFG["iters_rectify"] + 1


# ------------------------------------------------------------- row offset


@pytest.mark.parametrize("row0", [1, 37, 2**16 + 3])
def test_plain_draws_at_a_row_offset_are_the_slice(row0):
    n, m = row0 + 100, 100
    np.testing.assert_array_equal(fo.philox_normals(9, m, row0).numpy(), fo.philox_normals(9, n).numpy()[row0:])
    eps, u = fo.philox_spherical_draws(9, n)
    eps_r, u_r = fo.philox_spherical_draws(9, m, row0)
    np.testing.assert_array_equal(eps_r.numpy(), eps.numpy()[row0:])
    np.testing.assert_array_equal(u_r.numpy(), u.numpy()[..., row0:])


def test_k1_seed_route_at_a_row_offset_on_the_cpu():
    s = disk_setup(n=64, seed=2)
    w = fo.prepack_disk(s.tv, s.tb)
    x, pdf, x0 = fo.fused_sample_pdf_disk(w, s.t_cond, 4, seed=77)
    xs, pdfs, x0s = fo.fused_sample_pdf_disk(w, s.t_cond[40:], 4, seed=torch.tensor([77]), row0=40)
    np.testing.assert_allclose(x0s.numpy(), x0[40:].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(xs.numpy(), x[40:].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pdfs.numpy(), pdf[40:].numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="row0"):
        fo.fused_sample_pdf_disk(w, s.t_cond, 4, seed=77, row0=-1)
