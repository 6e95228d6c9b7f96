"""The port's training stages (`train/stages.py`), stage files
(`train/checkpoint.py`) and CLIs (`cli/train.py`,
`cli/assemble_checkpoint.py`) against the JAX package's.

- One Adam step a stage, from the same params and grads, equals
  `optax.adam`'s update to 1e-6 (float32 rounding of the same formula).
- Rectify's pair transport equals JAX's `ode/flow.py::ode_sample_only` at
  T = 32 from the same x0 and omega_i, to 1e-5.
- A stage killed mid-run resumes at its last save and ends bit-identical
  to an uninterrupted run (tests/test_train.py:130).
- Stage files cross between the packages: the JAX `TrainState` written by
  JAX's `save_pytree` resumes in the port, and a port stage file loads in
  JAX's `load_pytree` with a `TrainState` template.
- A tiny CPU `train_material` (disk; sphere_full with its 6 x 64 teacher)
  and `cli/train.py --device cpu` followed by both packages'
  `assemble_checkpoint`. JAX's own `train_material` is not run: its jitted
  stages take minutes on the CPU.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bsdf_diffusion_sampling_tpu.cli import assemble_checkpoint as j_assemble
from bsdf_diffusion_sampling_tpu.core.config import ModelConfig as JModelConfig
from bsdf_diffusion_sampling_tpu.models import get_base as j_get_base
from bsdf_diffusion_sampling_tpu.models.velocity import encode_condition as j_encode, velocity_init as j_velocity_init
from bsdf_diffusion_sampling_tpu.ode.flow import ode_sample_only
from bsdf_diffusion_sampling_tpu.train import checkpoint as j_ckpt
from bsdf_diffusion_sampling_tpu.train.stages import TrainState as JTrainState
from bsdf_diffusion_sampling_tpu_torch.cli import assemble_checkpoint as t_assemble
from bsdf_diffusion_sampling_tpu_torch.cli import train as t_train_cli
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, TrainConfig
from bsdf_diffusion_sampling_tpu_torch.core.prng import root_generator
from bsdf_diffusion_sampling_tpu_torch.data.datasets import generate_brdf_dataset
from bsdf_diffusion_sampling_tpu_torch.bsdf.analytic import ggx_shading_disk
from bsdf_diffusion_sampling_tpu_torch.interop.jax_params import params_from_jax
from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import prepack_velocity
from bsdf_diffusion_sampling_tpu_torch.train import checkpoint as t_ckpt
from bsdf_diffusion_sampling_tpu_torch.train import stages as ts

LR = {"pretrain": TrainConfig().lr_pretrain, "diffusion": TrainConfig().lr_diffusion,
      "rectify": TrainConfig().lr_rectify}


def _jax_params(stage):
    if stage == "pretrain":
        return j_get_base("disk").init(jax.random.key(0))
    return j_velocity_init(jax.random.key(1), JModelConfig(domain="disk"))


def _grads(tree, rng):
    return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), tree)


def _set_grads(state, jgrads):
    """Each parameter's grad from the JAX tree, matched by key path."""
    grads = {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for key, p in zip((k for k, _ in t_ckpt._flatten(state.params)), t_ckpt.tree_leaves(state.params)):
        p.grad = torch.from_numpy(np.array(grads[key]))


def _assert_tree_close(port_tree, jax_tree, **tol):
    got = dict(t_ckpt._flatten(port_tree))
    want = {jax.tree_util.keystr(p): np.asarray(w) for p, w in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _adam_steps(stage, n, rng):
    """n optax.adam steps and n port steps from the same params and grads."""
    jp = _jax_params(stage)
    tx = optax.adam(LR[stage])
    jstate = JTrainState(jp, tx.init(jp), jnp.asarray(0, jnp.int32))
    state = ts.init_state(params_from_jax(jp, "cpu"), LR[stage])
    for _ in range(n):
        g = _grads(jp, rng)
        updates, opt = tx.update(g, jstate.opt_state, jstate.params)
        jstate = JTrainState(optax.apply_updates(jstate.params, updates), opt, jstate.step + 1)
        _set_grads(state, g)
        state.optimizer.step()
        state.step += 1
    return jstate, state


@pytest.mark.parametrize("stage", ["pretrain", "diffusion", "rectify"])
def test_adam_step_matches_optax(stage):
    rng = np.random.default_rng(0)
    jstate, state = _adam_steps(stage, 1, rng)
    _assert_tree_close(t_ckpt.tree_map(lambda t: t.detach(), state.params), jstate.params, atol=1e-6, rtol=0)
    jstate2, state2 = _adam_steps(stage, 3, np.random.default_rng(1))  # bias correction past count 1
    _assert_tree_close(t_ckpt.tree_map(lambda t: t.detach(), state2.params), jstate2.params, atol=1e-6, rtol=0)


@pytest.mark.parametrize("domain, hidden, layers", [("disk", 32, 3), ("sphere_full", 64, 6)])
def test_pairgen_transport_matches_jax(domain, hidden, layers):
    cfg = ModelConfig(domain=domain, velocity_hidden=hidden, velocity_layers=layers)
    jcfg = JModelConfig(domain=domain, velocity_hidden=hidden, velocity_layers=layers)
    # weights of variance 1.5^2 / fan-in, which move x by O(1) at any depth
    jv = jax.tree.map(lambda w: w * 1.5 * math.sqrt(3.0), j_velocity_init(jax.random.key(2), jcfg))
    jb = j_get_base(domain).init(jax.random.key(3))
    pairgen = ts.make_rectify_pairgen(domain, cfg, 32)
    x0, x1, wi = pairgen(prepack_velocity(params_from_jax(jv, "cpu")), params_from_jax(jb, "cpu"),
                         root_generator(4, "cpu"), 4, 64)
    assert x0.shape == x1.shape == wi.shape == (256, 2)
    blocks = wi.reshape(4, 64, 2)
    assert torch.equal(blocks, blocks[:, :1].expand(4, 64, 2))  # omega_i in blocks of n_per_wi
    if domain != "disk":
        assert bool(((wi[:, 0] >= 0) & (wi[:, 0] < math.pi)).all())
    want = ode_sample_only(domain, jv, jnp.asarray(x0.numpy()), j_encode(jnp.asarray(wi.numpy()), jcfg), 32)
    np.testing.assert_allclose(x1.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert float((x1 - x0).abs().max()) > 0.5  # the transport moved the points


def test_midstage_crash_resumes_at_saved_step(tmp_path):
    """A stage killed at iteration 17 resumes at its last save (15) and
    ends bit-identical to an uninterrupted run."""

    def fresh():
        return ts.init_state({"w": torch.ones(4)}, 0.1)

    def make_step(crash_at=None):
        def step_call(state, gen, it):
            if it == crash_at:
                raise RuntimeError("simulated crash")
            loss = (state.params["w"] * torch.randn(4, generator=gen)).sum()
            state.optimizer.zero_grad()
            loss.backward()
            state.optimizer.step()
            state.step += 1
            return loss.detach()
        return step_call

    iters, save_every, path = 23, 5, str(tmp_path / "stage.npz")
    common = dict(iters=iters, seed=11, device="cpu", log_every=0, save_every=save_every)
    oracle = ts.run_stage(name="oracle", state=fresh(), step_call=make_step(), log_fn=lambda s: None, **common)
    with pytest.raises(RuntimeError):
        ts.run_stage(name="crashy", state=fresh(), step_call=make_step(crash_at=17), checkpoint_path=path,
                     log_fn=lambda s: None, **common)
    assert t_ckpt.load_pytree(path)[1] == 15
    logs = []
    resumed = ts.run_stage(name="resume", state=fresh(), step_call=make_step(), checkpoint_path=path,
                           log_fn=logs.append, **common)
    assert any("resumed at step 15" in s for s in logs), logs
    assert resumed.step == oracle.step == iters
    assert torch.equal(resumed.params["w"], oracle.params["w"])
    assert t_ckpt.load_pytree(path)[1] == iters


def test_jax_stage_file_resumes_in_port(tmp_path):
    rng = np.random.default_rng(5)
    jstate, _ = _adam_steps("diffusion", 3, rng)
    path = str(tmp_path / "diffusion_simpler.npz")
    j_ckpt.save_pytree(path, jstate, step=3)
    state = ts.init_state(params_from_jax(_jax_params("diffusion"), "cpu"), LR["diffusion"])
    assert t_ckpt.load_train_state(path, state.params, state.optimizer) == 3
    _assert_tree_close(t_ckpt.tree_map(lambda t: t.detach(), state.params), jstate.params, atol=0, rtol=0)
    # the next step agrees with optax's from the loaded Adam state
    g = _grads(jstate.params, rng)
    tx = optax.adam(LR["diffusion"])
    updates, _ = tx.update(g, jstate.opt_state, jstate.params)
    _set_grads(state, g)
    state.optimizer.step()
    _assert_tree_close(t_ckpt.tree_map(lambda t: t.detach(), state.params),
                       optax.apply_updates(jstate.params, updates), atol=1e-6, rtol=0)


def test_port_stage_file_loads_in_jax(tmp_path):
    jstate, state = _adam_steps("pretrain", 2, np.random.default_rng(6))
    path = str(tmp_path / "pretrain.npz")
    t_ckpt.save_train_state(path, state.params, state.optimizer, step=2)
    jp = _jax_params("pretrain")
    tmpl = JTrainState(jp, optax.adam(1e-3).init(jp), jnp.asarray(0, jnp.int32))
    loaded, step = j_ckpt.load_pytree(path, tmpl)
    assert step == 2 and int(loaded.step) == 2 and int(loaded.opt_state[0].count) == 2
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6, rtol=1e-5)


def _tiny_dataset(domain):
    if domain == "disk":
        pdf = lambda wi, wo: ggx_shading_disk(wi, wo, roughness=0.5)  # noqa: E731
    else:
        pdf = lambda wi, wo: torch.sin(wo[:, 0]) * (1.5 + torch.cos(wi[:, 0] - wo[:, 0]))  # noqa: E731
    return generate_brdf_dataset(0, pdf, domain=domain, nsteps=100, nwalkers=50, piecewise=2, burn_in=50,
                                 device="cpu")


@pytest.mark.parametrize("domain", ["disk", "sphere_full"])
def test_tiny_train_material_on_cpu(domain, tmp_path):
    if domain == "disk":
        cfg, teacher_cfg = ModelConfig(domain="disk"), None
    else:
        cfg = ModelConfig(domain=domain, velocity_hidden=32, velocity_layers=4)
        teacher_cfg = ModelConfig(domain=domain, velocity_hidden=64, velocity_layers=6)
    tcfg = TrainConfig(batch_pretrain=1024, iters_pretrain=10, batch_diffusion=1024, iters_diffusion=10,
                       iters_rectify=3, timestep_rectify=8, num_samples_rectify=64, batch_wi_rectify=4,
                       save_every=4, log_every=3, seed=1, checkpoint_dir=str(tmp_path))
    logs, stats = [], {}
    params = ts.train_material(_tiny_dataset(domain), cfg, tcfg, teacher_cfg=teacher_cfg, log_fn=logs.append,
                               device="cpu", stats=stats)
    assert sorted(params) == ["base", "diffusion", "rectified", "teacher"]
    assert params["base"]["net"][0]["w"].shape == (14, 16)
    assert [l["w"].shape[1] for l in params["teacher"]] == ([32] * 3 if domain == "disk" else [64] * 6) + [2]
    for t in t_ckpt.tree_leaves(params):
        assert bool(torch.isfinite(t).all()) and not t.requires_grad
    assert not torch.equal(params["rectified"][0]["w"], params["diffusion"][0]["w"])
    if domain == "disk":  # self-distilled: the teacher is the student
        assert params["teacher"] is params["diffusion"]
    stages = [f"pretrain/{domain}", f"diffusion-simpler/{domain}", f"rectify/{domain}"]
    stages += [f"diffusion-complex/{domain}"] if teacher_cfg else []
    assert sorted(stats) == sorted(stages)
    assert [stats[s]["iters"] for s in stages[:3]] == [10, 10, 3]
    losses = [float(s.split("loss ")[1].split()[0]) for s in logs if " loss " in s]
    assert losses and all(math.isfinite(v) for v in losses)
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(["pretrain.npz", "diffusion_simpler.npz", "rectify.npz"]
                           + (["diffusion_complex.npz"] if teacher_cfg else []))


def test_train_cli_then_both_assemblers(tmp_path, capsys):
    out = str(tmp_path / "run")
    argv = ["--domain", "disk", "--material", "ggx:0.5", "--device", "cpu", "--out", out, "--mcmc-bands", "2",
            "--mcmc-steps", "100", "--mcmc-burnin", "50", "--batch-pretrain", "1024", "--iters-pretrain", "6",
            "--batch-diffusion", "1024", "--iters-diffusion", "6", "--iters-rectify", "3", "--timestep-rectify",
            "8", "--num-samples-rectify", "64", "--batch-wi-rectify", "4", "--save-every", "2", "--log-every", "2"]
    params, stats = t_train_cli.main(argv)
    assert os.path.exists(os.path.join(out, "mcmc_disk_ggx_0.5.npy"))
    final, step = t_ckpt.load_pytree(os.path.join(out, "final.npz"))
    assert step == 3 and stats["rectify/disk"]["iters"] == 3
    # a second call with one more rectify iteration resumes every stage
    t_train_cli.main([a if a != "3" else "4" for a in argv])
    text = capsys.readouterr().out
    for name, at in (("pretrain", 6), ("diffusion-simpler", 6), ("rectify", 3)):
        assert f"[{name}/disk] resumed at step {at}" in text
    assert "[rectify/disk] step 3/4" in text and "[pretrain/disk] step" not in text.split("resumed at step 6")[-1]
    final, step = t_ckpt.load_pytree(os.path.join(out, "final.npz"))
    assert step == 4
    t_assemble.main(["--dir", out, "--out", "port.npz"])
    j_assemble.main(["--dir", out, "--out", "jax.npz"])
    port_tree, _ = t_ckpt.load_pytree(os.path.join(out, "port.npz"))
    jax_tree, _ = t_ckpt.load_pytree(os.path.join(out, "jax.npz"))
    for tree in (port_tree, jax_tree):
        got, want = dict(t_ckpt._flatten(tree)), dict(t_ckpt._flatten(final))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_port_assembler_reads_jax_stage_files(tmp_path):
    jb = j_get_base("disk").init(jax.random.key(0))
    jv = j_velocity_init(jax.random.key(1), JModelConfig(domain="disk"))
    jr = jax.tree.map(lambda w: w * 2.0, jv)
    for name, p in (("pretrain.npz", jb), ("diffusion_simpler.npz", jv), ("rectify.npz", jr)):
        j_ckpt.save_pytree(str(tmp_path / name), JTrainState(p, optax.adam(1e-3).init(p), jnp.asarray(7, jnp.int32)),
                           step=7)
    t_assemble.main(["--dir", str(tmp_path)])
    tree, _ = t_ckpt.load_pytree(str(tmp_path / "final.npz"))
    _assert_tree_close(tree, {"base": jb, "diffusion": jv, "teacher": jv, "rectified": jr}, atol=0, rtol=0)
    with pytest.raises(ValueError, match="velocity net over 25 inputs"):
        t_assemble.main(["--dir", str(tmp_path), "--domain", "spherical"])
