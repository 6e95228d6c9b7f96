"""The envmap's and the measured BRDF's entry points over the 2D warp's
kernels (`ops/warp2d.py`, `csrc/warp2d.cu`).

On the CPU (every case here):
- each public entry point of `render/envmap.py` and `bsdf/measured.py` is
  its plain version, bit for bit, on an envmap (one warp slice), an
  isotropic file (two theta_i slices) and an anisotropic one (four
  (phi_i, theta_i) slices), and launches nothing;
- the counters `rows.warp_env` and `rows.warp_brdf` add up the rows each
  call computes while a profiler records, and the benchmark's
  `warp_rows_per_row.render` reads them over a traced CPU render();
- the rows the card's gate leaves out (ties, directions near a pole) are
  few and the ones meant;
- the wrappers refuse a wrong dtype or shape, and CPU tensors.

On the card (marked `chip`, skipped without one; run there with
`python -m pytest --noconftest -m chip tests/test_torch_warp_kernel.py`):
- each kernel against its plain version at 2^20 rows with edge rows (u at
  0 and 1 - 2^-24, grazing wi, wo below the surface), over 1, 2 and 4
  slices, by `warp_checks.py`'s gaps (those of `chip_smoke.py`'s phase
  6b): 1e-5 on every row that is neither a binary-search tie nor
  ill-conditioned;
- no host sync (`torch.cuda.set_sync_debug_mode("error")`);
- `eval_lum` captured in a CUDA graph and replayed, as the MCMC sweep
  replays it.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bsdf_diffusion_sampling_tpu_torch.bsdf import measured as me
from bsdf_diffusion_sampling_tpu_torch.core import trace
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, SamplerConfig
from bsdf_diffusion_sampling_tpu_torch.ops import warp2d
from bsdf_diffusion_sampling_tpu_torch.render import envmap as em
from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti
from bsdf_diffusion_sampling_tpu_torch.render import procedural
from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf
from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene
import warp_checks as wc  # the cases and gaps chip_smoke.py's phase 6b holds the kernels to

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = os.path.join(ROOT, "port_bench", "metrics", "warp_rows_per_row.render.py")
N_CPU = 2048
N_CARD = 1 << 20
ENTRIES = ("sample_env", "eval_env", "pdf_env", "eval_brdf", "pdf_brdf", "eval_pdf_brdf", "eval_lum", "sample_brdf")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _brdf(kind: str, device):
    tf = procedural.synthetic_measured_tensors(3, vndf_res=(32, 48), lum_res=(16, 24), sigma_w=32,
                                               n_phi=4 if kind == "aniso" else 1)
    return me.measured_from_tensors(tf, name=kind, device=device)


def _env(device):
    return em.envmap_from_image(procedural.sky_envmap(32, 64)).to(device)


@pytest.fixture(autouse=True)
def empty_ring():
    trace.clear()
    yield
    trace.clear()


# --------------------------------------------------------------------- CPU


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("tables", ["env", "iso", "aniso"])
def test_cpu_entry_points_are_the_plain_chains(tables):
    env = _env("cpu") if tables == "env" else None
    brdf = None if tables == "env" else _brdf(tables, "cpu")
    u, wi, wo, d = wc.warp_inputs(N_CPU, 1, "cpu")
    warp2d.reset_launches()
    got, want = wc.warp_calls(env, brdf, u, wi, wo, d, False), wc.warp_calls(env, brdf, u, wi, wo, d, True)
    assert set(got) == set(want) and len(got) == (3 if env is not None else 5)
    for name in got:
        for a, b in zip(_flat(got[name]), _flat(want[name])):
            assert a.dtype == torch.float32 and torch.equal(a, b), name
    gaps = wc.warp_gaps(env, brdf, u, wi, wo, d)  # the card's yardstick, on the CPU: no gap
    assert all(g["max_gap"] == 0.0 and g["bit_equal_share"] == 1.0 for g in gaps.values()), gaps
    assert not any(warp2d.launches.values())


@pytest.mark.parametrize("tables", ["env", "iso", "aniso"])
def test_rows_left_out_of_the_gate_are_few_and_at_the_poles(tables):
    """The gate leaves out ties and ill-conditioned rows: each under 1% of
    the rows, and the ill-conditioned ones are those with a direction
    within WARP_POLE of its pole (the envmap's poles among the edge rows)."""
    env = _env("cpu") if tables == "env" else None
    brdf = None if tables == "env" else _brdf(tables, "cpu")
    u, wi, wo, d = wc.warp_inputs(N_CPU, 8, "cpu")
    want = wc.warp_calls(env, brdf, u, wi, wo, d, True)
    ties, ill = wc.warp_ties(env, brdf, u, wi, wo, d), wc.warp_ill_conditioned(env, brdf, wi, wo, d, want)
    assert set(ties) == set(ill) == set(want)
    for entry in want:
        assert float(ties[entry].double().mean()) < 1e-2 and float(ill[entry].double().mean()) < 1e-2, entry

    def band(w, axis):  # sin(theta) from the pole, in float64
        w = w.double()
        return torch.linalg.vector_norm(w[:, [i for i in range(3) if i != axis]], dim=-1) / w.norm(dim=-1)

    if env is not None:
        assert bool(ill["eval_env"][12:14].all())
        s_d, s_s = band(d @ env.to_local.T, 1), band(want["sample_env"][0] @ env.to_local.T, 1)
        for mask, s_ in ((ill["eval_env"], s_d), (ill["sample_env"], s_s)):
            assert bool((s_[mask] < 1.01 * wc.WARP_POLE).all()) and bool(mask[s_ < 0.99 * wc.WARP_POLE].all())
    else:
        s_i, s_h = band(wi, 2), band(wi + wo, 2)
        near = (s_i < 0.99 * wc.WARP_POLE) | (s_h < 0.99 * wc.WARP_POLE)
        far = (s_i > 1.01 * wc.WARP_POLE) & (s_h > 1.01 * wc.WARP_POLE)
        assert bool(ill["eval_brdf"][near].all()) and not bool(ill["eval_brdf"][far].any())
        assert not bool(ill["sample_brdf"][4:8].any())  # grazing wi is well-conditioned


def test_plain_chains_agree_between_entry_points():
    """What the kernels fuse is one function: eval_pdf_brdf's halves are
    eval_brdf and pdf_brdf, eval_lum is eval_brdf's luminance, and
    sample_env's radiance is eval_env at its direction."""
    env, brdf = _env("cpu"), _brdf("aniso", "cpu")
    u, wi, wo, d = wc.warp_inputs(N_CPU, 2, "cpu")
    f, pdf = me.eval_pdf_brdf(brdf, wi, wo)
    assert torch.equal(f, me.eval_brdf(brdf, wi, wo)) and torch.equal(pdf, me.pdf_brdf(brdf, wi, wo))
    assert torch.equal(me.eval_lum(brdf, wi, wo), me.rgb_to_luminance(f))
    assert bool((f[wo[:, 2] <= 0] == 0).all()) and bool((pdf[wo[:, 2] <= 0] == 0).all())
    d_s, rad, pdf_s = em.sample_env(env, u)
    assert torch.equal(rad, em.eval_env(env, d_s))
    # away from the edge rows, whose draws land on the poles
    torch.testing.assert_close(pdf_s[4:], em.pdf_env(env, d_s)[4:], rtol=2e-3, atol=1e-6)


def test_counters_add_the_rows_of_each_call():
    env, brdf = _env("cpu"), _brdf("iso", "cpu")
    u, wi, wo, d = wc.warp_inputs(N_CPU, 3, "cpu")
    wc.warp_calls(env, brdf, u, wi, wo, d, False)  # no profiler: nothing counted
    assert trace.snapshot().counters == {}
    with profile(activities=[ProfilerActivity.CPU]):
        wc.warp_calls(env, brdf, u[:100], wi[:100], wo[:100], d[:100], False)
        me.eval_brdf(brdf, wi[:1], wo[:7])  # broadcast rows count once each
        counters = trace.snapshot().counters
    assert counters == {"rows.warp_env": 3 * 100, "rows.warp_brdf": 5 * 100 + 7}


def _metric():
    return _load("warp_rows_per_row_render", METRIC)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("warp_scenes"))
    kw = dict(n_lat=12, n_lon=16, plane_g=3, env_res=(32, 64), width=16, height=16)
    measured = os.path.join(d, "measured")
    out = {"measured": load_scene(procedural.write_scene(measured, **kw), device="cpu", width=16, height=16),
           "table": load_scene(procedural.write_scene(os.path.join(d, "table"), table=procedural.TABLE, **kw),
                               device="cpu", width=16, height=16)}
    out["brdf"] = me.load_measured(os.path.join(measured, procedural.MATERIAL + ".bsdf"), device="cpu")
    return out


def _ball(mode: str, scenes):
    from port_bench.harness import weights
    from bsdf_diffusion_sampling_tpu_torch.bsdf.materials import BSDF_MATERIALS

    if mode == "gt":
        return ti.measured_matball(scenes["brdf"])
    if mode == "neural-disk":
        w = weights.make(5, {"base": ("base", None), "v": ("velocity", weights.velocity_dims(32, 3, 2))}, "cpu")
        return ti.neural_matball(make_neural_bsdf("disk", ModelConfig(), w["v"], {"net": w["base"]}, scenes["brdf"],
                                                  device="cpu"))
    cfg = ModelConfig(domain="sphere_full", velocity_hidden=32, velocity_layers=4)
    w = weights.make(5, {"base": ("base", None), "v": ("velocity", weights.velocity_dims(32, 4, 3))}, "cpu")
    nb = make_neural_bsdf("sphere_full", cfg, w["v"], {"net": w["base"]}, sampler_cfg=SamplerConfig(pdf_exact=True),
                          device="cpu")
    return ti.neural_matball_sphere(nb, BSDF_MATERIALS[procedural.TABLE[0]], procedural.TABLE[1])


@pytest.mark.parametrize("mode,scene,per_row", [("gt", "measured", 6), ("neural-disk", "measured", 5),
                                                ("neural-sphere", "table", 3)])
def test_metric_reads_the_warp_rows_of_a_traced_render(scenes, mode, scene, per_row):
    """The envmap's three calls a bounce, and the measured BRDF's two
    queries (and gt's own draw) on every row of the wavefront."""
    metric = _metric()
    assert metric.read(None) is None  # no counters: nothing read
    with profile(activities=[ProfilerActivity.CPU]):
        img = ti.render(scenes[scene], (_ball(mode, scenes),), seed=1, spp=2, spp_chunk=2, max_depth=2,
                        device="cpu")
        counters = trace.snapshot().counters
    assert np.isfinite(img).all()
    assert counters["rows.bounce_in"] == 2 * 16 * 16 * 2
    assert counters["rows.warp_env"] == 3 * counters["rows.bounce_in"]
    assert metric.read(None) == per_row


@pytest.mark.parametrize("entry", ENTRIES)
def test_wrappers_refuse_what_the_kernels_do_not_take(entry):
    env, brdf = _env("cpu"), _brdf("iso", "cpu")
    width = 2 if entry.startswith("sample") else 3
    fn = getattr(warp2d, entry)
    tables = env if entry.endswith("_env") else brdf

    def call(x):
        return fn(tables, x) if entry.endswith("_env") else fn(tables, x, torch.zeros(8, 3))

    with pytest.raises(ValueError, match="float32 rows"):
        call(torch.zeros(8, width, dtype=torch.float64))
    with pytest.raises(ValueError, match="float32 rows"):
        call(torch.zeros(8, width + 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(torch.zeros(8, width))
    assert not any(warp2d.launches.values())


# -------------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' 3x3 rotations in full fp32
    return torch.device("cuda", 0)


@pytest.mark.chip
@pytest.mark.parametrize("tables", ["env", "iso", "aniso"])
def test_kernels_match_the_plain_versions_on_the_card(tables):
    dev = _card()
    env = _env(dev) if tables == "env" else None
    brdf = None if tables == "env" else _brdf(tables, dev)
    u, wi, wo, d = wc.warp_inputs(N_CARD, 4, dev)
    warp2d.reset_launches()
    gaps = wc.warp_gaps(env, brdf, u, wi, wo, d)
    assert all(g["over_tol"] == 0 for g in gaps.values()), gaps
    assert all(g["tie_share"] < 1e-2 for g in gaps.values()), gaps
    assert {k: v for k, v in warp2d.launches.items() if v} == {k: 1 for k in gaps}


@pytest.mark.chip
def test_kernels_launch_without_a_host_sync():
    dev = _card()
    env, brdf = _env(dev), _brdf("aniso", dev)
    u, wi, wo, d = wc.warp_inputs(4096, 5, dev)
    wc.warp_calls(env, brdf, u, wi, wo, d, False)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wc.warp_calls(env, brdf, u, wi, wo, d, False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.chip
def test_eval_lum_replays_in_a_cuda_graph():
    dev = _card()
    brdf = _brdf("iso", dev)
    _, wi, wo, _ = wc.warp_inputs(1 << 16, 6, dev)
    _, wi2, wo2, _ = wc.warp_inputs(1 << 16, 7, dev)
    s_wi, s_wo = wi.clone(), wo.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        me.eval_lum(brdf, s_wi, s_wo)  # warm-up off the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = me.eval_lum(brdf, s_wi, s_wo)
    s_wi.copy_(wi2)
    s_wo.copy_(wo2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, me.eval_lum(brdf, wi2, wo2))
    assert wc.row_gap(out, me.eval_lum_plain(brdf, wi2, wo2), False).max() < 1e-3
