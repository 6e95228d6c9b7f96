"""The port's spans and counters (`core/trace.py`): off without a profiler
(one flag check, the shared no-op, nothing recorded), and under a CPU
`torch.profiler.profile` the span tree of a small `render()` and of two
rectify iterations, the row counters, the caller's stage marks, and the
records on the Chrome trace's clock."""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import json
import os
import time
import tracemalloc
import types
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured
from bsdf_diffusion_sampling_tpu_torch.core import trace
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu_torch.core.prng import root_generator
from bsdf_diffusion_sampling_tpu_torch.models.base_density import get_base
from bsdf_diffusion_sampling_tpu_torch.models.velocity import velocity_init
from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import prepack_velocity
from bsdf_diffusion_sampling_tpu_torch.render import integrator, procedural
from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf
from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene
from bsdf_diffusion_sampling_tpu_torch.train import stages

STAGES = ["closest_hit", "env_hit_and_surface", "nee_env_sample", "nee_eval_pdf", "nee_shadow", "nee_lights",
          "bsdf_sample", "bsdf_eval_pdf", "update"]
W, H, SPP, CHUNK, DEPTH = 8, 6, 4, 2, 3


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_ring():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trace"))
    xml = procedural.write_scene(d, n_lat=8, n_lon=12, plane_g=2, env_res=(16, 32), width=W, height=H)
    scene = load_scene(xml, device="cpu", width=W, height=H)
    brdf = load_measured(os.path.join(d, "synthetic_rgb.bsdf"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    cfg = ModelConfig()
    nb = make_neural_bsdf("disk", cfg, velocity_init(gen, cfg), get_base("disk").init(gen), brdf, device="cpu")
    return scene, integrator.neural_matball(nb)


def _boom(*args, **kwargs):
    raise AssertionError("called on the off path")


def test_off_path_records_nothing(monkeypatch):
    """With no profiler: the shared no-op, no torch call, no clock read, no
    device sync, nothing recorded or counted, nothing left allocated."""
    assert not trace.enabled()
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(torch.cuda, "synchronize", _boom)
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(time_ns=_boom))
    value = torch.ones((), dtype=torch.int64)
    monkeypatch.setattr(value, "add_", _boom)
    assert trace.span("render") is trace.span("render.bounce", depth=3) is trace.stage("bounce.update") is trace._NOOP
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(10_000):
            with trace.span("render.bounce", depth=1):
                with trace.stage("bounce.closest_hit"):
                    trace.count("rows.bounce_in", 4)
                    trace.count("rows.alive_in", value)
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before < 1024  # nothing accumulates over 10,000 spans
    snap = trace.snapshot()
    assert snap.spans == [] and snap.counters == {}


def test_render_records_the_span_tree(world, monkeypatch):
    scene, mb = world
    kw = dict(seed=3, spp=SPP, spp_chunk=CHUNK, max_depth=DEPTH, device="cpu")
    plain = integrator.render(scene, mb, **kw)
    alive_in = []
    body = integrator._bounce_body

    def counted(accel, env, lights, state, rnd, depth, *, matball, mark=None):
        alive_in.append(int(state[5].sum()))
        return body(accel, env, lights, state, rnd, depth, matball=matball, mark=mark)

    monkeypatch.setattr(integrator, "_bounce_body", counted)
    with cpu_profile():
        traced = integrator.render(scene, mb, **kw)
    np.testing.assert_array_equal(traced, plain)  # spans and counters change no output

    spans = trace.snapshot().spans
    by_index = {s.index: s for s in spans}
    root = spans[0]
    assert root.name == "render" and root.parent == -1
    assert {s.root for s in spans} == {root.index}  # one call id
    children = {}
    for s in spans[1:]:
        children.setdefault(s.parent, []).append(s)
        outer = by_index[s.parent]
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    passes = SPP // CHUNK
    assert [s.name for s in children[root.index]] == ["render.pass"] * passes + ["render.finish"]
    for p in children[root.index][:passes]:
        names = [s.name for s in children[p.index]]
        assert names == ["render.camera"] + ["render.bounce"] * DEPTH + ["render.film"]
        for depth, b in enumerate(children[p.index][1:1 + DEPTH]):
            assert b.attrs == {"depth": depth}
            assert [s.name for s in children[b.index]] == ["bounce." + n for n in STAGES]
            sample = children[b.index][STAGES.index("bsdf_sample")]
            assert [s.name for s in children[sample.index]] == ["sampler.draw"]
    counters = trace.snapshot().counters
    assert counters["rows.bounce_in"] == passes * DEPTH * W * H * CHUNK
    assert counters["rows.alive_in"] == sum(alive_in) and len(alive_in) == passes * DEPTH
    table = trace.summary()["spans"]
    assert table["render.bounce"]["count"] == passes * DEPTH
    assert table["bounce.update"]["count"] == passes * DEPTH


@pytest.mark.parametrize("traced", [False, True])
def test_callers_mark_gets_the_nine_stages(world, traced):
    scene, mb = world
    gen = root_generator(5, "cpu")
    n = W * H
    state = integrator._init_wavefront(scene.camera.vectors, torch.rand((n, 2), generator=gen), width=W, height=H,
                                       spp_chunk=1)
    rnd = integrator.draw_bounce(gen, n, (mb,))
    marks = []
    with cpu_profile() if traced else torch.no_grad():
        integrator._bounce_body(scene.accel, scene.envmap, scene.lights, state, rnd, 0, matball=(mb,),
                                mark=marks.append)
    assert marks == STAGES
    stage_spans = [s.name for s in trace.snapshot().spans if s.name.startswith("bounce.")]
    assert stage_spans == (["bounce." + n for n in STAGES] if traced else [])


def test_rectify_iterations_record_pairgen_and_update(tmp_path):
    domain, cfg = "disk", ModelConfig()
    gen = torch.Generator().manual_seed(1)
    base = get_base(domain).init(gen)
    teacher = prepack_velocity(velocity_init(gen, cfg))
    pairgen = stages.make_rectify_pairgen(domain, cfg, 4)
    step = stages.make_rectify_step(domain, cfg)

    def step_call(state, g, it):
        x0, x1, wi = pairgen(teacher, base, g, 2, 8)
        return step.update(state, step.draw(x0, x1, wi, g), None)

    state = stages.init_state(velocity_init(gen, cfg), 1e-3)
    with cpu_profile():
        stages.run_stage(name="rectify", state=state, step_call=step_call, iters=2, seed=7, device="cpu",
                         checkpoint_path=str(tmp_path / "rectify.npz"), save_every=1, log_every=1,
                         log_fn=lambda s: None)
    spans = trace.snapshot().spans
    iterations = [s for s in spans if s.name == "train.iteration"]
    assert [s.attrs for s in iterations] == [{"step": 0}, {"step": 1}]
    assert all(s.parent == -1 and s.root == s.index for s in iterations)
    for it in iterations:
        names = [s.name for s in spans if s.parent == it.index]
        assert names[:3] == ["rectify.pairgen", "rectify.update", "rectify.update"]  # pairgen, draw, update
    assert [s.name for s in spans if s.parent == iterations[0].index][3:] == ["train.checkpoint"]
    assert [s.name for s in spans if s.parent == iterations[1].index][3:] == ["train.log_wait"]
    assert [s.name for s in spans if s.parent == -1][2:] == ["train.log_wait", "train.checkpoint"]


def test_records_share_the_chrome_traces_clock(tmp_path):
    with cpu_profile() as prof:
        with trace.span("probe"):
            time.sleep(0.005)
    rec = [s for s in trace.snapshot().spans if s.name == "probe"][0]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    ev = [e for e in doc["traceEvents"] if e.get("cat") == "user_annotation" and e.get("name") == "probe"][0]
    base = int(doc["baseTimeNanoseconds"])
    start_ns = base + ev["ts"] * 1e3
    assert abs(start_ns - rec.start_ns) < 1e6
    assert abs(start_ns + ev["dur"] * 1e3 - rec.end_ns) < 1e6


def test_summary_self_time_and_the_ring_bound(monkeypatch):
    monkeypatch.setattr(trace, "_ring", deque(maxlen=4))
    with cpu_profile():
        with trace.span("outer"):
            for _ in range(2):
                with trace.span("inner"):
                    time.sleep(0.001)
        for _ in range(3):
            with trace.span("after"):
                pass
    spans = trace.snapshot().spans
    assert [s.name for s in spans] == ["outer", "after", "after", "after"]  # the oldest records went first
    monkeypatch.setattr(trace, "_ring", deque(maxlen=trace.CAPACITY))
    with cpu_profile():
        with trace.span("outer"):
            for _ in range(2):
                with trace.span("inner"):
                    time.sleep(0.001)
        trace.count("rows", 3)
        trace.count("rows", torch.tensor(4))
    table = trace.summary()
    outer, inner = table["spans"]["outer"], table["spans"]["inner"]
    assert inner["count"] == 2 and inner["total_ms"] >= 2.0
    assert outer["self_ms"] == pytest.approx(outer["total_ms"] - inner["total_ms"])
    assert table["counters"] == {"rows": 7}
