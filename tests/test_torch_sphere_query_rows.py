"""The full-sphere exact pdf query on only the rows that use it, in a
scene of one matball (`render/neural.py::neural_pdf`,
`render/integrator.py::_shade_eval_pdf`), at `sphere_table`'s widths (base
1 x 16, velocity 4 x 32, T = 8, exact pdf, 2 Newton iterations) from
seeded random weights, on the CPU (the routed K2s runs its plain version
there):

- `neural_pdf` queries only the rows whose wi is above the surface: it is
  the whole-row query on each of them, and 0 below;
- bounces and films of the one-ball exact scene equal the whole-wavefront
  dispatch (the `pdf` callback with neither the mask nor the routing), to
  1e-6, without a mesh, on a one-rank mesh and on the second half of a
  wavefront;
- a bounce calls the routed K2s twice and K4 once, and never the whole-row
  K2s (each call is one launch on the card; on the CPU the plain versions
  run and `ops.fused_ode.launches` stays 0);
- K3's pdf still transports the whole wavefront, and a measured-disk
  bounce is bit-equal to the dispatch without the mask;
- under a running profiler the counter `rows.routed_pdf` counts the NEE
  candidates and kept draws on the ball, and the benchmark's
  `sph_query_rows_pct.render` reads it over the wavefront's rows.
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bsdf_diffusion_sampling_tpu_torch.bsdf.materials import BSDF_MATERIALS
from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured
from bsdf_diffusion_sampling_tpu_torch.core import trace
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, SamplerConfig
from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import ROUTE_TILE
from bsdf_diffusion_sampling_tpu_torch.parallel.mesh import Mesh, make_mesh
from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti
from bsdf_diffusion_sampling_tpu_torch.render import neural, procedural
from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf
from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene
from port_bench.harness import weights

W = H = 24
CHUNK = 2
N = W * H * CHUNK
SCENE = dict(n_lat=12, n_lon=16, plane_g=3, env_res=(32, 64), width=W, height=H)
CFG = ModelConfig(domain="sphere_full", velocity_hidden=32, velocity_layers=4)
IDX, ALBEDO = procedural.TABLE
TOL = 1e-6
METRIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "port_bench", "metrics",
                      "sph_query_rows_pct.render.py")


def _nb(seed: int, exact: bool = True):
    w = weights.make(seed, {"base": ("base", None), "v": ("velocity", weights.velocity_dims(32, 4, 3))}, "cpu")
    return make_neural_bsdf("sphere_full", CFG, w["v"], {"net": w["base"]},
                            sampler_cfg=SamplerConfig(pdf_exact=exact), device="cpu")


def _ball(nb):
    return ti.neural_matball_sphere(nb, BSDF_MATERIALS[IDX], ALBEDO)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sphere_rows"))
    table = load_scene(procedural.write_scene(os.path.join(d, "table"), table=procedural.TABLE, **SCENE),
                       device="cpu", width=W, height=H)
    measured_dir = os.path.join(d, "measured")
    measured = load_scene(procedural.write_scene(measured_dir, **SCENE), device="cpu", width=W, height=H)
    brdf = load_measured(os.path.join(measured_dir, procedural.MATERIAL + ".bsdf"), device="cpu")
    nb = _nb(20241017)
    return {"table": table, "measured": measured, "brdf": brdf, "nb": nb, "ball": _ball(nb),
            "whole": _ball(nb._replace(stack=None))}


@pytest.fixture(autouse=True)
def empty_ring():
    trace.clear()
    yield
    trace.clear()


def _unmasked(monkeypatch):
    """The whole-wavefront dispatch: every `pdf` callback sees the true wi
    on every row."""
    orig = ti._shade_eval_pdf
    monkeypatch.setattr(ti, "_shade_eval_pdf", lambda *a, need=None: orig(*a))


def _bounces(scene, balls, gen_seed: int, n_bounces: int = 3, mesh=None):
    """The states after each of n bounces from one camera pass."""
    gen = torch.Generator().manual_seed(gen_seed)
    r0, m = (0, N) if mesh is None else mesh.block(N)
    u_cam = ti._uniform(gen, (N, 2), 1e-7, 1.0)
    state = tuple(x[r0:r0 + m] for x in ti._init_wavefront(scene.camera.vectors, u_cam, width=W, height=H,
                                                             spp_chunk=CHUNK))
    out = []
    for depth in range(n_bounces):
        rnd = ti.shard_randoms(ti.draw_bounce(gen, N, balls), r0, m)
        state, _ = ti._bounce_body(scene.accel, scene.envmap, scene.lights, state, rnd, depth, matball=balls)
        out.append(state)
    return out


def _assert_states_close(a, b):
    """Equal alive flags; radiance, throughput, MIS pdfs and the next rays
    to 1e-6 on the live rows."""
    for sa, sb in zip(a, b):
        alive = sa[5]
        assert torch.equal(alive, sb[5])
        for i, (x, y) in enumerate(zip(sa, sb)):
            if i != 5:
                torch.testing.assert_close(x[alive], y[alive], rtol=TOL, atol=TOL)


def test_pdf_is_the_whole_row_query_above_and_zero_below(world):
    gen = torch.Generator().manual_seed(1)
    n = 3000
    wi = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    wi[:20] = torch.nn.functional.normalize(wi[:20] * torch.tensor([1.0, 1.0, 0.0]), dim=-1)  # on the surface
    wo = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    nb = world["nb"]
    got = neural.neural_pdf(nb, wi, wo)
    want = neural.neural_pdf(nb._replace(stack=None), wi, wo)
    above = wi[:, 2] > 0
    assert n // 3 < int(above.sum()) < 2 * n // 3
    assert int((want[above] > 0).sum()) > n // 4
    torch.testing.assert_close(got[above], want[above], rtol=TOL, atol=TOL)
    assert torch.equal(got[~above], torch.zeros_like(got[~above]))


def test_query_takes_the_routed_k2s_on_the_rows_above(world, monkeypatch):
    """One routed K2s call over one group holding just the rows above the
    surface; no whole-row K2s."""
    calls = []

    def routed(sw, x, cond, tile_ball, T, **kw):
        calls.append((len(sw.packs), int((tile_ball >= 0).sum())))
        return orig(sw, x, cond, tile_ball, T, **kw)

    orig = neural.fused_pdf_spherical_routed
    monkeypatch.setattr(neural, "fused_pdf_spherical_routed", routed)
    monkeypatch.setattr(neural, "fused_pdf_spherical", None)
    gen = torch.Generator().manual_seed(2)
    wi = torch.nn.functional.normalize(torch.randn(1000, 3, generator=gen), dim=-1)
    wo = torch.nn.functional.normalize(torch.randn(1000, 3, generator=gen), dim=-1)
    neural.neural_pdf(world["nb"], wi, wo)
    assert calls == [(1, -(-int((wi[:, 2] > 0).sum()) // ROUTE_TILE))]


@pytest.mark.parametrize("shard", ["whole", "one-rank mesh", "second half"])
def test_bounces_match_whole_wavefront_dispatch(world, monkeypatch, shard):
    mesh = {"whole": None, "one-rank mesh": make_mesh(device_type="cpu"),
            "second half": Mesh(None, 1, 2, torch.device("cpu"))}[shard]
    got = _bounces(world["table"], (world["ball"],), 3, mesh=mesh)
    assert all(bool(s[5].any()) for s in got)
    _unmasked(monkeypatch)
    _assert_states_close(got, _bounces(world["table"], (world["whole"],), 3, mesh=mesh))


@pytest.mark.parametrize("mesh", [False, True])
def test_film_matches_whole_wavefront_dispatch(world, monkeypatch, mesh):
    kw = dict(seed=5, spp=4, spp_chunk=CHUNK, max_depth=3, device="cpu",
              mesh=make_mesh(device_type="cpu") if mesh else None)
    got = ti.render(world["table"], (world["ball"],), **kw)
    _unmasked(monkeypatch)
    want = ti.render(world["table"], (world["whole"],), **kw)
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _count_calls(monkeypatch, names):
    calls = {k: [] for k in names}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name].append(a)
            return fn(*a, **kw)
        return wrapped

    for name in names:
        monkeypatch.setattr(neural, name, counting(name, getattr(neural, name)))
    return calls


def test_exact_render_calls_routed_k2s_twice_a_bounce(world, monkeypatch):
    calls = _count_calls(monkeypatch, ("fused_pdf_spherical", "fused_pdf_spherical_routed",
                                       "fused_sample_pdf_spherical", "fused_transport_packed"))
    spp, depth = 4, 3
    img = ti.render(world["table"], (world["ball"],), seed=3, spp=spp, spp_chunk=CHUNK, max_depth=depth, device="cpu")
    assert np.isfinite(img).all() and img.max() > 0
    bounces = spp // CHUNK * depth
    assert {k: len(v) for k, v in calls.items()} == {"fused_pdf_spherical": 0, "fused_pdf_spherical_routed": 2 * bounces,
                                                     "fused_sample_pdf_spherical": bounces,
                                                     "fused_transport_packed": 0}


def test_k3_pdf_render_transports_the_whole_wavefront(world, monkeypatch):
    calls = _count_calls(monkeypatch, ("fused_pdf_spherical", "fused_pdf_spherical_routed",
                                       "fused_sample_pdf_spherical", "fused_transport_packed"))
    spp, depth = 4, 3
    img = ti.render(world["table"], (_ball(_nb(20241017, exact=False)),), seed=3, spp=spp, spp_chunk=CHUNK,
                    max_depth=depth, device="cpu")
    assert np.isfinite(img).all() and img.max() > 0
    bounces = spp // CHUNK * depth
    assert not calls["fused_pdf_spherical"] and not calls["fused_pdf_spherical_routed"]
    assert len(calls["fused_sample_pdf_spherical"]) == bounces
    assert [a[3].shape[0] for a in calls["fused_transport_packed"]] == [N] * (2 * bounces)  # x0: every row


def test_measured_disk_bounce_is_bit_equal_without_the_mask(world, monkeypatch):
    w = weights.make(7, {"base": ("base", None), "v": ("velocity", weights.velocity_dims(32, 3, 2))}, "cpu")
    nb = make_neural_bsdf("disk", ModelConfig(), w["v"], {"net": w["base"]}, world["brdf"], device="cpu")
    balls = (ti.neural_matball(nb),)
    got = _bounces(world["measured"], balls, 4)
    assert all(bool(s[5].any()) for s in got)
    _unmasked(monkeypatch)
    for sa, sb in zip(got, _bounces(world["measured"], balls, 4)):
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_routed_pdf_counter_counts_the_rows_that_use_the_query(world, monkeypatch):
    want = []
    orig = ti._shade_eval_pdf

    def counted(matballs, mat_id, uv, wi_l, wo_l, need=None):
        want.append(int((need & (mat_id == ti.MAT_BALL) & (wi_l[..., 2] > 0)).sum()))
        return orig(matballs, mat_id, uv, wi_l, wo_l, need=need)

    monkeypatch.setattr(ti, "_shade_eval_pdf", counted)
    with profile(activities=[ProfilerActivity.CPU]):
        states = _bounces(world["table"], (world["ball"],), 9, n_bounces=3)
        counters = trace.snapshot().counters
    assert len(want) == 6 and sum(want) > 0 and bool(states[-1][5].any())
    assert counters["rows.routed_pdf"] == sum(want)
    assert counters["rows.bounce_in"] == 3 * N

    spec = importlib.util.spec_from_file_location("sph_query_rows_pct_render", METRIC)
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    assert metric.read(None) == pytest.approx(100.0 * sum(want) / (2 * 3 * N))
    trace.clear()
    assert metric.read(None) is None  # no counters: nothing read
