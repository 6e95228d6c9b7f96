"""The routed matball dispatch of a scene of several balls
(`render/integrator.py`: `route_rows`, `_Router`) on the 12-ball table
array under its point light (`write_array_scene(kind="table",
point_light=ARRAY_LIGHT)`), one full-sphere sampler a ball from seeded
random weights, on the CPU (the routed K4 and K2s run their plain
versions there):

- bounces and films equal the callback dispatch, every matball run over
  the whole wavefront and kept by `torch.where` (`ROUTE_MIN_BALLS` raised
  past the ball count: the routing groups none), to 1e-6, without a mesh,
  on a one-rank mesh and on the second half of a wavefront (its rows keyed by their global index); a
  dead row's next ray is not compared, as it comes from the draw the
  routing left out;
- the draw and the pdf of every routed row equal today's, and a row the
  routing leaves out holds the diffuse plane's draw and pdf;
- the routing's partition: segments sorted by ball and padded to whole
  tiles, each row in exactly one slot, empty and one-row segments;
- the routed K4 and K2s twins against per-ball plain calls on the gathered
  rows, and `philox_spherical_draws` at explicit rows;
- the per-row principled evaluation against one evaluation a material;
- `cli/render.py` on the array launches one routed draw and at most two
  routed queries a bounce, and no per-ball draw or query;
- array and gt bounces against the benchmark's plain reference
  (`port_bench/reference/scene.py`, which imports neither jax nor the JAX
  package).
"""

import _torch_threads  # noqa: F401  (first: torch's threads at this worker's share)

import os

import numpy as np
import pytest
import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf.materials import BSDF_MATERIALS
from bsdf_diffusion_sampling_tpu_torch.bsdf.principled import PrincipledRows, eval_principled, eval_principled_rows
from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
from bsdf_diffusion_sampling_tpu_torch.ops import fused_ode as fo
from bsdf_diffusion_sampling_tpu_torch.parallel.mesh import Mesh, make_mesh
from bsdf_diffusion_sampling_tpu_torch.render import integrator as ti
from bsdf_diffusion_sampling_tpu_torch.render import neural, procedural
from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf
from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene
from bsdf_diffusion_sampling_tpu_torch.train.checkpoint import save_pytree
from port_bench.harness import weights

W = H = 24
SMALL = dict(n_lat=10, n_lon=14, plane_g=3, width=W, height=H, spp=4, max_depth=3)
CFG = ModelConfig(domain="sphere_full", velocity_hidden=32, velocity_layers=4)
TOL = 1e-6


def _nets(seed: int):
    w = weights.make(seed, {"base": ("base", None), "v": ("velocity", weights.velocity_dims(32, 4, 3))}, "cpu")
    return w["v"], {"net": w["base"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("routed"))
    path = procedural.write_array_scene(d, kind="table", point_light=procedural.ARRAY_LIGHT, **SMALL)
    scene = load_scene(path, device="cpu", width=W, height=H)
    balls = []
    for i, (idx, albedo) in enumerate(procedural.ARRAY_TABLE):
        nb = make_neural_bsdf("sphere_full", CFG, *_nets(100 + i), device="cpu")
        balls.append(ti.neural_matball_sphere(nb, BSDF_MATERIALS[idx], albedo))
    v, base = _nets(7)
    save_pytree(os.path.join(d, "sph.npz"), {"base": base, "rectified": v}, step=1)
    return {"dir": d, "path": path, "scene": scene, "balls": tuple(balls)}


def _masked(monkeypatch):
    monkeypatch.setattr(ti, "ROUTE_MIN_BALLS", 10 ** 9)


def _bounces(world, gen_seed: int, n_bounces: int = 3, mesh=None):
    """The states after each of n bounces from one camera pass."""
    sc, balls = world["scene"], world["balls"]
    gen = torch.Generator().manual_seed(gen_seed)
    n = W * H * 2
    r0, m = (0, n) if mesh is None else mesh.block(n)
    u_cam = ti._uniform(gen, (n, 2), 1e-7, 1.0)
    state = tuple(x[r0:r0 + m] for x in ti._init_wavefront(sc.camera.vectors, u_cam, width=W, height=H,
                                                             spp_chunk=2))
    out = []
    for depth in range(n_bounces):
        rnd = ti.shard_randoms(ti.draw_bounce(gen, n, balls), r0, m)
        state, _ = ti._bounce_body(sc.accel, sc.envmap, sc.lights, state, rnd, depth, matball=balls)
        out.append(state)
    return out


def _assert_states_equal(a, b):
    """Equal alive flags, radiance, throughput and MIS pdfs on every row;
    rays on the live rows (a dead row's next ray is the draw the routing
    left out)."""
    for sa, sb in zip(a, b):
        alive = sa[5]
        assert torch.equal(alive, sb[5])
        for i, (x, y) in enumerate(zip(sa, sb)):
            if i in (0, 1):
                x, y = x[alive], y[alive]
            torch.testing.assert_close(x, y, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shard", ["whole", "one-rank mesh", "second half"])
def test_routed_bounces_match_masked_dispatch(world, monkeypatch, shard):
    mesh = {"whole": None, "one-rank mesh": make_mesh(device_type="cpu"),
            "second half": Mesh(None, 1, 2, torch.device("cpu"))}[shard]
    routed = _bounces(world, 3, mesh=mesh)
    assert all(bool(s[5].any()) for s in routed)
    _masked(monkeypatch)
    _assert_states_equal(routed, _bounces(world, 3, mesh=mesh))


def test_routed_film_matches_masked_dispatch(world, monkeypatch):
    kw = dict(seed=5, spp=4, spp_chunk=2, max_depth=3, device="cpu")
    routed = ti.render(world["scene"], world["balls"], **kw)
    _masked(monkeypatch)
    masked = ti.render(world["scene"], world["balls"], **kw)
    assert np.isfinite(routed).all() and routed.max() > 0
    np.testing.assert_allclose(routed, masked, rtol=TOL, atol=TOL)


def test_routed_rows_draw_and_pdf_as_masked(world, monkeypatch):
    """At the first bounce: every live ball row's draw and every NEE-like
    candidate's pdf equal today's; a ball row left out holds the cosine
    lobe's draw and pdf."""
    sc, balls = world["scene"], world["balls"]
    gen = torch.Generator().manual_seed(11)
    n = W * H * 2
    ro, rd, *_ = ti._init_wavefront(sc.camera.vectors, ti._uniform(gen, (n, 2), 1e-7, 1.0), width=W, height=H,
                                    spp_chunk=2)
    hit = ti._isect(sc.accel, ro, rd, torch.ones(n, dtype=torch.bool))
    mat_id = sc.accel.attr_rows[hit.prim][:, 15].to(torch.int32)
    rnd = ti.draw_bounce(gen, n, balls)
    wi = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    wi[:, 2] = wi[:, 2].abs() + 0.05
    wo = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    need = torch.rand(n, generator=gen) < 0.7
    uv = torch.rand(n, 2, generator=gen)
    on_ball = mat_id >= ti.MAT_BALL
    assert len(set(mat_id[on_ball].tolist())) >= 6
    routed = ti.as_matballs(balls, "cpu")
    assert routed.router.sph_balls == tuple(range(len(balls)))  # 12 stacked samplers
    got_s = ti._shade_sample(routed, rnd, mat_id, wi, need=need)
    got_p = ti._shade_eval_pdf(routed, mat_id, uv, wi, wo, need=need)
    cos_wo, cos_pdf = ti.cosine_sample(rnd.u_diffuse)
    _masked(monkeypatch)
    masked = ti.as_matballs(balls, "cpu")
    r = masked.router
    assert r.sph is None and r.tab is None and not r.cos_balls
    assert r.cb_draw == r.cb_eval == tuple(range(len(balls)))
    want_s = ti._shade_sample(masked, rnd, mat_id, wi)
    want_p = ti._shade_eval_pdf(masked, mat_id, uv, wi, wo)
    kept, out = need | ~on_ball, on_ball & ~need
    for g, w in zip(got_s, want_s):
        torch.testing.assert_close(g[kept], w[kept], rtol=TOL, atol=TOL)
    torch.testing.assert_close(got_s[0][out], cos_wo[out])
    torch.testing.assert_close(got_s[1][out], cos_pdf[out])
    torch.testing.assert_close(got_p[0], want_p[0], rtol=TOL, atol=TOL)  # the value: every row
    torch.testing.assert_close(got_p[1][kept], want_p[1][kept], rtol=TOL, atol=TOL)
    torch.testing.assert_close(got_p[1][out], ti.diffuse_pdf(wo)[out])


@pytest.mark.parametrize("sizes", [[0, 1, 300, 0, 129, 128, 5], [1] * 12, [0] * 3])
def test_route_rows_partition(sizes):
    g = torch.cat([torch.full((k,), b) for b, k in enumerate(sizes)] + [torch.full((77,), -1)])
    g = g[torch.randperm(g.shape[0], generator=torch.Generator().manual_seed(0))]
    rt = ti.route_rows(g, len(sizes))
    t = fo.ROUTE_TILE
    assert rt.slot_row.shape[0] % t == 0 and rt.tile_ball.shape[0] == rt.slot_row.shape[0] // t
    assert torch.equal(rt.routed, g >= 0)
    rows = torch.nonzero(rt.routed)[:, 0]
    slots = rt.dest[rows]
    assert slots.unique().numel() == rows.numel()  # one slot a row
    assert torch.equal(rt.slot_row[slots], rows)
    ball_of_slot = rt.tile_ball.long().repeat_interleave(t)
    assert torch.equal(ball_of_slot[slots], g[rows])  # each row in its ball's tiles
    used = rt.tile_ball[rt.tile_ball >= 0].long()
    assert torch.equal(used, used.sort().values)  # segments in ball order
    want_tiles = [-(-k // t) for k in sizes]
    assert [int((used == b).sum()) for b in range(len(sizes))] == want_tiles
    assert torch.equal(rt.scatter(torch.arange(rt.slot_row.shape[0]), torch.full_like(g, -5))[~rt.routed],
                       torch.full(((~rt.routed).sum(),), -5))


def test_routed_twins_match_plain_per_ball():
    sizes = [3, 0, 1, 200, 130]
    packs = [fo.prepack_spherical(*_nets(40 + b)) for b in range(len(sizes))]
    sw = fo.stack_packed(packs)
    g = torch.cat([torch.full((k,), b) for b, k in enumerate(sizes)])
    g = g[torch.randperm(g.shape[0], generator=torch.Generator().manual_seed(1))]
    n = g.shape[0]
    gen = torch.Generator().manual_seed(2)
    cond = torch.randn(n, fo.COND_DIM, generator=gen)
    x = torch.stack([torch.rand(n, generator=gen) * 3.0 + 0.05, torch.rand(n, generator=gen) * 6.0 - 3.0], -1)
    rt = ti.route_rows(g, len(sizes))
    seeds = torch.tensor([11, 2 ** 40 + 3, 5, 2 ** 62 - 1, 9], dtype=torch.int64)
    row0 = 1000
    xs, pdfs, x0s = fo.fused_sample_pdf_spherical_routed(sw, rt.gather(cond), rt.slot_row + row0, rt.tile_ball,
                                                          seeds, 8)
    qp, qx0 = fo.fused_pdf_spherical_routed(sw, rt.gather(x), rt.gather(cond), rt.tile_ball, 8, newton_iters=2)
    for b, p in enumerate(packs):
        rows = torch.nonzero(g == b)[:, 0]
        slots = rt.dest[rows]
        # the whole batch's K4 draw, as one launch over every row would make it, at these rows
        x_all, pdf_all, x0_all = fo.fused_sample_pdf_spherical(p, cond, 8, seed=int(seeds[b]), row0=row0)
        torch.testing.assert_close(xs[slots], x_all[rows], rtol=TOL, atol=TOL)
        torch.testing.assert_close(pdfs[slots], pdf_all[rows], rtol=TOL, atol=TOL)
        torch.testing.assert_close(x0s[slots], x0_all[rows], rtol=0, atol=0)
        pq, x0q = fo.fused_pdf_spherical(p, x[rows].contiguous(), cond[rows], 8, newton_iters=2)
        torch.testing.assert_close(qp[slots], pq, rtol=TOL, atol=TOL)
        torch.testing.assert_close(qx0[slots], x0q, rtol=TOL, atol=TOL)


def test_philox_spherical_draws_at_explicit_rows():
    rows = torch.tensor([5, 0, 2 ** 33 + 7, 4095, 17, 17])
    whole_eps, whole_u = fo.philox_spherical_draws(2 ** 63 + 5, 4096)
    big_eps, big_u = fo.philox_spherical_draws(2 ** 63 + 5, 1, row0=2 ** 33 + 7)
    eps, u = fo.philox_spherical_draws(2 ** 63 + 5, rows.numel(), rows=rows)
    pick = [0, 1, 3, 4, 5]
    assert torch.equal(eps[pick], whole_eps[rows[pick]]) and torch.equal(u[..., pick], whole_u[..., rows[pick]])
    assert torch.equal(eps[2:3], big_eps) and torch.equal(u[..., 2:3], big_u)


def test_principled_rows_match_one_material_at_a_time():
    gen = torch.Generator().manual_seed(3)
    n = 6000
    wi = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    wo = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    mats = [BSDF_MATERIALS[i] for i, _ in procedural.ARRAY_TABLE]
    idx = torch.randint(0, len(mats), (n,), generator=gen)
    got = eval_principled_rows(PrincipledRows.of(mats, "cpu").take(idx), wi, wo)
    want = torch.stack([eval_principled(m, wi, wo) for m in mats])[idx, torch.arange(n)]
    assert (want > 0).float().mean() > 0.3
    torch.testing.assert_close(got, want, rtol=TOL, atol=1e-7)


def test_cli_array_launches_routed_kernels(world, monkeypatch):
    """The CLI's neural-sphere render of the array (12 balls, one
    checkpoint): a bounce draws once and queries at most twice through the
    routed kernels, and never through the per-ball K4 or K2s."""
    from bsdf_diffusion_sampling_tpu_torch.cli import render as cli

    calls = {k: 0 for k in ("draw", "query", "k4", "k2s")}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name, attr in (("draw", "fused_sample_pdf_spherical_routed"), ("query", "fused_pdf_spherical_routed"),
                       ("k4", "fused_sample_pdf_spherical"), ("k2s", "fused_pdf_spherical")):
        monkeypatch.setattr(neural, attr, counting(name, getattr(neural, attr)))
    depth, passes = 2, 2
    img, _ = cli.main(["--scene", world["path"], "--mode", "neural-sphere", "--checkpoint",
                       os.path.join(world["dir"], "sph.npz"), "--spp", "4", "--spp-chunk", "2", "--width", str(W),
                       "--height", str(H), "--max-depth", str(depth), "--device", "cpu",
                       "--out", os.path.join(world["dir"], "cli_out")])
    assert np.isfinite(img).all() and img.max() > 0
    bounces = depth * passes
    assert calls["draw"] == bounces and bounces <= calls["query"] <= 2 * bounces
    assert calls["k4"] == calls["k2s"] == 0


def _reference_bounce(sc_path, balls_ref, state, rnd_ref, rows, depth):
    from port_bench.reference import scene as refscene

    rsc = refscene.load_scene(sc_path, "cpu", W, H)
    balls_ref = [dict(b, brdf=rsc.brdf[b["filename"]]) if b["kind"] == "measured" else b for b in balls_ref]
    keys = ("ro", "rd", "px", "L", "beta", "alive", "prev_pdf")
    s_in = {k: v for k, v in zip(keys, state) if k != "px"}
    return refscene.SceneBounce(rsc, balls_ref)(s_in, rnd_ref, rows, depth)


def _off_share(got, want):
    """The share of live rows whose next state parts from the reference's
    (the benchmark's `bounce_off_share` rule)."""
    from port_bench.drivers.render import Driver

    keys = ("ro", "rd", "px", "L", "beta", "alive", "prev_pdf")
    return float(Driver._bounce_off(dict(zip(keys, got)), want).float().mean())


def test_array_bounce_matches_the_plain_reference(world):
    """Two bounces of the routed array against `port_bench/reference/
    scene.py`'s (each ball its sampler and table material, routing by the
    hit's material, the point light), from the program's state before
    each: the next states agree on all but 1% of the rows."""
    sc, balls = world["scene"], world["balls"]
    refs = []
    for i, ((idx, albedo), mb) in enumerate(zip(procedural.ARRAY_TABLE, balls)):
        nb = mb.route.nb
        m = BSDF_MATERIALS[idx]
        refs.append({"kind": "sphere", "albedo": albedo, "firefly": nb.firefly_clamp,
                     "material": {f: getattr(m, f) for f in m.__dataclass_fields__},
                     "net": {"domain": "sphere_full", "base": nb.base_params["net"], "v": nb.v_params, "T": nb.T,
                             "pdf_exact": True, "newton_iters": nb.pdf_newton_iters, "firefly": nb.firefly_clamp}})
    gen = torch.Generator().manual_seed(21)
    n = W * H * 2
    state = ti._init_wavefront(sc.camera.vectors, ti._uniform(gen, (n, 2), 1e-7, 1.0), width=W, height=H,
                               spp_chunk=2)
    for depth in range(2):
        rnd = ti.draw_bounce(gen, n, balls)
        out, _ = ti._bounce_body(sc.accel, sc.envmap, sc.lights, state, rnd, depth, matball=balls)
        rnd_ref = {"u_nee": rnd.u_nee, "u_diffuse": rnd.u_diffuse, "u_rr": rnd.u_rr,
                   "ball": [int(b[0]) for b in rnd.ball]}
        want = _reference_bounce(world["path"], refs, state, rnd_ref, np.arange(n), depth)
        assert bool(want["alive"].any())
        assert _off_share(out, want) <= 0.01
        state = out


def test_gt_bounce_matches_the_plain_reference(tmp_path):
    """Two bounces of the gt render (the measured BRDF sampling itself
    through its two warps) on the matpreview stand-in against the
    reference's: the next states agree on all but 1% of the rows."""
    from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured

    path = procedural.write_scene(str(tmp_path), n_lat=12, n_lon=16, plane_g=3, env_res=(32, 64), width=W,
                                  height=H)
    sc = load_scene(path, device="cpu", width=W, height=H)
    brdf = load_measured(os.path.join(str(tmp_path), procedural.MATERIAL + ".bsdf"), device="cpu")
    balls = (ti.measured_matball(brdf),)
    refs = [{"kind": "measured", "filename": procedural.MATERIAL, "firefly": 30.0}]
    gen = torch.Generator().manual_seed(22)
    n = W * H * 2
    state = ti._init_wavefront(sc.camera.vectors, ti._uniform(gen, (n, 2), 1e-7, 1.0), width=W, height=H,
                               spp_chunk=2)
    for depth in range(2):
        rnd = ti.draw_bounce(gen, n, balls)
        out, _ = ti._bounce_body(sc.accel, sc.envmap, sc.lights, state, rnd, depth, matball=balls)
        rnd_ref = {"u_nee": rnd.u_nee, "u_diffuse": rnd.u_diffuse, "u_rr": rnd.u_rr, "ball": [rnd.ball[0]]}
        want = _reference_bounce(path, refs, state, rnd_ref, np.arange(n), depth)
        assert bool(want["alive"].any())
        assert _off_share(out, want) <= 0.01
        state = out


def test_render_builds_the_routing_once(world, monkeypatch):
    """`render()` builds the balls' routing tables once for all its passes
    and bounces."""
    built = []
    orig = ti._router

    def counted(*a):
        built.append(1)
        return orig(*a)

    monkeypatch.setattr(ti, "_router", counted)
    ti.render(world["scene"], world["balls"], seed=5, spp=4, spp_chunk=2, max_depth=2, device="cpu")
    assert len(built) == 1


def test_mixed_samplers_warn_and_run_unrouted(world):
    """Full-sphere balls of two T cannot share a routed launch: they run
    over the whole wavefront, and the routing says so."""
    balls = list(world["balls"])
    nb = balls[1].route.nb._replace(T=4)
    balls[1] = ti.neural_matball_sphere(nb, balls[1].route.mat, balls[1].route.albedo)
    with pytest.warns(UserWarning, match="unrouted"):
        r = ti.as_matballs(tuple(balls), "cpu").router
    assert r.sph is None and set(r.cb_draw) == set(range(len(balls)))


def test_each_filter_is_its_route_clamp(world, tmp_path):
    """Each ball's rows are filtered by the luminance clamp at its route's
    clamp: in a scene of three kinds of balls, and in a scene of each ball
    alone."""
    from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured

    procedural.write_scene(str(tmp_path), n_lat=8, n_lon=8, plane_g=2, env_res=(8, 16), width=4, height=4)
    brdf = load_measured(os.path.join(str(tmp_path), procedural.MATERIAL + ".bsdf"), device="cpu")
    balls = (world["balls"][0], ti.principled_matball(BSDF_MATERIALS[0], device="cpu", firefly_clamp=2.0),
             ti.measured_matball(brdf, firefly_clamp=7.0))
    w = torch.rand(4000, 3, generator=torch.Generator().manual_seed(4)) * 12.0
    mat_id = torch.randint(ti.MAT_BALL, ti.MAT_BALL + len(balls), (w.shape[0],), generator=torch.Generator())
    got = ti._ball_filter(ti.as_matballs(balls, "cpu"), mat_id, w)
    for i, mb in enumerate(balls):
        on = mat_id == ti.MAT_BALL + i
        want = ti.luminance_clamp(w[on], mb.route.clamp)
        assert 0 < int((want.amax(-1) == 0).sum()) < int(on.sum())
        assert torch.equal(got[on], want)
        alone = ti._ball_filter(ti.as_matballs((mb,), "cpu"), torch.full_like(mat_id, ti.MAT_BALL), w)
        assert torch.equal(alone, ti.luminance_clamp(w, mb.route.clamp))
