"""Wavefront path tracer with next-event estimation + MIS, counterpart of
the JAX package's `render/integrator.py`.

Every bounce runs on the whole wavefront at once: closest hits through the
8-wide BVH (kernel K5 on the card, its plain walker on the CPU), or through
the binary BVH's lockstep walk for a scene built with `wide=False`, the
matball dispatch below, NEE against the envmap and point lights with shadow
rays (K5's any-hit variant), BSDF sampling, MIS by the power heuristic, and
Russian roulette from depth RR_DEPTH. The film is a scatter-free segment sum
over the sample-major ray layout.

The matball material is pluggable (`MatballFns`): ground-truth measured
RGL importance sampling, the neural ODE sampler (disk, spherical), the
analytic principled table material with a two-sided cosine sampler, or the
full-sphere neural sampler over that material, through the identical
integrator. A transmissive matball lets NEE and BSDF-sampled directions go
below its surface.

One dispatch serves every scene: the routing tables of its matballs
(`_Router`, built once a render by `_router`), looked up by the material id
each ray hit. They hold each ball's transmissive flag and firefly clamp
(`BallRoute.clamp`), and say which balls the scene computes in groups and
which run their callbacks. A scene of fewer than `ROUTE_MIN_BALLS` balls
groups none. A callback ball runs on the whole wavefront and is kept by
`torch.where`. Its `pdf` sees wi = (0, 0, -1), below the surface, on the
rows outside its ball and outside the rows that use the pdf (the NEE
candidates, the kept draws), so a full-sphere sampler
(`render/neural.py::neural_pdf`) queries none of them. In a scene of
`ROUTE_MIN_BALLS` or more balls, the groups are these. The full-sphere
samplers' rows are partitioned by ball on the device (`route_rows`: sorted
by ball, each ball's segment padded to the routed kernels' tile; no host
sync) for one routed K4 draw and routed K2s queries over all of them, and
only over the rows that use the result (the live rows for the draw, the NEE
candidates and the kept draws for the pdf). The table materials' values come
from one principled evaluation with each row's parameters gathered. The
two-sided cosine draws of table balls come from one draw with each row's
uniforms gathered. A row the routing leaves out holds the diffuse plane's
draw and pdf.

A bounce takes its random numbers as explicit tensors (`BounceRandoms`,
drawn by `draw_bounce` from one `torch.Generator`), so a test can hand it
the very draws the JAX package makes from its keys.

The JAX package's jitted bounce / pass programs (`lax.scan` over bounces
and passes) are Python loops here.

With a `mesh` (`parallel/mesh.py`), the wavefront is split over the ranks
in contiguous blocks of rays; the scene and the matballs are replicated.
Every rank draws the pass's global random numbers from the one generator
and keeps its block's rows (`shard_randoms`; a kernel seed becomes a
`RowSeed` at the block's first row, so K1 and K4 draw what the whole
wavefront's launch would), every bounce stays rank-local (the traversal
sort is local: per-ray traversal is exact), and the film sum and the
sample count cross ranks in one `all_reduce` a pass. The traversals'
`truncated` flag is reduced once a render.

While a profiler records (`core/trace.py`), a `render()` call is the span
`render`: each pass a `render.pass` holding `render.camera`, one
`render.bounce` a depth (over the nine `bounce.<stage>` spans of
`_bounce_body`) and `render.film`; then `render.finish`, the truncation
check and the image's copy to the host. A routing is the span
`sampler.route`; the counters `rows.routed_draw` and `rows.routed_pdf` add
the rows the routed draw and queries compute, `rows.routed_pad` the slots
that pad their segments to whole tiles.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.bsdf.principled import PrincipledParams, PrincipledRows, eval_principled_rows
from bsdf_diffusion_sampling_tpu_torch.core import trace
from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.core.prng import RowSeed, draw_seed, root_generator
from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import route_rows, stack_packed
from bsdf_diffusion_sampling_tpu_torch.parallel.mesh import Mesh, all_reduce_
from bsdf_diffusion_sampling_tpu_torch.render.camera import generate_rays
from bsdf_diffusion_sampling_tpu_torch.render.envmap import EnvMap, eval_env, pdf_env, sample_env
from bsdf_diffusion_sampling_tpu_torch.render.lambert import (
    checkerboard,
    cosine_sample,
    diffuse_eval,
    diffuse_pdf,
    make_frame,
    to_local,
    to_world,
)
from bsdf_diffusion_sampling_tpu_torch.render.neural import (
    neural_eval,
    neural_pdf,
    neural_pdf_routed,
    neural_sample,
    neural_sample_routed,
)
from bsdf_diffusion_sampling_tpu_torch.render.scene import MAT_BALL, MAT_PLANE, Scene
from bsdf_diffusion_sampling_tpu_torch.render.bvh import BVH, intersect
from bsdf_diffusion_sampling_tpu_torch.render.bvh8 import BVH8
from bsdf_diffusion_sampling_tpu_torch.render.traverse8 import Hit, intersect8

RR_DEPTH = 3
RR_MAX = 0.95
RAY_EPS = 1e-3
GRAY = 0.18  # `scene_measured.xml:46`
ROUTE_MIN_BALLS = 2  # matballs from which a scene routes each ball only its own rows


class BallRoute(NamedTuple):
    """What the dispatch knows of one matball: `clamp` its firefly clamp on
    the luminance of f / pdf; and what a scene of several balls groups it
    by: `kind` "table" (a material-table entry `mat` times `albedo`, drawn
    by the two-sided cosine lobe), "sphere" (the same value, drawn and
    weighted by the full-sphere sampler `nb`) or "other" (its callbacks)."""

    kind: str
    clamp: float
    mat: object = None
    albedo: tuple = (1.0, 1.0, 1.0)
    nb: object = None


class MatballFns(NamedTuple):
    """Local-frame material callbacks for one preview object. The MIS pdf
    comes from `eval_pdf` where it is given, else from `eval` and `pdf`.
    `route` holds the ball's firefly clamp and what a scene of several
    balls may compute for it in place of the callbacks; None stands for
    `BallRoute("other", math.inf)`: no clamp, the callbacks."""

    draw: Callable  # (generator, n) -> the randoms one bounce's sample() takes
    sample: Callable  # (randoms, wi_local) -> (wo_local, pdf)
    eval: Callable  # (wi_local, wo_local) -> (N, 3) f*cos
    pdf: Callable | None = None  # (wi_local, wo_local) -> (N,)
    eval_pdf: Callable | None = None  # (wi_local, wo_local) -> ((N, 3) f*cos, (N,) the MIS pdf)
    transmissive: bool = False  # a full-sphere BSDF: wo may go below the surface
    route: BallRoute | None = None


class BounceRandoms(NamedTuple):
    """Every random number one bounce consumes."""

    u_nee: torch.Tensor  # (N, 2) envmap NEE draw
    u_diffuse: torch.Tensor  # (N, 2) cosine draw of the diffuse materials
    ball: tuple  # per matball, what its `draw` returned
    u_rr: torch.Tensor  # (N,) Russian roulette


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u if (lo, hi) == (0.0, 1.0) else u * (hi - lo) + lo


def draw_bounce(gen: torch.Generator, n: int, matballs: tuple) -> BounceRandoms:
    return BounceRandoms(_uniform(gen, (n, 2)), _uniform(gen, (n, 2)),
                         tuple(mb.draw(gen, n) for mb in matballs), _uniform(gen, (n,)))


def _draw_rows(draw, r0: int, m: int):
    """Rows [r0, r0 + m) of one draw: (N, ...) tensors on their first axis,
    the spherical (16, 3, N) von Mises uniforms on their last, a (1,) int64
    kernel seed as that seed at row r0; tuples draw by draw."""
    if isinstance(draw, tuple):
        return tuple(_draw_rows(d, r0, m) for d in draw)
    if draw.dtype == torch.int64 and tuple(draw.shape) == (1,):
        return RowSeed(draw, r0)
    return draw[..., r0:r0 + m] if draw.ndim == 3 else draw[r0:r0 + m]


def shard_randoms(rnd: BounceRandoms, r0: int, m: int) -> BounceRandoms:
    """The rows [r0, r0 + m) of a bounce's random numbers."""
    return BounceRandoms(*(_draw_rows(f, r0, m) for f in rnd))


class Matballs(tuple):
    """A scene's matballs (slot i shades material id MAT_BALL + i) with
    their routing tables `router` (`_router`), built once on one device by
    `as_matballs`."""

    router: _Router


def as_matballs(matball, device) -> Matballs:
    """`matball` (one MatballFns or a sequence of them) with its routing
    tables on `device`: built here, unless `matball` already carries them
    (`render()` builds them once a render)."""
    if isinstance(matball, Matballs):
        return matball
    mbs = Matballs((matball,) if isinstance(matball, MatballFns) else matball)
    mbs.router = _router(mbs, device)
    return mbs


def _ray_sort_key(rd, active):
    """Traversal-coherence sort key: direction octant, dominant axis and a
    grazing bit for live rays, a sentinel for dead ones. Sorting before
    traversal groups rays that walk the same nodes and packs the dead rays
    together; results are un-permuted, so the order is invisible outside."""
    a = rd.abs()
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    octant = (rd[:, 0] > 0).to(torch.int64) * 4 + (rd[:, 1] > 0).to(torch.int64) * 2 + (rd[:, 2] > 0).to(torch.int64)
    dom = torch.where(ax >= torch.maximum(ay, az), 0, torch.where(ay >= az, 1, 2))
    mx = torch.maximum(ax, torch.maximum(ay, az))
    mid = ax + ay + az - mx - torch.minimum(ax, torch.minimum(ay, az))
    graze = (mid * 2 > mx).to(torch.int64)
    return torch.where(active, (octant * 3 + dom) * 2 + graze, 48)


def _sort_perm(sort_key):
    perm = torch.argsort(sort_key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def _isect(accel: Union[BVH8, BVH], ro, rd, active) -> Hit:
    """Closest hit: an 8-wide accel is traced by K5 (on the card) in
    sort-key order, a binary one by its lockstep walk. The accel's type
    decides, never the device."""
    if isinstance(accel, BVH):
        return intersect(accel, ro, rd, active=active)
    perm, inv = _sort_perm(_ray_sort_key(rd, active))
    h = intersect8(accel, ro[perm], rd[perm], active=active[perm])
    return Hit(h.t[inv], h.prim[inv], h.u[inv], h.v[inv], h.truncated)


def _occl(accel: Union[BVH8, BVH], ro, rd, t_max, active):
    """(occluded, truncated) of shadow rays, dispatched as `_isect` is."""
    if isinstance(accel, BVH):
        h = intersect(accel, ro, rd, t_max, active=active, any_hit=True)
        return h.t < t_max * 0.9999, h.truncated
    perm, inv = _sort_perm(_ray_sort_key(rd, active))
    tm = t_max[perm]
    h = intersect8(accel, ro[perm], rd[perm], tm, active=active[perm], any_hit=True)
    return (h.t < tm * 0.9999)[inv], h.truncated


def mis_weight(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic beta=2 (`mitsuba_helper.py:139-145`)."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-20)
    return torch.where(pdf_a > 0, w, 0.0)


def _albedo(mat_id, uv):
    plane = checkerboard(uv)
    return torch.where((mat_id == MAT_PLANE)[..., None], plane, torch.full_like(plane, GRAY))


# ------------------------------------------------------------------ routing


class _Router(NamedTuple):
    """A ball set's routing tables on one device (`_router`).
    The (MAT_BALL + balls,) lookups by material id: `trans` transmissive,
    `clamp` the firefly clamp (inf off the balls); `cos_on` a ball drawn by
    the two-sided cosine lobe; `sph_of` the ball's place in the stacked
    samplers `sph` (-1 if none); `tab_of` its row of the principled table
    `tab` and `tab_albedo` (-1 if none). The callback balls: `cb_draw` draw
    by their `sample` and weight by their `eval_pdf` or `pdf`, `cb_eval`
    take their value from `eval` (from `eval_pdf` where they draw by
    callback and have one)."""

    trans: torch.Tensor
    clamp: torch.Tensor
    cos_on: torch.Tensor
    cos_balls: tuple
    sph_of: torch.Tensor
    sph_balls: tuple
    sph: object  # StackedWeights or None
    sph_nb: object  # one NeuralBSDF of the stack: domain, widths, T, iterations
    tab_of: torch.Tensor
    tab: object  # PrincipledRows or None
    tab_albedo: torch.Tensor
    cb_draw: tuple
    cb_eval: tuple


def _sph_groupable(nb) -> bool:
    """An exact-pdf full-sphere sampler that the routed kernels take: one
    of K4's widths, which `make_neural_bsdf` gives a one-sampler stack."""
    return nb is not None and nb.pdf_exact and nb.stack is not None


def _router(matballs: tuple, device) -> _Router:
    """The routing tables of `matballs` on `device`. Below ROUTE_MIN_BALLS
    they group nothing: every ball runs its callbacks over the whole
    wavefront. From it, full-sphere balls that the routed kernels cannot
    take (not the exact pdf, other widths) run their callbacks; so do all
    of them, with a warning, where they differ in T, Newton iterations or
    encoding."""
    routes = [mb.route or BallRoute("other", math.inf) for mb in matballs]
    kinds = [r.kind if len(routes) >= ROUTE_MIN_BALLS else "other" for r in routes]
    sph = [i for i, (k, r) in enumerate(zip(kinds, routes)) if k == "sphere" and _sph_groupable(r.nb)]
    same = {(r.nb.cfg, r.nb.T, r.nb.pdf_newton_iters, r.nb.pole_sin_eps) for r in (routes[i] for i in sph)}
    if len(same) > 1:  # one launch takes one T, one iteration count and one encoding
        warnings.warn(f"{len(sph)} full-sphere matballs differ in T, Newton iterations or encoding: each runs "
                      "over the whole wavefront, unrouted", stacklevel=3)
        sph = []
    tab = [i for i, (k, r) in enumerate(zip(kinds, routes))
           if k in ("table", "sphere") and isinstance(r.mat, PrincipledParams)]
    cos = [i for i, k in enumerate(kinds) if k == "table"]
    n_ids = MAT_BALL + len(matballs)

    def lut(values: dict, fill, dtype):
        return torch.tensor([values.get(m - MAT_BALL, fill) for m in range(n_ids)], dtype=dtype, device=device)

    return _Router(
        trans=lut({i: mb.transmissive for i, mb in enumerate(matballs)}, False, torch.bool),
        clamp=lut({i: r.clamp for i, r in enumerate(routes)}, math.inf, torch.float32),
        cos_on=lut({i: True for i in cos}, False, torch.bool),
        cos_balls=tuple(cos),
        sph_of=lut({b: k for k, b in enumerate(sph)}, -1, torch.int64),
        sph_balls=tuple(sph),
        sph=stack_packed([routes[i].nb.packed for i in sph]) if sph else None,
        sph_nb=routes[sph[0]].nb if sph else None,
        tab_of=lut({b: k for k, b in enumerate(tab)}, -1, torch.int64),
        tab=PrincipledRows.of([routes[i].mat for i in tab], device) if tab else None,
        tab_albedo=torch.tensor([routes[i].albedo for i in tab], dtype=torch.float32, device=device).reshape(-1, 3),
        cb_draw=tuple(i for i in range(len(matballs)) if i not in sph and i not in cos),
        cb_eval=tuple(i for i in range(len(matballs)) if i not in tab),
    )


def _seeds(rands) -> tuple:
    """(seeds (B,) int64, the wavefront's first row) of the balls' kernel
    seeds or shard seeds (`RowSeed`)."""
    row0 = rands[0].row0 if isinstance(rands[0], RowSeed) else 0
    return torch.cat([(d.seed if isinstance(d, RowSeed) else d).reshape(1) for d in rands]), row0


def _table_values(r: _Router, mat_id, wi_l, wo_l, out):
    """The table balls' f * cos from one principled evaluation, each row
    under its ball's material and albedo; `out` elsewhere."""
    if r.tab is None:
        return out
    k = r.tab_of[mat_id.long()]
    kc = torch.clamp(k, min=0)
    f = eval_principled_rows(r.tab.take(kc), wi_l, wo_l)[..., None] * r.tab_albedo[kc]
    return torch.where((k >= 0)[..., None], f, out)


def _cosine_pdf(r: _Router, mid, wo_l):
    """The two-sided cosine lobe's pdf of each row's table ball."""
    base = wo_l[..., 2].abs() / math.pi
    return torch.where(r.trans[mid], base * 0.5, torch.where(wo_l[..., 2] > 0, base, 0.0))


def _below_unless(keep, wi_l):
    """wi_l on the rows of `keep`, (0, 0, -1) on the others."""
    down = wi_l.new_zeros(3)
    down[2:].fill_(-1.0)  # a kernel given the value: `down[2] = -1.0` copies it from the host, a stream sync
    return torch.where(keep[..., None], wi_l, down)


def _routed(r: _Router, mat_id, need, counter: str):
    """The routing of the rows of `need` (every row without it) that a
    stacked full-sphere sampler takes."""
    g = r.sph_of[mat_id.long()]
    if need is not None:
        g = torch.where(need, g, -1)
    return route_rows(g, len(r.sph_balls), counter)


# ---------------------------------------------------------- the dispatch


def _shade_eval(matballs: Matballs, mat_id, uv, wi_l, wo_l):
    """f*cos for all materials: the table balls' from one principled
    evaluation, the others' from their `eval`, kept by material id."""
    r = matballs.router
    out = _table_values(r, mat_id, wi_l, wo_l, diffuse_eval(_albedo(mat_id, uv), wo_l))
    for i in r.cb_eval:
        out = torch.where((mat_id == MAT_BALL + i)[..., None], matballs[i].eval(wi_l, wo_l), out)
    return out


def _shade_eval_pdf(matballs: Matballs, mat_id, uv, wi_l, wo_l, need=None):
    """(f*cos, pdf) for all materials. The full-sphere samplers' pdfs are
    queried only on the rows of `need` (every row without it): a stacked
    sampler's through the routing, a callback ball's `pdf` by seeing wi =
    (0, 0, -1), below the surface, on the rows outside `need` and its ball,
    which a full-sphere sampler does not query."""
    r = matballs.router
    f = _table_values(r, mat_id, wi_l, wo_l, diffuse_eval(_albedo(mat_id, uv), wo_l))
    pdf = diffuse_pdf(wo_l)
    if r.cos_balls:
        mid = mat_id.long()
        pdf = torch.where(r.cos_on[mid], _cosine_pdf(r, mid, wo_l), pdf)
    for i, mb in enumerate(matballs):
        draws, values = i in r.cb_draw, i in r.cb_eval
        if not (draws or values):
            continue
        is_b = mat_id == MAT_BALL + i
        if draws and mb.eval_pdf is not None:
            fb, pb = mb.eval_pdf(wi_l, wo_l)
        else:
            fb = mb.eval(wi_l, wo_l) if values else None
            pb = mb.pdf(wi_l if need is None else _below_unless(need & is_b, wi_l), wo_l) if draws else None
        if fb is not None:
            f = torch.where(is_b[..., None], fb, f)
        if pb is not None:
            pdf = torch.where(is_b, pb, pdf)
    if r.sph is not None:
        rt = _routed(r, mat_id, need, "rows.routed_pdf")
        pb = neural_pdf_routed(r.sph_nb, r.sph, rt.tile_ball, rt.gather(wi_l), rt.gather(wo_l))
        pdf = rt.scatter(pb, pdf)
    return f, pdf


def _shade_sample(matballs: Matballs, rnd: BounceRandoms, mat_id, wi_l, need=None):
    """(wo, pdf) of every row's material. The stacked full-sphere samplers
    draw only the rows of `need` (every row without it)."""
    wo, pdf = cosine_sample(rnd.u_diffuse)
    r = matballs.router
    if r.cos_balls:  # one two-sided cosine draw, each row from its ball's uniforms
        mid = mat_id.long()
        u, side = rnd.u_diffuse, torch.zeros_like(rnd.u_rr)
        for i in r.cos_balls:
            is_b = mat_id == MAT_BALL + i
            u = torch.where(is_b[..., None], rnd.ball[i][0], u)
            side = torch.where(is_b, rnd.ball[i][1], side)
        wo_c, pdf_c = cosine_sample(u)
        down = r.trans[mid]
        wo_c = torch.where((down & (side > 0.5))[..., None], wo_c * wo_c.new_tensor([1.0, 1.0, -1.0]), wo_c)
        pdf_c = torch.where(down, wo_c[..., 2].abs() / math.pi * 0.5, pdf_c)
        on = r.cos_on[mid]
        wo = torch.where(on[..., None], wo_c, wo)
        pdf = torch.where(on, pdf_c, pdf)
    for i in r.cb_draw:
        wo_b, pdf_b = matballs[i].sample(rnd.ball[i], wi_l)
        is_b = mat_id == MAT_BALL + i
        wo = torch.where(is_b[..., None], wo_b, wo)
        pdf = torch.where(is_b, pdf_b, pdf)
    if r.sph is not None:
        rt = _routed(r, mat_id, need, "rows.routed_draw")
        seeds, row0 = _seeds([rnd.ball[i] for i in r.sph_balls])
        wo_b, pdf_b = neural_sample_routed(r.sph_nb, r.sph, seeds, rt.slot_row + row0, rt.tile_ball,
                                           rt.gather(wi_l))
        wo, pdf = rt.scatter(wo_b, wo), rt.scatter(pdf_b, pdf)
    return wo, pdf


def _transmissive_mask(matballs: Matballs, mat_id):
    return matballs.router.trans[mat_id.long()]


def _ball_filter(matballs: Matballs, mat_id, w_rgb):
    """Each ball row's weight under its ball's firefly clamp."""
    return luminance_clamp(w_rgb, matballs.router.clamp[mat_id.long()])


def _bounce_body(accel: Union[BVH8, BVH], env: EnvMap, lights: torch.Tensor, state, rnd: BounceRandoms, depth: int, *,
                 matball: tuple, mark: Callable[[str], None] | None = None):
    """ONE path-tracing bounce for the whole wavefront. `state` is (ro, rd,
    px, L, beta, alive, prev_pdf). Returns (state, truncated) where
    truncated is a 0-dim bool tensor: did any traversal of this bounce hit
    its cap. The bounce runs in nine stages, each the span `bounce.<stage>`
    while a profiler records; `mark(stage)`, if given, is called at the end
    of each (a profiler records a CUDA event there; nothing else changes).
    While spans record, the counters `rows.bounce_in` and `rows.alive_in`
    add the rows the wavefront carries in and those of them alive."""
    ro, rd, px, L, beta, alive, prev_pdf = state
    matballs = as_matballs(matball, ro.device)
    n = ro.shape[0]
    if trace.enabled():
        trace.count("rows.bounce_in", n)
        trace.count("rows.alive_in", alive.sum())

    with trace.stage("bounce.closest_hit", mark):
        hit = _isect(accel, ro, rd, alive)
        truncated = hit.truncated
        miss = hit.t >= 1e29

    with trace.stage("bounce.env_hit_and_surface", mark):
        # escaped rays collect the envmap, MIS-weighted against the previous
        # bounce's BSDF pdf
        le = eval_env(env, rd)
        w_env = torch.where(prev_pdf > 0, mis_weight(prev_pdf, pdf_env(env, rd)), 1.0)
        L = L + beta * le * (w_env * (alive & miss))[..., None]
        alive = alive & ~miss

        # surface interaction: one attribute-row gather serves normals, uvs
        # and the material id
        a = accel.attr_rows[hit.prim]
        u, v = hit.u[:, None], hit.v[:, None]
        w0 = 1.0 - u - v
        n_sh = w0 * a[:, 0:3] + u * a[:, 3:6] + v * a[:, 6:9]
        uv = w0 * a[:, 9:11] + u * a[:, 11:13] + v * a[:, 13:15]
        mat_id = a[:, 15].to(torch.int32)
        n_sh = n_sh / torch.clamp(torch.linalg.vector_norm(n_sh, dim=-1, keepdim=True), min=1e-12)
        p_hit = ro + rd * hit.t[:, None]
        t, bt = make_frame(n_sh)
        wi_l = to_local(n_sh, t, bt, -rd)
        alive = alive & (wi_l[..., 2] > 0)
        trans_mask = _transmissive_mask(matballs, mat_id)

    def offset(wo_local):
        sign = torch.where(wo_local[..., 2] >= 0, RAY_EPS, -RAY_EPS)
        return p_hit + n_sh * sign[..., None]

    # ---- NEE against the envmap: sample, shadow-test, MIS
    with trace.stage("bounce.nee_env_sample", mark):
        d_env, le_nee, pdf_e = sample_env(env, rnd.u_nee)
    with trace.stage("bounce.nee_eval_pdf", mark):
        wo_nee_l = to_local(n_sh, t, bt, d_env)
        nee_cand = alive & (pdf_e > 1e-9) & ((wo_nee_l[..., 2] > 0) | trans_mask)
        f_nee, pdf_b_at_nee = _shade_eval_pdf(matballs, mat_id, uv, wi_l, wo_nee_l, need=nee_cand)
    with trace.stage("bounce.nee_shadow", mark):
        occ, tr = _occl(accel, offset(wo_nee_l), d_env, torch.full((n,), 1e6, device=ro.device), nee_cand)
        truncated = truncated | tr

    with trace.stage("bounce.nee_lights", mark):
        contrib = beta * f_nee * (le_nee / torch.clamp(pdf_e, min=1e-9)[..., None])
        contrib = contrib * mis_weight(pdf_e, pdf_b_at_nee)[..., None]
        L = L + torch.where((nee_cand & ~occ)[..., None], contrib, 0.0)

        # ---- NEE against point lights (delta emitters: deterministic
        # direction, no MIS)
        for li in range(lights.shape[0]):
            lp, inten = lights[li, :3], lights[li, 3:]
            dvec = lp[None, :] - p_hit
            dist = torch.clamp(torch.linalg.vector_norm(dvec, dim=-1), min=1e-6)
            d_l = dvec / dist[..., None]
            wo_light_l = to_local(n_sh, t, bt, d_l)
            f_l = _shade_eval(matballs, mat_id, uv, wi_l, wo_light_l)
            cand = alive & ((wo_light_l[..., 2] > 0) | trans_mask)
            occ_l, tr = _occl(accel, offset(wo_light_l), d_l, dist - 2 * RAY_EPS, cand)
            truncated = truncated | tr
            contrib_l = beta * f_l * (inten[None, :] / (dist * dist)[..., None])
            L = L + torch.where((cand & ~occ_l)[..., None], contrib_l, 0.0)

    # ---- BSDF sampling. pdf_b (the sampler's own pdf) divides the weight;
    # the MIS weights on both techniques use the material's eval_pdf pdf
    # (for a neural matball, the measured pdf it was trained to match): a
    # proxy shared by the NEE weight and the env-hit weight keeps the
    # weights summing to 1, so MIS stays unbiased
    with trace.stage("bounce.bsdf_sample", mark):
        wo_l, pdf_b = _shade_sample(matballs, rnd, mat_id, wi_l, need=alive)
    with trace.stage("bounce.bsdf_eval_pdf", mark):
        ok = alive & (pdf_b > 1e-9) & ((wo_l[..., 2] > 0) | trans_mask)
        f_b, pdf_mis = _shade_eval_pdf(matballs, mat_id, uv, wi_l, wo_l, need=ok)
    with trace.stage("bounce.update", mark):
        is_ball = mat_id >= MAT_BALL
        w_rgb = f_b / torch.clamp(pdf_b, min=1e-9)[..., None]
        w_rgb = torch.where(is_ball[..., None], _ball_filter(matballs, mat_id, w_rgb), w_rgb)
        beta = torch.where(ok[..., None], beta * w_rgb, beta)
        alive = alive & ok & (w_rgb.amax(dim=-1) > 0)

        rd = to_world(n_sh, t, bt, wo_l)
        ro = offset(wo_l)
        prev_pdf = torch.where(alive, pdf_mis, 0.0)

        # ---- Russian roulette (no-op while depth < RR_DEPTH)
        if depth >= RR_DEPTH:
            q = torch.clamp(beta.amax(dim=-1), max=RR_MAX)
        else:
            q = torch.ones(n, device=ro.device)
        beta = beta / torch.clamp(q, min=1e-9)[..., None]
        alive = alive & (rnd.u_rr < q)
    return (ro, rd, px, L, beta, alive, prev_pdf), truncated


def _init_wavefront(cam_vectors, u_cam, *, width, height, spp_chunk):
    ro, rd, px = generate_rays(cam_vectors, width, height, u_cam, spp_chunk)
    n = ro.shape[0]
    dev = ro.device
    return (ro.contiguous(), rd, px, torch.zeros((n, 3), device=dev), torch.ones((n, 3), device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.zeros(n, device=dev))  # prev_pdf 0 => camera ray: no MIS on env hit


def _finish_pass(L, r0: int, mesh: Mesh | None, *, width, height, spp_chunk):
    """Film accumulation without a scatter: the sample-major ray layout
    makes the per-pixel sum a reshape and a sum over samples; every sample
    splats with weight 1. `L` holds the pass's rays [r0, r0 + m); the
    others count zero here, and the film sum and the sample count cross the
    mesh in one all_reduce (none without a group)."""
    n, m = width * height * spp_chunk, L.shape[0]
    L_all = L.new_zeros((n, 3))
    L_all[r0:r0 + m] = L
    ones = L.new_zeros((n,))
    ones[r0:r0 + m] = 1.0
    img = L_all.reshape(spp_chunk, height, width, 3).sum(0)
    cnt = ones.reshape(spp_chunk, height, width).sum(0)
    film = all_reduce_(mesh, torch.cat([img.reshape(-1), cnt.reshape(-1)]))
    return film[:img.numel()].view(img.shape), film[img.numel():].view(cnt.shape)


def render_pass(scene: Scene, matball, gen: torch.Generator, *, spp_chunk: int = 4, max_depth: int = 12,
                mesh: Mesh | None = None):
    """One accumulation pass over the whole film: ray generation, max_depth
    bounces, film. Returns (film_sum, sample_count, truncated).

    With a `mesh`, this rank traces its contiguous block of the w * h *
    spp_chunk rays (which must divide by the mesh size) from the pass's
    global draws, and every rank returns the whole film; `truncated` is this
    rank's. Without one, the block is the whole wavefront."""
    with trace.span("render.pass"):
        matballs = as_matballs(matball, gen.device)
        w, h = scene.camera.width, scene.camera.height
        n = w * h * spp_chunk
        r0, m = (0, n) if mesh is None else mesh.block(n)
        with trace.span("render.camera"):
            u_cam = _uniform(gen, (n, 2), 1e-7, 1.0)
            state = _init_wavefront(scene.camera.vectors.to(gen.device), u_cam, width=w, height=h,
                                    spp_chunk=spp_chunk)
            state = tuple(x[r0:r0 + m] for x in state)
        truncated = torch.zeros((), dtype=torch.bool, device=gen.device)
        for depth in range(max_depth):
            with trace.span("render.bounce", depth=depth):
                rnd = shard_randoms(draw_bounce(gen, n, matballs), r0, m)
                state, tr = _bounce_body(scene.accel, scene.envmap, scene.lights, state, rnd, depth,
                                         matball=matballs)
                truncated = truncated | tr
        with trace.span("render.film"):
            img, cnt = _finish_pass(state[3], r0, mesh, width=w, height=h, spp_chunk=spp_chunk)
        return img, cnt, truncated


def render(scene: Scene, matball, seed: int = 0, spp: int = 512, spp_chunk: int = 4, max_depth: int = 12,
           device="cuda", mesh: Mesh | None = None) -> np.ndarray:
    """Full multi-pass render. Returns the (H, W, 3) numpy image.

    Runs on `device` (the card by default; the scene moves there, the
    matballs must already be there): K5 traces CUDA tensors and its plain
    walker CPU ones. Each pass is one wavefront over the whole film (the
    JAX package's `max_rays_per_pass` row tiles are not needed on the
    card), so the default 512x512 film at spp_chunk 4 is 2^20 rays. The
    traversal's `truncated` flags stay on the device and are checked once
    at the end. With a `mesh` the wavefront is sharded over its ranks
    (`render_pass`), every rank returns the whole image, and the flags are
    reduced over the mesh once, before the check."""
    with trace.span("render"):
        device = resolve_device(device)
        scene = scene.to(device)
        w, h = scene.camera.width, scene.camera.height
        gen = root_generator(seed, device)
        img_sum = torch.zeros((h, w, 3), device=device)
        cnt_sum = torch.zeros((h, w), device=device)
        truncated = torch.zeros((), dtype=torch.bool, device=device)
        matballs = as_matballs(matball, device)
        for _ in range(max(spp // spp_chunk, 1)):
            img, cnt, tr = render_pass(scene, matballs, gen, spp_chunk=spp_chunk, max_depth=max_depth, mesh=mesh)
            img_sum += img
            cnt_sum += cnt
            truncated |= tr
        with trace.span("render.finish"):
            truncated = all_reduce_(mesh, truncated.to(torch.int32), torch.distributed.ReduceOp.MAX)
            if bool(truncated):
                raise RuntimeError("BVH traversal hit its visit cap: the image may miss geometry")
            return (img_sum / torch.clamp(cnt_sum, min=1.0)[..., None]).cpu().numpy()


def measured_matball(brdf, firefly_clamp: float = 30.0) -> MatballFns:
    """Ground-truth matball: the measured BRDF importance-samples itself."""
    from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import eval_brdf, eval_pdf_brdf, sample_brdf

    return MatballFns(
        draw=lambda gen, n: _uniform(gen, (n, 2), 1e-6, 1.0 - 1e-6),
        sample=lambda u, wi: sample_brdf(brdf, u, wi),
        eval=lambda wi, wo: eval_brdf(brdf, wi, wo),
        eval_pdf=lambda wi, wo: eval_pdf_brdf(brdf, wi, wo),
        route=BallRoute("other", firefly_clamp),
    )


def neural_matball(nb) -> MatballFns:
    """Neural matball: ODE sample and its pdf (K1 or K4 draws with a kernel
    seed from the bounce's generator), measured eval. eval_pdf is the
    MEASURED fused (f, pdf), the MIS proxy (see the note in `_bounce_body`)."""
    from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import eval_pdf_brdf

    return MatballFns(
        draw=lambda gen, n: draw_seed(gen),
        sample=lambda rand, wi: neural_sample(nb, rand, wi),
        eval=lambda wi, wo: neural_eval(nb, wi, wo),
        eval_pdf=lambda wi, wo: eval_pdf_brdf(nb.brdf, wi, wo),
        route=BallRoute("other", nb.firefly_clamp),
    )


def luminance_clamp(w_rgb: torch.Tensor, clamp) -> torch.Tensor:
    """The firefly policy of every matball: zero a sample whose luminance of
    f / pdf reaches `clamp` (a number, or one a row)
    (`brdf_measured_disk.py:97-100`)."""
    lum = 0.2126 * w_rgb[..., 0] + 0.7152 * w_rgb[..., 1] + 0.0722 * w_rgb[..., 2]
    return torch.where((lum < clamp)[..., None], w_rgb, 0.0)


def _table_eval(mat, albedo, device):
    """f * cos of a material-table entry times the albedo tint, as rgb."""
    from bsdf_diffusion_sampling_tpu_torch.bsdf.materials import eval_material

    albedo_v = torch.tensor(albedo, dtype=torch.float32, device=device)

    def _eval(wi, wo):
        f = eval_material(mat, wi, wo)
        if f.ndim == wi.ndim - 1:  # grey materials broadcast to rgb
            f = f[..., None].expand(*f.shape, 3)
        return f * albedo_v

    return _eval


def principled_matball(mat, albedo=(1.0, 1.0, 1.0), firefly_clamp: float = 3.5, device="cuda") -> MatballFns:
    """Ground-truth full-sphere matball: a material-table entry's analytic
    eval times the albedo tint, sampled by a cosine lobe mirrored below the
    surface with probability 1/2 when the material transmits. Its draw is
    (u (N, 2) for the cosine lobe, u_side (N,) for the side)."""
    device = resolve_device(device)
    transmits = (not isinstance(mat, PrincipledParams)) or mat.spec_trans > 0
    p_up = 0.5  # upper-hemisphere probability of the two-sided mixture

    def sample(rand, wi):
        u, u_side = rand
        wo, pdf = cosine_sample(u)
        if transmits:
            go_down = u_side > p_up
            wo = torch.where(go_down[..., None], wo * torch.tensor([1.0, 1.0, -1.0], device=wo.device), wo)
            pdf = wo[..., 2].abs() / math.pi * 0.5  # 50/50 mirrored cosine
        return wo, pdf

    def pdf(wi, wo):
        base = wo[..., 2].abs() / math.pi
        return base * 0.5 if transmits else torch.where(wo[..., 2] > 0, base, 0.0)

    return MatballFns(
        draw=lambda gen, n: (_uniform(gen, (n, 2)), _uniform(gen, (n,))),
        sample=sample,
        eval=_table_eval(mat, albedo, device),
        pdf=pdf,
        transmissive=transmits,
        route=BallRoute("table", firefly_clamp, mat, tuple(albedo)),
    )


def neural_matball_sphere(nb, mat, albedo=(1.0, 1.0, 1.0)) -> MatballFns:
    """Full-sphere neural matball: the spherical sampler's draw and pdf (K4
    draws with a kernel seed from the bounce's generator) and the table
    material's analytic eval times the albedo. It has no fused eval_pdf, so
    MIS queries the neural pdf at the NEE and at the sampled direction."""
    return MatballFns(
        draw=lambda gen, n: draw_seed(gen),
        sample=lambda rand, wi: neural_sample(nb, rand, wi),
        eval=_table_eval(mat, albedo, nb.v_params[0]["w"].device),
        pdf=lambda wi, wo: neural_pdf(nb, wi, wo),
        transmissive=True,
        route=BallRoute("sphere", nb.firefly_clamp, mat, tuple(albedo), nb),
    )
