"""Wavefront path tracer with next-event estimation + MIS, counterpart of
the JAX package's `render/integrator.py`.

Every bounce runs on the whole wavefront at once: closest hits through the
8-wide BVH (kernel K5 on the card, its plain walker on the CPU), or through
the binary BVH's lockstep walk for a scene built with `wide=False`, masked
material dispatch (no queue compaction), NEE against the envmap and point
lights with shadow rays (K5's any-hit variant), BSDF sampling on every
matball in one batch (kernel K1 for a neural disk matball), MIS by the
power heuristic, and Russian roulette from depth RR_DEPTH. The film is a
scatter-free segment sum over the sample-major ray layout.

The matball material is pluggable (`MatballFns`): ground-truth measured
RGL importance sampling, the neural ODE sampler (disk, spherical), the
analytic principled table material with a two-sided cosine sampler, or the
full-sphere neural sampler over that material, through the identical
integrator. A transmissive matball lets NEE and BSDF-sampled directions go
below its surface. A bounce takes its random numbers as explicit tensors
(`BounceRandoms`, drawn by `draw_bounce` from one `torch.Generator`), so a
test can hand it the very draws the JAX package makes from its keys.

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
check and the image's copy to the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.core import trace
from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.core.prng import RowSeed, draw_seed, root_generator
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
from bsdf_diffusion_sampling_tpu_torch.render.scene import MAT_BALL, MAT_PLANE, Scene
from bsdf_diffusion_sampling_tpu_torch.render.bvh import BVH, intersect
from bsdf_diffusion_sampling_tpu_torch.render.bvh8 import BVH8
from bsdf_diffusion_sampling_tpu_torch.render.traverse8 import Hit, intersect8

RR_DEPTH = 3
RR_MAX = 0.95
RAY_EPS = 1e-3
GRAY = 0.18  # `scene_measured.xml:46`


class MatballFns(NamedTuple):
    """Local-frame material callbacks for one preview object. The MIS pdf
    comes from `eval_pdf` where it is given, else from `eval` and `pdf`."""

    draw: Callable  # (generator, n) -> the randoms one bounce's sample() takes
    sample: Callable  # (randoms, wi_local) -> (wo_local, pdf)
    eval: Callable  # (wi_local, wo_local) -> (N, 3) f*cos
    weight_filter: Callable  # (rgb_weight) -> rgb_weight (firefly policy)
    pdf: Callable | None = None  # (wi_local, wo_local) -> (N,)
    eval_pdf: Callable | None = None  # (wi_local, wo_local) -> ((N, 3) f*cos, (N,) the MIS pdf)
    transmissive: bool = False  # a full-sphere BSDF: wo may go below the surface


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


def _as_tuple(matball) -> tuple:
    """Normalize to a tuple of MatballFns: ball slot i shades material id
    MAT_BALL + i."""
    return (matball,) if isinstance(matball, MatballFns) else tuple(matball)


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


def _shade_eval(matballs: tuple, mat_id, uv, wi_l, wo_l):
    """f*cos for all materials, masked by mat_id."""
    out = diffuse_eval(_albedo(mat_id, uv), wo_l)
    for i, mb in enumerate(matballs):
        out = torch.where((mat_id == MAT_BALL + i)[..., None], mb.eval(wi_l, wo_l), out)
    return out


def _shade_eval_pdf(matballs: tuple, mat_id, uv, wi_l, wo_l):
    """(f*cos, pdf) for all materials, each matball's from its fused
    eval_pdf where it has one."""
    f = diffuse_eval(_albedo(mat_id, uv), wo_l)
    pdf = diffuse_pdf(wo_l)
    for i, mb in enumerate(matballs):
        if mb.eval_pdf is not None:
            fb, pb = mb.eval_pdf(wi_l, wo_l)
        else:
            fb, pb = mb.eval(wi_l, wo_l), mb.pdf(wi_l, wo_l)
        is_b = mat_id == MAT_BALL + i
        f = torch.where(is_b[..., None], fb, f)
        pdf = torch.where(is_b, pb, pdf)
    return f, pdf


def _shade_sample(matballs: tuple, rnd: BounceRandoms, mat_id, wi_l):
    wo, pdf = cosine_sample(rnd.u_diffuse)
    for i, mb in enumerate(matballs):
        wo_b, pdf_b = mb.sample(rnd.ball[i], wi_l)
        is_b = mat_id == MAT_BALL + i
        wo = torch.where(is_b[..., None], wo_b, wo)
        pdf = torch.where(is_b, pdf_b, pdf)
    return wo, pdf


def _transmissive_mask(matballs: tuple, mat_id):
    m = torch.zeros(mat_id.shape, dtype=torch.bool, device=mat_id.device)
    for i, mb in enumerate(matballs):
        if mb.transmissive:
            m = m | (mat_id == MAT_BALL + i)
    return m


def _ball_filter(matballs: tuple, mat_id, w_rgb):
    out = w_rgb
    for i, mb in enumerate(matballs):
        out = torch.where((mat_id == MAT_BALL + i)[..., None], mb.weight_filter(w_rgb), out)
    return out


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
    matballs = matball
    ro, rd, px, L, beta, alive, prev_pdf = state
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
        f_nee, pdf_b_at_nee = _shade_eval_pdf(matballs, mat_id, uv, wi_l, wo_nee_l)
        nee_cand = alive & (pdf_e > 1e-9) & ((wo_nee_l[..., 2] > 0) | trans_mask)
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
        wo_l, pdf_b = _shade_sample(matballs, rnd, mat_id, wi_l)
    with trace.stage("bounce.bsdf_eval_pdf", mark):
        f_b, pdf_mis = _shade_eval_pdf(matballs, mat_id, uv, wi_l, wo_l)
    with trace.stage("bounce.update", mark):
        is_ball = mat_id >= MAT_BALL
        ok = alive & (pdf_b > 1e-9) & ((wo_l[..., 2] > 0) | trans_mask)
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
        matballs = _as_tuple(matball)
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
        matballs = _as_tuple(matball)
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
        weight_filter=_luminance_clamp(firefly_clamp),
    )


def neural_matball(nb) -> MatballFns:
    """Neural matball: ODE sample and its pdf (K1 or K4 draws with a kernel
    seed from the bounce's generator), measured eval. eval_pdf is the
    MEASURED fused (f, pdf), the MIS proxy (see the note in `_bounce_body`)."""
    from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import eval_pdf_brdf
    from bsdf_diffusion_sampling_tpu_torch.render.neural import firefly_filter, neural_eval, neural_sample

    return MatballFns(
        draw=lambda gen, n: draw_seed(gen),
        sample=lambda rand, wi: neural_sample(nb, rand, wi),
        eval=lambda wi, wo: neural_eval(nb, wi, wo),
        eval_pdf=lambda wi, wo: eval_pdf_brdf(nb.brdf, wi, wo),
        weight_filter=lambda w: firefly_filter(nb, w),
    )


def _luminance_clamp(firefly_clamp: float):
    def clamp(w_rgb):
        lum = 0.2126 * w_rgb[..., 0] + 0.7152 * w_rgb[..., 1] + 0.0722 * w_rgb[..., 2]
        return torch.where((lum < firefly_clamp)[..., None], w_rgb, 0.0)

    return clamp


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
    from bsdf_diffusion_sampling_tpu_torch.bsdf.principled import PrincipledParams

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
        weight_filter=_luminance_clamp(firefly_clamp),
        pdf=pdf,
        transmissive=transmits,
    )


def neural_matball_sphere(nb, mat, albedo=(1.0, 1.0, 1.0)) -> MatballFns:
    """Full-sphere neural matball: the spherical sampler's draw and pdf (K4
    draws with a kernel seed from the bounce's generator) and the table
    material's analytic eval times the albedo. It has no fused eval_pdf, so
    MIS queries the neural pdf at the NEE and at the sampled direction."""
    from bsdf_diffusion_sampling_tpu_torch.render.neural import firefly_filter, neural_pdf, neural_sample

    return MatballFns(
        draw=lambda gen, n: draw_seed(gen),
        sample=lambda rand, wi: neural_sample(nb, rand, wi),
        eval=_table_eval(mat, albedo, nb.v_params[0]["w"].device),
        weight_filter=lambda w: firefly_filter(nb, w),
        pdf=lambda wi, wo: neural_pdf(nb, wi, wo),
        transmissive=True,
    )
