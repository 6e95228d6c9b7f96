"""The plain reference of a bounce over a scene of one or many matballs:
each ball with its own sampler and material, a row routed to the ball
whose shape its ray hit; point lights beside (or in place of) the envmap;
the ground-truth mode, where a measured BRDF samples itself through its
two warps (Dupuy & Jakob 2018: the luminance warp, then the visible-normal
warp, both blended over the two theta_i slices that bracket theta_i).

It reads the raw scene files itself, including the array dialect (an
inline `mybsdf` hook in each ball's shape, a scene lit by a point light
alone, with a black envmap as the program holds one), and builds on
`render.py`'s pieces; it imports nothing of the program.
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from . import files
from . import render as ref
from .flow import FP32, Prec
from .principled import eval_principled

MAT_PLANE, MAT_DIFFUSE, MAT_BALL = ref.MAT_PLANE, ref.MAT_DIFFUSE, ref.MAT_BALL


# ------------------------------------------------------------------ scene


def _hook(b, defaults) -> dict:
    idx = files._prop(b, "idx", defaults)
    return {"filename": files._prop(b, "filename", defaults) or "", "idx": -1 if idx is None else int(idx),
            "albedo": tuple(files._floats(files._prop(b, "albedo", defaults) or "1 1 1"))}


def read_scene_xml(path: str) -> dict:
    """Camera, emitters and shapes of both dialects: a shape's material by
    `ref` to a top-level bsdf, or an inline `mybsdf` hook. Each distinct
    hook (filename, idx, albedo) is a ball, numbered in order of first
    appearance, top-level hooks first."""
    root = ET.parse(path).getroot()
    defaults = {d.get("name"): d.get("value") for d in root.findall("default")}
    sensor = root.find("sensor")
    look = next(c for c in sensor.find("transform") if c.tag.lower() == "lookat")
    film = sensor.find("film")
    cam = {"origin": files._floats(look.get("origin")), "target": files._floats(look.get("target")),
           "up": files._floats(look.get("up")), "fov": float(files._prop(sensor, "fov", defaults)),
           "width": int(files._prop(film, "width", defaults)), "height": int(files._prop(film, "height", defaults))}
    env, lights = None, []
    for em in root.findall("emitter"):
        if em.get("type") == "envmap":
            env = {"file": os.path.join(os.path.dirname(path), files._prop(em, "filename", defaults)),
                   "to_world": files._transform(em.find("transform")),
                   "scale": float(files._prop(em, "scale", defaults) or 1.0)}
        elif em.get("type") == "point":
            lights.append(files._floats(files._prop(em, "position", defaults))
                          + files._floats(files._prop(em, "intensity", defaults)))
    balls, ids = [], {}

    def ball_id(hook: dict) -> int:
        key = (hook["filename"], hook["idx"], hook["albedo"])
        if key not in ids:
            ids[key] = MAT_BALL + len(balls)
            balls.append(hook)
        return ids[key]

    mats = {}
    for b in root.findall("bsdf"):
        if b.get("type") == "mybsdf":
            mats[b.get("id")] = ball_id(_hook(b, defaults))
        else:
            mats[b.get("id")] = MAT_PLANE if b.find("ref") is not None else MAT_DIFFUSE
    shapes = []
    for sh in root.findall("shape"):
        inline = sh.find("bsdf")
        mat = ball_id(_hook(inline, defaults)) if inline is not None else mats[next(iter(sh.findall("ref"))).get("id")]
        shapes.append({"file": os.path.join(os.path.dirname(path), files._prop(sh, "filename", defaults)),
                       "index": int(files._prop(sh, "shapeindex", defaults) or 0),
                       "to_world": files._transform(sh.find("transform")), "mat": mat})
    return {"camera": cam, "envmap": env, "lights": lights, "shapes": shapes, "balls": balls}


def load_scene(xml_path: str, device, width: int, height: int) -> ref.Scene:
    """`render.py`'s Scene of the file, its material ids one a ball
    (MAT_BALL + k), `ball` the list of balls' hooks, `brdf` the measured
    balls' tables by filename; a scene without an envmap gets a black one
    (2 x 4 texels, its sampling warp over luminance 1e-8)."""
    desc = read_scene_xml(xml_path)
    parts = {k: [] for k in ("v", "n", "uv", "mat")}
    for sh in desc["shapes"]:
        m = files.read_serialized(sh["file"], sh["index"])
        tw = sh["to_world"]
        pos = (m["positions"].astype(np.float64) @ tw[:3, :3].T + tw[:3, 3]).astype(np.float32)
        nrm = m["normals"].astype(np.float64) @ np.linalg.inv(tw[:3, :3])
        nrm = (nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)).astype(np.float32)
        f = m["faces"]
        parts["v"].append(pos[f])
        parts["n"].append(nrm[f])
        parts["uv"].append(m["uvs"][f])
        parts["mat"].append(np.full(len(f), sh["mat"]))
    env_desc = desc["envmap"]
    if env_desc is None:
        img, r = np.zeros((2, 4, 3), np.float32), np.eye(3)
    else:
        img, r = files.read_exr(env_desc["file"]) * env_desc["scale"], env_desc["to_world"][:3, :3]
    h = img.shape[0]
    lum = np.maximum(0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2], 1e-8)
    warp = ref.build_warp((lum * np.sin((np.arange(h) + 0.5) / h * np.pi)[:, None])[None])
    to = lambda x: x.to(device)  # noqa: E731
    brdfs = {}
    for b in desc["balls"]:
        if b["filename"] and b["filename"] not in brdfs:
            t = ref.load_brdf(os.path.join(os.path.dirname(xml_path), b["filename"] + ".bsdf"))
            brdfs[b["filename"]] = {k: (to(v) if torch.is_tensor(v) else {a: to(c) for a, c in v.items()})
                                    for k, v in t.items()}
    v = torch.from_numpy(np.concatenate(parts["v"]))
    cam = dict(desc["camera"], width=width, height=height)
    cam["vectors"] = ref.camera_vectors(cam).to(device)
    return ref.Scene(
        v0=to(v[:, 0]), e1=to(v[:, 1] - v[:, 0]), e2=to(v[:, 2] - v[:, 0]),
        nrm=to(torch.from_numpy(np.concatenate(parts["n"]))), uv=to(torch.from_numpy(np.concatenate(parts["uv"]))),
        mat=to(torch.from_numpy(np.concatenate(parts["mat"]))), cam=cam,
        env={"data": to(torch.from_numpy(np.asarray(img, np.float32))), "warp": {k: to(t) for k, t in warp.items()},
             "to_world": to(torch.from_numpy(np.asarray(r, np.float32))),
             "to_local": to(torch.from_numpy(np.linalg.inv(r).astype(np.float32)))},
        lights=to(torch.tensor(desc["lights"], dtype=torch.float32).reshape(-1, 6)),
        ball=desc["balls"], brdf=brdfs)


# ------------------------------------------------ measured self-sampling


def warp_sample(wp: dict, u, sl):
    """((N, 2) position, density) of the warp at uniforms u, its tables
    blended over the slices `sl` (render.py's `_slices`): the marginal's
    cell by counting, its linear cdf inverted; then the conditional row's,
    the rows blended by the marginal's fraction."""
    P, H, W = wp["dens"].shape
    i0, i1, w = sl
    marg = (1 - w)[:, None] * wp["marg"][i0] + w[:, None] * wp["marg"][i1]  # (N, H)
    k = torch.clamp((marg[:, :H - 1] <= u[:, 1:2]).sum(-1) - 1, 0, H - 2)
    last = torch.full_like(k, W - 1)
    m0, m1 = ref._at(wp["cond"], sl, k, last), ref._at(wp["cond"], sl, k + 1, last)
    t = ref._solve(marg.gather(1, k[:, None])[:, 0], m0, m1, 1.0 / (H - 1), u[:, 1])
    target = u[:, 0] * ((1 - t) * m0 + t * m1)

    def row(kk):
        kk = torch.clamp(kk, max=H - 1)
        return (1 - w)[:, None] * wp["cond"][i0, kk] + w[:, None] * wp["cond"][i1, kk]  # (N, W)

    rows = (1 - t)[:, None] * row(k) + t[:, None] * row(k + 1)
    j = torch.clamp((rows[:, :W - 1] <= target[:, None]).sum(-1) - 1, 0, W - 2)
    d0, d1 = ref._rows_at(wp, sl, k, t, j, "dens"), ref._rows_at(wp, sl, k, t, j + 1, "dens")
    s = ref._solve(rows.gather(1, j[:, None])[:, 0], d0, d1, 1.0 / (W - 1), target)
    return torch.stack([(j + s) / (W - 1), (k + t) / (H - 1)], -1), (1 - s) * d0 + s * d1


def measured_sample(b: dict, u, wi, prec: Prec = FP32):
    """(wo, pdf) of the measured BRDF sampling itself at uniforms u: the
    luminance warp maps u to s, the vndf warp s to the half vector's
    coordinates (theta_m = u_x^2 pi / 2, phi_m = 2 pi (u_y - 1/2) + phi_i),
    wo the mirror of wi about it; pdf = vndf lum / (4 |wo.wm| 2 pi^2 u_x
    sin theta_m); 0 where wi or wo points down."""
    th_i = torch.arccos(torch.clamp(wi[:, 2], -1.0, 1.0))
    ph_i = torch.atan2(wi[:, 1], wi[:, 0])
    sl = ref._slices(b["theta_i"], th_i)
    s, lum_pdf = warp_sample(b["lum"], u, sl)
    u_wm, vndf_pdf = warp_sample(b["vndf"], s, sl)
    th_m = u_wm[:, 0] * u_wm[:, 0] * (math.pi / 2.0)
    ph_m = (u_wm[:, 1] - 0.5) * (2.0 * math.pi) + ph_i
    st = torch.sin(th_m)
    wm = torch.stack([st * torch.cos(ph_m), st * torch.sin(ph_m), torch.cos(th_m)], -1)
    wo = 2.0 * (wi * wm).sum(-1, keepdim=True) * wm - wi
    jac = 4.0 * (wo * wm).sum(-1).abs() * torch.clamp(2.0 * math.pi ** 2 * u_wm[:, 0] * st, min=1e-6)
    valid = (wo[:, 2] > 0) & (wi[:, 2] > 0)
    return prec.q(wo), prec.q(torch.where(valid, vndf_pdf * lum_pdf / jac, 0.0))


# ------------------------------------------------------------------ bounce


def cosine(u):
    """The diffuse materials' cosine draw (wo, pdf) at uniforms u."""
    r, ph = torch.sqrt(u[:, 0]), 2 * math.pi * u[:, 1]
    z = torch.sqrt(torch.clamp(1 - u[:, 0], min=1e-9))
    return torch.stack([r * torch.cos(ph), r * torch.sin(ph), z], -1), z / math.pi


class SceneBounce:
    """One bounce of rows of a scene of one or many balls under the
    reference. `balls`, one a ball in the scene's order: {"kind":
    "measured" (the measured BRDF `brdf` samples itself and weights MIS
    with its own pdf) or "sphere" (the full-sphere sampler `net`, a
    `render.py` net dict, over the table material `material` times
    `albedo`), "firefly": the clamp on the luminance of f / pdf}."""

    def __init__(self, sc: ref.Scene, balls: list, prec: Prec = FP32):
        self.sc, self.balls, self.p = sc, balls, prec

    def ball_value(self, ball, wi, wo):
        if ball["kind"] == "measured":
            return ref.brdf_eval_pdf(ball["brdf"], wi, wo, self.p)[0]
        f = eval_principled(ball["material"], wi, wo, self.p)[:, None]
        return self.p.q(f * torch.tensor(ball["albedo"], dtype=torch.float32, device=wi.device))

    def ball_pdf(self, ball, wi, wo):
        if ball["kind"] == "measured":
            return ref.brdf_eval_pdf(ball["brdf"], wi, wo, self.p)[1]
        return ref.neural_pdf(ball["net"], wi, wo, self.p)

    def ball_sample(self, ball, rand, rows, wi):
        if ball["kind"] == "measured":
            return measured_sample(ball["brdf"], rand, wi, self.p)
        return ref.neural_sample(ball["net"], rand, rows, wi, self.p)

    def _per_ball(self, mat, fn, wi, wo, out):
        """out with each ball's rows replaced by fn(ball, its rows' wi, wo)."""
        out = [o.clone() for o in out]
        for k, ball in enumerate(self.balls):
            on = mat == MAT_BALL + k
            if bool(on.any()):
                got = fn(ball, wi[on], wo[on])
                for o, g in zip(out, got if isinstance(got, tuple) else (got,)):
                    o[on] = g.to(o.dtype)
        return out

    def diffuse(self, mat, uv, wo):
        cos_o = torch.clamp(wo[:, 2], min=0.0)
        alb = torch.where((mat == MAT_PLANE)[:, None], ref._checker(uv),
                          torch.full((mat.shape[0], 3), 0.18, device=mat.device))
        return alb * (cos_o / math.pi)[:, None], cos_o / math.pi

    def eval(self, mat, uv, wi, wo):
        f, _ = self.diffuse(mat, uv, wo)
        return self._per_ball(mat, self.ball_value, wi, wo, [f])[0]

    def eval_pdf(self, mat, uv, wi, wo):
        f, pdf = self.diffuse(mat, uv, wo)
        return tuple(self._per_ball(mat, lambda b, wi, wo: (self.ball_value(b, wi, wo), self.ball_pdf(b, wi, wo)),
                                    wi, wo, [f, pdf]))

    def sample(self, mat, rnd, rows, wi):
        wo, pdf = cosine(rnd["u_diffuse"])
        for k, ball in enumerate(self.balls):
            on = mat == MAT_BALL + k
            if bool(on.any()):
                rand = rnd["ball"][k]
                rand = rand[on] if torch.is_tensor(rand) else rand
                wb, pb = self.ball_sample(ball, rand, rows[on.cpu().numpy()], wi[on])
                wo, pdf = wo.clone(), pdf.clone()
                wo[on], pdf[on] = wb, pb
        return wo, pdf

    def transmissive(self, mat):
        t = torch.zeros_like(mat, dtype=torch.bool)
        for k, ball in enumerate(self.balls):
            if ball["kind"] == "sphere":
                t |= mat == MAT_BALL + k
        return t

    def firefly(self, mat):
        c = torch.full(mat.shape, math.inf, device=mat.device)
        for k, ball in enumerate(self.balls):
            c = torch.where(mat == MAT_BALL + k, ball["firefly"], c)
        return c

    def __call__(self, state: dict, rnd: dict, rows: np.ndarray, depth: int) -> dict:
        """`state`: ro, rd, L, beta, alive, prev_pdf of the rows; `rnd`:
        u_nee, u_diffuse, u_rr and "ball", one entry a ball (a sampler's
        kernel seed, or a measured ball's uniforms at the rows); `rows`
        the rows' wavefront indices. Returns the rows' next state."""
        sc, p = self.sc, self.p
        ro, rd, L, beta, alive, prev = (state[k] for k in ("ro", "rd", "L", "beta", "alive", "prev_pdf"))
        t, f, u, v = ref.closest_hit(sc, ro, rd, alive, prec=p)
        miss = t >= 1e29
        le = ref.env_eval(sc.env, rd, p)
        w_env = torch.where(prev > 0, ref.mis(prev, ref.env_pdf(sc.env, rd, p)), 1.0)
        L = L + beta * le * (w_env * (alive & miss))[:, None]
        alive = alive & ~miss
        u, v = u[:, None], v[:, None]
        w0 = 1 - u - v
        n = w0 * sc.nrm[f, 0] + u * sc.nrm[f, 1] + v * sc.nrm[f, 2]
        uv = w0 * sc.uv[f, 0] + u * sc.uv[f, 1] + v * sc.uv[f, 2]
        mat = sc.mat[f]
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
        hit_p = ro + rd * t[:, None]
        tg, bt = ref.frame(n)
        wi = ref.local(n, tg, bt, -rd)
        alive = alive & (wi[:, 2] > 0)
        trans = self.transmissive(mat)

        def offset(w):
            return hit_p + n * torch.where(w[:, 2] >= 0, ref.RAY_EPS, -ref.RAY_EPS)[:, None]

        d_env, le_nee, pdf_e = ref.env_sample(sc.env, rnd["u_nee"], p)
        wo_nee = ref.local(n, tg, bt, d_env)
        f_nee, pb_nee = self.eval_pdf(mat, uv, wi, wo_nee)
        cand = alive & (pdf_e > 1e-9) & ((wo_nee[:, 2] > 0) | trans)
        occ = ref.occluded(sc, offset(wo_nee), d_env, torch.full_like(pdf_e, 1e6), cand, p)
        c = beta * f_nee * (le_nee / torch.clamp(pdf_e, min=1e-9)[:, None]) * ref.mis(pdf_e, pb_nee)[:, None]
        L = L + torch.where((cand & ~occ)[:, None], c, 0.0)
        for li in range(sc.lights.shape[0]):
            lp, inten = sc.lights[li, :3], sc.lights[li, 3:]
            dv = lp[None] - hit_p
            dist = torch.clamp(torch.linalg.vector_norm(dv, dim=-1), min=1e-6)
            dl = dv / dist[:, None]
            wl = ref.local(n, tg, bt, dl)
            fl = self.eval(mat, uv, wi, wl)
            cl = alive & ((wl[:, 2] > 0) | trans)
            occ_l = ref.occluded(sc, offset(wl), dl, dist - 2 * ref.RAY_EPS, cl, p)
            L = L + torch.where((cl & ~occ_l)[:, None], beta * fl * (inten[None] / (dist * dist)[:, None]), 0.0)
        wo, pdf_b = self.sample(mat, rnd, rows, wi)
        f_b, pdf_mis = self.eval_pdf(mat, uv, wi, wo)
        ok = alive & (pdf_b > 1e-9) & ((wo[:, 2] > 0) | trans)
        w = f_b / torch.clamp(pdf_b, min=1e-9)[:, None]
        w = torch.where(((mat >= MAT_BALL) & ~(ref._lum(w) < self.firefly(mat)))[:, None], 0.0, w)
        beta = torch.where(ok[:, None], beta * w, beta)
        alive = alive & ok & (w.amax(-1) > 0)
        rd = ref.world(n, tg, bt, wo)
        ro = offset(wo)
        prev = torch.where(alive, pdf_mis, 0.0)
        q = torch.clamp(beta.amax(-1), max=0.95) if depth >= 3 else torch.ones_like(prev)
        beta = beta / torch.clamp(q, min=1e-9)[:, None]
        alive = alive & (rnd["u_rr"] < q)
        return {"ro": ro, "rd": rd, "L": L, "beta": beta, "alive": alive, "prev_pdf": prev}
