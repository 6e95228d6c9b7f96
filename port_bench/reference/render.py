"""The plain reference of one path-tracing bounce and of the pieces it is
made of: camera rays, closest and any hits by testing every triangle, the
lat-long envmap (eval, pdf, importance sampling over its piecewise
bilinear density), the RGL measured BRDF's value and pdf (Dupuy & Jakob
2018), the diffuse checkered plane, the neural samplers' draws and pdfs
(disk and full sphere) and the MIS, Russian roulette and film arithmetic.

It reads the raw scene files itself (`files.py`) and derives every table
again; it imports nothing of the program. Directions are in the program's
conventions: a shading frame with n = +z (Duff et al. 2017), the envmap
in Mitsuba's lat-long convention, the film sample-major.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import files
from .flow import FP32, Prec, disk_heads, disk_log_p0, disk_normals, euler, newton_inverse, pe, sphere_heads, \
    sphere_log_p0, sphere_uniforms, von_mises
from .principled import eval_principled

MAT_PLANE, MAT_DIFFUSE, MAT_BALL = 0, 1, 2
RAY_EPS = 1e-3
INF = 1e30


# ------------------------------------------------------------------ warps


def build_warp(grids: np.ndarray) -> dict:
    """Normalised bilinear densities of (P, H, W) vertex grids, their
    cumulative trapezoids along x and the row integrals' along y, built in
    float64 and held in float32."""
    g = np.maximum(np.asarray(grids, np.float64), 0.0)
    P, H, W = g.shape
    cond = np.concatenate([np.zeros((P, H, 1)), np.cumsum(0.5 * (g[..., 1:] + g[..., :-1]) / (W - 1), -1)], -1)
    rows = cond[..., -1]
    marg = np.concatenate([np.zeros((P, 1)), np.cumsum(0.5 * (rows[:, 1:] + rows[:, :-1]) / (H - 1), -1)], -1)
    tot = np.maximum(marg[:, -1:], 1e-30)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return {"dens": f(g / tot[..., None]), "cond": f(cond / tot[..., None]), "marg": f(marg / tot)}


def _slices(grid: torch.Tensor, v: torch.Tensor):
    """(lower slice, upper slice, weight) of v on an increasing grid."""
    n = grid.shape[0]
    if n == 1:
        z = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
        return z, z, torch.zeros_like(v)
    i = torch.clamp(torch.searchsorted(grid, v.contiguous(), right=True) - 1, 0, n - 2)
    w = torch.clamp((v - grid[i]) / torch.clamp(grid[i + 1] - grid[i], min=1e-12), 0.0, 1.0)
    return i, i + 1, w


def _at(tab, sl, k, j=None):
    """tab[slice, k(, j)] blended over the two slices, indices clamped."""
    i0, i1, w = sl
    k = torch.clamp(k, max=tab.shape[1] - 1)
    if j is None:
        return (1 - w) * tab[i0, k] + w * tab[i1, k]
    j = torch.clamp(j, max=tab.shape[2] - 1)
    return (1 - w) * tab[i0, k, j] + w * tab[i1, k, j]


def _cell(x, n):
    xf = torch.clamp(x * (n - 1), 0.0, n - 1 - 1e-6)
    i = xf.to(torch.int64)
    return i, xf - i


def _rows_at(wp, sl, k, t, j, key):
    return (1 - t) * _at(wp[key], sl, k, j) + t * _at(wp[key], sl, k + 1, j)


def warp_invert(wp: dict, pos, sl):
    """(u (N, 2), density): the uniforms the warp maps to `pos`."""
    P, H, W = wp["dens"].shape
    k, t = _cell(pos[:, 1], H)
    last = torch.full_like(k, W - 1)
    m0, m1 = _at(wp["cond"], sl, k, last), _at(wp["cond"], sl, k + 1, last)
    u2 = _at(wp["marg"], sl, k) + (m0 * t + 0.5 * (m1 - m0) * t * t) / (H - 1)
    j, s = _cell(pos[:, 0], W)
    d0, d1 = _rows_at(wp, sl, k, t, j, "dens"), _rows_at(wp, sl, k, t, j + 1, "dens")
    cx = _rows_at(wp, sl, k, t, j, "cond") + (d0 * s + 0.5 * (d1 - d0) * s * s) / (W - 1)
    u1 = cx / torch.clamp((1 - t) * m0 + t * m1, min=1e-20)
    return torch.stack([u1, u2], -1), (1 - s) * d0 + s * d1


def warp_density(wp: dict, pos, sl):
    P, H, W = wp["dens"].shape
    k, t = _cell(pos[:, 1], H)
    j, s = _cell(pos[:, 0], W)
    return (1 - s) * _rows_at(wp, sl, k, t, j, "dens") + s * _rows_at(wp, sl, k, t, j + 1, "dens")


def _solve(c0, d0, d1, step, target):
    """t in [0, 1] with c0 + step (d0 t + (d1 - d0) t^2 / 2) = target."""
    rhs = torch.clamp((target - c0) / step, min=0.0)
    disc = torch.clamp(d0 * d0 + 2.0 * (d1 - d0) * rhs, min=0.0)
    return torch.clamp(2.0 * rhs / torch.clamp(d0 + torch.sqrt(disc), min=1e-20), 0.0, 1.0)


def warp_sample_one(wp: dict, u):
    """((N, 2) position, density) of a one-slice warp at uniforms u."""
    P, H, W = wp["dens"].shape
    dev = u.device
    z = torch.zeros(u.shape[0], dtype=torch.int64, device=dev)
    sl = (z, z, torch.zeros(u.shape[0], device=dev))
    marg, cond, dens = wp["marg"][0], wp["cond"][0], wp["dens"][0]
    k = torch.clamp((marg[None, :H - 1] <= u[:, 1:2]).sum(-1) - 1, 0, H - 2)
    m0, m1 = cond[k, W - 1], cond[k + 1, W - 1]
    t = _solve(marg[k], m0, m1, 1.0 / (H - 1), u[:, 1])
    target = u[:, 0] * ((1 - t) * m0 + t * m1)
    rows = (1 - t[:, None]) * cond[k] + t[:, None] * cond[k + 1]  # (N, W)
    j = torch.clamp((rows[:, :W - 1] <= target[:, None]).sum(-1) - 1, 0, W - 2)
    d0, d1 = _rows_at(wp, sl, k, t, j, "dens"), _rows_at(wp, sl, k, t, j + 1, "dens")
    s = _solve(torch.gather(rows, 1, j[:, None])[:, 0], d0, d1, 1.0 / (W - 1), target)
    return torch.stack([(j + s) / (W - 1), (k + t) / (H - 1)], -1), (1 - s) * d0 + s * d1


# ----------------------------------------------------------------- scene


@dataclass
class Scene:
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    nrm: torch.Tensor  # (F, 3, 3) corner normals
    uv: torch.Tensor  # (F, 3, 2)
    mat: torch.Tensor  # (F,) int64
    cam: dict
    env: dict
    lights: torch.Tensor  # (L, 6)
    ball: dict  # the matball: {"filename" | "idx", "albedo"}
    brdf: dict | None


def load_scene(xml_path: str, device, width: int, height: int) -> Scene:
    desc = files.read_scene_xml(xml_path)
    parts = {k: [] for k in ("v", "n", "uv", "mat")}
    ball = None
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
        kind = sh["material"]["kind"]
        parts["mat"].append(np.full(len(f), {"plane": MAT_PLANE, "diffuse": MAT_DIFFUSE, "ball": MAT_BALL}[kind]))
        if kind == "ball":
            ball = sh["material"]
    v = torch.from_numpy(np.concatenate(parts["v"]))
    env_desc = desc["envmap"]
    img = files.read_exr(env_desc["file"]) * env_desc["scale"]
    h = img.shape[0]
    lum = np.maximum(0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2], 1e-8)
    warp = build_warp((lum * np.sin((np.arange(h) + 0.5) / h * np.pi)[:, None])[None])
    r = env_desc["to_world"][:3, :3]
    brdf = None
    if ball["filename"]:
        brdf = load_brdf(os.path.join(os.path.dirname(xml_path), ball["filename"] + ".bsdf"))
    to = lambda x: x.to(device)  # noqa: E731
    cam = dict(desc["camera"], width=width, height=height)
    cam["vectors"] = camera_vectors(cam).to(device)
    return Scene(
        v0=to(v[:, 0]), e1=to(v[:, 1] - v[:, 0]), e2=to(v[:, 2] - v[:, 0]),
        nrm=to(torch.from_numpy(np.concatenate(parts["n"]))), uv=to(torch.from_numpy(np.concatenate(parts["uv"]))),
        mat=to(torch.from_numpy(np.concatenate(parts["mat"]))),
        cam=cam,
        env={"data": to(torch.from_numpy(img.astype(np.float32))), "warp": {k: to(t) for k, t in warp.items()},
             "to_world": to(torch.from_numpy(r.astype(np.float32))),
             "to_local": to(torch.from_numpy(np.linalg.inv(r).astype(np.float32)))},
        lights=to(torch.tensor(desc["lights"], dtype=torch.float32).reshape(-1, 6)),
        ball=ball,
        brdf=None if brdf is None else {k: (to(t) if torch.is_tensor(t) else {a: to(b) for a, b in t.items()})
                                        for k, t in brdf.items()},
    )


def camera_vectors(cam: dict) -> torch.Tensor:
    """[origin, right, up, forward]: a look-at camera with the fov on the
    smaller film axis, right and up scaled by the half-angle's tangent."""
    o, t, up = (np.asarray(cam[k], np.float64) for k in ("origin", "target", "up"))
    fwd = (t - o) / np.linalg.norm(t - o)
    r = np.cross(fwd, up)
    r /= np.linalg.norm(r)
    u = np.cross(r, fwd)
    th = math.tan(math.radians(cam["fov"]) / 2)
    w, h = cam["width"], cam["height"]
    rs, us = (th, th * h / w) if w <= h else (th * w / h, th)
    return torch.from_numpy(np.stack([o, r * rs, u * us, fwd]).astype(np.float32))


def camera_rays(cam: dict, u: torch.Tensor, rows: torch.Tensor, spp_chunk: int, prec: Prec = FP32):
    """(origin, direction) of wavefront rows `rows` (sample-major layout:
    pixel = row mod (w h)) from their filter uniforms u (N, 2): a Gaussian
    (stddev 0.5) pixel offset by Box-Muller, clamped to +-2 pixels."""
    o, right, up, fwd = cam["vectors"]
    w, h = cam["width"], cam["height"]
    px = rows % (w * h)
    x, y = (px % w).float(), (px // w).float()
    r = 0.5 * torch.sqrt(-2.0 * torch.log(u[:, 0]))
    ph = 2.0 * math.pi * u[:, 1]
    jx, jy = torch.clamp(r * torch.cos(ph), -2, 2), torch.clamp(r * torch.sin(ph), -2, 2)
    sx = (x + 0.5 + jx) / w * 2 - 1
    sy = (y + 0.5 + jy) / h * 2 - 1
    d = fwd[None] + sx[:, None] * right[None] - sy[:, None] * up[None]
    d = prec.q(d / torch.linalg.vector_norm(d, dim=-1, keepdim=True))
    return o.expand_as(d), d


# ------------------------------------------------------------- traversal


def _hits(sc: Scene, ro, rd, t_max, chunk: int = 64):
    """For each ray, the least t in (1e-4, t_max) over every triangle
    (Moller-Trumbore), its triangle and barycentrics; t_max on a miss."""
    out_t, out_f, out_u, out_v = [], [], [], []
    tiny = torch.where(rd >= 0, 1e-12, -1e-12)
    rd = torch.where(rd.abs() < 1e-12, tiny, rd)
    for a in range(0, ro.shape[0], chunk):
        o, d, tm = ro[a:a + chunk, None], rd[a:a + chunk, None], t_max[a:a + chunk, None]
        p = torch.cross(d.expand(-1, sc.e2.shape[0], -1), sc.e2[None].expand(d.shape[0], -1, -1), dim=-1)
        det = (sc.e1[None] * p).sum(-1)
        ok = det.abs() > 1e-12
        inv = torch.where(ok, 1.0 / det, 0.0)
        s = o - sc.v0[None]
        u = (s * p).sum(-1) * inv
        q = torch.cross(s, sc.e1[None].expand_as(s), dim=-1)
        v = (d * q).sum(-1) * inv
        t = (sc.e2[None] * q).sum(-1) * inv
        valid = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4) & (t < tm)
        t = torch.where(valid, t, INF)
        best, f = t.min(dim=1)
        hit = best < INF
        out_t.append(torch.where(hit, best, tm[:, 0]))
        out_f.append(f)
        out_u.append(torch.where(hit, u.gather(1, f[:, None])[:, 0], 0.0))
        out_v.append(torch.where(hit, v.gather(1, f[:, None])[:, 0], 0.0))
    return torch.cat(out_t), torch.cat(out_f), torch.cat(out_u), torch.cat(out_v)


def closest_hit(sc: Scene, ro, rd, active, t_max=None, prec: Prec = FP32):
    """(t, triangle, u, v): t = t_max (1e30 unless given) on a miss and for
    inactive rays."""
    tm = torch.full((ro.shape[0],), INF, device=ro.device) if t_max is None else t_max
    t, f, u, v = _hits(sc, prec.q(ro), prec.q(rd), tm)
    return torch.where(active, t, tm), f, u, v


def occluded(sc: Scene, ro, rd, t_max, active, prec: Prec = FP32):
    """Some triangle hit at t in (1e-4, 0.9999 t_max)."""
    t, _, _, _ = _hits(sc, prec.q(ro), prec.q(rd), t_max)
    return active & (t < t_max * 0.9999)


# ---------------------------------------------------------------- envmap


def _dir_uv(env, d):
    dl = d @ env["to_local"].T
    u = (1.0 + torch.atan2(dl[:, 0], -dl[:, 2]) / math.pi) * 0.5
    return u, torch.arccos(torch.clamp(dl[:, 1], -1.0, 1.0)) / math.pi


def env_eval(env, d, prec: Prec = FP32):
    """Radiance from world direction d, bilinear over texels."""
    u, v = _dir_uv(env, d)
    img = env["data"]
    h, w, _ = img.shape
    x = torch.clamp(u * w - 0.5, 0.0, w - 1 - 1e-3)
    y = torch.clamp(v * h - 0.5, 0.0, h - 1 - 1e-3)
    x0, y0 = x.long(), y.long()
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    lo = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    hi = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return prec.q(lo * (1 - fy) + hi * fy)


def _uv_pdf_sa(pdf_uv, v):
    return pdf_uv / (2.0 * math.pi ** 2 * torch.clamp(torch.sin(v * math.pi), min=1e-6))


def env_pdf(env, d, prec: Prec = FP32):
    u, v = _dir_uv(env, d)
    n = u.shape[0]
    z = torch.zeros(n, dtype=torch.int64, device=u.device)
    pdf = warp_density(env["warp"], torch.stack([u, v], -1), (z, z, torch.zeros(n, device=u.device)))
    return prec.q(_uv_pdf_sa(pdf, v))


def env_sample(env, u2, prec: Prec = FP32):
    """(world direction, its radiance, its solid-angle pdf)."""
    pos, pdf = warp_sample_one(env["warp"], u2)
    ph, th = (2.0 * pos[:, 0] - 1.0) * math.pi, pos[:, 1] * math.pi
    st = torch.sin(th)
    d = prec.q(torch.stack([st * torch.sin(ph), torch.cos(th), -st * torch.cos(ph)], -1) @ env["to_world"].T)
    return d, env_eval(env, d, prec), prec.q(_uv_pdf_sa(pdf, pos[:, 1]))


# -------------------------------------------------------- measured BRDF


def load_brdf(path: str) -> dict:
    """The RGL file's tables; the vndf and luminance warps built again."""
    tf = files.read_tensor_file(path)
    if tf["phi_i"].shape[0] != 1:
        raise ValueError("the reference reads isotropic RGL files only")
    f = lambda k: torch.from_numpy(np.array(tf[k], np.float32))  # noqa: E731
    return {"theta_i": f("theta_i"), "sigma": f("sigma"), "ndf": f("ndf"), "rgb": f("rgb")[0],
            "vndf": build_warp(np.asarray(tf["vndf"], np.float64)[0]),
            "lum": build_warp(np.asarray(tf["luminance"], np.float64)[0])}


def _lookup(tab, ux, uy):
    """Bilinear (H, W[, C]) lookup at unit coordinates."""
    H, W = tab.shape[0], tab.shape[1]
    xf = torch.clamp(ux * (W - 1), 0.0, W - 1 - 1e-6)
    yf = torch.clamp(uy * (H - 1), 0.0, H - 1 - 1e-6)
    x0, y0 = xf.long(), yf.long()
    fx, fy = xf - x0, yf - y0
    x1, y1 = torch.clamp(x0 + 1, max=W - 1), torch.clamp(y0 + 1, max=H - 1)
    if tab.ndim == 3:
        fx, fy = fx[:, None], fy[:, None]
    return (tab[y0, x0] * (1 - fx) * (1 - fy) + tab[y0, x1] * fx * (1 - fy) + tab[y1, x0] * (1 - fx) * fy
            + tab[y1, x1] * fx * fy)


def brdf_eval_pdf(b: dict, wi, wo, prec: Prec = FP32):
    """(f cos (N, 3), pdf (N,)) of the measured BRDF: the half vector's
    warp coordinates u = (sqrt(2 theta_m / pi), (phi_m - phi_i) / 2 pi +
    1/2 mod 1) inverted through the vndf warp to s; f = rgb(s) D / (4
    sigma(wi)); pdf = vndf(s) lum(s) / (4 |wo.wm| 2 pi^2 u_x sin theta_m).
    Tables blend the two theta_i slices that bracket theta_i."""
    active = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    wm = wi + wo
    wm = wm / torch.clamp(torch.linalg.vector_norm(wm, dim=-1, keepdim=True), min=1e-12)
    th_i = torch.arccos(torch.clamp(wi[:, 2], -1, 1))
    ph_i = torch.atan2(wi[:, 1], wi[:, 0])
    th_m = torch.arccos(torch.clamp(wm[:, 2], -1, 1))
    ph_m = torch.atan2(wm[:, 1], wm[:, 0])
    ux = torch.sqrt(torch.clamp(th_m * (2 / math.pi), min=0.0))
    uy = (ph_m - ph_i) / (2 * math.pi) + 0.5
    uy = uy - torch.floor(uy)
    sl = _slices(b["theta_i"], th_i)
    s, vpdf = warp_invert(b["vndf"], torch.stack([ux, uy], -1), sl)
    rgb = b["rgb"]  # (T, 3, h, w)
    fr = (1 - sl[2])[:, None] * _lookup_rows(rgb, sl[0], s) + sl[2][:, None] * _lookup_rows(rgb, sl[1], s)
    d = _lookup(b["ndf"], ux, uy)
    sig = _lookup(b["sigma"], torch.sqrt(torch.clamp(th_i * (2 / math.pi), min=0.0)), ph_i / (2 * math.pi) + 0.5)
    f = torch.clamp(fr * (d / torch.clamp(4 * sig, min=1e-12))[:, None], min=0.0)
    lum = warp_density(b["lum"], s, sl)
    jac = 4.0 * (wo * wm).sum(-1).abs() * torch.clamp(2 * math.pi ** 2 * ux * torch.sin(th_m), min=1e-6)
    return prec.q(torch.where(active[:, None], f, 0.0)), prec.q(torch.where(active, vpdf * lum / jac, 0.0))


def _lookup_rows(rgb, p, s):
    """(N, 3) bilinear lookup of slice p's (3, h, w) table at unit s."""
    _, _, h, w = rgb.shape
    xf = torch.clamp(s[:, 0] * (w - 1), 0.0, w - 1 - 1e-6)
    yf = torch.clamp(s[:, 1] * (h - 1), 0.0, h - 1 - 1e-6)
    x0, y0 = xf.long(), yf.long()
    fx, fy = (xf - x0)[:, None], (yf - y0)[:, None]
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    c = lambda yy, xx: rgb[p, :, yy, xx]  # noqa: E731
    return c(y0, x0) * (1 - fx) * (1 - fy) + c(y0, x1) * fx * (1 - fy) + c(y1, x0) * (1 - fx) * fy + c(y1, x1) * fx * fy


# -------------------------------------------------------------- samplers


def _pole(sin_t):
    return torch.clamp(1.0 / torch.clamp(sin_t, min=5e-5), 0.0, 1e6)


def sph_coords(w):
    r = torch.linalg.vector_norm(w, dim=-1)
    return torch.stack([torch.arccos(torch.clamp(w[:, 2] / (r + 1e-8), -1, 1)), torch.atan2(w[:, 1], w[:, 0])], -1)


def sph_dir(x):
    st = torch.sin(x[:, 0])
    return torch.stack([st * torch.cos(x[:, 1]), st * torch.sin(x[:, 1]), torch.cos(x[:, 0])], -1)


def neural_sample(net: dict, seed: int, rows: np.ndarray, wi, prec: Prec = FP32):
    """(wo, solid-angle pdf) of the neural sampler's draw for wavefront rows
    `rows` under kernel seed `seed`. Disk: x0 = loc + eps exp(log_scale),
    T forward steps, pdf = p0 / det, wo lifted from the disk (x cos theta_o,
    rejected past r^2 = 0.995). Full sphere: theta0 Gaussian, phi0 von
    Mises, T steps on (theta, phi), x 1/sin theta (rejected near the poles
    and outside (0, pi)). Draws under a downward wi carry pdf 0."""
    dev = wi.device
    if net["domain"] == "disk":
        cond = pe(wi[:, :2], 5)
        loc, ls = disk_heads(net["base"], cond, prec)
        eps = torch.from_numpy(disk_normals(seed, rows)).to(dev)
        x0 = loc + eps * torch.exp(ls)
        x, det = euler(net["v"], "disk", x0, cond, net["T"], det=True, prec=prec)
        pdf = torch.exp(disk_log_p0(loc, ls, x0)) / det
        valid = (x * x).sum(-1) <= 0.995
        wo = torch.cat([x, torch.sqrt(torch.clamp(1 - (x * x).sum(-1, keepdim=True), min=0.0))], -1)
        pdf = pdf * torch.clamp(wo[:, 2], min=0.0)
    else:
        om = sph_coords(wi)
        cond = pe(om, 5)
        heads = sphere_heads(net["base"], cond, prec)
        eps_g, u = sphere_uniforms(seed, rows)
        eps_g, u = torch.from_numpy(eps_g).to(dev), torch.from_numpy(u).to(dev)
        x0 = torch.stack([heads[0] + eps_g * (torch.exp(heads[1]) + 1e-3), von_mises(u, heads[2], heads[3])], -1)
        x, det = euler(net["v"], "spherical", x0, cond, net["T"], det=True, prec=prec)
        pdf = torch.exp(sphere_log_p0(heads, x0)) / det
        st = torch.sin(x[:, 0])
        valid = (st > 5e-5) & (x[:, 0] > 0) & (x[:, 0] < math.pi)
        wo = sph_dir(x)
        pdf = pdf * _pole(st)
    valid = valid & (wi[:, 2] > 0)
    return prec.q(wo), prec.q(torch.where(valid, torch.clamp(pdf, min=0.0), 0.0))


def neural_pdf(net: dict, wi, wo, prec: Prec = FP32):
    """The full-sphere sampler's solid-angle pdf of wo: p0 at the point the
    flow came from (the exact Newton inverse of the forward map, or reverse
    Euler with `pdf_exact` false), over the det, x 1/sin theta."""
    om = sph_coords(wi)
    cond = pe(om, 5)
    x = sph_coords(wo)
    if net["pdf_exact"]:
        x0, d = newton_inverse(net["v"], "spherical", x, cond, net["T"], net["newton_iters"], prec)
        p = torch.exp(sphere_log_p0(sphere_heads(net["base"], cond, prec), x0)) / d
    else:
        x0, d = euler(net["v"], "spherical", x, cond, net["T"], reverse=True, det=True, prec=prec)
        p = torch.exp(sphere_log_p0(sphere_heads(net["base"], cond, prec), x0)) * d
    p = p * _pole(torch.sin(x[:, 0]))
    return prec.q(torch.where(wi[:, 2] > 0, torch.clamp(p, min=0.0), 0.0))


def table_eval(sc: Scene, net: dict, wi, wo, prec: Prec = FP32):
    """(N, 3) a table matball's f cos: the material's grey value times the
    albedo tint."""
    f = eval_principled(net["material"], wi, wo, prec)[:, None]
    return prec.q(f * torch.tensor(sc.ball["albedo"], dtype=torch.float32, device=wi.device))


# ---------------------------------------------------------------- bounce


def frame(n):
    sign = torch.where(n[:, 2] >= 0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1 + sign * n[:, 0] ** 2 * a, sign * b, -sign * n[:, 0]], -1)
    bt = torch.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], -1)
    return t, bt


def local(n, t, bt, w):
    return torch.stack([(w * t).sum(-1), (w * bt).sum(-1), (w * n).sum(-1)], -1)


def world(n, t, bt, w):
    return w[:, 0:1] * t + w[:, 1:2] * bt + w[:, 2:3] * n


def mis(a, b):
    a2 = a * a
    return torch.where(a > 0, a2 / torch.clamp(a2 + b * b, min=1e-20), 0.0)


def _lum(w):
    return 0.2126 * w[:, 0] + 0.7152 * w[:, 1] + 0.0722 * w[:, 2]


def _checker(uv):
    st = torch.floor(uv * 8.0).long()
    even = (st[:, 0] + st[:, 1]) % 2 == 0
    return torch.where(even, 0.4, 0.2)[:, None].expand(-1, 3)


class Bounce:
    """One bounce of the wavefront's rows under the reference, the matball
    sampled by the neural sampler `net` (disk over a measured BRDF, or full
    sphere over a table material)."""

    def __init__(self, sc: Scene, net: dict | None, prec: Prec = FP32):
        self.sc, self.net, self.p = sc, net, prec

    def ball_eval_pdf(self, wi, wo):
        """The matball's (f cos, MIS pdf): measured (the proxy a neural
        measured matball weights with), or the table material's value and
        the neural sampler's pdf."""
        if self.sc.brdf is not None:
            return brdf_eval_pdf(self.sc.brdf, wi, wo, self.p)
        return table_eval(self.sc, self.net, wi, wo, self.p), neural_pdf(self.net, wi, wo, self.p)

    def eval_pdf(self, mat, uv, wi, wo):
        cos_o = torch.clamp(wo[:, 2], min=0.0)
        alb = torch.where((mat == MAT_PLANE)[:, None], _checker(uv), torch.full((mat.shape[0], 3), 0.18,
                                                                               device=mat.device))
        f, pdf = alb * (cos_o / math.pi)[:, None], cos_o / math.pi
        fb, pb = self.ball_eval_pdf(wi, wo)
        ball = mat == MAT_BALL
        return torch.where(ball[:, None], fb, f), torch.where(ball, pb, pdf)

    def __call__(self, state: dict, rnd: dict, rows: np.ndarray, depth: int) -> dict:
        """`state`: ro, rd, L, beta, alive, prev_pdf of the rows; `rnd`:
        u_nee, u_diffuse, ball seed, u_rr. Returns the rows' next state."""
        sc, p = self.sc, self.p
        ro, rd, L, beta, alive, prev = (state[k] for k in ("ro", "rd", "L", "beta", "alive", "prev_pdf"))
        t, f, u, v = closest_hit(sc, ro, rd, alive, prec=p)
        miss = t >= 1e29
        le = env_eval(sc.env, rd, p)
        w_env = torch.where(prev > 0, mis(prev, env_pdf(sc.env, rd, p)), 1.0)
        L = L + beta * le * (w_env * (alive & miss))[:, None]
        alive = alive & ~miss
        u, v = u[:, None], v[:, None]
        w0 = 1 - u - v
        n = w0 * sc.nrm[f, 0] + u * sc.nrm[f, 1] + v * sc.nrm[f, 2]
        uv = w0 * sc.uv[f, 0] + u * sc.uv[f, 1] + v * sc.uv[f, 2]
        mat = sc.mat[f]
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
        hit_p = ro + rd * t[:, None]
        tg, bt = frame(n)
        wi = local(n, tg, bt, -rd)
        alive = alive & (wi[:, 2] > 0)
        trans = (mat == MAT_BALL) & (self.net["domain"] == "sphere_full")

        def offset(w):
            return hit_p + n * torch.where(w[:, 2] >= 0, RAY_EPS, -RAY_EPS)[:, None]

        d_env, le_nee, pdf_e = env_sample(sc.env, rnd["u_nee"], p)
        wo_nee = local(n, tg, bt, d_env)
        f_nee, pb_nee = self.eval_pdf(mat, uv, wi, wo_nee)
        cand = alive & (pdf_e > 1e-9) & ((wo_nee[:, 2] > 0) | trans)
        occ = occluded(sc, offset(wo_nee), d_env, torch.full_like(pdf_e, 1e6), cand, p)
        c = beta * f_nee * (le_nee / torch.clamp(pdf_e, min=1e-9)[:, None]) * mis(pdf_e, pb_nee)[:, None]
        L = L + torch.where((cand & ~occ)[:, None], c, 0.0)
        for li in range(sc.lights.shape[0]):
            lp, inten = sc.lights[li, :3], sc.lights[li, 3:]
            dv = lp[None] - hit_p
            dist = torch.clamp(torch.linalg.vector_norm(dv, dim=-1), min=1e-6)
            dl = dv / dist[:, None]
            wl = local(n, tg, bt, dl)
            fl, _ = self.eval_pdf(mat, uv, wi, wl)
            cl = alive & ((wl[:, 2] > 0) | trans)
            occ_l = occluded(sc, offset(wl), dl, dist - 2 * RAY_EPS, cl, p)
            L = L + torch.where((cl & ~occ_l)[:, None], beta * fl * (inten[None] / (dist * dist)[:, None]), 0.0)
        # the diffuse materials' cosine draw; the matball's own draw
        ud = rnd["u_diffuse"]
        r, ph = torch.sqrt(ud[:, 0]), 2 * math.pi * ud[:, 1]
        z = torch.sqrt(torch.clamp(1 - ud[:, 0], min=1e-9))
        wo = torch.stack([r * torch.cos(ph), r * torch.sin(ph), z], -1)
        pdf_b = z / math.pi
        ball = mat == MAT_BALL
        wo_b, pb = neural_sample(self.net, rnd["seed"], rows, wi, p)
        wo = torch.where(ball[:, None], wo_b, wo)
        pdf_b = torch.where(ball, pb, pdf_b)
        f_b, pdf_mis = self.eval_pdf(mat, uv, wi, wo)
        ok = alive & (pdf_b > 1e-9) & ((wo[:, 2] > 0) | trans)
        w = f_b / torch.clamp(pdf_b, min=1e-9)[:, None]
        clamp = self.net["firefly"]
        w = torch.where(ball[:, None] & ~(_lum(w) < clamp)[:, None], 0.0, w)
        beta = torch.where(ok[:, None], beta * w, beta)
        alive = alive & ok & (w.amax(-1) > 0)
        rd = world(n, tg, bt, wo)
        ro = offset(wo)
        prev = torch.where(alive, pdf_mis, 0.0)
        q = torch.clamp(beta.amax(-1), max=0.95) if depth >= 3 else torch.ones_like(prev)
        beta = beta / torch.clamp(q, min=1e-9)[:, None]
        alive = alive & (rnd["u_rr"] < q)
        return {"ro": ro, "rd": rd, "L": L, "beta": beta, "alive": alive, "prev_pdf": prev}
