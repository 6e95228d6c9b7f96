"""Render cells over scenes of many matballs, point lights and the
ground-truth mode: `render/integrator.py::render` called back to back,
one caller, as `render.py`'s cells call it, on

- the array (`render/procedural.py::write_array_scene`): one full-sphere
  sampler a ball over its table material, lit by a point light; or
- the matpreview stand-in (`write_scene`) in `gt` mode: the measured BRDF
  samples itself (`integrator.measured_matball`).

It reuses `render.py`'s recorders (camera rays, traversals, envmap, film)
and records the matball pieces where the integrator dispatches them to
the materials (`_shade_sample`, `_shade_eval_pdf`, `_shade_eval`), whole
rows of the wavefront, whatever runs under them: every ball's callbacks
over the whole wavefront, or rows routed ball by ball. After the recorded
bounce its judged rows are drawn: rows of every ball the bounce has alive
(`PER_BALL` of each, or all it has) beside `render.py`'s random rows. Of
a window's calls, the last and up to JUDGED_CALLS - 1 others drawn from
the seed keep their recording to be judged.
The reference (`reference/scene.py`) judges, on those rows, each piece
from the program's inputs to it: the draw where the program draws it
(the rows it routes, or every live one), the materials' values, the pdf
queries where the program queries them; a row the routing leaves out
against what the program says it holds (the diffuse plane's cosine draw
and pdf); and the whole bounce from the program's state before it, over
all judged rows and ball by ball.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from port_bench.counts import routed, work
from port_bench.drivers import render as base
from port_bench.harness import weights
from port_bench.harness.gaps import abs_gap, rel_gap, share
from port_bench.reference import render as ref
from port_bench.reference import scene as refscene
from port_bench.reference.flow import FP32, LOW

SHADE = ("_shade_sample", "_shade_eval_pdf", "_shade_eval")
PER_BALL = 384  # judged rows of each ball at the recorded bounce
JUDGED_CALLS = 8  # calls whose recorded bounce is judged: the last, and others drawn from the seed
GT_CLAMP = 30.0  # `measured_matball`'s firefly clamp, as `cli/render.py` renders gt


def _ball_seed(rand):
    """The int kernel seed of a ball's draw (a (1,) tensor or a shard's
    `RowSeed`)."""
    return int((rand.seed if hasattr(rand, "row0") else rand).reshape(-1)[0])


class Driver(base.Driver):
    span = "render_call"
    unit = "render_msamples_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tmpdir: str):
        from bsdf_diffusion_sampling_tpu_torch.render import integrator, procedural
        from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene

        self.cfg, self.seed, self.device = cfg, seed, device
        self.integ = integrator
        t, sc = traffic, cfg["scene"]
        self.w, self.h = t["width"], t["height"]
        self.spp, self.chunk, self.depth = t["spp"], t["spp_chunk"], t["max_depth"]
        self.passes = max(self.spp // self.chunk, 1)
        self.n = self.w * self.h * self.chunk
        self.mode = t["mode"]
        self.dir = os.path.join(tmpdir, f"port_bench_scene_{cfg['name']}")
        if "balls" in cfg:
            balls = [(b["idx"], tuple(b["albedo"])) for b in cfg["balls"]]
            light = tuple(sc["point_light"]) if sc.get("point_light") else None
            self.xml = procedural.write_array_scene(self.dir, kind=sc["kind"], balls=balls, n_lat=sc["n_lat"],
                                                    n_lon=sc["n_lon"], plane_g=sc["plane_g"], width=self.w,
                                                    height=self.h, spp=self.spp, max_depth=self.depth,
                                                    point_light=light)
        else:
            self.xml = procedural.write_scene(self.dir, n_lat=sc["n_lat"], n_lon=sc["n_lon"], plane_g=sc["plane_g"],
                                              env_res=tuple(sc["env_res"]), width=self.w, height=self.h,
                                              spp=self.spp, max_depth=self.depth)
        self.scene = load_scene(self.xml, device=device, width=self.w, height=self.h)
        self.balls, self.ref_balls = self._balls(cfg, t, seed, device)
        rng = np.random.default_rng([seed, 7])
        self.rows = np.sort(rng.choice(self.n, size=min(base.ROWS, self.n), replace=False))
        self.rows_dev = torch.as_tensor(self.rows, device=device)
        self.pixels = np.sort(rng.choice(self.w * self.h, size=min(base.PIXELS, self.w * self.h), replace=False))
        film_rows = np.concatenate([s * self.w * self.h + self.pixels for s in range(self.chunk)])
        self.film_rows = torch.as_tensor(film_rows, device=device)
        self.plan = np.random.default_rng([seed, 11])
        self.pick = np.random.default_rng([seed, 19])
        self.caps, self.cur, self.rec = [], None, None
        self.orig = {name: getattr(integrator, name) for name in base.PATCHED + SHADE}
        for name in base.PATCHED + SHADE:
            setattr(integrator, name, getattr(self, "_" + name.strip("_")))

    def _balls(self, cfg, t, seed, device):
        """(the program's matballs, the reference's balls) in the scene's
        ball order: full-sphere samplers of weights drawn from the seed,
        one set a ball; or the measured BRDF sampling itself."""
        from bsdf_diffusion_sampling_tpu_torch.bsdf.materials import BSDF_MATERIALS
        from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured
        from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, SamplerConfig
        from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf

        if self.mode == "gt":
            brdf = load_measured(os.path.join(self.dir, cfg["material"] + ".bsdf"), device=device)
            return (self.integ.measured_matball(brdf, firefly_clamp=GT_CLAMP),), [
                {"kind": "measured", "filename": cfg["material"], "firefly": GT_CLAMP}]
        dims = weights.velocity_dims(cfg["velocity_hidden"], cfg["velocity_layers"], 3)
        mcfg = ModelConfig(domain=cfg["domain"], velocity_hidden=cfg["velocity_hidden"],
                           velocity_layers=cfg["velocity_layers"])
        scfg = SamplerConfig(pdf_exact=t.get("pdf_exact", True))
        prog, refs = [], []
        for i, b in enumerate(cfg["balls"]):
            s = int(np.random.default_rng([seed, 17, i]).integers(0, 2 ** 62))
            w = weights.make(s, {"base": ("base", None), "v": ("velocity", dims)}, device)
            net = {"domain": cfg["domain"], "base": weights.clone(w["base"]), "v": weights.clone(w["v"]),
                   "T": cfg["T"], "firefly": cfg["firefly_clamp"], "pdf_exact": t.get("pdf_exact", True),
                   "newton_iters": cfg["pdf_newton_iters"]}
            nb = make_neural_bsdf(cfg["domain"], mcfg, w["v"], {"net": w["base"]}, sampler_cfg=scfg, device=device)
            prog.append(self.integ.neural_matball_sphere(nb, BSDF_MATERIALS[b["idx"]], tuple(b["albedo"])))
            refs.append({"kind": "sphere", "net": net, "material": b["material_params"],
                         "albedo": tuple(b["albedo"]), "firefly": cfg["firefly_clamp"]})
        return tuple(prog), refs

    # ------------------------------------------------------------ recorders

    def _bounce_body(self, accel, env, lights, state, rnd, depth, *, matball, mark=None):
        fn = self.orig["_bounce_body"]
        index, self.n_bounce = self.n_bounce, self.n_bounce + 1
        if index != self.cap_index:
            return fn(accel, env, lights, state, rnd, depth, matball=matball, mark=mark)
        self.rec = {"shade": []}
        out, tr = fn(accel, env, lights, state, rnd, depth, matball=matball, mark=mark)
        shade, self.rec["shade"] = self.rec["shade"], None
        rows = self._judged_rows(shade[0]["mat_id"], state[5])
        tk = lambda x: x.index_select(0, rows)  # noqa: E731
        self.rec.update({
            "rows": rows.cpu().numpy(), "depth": depth,
            "in": {k: tk(v) for k, v in zip(base.STATE, state)},
            "out": {k: tk(v) for k, v in zip(base.STATE, out)},
            "rnd": {"u_nee": tk(rnd.u_nee), "u_diffuse": tk(rnd.u_diffuse), "u_rr": tk(rnd.u_rr),
                    "ball": [tk(b) if torch.is_tensor(b) and b.ndim == 2 else _ball_seed(b) for b in rnd.ball]},
            # a program that routes a scene of this many balls (the parent of the routing has no threshold)
            "routed": len(self.balls) >= getattr(self.integ, "ROUTE_MIN_BALLS", float("inf")),
            "shade": [{"kind": s["kind"], **{k: (tk(v) if torch.is_tensor(v) else v) for k, v in s.items()
                                             if k != "kind"}} for s in shade],
        })
        self.cur["bounce"], self.rec = self.rec, None
        return out, tr

    def _judged_rows(self, mat_id, alive) -> torch.Tensor:
        """`render.py`'s random rows, and up to PER_BALL of each ball's live
        rows, drawn from the seed."""
        picked = [self.rows_dev]
        for k in range(len(self.balls)):
            on = torch.nonzero((mat_id == self.integ.MAT_BALL + k) & alive)[:, 0]
            if on.numel() > PER_BALL:
                on = on[torch.as_tensor(self.pick.choice(on.numel(), PER_BALL, replace=False), device=on.device)]
            picked.append(on)
        return torch.unique(torch.cat(picked))

    def _shade(self, kind, fn, args, kw):
        out = fn(*args, **kw)
        if self.rec is not None and self.rec.get("shade") is not None:
            if kind == "sample":
                _, rnd, mat_id, wi = args
                rec = {"mat_id": mat_id, "wi": wi, "wo": out[0], "pdf": out[1]}
            else:
                _, mat_id, uv, wi, wo = args
                rec = {"mat_id": mat_id, "uv": uv, "wi": wi, "wo_in": wo, "f": out[0] if kind == "eval_pdf" else out}
                if kind == "eval_pdf":
                    rec["pdf"] = out[1]
            if kw.get("need") is not None:
                rec["need"] = kw["need"]
            self.rec["shade"].append({"kind": kind, **rec})
        return out

    def _shade_sample(self, *args, **kw):
        return self._shade("sample", self.orig["_shade_sample"], args, kw)

    def _shade_eval_pdf(self, *args, **kw):
        return self._shade("eval_pdf", self.orig["_shade_eval_pdf"], args, kw)

    def _shade_eval(self, *args, **kw):
        return self._shade("eval", self.orig["_shade_eval"], args, kw)

    # --------------------------------------------------------------- calls

    def _render(self, k: int, spp: int):
        self.n_bounce = self.n_pass = 0
        self.cap_pass = int(self.plan.integers(0, max(spp // self.chunk, 1)))
        self.cap_index = self.cap_pass * self.depth + int(self.plan.integers(0, min(base.DEPTHS, self.depth)))
        self.cur = {"film": []}
        seed = int(np.random.default_rng([self.seed, 13, k]).integers(0, 2 ** 62))
        img = self.integ.render(self.scene, self.balls, seed=seed, spp=spp, spp_chunk=self.chunk,
                                max_depth=self.depth, device=self.device)
        self.cur["image"] = torch.from_numpy(img.reshape(-1, 3)[self.pixels]).to(self.device)
        if self.caps:
            self.caps[-1].pop("film", None)  # the last call's film alone is judged
        if len(self.caps) >= JUDGED_CALLS:  # drop one of the earlier calls, drawn from the seed
            self.caps.pop(int(self.pick.integers(0, len(self.caps))))
        self.caps.append(self.cur)

    def work(self) -> dict:
        """What one call counts: the traversals, two a bounce and one more
        a point light (closest hit, the envmap's shadow ray, each light's);
        for full-sphere samplers, the work of one routed row of the draw
        and of the exact pdf query (`counts/routed.py`), which the routed
        kernels' rooflines scale by the program's row counters."""
        c = self.cfg
        traversals = 2 + len(self.scene.desc.point_lights)
        out = {"passes": self.passes,
               "k5": work.scale(work.traversal(self.n), traversals * self.depth * self.passes)}
        if self.mode != "gt":
            args = (c["velocity_hidden"], c["velocity_layers"], 3, c["T"])
            out["sph_draw_routed"] = dict(work.draw(1, *args), rows=1.0)
            out["sph_query_routed"] = dict(routed.query(1, *args, c["pdf_newton_iters"]), rows=1.0)
        return out

    def release(self):
        super().release()
        self.balls = None

    # ---------------------------------------------------------------- check

    @torch.no_grad()
    def check(self, control: bool = False) -> list:
        """[(name, reading, limit)]: the program's pieces against the
        reference's on the recorded rows; with `control`, the reference in
        lower precision judged in the program's place."""
        sc = refscene.load_scene(self.xml, self.device, self.w, self.h)
        balls = [dict(b, brdf=sc.brdf[b["filename"]]) if b["kind"] == "measured" else b for b in self.ref_balls]
        bounce, low = refscene.SceneBounce(sc, balls, FP32), refscene.SceneBounce(sc, balls, LOW)
        acc = {k: [] for k in ("rays", "hits", "sdir", "spdf", "qpdf", "mat", "env", "bounce", "ball", "out")}
        for cap in self.caps:
            self._check_common(cap, sc, control, acc)
            b = cap["bounce"]
            prog = low if control else None
            for s in b["shade"]:
                self._check_shade(s, b, bounce, prog, acc)
            s_in = {k: b["in"][k] for k in ("ro", "rd", "L", "beta", "alive", "prev_pdf")}
            want = bounce(s_in, b["rnd"], b["rows"], b["depth"])
            got = low(s_in, b["rnd"], b["rows"], b["depth"]) if control else b["out"]
            off = self._bounce_off(got, want)
            acc["bounce"].append((off, s_in["alive"]))
            mat = b["shade"][0]["mat_id"]
            for k in range(len(balls)):
                on = (mat == ref.MAT_BALL + k) & s_in["alive"]
                if bool(on.any()):
                    acc["ball"].append(share(off, on))
        film = self._film_gap(control)

        def shares(key):
            flags = [f if among is None else f[among] for f, among in acc[key]]
            return share(torch.cat(flags)) if flags else 0.0

        readings = {
            "rays_gap": max(acc["rays"], default=0.0),
            "hits_off_share": shares("hits"),
            "sampler_dir_gap": max(acc["sdir"], default=0.0),
            "sampler_pdf_gap": max(acc["spdf"], default=0.0),
            "material_gap": max(acc["mat"], default=0.0),
            "pdf_query_gap": max(acc["qpdf"], default=0.0),
            "routed_out_gap": max(acc["out"], default=0.0),
            "envmap_gap": max(acc["env"], default=0.0),
            "bounce_off_share": shares("bounce"),
            "ball_off_share": max(acc["ball"], default=0.0),
            "film_gap": film,
        }
        return [(k, v, self.limits[k]) for k, v in readings.items() if k in self.limits]

    def _check_common(self, cap, sc, control, acc):
        """Camera rays, traversals and the envmap, as `render.py` judges them."""
        rows = self.rows_dev
        init = cap.get("init")
        if init is not None:
            _, rd = ref.camera_rays(sc.cam, init["u"], rows, self.chunk)
            got = ref.camera_rays(sc.cam, init["u"], rows, self.chunk, LOW)[1] if control else init["rd"]
            acc["rays"].append(abs_gap(got, rd))
        b = cap["bounce"]
        for r in b.get("isect", []):
            if r["any_hit"]:
                occ = ref.occluded(sc, r["ro"], r["rd"], r["t_max"], r["active"])
                got = ref.occluded(sc, r["ro"], r["rd"], r["t_max"], r["active"], LOW) if control else \
                    r["active"] & (r["t"] < r["t_max"] * 0.9999)
                acc["hits"].append(((got != occ) & r["active"], r["active"]))
            else:
                t = ref.closest_hit(sc, r["ro"], r["rd"], r["active"], r["t_max"])[0]
                tp = ref.closest_hit(sc, r["ro"], r["rd"], r["active"], r["t_max"], LOW)[0] if control else r["t"]
                miss, miss_p = t >= 1e29, tp >= 1e29
                off = (miss != miss_p) | (~miss & ((tp - t).abs() > 1e-4 * torch.clamp(t, min=1.0)))
                acc["hits"].append((off & r["active"], r["active"]))
        if "env_sample" in b:
            es = b["env_sample"]
            want = ref.env_sample(sc.env, es["u"])
            got = ref.env_sample(sc.env, es["u"], LOW) if control else es["out"]
            acc["env"].append(max(abs_gap(got[0], want[0]), rel_gap(got[1], want[1]), rel_gap(got[2], want[2])))
        for key, fn in (("env_eval", ref.env_eval), ("env_pdf", ref.env_pdf)):
            if key in b:
                want = fn(sc.env, b[key]["d"])
                got = fn(sc.env, b[key]["d"], LOW) if control else b[key]["out"]
                acc["env"].append(rel_gap(got, want))

    def _check_shade(self, s, b, bounce, low, acc):
        """One recorded dispatch: each ball's rows the program computes for
        it against the reference from the same inputs; with `low`, the
        control in the program's place."""
        mat, wi = s["mat_id"].long(), s["wi"]
        up = wi[:, 2] > 0
        need = s.get("need")
        for k, ball in enumerate(bounce.balls):
            on = (mat == ref.MAT_BALL + k) & up
            if not bool(on.any()):
                continue
            want_rows = on if need is None else on & need
            rows_np = b["rows"][want_rows.cpu().numpy()]
            if s["kind"] == "sample" and bool(want_rows.any()):
                rand = b["rnd"]["ball"][k]
                rand = rand[want_rows] if torch.is_tensor(rand) else rand
                wo, pdf = bounce.ball_sample(ball, rand, rows_np, wi[want_rows])
                wo_p, pdf_p = (low.ball_sample(ball, rand, rows_np, wi[want_rows]) if low is not None else
                               (s["wo"][want_rows], s["pdf"][want_rows]))
                both = (pdf > 0) & (pdf_p > 0)
                if ball["kind"] == "sphere":  # the (theta, phi) domain's pdf, as render.py compares it
                    pdf = pdf * torch.clamp(torch.linalg.vector_norm(wo[:, :2], dim=-1), min=5e-5)
                    pdf_p = pdf_p * torch.clamp(torch.linalg.vector_norm(wo_p[:, :2].float(), dim=-1), min=5e-5)
                acc["sdir"].append(abs_gap(wo_p, wo, both))
                acc["spdf"].append(rel_gap(pdf_p, pdf, both))
            if s["kind"] in ("eval", "eval_pdf"):
                wo = s["wo_in"][on]
                f = bounce.ball_value(ball, wi[on], wo)
                got = low.ball_value(ball, wi[on], wo) if low is not None else s["f"][on]
                act = wo[:, 2] > 0 if ball["kind"] == "measured" else None
                acc["mat"].append(rel_gap(got, f, act))
            if s["kind"] == "eval_pdf" and bool(want_rows.any()):
                wo = s["wo_in"][want_rows]
                pdf = bounce.ball_pdf(ball, wi[want_rows], wo)
                got = low.ball_pdf(ball, wi[want_rows], wo) if low is not None else s["pdf"][want_rows]
                act = wo[:, 2] > 0 if ball["kind"] == "measured" else None
                acc["mat" if ball["kind"] == "measured" else "qpdf"].append(rel_gap(got, pdf, act))
        if need is not None and b["routed"] and s["kind"] in ("sample", "eval_pdf"):
            # rows the routing leaves out hold the diffuse plane's draw and pdf
            out = (mat >= ref.MAT_BALL) & ~need
            if bool(out.any()):
                if s["kind"] == "sample":
                    wo, pdf = refscene.cosine(b["rnd"]["u_diffuse"][out])
                    got = (s["wo"][out], s["pdf"][out]) if low is None else (low.p.q(wo), low.p.q(pdf))
                    acc["out"].append(max(abs_gap(got[0], wo), rel_gap(got[1], pdf)))
                else:
                    pdf = torch.clamp(s["wo_in"][out][:, 2], min=0.0) / np.pi
                    got = s["pdf"][out] if low is None else low.p.q(pdf)
                    acc["out"].append(rel_gap(got, pdf))
