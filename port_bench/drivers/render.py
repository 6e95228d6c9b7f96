"""Render cells: `render/integrator.py::render` called back to back, one
caller, each call a whole image of `spp` samples a pixel in passes of one
wavefront (width x height x spp_chunk rays, max_depth bounces).

What the timed calls produce is recorded as they run, from the program's
own module-level entry points, and judged once the window has closed: at
one bounce a call, drawn from the seed (its pass and depth), a fixed set
of wavefront rows drawn from the seed is copied at every piece of the
bounce (the camera rays of its pass, both traversals, the envmap's
sample, value and pdf, the matball's draw and its value and pdf) and at
the bounce's end; the last call's film is copied at a set of pixels. The
reference recomputes each piece from the program's inputs to it, and the
whole bounce from the program's state before it (so paths cannot part
over many bounces), and the film from the program's path radiances.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from port_bench.counts import work
from port_bench.harness import weights
from port_bench.harness.gaps import abs_gap, rel_gap, row_rel, share
from port_bench.reference import render as ref
from port_bench.reference.flow import FP32, LOW

STATE = ("ro", "rd", "px", "L", "beta", "alive", "prev_pdf")
PATCHED = ("_bounce_body", "_init_wavefront", "_finish_pass", "intersect8", "sample_env", "eval_env", "pdf_env")
ROWS = 8192  # wavefront rows judged at each recorded bounce
DEPTHS = 4  # the recorded bounce's depth is drawn from 0 .. DEPTHS - 1, where most rows live
PIXELS = 4096  # film pixels judged


def _seed_of(rand):
    """(seed tensor, first row) of a kernel seed or a shard's `RowSeed`."""
    if hasattr(rand, "row0"):
        return rand.seed.detach().clone(), int(rand.row0)
    return rand.detach().clone(), 0


class Driver:
    span = "render_call"
    unit = "render_msamples_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tmpdir: str):
        from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import load_measured
        from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig, SamplerConfig
        from bsdf_diffusion_sampling_tpu_torch.render import integrator, procedural
        from bsdf_diffusion_sampling_tpu_torch.render.neural import make_neural_bsdf
        from bsdf_diffusion_sampling_tpu_torch.render.scene import load_scene

        self.cfg, self.seed, self.device = cfg, seed, device
        self.integ = integrator
        t, sc = traffic, cfg["scene"]
        self.w, self.h = t["width"], t["height"]
        self.spp, self.chunk, self.depth = t["spp"], t["spp_chunk"], t["max_depth"]
        self.passes = max(self.spp // self.chunk, 1)
        self.n = self.w * self.h * self.chunk
        table = cfg.get("table")
        self.dir = os.path.join(tmpdir, f"port_bench_scene_{cfg['name']}")
        xml = procedural.write_scene(self.dir, n_lat=sc["n_lat"], n_lon=sc["n_lon"], plane_g=sc["plane_g"],
                                     env_res=tuple(sc["env_res"]), width=self.w, height=self.h, spp=self.spp,
                                     max_depth=self.depth, table=None if table is None else (table[0], tuple(table[1])))
        self.xml = xml
        self.scene = load_scene(xml, device=device, width=self.w, height=self.h)
        domain, x_enc = cfg["domain"], 2 if cfg["domain"] == "disk" else 3
        dims = weights.velocity_dims(cfg["velocity_hidden"], cfg["velocity_layers"], x_enc)
        w = weights.make(seed, {"base": ("base", None), "v": ("velocity", dims)}, device)
        self.net = {"domain": domain, "material": cfg.get("material_params"), "base": weights.clone(w["base"]), "v": weights.clone(w["v"]), "T": cfg["T"],
                    "firefly": cfg["firefly_clamp"], "pdf_exact": t.get("pdf_exact", True),
                    "newton_iters": cfg.get("pdf_newton_iters", 2)}
        mcfg = ModelConfig(domain=domain, velocity_hidden=cfg["velocity_hidden"],
                           velocity_layers=cfg["velocity_layers"])
        scfg = SamplerConfig(pdf_exact=t.get("pdf_exact", True))
        brdf = None
        if table is None:
            brdf = load_measured(os.path.join(self.dir, cfg["material"] + ".bsdf"), device=device)
        self.nb = make_neural_bsdf(domain, mcfg, w["v"], {"net": w["base"]}, brdf, sampler_cfg=scfg, device=device)
        if table is None:
            mb = integrator.neural_matball(self.nb)
        else:
            from bsdf_diffusion_sampling_tpu_torch.bsdf.materials import BSDF_MATERIALS

            mb = integrator.neural_matball_sphere(self.nb, BSDF_MATERIALS[table[0]], tuple(table[1]))
        self.matball = mb._replace(**{k: self._recorder(k, getattr(mb, k)) for k in ("sample", "eval", "eval_pdf", "pdf")
                                      if getattr(mb, k) is not None})
        rng = np.random.default_rng([seed, 7])
        self.rows = np.sort(rng.choice(self.n, size=min(ROWS, self.n), replace=False))
        self.rows_dev = torch.as_tensor(self.rows, device=device)
        self.pixels = np.sort(rng.choice(self.w * self.h, size=min(PIXELS, self.w * self.h), replace=False))
        film_rows = np.concatenate([s * self.w * self.h + self.pixels for s in range(self.chunk)])
        self.film_rows = torch.as_tensor(film_rows, device=device)
        self.plan = np.random.default_rng([seed, 11])
        self.caps, self.cur, self.rec = [], None, None
        self.orig = {name: getattr(integrator, name) for name in PATCHED}
        for name in PATCHED:
            setattr(integrator, name, getattr(self, "_" + name.strip("_")))

    # ------------------------------------------------------------ recorders

    def _take(self, x):
        return x.index_select(0, self.rows_dev)

    def _recorder(self, kind: str, fn):
        def wrapped(*args):
            out = fn(*args)
            if self.rec is not None:
                if kind == "sample":
                    rand, wi = args
                    self.rec.setdefault("sample", []).append(
                        {"seed": _seed_of(rand), "wi": self._take(wi), "wo": self._take(out[0]),
                         "pdf": self._take(out[1])})
                else:
                    wi, wo = args
                    outs = out if isinstance(out, tuple) else (out,)
                    self.rec.setdefault(kind, []).append(
                        {"wi": self._take(wi), "wo": self._take(wo), "out": [self._take(o) for o in outs]})
            return out

        return wrapped

    def _bounce_body(self, accel, env, lights, state, rnd, depth, *, matball, mark=None):
        fn = self.orig["_bounce_body"]
        index, self.n_bounce = self.n_bounce, self.n_bounce + 1
        if index != self.cap_index:
            return fn(accel, env, lights, state, rnd, depth, matball=matball, mark=mark)
        tk = self._take
        self.rec = {"in": {k: tk(v) for k, v in zip(STATE, state)}, "depth": depth,
                    "rnd": {"u_nee": tk(rnd.u_nee), "u_diffuse": tk(rnd.u_diffuse), "u_rr": tk(rnd.u_rr),
                            "seed": _seed_of(rnd.ball[0])}}
        out, tr = fn(accel, env, lights, state, rnd, depth, matball=matball, mark=mark)
        self.rec["out"] = {k: tk(v) for k, v in zip(STATE, out)}
        self.cur["bounce"], self.rec = self.rec, None
        return out, tr

    def _init_wavefront(self, cam_vectors, u_cam, **kw):
        out = self.orig["_init_wavefront"](cam_vectors, u_cam, **kw)
        index, self.n_pass = self.n_pass, self.n_pass + 1
        if index == self.cap_pass:
            self.cur["init"] = {"u": self._take(u_cam), "ro": self._take(out[0]), "rd": self._take(out[1])}
        return out

    def _finish_pass(self, L, r0, mesh, **kw):
        self.cur["film"].append(L.index_select(0, self.film_rows))
        return self.orig["_finish_pass"](L, r0, mesh, **kw)

    def _intersect8(self, bvh, ro, rd, t_max=1e30, active=None, any_hit=False):
        h = self.orig["intersect8"](bvh, ro, rd, t_max, active=active, any_hit=any_hit)
        if self.rec is not None:
            tm = t_max if torch.is_tensor(t_max) else torch.full_like(h.t, float(t_max))
            act = torch.ones_like(h.t, dtype=torch.bool) if active is None else active
            self.rec.setdefault("isect", []).append(
                {"ro": self._take(ro), "rd": self._take(rd), "t_max": self._take(tm), "active": self._take(act),
                 "any_hit": any_hit, "t": self._take(h.t)})
        return h

    def _sample_env(self, env, u2):
        out = self.orig["sample_env"](env, u2)
        if self.rec is not None:
            self.rec["env_sample"] = {"u": self._take(u2), "out": [self._take(o) for o in out]}
        return out

    def _eval_env(self, env, d):
        out = self.orig["eval_env"](env, d)
        if self.rec is not None:
            self.rec["env_eval"] = {"d": self._take(d), "out": self._take(out)}
        return out

    def _pdf_env(self, env, d):
        out = self.orig["pdf_env"](env, d)
        if self.rec is not None:
            self.rec["env_pdf"] = {"d": self._take(d), "out": self._take(out)}
        return out

    # --------------------------------------------------------------- calls

    def warmup(self):
        """One pass: every shape a call uses (each pass is alike)."""
        self._render(0, spp=self.chunk)
        self.caps.clear()

    def _render(self, k: int, spp: int):
        self.n_bounce = self.n_pass = 0
        self.cap_pass = int(self.plan.integers(0, max(spp // self.chunk, 1)))
        self.cap_index = self.cap_pass * self.depth + int(self.plan.integers(0, min(DEPTHS, self.depth)))
        self.cur = {"film": []}
        seed = int(np.random.default_rng([self.seed, 13, k]).integers(0, 2 ** 62))
        img = self.integ.render(self.scene, (self.matball,), seed=seed, spp=spp, spp_chunk=self.chunk,
                                max_depth=self.depth, device=self.device)
        self.cur["image"] = torch.from_numpy(img.reshape(-1, 3)[self.pixels]).to(self.device)
        if self.caps:
            self.caps[-1].pop("film", None)  # the last call's film alone is judged
        self.caps.append(self.cur)

    def call(self, k: int) -> float:
        """One render() call; returns its pixel samples."""
        self._render(k + 1, spp=self.spp)
        return float(self.w * self.h * self.spp)

    def work(self) -> dict:
        """What one call counts: one draw a ray-bounce on every ray of the
        wavefront; the pdf queries the matball asks for (none for the disk
        matball, which weights MIS with the measured pdf; two, NEE's and the
        sampled direction's, for the full-sphere one); two traversals a
        bounce (closest hit, the envmap's shadow ray)."""
        c = self.cfg
        rb = self.n * self.depth * self.passes
        disk = c["domain"] == "disk"
        draw = work.draw(rb, c["velocity_hidden"], c["velocity_layers"], 2 if disk else 3, c["T"])
        out = {"passes": self.passes, "k5": work.scale(work.traversal(self.n), 2 * self.depth * self.passes)}
        if disk:
            out["k1"] = draw
            out["step"] = draw
        else:
            q = work.transport(2 * rb, c["velocity_hidden"], c["velocity_layers"], 3, c["T"], True)
            out["k4"] = draw
            out["step"] = work.add(draw, q)
            if not self.net["pdf_exact"]:
                out["k3"] = q
        return out

    def release(self):
        for name, fn in self.orig.items():
            setattr(self.integ, name, fn)
        self.scene = self.nb = self.matball = None

    # ---------------------------------------------------------------- check

    @torch.no_grad()
    def check(self, control: bool = False) -> list:
        """[(name, reading, limit)]: the program's pieces against the
        reference's on the recorded rows; with `control`, the reference in
        lower precision judged in the program's place."""
        sc = ref.load_scene(self.xml, self.device, self.w, self.h)
        bounce, low = ref.Bounce(sc, self.net, FP32), ref.Bounce(sc, self.net, LOW)
        rows = self.rows
        acc = {k: [] for k in ("rays", "hits", "sdir", "spdf", "qpdf", "mat", "env", "bounce")}
        for cap in self.caps:
            init = cap.get("init")
            if init is not None:
                _, rd = ref.camera_rays(sc.cam, init["u"], self.rows_dev, self.chunk)
                got = ref.camera_rays(sc.cam, init["u"], self.rows_dev, self.chunk, LOW)[1] if control else init["rd"]
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
            for s in b.get("sample", []):
                seed, row0 = int(s["seed"][0]), s["seed"][1]
                wo, pdf = ref.neural_sample(self.net, seed, rows + row0, s["wi"])
                wo_p, pdf_p = ref.neural_sample(self.net, seed, rows + row0, s["wi"], LOW) if control else \
                    (s["wo"], s["pdf"])
                both = (pdf > 0) & (pdf_p > 0)
                if self.net["domain"] != "disk":
                    # the solid-angle pdf's 1 / sin(theta) turns theta's rounding into a relative gap near the
                    # poles: compare the (theta, phi) domain's pdf, each side's taken at its own direction
                    pdf = pdf * torch.clamp(torch.linalg.vector_norm(wo[:, :2], dim=-1), min=5e-5)
                    pdf_p = pdf_p * torch.clamp(torch.linalg.vector_norm(wo_p[:, :2].float(), dim=-1), min=5e-5)
                acc["sdir"].append(abs_gap(wo_p, wo, both))
                acc["spdf"].append(rel_gap(pdf_p, pdf, both))
            for e in b.get("eval_pdf", []):
                f, pdf = ref.brdf_eval_pdf(sc.brdf, e["wi"], e["wo"])
                got = ref.brdf_eval_pdf(sc.brdf, e["wi"], e["wo"], LOW) if control else e["out"]
                act = (e["wi"][:, 2] > 0) & (e["wo"][:, 2] > 0)
                acc["mat"].append(max(rel_gap(got[0], f, act), rel_gap(got[1], pdf, act)))
            for e in b.get("eval", []):  # a table matball's value
                f = ref.table_eval(sc, self.net, e["wi"], e["wo"])
                got = ref.table_eval(sc, self.net, e["wi"], e["wo"], LOW) if control else e["out"][0]
                acc["mat"].append(rel_gap(got, f))
            for e in b.get("pdf", []):  # the full-sphere sampler's pdf queries
                pdf = ref.neural_pdf(self.net, e["wi"], e["wo"])
                got = ref.neural_pdf(self.net, e["wi"], e["wo"], LOW) if control else e["out"][0]
                acc["qpdf"].append(rel_gap(got, pdf))
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
            s_in = {k: b["in"][k] for k in ("ro", "rd", "L", "beta", "alive", "prev_pdf")}
            rnd = dict(b["rnd"], seed=int(b["rnd"]["seed"][0]))
            row_ids = rows + b["rnd"]["seed"][1]
            want = bounce(s_in, rnd, row_ids, b["depth"])
            got = low(s_in, rnd, row_ids, b["depth"]) if control else b["out"]
            acc["bounce"].append((self._bounce_off(got, want), s_in["alive"]))
        film = self._film_gap(control)

        def shares(key):
            flags = [f if among is None else f[among] for f, among in acc[key]]
            return share(torch.cat(flags)) if flags else 0.0

        lim = self.limits
        readings = {
            "rays_gap": max(acc["rays"], default=0.0),
            "hits_off_share": shares("hits"),
            "sampler_dir_gap": max(acc["sdir"], default=0.0),
            "sampler_pdf_gap": max(acc["spdf"], default=0.0),
            "material_gap": max(acc["mat"], default=0.0),
            "pdf_query_gap": max(acc["qpdf"], default=0.0),
            "envmap_gap": max(acc["env"], default=0.0),
            "bounce_off_share": shares("bounce"),
            "film_gap": film,
        }
        return [(k, v, lim[k]) for k, v in readings.items() if k in lim]

    @staticmethod
    def _bounce_off(got: dict, want: dict) -> torch.Tensor:
        """Rows whose next state parts from the reference's: a different
        alive flag, or radiance, throughput, direction or MIS pdf more than
        1e-3 apart (relative; directions and pdfs of live rows only)."""
        alive = want["alive"]
        off = got["alive"] != alive
        off |= row_rel(got["L"], want["L"], 1e-6) > 1e-3
        off |= row_rel(got["beta"], want["beta"], 1e-6) > 1e-3
        live = alive & got["alive"]
        off |= live & (row_rel(got["rd"], want["rd"], 1e-3) > 1e-3)
        off |= live & (row_rel(got["prev_pdf"], want["prev_pdf"], 1e-6) > 1e-3)
        return off

    def _film_gap(self, control: bool) -> float:
        cap = self.caps[-1]
        if not cap.get("film"):
            return 0.0
        L = torch.stack(cap["film"])  # (passes, chunk * pixels, 3)
        L = L.reshape(L.shape[0], self.chunk, -1, 3).double()
        want = (L.sum(dim=(0, 1)) / (L.shape[0] * self.chunk)).float()
        if control:
            got = (L.to(torch.bfloat16).float().sum(dim=(0, 1)) / (L.shape[0] * self.chunk)).to(torch.bfloat16).float()
        else:
            got = cap["image"]
        return rel_gap(got, want)
