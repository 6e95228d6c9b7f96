"""Rectify cells: `train/stages.py::run_stage` iterations of the rectify
stage as `train_material` builds it (`make_rectify_pairgen` with the
teacher at T steps, `make_rectify_step` on the student, Adam), one
iteration a call, no stage file saved.

Set-up builds the one training state, drives it from the seed through its
first three iterations through the window's own call, and hands it to the
window. The reference follows those three from the same weights: it draws
each iteration's omega_i, base draws and alphas again from the iteration's
generator, transports the pairs by the teacher itself, and takes the loss,
the gradient and the Adam step. Compared: each step's loss, the first
gradient's norm as Adam got it (its first moment after one step over 1 -
beta1), the norm of the parameters' change over the three steps, each by
the worst leaf, and the share of the three iterations' pairs (omega_i,
x0, x1, alpha) that part from the reference's by more than 1e-3 in x (phi
on the circle) or 1e-6 in omega_i and alpha.
"""

from __future__ import annotations

import math
import statistics

import torch
from torch.profiler import record_function

from port_bench.counts import work
from port_bench.harness import weights
from port_bench.reference import train as ref
from port_bench.reference.flow import FP32, LOW, Prec

FOLLOWED = 3  # iterations the reference follows


class Driver:
    span = "train_call"
    unit = "train_rows_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tmpdir: str):
        from bsdf_diffusion_sampling_tpu_torch.core import prng
        from bsdf_diffusion_sampling_tpu_torch.core.config import ModelConfig
        from bsdf_diffusion_sampling_tpu_torch.ops.fused_ode import prepack_velocity
        from bsdf_diffusion_sampling_tpu_torch.train import stages

        self.cfg, self.device, self.stages = cfg, device, stages
        self.n_wi, self.n_per, self.T = traffic["batch_wi"], traffic["num_samples"], traffic["timestep"]
        self.lr = traffic["lr"]
        s, te = cfg["student"], cfg["teacher"]
        nets = {"base": ("base", None),
                "student": ("velocity", weights.velocity_dims(s["hidden"], s["layers"], 3)),
                "teacher": ("velocity", weights.velocity_dims(te["hidden"], te["layers"], 3))}
        w = weights.make(seed, nets, device)
        self.ref_w = weights.clone(w)
        domain = cfg["domain"]
        student_cfg = ModelConfig(domain=domain, velocity_hidden=s["hidden"], velocity_layers=s["layers"])
        teacher_cfg = ModelConfig(domain=domain, velocity_hidden=te["hidden"], velocity_layers=te["layers"])
        base_params = {"net": w["base"], "pe_bands": 3}
        self.state = stages.init_state(w["student"], self.lr)
        pairgen = stages.make_rectify_pairgen(domain, teacher_cfg, self.T)
        teacher = prepack_velocity(w["teacher"])
        r_step = stages.make_rectify_step(domain, student_cfg)
        self.stage_seed = prng.fold_in(seed, "rectify")
        self.recorded, self.peak = [], 0

        def step_call(st, gen, it):
            with record_function("pairgen"):
                x0, x1, wi = pairgen(teacher, base_params, gen, self.n_wi, self.n_per)
            with record_function("update"):
                batch = r_step.draw(x0, x1, wi, gen, None)
                loss = r_step.update(st, batch, None)
            if len(self.recorded) < FOLLOWED:
                self.recorded.append({"omega": wi, "x0": x0, "x1": x1, "alpha": batch[3], "loss": loss})
            return loss

        self.step_call = step_call

    def _iterate(self):
        self.stages.run_stage(name="rectify", state=self.state, step_call=self.step_call, iters=self.state.step + 1,
                              seed=self.stage_seed, device=self.device, log_every=0, log_fn=lambda s: None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.device))

    def _params(self):
        return [p.detach().clone() for p in self.state.optimizer.param_groups[0]["params"]]

    def warmup(self):
        """The first three iterations, which the reference follows."""
        self.p0 = self._params()
        self._iterate()
        opt = self.state.optimizer
        self.g1 = [opt.state[p]["exp_avg"].detach().clone() / 0.1 for p in opt.param_groups[0]["params"]]
        for _ in range(FOLLOWED - 1):
            self._iterate()
        self.p3 = self._params()

    def call(self, k: int) -> float:
        """One rectify iteration; returns its pairs."""
        self._iterate()
        return float(self.n_wi * self.n_per)

    def work(self) -> dict:
        """One iteration: the teacher's transport of every pair and the
        student's forward and backward on them (the base draws' heads are
        not counted)."""
        s, te = self.cfg["student"], self.cfg["teacher"]
        n = self.n_wi * self.n_per
        k3 = work.transport(n, te["hidden"], te["layers"], 3, self.T, False)
        student = work.mlp_train(n, weights.velocity_dims(s["hidden"], s["layers"], 3))
        return {"k3": k3, "step": work.add(k3, student)}

    def peak_bytes(self) -> int:
        return self.peak

    def release(self):
        self.state = self.step_call = None

    # ---------------------------------------------------------------- check

    def _follow(self, prec: Prec) -> dict:
        """The reference's three iterations from the set-up's weights."""
        w = weights.clone(self.ref_w)
        params = [layer["w"].requires_grad_(True) for layer in w["student"]]
        adam = ref.Adam(params, self.lr)
        out = {"loss": [], "batches": []}
        for it in range(FOLLOWED):
            b = ref.draw_batch(self.stage_seed, it, w["base"], w["teacher"], self.n_wi, self.n_per, self.T,
                               self.device, prec)
            out["batches"].append(b)
            out["loss"].append(ref.loss_fn(w["student"], b, prec))
            if it == 0:
                out["g1"] = [p.grad.detach().clone() for p in params]
            adam.step()
        out["p3"] = [p.detach().clone() for p in params]
        return out

    def check(self, control: bool = False) -> list:
        want = self._follow(FP32)
        if control:
            low = self._follow(LOW)
            got = {"loss": low["loss"], "g1": low["g1"], "p3": low["p3"], "batches": low["batches"]}
        else:
            got = {"loss": [float(r["loss"]) for r in self.recorded], "g1": self.g1, "p3": self.p3,
                   "batches": self.recorded}
        p0 = [layer["w"] for layer in self.ref_w["student"]]
        g_norm = [float(g.norm()) for g in want["g1"]]
        # leaves whose gradient is nought to rounding move under Adam by round-off alone
        keep = [i for i, g in enumerate(g_norm) if g >= 1e-3 * statistics.median(g_norm)]

        def worst(a: list, b: list) -> float:
            na, nb = [float(x.norm()) for x in a], [float(x.norm()) for x in b]
            med = statistics.median([nb[i] for i in keep])
            return max(abs(na[i] - nb[i]) / max(nb[i], med) for i in keep)

        dp_want = [p - q for p, q in zip(want["p3"], p0)]
        dp_got = [p.to(q.device) - q for p, q in zip(got["p3"], p0)]
        off, rows = 0, 0
        for bg, bw in zip(got["batches"], want["batches"]):
            bad = torch.zeros(bw["x0"].shape[0], dtype=torch.bool, device=bw["x0"].device)
            for key, tol in (("omega", 1e-6), ("x0", 1e-3), ("x1", 1e-3), ("alpha", 1e-6)):
                d = bg[key].float().reshape(bad.shape[0], -1) - bw[key].reshape(bad.shape[0], -1)
                if key in ("x0", "x1"):  # phi on the circle
                    d[:, 1] = torch.remainder(d[:, 1] + math.pi, 2 * math.pi) - math.pi
                bad |= (d.abs() > tol).any(-1)
            off, rows = off + int(bad.sum()), rows + bad.shape[0]
        readings = {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
            "grad_norm_gap": worst(got["g1"], want["g1"]),
            "update_norm_gap": worst(dp_got, dp_want),
            "pairs_off_share": off / rows,
        }
        return [(k, v, self.limits[k]) for k, v in readings.items()]
