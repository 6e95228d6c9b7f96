"""Typed configuration system.

A copy of the JAX package's `core/config.py` (pure Python): the
port keeps its own so that it never imports the JAX package. Plain
dataclasses plus a safe CLI parser that accepts python-ish integer
expressions like "2**16" or "4900000 * 2" without calling eval() on
arbitrary strings.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import operator
from dataclasses import dataclass
from typing import Any

_ALLOWED_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Pow: operator.pow,
    ast.Mod: operator.mod,
}


def safe_int_expr(value: str) -> int:
    """Parse "2**16", "4900000 * 2", "128" etc. without eval()."""

    def _eval(node: ast.AST) -> float:
        if isinstance(node, ast.Expression):
            return _eval(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.BinOp) and type(node.op) in _ALLOWED_BINOPS:
            return _ALLOWED_BINOPS[type(node.op)](_eval(node.left), _eval(node.right))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -_eval(node.operand)
        raise ValueError(f"unsupported expression: {ast.dump(node)}")

    return int(_eval(ast.parse(value, mode="eval")))


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters of the conditional flow models.

    Defaults mirror the reference nets so checkpoints can be cross-validated:
    - base density: 1 hidden x16 SiLU over PE(omega_i, basis 3)
    - disk velocity: 3 hidden x32, PE basis 5, bias-free
    - spherical velocity (simpler): 4 hidden x32; complex: 6 hidden x64.
    """

    domain: str = "disk"  # "disk" | "spherical" | "sphere_full"
    base_hidden: int = 16
    base_pe_bands: int = 3
    velocity_hidden: int = 32
    velocity_layers: int = 3
    velocity_pe_bands: int = 5
    dtype: str = "float32"

    @property
    def x_dim(self) -> int:
        return 2

    @property
    def x_enc_dim(self) -> int:
        # spherical nets re-encode (theta, phi) -> (theta, sin phi, cos phi)
        return 2 if self.domain == "disk" else 3

    @property
    def cond_enc_dim(self) -> int:
        # PE with include_input: 2 + 2*2*bands
        return 2 + 4 * self.velocity_pe_bands

    @property
    def velocity_in_dim(self) -> int:
        return self.x_enc_dim + 1 + self.cond_enc_dim


@dataclass(frozen=True)
class TrainConfig:
    """Stage schedule, the reference CLI tables' defaults
    (`disk_domain_sampling.py:144-153`, `spherical_domain_sampling.py:211-220`).
    `mesh_axes` names the data mesh `cli/train.py` trains over: -1 spans the
    whole process group (one process without one)."""

    batch_pretrain: int = 9_800_000
    iters_pretrain: int = 10_000
    lr_pretrain: float = 3e-4

    batch_diffusion: int = 4_900_000
    iters_diffusion: int = 40_000
    lr_diffusion: float = 1e-3

    iters_rectify: int = 40_000
    timestep_rectify: int = 256
    num_samples_rectify: int = 2**16
    batch_wi_rectify: int = 2**6
    lr_rectify: float = 1e-3

    save_every: int = 1000
    log_every: int = 100
    seed: int = 0
    checkpoint_dir: str = "./checkpoints"
    mesh_axes: tuple = (("data", -1),)  # -1 == all devices


@dataclass(frozen=True)
class SamplerConfig:
    """Inference-time ODE settings (T per domain as in the reference's
    `rendering/utils/mlp_brdf_sampling.py:17,106`)."""

    T_disk: int = 4
    T_spherical: int = 8
    firefly_clamp_disk: float = 30.0  # `rendering/brdf_measured_disk.py:98`
    firefly_clamp_sphere: float = 3.5  # `rendering/bsdf_myresult.py:102`
    disk_valid_r2: float = 0.995  # `rendering/brdf_measured_disk.py:69`
    pole_sin_eps: float = 5e-5  # `rendering/bsdf_myresult.py:69`
    # pdf queries invert the FORWARD Euler map with a 2x2 Newton solve
    # (ode_pdf_exact / the fused kernel's Newton loop) instead of the
    # reference's reverse-Euler approximation; set False for reference
    # parity
    pdf_exact: bool = True
    pdf_newton_iters: int = 2


def asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(asdict(cfg), indent=2, default=str)


def replace(cfg: Any, **kw) -> Any:
    return dataclasses.replace(cfg, **kw)
