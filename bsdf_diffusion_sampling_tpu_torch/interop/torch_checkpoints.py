"""Import the reference implementation's PyTorch `.pth` checkpoints into the
port's parameter trees (counterpart of the JAX package's
`interop/torch_checkpoints.py`).

A reference checkpoint is a state dict of one SiLU MLP whose layers are
named `linear1..linearN`, then `output`; torch stores each Linear weight
as (out, in), and the trees keep (in, out) for `y = x @ W`, so each weight
is transposed on import. A `.bias` is kept where a layer has one.

Checkpoint directory layout (one directory a material and domain):
- `<material>_disk/`: `brdf_pretrain_network<m>.pth` (base density, PE(3)
  14 -> 16 -> 4), `brdf_diffusion_network<m>.pth` (velocity, 3 x 32) and
  `brdf_rectify_network<m>.pth` (the distilled velocity, 3 x 32). The
  teacher is the diffusion net.
- `<material>_spherical/`: pretrain, `brdf_diffusion_network_simpler<m>.pth`
  (4 x 32), `brdf_diffusion_network_complex<m>.pth` (6 x 64, the teacher)
  and rectify (4 x 32). A directory without a pretrain file takes it from
  `<material>_disk/`.
- `bsdf_<idx>_spherical/`: the same for the full-sphere models of the
  material table; some store the two diffusion nets under the legacy names
  `neusample_pos_diffusion_brdf_mcmc_pytorch_emcee_onemode{32,64}.pth`.

Tensors come back float32 on the requested device, the card by default.
The PE band count is a plain int, as in `models/base_density.py`.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

import torch

from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device

LEGACY_DIFFUSION = "neusample_pos_diffusion_brdf_mcmc_pytorch_emcee_onemode"


def load_state_dict(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """A `.pth` state dict as float32 tensors on `device`."""
    device = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().to(device=device, dtype=torch.float32) for k, v in sd.items()}


def _layer_order(sd: Dict[str, torch.Tensor]) -> List[str]:
    """linear1..linearN then output: sorted by number, not as strings."""
    names = {k.split(".")[0] for k in sd}
    linears = sorted((n for n in names if n.startswith("linear")), key=lambda n: int(re.search(r"\d+", n).group()))
    if "output" not in names:
        raise ValueError(f"state dict has no 'output' layer: {sorted(names)}")
    return linears + ["output"]


def mlp_from_state_dict(sd: Dict[str, torch.Tensor]) -> List[dict]:
    """A torch MLP state dict as the trees' list of `{"w": (in, out)[, "b"]}`."""
    params = []
    for name in _layer_order(sd):
        layer = {"w": sd[f"{name}.weight"].t().contiguous()}
        if f"{name}.bias" in sd:
            layer["b"] = sd[f"{name}.bias"]
        params.append(layer)
    return params


def base_from_state_dict(sd: Dict[str, torch.Tensor], pe_bands: int = 3) -> dict:
    """A pretrain-net state dict as base-density params; its input is
    PE(omega_i, pe_bands), 14 wide for the reference's 3 bands."""
    net = mlp_from_state_dict(sd)
    in_dim = net[0]["w"].shape[0]
    expect = 2 * (2 * pe_bands + 1)
    if in_dim != expect:
        raise ValueError(f"base net input {in_dim} != PE({pe_bands}) dim {expect}")
    return {"net": net, "pe_bands": pe_bands}


def _pth(ckpt_dir: str, stem: str, tag: str) -> str:
    return os.path.join(ckpt_dir, f"{stem}{tag}.pth")


def import_reference_material(checkpoints_root: str, material: str, domain: str, device="cuda") -> dict:
    """One material's checkpoint directory as the tree `cli/train.py` writes
    (base, diffusion, teacher, rectified). `material` is a measured
    material's name or, for `sphere_full`, the material-table index
    ("0".."25")."""
    device = resolve_device(device)
    if domain == "disk":
        ckpt_dir = os.path.join(checkpoints_root, f"{material}_disk")
        base = base_from_state_dict(load_state_dict(_pth(ckpt_dir, "brdf_pretrain_network", material), device))
        diffusion = mlp_from_state_dict(load_state_dict(_pth(ckpt_dir, "brdf_diffusion_network", material), device))
        teacher = diffusion
    elif domain in ("spherical", "sphere_full"):
        stem = material if domain == "spherical" else f"bsdf_{material}"
        ckpt_dir = os.path.join(checkpoints_root, f"{stem}_spherical")
        pre = _pth(ckpt_dir, "brdf_pretrain_network", material)
        if not os.path.exists(pre):
            pre = _pth(os.path.join(checkpoints_root, f"{material}_disk"), "brdf_pretrain_network", material)
        base = base_from_state_dict(load_state_dict(pre, device))
        simpler = _pth(ckpt_dir, "brdf_diffusion_network_simpler", material)
        if not os.path.exists(simpler):
            simpler = os.path.join(ckpt_dir, f"{LEGACY_DIFFUSION}32.pth")
        complex_ = _pth(ckpt_dir, "brdf_diffusion_network_complex", material)
        if not os.path.exists(complex_):
            complex_ = os.path.join(ckpt_dir, f"{LEGACY_DIFFUSION}64.pth")
        diffusion = mlp_from_state_dict(load_state_dict(simpler, device))
        teacher = mlp_from_state_dict(load_state_dict(complex_, device))
    else:
        raise ValueError(f"unknown domain {domain!r}")
    rectified = mlp_from_state_dict(load_state_dict(_pth(ckpt_dir, "brdf_rectify_network", material), device))
    return {"base": base, "diffusion": diffusion, "teacher": teacher, "rectified": rectified}
