"""Model zoo: the reference's auxiliary network variants (counterpart of the
JAX package's `models/zoo.py`), plain functions over parameter trees in the
JAX package's layout, so `interop/jax_params.py::params_from_jax` carries its
trees across unchanged.

- `make_regressor`: biased SiLU MLP regressors `f([x, alpha, cond...])`,
  optionally with a sigmoid head;
- `velocity_pe_x_init` / `velocity_pe_x_apply`: a velocity net that
  frequency-encodes the state x as well as the condition;
- `gmm_disk_base`: a conditional 2-D diagonal-Gaussian mixture on the disk,
  and `mixture_spherical_base`: a mixture of Gaussian(theta) x von
  Mises(phi) components, both `BaseDensity` bundles. Their `sample` takes a
  `torch.Generator` or the explicit draws: (u_mode (N,), eps (N, 2)) for
  the GMM, (u_mode (N,), eps_g (N,), u_von (16, 3, N)) for the spherical
  mixture. The mode is the inverse CDF of the mixture weights at u_mode,
  where the JAX package draws `jax.random.categorical`. Both use one scale
  in sampling and in log_prob, so log_prob is the density of sample();
- `unet_init` / `unet_apply`: a 32 x 32 conv U-Net. Its API keeps NHWC
  images and HWIO kernels, as the JAX trees have them, and permutes to NCHW
  inside. A convolution pads as XLA's "SAME" does (for a stride-2 3 x 3 on
  32 x 32: 0 before, 1 after); a transposed convolution is
  `lax.conv_transpose` with `transpose_kernel=False`: the input dilated by
  the stride, padded by `_conv_transpose_padding`'s rule, and correlated
  with the unflipped kernel.

No kernel belongs to the zoo: it is plain PyTorch, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from bsdf_diffusion_sampling_tpu_torch.models.base_density import BaseDensity
from bsdf_diffusion_sampling_tpu_torch.models.encoding import encoded_dim, positional_encoding
from bsdf_diffusion_sampling_tpu_torch.models.mlp import init_mlp, mlp_apply
from bsdf_diffusion_sampling_tpu_torch.models.von_mises import von_mises_log_prob, von_mises_sample, von_mises_uniforms

_LOG_2PI = math.log(2.0 * math.pi)


# ------------------------------------------------------- MLP regressors ----


def make_regressor(gen: torch.Generator, in_dim: int, out_dim: int, hidden: int = 64, n_hidden: int = 4,
                   sigmoid_head: bool = False):
    """Biased SiLU MLP `f([x, alpha, cond...]) -> out`. Returns (params, apply)."""
    params = init_mlp(gen, [in_dim] + [hidden] * n_hidden + [out_dim], bias=True)

    def apply(params: List[dict], *inputs: torch.Tensor) -> torch.Tensor:
        y = mlp_apply(params, torch.cat(inputs, dim=-1) if len(inputs) > 1 else inputs[0])
        return torch.sigmoid(y) if sigmoid_head else y

    return params, apply


def velocity_pe_x_init(gen: torch.Generator, x_dim: int, cond_dim: int, pe_bands: int = 5, hidden: int = 64,
                       n_hidden: int = 4) -> List[dict]:
    """A biased net over [PE(x), alpha, PE(cond)] -> 2."""
    in_dim = encoded_dim(x_dim, pe_bands) + 1 + encoded_dim(cond_dim, pe_bands)
    return init_mlp(gen, [in_dim] + [hidden] * n_hidden + [2], bias=True)


def velocity_pe_x_apply(params: List[dict], x: torch.Tensor, alpha, cond: torch.Tensor,
                        pe_bands: int = 5) -> torch.Tensor:
    if not torch.is_tensor(alpha) or alpha.ndim == 0:
        alpha = torch.full(x.shape[:-1] + (1,), float(alpha), dtype=x.dtype, device=x.device)
    return mlp_apply(params, torch.cat([positional_encoding(x, pe_bands), alpha,
                                        positional_encoding(cond, pe_bands)], dim=-1))


# -------------------------------------------------- mixture base densities ----


def _pick(log_w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(N, K) one-hot of the mode whose CDF interval holds u (N,)."""
    cdf = torch.cumsum(torch.exp(log_w), dim=-1)
    mode = torch.clamp((cdf < u[..., None] * cdf[..., -1:]).sum(-1), max=log_w.shape[-1] - 1)
    return F.one_hot(mode, log_w.shape[-1]).to(log_w.dtype)


def _mixture_log_w(w_raw: torch.Tensor, floor: float) -> torch.Tensor:
    w = torch.abs(w_raw) + floor
    return torch.log(w) - torch.log(w.sum(-1, keepdim=True))


def gmm_disk_base(n_modes: int = 2, hidden: int = 64, pe_bands: int = 5) -> BaseDensity:
    """Conditional 2-D diagonal-Gaussian mixture; head layout [locs (K, 2),
    log_scales (K, 2), weights (K)]."""

    def init(gen: torch.Generator) -> dict:
        return {"net": init_mlp(gen, [encoded_dim(2, pe_bands), hidden, n_modes * 5], bias=True),
                "pe_bands": pe_bands, "n_modes": n_modes}

    def heads(params, omega_i):
        out = mlp_apply(params["net"], positional_encoding(omega_i, params["pe_bands"]))
        k = n_modes
        loc = out[..., :2 * k].reshape(out.shape[:-1] + (k, 2))
        log_scale = out[..., 2 * k:4 * k].reshape(out.shape[:-1] + (k, 2))
        return loc, log_scale, _mixture_log_w(out[..., 4 * k:5 * k], 1e-10)

    def sample(params: dict, omega_i: torch.Tensor, eps) -> torch.Tensor:
        loc, log_scale, log_w = heads(params, omega_i)
        if isinstance(eps, torch.Generator):
            u = torch.rand(log_w.shape[:-1], generator=eps, dtype=loc.dtype, device=loc.device)
            eps = (u, torch.randn(loc.shape[:-2] + (2,), generator=eps, dtype=loc.dtype, device=loc.device))
        u, e = eps
        sel = _pick(log_w, u)[..., None]
        return (loc * sel).sum(-2) + (torch.exp(log_scale) * sel).sum(-2) * e

    def log_prob(params: dict, x: torch.Tensor, omega_i: torch.Tensor) -> torch.Tensor:
        loc, log_scale, log_w = heads(params, omega_i)
        z = (x[..., None, :] - loc) / torch.exp(log_scale)
        comp = -_LOG_2PI - log_scale.sum(-1) - 0.5 * (z * z).sum(-1)
        return torch.logsumexp(comp + log_w, dim=-1)

    return BaseDensity("disk", init, sample, log_prob)


def mixture_spherical_base(n_modes: int = 2, hidden: int = 64, pe_bands: int = 5, eps: float = 1e-6) -> BaseDensity:
    """Mixture of Gaussian(theta) x von Mises(phi); head layout [loc,
    log_scale, weight, loc_von, raw_conc], K columns each."""

    def init(gen: torch.Generator) -> dict:
        return {"net": init_mlp(gen, [encoded_dim(2, pe_bands), hidden, n_modes * 5], bias=True),
                "pe_bands": pe_bands, "n_modes": n_modes}

    def heads(params, omega_i):
        out = mlp_apply(params["net"], positional_encoding(omega_i, params["pe_bands"]))
        k = n_modes
        log_w = _mixture_log_w(out[..., 2 * k:3 * k], 1e-6)
        conc = F.softplus(out[..., 4 * k:5 * k]) + eps
        scale = torch.exp(out[..., k:2 * k]) + eps
        return out[..., :k], scale, log_w, out[..., 3 * k:4 * k], conc

    def sample(params: dict, omega_i: torch.Tensor, draws) -> torch.Tensor:
        loc, scale, log_w, loc_von, conc = heads(params, omega_i)
        if isinstance(draws, torch.Generator):
            shape = log_w.shape[:-1]
            draws = (torch.rand(shape, generator=draws, dtype=loc.dtype, device=loc.device),
                     torch.randn(shape, generator=draws, dtype=loc.dtype, device=loc.device),
                     von_mises_uniforms(draws, shape, loc.device).to(loc.dtype))
        u, eps_g, u_von = draws
        sel = _pick(log_w, u)
        theta = (loc * sel).sum(-1) + (scale * sel).sum(-1) * eps_g
        phi = von_mises_sample(u_von, (loc_von * sel).sum(-1), (conc * sel).sum(-1))
        return torch.stack([theta, phi], dim=-1)

    def log_prob(params: dict, x: torch.Tensor, omega_i: torch.Tensor) -> torch.Tensor:
        loc, scale, log_w, loc_von, conc = heads(params, omega_i)
        z = (x[..., :1] - loc) / scale
        loggau = -0.5 * _LOG_2PI - torch.log(scale) - 0.5 * z * z
        return torch.logsumexp(loggau + von_mises_log_prob(x[..., 1:2], loc_von, conc) + log_w, dim=-1)

    return BaseDensity("spherical", init, sample, log_prob)


# --------------------------------------------------------------- U-Net ----


def _conv_init(gen: torch.Generator, k_h: int, k_w: int, c_in: int, c_out: int) -> dict:
    bound = 1.0 / math.sqrt(k_h * k_w * c_in)
    w = (torch.rand((k_h, k_w, c_in, c_out), generator=gen, device=gen.device) * 2.0 - 1.0) * bound
    b = (torch.rand((c_out,), generator=gen, device=gen.device) * 2.0 - 1.0) * bound
    return {"w": w, "b": b}


def _same_pads(size: int, k: int, s: int):
    """XLA's "SAME" padding of one dim: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """NCHW x, HWIO kernel, "SAME" padding."""
    kh, kw = p["w"].shape[:2]
    (ht, hb), (wl, wr) = _same_pads(x.shape[2], kh, stride), _same_pads(x.shape[3], kw, stride)
    y = F.conv2d(F.pad(x, (wl, wr, ht, hb)), p["w"].permute(3, 2, 0, 1), stride=stride)
    return y + p["b"][:, None, None]


def _conv_transpose_pads(k: int, s: int):
    """`lax.conv_transpose`'s "SAME" padding of the dilated input: (before, after)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def _conv_t(x: torch.Tensor, p: dict, stride: int = 2) -> torch.Tensor:
    """`lax.conv_transpose(x, w, stride, "SAME")` on NCHW x and an HWIO
    kernel. `F.conv_transpose2d` pads the dilated input by k - 1 - padding on
    each side and correlates with the flipped kernel, so it gets the
    flipped HWIO kernel as (in, out, kH, kW), padding k - 1 - before, and
    the after side is then grown (output_padding) or cropped to match."""
    kh, kw = p["w"].shape[:2]
    (ha, hb), (wa, wb) = _conv_transpose_pads(kh, stride), _conv_transpose_pads(kw, stride)
    w = torch.flip(p["w"], dims=(0, 1)).permute(2, 3, 0, 1)
    grow = (max(hb - ha, 0), max(wb - wa, 0))
    y = F.conv_transpose2d(x, w, stride=stride, padding=(kh - 1 - ha, kw - 1 - wa), output_padding=grow)
    h_out, w_out = (x.shape[2] - 1) * stride + 1 + ha + hb - kh + 1, (x.shape[3] - 1) * stride + 1 + wa + wb - kw + 1
    return y[:, :, :h_out, :w_out] + p["b"][:, None, None]


UNET_SPEC = [
    # (name, kind, c_in, c_out, stride): 3 down blocks, a residual
    # bottleneck, 3 up blocks
    ("d1a", "conv", 2, 64, 1), ("d1b", "conv", 64, 64, 2),
    ("d2a", "conv", 64, 64, 1), ("d2b", "conv", 64, 64, 2),
    ("d3a", "conv", 64, 64, 1), ("d3b", "conv", 64, 64, 1),
    ("d3c", "conv", 64, 64, 1), ("d3d", "conv", 64, 64, 2),
    ("u3a", "convt", 64, 64, 2), ("u3b", "conv", 64, 64, 1),
    ("u2a", "convt", 64, 64, 2), ("u2b", "conv", 64, 64, 1),
    ("u1a", "convt", 64, 64, 2), ("u1b", "conv", 64, 64, 1),
    ("out", "conv1x1", 64, 1, 1),
]


def unet_init(gen: torch.Generator) -> dict:
    """Uniform(+-1/sqrt(fan_in)) HWIO kernels and biases, on the generator's device."""
    params = {}
    for name, kind, c_in, c_out, _ in UNET_SPEC:
        k = 1 if kind == "conv1x1" else 3
        params[name] = _conv_init(gen, k, k, c_in, c_out)
    return params


def unet_apply(params: dict, x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x: (N, 32, 32, 1) NHWC; alpha: (N,). Returns (N, 32, 32, 1)."""
    relu = F.relu
    a = alpha.to(x.dtype)[:, None, None, None].expand(x.shape[:3] + (1,))
    h0 = torch.cat([x, a], dim=-1).permute(0, 3, 1, 2)

    d1a = relu(_conv(h0, params["d1a"]))
    d1b = relu(_conv(d1a, params["d1b"], 2))
    d2a = relu(_conv(d1b, params["d2a"]))
    d2b = relu(_conv(d2a, params["d2b"], 2))
    d3a = relu(_conv(d2b, params["d3a"]))
    d3b = relu(_conv(d3a, params["d3b"]))
    d3c = relu(_conv(d3b, params["d3c"])) + d3a
    d3d = relu(_conv(d3c, params["d3d"], 2))

    u3a = relu(_conv_t(d3d, params["u3a"])) + d3c
    u3b = relu(_conv(u3a, params["u3b"])) + d2b
    u2a = relu(_conv_t(u3b, params["u2a"])) + d1b
    u2b = relu(_conv(u2a, params["u2b"]))
    u1a = relu(_conv_t(u2b, params["u1a"])) + d1a
    u1b = relu(_conv(u1a, params["u1b"]))
    return _conv(u1b, params["out"]).permute(0, 2, 3, 1)
