"""Independent numpy reference implementations (cross-validation oracles),
the port's own copy of the JAX package's `utils/reference_np.py`: the same
functions, statement for statement, with this docstring and the Metropolis
chain's reworded.

The reference implementation validates its target densities by writing them
several times in unrelated stacks (numpy, torch, Stan, PyMC) and comparing
them by eye. This module makes that automatic: a pure-numpy implementation
of the GGX shading density, the anisotropic GGX microfacet pieces, and the
coordinate maps, written from the microfacet formulas, which tests hold
against the port's PyTorch modules.
"""

from __future__ import annotations

import numpy as np

# ------------------------------------------------------- coordinates ----


def disk_to_cart_np(w: np.ndarray) -> np.ndarray:
    x, y = w[..., 0], w[..., 1]
    z = np.sqrt(np.clip(1.0 - x * x - y * y, 0.0, None))
    return np.stack([x, y, z], axis=-1)


def spher_to_cart_np(theta: np.ndarray, phi: np.ndarray) -> np.ndarray:
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], axis=-1)


# -------------------------------------------- GGX shading (isotropic) ----


def ggx_shading_np(
    light: np.ndarray,
    view: np.ndarray,
    roughness: float,
    f0: float = 0.04,
    diffuse_prob: float = 0.0,
) -> np.ndarray:
    """Unnormalized GGX + Smith-Schlick + Schlick-Fresnel shading density
    over cartesian directions. Mirrors the convention quirk of the torch
    oracle — the NDF denominator uses n.h (not squared) times (a^2-1)+1
    (`analytical_brdf_torch.py:36-40`) — because that is the density the
    models are trained against."""
    h = light + view
    h = h / np.linalg.norm(h, axis=-1, keepdims=True)
    ndh = h[..., 2]
    ndl = light[..., 2]
    ndv = view[..., 2]
    vdh = np.sum(view * h, axis=-1)

    a = roughness * roughness
    d = a * a / (np.pi * (ndh * (a * a - 1.0) + 1.0) ** 2)
    k = (roughness + 1.0) ** 2 / 8.0
    g = (ndl / (ndl * (1.0 - k) + k)) * (ndv / (ndv * (1.0 - k) + k))
    f = f0 + (1.0 - f0) * (1.0 - vdh) ** 5
    spec = d * g * f / (4.0 * ndl * ndv + 1e-10)
    cos_o = np.maximum(ndv, 0.0)
    return (1.0 - diffuse_prob) * spec * cos_o + diffuse_prob * cos_o / np.pi


def ggx_pdf_grid_np(
    omega_i: np.ndarray, roughness: float, res: int = 128, f0: float = 0.04
) -> np.ndarray:
    """Numerically normalized disk-domain pdf grid of the GGX density for a
    fixed omega_i — the ground-truth heat-map the reference plots
    (`analytical_brdf_np_test.py:72-138`). Returns (res, res), integrating
    to ~1 over [-1,1]^2."""
    c = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    gx, gy = np.meshgrid(c, c, indexing="ij")
    wo = np.stack([gx.ravel(), gy.ravel()], -1)
    inside = (wo**2).sum(-1) < 1.0
    li = np.broadcast_to(disk_to_cart_np(omega_i), (wo.shape[0], 3))
    vals = np.where(inside, ggx_shading_np(li, disk_to_cart_np(wo), roughness, f0), 0.0)
    cell = (2.0 / res) ** 2
    return (vals / (vals.sum() * cell)).reshape(res, res)


# ------------------------------------- anisotropic GGX (roughconductor) ----


def ggx_d_np(wh: np.ndarray, alpha_u: float, alpha_v: float) -> np.ndarray:
    """Anisotropic GGX NDF (Heitz 2014, eq. 85)."""
    x, y, z = wh[..., 0], wh[..., 1], wh[..., 2]
    t = (x / alpha_u) ** 2 + (y / alpha_v) ** 2 + z * z
    d = 1.0 / (np.pi * alpha_u * alpha_v * t * t)
    return np.where(z > 0, d, 0.0)


def ggx_smith_g1_np(w: np.ndarray, wh: np.ndarray, alpha_u: float, alpha_v: float) -> np.ndarray:
    """Smith shadowing for the anisotropic GGX (Heitz 2014, eq. 43)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    xy_a2 = (alpha_u * x) ** 2 + (alpha_v * y) ** 2
    tan2 = xy_a2 / np.maximum(z * z, 1e-20)
    g = 2.0 / (1.0 + np.sqrt(1.0 + tan2))
    side = np.sum(w * wh, axis=-1) * z > 0
    return np.where(side, g, 0.0)


def fresnel_conductor_np(cos_i: np.ndarray, eta: float, k: float) -> np.ndarray:
    """Unpolarized conductor Fresnel (exact, complex IOR eta - i k)."""
    c2 = cos_i * cos_i
    s2 = 1.0 - c2
    e2, k2 = eta * eta, k * k
    t0 = e2 - k2 - s2
    a2b2 = np.sqrt(np.maximum(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + c2
    a = np.sqrt(np.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * cos_i
    rs = (t1 - t2) / (t1 + t2)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / (t3 + t4)
    return 0.5 * (rs + rp)


def eval_roughconductor_np(
    wi: np.ndarray, wo: np.ndarray, alpha_u: float, alpha_v: float,
    eta: float, k: float,
) -> np.ndarray:
    """Rough-conductor BRDF x cos(theta_o) (Mitsuba `roughconductor`
    semantics, the oracle of `mitsuba_brdf_scalar.py:27-45`)."""
    wh = wi + wo
    norm = np.linalg.norm(wh, axis=-1, keepdims=True)
    wh = wh / np.maximum(norm, 1e-20)
    d = ggx_d_np(wh, alpha_u, alpha_v)
    g = ggx_smith_g1_np(wi, wh, alpha_u, alpha_v) * ggx_smith_g1_np(
        wo, wh, alpha_u, alpha_v
    )
    f = fresnel_conductor_np(np.sum(wi * wh, axis=-1), eta, k)
    ci, co = wi[..., 2], wo[..., 2]
    val = d * g * f / np.maximum(4.0 * ci, 1e-10)  # includes the cos_o
    return np.where((ci > 0) & (co > 0), val, 0.0)


# --------------------------- external-stack MCMC redundancy (P23) ----


def metropolis_ggx_disk_np(
    rng: np.random.Generator,
    omega_i: np.ndarray,
    roughness: float,
    n_steps: int = 2000,
    n_chains: int = 64,
    burn_in: int = 500,
    f0: float = 0.04,
) -> tuple[np.ndarray, float]:
    """Adaptive random-walk Metropolis over omega_o in the unit disk at a
    fixed omega_i, targeting the GGX shading density.

    The reference implementation cross-validates its emcee data pipeline by
    sampling the same density with Stan/NUTS and PyMC. This is that
    redundancy without those dependencies: a self-contained numpy sampler
    that shares no code with the device stretch-move ensemble
    (`data/mcmc.py`): another algorithm (symmetric random walk against
    affine-invariant stretch), another RNG (a numpy Generator), another
    density implementation (ggx_shading_np against
    `bsdf/analytic.py::ggx_shading_disk`). Agreement of the two sample
    populations with each other and with the numerically normalized
    `ggx_pdf_grid_np` validates all three independently.

    Runs `n_chains` independent chains in lockstep (vectorized over chains,
    Python loop over steps); proposal scale adapts during burn-in toward
    ~35% acceptance by Robbins-Monro on the log-scale. Out-of-disk
    proposals have density zero and are rejected, the support guard of the
    reference's log density.

    Returns (samples (n_chains*(n_steps-burn_in), 2), acceptance_rate).
    """
    li = np.broadcast_to(disk_to_cart_np(np.asarray(omega_i, np.float64)), (n_chains, 3))

    def dens(wo_disk):
        inside = (wo_disk**2).sum(-1) < 1.0
        safe = np.where(inside[:, None], wo_disk, 0.0)
        v = ggx_shading_np(li, disk_to_cart_np(safe), roughness, f0)
        return np.where(inside, np.maximum(v, 0.0), 0.0)

    # start chains in the disk, biased toward the specular direction
    x = -0.5 * np.asarray(omega_i, np.float64) + 0.05 * rng.standard_normal(
        (n_chains, 2)
    )
    p = dens(x)
    log_step = np.log(0.15)
    acc_count = 0
    kept = []
    for it in range(n_steps):
        prop = x + np.exp(log_step) * rng.standard_normal((n_chains, 2))
        p_prop = dens(prop)
        u = rng.random(n_chains)
        accept = u * p < p_prop  # p>0 always after init; 0-density rejects
        x = np.where(accept[:, None], prop, x)
        p = np.where(accept, p_prop, p)
        rate = accept.mean()
        if it < burn_in:
            # Robbins-Monro toward 35% acceptance (optimal-ish for RW in 2D)
            log_step += (rate - 0.35) / np.sqrt(it + 1.0)
        else:
            kept.append(x.copy())
            acc_count += accept.sum()
    samples = np.concatenate(kept, axis=0)
    return samples, acc_count / (n_chains * (n_steps - burn_in))
