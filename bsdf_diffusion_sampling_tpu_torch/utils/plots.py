"""Figure exports of validation results, counterpart of the JAX package's
`utils/plots.py` (the reference implementation's `export_*` utilities):

- `export_hist_vs_pdf_1d`: histogram of samples against an analytic pdf
  curve;
- `export_2d`: 2-D sample histogram heat-map;
- `export_pdf_comparison`: learned vs ground-truth pdf grids and their
  difference, gamma-compressed;
- `export_samples_vs_pdf`: sample histogram vs pdf grid side by side,
  returning the KL divergence;
- `export_render_diff`: two tonemapped renders and their error map,
  returning the MSE.

Figures are written headlessly (Agg); every function returns the figure's
path, and the KL and MSE variants the number too. Inputs are numpy arrays.
matplotlib is imported inside the functions, so importing this module (or
the `utils` package) does not need it.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np

from bsdf_diffusion_sampling_tpu_torch.utils.validation import kl_divergence_grid


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    _plt().close(fig)
    return path


def export_hist_vs_pdf_1d(
    x: np.ndarray,
    pdf_func: Callable[[np.ndarray], np.ndarray],
    path: str,
    lo: float = -1.0,
    hi: float = 1.0,
    bins: int = 200,
    title: str = "",
) -> str:
    xs = np.linspace(lo, hi, 512)
    fig, ax = _plt().subplots(figsize=(6, 4))
    ax.hist(np.asarray(x).ravel(), bins=bins, range=(lo, hi), density=True,
            alpha=0.6, label="samples")
    ax.plot(xs, np.asarray(pdf_func(xs)), lw=2, label="pdf")
    ax.set_title(title)
    ax.legend()
    return _save(fig, path)


def export_2d(
    x: np.ndarray,
    path: str,
    extent: Sequence[Sequence[float]] = ((-1, 1), (-1, 1)),
    bins: int = 200,
    title: str = "",
) -> str:
    fig, ax = _plt().subplots(figsize=(5, 5))
    ax.hist2d(x[:, 0], x[:, 1], bins=bins,
              range=[list(extent[0]), list(extent[1])], density=True)
    ax.set_title(title)
    ax.set_aspect("equal")
    return _save(fig, path)


def export_pdf_comparison(
    learned: np.ndarray,
    ground_truth: np.ndarray,
    path_prefix: str,
    gamma: float = 0.35,
) -> str:
    """Learned | GT | difference triptych with gamma compression
    (`export_2d_result_pdf:104-135` uses gamma=0.35)."""
    lg = np.power(np.clip(learned, 0, None), gamma)
    gg = np.power(np.clip(ground_truth, 0, None), gamma)
    vmax = max(lg.max(), gg.max(), 1e-9)
    fig, axes = _plt().subplots(1, 3, figsize=(13, 4))
    for ax, img, name in zip(
        axes,
        (lg, gg, np.abs(learned - ground_truth)),
        ("learned", "ground truth", "|difference|"),
    ):
        im = ax.imshow(img.T, origin="lower",
                       vmax=vmax if name != "|difference|" else None)
        ax.set_title(name)
        fig.colorbar(im, ax=ax, shrink=0.8)
    return _save(fig, path_prefix + "_pdf_comparison.png")


def export_samples_vs_pdf(
    x: np.ndarray,
    gt_pdf_grid: np.ndarray,
    path_prefix: str,
    extent: Sequence[Sequence[float]] = ((-1, 1), (-1, 1)),
) -> tuple[str, float]:
    """Sample histogram vs ground-truth pdf grid; returns (figure path, KL)
    — the KL(gt || hist) number the reference prints at
    `utils.py:206-211`."""
    bins = gt_pdf_grid.shape[0]
    hist, _, _ = np.histogram2d(
        x[:, 0], x[:, 1], bins=bins,
        range=[list(extent[0]), list(extent[1])],
    )
    q = hist / max(hist.sum(), 1.0)
    p = np.clip(gt_pdf_grid, 0, None)
    p = p / max(p.sum(), 1e-30)
    kl = kl_divergence_grid(p, q)

    fig, axes = _plt().subplots(1, 2, figsize=(9, 4))
    axes[0].imshow(q.T, origin="lower")
    axes[0].set_title("sample histogram")
    axes[1].imshow(p.T, origin="lower")
    axes[1].set_title(f"ground-truth pdf (KL={kl:.4f})")
    return _save(fig, path_prefix + "_samples_vs_pdf.png"), kl


def export_render_diff(
    img_a: np.ndarray,
    img_b: np.ndarray,
    path_prefix: str,
    labels: tuple[str, str] = ("ours", "reference"),
) -> tuple[str, float]:
    """Two tonemapped renders plus an error map; returns (path, MSE) —
    the EXR-comparison workflow of `mitsuba_brdf_draw.py:9-34`."""
    mse = float(np.mean((img_a - img_b) ** 2))
    tm = lambda i: np.clip(np.power(np.clip(i, 0, None), 1 / 2.2), 0, 1)  # noqa: E731
    fig, axes = _plt().subplots(1, 3, figsize=(13, 4))
    axes[0].imshow(tm(img_a))
    axes[0].set_title(labels[0])
    axes[1].imshow(tm(img_b))
    axes[1].set_title(labels[1])
    err = np.abs(img_a - img_b).mean(-1) if img_a.ndim == 3 else np.abs(img_a - img_b)
    im = axes[2].imshow(err, cmap="magma")
    axes[2].set_title(f"|error| (MSE={mse:.3e})")
    fig.colorbar(im, ax=axes[2], shrink=0.8)
    for ax in axes:
        ax.set_xticks([])
        ax.set_yticks([])
    return _save(fig, path_prefix + "_render_diff.png"), mse
