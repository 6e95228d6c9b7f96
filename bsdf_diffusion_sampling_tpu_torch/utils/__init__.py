"""Validation metrics, numpy oracles, analytic 1-D distributions and figure
exports."""

from bsdf_diffusion_sampling_tpu_torch.utils.validation import (  # noqa: F401
    histogram_grid_2d,
    image_mse,
    kl_divergence_grid,
    pdf_grid_2d,
    relative_mse,
    sampler_vs_pdf_kl,
)
