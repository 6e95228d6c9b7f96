"""Training data: the batched stretch-move ensemble, the banded dataset
generator, and tabulated inverse-CDF sampling."""

from bsdf_diffusion_sampling_tpu_torch.data.mcmc import (  # noqa: F401
    ensemble_mcmc,
    make_domain_log_prob,
)
from bsdf_diffusion_sampling_tpu_torch.data.datasets import generate_brdf_dataset  # noqa: F401
