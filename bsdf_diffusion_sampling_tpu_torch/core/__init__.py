"""Configuration dataclasses and the torch.Generator discipline."""

from bsdf_diffusion_sampling_tpu_torch.core import config, prng  # noqa: F401
