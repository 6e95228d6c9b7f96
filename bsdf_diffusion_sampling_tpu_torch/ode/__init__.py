from bsdf_diffusion_sampling_tpu_torch.ode.flow import (  # noqa: F401
    ode_pdf,
    ode_pdf_exact,
    ode_sample,
    ode_sample_only,
)
