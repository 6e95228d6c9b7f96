"""Measured BSDFs: the RGL tensor-file container, the 2D warp and the
isotropic measured-BRDF evaluator."""

from bsdf_diffusion_sampling_tpu_torch.bsdf.analytic import (  # noqa: F401
    ggx_shading_disk,
    ggx_shading_spherical,
)
from bsdf_diffusion_sampling_tpu_torch.bsdf.measured import (  # noqa: F401
    MeasuredBRDF,
    eval_brdf,
    eval_lum,
    load_measured,
    pdf_brdf,
    rgb_to_luminance,
    sample_brdf,
)
from bsdf_diffusion_sampling_tpu_torch.bsdf.tensorfile import read_tensor_file  # noqa: F401
from bsdf_diffusion_sampling_tpu_torch.bsdf.materials import (  # noqa: F401
    BSDF_MATERIALS,
    eval_material,
)
from bsdf_diffusion_sampling_tpu_torch.bsdf.principled import (  # noqa: F401
    PrincipledParams,
    eval_principled,
)
from bsdf_diffusion_sampling_tpu_torch.bsdf.rough import (  # noqa: F401
    RoughConductorParams,
    RoughDielectricParams,
    eval_roughconductor,
    eval_roughdielectric,
)
