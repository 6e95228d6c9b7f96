"""The renderer: scene loading, the 8-wide BVH and its traversal kernel, the
binary BVH, materials, the wavefront path tracer and the neural BSDF
adapter."""

from bsdf_diffusion_sampling_tpu_torch.render.integrator import (  # noqa: F401
    MatballFns,
    measured_matball,
    mis_weight,
    neural_matball,
    render,
    render_pass,
)
from bsdf_diffusion_sampling_tpu_torch.render.neural import (  # noqa: F401
    NeuralBSDF,
    make_neural_bsdf,
    neural_eval,
    neural_pdf,
    neural_sample,
)
from bsdf_diffusion_sampling_tpu_torch.render.scene import (  # noqa: F401
    Scene,
    build_scene,
    load_scene,
    parse_scene_xml,
)
