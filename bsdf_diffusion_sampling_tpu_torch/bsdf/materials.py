"""The 26-entry material table (counterpart of the JAX package's
`bsdf/materials.py`, the reference's `bsdf_materials` index): 23
principled materials and three Beckmann bk7 rough dielectrics.

Quirk kept: the reference defines `dict4_principled` twice and the second
definition (metallic .2, specular .3, roughness .3) shadows the first, so
index 3 uses the second.

All principled entries share spec_tint .5, clearcoat .5/.5, spec_trans .9,
flatness 1.0, sheen .5 (sheen_tint .3 only for #8), anisotropic .7 (.5 for
#1-3); only (metallic, specular, roughness) vary otherwise, so the table is
stored as deltas over a common base.
"""

from __future__ import annotations

from typing import List, Union

from bsdf_diffusion_sampling_tpu_torch.bsdf.principled import PrincipledParams, eval_principled
from bsdf_diffusion_sampling_tpu_torch.bsdf.rough import RoughDielectricParams, eval_roughdielectric

_BASE = dict(spec_tint=0.5, anisotropic=0.7, sheen=0.5, sheen_tint=0.5, clearcoat=0.5, clearcoat_gloss=0.5,
             spec_trans=0.9, flatness=1.0)

# (metallic, specular, roughness, overrides)
_PRINCIPLED_ROWS = [
    (0.1, 1.0, 0.2, {"anisotropic": 0.5}),   # 1
    (0.3, 0.7, 0.5, {"anisotropic": 0.5}),   # 2
    (1.0, 0.8, 0.1, {"anisotropic": 0.5}),   # 3
    (0.2, 0.3, 0.3, {}),                     # 4 (second definition wins)
    (0.1, 0.8, 0.3, {}),                     # 5
    (0.1, 1.0, 0.1, {}),                     # 6
    (0.9, 0.7, 0.3, {}),                     # 7
    (0.5, 0.8, 0.3, {"sheen_tint": 0.3}),    # 8
    (0.1, 0.8, 0.3, {}),                     # 9
    (0.3, 0.2, 0.1, {}),                     # 10
    (0.0, 1.0, 0.1, {}),                     # 11
    (0.8, 0.2, 0.1, {}),                     # 12
    (0.6, 0.2, 0.3, {}),                     # 13
    (0.3, 0.2, 0.7, {}),                     # 14
    (0.9, 0.2, 0.5, {}),                     # 15
    (0.9, 0.2, 0.3, {}),                     # 16
    (0.9, 0.2, 0.6, {}),                     # 17
    (0.9, 0.2, 0.9, {}),                     # 18
    (0.1, 0.8, 0.1, {}),                     # 19
    (0.1, 0.5, 0.4, {}),                     # 20
    (0.1, 0.8, 0.3, {}),                     # 21
    (0.1, 0.5, 0.7, {}),                     # 22
    (0.1, 0.3, 0.8, {}),                     # 23
]

MaterialParams = Union[PrincipledParams, RoughDielectricParams]


def _build() -> List[MaterialParams]:
    mats: List[MaterialParams] = []
    for metallic, specular, roughness, over in _PRINCIPLED_ROWS:
        mats.append(PrincipledParams(**{**_BASE, "metallic": metallic, "specular": specular,
                                        "roughness": roughness, **over}))
    for alpha in (0.2, 0.3, 0.5):
        mats.append(RoughDielectricParams(alpha=alpha, int_ior="bk7", ext_ior="air", distribution="beckmann"))
    return mats


BSDF_MATERIALS: List[MaterialParams] = _build()


def eval_material(params: MaterialParams, wi, wo):
    """f * cos of a table entry: a scalar per direction pair, as both the
    principled (white) and the dielectric entries are grey."""
    if isinstance(params, PrincipledParams):
        return eval_principled(params, wi, wo)
    return eval_roughdielectric(params, wi, wo)
