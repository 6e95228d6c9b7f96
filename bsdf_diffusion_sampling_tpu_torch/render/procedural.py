"""A procedural stand-in for the matpreview scene, written in the formats
the renderer reads: `.serialized` meshes, a Mitsuba-XML scene in the
`scene_measured.xml` dialect, a lat-long EXR envmap and a measured-BRDF
`.bsdf` tensor file. Used where the real scene files are not at hand.

The scene: a UV-sphere matball (the `mybsdf` material, MAT_BALL) with
normals and uvs, resting on a checkered ground plane (MAT_PLANE), under a
sky envmap with a small bright sun. The default tessellation gives 61,648
triangles, the matpreview scene's size (61.6k). The matball's hook names
the measured BRDF (`scene_measured.xml`), or, with `table=`, a material-
table index and an albedo tint as `scene_bsdf.xml` does (no `.bsdf` file
then).
"""

from __future__ import annotations

import math
import os

import numpy as np

from bsdf_diffusion_sampling_tpu_torch.bsdf.tensorfile import write_tensor_file
from bsdf_diffusion_sampling_tpu_torch.native.exr import write_exr
from bsdf_diffusion_sampling_tpu_torch.render.mesh import Mesh, write_serialized


def uv_sphere(n_lat: int, n_lon: int) -> Mesh:
    """A unit sphere of 2 * n_lon * (n_lat - 1) triangles; the pole rows are
    fans."""
    th = np.linspace(0.0, math.pi, n_lat + 1)
    ph = np.linspace(0.0, 2.0 * math.pi, n_lon + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")  # (n_lat+1, n_lon+1)
    nrm = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)], -1)
    uv = np.stack([pp / (2.0 * math.pi), tt / math.pi], -1)
    idx = np.arange((n_lat + 1) * (n_lon + 1)).reshape(n_lat + 1, n_lon + 1)
    a, b = idx[:-1, :-1], idx[:-1, 1:]
    c, d = idx[1:, :-1], idx[1:, 1:]
    faces = [np.stack([a[1:], d[1:], b[1:]], -1).reshape(-1, 3),  # skip the north-pole slivers
             np.stack([a[:-1], c[:-1], d[:-1]], -1).reshape(-1, 3)]  # and the south-pole ones
    return Mesh(nrm.reshape(-1, 3).astype(np.float32), nrm.reshape(-1, 3).astype(np.float32),
                uv.reshape(-1, 2).astype(np.float32), np.concatenate(faces).astype(np.int32))


def plane_grid(g: int, half: float) -> Mesh:
    """A g x g quad grid over [-half, half]^2 at y = 0, normal +y, uv in [0, 1]."""
    s = np.linspace(-half, half, g + 1)
    xx, zz = np.meshgrid(s, s, indexing="ij")
    pos = np.stack([xx, np.zeros_like(xx), zz], -1).reshape(-1, 3)
    uv = np.stack([(xx + half) / (2 * half), (zz + half) / (2 * half)], -1).reshape(-1, 2)
    idx = np.arange((g + 1) * (g + 1)).reshape(g + 1, g + 1)
    a, b, c, d = idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:], idx[1:, 1:]
    faces = np.concatenate([np.stack([a, c, b], -1).reshape(-1, 3), np.stack([b, c, d], -1).reshape(-1, 3)])
    nrm = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (len(pos), 1))
    return Mesh(pos.astype(np.float32), nrm, uv.astype(np.float32), faces.astype(np.int32))


SUN_DIR = (0.4, 0.75, 0.5)
SUN_RADIANCE = 60.0
MATERIAL = "synthetic_rgb"  # the scene's mybsdf filename; its .bsdf file sits beside the XML
ANISO_MATERIAL = "synthetic_aniso_rgb"  # the anisotropic twin (4 phi_i x 8 theta_i), written on request
ANISO_PHI = 4
ROUGHNESS = 0.35  # of the synthesized BRDF's lobes
TABLE = (20, (0.4, 0.8, 0.4))  # scene_bsdf.xml's hook: material-table idx 20, a green albedo


def sky_envmap(h: int, w: int) -> np.ndarray:
    """(h, w, 3) lat-long radiance in Mitsuba's convention: a blue-to-white
    gradient, a dim ground and a sun disk of ~3 degrees."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v[:, None] * math.pi
    phi = (2.0 * u[None, :] - 1.0) * math.pi
    d = np.stack(np.broadcast_arrays(np.sin(theta) * np.sin(phi), np.cos(theta), -np.sin(theta) * np.cos(phi)), -1)
    y = d[..., 1:2]
    sky = np.where(y > 0, (1 - y) * np.array([0.9, 0.95, 1.0]) + y * np.array([0.25, 0.45, 0.9]),
                   np.array([0.12, 0.1, 0.08]))
    s = np.asarray(SUN_DIR, np.float64)
    s = s / np.linalg.norm(s)
    sun = (d @ s) > math.cos(math.radians(3.0))
    img = np.where(sun[..., None], SUN_RADIANCE * np.array([1.0, 0.95, 0.85]), sky)
    return img.astype(np.float32)


def synthetic_measured_tensors(seed: int = 0, vndf_res=(64, 64), lum_res=(32, 32), sigma_w: int = 64,
                               n_phi: int = 1) -> dict:
    """An RGL-style tensor dict (the fields `measured_from_tensors` reads)
    for a rough, tinted glossy material: vndf, ndf and luminance tables are
    smooth lobes in the sqrt-elevation parameterization with a little seeded
    noise, and the rgb ratios a tint over the luminance. With n_phi > 1 it is
    anisotropic: n_phi slices at phi_i = linspace(-pi, pi, n_phi), each with
    its own seeded shift of the vndf's cosine modulation and of the
    luminance lobe's centre (a bare per-slice scale would cancel in the
    normalised warps). n_phi = 1 is the isotropic file (phi_i = 0)."""
    rng = np.random.default_rng(seed)
    if n_phi == 1:
        phi_i, shift = np.zeros(1), np.zeros((1, 3))
    else:
        phi_i = np.linspace(-math.pi, math.pi, n_phi)
        shift = np.random.default_rng([seed, n_phi]).uniform(-1.0, 1.0, (n_phi, 3)) * [math.pi, 0.15, 0.15]
    theta_i = (np.linspace(0.0, 1.0, 8) ** 2 * (math.pi / 2) * 0.98).astype(np.float32)
    hv, wv = vndf_res
    ux = np.linspace(0.0, 1.0, hv)[:, None] * np.ones((1, wv))  # rows: theta_m, as u^2 pi/2
    th_m = ux * ux * (math.pi / 2)
    lobe = np.exp(-(np.tan(np.minimum(th_m, 1.55)) / ROUGHNESS) ** 2) + 0.02
    vndf = np.stack([[lobe * (1.0 + 0.3 * math.sin(t) * np.cos(np.linspace(0, 2 * math.pi, wv) - d[0])[None, :])
                      for t in theta_i] for d in shift])
    vndf *= 1.0 + 0.05 * rng.random(vndf.shape)
    hl, wl = lum_res
    yy, xx = np.meshgrid(np.linspace(0, 1, hl), np.linspace(0, 1, wl), indexing="ij")
    lum = np.stack([[np.exp(-((xx - 0.3 - 0.2 * t - d[1]) ** 2 + (yy - 0.5 - d[2]) ** 2) / 0.08) + 0.1
                     for t in theta_i] for d in shift])
    lum *= 1.0 + 0.05 * rng.random(lum.shape)
    tint = np.array([0.9, 0.6, 0.3])
    rgb = lum[:, :, None] * tint[None, None, :, None, None] * 0.5
    ndf_row = np.exp(-(np.tan(np.minimum(np.linspace(0, 1, sigma_w) ** 2 * math.pi / 2, 1.55)) / ROUGHNESS) ** 2)
    ndf_row = ndf_row / (math.pi * ROUGHNESS ** 2) + 1e-3
    sigma_row = 0.5 + 0.5 * np.cos(np.linspace(0, 1, sigma_w) ** 2 * math.pi / 2)
    return {
        "theta_i": theta_i,
        "phi_i": phi_i.astype(np.float32),
        "sigma": np.stack([sigma_row, sigma_row]).astype(np.float32),
        "ndf": np.stack([ndf_row, ndf_row]).astype(np.float32),
        "vndf": vndf.astype(np.float32),
        "luminance": lum.astype(np.float32),
        "rgb": rgb.astype(np.float32),
    }


def _hook_xml(table) -> str:
    if table is None:
        return f'<string name="filename" value="{MATERIAL}"/>'
    idx, albedo = table
    return f'<integer name="idx" value="{idx}"/>\n        <vector name="albedo" value="{", ".join(map(str, albedo))}"/>'


def _xml(width: int, height: int, spp: int, max_depth: int, lights, table) -> str:
    light_xml = "".join(
        f'    <emitter type="point">\n        <point name="position" value="{p[0]}, {p[1]}, {p[2]}"/>\n'
        f'        <rgb name="intensity" value="{p[3]}, {p[4]}, {p[5]}"/>\n    </emitter>\n' for p in lights)
    return f"""<scene version="3.0.0">
    <default name="spp" value="{spp}"/>
    <default name="width" value="{width}"/>
    <default name="height" value="{height}"/>
    <integrator type="path">
        <integer name="max_depth" value="{max_depth}"/>
    </integrator>
    <sensor type="perspective">
        <string name="fov_axis" value="smaller"/>
        <float name="fov" value="30"/>
        <transform name="to_world">
            <lookat origin="0, 2.2, 6.2" target="0, 0.85, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent">
            <integer name="sample_count" value="$spp"/>
        </sampler>
        <film type="hdrfilm">
            <integer name="width" value="$width"/>
            <integer name="height" value="$height"/>
        </film>
    </sensor>
    <emitter type="envmap">
        <string name="filename" value="envmap.exr"/>
        <transform name="to_world">
            <rotate y="1" angle="-90"/>
        </transform>
        <float name="scale" value="1.0"/>
    </emitter>
{light_xml}    <texture type="checkerboard" id="checks">
        <rgb name="color0" value="0.4"/>
        <rgb name="color1" value="0.2"/>
    </texture>
    <bsdf type="diffuse" id="plane_mat">
        <ref name="reflectance" id="checks"/>
    </bsdf>
    <bsdf type="mybsdf" id="ball_mat">
        {_hook_xml(table)}
    </bsdf>
    <shape type="serialized" id="plane">
        <string name="filename" value="scene.serialized"/>
        <integer name="shape_index" value="0"/>
        <transform name="to_world">
            <scale x="1" y="1" z="1"/>
        </transform>
        <ref id="plane_mat"/>
    </shape>
    <shape type="serialized" id="ball">
        <string name="filename" value="scene.serialized"/>
        <integer name="shape_index" value="1"/>
        <transform name="to_world">
            <translate x="0" y="1.0" z="0"/>
        </transform>
        <ref id="ball_mat"/>
    </shape>
</scene>
"""


def write_scene(directory: str, *, n_lat: int = 150, n_lon: int = 200, plane_g: int = 32,
                env_res=(128, 256), width: int = 512, height: int = 512, spp: int = 64,
                max_depth: int = 12, lights=(), table=None, anisotropic: bool = False) -> str:
    """Write the scene into `directory` and return the XML's path. `lights`
    is a list of point lights (x, y, z, r, g, b). Without `table` the
    matball is the measured BRDF, written to `<directory>/<MATERIAL>.bsdf`,
    and the XML is `scene_measured.xml`; with `table` = (idx, albedo) (e.g.
    `TABLE`) it is that material-table entry and the XML `scene_bsdf.xml`.
    With `anisotropic`, `<directory>/<ANISO_MATERIAL>.bsdf` (4 phi_i x 8
    theta_i slices, vndf 64 x 64, luminance 32 x 32) is written too, for
    `--material synthetic_aniso_rgb`."""
    os.makedirs(directory, exist_ok=True)
    write_serialized(os.path.join(directory, "scene.serialized"),
                     [plane_grid(plane_g, 6.0), uv_sphere(n_lat, n_lon)])
    write_exr(os.path.join(directory, "envmap.exr"), sky_envmap(*env_res))
    if table is None:
        write_tensor_file(os.path.join(directory, f"{MATERIAL}.bsdf"), synthetic_measured_tensors())
    if anisotropic:
        write_tensor_file(os.path.join(directory, f"{ANISO_MATERIAL}.bsdf"),
                          synthetic_measured_tensors(n_phi=ANISO_PHI))
    path = os.path.join(directory, "scene_measured.xml" if table is None else "scene_bsdf.xml")
    with open(path, "w") as f:
        f.write(_xml(width, height, spp, max_depth, lights, table))
    return path
