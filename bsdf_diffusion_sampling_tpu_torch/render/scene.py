"""Scene description: Mitsuba-XML subset parser + matpreview assembly,
counterpart of the JAX package's `render/scene.py`.

Parses the reference's scene dialects: the modern one (version 3.0.0,
snake_case property names) and the version-0.5.0 array scenes (camelCase
names, per-shape inline `mybsdf` materials, point-light emitters):

- <default> substitution, <transform> composition (each child
  left-multiplies the accumulated matrix), perspective <sensor> with
  fov_axis=smaller, serialized <shape>s.
- Property-name normalization (max_depth == maxDepth, shape_index ==
  shapeIndex, sample_count == sampleCount).
- Materials: top-level id'd <bsdf>s referenced via <ref>, or inline
  per-shape <bsdf type="mybsdf"> hooks carrying a measured filename or a
  material-table idx + albedo. Every distinct mybsdf becomes its own
  matball slot: ball i gets material id MAT_BALL + i.
- Emitters: an envmap and/or point lights; a scene without an envmap gets
  a black placeholder so the integrator is structurally identical.

Output is a Scene: the BVH over all world-space triangles with
per-triangle material ids, the envmap, point lights, the camera and the
description. The BVH is the 8-wide one by default (`wide=True`), which
kernel K5 walks on the card and its plain walker on the CPU; `wide=False`
builds the binary one (`render/bvh.py`), walked in plain PyTorch on either.
The integrator picks the walk by the accel's type.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.core.device import resolve_device
from bsdf_diffusion_sampling_tpu_torch.render.bvh import BVH, build_bvh
from bsdf_diffusion_sampling_tpu_torch.render.bvh8 import BVH8, build_bvh8
from bsdf_diffusion_sampling_tpu_torch.render.camera import Camera, make_camera
from bsdf_diffusion_sampling_tpu_torch.render.envmap import EnvMap, black_envmap, load_envmap
from bsdf_diffusion_sampling_tpu_torch.render.mesh import build_soup, load_serialized, transform_mesh

MAT_PLANE = 0
MAT_DIFFUSE = 1
MAT_BALL = 2  # matball slot i has material id MAT_BALL + i


@dataclass
class SceneDesc:
    camera: Camera
    width: int
    height: int
    spp: int
    max_depth: int
    envmap_path: str  # "" = no envmap (point-light scene)
    envmap_to_world: np.ndarray
    envmap_scale: float
    shapes: List[dict] = field(default_factory=list)  # filename/index/to_world/mat
    # one entry per distinct mybsdf hook: {"filename": str, "idx": int,
    # "albedo": (r, g, b)}
    matballs: List[dict] = field(default_factory=list)
    point_lights: np.ndarray = field(default_factory=lambda: np.zeros((0, 6), np.float32))


class Scene(NamedTuple):
    accel: Union[BVH8, BVH]
    envmap: EnvMap
    camera: Camera
    desc: SceneDesc
    lights: torch.Tensor  # (P, 6) point lights: position, intensity

    @property
    def device(self) -> torch.device:
        return self.accel.device

    def to(self, device) -> "Scene":
        return self._replace(accel=self.accel.to(device), envmap=self.envmap.to(device),
                             lights=self.lights.to(device))


def _rotation(axis: np.ndarray, angle_deg: float) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    x, y, z = axis / np.linalg.norm(axis)
    c, s = np.cos(a), np.sin(a)
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ]
    )
    m = np.eye(4)
    m[:3, :3] = r
    return m


def _parse_transform(elem: ET.Element) -> np.ndarray:
    """Compose child elements in document order; each new op left-multiplies
    (Mitsuba semantics: later ops apply after earlier ones)."""
    m = np.eye(4)
    for child in elem:
        tag = child.tag.lower()
        if tag == "matrix":
            vals = np.array([float(v) for v in child.get("value").split()])
            op = vals.reshape(4, 4)
        elif tag == "rotate":
            axis = np.array(
                [float(child.get(k, 0)) for k in ("x", "y", "z")], np.float64
            )
            op = _rotation(axis, float(child.get("angle")))
        elif tag == "translate":
            op = np.eye(4)
            op[:3, 3] = [float(child.get(k, 0)) for k in ("x", "y", "z")]
        elif tag == "scale":
            op = np.diag(
                [float(child.get(k, 1)) for k in ("x", "y", "z")] + [1.0]
            )
        elif tag == "lookat":
            continue  # handled by the sensor parser
        else:
            raise ValueError(f"unsupported transform op <{tag}>")
        m = op @ m
    return m


def _norm(name: Optional[str]) -> str:
    """Property-name normalization across XML dialects: max_depth ==
    maxDepth, shape_index == shapeIndex, sample_count == sampleCount."""
    return name.strip().replace("_", "").lower() if name else ""


def _floats(s: str) -> List[float]:
    return [float(v) for v in s.replace(",", " ").split()]


def _get_props(elem: ET.Element, defaults: Dict[str, str]) -> Dict[str, str]:
    props = {}
    for child in elem:
        if child.tag in ("integer", "float", "string", "boolean"):
            v = child.get("value")
            if v.startswith("$"):
                v = defaults[v[1:]]
            props[_norm(child.get("name"))] = v
    return props


def _parse_mybsdf(elem: ET.Element) -> dict:
    """One mybsdf hook -> matball descriptor: measured filename
    (`scene_measured.xml:60-62`) or material-table idx + albedo tint
    (`scene_bsdf.xml:60-61`)."""
    filename, idx, albedo = "", -1, (1.0, 1.0, 1.0)
    for s in elem.findall("string"):
        if _norm(s.get("name")) == "filename":
            filename = s.get("value").strip()
    for s in elem.findall("integer"):
        if _norm(s.get("name")) == "idx":
            idx = int(s.get("value"))
    for s in elem.findall("vector"):
        if _norm(s.get("name")) == "albedo":
            albedo = tuple(_floats(s.get("value")))
    return {"filename": filename, "idx": idx, "albedo": albedo}


def parse_scene_xml(path: str, spp: Optional[int] = None,
                    width: Optional[int] = None, height: Optional[int] = None) -> SceneDesc:
    root = ET.parse(path).getroot()
    defaults = {d.get("name"): d.get("value") for d in root.findall("default")}
    if spp is not None:
        defaults["spp"] = str(spp)
    if width is not None:
        defaults["width"] = str(width)
    if height is not None:
        defaults["height"] = str(height)

    # sensor
    sensor = root.find("sensor")
    fov = float(next(f.get("value") for f in sensor.findall("float")
                     if _norm(f.get("name")) == "fov"))
    lookat = next(c for c in sensor.find("transform")
                  if c.tag.lower() == "lookat")
    origin = np.array(_floats(lookat.get("origin")))
    target = np.array(_floats(lookat.get("target")))
    up = np.array(_floats(lookat.get("up")))
    film = sensor.find("film")
    film_props = _get_props(film, defaults)
    w = int(film_props["width"]) if width is None else width
    h = int(film_props["height"]) if height is None else height
    sampler_props = _get_props(sensor.find("sampler"), defaults)
    # an explicit spp= wins over the XML's literal samplecount
    spp_v = (spp if spp is not None
             else int(sampler_props.get("samplecount", defaults.get("spp", "64"))))
    integrator_props = _get_props(root.find("integrator"), defaults)
    max_depth = int(integrator_props.get("maxdepth", "-1"))

    cam = make_camera(origin, target, up, fov, w, h)

    # emitters: envmap and/or point lights
    env_file, env_tf, e_scale = "", np.eye(4), 1.0
    point_lights: List[List[float]] = []
    for emitter in root.findall("emitter"):
        etype = emitter.get("type")
        if etype == "envmap":
            e_props = _get_props(emitter, defaults)
            env_file = os.path.join(os.path.dirname(path), e_props["filename"])
            tf = emitter.find("transform")
            env_tf = _parse_transform(tf) if tf is not None else np.eye(4)
            for f in emitter.findall("float"):
                if _norm(f.get("name")) == "scale":
                    e_scale = float(f.get("value"))
        elif etype == "point":
            pos = [0.0, 0.0, 0.0]
            inten = [1.0, 1.0, 1.0]
            for p in emitter.findall("point"):
                if _norm(p.get("name")) == "position":
                    pos = _floats(p.get("value"))
            for r in emitter.findall("rgb"):
                if _norm(r.get("name")) == "intensity":
                    v = _floats(r.get("value"))
                    inten = v * 3 if len(v) == 1 else v
            point_lights.append(pos + inten)
        else:
            raise ValueError(f"unsupported emitter type {etype!r}")

    # materials: top-level id'd bsdfs (referenced by shapes) + inline
    # per-shape mybsdf hooks; every distinct mybsdf gets a matball slot
    matballs: List[dict] = []
    ball_key_to_id: Dict[tuple, int] = {}

    def _ball_id(mb: dict) -> int:
        k = (mb["filename"], mb["idx"], mb["albedo"])
        if k not in ball_key_to_id:
            ball_key_to_id[k] = MAT_BALL + len(matballs)
            matballs.append(mb)
        return ball_key_to_id[k]

    mat_of_ref: Dict[str, int] = {}
    for b in root.findall("bsdf"):
        bid = b.get("id")
        btype = b.get("type")
        if bid is None:
            continue
        if btype == "mybsdf":
            mat_of_ref[bid] = _ball_id(_parse_mybsdf(b))
        elif btype == "diffuse":
            # textured diffuse = the checkerboard ground plane; constant
            # rgb diffuse = the gray matball interior
            is_textured = b.find("ref") is not None
            mat_of_ref[bid] = MAT_PLANE if is_textured else MAT_DIFFUSE
        else:
            raise ValueError(f"unsupported bsdf type {btype!r}")

    # shapes
    shapes = []
    for sh in root.findall("shape"):
        props = _get_props(sh, defaults)
        inline = sh.find("bsdf")
        if inline is not None and inline.get("type") == "mybsdf":
            mat = _ball_id(_parse_mybsdf(inline))
        else:
            ref = next(r for r in sh.findall("ref")
                       if _norm(r.get("name", "bsdf")) == "bsdf")
            mat = mat_of_ref[ref.get("id")]
        shapes.append(
            dict(
                filename=os.path.normpath(os.path.join(
                    os.path.dirname(path), props["filename"])),
                shape_index=int(props.get("shapeindex", "0")),
                to_world=_parse_transform(sh.find("transform")),
                material=mat,
            )
        )

    return SceneDesc(
        camera=cam, width=w, height=h, spp=spp_v, max_depth=max_depth,
        envmap_path=env_file, envmap_to_world=env_tf, envmap_scale=e_scale,
        shapes=shapes, matballs=matballs,
        point_lights=np.asarray(point_lights, np.float32).reshape(-1, 6),
    )


def build_scene(desc: SceneDesc, device="cuda", wide: bool = True) -> Scene:
    """The scene's accel, envmap and lights on `device` (the card by default;
    pass device="cpu" for the CPU). The accel is the 8-wide BVH, or with
    `wide=False` the binary one."""
    device = resolve_device(device)
    meshes, mats = [], []
    for sh in desc.shapes:
        meshes.append(transform_mesh(load_serialized(sh["filename"], sh["shape_index"]), sh["to_world"]))
        mats.append(sh["material"])
    if desc.envmap_path:
        env = load_envmap(desc.envmap_path, desc.envmap_to_world, desc.envmap_scale)
    else:
        env = black_envmap()
    soup = build_soup(meshes, mats)
    scene = Scene(accel=build_bvh8(soup) if wide else build_bvh(soup), envmap=env, camera=desc.camera, desc=desc,
                  lights=torch.from_numpy(np.array(desc.point_lights, np.float32)))
    return scene.to(device)


def load_scene(path: str, device="cuda", wide: bool = True, **overrides) -> Scene:
    device = resolve_device(device)
    return build_scene(parse_scene_xml(path, **overrides), device=device, wide=wide)
