"""The golden `obj_primary_64` (tests/golden/obj_primary_64.npy, written by
`tests/test_golden_configs.py::test_golden_obj_primary` through rfw_tpu)
held through the port: the same OBJ scene, built with rfw_tpu's loader
and packer on the CPU, converted with `rfw_tpu_torch.convert` and rendered
by `rfw_tpu_torch.render.wavefront.render_sample` on the CPU (the plain
traversal).

The golden's config is primary rays only (max_bounces=0) through pixel
centres, with the albedo, normal and depth AOVs: no sample is drawn, so
the port's Sobol sampler stands in for the reference's threefry one.

Tolerances: `test_golden_configs._gate`'s, on the uint8 frame: mean
absolute difference below 1.0 and fewer than 1% of texels off by more
than 3. This test only reads the golden; it never writes one.
"""

import os

import numpy as np
import pytest
import torch

from rfw_tpu_torch.convert import from_numpy_scene
from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "obj_primary_64.npy")

# the scene of tests/test_golden_configs.py (config 1: OBJ)
OBJ_SRC = (
    "mtllib gold.mtl\n"
    "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
    "v -0.4 0 -0.4\nv 0.4 0 -0.4\nv 0 1.0 0\n"
    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
    "vn 0 1 0\n"
    "usemtl floor\n"
    "f 1/1/1 3/3/1 2/2/1\nf 1/1/1 4/4/1 3/3/1\n"
    "usemtl pyramid\n"
    "f 5/1 6/2 7/3\n"
)
MTL_SRC = (
    "newmtl floor\nKd 0.6 0.62 0.65\nNs 40\n"
    "\nnewmtl pyramid\nKd 0.8 0.25 0.2\nNs 160\n"
)
SIZE = 64


def _scene(tmp_path):
    """The golden's scene and camera view, built through rfw_tpu (host
    numpy): (TraceScene, DeviceMaterials, DeviceLights, atlas, view)."""
    from rfw_tpu.backend.lights import (
        AreaLightsView, DirectionalLightsView, PointLightsView, SpotLightsView,
    )
    from rfw_tpu.loaders.obj import ObjLoader
    from rfw_tpu.render import pack_trace_scene
    from rfw_tpu.render.atlas import pack_atlas
    from rfw_tpu.render.lights_pack import pack_lights
    from rfw_tpu.scene.camera import Camera3D
    from rfw_tpu.scene.materials import Materials

    (tmp_path / "gold.mtl").write_text(MTL_SRC)
    obj = tmp_path / "gold.obj"
    obj.write_text(OBJ_SRC)
    mats = Materials()
    mesh = ObjLoader().load(str(obj), mats).mesh
    scene = pack_trace_scene([(0, mesh, None)], [(0, np.eye(4, dtype=np.float32)[None])])
    lights = pack_lights(PointLightsView.empty(), SpotLightsView.empty(),
                         DirectionalLightsView.empty(), AreaLightsView.empty())
    atlas = pack_atlas([t for _, t in mats.textures])
    cam = Camera3D(fov=50).look_at(np.array([1.6, 1.5, 2.2], np.float32),
                                   np.array([0, 0.4, 0], np.float32))
    return scene, mats.to_device(), lights, atlas, cam.get_view(SIZE, SIZE).as_array()


def test_obj_primary_golden(tmp_path):
    if not os.path.exists(GOLDEN):
        pytest.fail(f"missing golden {GOLDEN}")
    scene_np, mats_np, lights_np, atlas_np, view = _scene(tmp_path)
    scene, mats, lights, atlas = from_numpy_scene(scene_np, mats_np, lights_np, atlas_np,
                                                  "cpu")
    cfg = RenderConfig(max_bounces=0, sky_intensity=0.8, pixel_center=True, aovs=True,
                       sampler="sobol")
    r = render_sample(scene, mats, atlas, lights, torch.from_numpy(view), SIZE, SIZE, cfg,
                      sample_index=0)
    depth = np.clip(r.depth.numpy() / 6.0, 0, 1)  # misses (T_MAX) saturate to 1
    frame = np.concatenate([
        r.albedo.numpy().reshape(SIZE, SIZE, 3),
        r.normal.numpy().reshape(SIZE, SIZE, 3) * 0.5 + 0.5,
        depth.reshape(SIZE, SIZE, 1),
    ], axis=-1)
    img = np.clip(frame * 255.0, 0, 255).astype(np.uint8)
    ref = np.load(GOLDEN)
    assert ref.shape == img.shape, (ref.shape, img.shape)
    diff = np.abs(img.astype(np.float32) - ref.astype(np.float32))
    mad, frac_off = float(diff.mean()), float((diff > 3.0).mean())
    assert mad < 1.0, f"obj_primary_64: mean abs diff {mad:.3f}"
    assert frac_off < 0.01, f"obj_primary_64: {frac_off:.4f} of texels differ > 3"
    # the frame holds the scene, not a blank: the floor and the pyramid
    assert len(np.unique(img.reshape(-1, 7), axis=0)) > 10
