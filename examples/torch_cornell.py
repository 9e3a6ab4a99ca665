"""Cornell-box path-trace demo on rfw_tpu_torch (the counterpart of
examples/cornell.py, BASELINE.json config 3): area light, NEE + BSDF
sampling with MIS, progressive accumulation. Writes a PNG.

Usage: python examples/torch_cornell.py [--size 256] [--spp 16] [--bounces 4]
                                        [--out cornell.png] [--device cpu]

Runs on the CUDA card unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_cornell():
    """Cornell box: 5 walls + 2 blocks + area light, with cbox.mtl-style
    materials (the scene of examples/cornell.py::build_cornell, built
    through rfw_tpu_torch's host copies)."""
    from rfw_tpu_torch.models import cube, quad3d
    from rfw_tpu_torch.models.mesh3d import build_mesh3d
    from rfw_tpu_torch.scene.materials import Material, Materials

    mats = Materials()
    white = mats.push(Material(name="white", color=np.array([0.73, 0.73, 0.73, 1], np.float32), roughness=1.0, specular_f=0.0))
    red = mats.push(Material(name="red", color=np.array([0.63, 0.065, 0.05, 1], np.float32), roughness=1.0, specular_f=0.0))
    green = mats.push(Material(name="green", color=np.array([0.14, 0.45, 0.091, 1], np.float32), roughness=1.0, specular_f=0.0))
    light = mats.push(Material(name="light", color=np.array([17.0, 12.0, 4.0, 1], np.float32)))

    parts = [
        quad3d(normal=(0, 1, 0), position=(0, 0, 0), width=2, height=2, material_id=white),  # floor
        quad3d(normal=(0, -1, 0), position=(0, 2, 0), width=2, height=2, material_id=white),  # ceiling
        quad3d(normal=(0, 0, 1), position=(0, 1, -1), width=2, height=2, material_id=white),  # back
        quad3d(normal=(1, 0, 0), position=(-1, 1, 0), width=2, height=2, material_id=red),  # left
        quad3d(normal=(-1, 0, 0), position=(1, 1, 0), width=2, height=2, material_id=green),  # right
        cube(position=(-0.35, 0.6, -0.35), size=(0.6, 1.2, 0.6), material_id=white),
        cube(position=(0.4, 0.3, 0.3), size=(0.6, 0.6, 0.6), material_id=white),
        quad3d(normal=(0, -1, 0), position=(0, 1.98, 0), width=0.5, height=0.5, material_id=light),
    ]

    # merge into one mesh
    pos = np.concatenate([p.positions for p in parts])
    off = np.cumsum([0] + [p.num_vertices for p in parts[:-1]])
    idx = np.concatenate([p.indices + off[i] for i, p in enumerate(parts)])
    nrm = np.concatenate([p.normals for p in parts])
    uv = np.concatenate([p.uvs for p in parts])
    mat_ids = np.concatenate([p.tri_material for p in parts])
    mesh = build_mesh3d(pos, idx, normals=nrm, uvs=uv, material_ids=mat_ids, name="cornell")
    return mesh, mats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--out", default="cornell.png")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host)")
    args = ap.parse_args(argv)

    import torch

    from rfw_tpu_torch.backend.lights import (
        DirectionalLightsView, PointLightsView, SpotLightsView,
    )
    from rfw_tpu_torch.convert import from_numpy_scene
    from rfw_tpu_torch.render import threefry
    from rfw_tpu_torch.render.atlas import pack_atlas
    from rfw_tpu_torch.render.film import add_sample, new_film, tonemap
    from rfw_tpu_torch.render.lights_pack import pack_lights
    from rfw_tpu_torch.render.pack import pack_trace_scene
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample
    from rfw_tpu_torch.scene.camera import Camera3D
    from rfw_tpu_torch.scene.lights import extract_area_lights
    from rfw_tpu_torch.utils.png import write_png

    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to render on the host")
    dev = torch.device(args.device or "cuda")

    mesh, mats = build_cornell()

    # area-light extraction (reference update_lights semantics)
    light_flags = mats.light_flags()
    emissive_tri = light_flags[mesh.tri_material]
    radiance = np.stack([mats.get(int(m)).emission for m in mesh.tri_material])
    area_lights, light_id = extract_area_lights(
        emissive_tri, radiance, mesh.tri_vertices(),
        np.eye(4, dtype=np.float32)[None], 0, np.array([0]),
    )
    mesh.tri_light[:] = light_id
    print(f"area lights: {area_lights.count}")

    scene_np = pack_trace_scene([(0, mesh, None)], [(0, np.eye(4, dtype=np.float32)[None])])
    lights_np = pack_lights(
        PointLightsView.empty(), SpotLightsView.empty(),
        DirectionalLightsView.empty(), area_lights,
    )
    scene, dmats, dl, atlas = from_numpy_scene(
        scene_np, mats.to_device(), lights_np, pack_atlas([t for _, t in mats.textures]), dev)

    cam = Camera3D(fov=40).look_at(np.array([0, 1.0, 3.4], np.float32), np.array([0, 1.0, 0], np.float32))
    view = torch.from_numpy(cam.get_view(args.size, args.size).as_array()).to(dev)

    cfg = RenderConfig(max_bounces=args.bounces, clamp=100.0)
    film = new_film(args.size, args.size, device=dev)
    key = threefry.PRNGKey(7)
    t0 = time.time()
    for s in range(args.spp):
        res = render_sample(scene, dmats, atlas, dl, view, args.size, args.size, cfg,
                            key=threefry.fold_in(key, s))
        film = add_sample(film, res.radiance)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    rays = args.size * args.size * args.spp * (args.bounces + 1)
    print(f"{args.spp} spp in {dt:.2f}s ({rays/dt/1e6:.1f} Mrays/s on {dev.type}, clock "
          f"stopped after the device finished)")

    frame = tonemap(film, args.spp, args.size, args.size).cpu().numpy()
    write_png(args.out, frame)
    print("saved", args.out)


if __name__ == "__main__":
    main()
