"""The `animated` demo on rfw_tpu_torch (the counterpart of
examples/animated.py): a grid of bouncing instanced spheres as ECS
entities, two skinned CesiumMan characters, the pica interior, three
rotating spot lights and a directional sun, and an FPS overlay, driven
headlessly through the app runtime, frames written as PNGs.

Usage:
  python examples/torch_animated.py [--frames 8] [--size 640x360] [--spp 2]
                                    [--grid 12] [--bounces 2] [--out-dir DIR]
                                    [--assets DIR] [--no-pica] [--font PATH]
                                    [--device cpu] [--cpu]

Renders on the CUDA card through TorchBackend unless `--device` names
another device; with its default settings a skinned character's pose
takes the backend's device skin and refit route, and the sphere grid
(from 64 instances) the device motion route. `--cpu` takes the numpy
oracle backend instead. The characters and the interior load from
`--assets DIR` (DIR/CesiumMan/CesiumMan.gltf, DIR/pica/scene.gltf);
without it, or with `--no-pica` for the interior, the scene goes
without them. The overlay needs a TrueType font (`--font`); without one
the frames carry no text.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--grid", type=int, default=12, help="sphere grid side")
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "animated"))
    ap.add_argument("--no-pica", action="store_true")
    ap.add_argument("--assets", default=None,
                    help="models directory holding CesiumMan/CesiumMan.gltf and "
                         "pica/scene.gltf")
    ap.add_argument("--font", default=None, help="TrueType font for the FPS overlay")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host)")
    ap.add_argument("--cpu", action="store_true",
                    help="use the numpy oracle backend (no torch render)")
    args = ap.parse_args(argv)
    W, H = (int(x) for x in args.size.split("x"))

    from rfw_tpu_torch.app import Instance
    from rfw_tpu_torch.app.timer import GameTimer
    from rfw_tpu_torch.font import FontPlugin, Section, Text
    from rfw_tpu_torch.mathx import compose_trs, quat_identity
    from rfw_tpu_torch.models import sphere
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
    from rfw_tpu_torch.scene import Material
    from rfw_tpu_torch.scene.scene import Scene as SceneT
    from rfw_tpu_torch.utils import Averager, Timer
    from rfw_tpu_torch.utils.png import write_png

    os.makedirs(args.out_dir, exist_ok=True)
    settings = TorchSettings(samples_per_frame=args.spp, max_bounces=args.bounces,
                             sky_intensity=0.5, clamp=20.0)
    if args.cpu:
        from rfw_tpu_torch.render.cpu_reference import CpuReferenceBackend

        backend = CpuReferenceBackend(W, H, settings)
    else:
        backend = TorchBackend(W, H, settings, device=args.device)
    app = Instance(backend, W, H)
    scene = app.scene
    font = None
    if args.font:
        font = FontPlugin(args.font)
        app.with_plugin(font)
    else:
        print("no --font given: the frames carry no FPS overlay", flush=True)

    # ---- content ---------------------------------------------------------
    metal = scene.add_material(Material(
        name="sphere-metal", color=np.array([0.95, 0.64, 0.54, 1], np.float32),
        metallic=1.0, roughness=0.25,
    ))
    ball = sphere(quality=2, radius=0.25, material_id=metal)
    ball_id = scene.add_3d_object(ball)

    # sphere grid as ECS entities: each sphere is an entity with a
    # base-position component and a bounce phase; the update system below
    # queries the batch and computes all matrices in one vectorized pass
    n = args.grid
    handles = []
    for ix in range(n):
        for iz in range(n):
            x = (ix - n / 2) * 0.8
            z = (iz - n / 2) * 0.8
            h = scene.add_3d_instance(ball_id)
            app.world.spawn(
                base_xz=np.array([x, z], np.float32),
                phase=np.float32(0.3 * (x + z)),
                handle_idx=np.int64(len(handles)),
            )
            handles.append(h)
    print(f"{len(handles)} sphere instances (ECS entities)")

    # skinned characters
    men = []
    if args.assets is None:
        print("no --assets DIR: no CesiumMan characters, no pica interior", flush=True)
    else:
        cesium = os.path.join(args.assets, "CesiumMan", "CesiumMan.gltf")
        for x in (-2.5, 2.5):
            man = scene.add_3d(scene.load(cesium))
            man.set_root_matrix(compose_trs(
                np.array([x, 0, 0], np.float32), quat_identity(),
                np.array([1.5, 1.5, 1.5], np.float32)))
            men.append(man)
        if not args.no_pica:
            pica = scene.add_3d(scene.load(os.path.join(args.assets, "pica", "scene.gltf")))
            # centre the room under the demo content (pica's world bounds are
            # roughly [-37,-1,-32]..[27,19,18]): shift to the origin, floor at
            # y=0, scale to ~18 units across
            k = 18.0 / 64.0
            center_xz = np.array([(-36.92 + 27.37) / 2, 0.0, (-32.19 + 18.17) / 2])
            t = np.array([-center_xz[0] * k, 1.17 * k, -center_xz[2] * k], np.float32)
            pica.set_root_matrix(compose_trs(t, quat_identity(), np.full(3, k, np.float32)))

    # lights (the reference's: 3 rotating spots + 1 directional)
    scene.add_directional_light((0.35, -1.0, 0.25), (2.2, 2.1, 1.9))
    spot_ids = [
        scene.add_spot_light((np.cos(a) * 5, 6, np.sin(a) * 5), (0, -1, 0),
                             (60, 56, 50), 20, 35)
        for a in (0.0, 2.1, 4.2)
    ]

    # ---- systems ---------------------------------------------------------
    def bounce_spheres(world):
        t = world.get(GameTimer).elapsed
        batch = world.query("base_xz", "phase", "handle_idx")
        xz = batch.col("base_xz")  # (N,2): the whole grid in one expression
        y = 0.3 + np.abs(np.sin(t * 2.0 + batch.col("phase")))
        mats = np.tile(np.eye(4, dtype=np.float32), (len(batch), 1, 1))
        mats[:, 0, 3] = xz[:, 0]
        mats[:, 1, 3] = y
        mats[:, 2, 3] = xz[:, 1]
        for idx, m in zip(batch.col("handle_idx"), mats):
            handles[int(idx)].set_matrix(m)
        # a handle edit does not raise the scene's instance flag (the
        # reference's behaviour; the characters' animation raises it every
        # frame); raise it so the spheres move without characters too
        world.get(SceneT)._instances_changed = True

    def animate(world):
        t = world.get(GameTimer).elapsed
        for man, dt in zip(men, (0.0, 0.7)):
            man.set_time(t + dt)
        sc = world.get(SceneT)
        for k, sid in enumerate(spot_ids):
            a = t * 0.8 + k * 2.1
            sl = sc.lights.spot.get_mut(sid)
            sl.position = np.array([np.cos(a) * 5, 6, np.sin(a) * 5], np.float32)

    fps = Averager(100)

    def overlay(world):
        timer = world.get(GameTimer)
        if timer.dt > 0:
            fps.add(1.0 / timer.dt)
        font.draw(Section(
            screen_position=(10, 10),
            texts=[Text(f"FPS {fps.average():5.1f}  frame {timer.frame}", px=22)],
        ))

    app.with_system(bounce_spheres).with_system(animate)
    if font is not None:
        app.with_system(overlay)
    app.camera.look_at(np.array([5.5, 4.0, 7.0], np.float32),
                       np.array([0, 1.2, 0], np.float32))
    app.camera.fov = 62

    # ---- run -------------------------------------------------------------
    t = Timer()
    for i in range(args.frames):
        frame = app.render_frame()
        write_png(f"{args.out_dir}/frame_{i:04d}.png", frame)
        line = f"frame {i}: {t.elapsed_ms():.0f}ms"
        st = getattr(backend, "stats", None)
        if st is not None:
            line += (f"  (sync {st['sync_ms'].last():.0f}ms, render "
                     f"{st['render_ms'].last():.0f}ms, {st['mrays_per_s'].last():.1f} Mray/s)")
        print(line, flush=True)
        t.reset()


if __name__ == "__main__":
    main()
