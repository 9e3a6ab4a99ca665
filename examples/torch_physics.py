"""Physics-coupled demo on rfw_tpu_torch (the counterpart of
examples/physics.py, BASELINE.json config 5): spheres dropped on a plane,
an impulse on frame 5, physics state copied into the scene's instance
transforms each frame -> a motion sync (on the card's motion route from 64
instances) + path trace + a text overlay. Writes a PNG per frame.

Usage: python examples/torch_physics.py [--frames 10] [--size 320x180] [--spp 2]
                                        [--balls 12] [--out-dir DIR]
                                        [--font PATH] [--device cpu]

Runs on the CUDA card unless `--device` names another device. The overlay
needs a TrueType font (`--font`); without one the frames carry no text.
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
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--size", default="320x180")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--balls", type=int, default=12,
                    help="sphere instance count (large pools exercise the "
                         "device instance-motion path, gated at >= 64)")
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "physics"))
    ap.add_argument("--font", default=None, help="TrueType font for the overlay text")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host)")
    args = ap.parse_args(argv)
    W, H = (int(x) for x in args.size.split("x"))
    os.makedirs(args.out_dir, exist_ok=True)

    from rfw_tpu_torch.app import Instance
    from rfw_tpu_torch.app.timer import GameTimer
    from rfw_tpu_torch.font import FontPlugin, Section, Text
    from rfw_tpu_torch.models import plane, sphere
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
    from rfw_tpu_torch.scene import Material
    from rfw_tpu_torch.utils.physics import SphereWorld
    from rfw_tpu_torch.utils.png import write_png

    backend = TorchBackend(W, H, TorchSettings(samples_per_frame=args.spp,
                                               max_bounces=2, sky_intensity=0.6),
                           device=args.device)
    app = Instance(backend, W, H)
    scene = app.scene
    font = None
    if args.font:
        font = FontPlugin(args.font)
        app.with_plugin(font)
    else:
        print("no --font given: the frames carry no overlay text", flush=True)

    mat_floor = scene.add_material(Material(
        color=np.array([0.55, 0.55, 0.6, 1], np.float32), roughness=0.9))
    mat_ball = scene.add_material(Material(
        color=np.array([0.8, 0.35, 0.2, 1], np.float32), roughness=0.35,
        metallic=0.6))

    floor_id = scene.add_3d_object(plane(up=(0, 1, 0), size=(20, 20),
                                         material_id=mat_floor))
    scene.add_3d_instance(floor_id)
    ball = sphere(quality=2, radius=0.5, material_id=mat_ball)
    ball_id = scene.add_3d_object(ball)

    world = SphereWorld.new()
    handles = []
    rng = np.random.default_rng(3)
    side = max(1.5, 0.45 * float(args.balls) ** 0.5 * 1.2)
    for k in range(args.balls):
        p = np.array([rng.uniform(-side, side), 2.0 + (k % 24) * 1.1,
                      rng.uniform(-side, side)], np.float32)
        world.add_sphere(p, radius=0.5)
        handles.append(scene.add_3d_instance(ball_id))

    scene.add_directional_light((0.4, -1, 0.3), (2.5, 2.4, 2.2))
    scene.add_point_light((0, 6, 4), (40, 40, 42))

    def physics_system(w):
        timer = w.get(GameTimer)
        dt = min(max(timer.dt, 1e-3), 0.05)
        if timer.frame == 5:  # the reference applies an impulse on spacebar
            world.apply_impulse_all((0.0, 5.0, 0.0))
        world.step(dt)
        for i, h in enumerate(handles):
            h.set_trs(world.positions[i], (0, 0, 0, 1), (1, 1, 1))
        # a handle edit does not raise the scene's instance flag (the
        # reference's behaviour), so the frames would show the first
        # frame's positions; raise it so every frame takes a motion sync
        scene._instances_changed = True

    def overlay(w):
        timer = w.get(GameTimer)
        font.draw(Section((8, 8), [Text(f"physics frame {timer.frame}", px=18)]))

    app.with_system(physics_system)
    if font is not None:
        app.with_system(overlay)
    app.camera.look_at(np.array([6, 4.5, 8], np.float32),
                       np.array([0, 1, 0], np.float32))
    app.camera.fov = 50

    import time as _time

    ms = []
    for i in range(args.frames):
        t0 = _time.perf_counter()
        frame = app.render_frame()  # sync + render + film pull
        ms.append((_time.perf_counter() - t0) * 1e3)
        write_png(f"{args.out_dir}/frame_{i:04d}.png", frame)
        print(f"frame {i} ok  {ms[-1]:.1f} ms", flush=True)
    if len(ms) > 4:
        steady = sorted(ms[4:])
        print(f"steady-state median {steady[len(steady) // 2]:.1f} ms/frame "
              f"(frames 4..{args.frames - 1})", flush=True)
    print(f"mean sync {backend.stats['sync_ms'].average():.1f} ms, mean render "
          f"{backend.stats['render_ms'].average():.1f} ms; motion syncs on the device "
          f"route: {backend._motion_syncs}", flush=True)


if __name__ == "__main__":
    main()
