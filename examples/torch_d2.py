"""2D demo on rfw_tpu_torch (the counterpart of examples/d2.py): textured
and coloured 2D quads + text composited by the backend's 2D pass over a
small 3D scene. Writes a PNG per frame.

Usage: python examples/torch_d2.py [--size 640x360] [--frames 4] [--out-dir DIR]
                                   [--font PATH] [--device cpu]

Runs on the CUDA card unless `--device` names another device. The text
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
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "d2"))
    ap.add_argument("--font", default=None, help="TrueType font for the text")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host)")
    args = ap.parse_args(argv)
    W, H = (int(x) for x in args.size.split("x"))
    os.makedirs(args.out_dir, exist_ok=True)

    from rfw_tpu_torch.app import Instance
    from rfw_tpu_torch.app.timer import GameTimer
    from rfw_tpu_torch.font import FontPlugin, Section, Text
    from rfw_tpu_torch.models import quad2d, sphere
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
    from rfw_tpu_torch.scene import Material, Texture
    from rfw_tpu_torch.utils.png import write_png

    backend = TorchBackend(W, H, TorchSettings(samples_per_frame=1, max_bounces=1,
                                               sky_intensity=0.12), device=args.device)
    app = Instance(backend, W, H)
    scene = app.scene
    font = None
    if args.font:
        font = FontPlugin(args.font)
        app.with_plugin(font)
    else:
        print("no --font given: the frames carry no text", flush=True)

    # a minimal 3D backdrop so the film isn't empty
    m = scene.add_material(Material(color=np.array([0.3, 0.4, 0.6, 1], np.float32)))
    sid = scene.add_3d_object(sphere(quality=1, material_id=m))
    scene.add_3d_instance(sid)
    scene.add_point_light((2, 2, 3), (20, 20, 20))
    app.camera.look_at(np.array([0, 0, 4], np.float32), np.zeros(3, np.float32))

    # checkerboard texture for the 2D quad
    c = np.indices((64, 64)).sum(axis=0) % 2
    tex = np.stack([c * 255, 64 + c * 128, 255 - c * 200, np.full_like(c, 255)],
                   axis=-1).astype(np.uint8)
    tex_id = scene.add_texture(Texture.from_array(tex))

    # 2D meshes: one textured quad + one vertex-colored quad (pixel space)
    q1 = quad2d(center=(140, 180), size=(160, 160), texture_id=tex_id)
    q1_id = scene.add_2d_object(q1)
    scene.add_2d_instance(q1_id)

    q2 = quad2d(center=(420, 200), size=(120, 80), color=(1.0, 0.4, 0.2, 0.8))
    q2_id = scene.add_2d_object(q2)
    h2 = scene.add_2d_instance(q2_id)

    def spin(world):
        t = world.get(GameTimer).elapsed
        # rotate the colored quad about its center in pixel space
        cx, cy = 420, 200
        a = t * 1.5
        rot = np.eye(4, dtype=np.float32)
        rot[0, 0] = np.cos(a)
        rot[0, 1] = -np.sin(a)
        rot[1, 0] = np.sin(a)
        rot[1, 1] = np.cos(a)
        tr1 = np.eye(4, dtype=np.float32)
        tr1[:2, 3] = (-cx, -cy)
        tr2 = np.eye(4, dtype=np.float32)
        tr2[:2, 3] = (cx, cy)
        h2.set_matrix(tr2 @ rot @ tr1)
        if font is not None:
            font.draw(Section((16, 12), [Text("rfw-tpu 2D", px=32)]))
            font.draw(Section((16, 52), [Text(f"frame {world.get(GameTimer).frame}",
                                              px=18, color=(1, 0.8, 0.3, 1))]))

    app.with_system(spin)

    for i in range(args.frames):
        frame = app.render_frame()
        write_png(f"{args.out_dir}/frame_{i:04d}.png", frame)
        print(f"frame {i} ok  render {backend.stats['render_ms'].average():.1f} ms avg",
              flush=True)


if __name__ == "__main__":
    main()
