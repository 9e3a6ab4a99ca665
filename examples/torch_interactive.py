"""Interactive fly-through in a browser window, on rfw_tpu_torch (the
counterpart of examples/interactive.py).

`BrowserWindow` streams frames to any browser over HTTP and mirrors its
key/mouse events into the winit event mirror, `Instance.run_windowed` is
the poll loop, and a camera controller system reads `KeyState`/
`MouseState` as the reference examples read `Input<VirtualKeyCode>`.

Controls: WASD move, QE down/up, arrow keys look, drag to look,
scroll to change speed, Escape to quit.

Usage:
  python examples/torch_interactive.py [--size 384x216] [--spp 1] [--cpu]
                                       [--port 8787] [--frames N] [--no-pica]
                                       [--assets DIR] [--device cpu]

Renders on the CUDA card through TorchBackend unless `--device` names
another device; `--cpu` takes the numpy oracle backend instead. The pica
interior loads from `--assets DIR` (DIR/pica/scene.gltf); without it, or
with `--no-pica`, the scene is the spheres alone.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="384x216")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--bounces", type=int, default=1)
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--cpu", action="store_true",
                    help="use the numpy oracle backend (no torch render)")
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: until tab closes)")
    ap.add_argument("--no-pica", action="store_true",
                    help="spheres only (fast enough for the CPU oracle)")
    ap.add_argument("--assets", default=None,
                    help="models directory holding pica/scene.gltf")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host)")
    args = ap.parse_args(argv)
    W, H = (int(x) for x in args.size.split("x"))

    from rfw_tpu_torch.app import Instance, Stage
    from rfw_tpu_torch.app.window import (
        BrowserWindow, KeyState, MouseButton, MouseState, MouseWheel,
        VirtualKeyCode as K, WindowData, WindowEvents,
    )
    from rfw_tpu_torch.mathx import compose_trs, quat_identity
    from rfw_tpu_torch.models import sphere
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
    from rfw_tpu_torch.scene import Material
    from rfw_tpu_torch.scene.camera import Camera3D

    window = BrowserWindow(W, H, port=args.port)
    settings = TorchSettings(samples_per_frame=args.spp, max_bounces=args.bounces,
                             sky_intensity=0.6, clamp=20.0)
    # the backend is constructed FROM the window handle
    if args.cpu:
        from rfw_tpu_torch.render.cpu_reference import CpuReferenceBackend

        backend = CpuReferenceBackend.from_window_handle(window, settings=settings)
    else:
        backend = TorchBackend.from_window_handle(window, settings=settings,
                                                  device=args.device)
    app = Instance(backend, W, H)
    scene = app.scene

    # ---- content: metal spheres over the pica interior --------------------
    metal = scene.add_material(Material(
        name="metal", color=np.array([0.95, 0.64, 0.54, 1], np.float32),
        metallic=1.0, roughness=0.2))
    ball = sphere(quality=2, radius=0.3, material_id=metal)
    bid = scene.add_3d_object(ball)
    for ix in range(4):
        for iz in range(4):
            h = scene.add_3d_instance(bid)
            h.set_matrix(compose_trs(
                np.array([(ix - 1.5) * 1.2, 0.6, (iz - 1.5) * 1.2],
                         np.float32),
                quat_identity(), np.ones(3, np.float32)))
    try:
        if args.no_pica:
            raise RuntimeError("--no-pica")
        if args.assets is None:
            raise RuntimeError("no --assets DIR")
        pica = scene.add_3d(scene.load(os.path.join(args.assets, "pica", "scene.gltf")))
        k = 18.0 / 64.0
        cxz = np.array([(-36.92 + 27.37) / 2, 0.0, (-32.19 + 18.17) / 2])
        pica.set_root_matrix(compose_trs(
            np.array([-cxz[0] * k, 1.17 * k, -cxz[2] * k], np.float32),
            quat_identity(), np.full(3, k, np.float32)))
    except Exception as e:  # noqa: BLE001 — demo still works without assets
        print(f"pica unavailable ({e}); spheres only")
    scene.add_directional_light((0.35, -1.0, 0.25), (2.2, 2.1, 1.9))

    cam: Camera3D = app.camera
    cam.look_at(np.array([4.5, 3.0, 6.0], np.float32),
                np.array([0, 1.0, 0], np.float32))

    # ---- the controller: Input<VirtualKeyCode> consumer -------------------
    state = {"yaw": None, "pitch": None, "speed": 3.0, "last": time.time(),
             "mouse": None, "frames": 0, "t0": time.time()}

    def _angles():
        d = cam.direction
        state["yaw"] = float(np.arctan2(d[0], -d[2]))
        state["pitch"] = float(np.arcsin(np.clip(d[1], -1, 1)))

    _angles()

    def controller(world):
        keys: KeyState = world.get(KeyState)
        mouse: MouseState = world.get(MouseState)
        data: WindowData = world.get(WindowData)
        now = time.time()
        dt = min(now - state["last"], 0.1)
        state["last"] = now

        for ev in world.get(WindowEvents).iter():
            if isinstance(ev, MouseWheel):
                state["speed"] = float(np.clip(
                    state["speed"] * (0.9 if ev.delta_y > 0 else 1.12),
                    0.2, 50.0))

        look = 1.6 * dt
        if keys.pressed(K.Left):
            state["yaw"] -= look
        if keys.pressed(K.Right):
            state["yaw"] += look
        if keys.pressed(K.Up):
            state["pitch"] += look
        if keys.pressed(K.Down):
            state["pitch"] -= look
        if mouse.pressed(MouseButton.LEFT):
            if state["mouse"] is not None:
                mx, my = state["mouse"]
                state["yaw"] += (data.mouse_position[0] - mx) * 0.008
                state["pitch"] -= (data.mouse_position[1] - my) * 0.008
            state["mouse"] = data.mouse_position
        else:
            state["mouse"] = None
        state["pitch"] = float(np.clip(state["pitch"], -1.5, 1.5))

        cy, sy = np.cos(state["yaw"]), np.sin(state["yaw"])
        cp, sp = np.cos(state["pitch"]), np.sin(state["pitch"])
        fwd = np.array([sy * cp, sp, -cy * cp], np.float32)
        right = np.array([cy, 0, sy], np.float32)
        v = state["speed"] * dt
        pos = cam.position.astype(np.float32)
        if keys.pressed(K.W):
            pos += fwd * v
        if keys.pressed(K.S):
            pos -= fwd * v
        if keys.pressed(K.D):
            pos += right * v
        if keys.pressed(K.A):
            pos -= right * v
        if keys.pressed(K.E):
            pos[1] += v
        if keys.pressed(K.Q):
            pos[1] -= v
        cam.position = pos
        cam.direction = fwd

        if keys.just_pressed(K.Escape):
            window._push({"t": "close"})
        state["frames"] += 1
        if state["frames"] % 30 == 0:
            fps = state["frames"] / (time.time() - state["t0"])
            print(f"{state['frames']} frames, {fps:.1f} fps avg")

    app.with_system(controller, Stage.UPDATE)

    print(f"open {window.url} — WASD/QE move, arrows or drag to look, "
          f"wheel = speed, Esc quits")
    n = app.run_windowed(window, max_frames=args.frames)
    print(f"presented {n} frames in {time.time() - state['t0']:.2f} s", flush=True)


if __name__ == "__main__":
    main()
