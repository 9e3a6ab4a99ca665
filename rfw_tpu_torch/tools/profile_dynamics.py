"""The animated demo's per-frame cost, taken apart.

Counterpart of the reference's `tools/profile_dynamics.py`: the content of
`examples/torch_animated.py` (a 12 x 12 grid of metal spheres, two skinned
CesiumMan characters, the pica interior, a sun and three spot lights)
through `rfw_tpu_torch.app.Instance` and `TorchBackend`, and each suspect
of a frame's cost timed alone on the host clock, every repetition closed
by a device synchronize:

  lights      `pack_lights` and an upload field by field, against
              `upload_lights` (two blobs)
  dyn sync    `set_time` on both characters, then `Scene.synchronize`:
              the skin and refit, including their execution on the card
              (the demo's `sync_ms` stops at the same synchronize)
  render      a warm `render_frame` on a quiescent scene
  full frame  a frame with both characters' skins dirty (what the demo
              measures)

It prints each timing's median and its repetitions, and the route the
dirty skin sync took: "device" (`TorchBackend`'s skin and refit on the
device, no repack) or "host" (a full host repack).

The characters and the interior load from `--assets DIR`
(DIR/CesiumMan/CesiumMan.gltf, DIR/pica/scene.gltf), which the repository
does not hold; `--no-pica` leaves the interior out.

    python -m rfw_tpu_torch.tools.profile_dynamics --assets DIR [--size 256x128 --reps 4]
        [--no-pica] [--device cuda|cpu]

prints one line per timing and, last, one JSON line of the medians (ms),
the route and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from rfw_tpu_torch.tools import card_line, device_name, device_of


def clock(fn, reps: int, dev: torch.device):
    """Median and per-rep wall ms of fn(), each rep closed by a device
    synchronize."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), ts


def build(W: int, H: int, assets: str, pica: bool, dev: torch.device):
    """(app, backend, (man, man2)): the demo's content through Instance and
    TorchBackend."""
    from rfw_tpu_torch.app import Instance
    from rfw_tpu_torch.mathx import compose_trs, quat_identity
    from rfw_tpu_torch.models import sphere
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
    from rfw_tpu_torch.scene import Material

    backend = TorchBackend(W, H, TorchSettings(
        samples_per_frame=1, max_bounces=1, sky_intensity=0.5, clamp=20.0), device=dev)
    app = Instance(backend, W, H)
    scene = app.scene
    metal = scene.add_material(Material(
        name="m", color=np.array([0.9, 0.6, 0.5, 1], np.float32), metallic=1.0,
        roughness=0.3))
    bid = scene.add_3d_object(sphere(quality=2, radius=0.25, material_id=metal))
    for ix in range(12):
        for iz in range(12):
            h = scene.add_3d_instance(bid)
            h.set_matrix(compose_trs(
                np.array([(ix - 6) * 0.8, 0.5, (iz - 6) * 0.8], np.float32),
                quat_identity(), np.ones(3, np.float32)))
    cesium = os.path.join(assets, "CesiumMan", "CesiumMan.gltf")
    men = []
    for x in (-2.5, 2.5):
        man = scene.add_3d(scene.load(cesium))
        man.set_root_matrix(compose_trs(np.array([x, 0, 0], np.float32), quat_identity(),
                                        np.array([1.5, 1.5, 1.5], np.float32)))
        men.append(man)
    if pica:
        room = scene.add_3d(scene.load(os.path.join(assets, "pica", "scene.gltf")))
        k = 18.0 / 64.0
        cxz = np.array([(-36.92 + 27.37) / 2, 0.0, (-32.19 + 18.17) / 2])
        room.set_root_matrix(compose_trs(
            np.array([-cxz[0] * k, 1.17 * k, -cxz[2] * k], np.float32),
            quat_identity(), np.full(3, k, np.float32)))
    scene.add_directional_light((0.35, -1.0, 0.25), (2.2, 2.1, 1.9))
    for a in (0.0, 2.1, 4.2):
        scene.add_spot_light((np.cos(a) * 5, 6, np.sin(a) * 5), (0, -1, 0),
                             (60, 56, 50), 20, 35)
    app.camera.look_at(np.array([5.5, 4.0, 7.0], np.float32),
                       np.array([0, 1.2, 0], np.float32))
    return app, backend, men


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="256x128")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--assets", required=True,
                    help="models directory holding CesiumMan/CesiumMan.gltf and "
                         "pica/scene.gltf")
    ap.add_argument("--no-pica", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    W, H = (int(v) for v in args.size.split("x"))
    dev = device_of(args.device)
    card = card_line(dev)

    from rfw_tpu_torch.render.lights_pack import DeviceLights, pack_lights, upload_lights

    app, backend, (man, man2) = build(W, H, args.assets, not args.no_pica, dev)
    scene = app.scene
    man.set_time(0.2)
    frame = app.render_frame()
    print(f"[{card}] first frame done {frame.shape}", flush=True)
    man.set_time(0.25)
    app.render_frame()
    print(f"[{card}] second frame done", flush=True)
    res = {}

    def report(key, label, m, ts, note=""):
        res[key] = m
        print(f"[{card}] {label:24s} {m:9.2f} ms   {['%.1f' % x for x in ts]}{note}",
              flush=True)

    # ---- lights upload: field by field against two blobs
    def packed():
        return pack_lights(backend._point, backend._spot, backend._directional,
                           backend._area)

    def lights_fields():
        return DeviceLights(*[torch.from_numpy(np.asarray(x)).to(dev) for x in packed()])

    report("lights_fields_ms", "lights per-field upload", *clock(lights_fields, args.reps, dev))
    report("lights_blob_ms", "lights 2-blob upload",
           *clock(lambda: upload_lights(packed(), dev), args.reps, dev))

    # ---- a dirty skin sync, its execution included; the route it takes
    routes = {"device": 0, "host": 0}
    for name, route in (("_apply_device_dynamics", "device"), ("_rebuild_scene", "host")):
        def counted(*a, _fn=getattr(backend, name), _route=route, **k):
            routes[_route] += 1
            return _fn(*a, **k)
        setattr(backend, name, counted)
    t = [0.3]

    def dyn():
        t[0] += 0.05
        man.set_time(t[0])
        man2.set_time(t[0] + 0.7)
        scene.synchronize(backend)

    m, ts = clock(dyn, args.reps, dev)
    if routes["host"] == 0 and routes["device"] == args.reps:
        mode = "device"
    elif routes["device"] == 0 and routes["host"] == args.reps:
        mode = "host"
    else:
        mode = f"mixed {routes}"
    report("dyn_sync_ms", "dirty skin sync+exec", m, ts, f" ({mode})")

    # ---- a warm frame of a quiescent scene
    report("render_quiescent_ms", "quiescent render_frame",
           *clock(app.render_frame, args.reps, dev))

    # ---- a frame with dirty skins (what the demo measures)
    def full():
        t[0] += 0.05
        man.set_time(t[0])
        man2.set_time(t[0] + 0.7)
        return app.render_frame()

    report("render_dirty_ms", "dirty-skin render_frame", *clock(full, args.reps, dev))
    out = dict(res, mode=mode, size=f"{W}x{H}", reps=args.reps, pica=not args.no_pica,
               device=device_name(dev), card=card, clock="host clock, synchronized")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
