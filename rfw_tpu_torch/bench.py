"""The port's benchmark entry point, the counterpart of the reference's
`bench.py`: Mrays/s of a 1080p 1-bounce + NEE path trace on one card.

    python -m rfw_tpu_torch.bench [--width 1920 --height 1080 --spp 8 --bounces 1]
        [--save PATH] [--no-sort] [--gltf PATH] [--device cuda|cpu]
        [--two-phase auto|on|off] [--repeats 1]

prints one JSON line with `bench.py`'s four keys (`metric`, `value`,
`unit`, `vs_baseline`) and the port's own: `ms_per_sample` (the median
over the repeats; with more than two, `ms_per_sample_quartiles`),
`ms_per_sample_all`, `repeats`, `spp`, `scene`, `two_phase`, `device`,
`card` (name and power limit), `peak_mem_mb`, `setup_s`,
`launches_per_sample` (each kernel's launches over the timed loops a
sample, by launch kind; none on the CPU, where the plain versions run)
and, of the last loop's film, `film_mean` (mean radiance) and
`film_finite`.

The scene: with `--gltf PATH`, the glTF packed as `bench.py:34-101`
packs pica (node walk, two spots and a sun from the TLAS bounds, the
55-degree camera); without it, the flagship-scale procedural scene of
`rfw_tpu_torch.scenes.build_scene(7)` (pica is not in the
repository) with the same lights' placement and camera. The config is
`bench.py:127-134`'s: clamp 20, sky 0.35, the Sobol sampler, aovs off,
the texture and lobe masks from the scene. One warm-up sample, then
`--spp` timed samples (sample index s + 1, key fold_in(11, s + 1)) into
a fresh film, the clock stopped after a device synchronize; `--repeats`
repeats the timed loop in one process. Rays are counted as `bench.py`
counts them: closest + shadow at each of the bounces + 1 path vertices,
W*H*spp*2*(bounces+1). `value` is rays per sample over the median ms per
sample. `vs_baseline` is null: the reference's 500 Mrays/s is a target
set for a TPU, not a figure of this card.

`--two-phase` is the counterpart of the reference's RFW_TWO_PHASE for
this entry point: "off" traces every ray with the classic kernel (K1/K2),
"on" the bounce rays' closest hits through the two-phase path (K3 and a
K1 retrace), and "auto" (the default, as in `bench.py`) takes the
two-phase path on the CPU and the classic kernel on the card, where it is
the faster route, so there "auto" and "off" run the same program.
Without `--device cpu` it runs on the card and raises where there is
none; on the CPU the plain versions run and the numbers are host-clock
times of the CPU, not of a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

#: the seed of the procedural flagship scene (`chip_smoke.py`'s)
DEFAULT_SEED = 7
#: the reference's key (`bench.py:135`)
KEY_SEED = 11


def build_scene(width: int, height: int, *, gltf=None, seed: int = DEFAULT_SEED,
                device="cuda"):
    """(scene, mats, atlas, lights, view) as tensors on `device`, the tuple
    `bench.py:34` returns: TraceScene, DeviceMaterials, TextureAtlas,
    DeviceLights and the (24,) camera vector for width x height. With
    `gltf`, that glTF packed as `bench.py` packs pica; without it, the
    procedural flagship scene of `scenes.build_scene(seed)`."""
    from rfw_tpu_torch.convert import materials_to_device, scene_to_device
    from rfw_tpu_torch.render.atlas import atlas_to_device
    from rfw_tpu_torch.render.lights_pack import upload_lights

    if gltf is None:
        from rfw_tpu_torch.scenes import build_scene as flagship

        scene, dmats, dl, atlas, cam, _ = flagship(seed)
    else:
        scene, dmats, dl, atlas, cam = _gltf_scene(gltf)
    view = torch.from_numpy(cam.get_view(width, height).as_array()).to(device)
    return (scene_to_device(scene, device), materials_to_device(dmats, device),
            atlas_to_device(atlas, device), upload_lights(dl, device), view)


def _gltf_scene(path):
    """`bench.py:34-101` on the host: (TraceScene, DeviceMaterials,
    DeviceLights, TextureAtlas, Camera3D) of a glTF file."""
    from rfw_tpu_torch.backend.lights import AreaLightsView, PointLightsView
    from rfw_tpu_torch.loaders.gltf import GltfLoader
    from rfw_tpu_torch.mathx import compose_trs
    from rfw_tpu_torch.render.atlas import pack_atlas
    from rfw_tpu_torch.render.lights_pack import pack_lights
    from rfw_tpu_torch.render.pack import pack_trace_scene
    from rfw_tpu_torch.scene.materials import Materials
    from rfw_tpu_torch.scenes import bench_camera, bench_lights

    mats = Materials()
    sd = GltfLoader().load(str(path), mats)
    world = {}

    def walk(idx, parent):
        nd = sd.nodes[idx]
        local = nd.matrix if nd.matrix is not None else compose_trs(
            nd.translation, nd.rotation, nd.scale)
        m = parent @ local
        for mid in nd.mesh_ids:
            world.setdefault(mid, []).append(m)
        for c in nd.children:
            walk(c, m)

    for r in sd.roots:
        walk(r, np.eye(4, dtype=np.float32))
    meshes = [(i, m, None) for i, m in enumerate(sd.meshes)]
    instances = [(i, np.stack(ms)) for i, ms in world.items()]
    scene = pack_trace_scene(meshes, instances)
    spot, sun = bench_lights(scene)
    dl = pack_lights(PointLightsView.empty(), spot, sun, AreaLightsView.empty())
    atlas = pack_atlas([t for _, t in mats.textures])
    return scene, mats.to_device(), dl, atlas, bench_camera(scene)


def bench_config(mats, lights, bounces: int = 1, sort: bool = True, two_phase: str = "auto"):
    """`bench.py:127-134`'s RenderConfig for a scene's materials and
    lights (tensors or host arrays)."""
    from rfw_tpu_torch.render.wavefront import RenderConfig, mat_feature_mask, tex_kinds_mask

    n_area = lights.n_area[0]
    return RenderConfig(max_bounces=bounces, clamp=20.0, sky_intensity=0.35,
                        sort_secondary=sort, sampler="sobol",
                        tex_mask=tex_kinds_mask(mats.tex), mat_features=mat_feature_mask(mats),
                        has_area_lights=bool(n_area > 0), aovs=False, two_phase=two_phase)


def sample(parts, width: int, height: int, cfg, s: int):
    """Sample s of the bench's sequence: sample_index s, key fold_in(11, s)."""
    from rfw_tpu_torch.render import threefry
    from rfw_tpu_torch.render.wavefront import render_sample

    scene, mats, atlas, lights, view = parts
    key = threefry.fold_in(threefry.PRNGKey(KEY_SEED), s)
    return render_sample(scene, mats, atlas, lights, view, width, height, cfg,
                         sample_index=s, key=key)


def sample_loop(parts, width: int, height: int, cfg, spp: int):
    """The timed loop: samples 1..spp added into a fresh film. Returns
    (film, seconds), the clock stopped after a device synchronize."""
    from rfw_tpu_torch.render.film import add_sample, new_film

    dev = parts[4].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    film = new_film(width, height, device=dev)
    sync()
    t0 = time.perf_counter()
    for s in range(spp):
        add_sample(film, sample(parts, width, height, cfg, s + 1).radiance)
    sync()
    return film, time.perf_counter() - t0


def launch_counts() -> dict:
    """The kernels' launch counters, by launch kind (ops.traverse,
    ops.traverse_items, ops.traverse_entries)."""
    from rfw_tpu_torch.ops import traverse, traverse_entries, traverse_items

    return {k: n for m in (traverse, traverse_items, traverse_entries)
            for k, n in m.LAUNCHES.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=8, help="timed samples")
    ap.add_argument("--bounces", type=int, default=1)
    ap.add_argument("--save", default=None, help="optional PNG output")
    ap.add_argument("--no-sort", dest="sort", action="store_false",
                    help="disable secondary-ray sorting (default: on)")
    ap.add_argument("--gltf", default=None,
                    help="glTF scene (e.g. pica's scene.gltf); default: the procedural "
                         "flagship scene")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--two-phase", default="auto", choices=("auto", "on", "off"))
    ap.add_argument("--repeats", type=int, default=1,
                    help="timed loops in this process; the line reports their median")
    args = ap.parse_args(argv)
    if args.spp < 1 or args.repeats < 1:
        ap.error("--spp and --repeats must be at least 1")

    from rfw_tpu_torch.render.film import frame_to_host, tonemap
    from rfw_tpu_torch.tools import card_line, device_name, device_of

    dev = device_of(args.device)
    W, H = args.width, args.height
    t0 = time.perf_counter()
    parts = build_scene(W, H, gltf=args.gltf, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    cfg = bench_config(parts[1], parts[3], args.bounces, args.sort, args.two_phase)

    # warm-up: builds the kernels at their first use
    sample(parts, W, H, cfg, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    before = launch_counts()
    for _ in range(args.repeats):
        film, dt = sample_loop(parts, W, H, cfg, args.spp)
        ms.append(dt / args.spp * 1e3)
    launches = {k: (n - before[k]) / (args.spp * args.repeats)
                for k, n in launch_counts().items() if n > before[k]}
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None
    film_mean = float(film.mean()) / args.spp

    rays_per_sample = W * H * 2 * (args.bounces + 1)
    med = float(np.median(ms))
    mrays = rays_per_sample / (med * 1e-3) / 1e6
    scene_name = args.gltf or f"procedural flagship seed {DEFAULT_SEED}"
    if args.save:
        from rfw_tpu_torch.utils.png import write_png

        write_png(args.save, frame_to_host(tonemap(film, args.spp, W, H)))
    per = "chip" if dev.type == "cuda" else "host CPU"
    result = {
        "metric": f"Mrays/sec/{per} ({W}x{H}, {args.bounces}-bounce+NEE, {scene_name})",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": None,
        "ms_per_sample": med,
        "ms_per_sample_all": ms,
        "repeats": args.repeats,
        "spp": args.spp,
        "scene": scene_name,
        "two_phase": args.two_phase,
        "device": device_name(dev),
        "card": card_line(dev),
        "peak_mem_mb": peak,
        "setup_s": setup_s,
        "launches_per_sample": launches,
        "film_mean": film_mean,
        "film_finite": bool(torch.isfinite(film).all()),
    }
    if args.repeats > 2:
        result["ms_per_sample_quartiles"] = [float(q) for q in np.percentile(ms, [25, 75])]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
