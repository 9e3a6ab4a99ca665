"""Time per application of each ingredient of the shading path on the
bench scene.

Counterpart of the reference's `tools/profile_shading.py`. `profile_e2e`'s
stages nest (light + Disney re-runs the basis and the material), so the
marginal cost of each ingredient does not show there; this tool runs each
one alone, `--iters` times in a row inside one timed call (each iteration
perturbs its input, as the reference's do), on real data: the bench
scene's swizzled primaries (threefry key 3) and their hits by K1. Times
are device times by CUDA events, the least of `--reps` calls, divided by
`--iters`: ms per ONE application at R = width x height lanes.

  gather_tri_shade   the (T,32) tri_shade row gather (the basis's input)
  gather_atlas       one quad-row texel-pool gather and a channel unpack
  basis_full         `_shading_basis_c` (its two row gathers included)
  basis_math         `_shading_basis_c` on rows already gathered into lane
                     order (prim and instance = the lane), so its gathers
                     read in sequence: the math with the fetches' cost
                     taken out as far as a gather can be
  sample_light       `_sample_light_c` (the potential pick on the bench
                     lights)
  disney_eval        `disney.disney_eval_c`
  disney_pdf         `disney.disney_pdf_c`
  disney_sample      `disney.disney_sample_c` (its eval and pdf included)
  sobol3             one `sampler.sample_slot(R, 3)` draw (on the card the
                     Sobol kernel, csrc/sampler.cu)
  sobol3_plain       the same draw by `sampler.sample_slot_plain`, the
                     kernel's yardstick (eager int64 torch operations)
  frame_tolocal      `disney.build_tangent_frame_c` and two `to_local_c`

The reference's `onehot_inst` and `onehot_mat` time the TPU's one-hot MXU
fetch of instance and material rows (`RFW_ONEHOT_MAX`); the port fetches
those rows by a gather (`wavefront._fetch_rows`), so they have no
counterpart here.

    python -m rfw_tpu_torch.tools.profile_shading [--width 1920 --height 1080 --iters 8
        --reps 3] [--gltf PATH] [--device cuda|cpu]

prints one JSON line: ms per application of each stage, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import torch

from rfw_tpu_torch.tools import (
    RAY_SEED, call_ms, card_line, device_name, device_of, primary_rays,
)

STAGES = ("gather_tri_shade", "gather_atlas", "basis_full", "basis_math", "sample_light",
          "disney_eval", "disney_pdf", "disney_sample", "sobol3", "sobol3_plain",
          "frame_tolocal")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--gltf", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from rfw_tpu_torch.bench import build_scene
    from rfw_tpu_torch.ops.traverse import closest_hit, prepare_scene
    from rfw_tpu_torch.render import disney, threefry
    from rfw_tpu_torch.render.disney import v3_split
    from rfw_tpu_torch.render.sampler import sample_slot, sample_slot_plain
    from rfw_tpu_torch.render.wavefront import (
        _fetch_material_c, _inst_table, _sample_light_c, _shading_basis_c,
    )

    dev = device_of(args.device)
    W, H = args.width, args.height
    R = W * H
    IT = args.iters
    scene, mats, atlas, lights, view = build_scene(W, H, gltf=args.gltf, device=dev)
    ps = prepare_scene(scene)
    card = card_line(dev)

    o, d, pix = primary_rays(view, W, H)
    hit = closest_hit(ps, o, d)
    T = scene.tri_shade.shape[0]
    NTEX = atlas.texels.shape[0]

    ks = threefry.split(threefry.PRNGKey(RAY_SEED), 8)
    u3 = threefry.uniform(ks[0], (R, 3), device=dev)

    def unit(k, lo):
        v = lo + (1.0 - lo) * threefry.uniform(k, (R, 3), device=dev)
        return v / torch.linalg.norm(v, dim=1, keepdim=True)

    wo0, wi0 = unit(ks[1], 0.1), unit(ks[2], 0.05)
    prim0 = torch.clamp(hit.prim, min=0).long()
    if pix is None:
        pid = torch.arange(R, dtype=torch.int32, device=dev)
    else:
        pid = (pix[1] * W + pix[0]).to(torch.int32)

    # realistic MatParams: fetched once, outside the timing
    dc = v3_split(d)
    basis0 = _shading_basis_c(scene, hit, dc)
    params0 = _fetch_material_c(mats, atlas, basis0["mat_id"], basis0["uv"],
                                torch.zeros(R, device=dev), basis0["entering"], 1)[0]
    results = {}

    def timed(name, fn):
        results[name] = min(call_ms(fn, args.reps, dev)) / IT
        print(f"[{card}] {name:18s} {results[name]:9.4f} ms/app", file=sys.stderr)

    def zeros():
        return torch.zeros(R, dtype=torch.float32, device=dev)

    # ---- gathers
    def g_tri():
        acc = zeros()
        for i in range(IT):
            rows = scene.tri_shade[(prim0 + i * 9973) % T]
            acc = acc + rows[:, 0] + rows[:, 31]
        return acc

    timed("gather_tri_shade", g_tri)

    def g_atlas():
        acc = zeros()
        for i in range(IT):
            q = atlas.texels[(prim0 + i * 65537) % NTEX]
            acc = acc + (q[:, 0] & 0xFF).to(torch.float32)
        return acc

    timed("gather_atlas", g_atlas)

    # ---- the basis, whole and on rows in lane order
    def basis(sc, h, table):
        acc = zeros()
        hh = h
        for _ in range(IT):
            b = _shading_basis_c(sc, hh, dc, table)
            acc = acc + b["ns"][0] + b["uv"][0] + b["lodf"]
            hh = hh._replace(u=hh.u + 1e-6 * acc)
        return acc

    inst_table = _inst_table(scene)
    timed("basis_full", lambda: basis(scene, hit, inst_table))
    lane = torch.arange(R, dtype=torch.int32, device=dev)
    lane_scene = SimpleNamespace(tri_shade=scene.tri_shade[prim0].contiguous())
    lane_table = inst_table[torch.clamp(hit.inst, min=0).long()].contiguous()
    lane_hit = hit._replace(prim=lane, inst=lane)
    timed("basis_math", lambda: basis(lane_scene, lane_hit, lane_table))

    # ---- light sampling
    pc = v3_split(o + d * hit.t[:, None])
    nsc = basis0["ns"]

    def light():
        acc = zeros()
        uu = u3
        for _ in range(IT):
            wi, dist, rop, _, pdf_sa, z = _sample_light_c(lights, pc, uu[:, 0], uu[:, 1],
                                                          uu[:, 2], nsc)
            acc = acc + wi[0] + dist + rop[0] + pdf_sa + z
            uu = torch.abs(torch.sin(uu + acc[:, None] * 1e-9))
        return acc

    timed("sample_light", light)

    # ---- Disney
    woc, wic = v3_split(wo0), v3_split(wi0)

    def ev():
        acc = zeros()
        wc = wic
        for _ in range(IT):
            f = disney.disney_eval_c(params0, woc, wc)
            acc = acc + f[0] + f[1] + f[2]
            wc = (wc[0] + acc * 1e-12, wc[1], wc[2])
        return acc

    timed("disney_eval", ev)

    def pdf():
        acc = zeros()
        wc = wic
        for _ in range(IT):
            acc = acc + disney.disney_pdf_c(params0, woc, wc)
            wc = (wc[0] + acc * 1e-12, wc[1], wc[2])
        return acc

    timed("disney_pdf", pdf)

    def smp():
        acc = zeros()
        uu = u3
        for _ in range(IT):
            wi, f, pdf_b, _ = disney.disney_sample_c(params0, woc, uu[:, 0], uu[:, 1], uu[:, 2])
            acc = acc + wi[0] + f[0] + pdf_b
            uu = torch.abs(torch.sin(uu + acc[:, None] * 1e-9))
        return acc

    timed("disney_sample", smp)

    # ---- the sampler
    def sob(draw):
        acc = zeros()
        for i in range(IT):
            u = draw(5 + i, pid, 2 + i, 3)
            acc = acc + u[:, 0] + u[:, 1] + u[:, 2]
        return acc

    timed("sobol3", lambda: sob(sample_slot))
    timed("sobol3_plain", lambda: sob(sample_slot_plain))

    # ---- tangent frame and to_local
    def frame():
        acc = zeros()
        nc = woc
        for _ in range(IT):
            t, bt = disney.build_tangent_frame_c(nc)
            a = disney.to_local_c(t, bt, nc, woc)
            b = disney.to_local_c(t, bt, nc, wic)
            acc = acc + a[0] + b[2]
            nc = disney.v3_normalize((nc[0] + acc * 1e-12, nc[1], nc[2]))
        return acc

    timed("frame_tolocal", frame)

    out = dict(results, width=W, height=H, rays=R, iters=IT, device=device_name(dev),
               card=card, clock="cuda events" if dev.type == "cuda" else "host")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
