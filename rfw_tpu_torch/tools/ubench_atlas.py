"""The cost of atlas sampling, taken apart, on the bench scene.

Counterpart of the reference's `tools/ubench_atlas.py`. The texel-pool
gather's cost depends on where its indices fall; this tool prices it on
the index stream of vertex 0's real diffuse lookups (the bench scene's
swizzled primaries, threefry key 3, their hits by K1, the basis's uvs,
mip 0) and on the same indices reordered, and prices the rest of
`atlas.sample_bilinear` beside it:

  texel_real      the quad-row gather at the real vertex-0 indices
  texel_shuf      the same indices randomly permuted (a bounce vertex's
                  worst case)
  texel_sortidx   the permuted indices sorted ascending (what a sort by
                  texel before the gather could recover)
  meta_gathers    the six per-lane metadata gathers of the per-mip tables
                  (mip_count, width0, offset, width, height, srgb)
  bilinear_full   one whole `sample_bilinear` (the diffuse map, real uvs)
  unpack_math     the RGBA unpack and bilinear lerp on a fixed quad
  sortpair        one stable `torch.sort` of an (R,) key and the gather
                  of three operands by its permutation, as the bounce
                  sort (`wavefront._sort_state`) does: what a sort by
                  texel would cost

Each stage runs `--iters` times in one timed call (each iteration moves
its input, as the reference's do); times are device times by CUDA
events, the least of `--reps` calls, divided by `--iters`: ms per ONE
application at R = width x height lanes.

    python -m rfw_tpu_torch.tools.ubench_atlas [--width 1920 --height 1080 --iters 8
        --reps 3] [--gltf PATH] [--device cuda|cpu]

prints one JSON line: ms per application of each stage, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rfw_tpu_torch.tools import call_ms, card_line, device_name, device_of, primary_rays

STAGES = ("texel_real", "texel_shuf", "texel_sortidx", "meta_gathers", "bilinear_full",
          "unpack_math", "sortpair")


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
    from rfw_tpu_torch.render.atlas import _unpack_rgba, sample_bilinear
    from rfw_tpu_torch.render.disney import v3_split
    from rfw_tpu_torch.render.wavefront import _shading_basis_c

    dev = device_of(args.device)
    W, H = args.width, args.height
    R = W * H
    IT = args.iters
    scene, mats, atlas, lights, view = build_scene(W, H, gltf=args.gltf, device=dev)
    ps = prepare_scene(scene)
    card = card_line(dev)

    o, d, _ = primary_rays(view, W, H)
    hit = closest_hit(ps, o, d)
    basis = _shading_basis_c(scene, hit, v3_split(d))
    NTEX = atlas.texels.shape[0]

    # the real diffuse-map state at vertex 0
    mat_id = basis["mat_id"].long()
    tex0 = torch.round(mats.tex.to(torch.float32)[mat_id][:, 0]).to(torch.int32)
    uv_u, uv_v = basis["uv"]
    lod = torch.zeros(R, dtype=torch.float32, device=dev)

    # the texel index stream sample_bilinear gathers (mip 0)
    t = torch.clamp(tex0, min=0).long()
    off = atlas.offset[t, 0]
    w_ = atlas.width[t, 0]
    h_ = atlas.height[t, 0]
    u_w = uv_u - torch.floor(uv_u)
    v_w = uv_v - torch.floor(uv_v)
    xi = torch.remainder(torch.floor(u_w * w_.to(torch.float32) - 0.5).to(torch.int32), w_)
    yi = torch.remainder(torch.floor(v_w * h_.to(torch.float32) - 0.5).to(torch.int32), h_)
    idx_real = (off + yi * w_ + xi).contiguous()
    perm = torch.from_numpy(np.random.default_rng(0).permutation(R)).to(dev)
    idx_shuf = idx_real[perm].contiguous()
    idx_sorted = torch.sort(idx_shuf).values.contiguous()
    results = {}

    def timed(name, fn):
        results[name] = min(call_ms(fn, args.reps, dev)) / IT
        print(f"[{card}] {name:16s} {results[name]:9.4f} ms/app", file=sys.stderr)

    def zeros():
        return torch.zeros(R, dtype=torch.float32, device=dev)

    def g_quad(idx):
        acc = zeros()
        for i in range(IT):
            # nudged one row an iteration: locality kept
            q = atlas.texels[((idx + i) % NTEX).long()]
            acc = acc + (q[:, 0] & 0xFF).to(torch.float32)
        return acc

    timed("texel_real", lambda: g_quad(idx_real))
    timed("texel_shuf", lambda: g_quad(idx_shuf))
    timed("texel_sortidx", lambda: g_quad(idx_sorted))

    n_tex = atlas.mip_count.shape[0]

    def meta():
        acc = zeros()
        for i in range(IT):
            ti = (t + i) % n_tex
            acc = (acc + atlas.mip_count[ti].to(torch.float32)
                   + atlas.width[ti, 0].to(torch.float32)
                   + atlas.offset[ti, 1].to(torch.float32)
                   + atlas.width[ti, 1].to(torch.float32)
                   + atlas.height[ti, 1].to(torch.float32)
                   + atlas.srgb[ti].to(torch.float32))
        return acc

    timed("meta_gathers", meta)

    def bil():
        acc = zeros()
        u_cur = uv_u
        for _ in range(IT):
            c = sample_bilinear(atlas, tex0, (u_cur, uv_v), lod)
            acc = acc + c[:, 0] + c[:, 2]
            u_cur = u_cur + 1e-4
        return acc

    timed("bilinear_full", bil)

    quad0 = atlas.texels[idx_real.long()]
    fx, fy = uv_u[:, None], uv_v[:, None]

    def unpack():
        acc = zeros()
        qq = quad0
        for _ in range(IT):
            c00, c10 = _unpack_rgba(qq[:, 0]), _unpack_rgba(qq[:, 1])
            c01, c11 = _unpack_rgba(qq[:, 2]), _unpack_rgba(qq[:, 3])
            c = (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy
            acc = acc + c[:, 0] + c[:, 3]
            qq = qq + 1
        return acc

    timed("unpack_math", unpack)

    def sortpair():
        acc = zeros()
        kk = idx_shuf
        for _ in range(IT):
            p = torch.sort(kk, stable=True).indices
            k_s, u_s, _, l_s = kk[p], uv_u[p], uv_v[p], lod[p]
            acc = acc + u_s + l_s
            kk = kk + k_s % 7
        return acc

    timed("sortpair", sortpair)

    out = dict(results, width=W, height=H, rays=R, iters=IT, device=device_name(dev),
               card=card, clock="cuda events" if dev.type == "cuda" else "host")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
