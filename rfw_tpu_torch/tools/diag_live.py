"""Live-lane shares after each bounce on the bench scene, and the split of
the material and atlas fetch.

Counterpart of the reference's `tools/diag_live.py`:

  * `live_b1`: the share of primaries that hit (the lanes alive at the
    bounce vertex), by K1 on the coherent primaries;
  * `live_b2`: the share of bounce-like rays from those hits that hit
    again (an upper bound on the lanes alive at a second bounce), by K1
    with the dead lanes' limit 0;
  * the fetch, each timed alone by CUDA events (the least of `--reps`):
    `mat_block` (one row gather of the material table), `one_bilinear` and
    `two_bilinear` (atlas fetches at synthetic uv), and `mat_real_m5` /
    `mat_real_m15` (the shading basis and `_fetch_material_c` at the real
    hits with texture masks 5 and 15).

    python -m rfw_tpu_torch.tools.diag_live [--width 1920 --height 1080 --reps 3]
        [--gltf PATH] [--device cuda|cpu]

prints one JSON line: the live shares, ms per fetch, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rfw_tpu_torch.tools import (
    bounce_rays, call_ms, card_line, device_name, device_of, primary_rays,
)


def live_shares(ps, o, d):
    """(live_b1, live_b2, first hits): the primaries' hit share, and the
    hit share of the bounce-like rays from their hits."""
    from rfw_tpu_torch.ops.traverse import closest_hit

    hit0 = closest_hit(ps, o, d)
    o2, d2 = bounce_rays(o, d, hit0)
    tl = torch.where(hit0.prim >= 0, 1e30, 0.0)
    hit1 = closest_hit(ps, o2, d2, tl)
    return ((hit0.prim >= 0).float().mean().item(), (hit1.prim >= 0).float().mean().item(),
            hit0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--gltf", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from rfw_tpu_torch.bench import build_scene
    from rfw_tpu_torch.ops.traverse import prepare_scene
    from rfw_tpu_torch.render.atlas import sample_bilinear
    from rfw_tpu_torch.render.disney import v3_split
    from rfw_tpu_torch.render.wavefront import (
        _fetch_material_c, _fetch_rows, _shading_basis_c, tex_kinds_mask,
    )

    dev = device_of(args.device)
    W, H = args.width, args.height
    R = W * H
    scene, mats, atlas, _, view = build_scene(W, H, gltf=args.gltf, device=dev)
    ps = prepare_scene(scene)
    card = card_line(dev)
    print(f"[{card}] tex_mask = {tex_kinds_mask(mats.tex)}, n_mats = {mats.color.shape[0]}, "
          f"atlas texels = {tuple(atlas.texels.shape)}", file=sys.stderr)
    o, d, _ = primary_rays(view, W, H)
    live1, live2, hit0 = live_shares(ps, o, d)
    print(f"[{card}] primary hit share (live at bounce 1): {live1:.4f}; bounce-1 hit share "
          f"(live at bounce 2, an upper bound): {live2:.4f}", file=sys.stderr)
    results = {"live_b1": live1, "live_b2": live2}

    def timed(name, fn):
        results[name] = min(call_ms(fn, args.reps, dev))
        print(f"[{card}] {name:18s} {results[name]:9.4f} ms", file=sys.stderr)

    mat_id = scene.tri_mat[torch.clamp(hit0.prim, min=0).long()]
    uv = torch.stack([o[:, 0].abs() % 1.0, o[:, 1].abs() % 1.0], 1)
    lod = torch.zeros(R, device=dev)
    blk_tbl = torch.cat([mats.color, mats.params, mats.absorption[:, :3]], dim=1)
    tex = mats.tex[mat_id.long()]
    timed("mat_block", lambda: _fetch_rows(blk_tbl, mat_id))
    timed("one_bilinear", lambda: sample_bilinear(atlas, tex[:, 0], uv, lod))
    timed("two_bilinear", lambda: sample_bilinear(atlas, tex[:, 0], uv, lod)
          + sample_bilinear(atlas, tex[:, 1], uv, lod))

    def mat_real(tex_mask):
        def fetch():
            basis = _shading_basis_c(scene, hit0, v3_split(d))
            lodr = torch.log2(torch.clamp(hit0.t * view[16] * basis["lodf"] * 1024.0,
                                          min=1e-6))
            return _fetch_material_c(mats, atlas, basis["mat_id"], basis["uv"], lodr,
                                     basis["entering"], tex_mask)[0].base_color
        return fetch

    timed("mat_real_m5", mat_real(5))
    timed("mat_real_m15", mat_real(15))
    out = dict(results, width=W, height=H, device=device_name(dev), card=card,
               clock="cuda events" if dev.type == "cuda" else "host")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
