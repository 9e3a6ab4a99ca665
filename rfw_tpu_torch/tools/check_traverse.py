"""Traversal correctness gate: K1/K2 on a subsample of the bench scene's
primary rays against a brute-force oracle and against their plain walks.

Counterpart of the reference's `tools/check_traverse.py`, the gate a
traversal-kernel change passes on the card before it lands. On
`--oracle-rays` primaries spread evenly over the frame:

  * K1 (`ops.traverse.closest_hit`) against `render.intersect.
    brute_force_closest` over every instanced triangle in world space
    (run in chunks of rays, so 4,096 rays x the flagship's 122,880
    triangles fit in memory): hit masks differ on at most max(1, n/2048)
    rays and t within 1e-3 relative where both hit (the reference's gate:
    the oracle's Moller-Trumbore test rounds otherwise than the kernel's
    Woop test);
  * K1 against its plain walk (`closest_hit_plain`) under K1's
    nearest-first gate: hit masks identical, t bit-identical but for at
    most 1 in 10^5 rays within 1e-5 relative, prim/inst/u/v bit-identical
    but where the plain walk's t ties exactly (counted);
  * K2 (`occluded`) at limits of 1.5 x K1's t (8 on a miss) against the
    flags K1's t implies, rays within 1e-3 relative of their limit left out
    (at most max(1, R/10^5) may differ), and against its plain walk
    (identical flags).

On the CPU the wrappers run the plain walks, so the second and fourth
checks hold trivially. Exits nonzero when a check fails.

    python -m rfw_tpu_torch.tools.check_traverse [--width 512 --height 256]
        [--oracle-rays 4096] [--gltf PATH] [--device cuda|cpu]

prints one JSON line of the counts, `ok`, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rfw_tpu_torch.tools import card_line, device_name, device_of, primary_rays

#: the reference tool's ray key (`check_traverse.py:47`)
CHECK_SEED = 7
#: rays per brute-force call
ORACLE_CHUNK = 512


def world_triangles(scene):
    """World-space (v0, e1, e2) of every instanced triangle of a
    TraceScene of tensors."""
    v0s, e1s, e2s = [], [], []
    for i in range(scene.inst_matrix.shape[0]):
        mesh = int(scene.inst_mesh[i])
        if mesh < 0:
            continue
        m = scene.inst_matrix[i]
        sel = scene.tri_mesh == mesh
        v0s.append(scene.tri_v0[sel] @ m[:3, :3].T + m[:3, 3])
        e1s.append(scene.tri_e1[sel] @ m[:3, :3].T)
        e2s.append(scene.tri_e2[sel] @ m[:3, :3].T)
    return torch.cat(v0s), torch.cat(e1s), torch.cat(e2s)


def oracle(o, d, tris):
    """brute_force_closest's (t, prim) in chunks of ORACLE_CHUNK rays."""
    from rfw_tpu_torch.render.intersect import brute_force_closest

    out = [brute_force_closest(o[s:s + ORACLE_CHUNK], d[s:s + ORACLE_CHUNK], *tris)[:2]
           for s in range(0, o.shape[0], ORACLE_CHUNK)]
    return torch.cat([t for t, _ in out]), torch.cat([p for _, p in out])


def nearest_gate(kh, ph, live=None):
    """K1's nearest-first gate of a walk's hits `kh` (K1, K3) against the
    plain walk's `ph`, which `chip_smoke.py::check_nearest` also applies:
    hit masks identical; t bit-identical where both hit but for at most 1
    in 10^5 rows (all rows, or those of the mask `live`), each within 1e-5
    relative; prim, inst, u and v bit-identical but on an exact-t tie
    (another triangle at the plain walk's t, bit for bit), counted; misses
    identical in every output. Returns (counts and `ok`, the mask of rows
    whose t differs)."""
    bits = lambda x: x.view(torch.int32)  # noqa: E731
    km, pm = kh.prim >= 0, ph.prim >= 0
    both = km & pm
    same_t = bits(kh.t) == bits(ph.t)
    diff = both & ~same_t
    same_id = (kh.prim == ph.prim) & (kh.inst == ph.inst)
    same_uv = (bits(kh.u) == bits(ph.u)) & (bits(kh.v) == bits(ph.v))
    rel = ((kh.t - ph.t).abs() / ph.t.abs().clamp(min=1e-30))[diff]
    out = dict(rows=kh.t.numel() if live is None else int(live.sum()),
               masks_identical=bool(torch.equal(km, pm)), hits=int(both.sum()),
               t_differ=int(diff.sum()),
               t_differ_max_rel=rel.max().item() if rel.numel() else 0.0,
               t_err_max=(kh.t - ph.t).abs()[both].max().item() if both.any() else 0.0,
               exact_t_ties=int((both & same_t & ~same_id).sum()),
               uv_differ=int((both & same_t & same_id & ~same_uv).sum()),
               misses_differ=int((~km & ~pm & ~(same_t & same_id & same_uv)).sum()),
               identical=all(torch.equal(a, b) for a, b in zip(kh, ph)))
    out["ok"] = (out["masks_identical"] and out["t_differ"] <= out["rows"] // 100000
                 and out["t_differ_max_rel"] <= 1e-5 and out["uv_differ"] == 0
                 and out["misses_differ"] == 0)
    return out, diff


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--oracle-rays", type=int, default=4096)
    ap.add_argument("--gltf", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from rfw_tpu_torch.bench import build_scene
    from rfw_tpu_torch.ops.traverse import (
        closest_hit, closest_hit_plain, occluded, occluded_plain, prepare_scene,
    )

    dev = device_of(args.device)
    W, H = args.width, args.height
    R = W * H
    parts = build_scene(W, H, gltf=args.gltf, device=dev)
    scene = parts[0]
    ps = prepare_scene(scene)
    card = card_line(dev)
    o, d, _ = primary_rays(parts[4], W, H, CHECK_SEED)
    hit = closest_hit(ps, o, d)

    n_sub = min(args.oracle_rays, R)
    sub = torch.linspace(0, R - 1, n_sub, dtype=torch.float64, device=dev).long()
    t_ref, p_ref = oracle(o[sub], d[sub], world_triangles(scene))
    mask, ref_mask = hit.prim[sub] >= 0, p_ref >= 0
    mm = int((mask != ref_mask).sum())
    both = mask & ref_mask
    terr = (hit.t[sub][both] - t_ref[both]).abs() / t_ref[both].abs().clamp(min=1e-6)
    t_err = terr.max().item() if terr.numel() else 0.0
    res = dict(oracle_rays=n_sub, oracle_mask_mismatch=mm, oracle_t_rel_err_max=t_err,
               oracle_ok=mm <= max(1, n_sub // 2048) and t_err < 1e-3)
    print(f"[{card}] oracle rays {n_sub}: mask mismatches {mm}/{n_sub}, rel t err max "
          f"{t_err:.2e}", file=sys.stderr)

    plain = closest_hit_plain(ps, o[sub].contiguous(), d[sub].contiguous())
    gate, _ = nearest_gate(type(hit)(*[a[sub] for a in hit]), plain)
    res.update({f"k1_vs_plain_{k}": v for k, v in gate.items()})
    print(f"[{card}] K1 vs plain walk on the subsample: {gate}", file=sys.stderr)

    tlim = torch.where(hit.t < 1e20, hit.t * 1.5, 8.0)
    occ = occluded(ps, o, d, tlim)
    near_tie = (hit.t - tlim).abs() < 1e-3 * torch.clamp(hit.t, min=1.0)
    omm = int(((occ != (hit.t < tlim)) & ~near_tie).sum())
    occ_plain = occluded_plain(ps, o[sub].contiguous(), d[sub].contiguous(), tlim[sub])
    res.update(occluded_mismatch=omm, occluded_rays=R - int(near_tie.sum()),
               k2_vs_plain_identical=bool(torch.equal(occ[sub], occ_plain)))
    print(f"[{card}] any hit: occluded mismatches {omm}/{res['occluded_rays']}, K2 vs plain "
          f"walk identical {res['k2_vs_plain_identical']}", file=sys.stderr)
    res["ok"] = bool(res["oracle_ok"] and gate["ok"] and omm <= max(1, R // 100000)
                     and res["k2_vs_plain_identical"])
    out = dict(res, width=W, height=H, device=device_name(dev), card=card)
    print(json.dumps(out), flush=True)
    print("PASS" if res["ok"] else "FAIL", file=sys.stderr)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
