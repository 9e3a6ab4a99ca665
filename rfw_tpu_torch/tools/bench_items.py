"""The two-phase closest hit against K1 on the same bounce rays.

Counterpart of the reference's `tools/bench_items.py`: on the bench
scene's bounce-like rays (`--case sorted`, the integrator's bounce order,
by default; `coherent` or `unsorted` as `bench_traverse` makes them), times
the classic kernel K1 (`ops.traverse.closest_hit`) against the public
two-phase call (`ops.pallas_twophase_closest_hit`: phase A by the TLAS
walk K4, the items sorted by instance, phase B by K3, the per-ray min-t
merge; truncated rays are not retraced) and counts their disagreements on
the rays it does not mark truncated: hit masks that differ, and t more
than 1e-3 apart where both hit.

  --fused       times the integrator's calls instead:
                `twophase_closest_fused` (phase A as the integrator picks
                it, no retrace) and `twophase_closest_with_fallback` (with
                K1 retracing truncated rays), the second checked against
                K1 on every ray;
  --breakdown   also times the stages alone: phase A by the reference
                walk (`render.twophase.tlas_entries`), the compaction and
                instance sort, and phase B (K3); with
  --pallas-A    also phase A by K4, with the rays whose entry sets differ
                from the reference walk's counted.

The reference's breakdown sizes its stages by TPU tile constants
(CHUNK_TILES, SUB, LANE, NSTREAM) and counts occupied STILE streams; here
the items sit back to back and the breakdown counts occupied slots.

Times are device times by CUDA events, the least of `--reps` calls.

    python -m rfw_tpu_torch.tools.bench_items [--width 960 --height 544 --reps 3 --K 8]
        [--items-per-ray 3.0] [--case sorted] [--fused] [--breakdown] [--pallas-A]
        [--gltf PATH] [--device cuda|cpu]

prints one JSON line: Mrays/s (and ms) per call, `trunc_frac`,
`mask_mismatch`, `t_mismatch`, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rfw_tpu_torch.tools import call_ms, card_line, device_name, device_of

CASES = ("coherent", "sorted", "unsorted")


def disagreements(ref, got, trunc) -> dict:
    """Counts of `got` against the reference hits `ref` on the rays not
    marked truncated: hit masks that differ, and t more than 1e-3 apart
    where both hit (`bench_items.py:239-245`)."""
    ok = ~trunc
    both = ok & (ref.prim >= 0) & (got.prim >= 0)
    return dict(trunc_frac=trunc.float().mean().item(),
                mask_mismatch=int((ok & ((ref.prim >= 0) != (got.prim >= 0))).sum()),
                t_mismatch=int((both & ((ref.t - got.t).abs() > 1e-3)).sum()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--items-per-ray", type=float, default=3.0,
                    help="item buffer slots per ray")
    ap.add_argument("--case", default="sorted", choices=CASES)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--pallas-A", dest="pallas_a", action="store_true")
    ap.add_argument("--gltf", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from rfw_tpu_torch.bench import build_scene
    from rfw_tpu_torch.ops import traverse_items as ti
    from rfw_tpu_torch.ops.traverse import closest_hit, prepare_scene
    from rfw_tpu_torch.tools.bench_traverse import populations

    dev = device_of(args.device)
    W, H = args.width, args.height
    R = W * H
    parts = build_scene(W, H, gltf=args.gltf, device=dev)
    ps = prepare_scene(parts[0])
    o, d = populations(parts, ps, W, H)[args.case]
    cap_tiles = max(1, int(args.items_per_ray * R) // ti.CAPACITY_TILE) + 16
    card = card_line(dev)
    print(f"[{card}] R={R} K={args.K} capacity={cap_tiles} tiles "
          f"({cap_tiles * ti.CAPACITY_TILE} slots)", file=sys.stderr)

    results = {}

    def timed(name, fn):
        ms = min(call_ms(fn, args.reps, dev))
        results[name] = R / ms / 1e3
        results[f"{name}_ms"] = ms
        print(f"[{card}] {name:12s} {ms:9.4f} ms {R / ms / 1e3:9.2f} Mrays/s", file=sys.stderr)

    timed("classic", lambda: closest_hit(ps, o, d))
    ref = closest_hit(ps, o, d)
    if args.fused:
        K, ipr = args.K, args.items_per_ray
        timed("fused", lambda: ti.twophase_closest_fused(ps, o, d, K=K, items_per_ray=ipr))
        timed("fused+fb",
              lambda: ti.twophase_closest_with_fallback(ps, o, d, K=K, items_per_ray=ipr))
        _, trunc = ti.twophase_closest_fused(ps, o, d, K=K, items_per_ray=ipr)
        got = ti.twophase_closest_with_fallback(ps, o, d, K=K, items_per_ray=ipr)
        counts = disagreements(ref, got, torch.zeros_like(trunc))
        counts["trunc_frac"] = trunc.float().mean().item()
    else:
        timed("twophase", lambda: ti.pallas_twophase_closest_hit(
            ps, o, d, K=args.K, capacity_tiles=cap_tiles))
        got, trunc = ti.pallas_twophase_closest_hit(ps, o, d, K=args.K,
                                                    capacity_tiles=cap_tiles)
        counts = disagreements(ref, got, trunc)
    results.update(counts)
    print(f"[{card}] trunc {counts['trunc_frac']:.4f} mask_mis {counts['mask_mismatch']} "
          f"t_mis {counts['t_mismatch']}", file=sys.stderr)

    if args.breakdown:
        from rfw_tpu_torch.ops.traverse_entries import tlas_entries as k4_entries
        from rfw_tpu_torch.render.twophase import tlas_entries

        scene = parts[0]
        tl = torch.full((R,), 1e30, dtype=torch.float32, device=dev)
        timed("A.entries", lambda: tlas_entries(scene.tlas_wide_f, scene.tlas_wide_i, o, d,
                                                K=args.K))
        ents = tlas_entries(scene.tlas_wide_f, scene.tlas_wide_i, o, d, K=args.K)
        if args.pallas_a:
            timed("A.pallas", lambda: k4_entries(ps, o, d, K=args.K))
            gp = k4_entries(ps, o, d, K=args.K)
            results["A_entry_set_mismatch"] = int(
                (torch.sort(gp.inst, dim=1).values
                 != torch.sort(ents.inst, dim=1).values).any(dim=1).sum())
            print(f"[{card}] A.pallas entry-set mismatches {results['A_entry_set_mismatch']}",
                  file=sys.stderr)
        C = cap_tiles * ti.CAPACITY_TILE
        timed("B.pack", lambda: ti._pack(ps, o, d, tl, args.K, C, ents))
        _, _, slot_item, slot_inst, o_s, d_s, tl_s = ti._pack(ps, o, d, tl, args.K, C, ents)
        timed("C.kernel", lambda: ti.items(ps, slot_inst, o_s, d_s, tl_s, False))
        results["occupied_slots"] = int((slot_item >= 0).sum())
        print(f"[{card}] occupied slots {results['occupied_slots']}/{C}", file=sys.stderr)

    out = dict(results, width=W, height=H, rays=R, K=args.K, case=args.case,
               device=device_name(dev), card=card,
               clock="cuda events" if dev.type == "cuda" else "host")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
