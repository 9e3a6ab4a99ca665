"""Time per stage of the port's two-phase closest-hit call.

Counterpart of the reference's `tools/bench_fused_stages.py`, on the
port's own call, `ops.traverse_items.twophase_closest_with_fallback`,
over the bench scene's bounce-like rays (`--case`, as `bench_traverse`
makes them). One call runs with each stage's arguments captured; then
each stage runs alone on its captured arguments, timed by CUDA events
(the least of `--reps` calls):

  A.dense / A.k4   phase A: each ray's K nearest instance entries, by the
                   dense scan (`twophase.dense_tlas_entries`, the default
                   up to `DENSE_A_MAX_INST` arena rows) or, with
                   --pallas-A, by K4 (`ops.traverse_entries`)
  B.pack           compaction, instance sort and the slot gather of
                   origins, directions and limits (`_pack` on phase A's
                   entries)
  C.items          phase B: K3 (`items`), or K6 (`dense_items`) for the
                   items the dense tier takes (RFW_DENSE_ITEMS=1)
  D.merge          the per-ray scatter-min merge (`_merge_closest`)
  E.fallback       K1 retracing the truncated rays (`closest_hit`)

Beside them, `stages` times the same call with every stage bracketed by a
device synchronize (exclusive host-clock ms per stage and the rest as
glue; `chip_smoke.py` prints it). The reference counts occupied STILE
streams, a TPU tile; the port's items sit back to back in slots, so this
tool reports the occupied item slots of the buffer.

    python -m rfw_tpu_torch.tools.bench_fused_stages [--width 1920 --height 1080 --reps 3
        --K 8 --items-per-ray 1.5 --case sorted] [--pallas-A] [--gltf PATH]
        [--device cuda|cpu]

prints one JSON line: ms per stage, the bracketed call's ms per stage,
the slot occupancy, the truncated and retraced rays, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from collections import defaultdict

import torch

from rfw_tpu_torch.tools import call_ms, card_line, device_name, device_of, patched

#: the stages of the call: the traverse_items function each wraps, and its
#: label in the bracketed breakdown
STAGE_FNS = {"_phase_a": "phase A", "_pack": "pack (compaction, instance sort, gather)",
             "items": "phase B: K3 items", "dense_items": "phase B: K6 dense items",
             "_merge_closest": "merge (scatter-min)", "closest_hit": "fallback (K1 retrace)"}
CASES = ("coherent", "sorted", "unsorted")


class StageClock:
    """Exclusive host-clock milliseconds per wrapped function, each call
    bracketed by a synchronize of `dev` (none on the CPU); a nested
    wrapped call counts for itself only."""

    def __init__(self, dev: torch.device):
        self.dev = torch.device(dev)
        self.ms = defaultdict(float)
        self._open = []  # per open call: ms spent in wrapped callees

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def wrap(self, name, fn):
        def timed_stage(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            self._open.append(0.0)
            out = fn(*args, **kwargs)
            self.sync()
            dt = (time.perf_counter() - t0) * 1e3
            inner = self._open.pop()
            self.ms[name] += dt - inner
            if self._open:
                self._open[-1] += dt
            return out
        return timed_stage


def stages(ps, o, d, tl, K: int, items_per_ray: float, dev) -> dict:
    """One two-phase call with its stages bracketed by synchronize(): the
    call's ms, exclusive ms per stage (STAGE_FNS' labels) and the rest as
    glue, its truncated rays and the rays the fallback retraced."""
    from rfw_tpu_torch.ops import traverse_items as ti

    clock = StageClock(dev)
    fallback = []
    closest = ti.closest_hit

    def count_fallback(ps_, o_, *a):
        fallback.append(o_.shape[0])
        return closest(ps_, o_, *a)

    fns = {f: clock.wrap(n, getattr(ti, f)) for f, n in STAGE_FNS.items() if f != "closest_hit"}
    with patched(ti, **fns, closest_hit=clock.wrap(STAGE_FNS["closest_hit"], count_fallback)):
        clock.sync()
        t0 = time.perf_counter()
        ti.twophase_closest_with_fallback(ps, o, d, tl, K=K, items_per_ray=items_per_ray)
        clock.sync()
        total = (time.perf_counter() - t0) * 1e3
    _, trunc = ti.twophase_closest_fused(ps, o, d, tl, K=K, items_per_ray=items_per_ray)
    return dict(total_ms=total, stage_ms=dict(clock.ms),
                other_ms=total - sum(clock.ms.values()), truncated=int(trunc.sum()),
                retraced=sum(fallback))


def capture(ps, o, d, tl, K: int, items_per_ray: float):
    """One two-phase call with each stage's call recorded: (its hits,
    [(stage, fn, args, kwargs, output)] in call order)."""
    from rfw_tpu_torch.ops import traverse_items as ti

    calls = []

    def recorder(name, fn):
        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, fn, args, kwargs, out))
            return out
        return record

    with patched(ti, **{f: recorder(f, getattr(ti, f)) for f in STAGE_FNS}):
        hit = ti.twophase_closest_with_fallback(ps, o, d, tl, K=K, items_per_ray=items_per_ray)
    return hit, calls


def isolated(calls, reps: int, dev, k4: bool) -> dict:
    """ms of each captured stage call alone (CUDA events, the least of
    `reps`); the pack runs on the captured phase A entries."""
    names = {"_phase_a": "A.k4" if k4 else "A.dense", "_pack": "B.pack", "items": "C.items",
             "dense_items": "C.dense_items", "_merge_closest": "D.merge",
             "closest_hit": "E.fallback"}
    ents = next(out for name, _, _, _, out in calls if name == "_phase_a")
    out = {}
    for name, fn, args, kwargs, _ in calls:
        if name == "_pack":
            kwargs = dict(kwargs, ents=ents)
        out[names[name]] = out.get(names[name], 0.0) + min(
            call_ms(lambda: fn(*args, **kwargs), reps, dev))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--items-per-ray", type=float, default=1.5)
    ap.add_argument("--case", default="sorted", choices=CASES)
    ap.add_argument("--pallas-A", dest="pallas_a", action="store_true",
                    help="phase A by K4 (the dense-scan gate forced to 0)")
    ap.add_argument("--gltf", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from rfw_tpu_torch.bench import build_scene
    from rfw_tpu_torch.ops import traverse_items as ti
    from rfw_tpu_torch.ops.traverse import prepare_scene
    from rfw_tpu_torch.tools.bench_traverse import populations

    dev = device_of(args.device)
    W, H = args.width, args.height
    R, K = W * H, args.K
    parts = build_scene(W, H, gltf=args.gltf, device=dev)
    ps = prepare_scene(parts[0])
    o, d = populations(parts, ps, W, H)[args.case]
    tl = torch.full((R,), 1e30, dtype=torch.float32, device=dev)
    card = card_line(dev)
    cap = math.ceil(R * args.items_per_ray)
    print(f"[{card}] R={R} instances={ps.n_inst} K={K} slots={cap} case={args.case} "
          f"phase A by {'K4' if args.pallas_a else 'the dense scan'}", file=sys.stderr)

    gate = dict(DENSE_A_MAX_INST=0) if args.pallas_a else {}
    with patched(ti, **gate):
        _, calls = capture(ps, o, d, tl, K, args.items_per_ray)
        res = isolated(calls, args.reps, dev, args.pallas_a)
        call = stages(ps, o, d, tl, K, args.items_per_ray, dev)
    for name, ms in res.items():
        print(f"[{card}] {name:14s} {ms:9.4f} ms", file=sys.stderr)
    slot_item = next(out for name, _, _, _, out in calls if name == "_pack")[2]
    occupied = int((slot_item >= 0).sum())
    print(f"[{card}] occupied slots {occupied}/{slot_item.shape[0]}; bracketed call "
          f"{call['total_ms']:.3f} ms, truncated {call['truncated']}, retraced "
          f"{call['retraced']}", file=sys.stderr)
    out = dict(res, bracketed=call, occupied_slots=occupied, slots=int(slot_item.shape[0]),
               width=W, height=H, rays=R, K=K, case=args.case, pallas_A=args.pallas_a,
               device=device_name(dev), card=card,
               clock="cuda events" if dev.type == "cuda" else "host")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
