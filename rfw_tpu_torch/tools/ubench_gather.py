"""The cost of the gathers the integrator makes, and of `searchsorted`.

Counterpart of the reference's `tools/ubench_gather.py`: each primitive
alone on random indices, in one process, the least of `--reps` calls by
CUDA events (a gather and the sum that reads it):

  g_small_int   (R,) gather of (32,6) int32 rows      (material texture ids)
  g_small_f32   (R,) gather of (32,23) f32 rows       (the material block)
  g_mid_f32     (R,) gather of (2048,18) f32 rows     (instance matrices)
  g_big32_f32   (R,) gather of (128k,32) f32 rows     (the tri_shade record)
  g_big3_f32    (R,) gather of (128k,3) f32 rows      (a vertex gather)
  g_pool_f32    (R,) gather of a (16M,) f32 flat pool (atlas texel taps)
  searchsorted  (R,) into a (64,) CDF                 (the power-CDF pick)

--sweep-size prices an (R,) row gather against the table's size (0.5 MB
to 512 MB), its row type (32 columns of f32 against bf16: does halving a
row's bytes halve the cost?) and the order of its indices (random against
sorted: what sorting rays by what they fetch buys), in ns a row. Each
case's table is made on the device from a seeded generator.

--sweep-width (the port's own) prices an (R,) gather of f32 rows against
the row's width (2 to 32 columns of a 1M-row table), in three forms:
`table[idx]` (`index`), `torch.index_select` (`index_select`) and one
1-D gather of the R x C element ids of the flattened table (`flat`), in
ns a row. The integrator gathers rows of 4 (atlas texel quads), 21
(instance matrices) and 32 (tri_shade) columns this way.

The reference's `onehot_small` and `onehot_mid` time the TPU's one-hot
MXU fetch (`RFW_ONEHOT_MAX`); the port fetches those rows by a gather, so
they have no counterpart here.

    python -m rfw_tpu_torch.tools.ubench_gather [--rays 518400 --reps 5]
        [--sweep-size | --sweep-width] [--shrink N] [--device cuda|cpu]

`--shrink N` divides every table's rows by N (for the CPU or a small
card). Prints one JSON line: ms per gather (with a sweep, ns a row per
case), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rfw_tpu_torch.tools import call_ms, card_line, device_name, device_of

GATHERS = ("g_small_int", "g_small_f32", "g_mid_f32", "g_big32_f32", "g_big3_f32",
           "g_pool_f32", "searchsorted")


def sweep_cases(shrink: int = 1) -> list:
    """(name, rows, columns, dtype) of the size sweep: 16-byte u32 quad rows
    (atlas-shaped) over four sizes, and 32-column records (tri_shade-
    shaped) in f32 and bf16 over three."""
    cases = [(f"u32x4_{n // 1024}k", n, 4, torch.int32)
             for n in (32 * 1024, 256 * 1024, 2 * 1024 * 1024, 12 * 1024 * 1024)]
    for n in (64 * 1024, 1024 * 1024, 4 * 1024 * 1024):
        cases.append((f"f32x32_{n // 1024}k", n, 32, torch.float32))
        cases.append((f"bf16x32_{n // 1024}k", n, 32, torch.bfloat16))
    return [(name, max(1, n // shrink), c, dt) for name, n, c, dt in cases]


def _table(n: int, c: int, dtype, gen, dev) -> torch.Tensor:
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, (n, c), generator=gen, device=dev,
                             dtype=torch.int32)
    return torch.randn((n, c), generator=gen, device=dev).to(dtype)


def sweep_size(args, dev, card) -> dict:
    R = args.rays
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, n, c, dt in sweep_cases(args.shrink):
        tbl = _table(n, c, dt, gen, dev)
        idx_r = rng.integers(0, n, R)
        for loc, idx in (("rand", idx_r), ("sorted", np.sort(idx_r))):
            di = torch.from_numpy(idx).to(dev)

            def g(tbl=tbl, di=di):
                r = tbl[di]
                return r[:, 0].to(torch.float32).sum() + r[:, -1].to(torch.float32).sum()

            best = min(call_ms(g, args.reps, dev))
            key = f"{name}_{loc}"
            out[key] = best * 1e6 / R
            mb = tbl.numel() * tbl.element_size() / 1e6
            print(f"[{card}] {key:22s} {best:9.4f} ms  ({out[key]:8.3f} ns/row, table "
                  f"{mb:8.1f} MB)", file=sys.stderr)
        del tbl
    return out


#: the row widths (f32 columns) and the gather forms of --sweep-width
WIDTHS = (2, 3, 4, 5, 6, 8, 12, 16, 21, 24, 32)
FORMS = ("index", "index_select", "flat")


def sweep_width(args, dev, card) -> dict:
    R = args.rays
    n = max(1, 1024 * 1024 // args.shrink)
    gen = torch.Generator(device=dev).manual_seed(0)
    di = torch.from_numpy(np.random.default_rng(0).integers(0, n, R)).to(dev)
    out = {}
    for c in WIDTHS:
        tbl = torch.randn((n, c), generator=gen, device=dev)
        flat = tbl.view(-1)
        ids = (di[:, None] * c + torch.arange(c, device=dev)).view(-1)
        calls = {"index": lambda: tbl[di],
                 "index_select": lambda: torch.index_select(tbl, 0, di),
                 "flat": lambda: flat[ids].view(R, c)}
        ref = calls["index"]()
        for form in FORMS:  # the three forms gather the same rows
            assert torch.equal(calls[form](), ref), form
        for form in FORMS:
            key = f"f32x{c}_{form}"
            out[key] = min(call_ms(calls[form], args.reps, dev)) * 1e6 / R
            print(f"[{card}] {key:22s} {out[key]:8.3f} ns/row ({4 * c} B rows)",
                  file=sys.stderr)
    return out


def gathers(args, dev, card) -> dict:
    R, s = args.rays, args.shrink
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a).to(dev)

    n_big, n_pool = max(1, 131072 // s), max(1, 16 * 1024 * 1024 // s)
    t_small_i = t(rng.integers(0, 100, (32, 6)).astype(np.int32))
    t_small_f = t(rng.normal(size=(32, 23)).astype(np.float32))
    t_mid_f = t(rng.normal(size=(2048, 18)).astype(np.float32))
    t_big32 = t(rng.normal(size=(n_big, 32)).astype(np.float32))
    t_big3 = t(rng.normal(size=(n_big, 3)).astype(np.float32))
    t_pool = torch.randn(n_pool, generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    cdf = t(np.sort(rng.random(64).astype(np.float32)))
    idx_small = t(rng.integers(0, 32, R))
    idx_mid = t(rng.integers(0, 2048, R))
    idx_big = t(rng.integers(0, n_big, R))
    idx_pool = t(rng.integers(0, n_pool, R))
    u = t(rng.random(R).astype(np.float32))

    fns = [
        ("g_small_int", lambda: t_small_i[idx_small].sum()),
        ("g_small_f32", lambda: t_small_f[idx_small].sum()),
        ("g_mid_f32", lambda: t_mid_f[idx_mid].sum()),
        ("g_big32_f32", lambda: t_big32[idx_big].sum()),
        ("g_big3_f32", lambda: t_big3[idx_big].sum()),
        ("g_pool_f32", lambda: t_pool[idx_pool].sum()),
        ("searchsorted", lambda: torch.searchsorted(cdf, u, right=True).sum()),
    ]
    out = {}
    for name, fn in fns:
        out[name] = min(call_ms(fn, args.reps, dev))
        print(f"[{card}] {name:14s} {out[name]:9.4f} ms  ({out[name] * 1e6 / R:8.3f} ns/row)",
              file=sys.stderr)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=518400)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep-size", action="store_true",
                    help="table-size x dtype x locality gather cost curve")
    ap.add_argument("--sweep-width", action="store_true",
                    help="row width x gather form cost curve")
    ap.add_argument("--shrink", type=int, default=1,
                    help="divide every table's rows by N")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.shrink < 1 or (args.sweep_size and args.sweep_width):
        ap.error("--shrink must be at least 1; one sweep at a time")
    dev = device_of(args.device)
    card = card_line(dev)
    sweep = sweep_size if args.sweep_size else sweep_width if args.sweep_width else None
    res = gathers(args, dev, card) if sweep is None else sweep(args, dev, card)
    out = dict(res, rays=args.rays, shrink=args.shrink, unit="ms" if sweep is None
               else "ns/row", device=device_name(dev), card=card,
               clock="cuda events" if dev.type == "cuda" else "host")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
