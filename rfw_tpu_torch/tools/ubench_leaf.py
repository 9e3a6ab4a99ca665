"""U1: the cost of K1's treelet leaf test, stage by stage, on the card.

Counterpart of the reference's `tools/ubench_leaf.py`, whose Pallas kernel
becomes the hand-written CUDA kernel `rfw_tpu_torch/csrc/ubench_leaf.cu`
(built at first use by `ops._build`); `leaf_plain` beside it computes the
same function in plain torch. 1,024 rays (8 rows of 128) run `iters`
sequential steps, each a 64-slot leaf test over synthetic Woop records
(or one load of a dependent chain), with all data resident. Variants:

  full      K1's own leaf test (`csrc/bvh_common.cuh::leaf_test`)
  noselect  the same on record group 0
  madds     the six products per slot and a min over slots, no epilogue
  epilogue  the division, compares and best-slot update, no products
  fetch     a dependent chain of `iters` loads, nothing else
  fused     full's step with the slot test in the reference tool's own
            arithmetic (`slot_hit_fused`: multiply-adds, an approximate
            reciprocal refined by one Newton step), in K1's leaf loop
  staged    fused's test in U1's own loop: each step's treelet staged in
            shared memory while the block tests the previous one

Every variant but `fused` and `staged` matches its plain version bit for
bit on the card. Their plain version (one function for both) rounds each
multiply-add once, as the card's FFMA does, but takes the correctly
rounded 1/d'_w where the card's MUFU.RCP is within 1 ulp of it, so the
kernels are held to it by a tolerance: t within 3e-5 relative on all but
at most 4 of the 1,024 rays.

Per-iteration cost is (time(2*iters) - time(iters)) / iters, the least
over `--reps` timed calls of each; on the card each call is timed by CUDA
events. `--copies N` runs N independent copies of the problem in N
blocks: one block (the reference's shape) reads the latency of a step on
one SM, a copy per SM reads the card's throughput. Every copy must give
the first copy's output.

    python -m rfw_tpu_torch.tools.ubench_leaf [--iters 512 --reps 3 --copies N --device cuda|cpu]

prints one JSON line: microseconds per iteration and milliseconds per call
(at `--iters`) of each variant. Anything else goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple

import numpy as np
import torch

from rfw_tpu_torch.accel.bvh_cpu import TREELET
from rfw_tpu_torch.ops.traverse import _leaf_slots
from rfw_tpu_torch.render.intersect import T_MIN
from rfw_tpu_torch.tools import call_ms, device_name, device_of

LANE = 128
SSUB = 8  # ray rows of the reference's sub-tile at its defaults
RAYS = SSUB * LANE
TLANES = 16  # floats per record
TGROUPS = LANE // TLANES  # record groups per fetch block
N_BLOCKS = 64  # fetch blocks of the synthetic arena
VARIANTS = ("full", "noselect", "madds", "epilogue", "fetch", "fused", "staged")

#: kernel launches; the wrapper adds one where it launches
LAUNCHES = {"leaf": 0}

_F32 = torch.float32
_EPS = 1e-30  # scale of the value folded into t to keep it live


class LeafOut(NamedTuple):
    t: torch.Tensor  # (copies, 8, 128) f32
    aux: torch.Tensor  # (copies, 8, 128) i32: the chain's last index (fetch), else g


def make_inputs():
    """The reference tool's inputs, drawn alike from seed 0: (tri
    (64, 64*128) f32 — 64 fetch blocks of 8 groups of 16-float records —
    and obj (9, 8, 128) f32), numpy."""
    rng = np.random.default_rng(0)
    tri = rng.normal(size=(TREELET, N_BLOCKS * LANE)).astype(np.float32)
    obj = rng.normal(size=(9, SSUB, LANE)).astype(np.float32)
    return tri, obj


def to_records(tri: torch.Tensor) -> torch.Tensor:
    """The reference's (64, 64*128) record blocks in the port's node-major
    Woop layout: (64*8*64, 16), treelet gb*8 + g holding in slot i the
    record tri[i, gb*128 + g*16 : +16] (floats 0-3, 4-7, 8-11: the u, v, w
    rows, as `csrc/bvh_common.cuh::leaf_test` reads them)."""
    return (tri.reshape(TREELET, N_BLOCKS, TGROUPS, TLANES).permute(1, 2, 0, 3)
            .reshape(-1, TLANES).contiguous())


def _group(obj: torch.Tensor) -> torch.Tensor:
    """int(t0 of ray 0) % 8: the record group, read once from lane 0."""
    t00 = torch.abs(obj.reshape(-1)[0]) * 100.0
    return torch.remainder(t00.to(torch.int32), TGROUPS)


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a*b + c rounded once to float32, as an FFMA rounds it: the product
    of two float32 values is exact in float64, so only the float64 sum and
    the cast round, which gives the FFMA's result but where the float64 sum
    lands on a float32 tie that the exact sum is not (about 2^-29 of the
    cases)."""
    return (a.double() * b + c).float()


def _fused_slots(a: torch.Tensor, obj, tcur: torch.Tensor):
    """`csrc/bvh_common.cuh::slot_hit_fused` over the 64 slots of one
    treelet's records a (64, 16) for n rays obj = (ox, oy, oz, dx, dy, dz)
    (n,) each, hits limited to (T_MIN, tcur): (ok, t, u), each (n, 64).
    The reference tool's step (`tools/ubench_leaf.py:96-111`) with the
    kernel's multiply-adds; r0 = 1/d'_w stands in for its approximate
    reciprocal."""
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in obj)

    def tail(k, y, z, s):  # s + a_k+1 * y + a_k+2 * z, two multiply-adds
        return _fma(a[:, k + 2], z, _fma(a[:, k + 1], y, s))

    opu, opv, opw = (tail(k, oy, oz, _fma(a[:, k], ox, a[:, k + 3])) for k in (0, 4, 8))
    dpu, dpv, dpw = (tail(k, dy, dz, a[:, k] * dx) for k in (0, 4, 8))
    r0 = 1.0 / dpw  # d'_w = 0: inf, then 1 - 0*inf is NaN and so is t
    rw = _fma(r0, _fma(-dpw, r0, 1.0), r0)
    t = -opw * rw
    u = _fma(t, dpu, opu)
    v = _fma(t, dpv, opv)
    ok = ((u >= -1e-7) & (v >= -1e-7) & (u + v <= 1 + 1e-7)
          & (t > T_MIN) & (t < tcur[:, None]))
    return ok, t, u


def leaf_plain(tris: torch.Tensor, obj: torch.Tensor, variant: str, iters: int) -> LeafOut:
    """Plain torch U1 (any device), one copy: (1, 8, 128) outputs, each
    operation rounded as the kernel rounds it (`fused`, `staged`: but for
    the reciprocal, see `_fused_slots`)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    dev = tris.device
    o = obj.reshape(9, RAYS)
    ox, oy, oz, dx, dy, dz = (o[k] for k in range(6))
    t = torch.abs(ox) * 100.0
    g = _group(obj)
    eps = torch.tensor(_EPS, dtype=_F32, device=dev)
    if variant == "fetch":
        flat = tris.reshape(-1)
        idx = torch.ones((), dtype=torch.int64, device=dev)
        for _ in range(iters):
            v = flat[torch.remainder(idx, N_BLOCKS) * (TGROUPS * TREELET * TLANES)]
            h = (idx * 1103515245 + 12345 + (v * 0.0).to(torch.int64)) & 0xFFFFFFFF
            idx = torch.remainder(torch.where(h >= 2**31, h - 2**32, h), 65521)
        aux = idx.to(torch.int32).expand(RAYS)
        return LeafOut((t + 1.0).reshape(1, SSUB, LANE),
                       aux.reshape(1, SSUB, LANE).contiguous())

    recs = tris.reshape(-1, TREELET, TLANES)
    ray = (ox, oy, oz, dx, dy, dz)
    count = torch.full((RAYS,), TREELET, device=dev)
    inf = torch.tensor(float("inf"), dtype=_F32, device=dev)
    for j in range(iters):
        treelet = (j * 7) % N_BLOCKS * TGROUPS + (0 if variant == "noselect" else g)
        if variant == "madds":
            a = recs[treelet]  # (64 slots, 16)

            def dot(k, x, y, z):  # (rays, slots)
                return a[:, k] * x[:, None] + a[:, k + 1] * y[:, None] + a[:, k + 2] * z[:, None]
            s = (dot(0, ox, oy, oz) + a[:, 3] + (dot(4, ox, oy, oz) + a[:, 7])
                 + (dot(8, ox, oy, oz) + a[:, 11]) + dot(0, dx, dy, dz) + dot(4, dx, dy, dz)
                 + dot(8, dx, dy, dz))
            t = t + torch.amin(s, dim=1) * eps
        elif variant == "epilogue":  # o' = o, d' = d in every slot: slot 0 decides
            tq = -oz / dz
            uq = ox + tq * dx
            vq = oy + tq * dy
            ok = ((uq >= -1e-7) & (vq >= -1e-7) & (uq + vq <= 1 + 1e-7)
                  & (tq > T_MIN) & (tq < t))
            t = torch.where(ok, tq + uq * eps, t)
        else:
            if variant in ("fused", "staged"):
                ok, tq, uq = _fused_slots(recs[treelet], ray, t)
            else:  # K1's own plain leaf test
                first = torch.as_tensor(treelet * TREELET, device=dev).expand(RAYS)
                ok, tq, uq, _ = _leaf_slots(tris, first, count, ray, t)
            score = torch.where(ok, tq, inf)
            win = torch.argmin(score, dim=1, keepdim=True)  # lowest slot among ties
            tmin = score.gather(1, win)[:, 0]
            t = torch.where(tmin < t, tmin + uq.gather(1, win)[:, 0] * eps, t)
    aux = g.to(torch.int32).expand(RAYS)
    return LeafOut(t.reshape(1, SSUB, LANE), aux.reshape(1, SSUB, LANE).contiguous())


def _check(tris: torch.Tensor, obj: torch.Tensor) -> None:
    if tris.device.type != "cuda":
        raise ValueError(f"U1 runs on the CPU or a CUDA device, not {tris.device}")
    if (tris.dtype != _F32 or tris.dim() != 2 or tris.shape[1] != TLANES
            or tris.shape[0] < N_BLOCKS * TGROUPS * TREELET or not tris.is_contiguous()):
        raise ValueError(f"tris: expected contiguous (>= {N_BLOCKS * TGROUPS * TREELET}, "
                         f"{TLANES}) float32, got {tuple(tris.shape)} {tris.dtype}")
    if (obj.dtype != _F32 or tuple(obj.shape) != (9, SSUB, LANE)
            or not obj.is_contiguous() or obj.device != tris.device):
        raise ValueError(f"obj: expected contiguous (9, {SSUB}, {LANE}) float32 on "
                         f"{tris.device}, got {tuple(obj.shape)} {obj.dtype} on {obj.device}")


def leaf(tris: torch.Tensor, obj: torch.Tensor, variant: str, iters: int,
         copies: int = 1) -> LeafOut:
    """U1 over `copies` independent copies: the CUDA kernel for tensors on
    the card (one block of 1,024 threads per copy), the plain version for
    tensors on the CPU. Returns (copies, 8, 128) outputs."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if copies < 1 or iters < 0:
        raise ValueError(f"copies {copies} and iters {iters}: need copies >= 1, iters >= 0")
    if tris.device.type == "cpu":
        one = leaf_plain(tris, obj, variant, iters)
        return LeafOut(*(x.expand(copies, SSUB, LANE).contiguous() for x in one))
    from rfw_tpu_torch.ops._build import load_library
    from rfw_tpu_torch.ops.traverse import ptr, stream_of

    _check(tris, obj)
    lib = load_library("ubench_leaf")
    dev = tris.device
    t = torch.empty((copies, SSUB, LANE), dtype=_F32, device=dev)
    aux = torch.empty((copies, SSUB, LANE), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.rfw_ubench_leaf(VARIANTS.index(variant), ptr(tris), tris.shape[0], ptr(obj),
                                 iters, copies, ptr(t), ptr(aux), stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"ubench_leaf kernel launch failed: cudaError {rc}")
    LAUNCHES["leaf"] += 1
    return LeafOut(t, aux)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--copies", type=int, default=1,
                    help="independent 1,024-ray blocks (one per SM fills an H100 at 132)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.iters < 1 or args.reps < 1:
        ap.error("--iters and --reps must be at least 1")
    dev = device_of(args.device)
    tri, obj = make_inputs()
    tris = to_records(torch.from_numpy(tri)).to(dev)
    obj = torch.from_numpy(obj).to(dev)

    us_per_iter, ms_per_call = {}, {}
    for variant in VARIANTS:
        times = {}
        for iters in (args.iters, 2 * args.iters):
            out = leaf(tris, obj, variant, iters, args.copies)
            for x in out:
                if not torch.equal(x, x[:1].expand_as(x)):
                    raise RuntimeError(f"U1 {variant} at {iters} iterations: the "
                                       f"{args.copies} copies disagree")
            times[iters] = min(call_ms(lambda: leaf(tris, obj, variant, iters, args.copies),
                                       args.reps, dev))
        us_per_iter[variant] = (times[2 * args.iters] - times[args.iters]) / args.iters * 1e3
        ms_per_call[variant] = times[args.iters]
        print(f"{variant:9s} {us_per_iter[variant]:10.4f} us/iter (call "
              f"{times[args.iters]:.4f} ms @ {args.iters}, {args.copies} copies)",
              file=sys.stderr)
    result = dict(device=device_name(dev), clock="cuda events" if dev.type == "cuda" else "host",
                  iters=args.iters, copies=args.copies, rays_per_copy=RAYS,
                  us_per_iter=us_per_iter, ms_per_call=ms_per_call)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
