"""Spans and counters of `TorchBackend`'s frame, on the profiler's clock.

Tracing is on exactly while a torch profiler records, and there is no other
switch: run the frames under `torch.profiler.profile(activities=[CPU,
CUDA])`. The spans are then `record_function` annotations, user annotations
in the profiler's event list on the same clock as its device events, and
the counters fill one record a frame (`frames()`). With no profiler
running, `span` hands back one shared null context and `count` returns at
once: the frame path enters no `record_function`, records nothing and pays
one attribute read a call.

A span's parent is the span around it on the host thread.

Spans of the frame's stages, which tile the program's part of a frame:

  rfw.sync            TorchBackend.synchronize
  rfw.sync.motion     the device motion route (`_try_device_motion`)
  rfw.sync.dynamics   the device dynamics route (`_apply_device_dynamics`)
  rfw.sync.dynamics.tlas
                      in it, the TLAS half of the refit: `refit_device.
                      apply_dynamic`'s `_refit_tlas` call, every TLAS
                      mirror over every instance row
  rfw.sync.repack     the host instance repack (`_sync_instances`)
  rfw.sync.rebuild    the full rebuild (`_rebuild_scene`)
  rfw.sync.upload     materials, textures and lights
  rfw.sync.wait       the closing device synchronize
  rfw.render          TorchBackend.render
  rfw.render.setup    render()'s work before its first render_sample
  rfw.vertex0         render_sample from its entry through vertex 0
  rfw.bounce.<d>      bounce vertex d: sort, live count, trace, shading;
                      d runs 1..max_bounces, so rfw.bounce.2 and on appear
                      only at a path depth of 2 or more
  rfw.film            add_sample, tonemap and the readback

Spans of traversal, around each kernel call's host side:

  rfw.trace.closest   ops.traverse.closest_hit (K1)
  rfw.trace.occluded  ops.traverse.occluded (K2)
  rfw.trace.phase_a   the dense instance scan or ops.traverse_entries (K4)
  rfw.trace.phase_b   pack, K3/K5/K6 and the merge of a two-phase call
  rfw.trace.fallback  the retrace of truncated rays through K1/K2

(The last three run only where bounce rays take the two-phase route: on
the CPU, and on the card under two_phase="on" or RFW_TWO_PHASE=1.)

Spans of blocking host reads, `rfw.wait.<site>`:

  rfw.wait.v0_hits        render_sample: vertex 0's hit count (.item())
  rfw.wait.live_count     render_sample: a bounce's live count (.item())
  rfw.wait.compact        ops.traverse_items.compact_entries: boolean-mask
                          indexing of the kept items
  rfw.wait.fallback_rows  ops.traverse_items._fallback_rows: the nonzero
                          of the truncated rays
  rfw.wait.upload         host-to-device copies from pageable host memory:
                          render()'s view, the motion route's matrices
  rfw.wait.readback       the frame's copy to the host

(rfw.sync.wait is the wait of the sync itself.)

Counters, summed over a frame (from the previous render() return to this
one, so a frame's synchronize() counts land in it), each from a value the
host already holds:

  lanes.shaded   lanes a vertex shades: vertex 0's hit prefix and each
                 bounce's live prefix (under compaction, the default;
                 RFW_COMPACTION=0 reads no count and counts nothing)
  lanes.live     the lanes alive among them: vertex 0's hits, a bounce's
                 alive count
  lanes.shaded.deep, lanes.live.deep
                 the same two counts of the bounce vertices at depth 2
                 or more only (render/wavefront.py:`_shade_live`); a
                 1-bounce frame records neither
  ladder.subfloor
                 bounce vertices whose live prefix took one of the two
                 rungs the deep ladder adds below the 1-bounce ladder's
                 floor (`_prefix_sizes` at max_bounces >= 3,
                 `_pick_prefix`; render/wavefront.py:`_shade_live`): 0
                 under RFW_DEEP_LADDER=0 and at fewer than 3 bounces
  route.classic_bounce
                 bounce vertices whose closest hits the kernel tier's
                 classic walk traced (`ops.traverse.closest_hit`, K1 on
                 the card; render/wavefront.py:`_bounce_vertex`): max_bounces
                 a frame on the card under two_phase="auto", 0 where the
                 two-phase route ran (and in the lockstep and packet tiers)
  tp.truncated   rays a two-phase call could not decide (the nonzero of
                 its truncated or undecided mask)
  tp.retraced    those of them retraced through K1/K2, at most the
                 fallback's capacity
  sampler.kernel_draws
                 launches of the Sobol kernel (render/sampler.py's
                 `sample_slot` on the card): 5 a 1-bounce Sobol sample,
                 0 where the draws took the plain version
  dyn.units      deform units (one a distinct (mesh, skin, morph weights)
                 group) that `refit_device.apply_dynamic` re-bakes and
                 refits: every unit of the scene, each dynamics sync
  dyn.vertices   the vertices it skins there: the rest vertices of every
                 unit with a pose (a morph-only unit counts none)
  disney.kernel_calls
                 launches of the Disney BSDF kernels (render/disney.py's
                 `_launch` on the card): 3 a 1-bounce frame, 7 at 3
                 bounces (NEE eval and pdf at every vertex, a sample at
                 every vertex but the last), 0 where the BSDF took the
                 plain version; a vertex with no live lane launches none

`tp.truncated - tp.retraced` is the number of rays that kept an
approximate answer (a two-phase hit among their kept instances, or
unoccluded): the operator's accuracy check, which should read 0.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Deque, Dict, List

from torch.autograd import profiler as _profiler

#: closed frame records kept, the newest last
FRAMES_KEPT = 1024

_NULL = contextlib.nullcontext()
_frames: Deque[Dict] = collections.deque(maxlen=FRAMES_KEPT)
_open: Dict[str, int] = {}
_seq = 0
_opened_ns = 0


def enabled() -> bool:
    """True while a torch profiler records."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context manager: `record_function(name)` while a profiler records,
    else a shared null context."""
    if enabled():
        return _profiler.record_function(name)
    return _NULL


def count(name: str, n: int) -> None:
    """Add the host integer n to the open frame's counter `name` while a
    profiler records."""
    if enabled():
        _open[name] = _open.get(name, 0) + n


def end_frame() -> None:
    """Close the open frame's record (TorchBackend.render, as it returns):
    while a profiler records, keep {"frame": sequence number, "start_ns",
    "end_ns" (time.time_ns(), the profiler's clock), "counts"}; the counts
    start anew either way."""
    global _seq, _opened_ns
    _seq += 1
    now = time.time_ns()
    if enabled():
        _frames.append({"frame": _seq, "start_ns": _opened_ns, "end_ns": now,
                        "counts": dict(_open)})
    _open.clear()
    _opened_ns = now


def frames() -> List[Dict]:
    """The closed frame records, oldest first (at most FRAMES_KEPT)."""
    return list(_frames)
