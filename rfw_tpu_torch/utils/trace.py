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
  rfw.sync.repack     the host instance repack (`_sync_instances`)
  rfw.sync.rebuild    the full rebuild (`_rebuild_scene`)
  rfw.sync.upload     materials, textures and lights
  rfw.sync.wait       the closing device synchronize
  rfw.render          TorchBackend.render
  rfw.render.setup    render()'s work before its first render_sample
  rfw.vertex0         render_sample from its entry through vertex 0
  rfw.bounce.<d>      bounce vertex d: sort, live count, trace, shading
  rfw.film            add_sample, tonemap and the readback

Spans of traversal, around each kernel call's host side:

  rfw.trace.closest   ops.traverse.closest_hit (K1)
  rfw.trace.occluded  ops.traverse.occluded (K2)
  rfw.trace.phase_a   the dense instance scan or ops.traverse_entries (K4)
  rfw.trace.phase_b   pack, K3/K5/K6 and the merge of a two-phase call
  rfw.trace.fallback  the retrace of truncated rays through K1/K2

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
  tp.truncated   rays a two-phase call could not decide (the nonzero of
                 its truncated or undecided mask)
  tp.retraced    those of them retraced through K1/K2, at most the
                 fallback's capacity
  sampler.kernel_draws
                 launches of the Sobol kernel (render/sampler.py's
                 `sample_slot` on the card): 5 a 1-bounce Sobol sample,
                 0 where the draws took the plain version

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
