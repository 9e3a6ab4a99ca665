"""The least work a frame's traversal needs, from shapes alone.

Whatever implements the traversal (the walk kernels, a two-phase path, a
brute force), a frame asks the same queries of it:
  * W·H·(bounces+1) closest-hit queries, one per pixel and path vertex, and
    as many shadow queries (NEE at every vertex);
  * each query reads its ray once (origin, direction, t limit: 28 B) and
    writes its answer once (a closest hit's t, triangle, instance, u, v:
    20 B; a shadow query's flag: 4 B);
  * the scene is read once: every triangle of the input meshes (three
    float32 corners, 36 B) and every instance matrix (4x4 float32, 64 B).

Every lane counts, dead or alive (a path that ended still owns its lane):
the share is a lower bound on the work. Operations are left out: a walk's
count of box and triangle tests depends on the BVH it builds, which is the
program's choice, so no count of them stays fixed across implementations.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

RAY_BYTES = 28
CLOSEST_ANSWER_BYTES = 20
SHADOW_ANSWER_BYTES = 4
TRIANGLE_BYTES = 36
MATRIX_BYTES = 64


def queries(width: int, height: int, bounces: int, samples: int = 1) -> int:
    """Closest-hit queries a frame (as many shadow queries again)."""
    return width * height * samples * (bounces + 1)


def trace_bytes(width: int, height: int, bounces: int, n_triangles: int, n_instances: int,
                samples: int = 1) -> int:
    q = queries(width, height, bounces, samples)
    return (q * (RAY_BYTES + CLOSEST_ANSWER_BYTES) + q * (RAY_BYTES + SHADOW_ANSWER_BYTES)
            + n_triangles * TRIANGLE_BYTES + n_instances * MATRIX_BYTES)


def peak(kind: str, root: Path) -> Optional[Dict]:
    """The published peaks of a card by its `torch.cuda.get_device_name()`
    (`peaks.json`), or None for a card the table lacks."""
    return json.loads((root / "peaks.json").read_text()).get(kind)


def share_pct(work_bytes: float, seconds: float, bytes_per_s: float) -> float:
    """The least time the bytes need at the peak rate, over the time taken,
    in percent."""
    return 100.0 * work_bytes / bytes_per_s / seconds
