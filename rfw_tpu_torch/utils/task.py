"""Host-side task pool for asset IO (reference crates/rfw-utils/src/task.rs:10-229).

On TPU all *compute* parallelism lives on-device; the only legitimate host
threading is overlapping file IO / decode with device work, so this is a thin
wrapper over ``concurrent.futures`` with the reference's finished-task
drain semantics (`iter_finished` / `sync`).

Host copy of `rfw_tpu/utils/task.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterator, List, Optional


class TaskPool:
    def __init__(self, workers: Optional[int] = None) -> None:
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._tasks: List[Future] = []

    def spawn(self, fn: Callable[..., Any], *args: Any, **kw: Any) -> Future:
        f = self._pool.submit(fn, *args, **kw)
        self._tasks.append(f)
        return f

    def iter_finished(self) -> Iterator[Any]:
        """Yield results of finished tasks, removing them from the pool."""
        still = []
        for t in self._tasks:
            if t.done():
                yield t.result()
            else:
                still.append(t)
        self._tasks = still

    def sync(self) -> List[Any]:
        """Block until all tasks finish; return their results."""
        res = [t.result() for t in self._tasks]
        self._tasks = []
        return res

    def __len__(self) -> int:
        return len(self._tasks)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
