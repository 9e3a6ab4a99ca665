"""Tiny sizes of the benchmark's configurations, on the CPU, for CPU tests.

`run_cell` and the control need a CUDA card; `tiny()` stands in for one:
`load_cell` gives each configuration's tiny sizes, and the `torch.cuda`
calls of a run answer as a card with nothing allocated would."""

import contextlib
import time

import pytest
import torch

PATCH = {
    "flagship": dict(width=48, height=32, sphere_quality=1, instances_per_sphere=4, grid=4),
    "heavy10k": dict(width=48, height=32, n_instances=120),
}
SEED = 20260417123
CPU = torch.device("cpu")


@contextlib.contextmanager
def tiny():
    from benchmark import harness

    real = harness.load_cell

    def load_cell(workload, root=harness.HERE):
        bench, cell, cfg, traffic, gen = real(workload, root)
        cfg.update(PATCH.get(cell["config"], {}))
        return bench, cell, cfg, traffic, gen

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "load_cell", load_cell)
        mp.setattr(harness, "card_line", lambda: "cpu")
        for name, value in (("synchronize", None), ("empty_cache", None),
                            ("max_memory_allocated", 0), ("max_memory_reserved", 0),
                            ("get_device_name", "cpu")):
            mp.setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)
        yield


def run(workload, seconds=0.5, trace=False, root=None, seed=SEED):
    """One run of the cell at its tiny size on the CPU: (result, info)."""
    from benchmark import harness

    with tiny():
        return harness.run_cell(workload, seed, seconds, trace, CPU, time.perf_counter(),
                                root=root or harness.HERE)
