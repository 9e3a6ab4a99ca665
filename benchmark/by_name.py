"""Load a file of this folder as a module by its path: configuration
generators, traffic laws and metric readers are found by the names in
`BENCHMARK.json` and in the traffic files (names such as `device_ms.shade`
hold a dot, so they cannot be imported by name)."""

import importlib.util
from pathlib import Path


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
