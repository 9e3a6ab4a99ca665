"""Run one cell of BENCHMARK.json on the card this process finds.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, on standard output, a line with the
set-up's parts and the run's counts, then as its last line the result:
`correct`, `attempted`, `failed`, `metrics`, `device` (and with --trace 1
`breakdown`), and last `checks`, each number compared beside its limit.
The same numbers and limits end standard error. Exits 2 without a result
where there is no CUDA card (or fewer than the cell asks for), and 3 where
a forbidden module (jax, jaxlib, flax, rfw_tpu) was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# import the folder as the package `benchmark`, never its files as
# top-level modules
sys.path[0] = str(ROOT)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / "build" / "bench_cache" / sub))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark import harness

    result, info = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                    torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(info), flush=True)
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
