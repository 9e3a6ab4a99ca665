"""The judge's control: the reference put in the program's place, computed in
bfloat16, the precision below the float32 the configurations state, in two
forms: `bf16`, the radiance and the film's sum in bfloat16, and
`bf16_film32`, the radiance in bfloat16 and the film's sum in float32 (a
program that shades in bfloat16 but keeps a float32 film).

    python3 benchmark/control.py --workload <name> --frames <n> --seeds <s> [<s> ...]

For each seed it builds the cell's scene at its own size, draws the judged
pixels and frames as a run of `n` frames would (the warm-up frames
included), renders them with the reference in float32 and in both forms,
and prints the judge's numbers of each form's frames against the float32
ones, one JSON line a seed. A control that passes the cell's limit means
the limit cannot tell a lower precision from the program. The benchmark's
own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
#: the control's forms: the dtype the film sums the bfloat16 radiance in
FORMS = {"bf16": "bfloat16", "bf16_film32": "float32"}


def control(workload: str, seed: int, frames: int, device, root=None):
    """({form: the judge's numbers of its frames against the float32
    reference's}, the cell's limits)."""
    import torch

    from benchmark import harness, judge

    root = root or harness.HERE
    _, _, cfg, traffic, gen = harness.load_cell(workload, root)
    spec = gen.build(seed % (1 << 64), cfg)
    pixels = judge.pick_pixels(seed, spec.width, spec.height)
    warm = traffic.warmup_frames
    picked = judge.pick_frames(seed, list(range(warm, max(frames, warm + 1))))
    want = judge.expected(spec, traffic, pixels, picked, device, torch.float32)
    out = {form: judge.compare(judge.expected(spec, traffic, pixels, picked, device,
                                              torch.bfloat16, getattr(torch, film)), want)
           for form, film in FORMS.items()}
    return out, judge.limits(workload, root)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        forms, lim = control(args.workload, seed, args.frames, torch.device("cuda", 0))
        print(json.dumps(dict(workload=args.workload, seed=seed, frames=args.frames,
                              seconds=time.perf_counter() - t, limits=lim, **forms)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
