"""Whether the frames the timed path produced are right.

A run keeps, of every frame that `TorchBackend.render()` returned, the 8-bit
RGB of PIXELS pixels drawn from the seed. Once the window has closed, the
reference (`reference.py`) renders those pixels of FRAMES frames drawn from
the seed, the last frame among them: every Sobol sample the film of that
frame holds (all of them since the film's last reset), accumulated and
tonemapped as the program's film is. A pixel is off where a channel of the
program's frame differs from the reference's by more than LEVELS 8-bit
levels. The number compared is the share of judged pixels that are off
(`off_pct`); its limit is the cell's (`limits/<workload>.json`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import Reference

PIXELS = 256
FRAMES = 24
LEVELS = 2
#: lanes a reference batch traces at once
BATCH = 32768


def rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), tag])


def pick_pixels(seed: int, width: int, height: int, n: int = PIXELS) -> np.ndarray:
    return np.sort(rng(seed, 1).choice(width * height, size=min(n, width * height),
                                       replace=False))


def pick_frames(seed: int, window: List[int], n: int = FRAMES) -> List[int]:
    """Up to n frame indices of the window drawn from the seed, the last
    one always among them."""
    chosen = rng(seed, 2).choice(len(window), size=min(n, len(window)), replace=False)
    return sorted({window[i] for i in chosen} | {window[-1]})


def tonemap(acc: torch.Tensor, spp: int, exposure: float = 1.0) -> np.ndarray:
    """(P,3) accumulated radiance -> (P,3) uint8 sRGB through the ACES
    approximation (Narkowicz), as the film's tonemap encodes it."""
    c = acc / max(float(spp), 1.0) * exposure
    c = torch.clamp((c * (2.51 * c + 0.03)) / (c * (2.43 * c + 0.59) + 0.14), 0.0, 1.0)
    c = torch.where(c <= 0.0031308, 12.92 * c, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    c = torch.clamp(c, 0.0, 1.0)
    return (c * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def expected(spec, traffic, pixels: np.ndarray, frames: List[int], device,
             dtype=torch.float32, film_dtype=None) -> np.ndarray:
    """(F,P,3) uint8: what the frames' pixels should read. Frame f's film
    holds samples 0..f - s of the scene as it stands at f, where s is the
    traffic's `film_start(f)`. The radiance is computed in `dtype` and the
    film sums it in `film_dtype` (`dtype` where None)."""
    s = spec.settings
    if s.get("tonemap", "aces") != "aces" or s.get("samples_per_frame", 1) != 1 \
            or s.get("sampler", "sobol") != "sobol" or s.get("fxaa", False):
        raise ValueError("the reference renders one Sobol sample a frame, ACES, no FXAA")
    exposure = float(s.get("exposure", 1.0))
    film_dtype = film_dtype or dtype
    groups: Dict[int, List[int]] = {}
    for f in frames:
        groups.setdefault(traffic.film_start(f), []).append(f)
    out = {}
    ref = None
    for start, fs in sorted(groups.items()):
        sc = traffic.scene_at(spec, max(fs))
        if ref is None or not ref.holds(sc):
            ref = Reference(sc, device, dtype)
        ref.set_instances(sc.instances)
        pid = torch.as_tensor(pixels, dtype=torch.int64, device=ref.dev)
        P = pid.shape[0]
        due = {f - start + 1: f for f in fs}  # samples the film holds -> frame
        acc = torch.zeros((P, 3), dtype=film_dtype, device=ref.dev)
        per = max(1, BATCH // P)
        K = max(due)
        for s0 in range(0, K, per):
            n = min(per, K - s0)
            sample = torch.arange(s0, s0 + n, device=ref.dev).repeat_interleave(P)
            rad = ref.radiance(pid.repeat(n), sample).to(dtype).reshape(n, P, 3)
            for i in range(n):
                acc = acc + rad[i].to(film_dtype)  # one sample at a time, as the film adds them
                if s0 + i + 1 in due:
                    out[due[s0 + i + 1]] = tonemap(acc, s0 + i + 1, exposure)
    return np.stack([out[f] for f in frames])


def compare(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """The number compared (`off_pct`) and, beside it, the spread of the
    channel gaps in 8-bit levels."""
    gap = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=-1)
    out = {"off_pct": 100.0 * float((gap > LEVELS).mean())}
    for k in (1, 4, 16, 64):
        out[f"gap_over_{k}_pct"] = 100.0 * float((gap > k).mean())
    out["gap_mean"] = float(gap.mean())
    return out


def limits(workload: str, root: Path) -> Dict[str, float]:
    """The cell's limit of each number compared (`limits/<workload>.json`)."""
    d = json.loads((root / "limits" / f"{workload}.json").read_text())
    return {k: float(v["limit"]) for k, v in d.items()}
