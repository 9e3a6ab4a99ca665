"""Light buffers: the four light-type SoA blocks plus the unified light
table (host numpy copy of `rfw_tpu/render/lights_pack.py`).

Zero-light types keep one dummy row so shapes stay static (masked by count).
`rfw_tpu_torch.convert` moves the packed arrays to the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from rfw_tpu_torch.backend.lights import (
    AreaLightsView,
    DirectionalLightsView,
    PointLightsView,
    SpotLightsView,
)


class DeviceLights(NamedTuple):
    # counts, as (1,) arrays
    n_point: np.ndarray  # (1,) i32 actual count
    n_spot: np.ndarray
    n_dir: np.ndarray
    n_area: np.ndarray

    point_pos: np.ndarray  # (P,3)
    point_energy: np.ndarray  # (P,3)

    spot_pos: np.ndarray  # (S,3)
    spot_dir: np.ndarray
    spot_energy: np.ndarray
    spot_cos_inner: np.ndarray  # (S,)
    spot_cos_outer: np.ndarray

    dir_dir: np.ndarray  # (D,3)
    dir_energy: np.ndarray

    area_v0: np.ndarray  # (A,3)
    area_v1: np.ndarray
    area_v2: np.ndarray
    area_normal: np.ndarray
    area_radiance: np.ndarray  # (A,3)
    area_area: np.ndarray  # (A,)

    # Power-proportional selection (improves on the reference's
    # potential-weighted pick, shade.comp:283-470, with exact pdfs that
    # scale to thousands of emissive triangles): cdf over the unified
    # [point ++ spot ++ dir ++ area] light list, plus each light's pick
    # probability for MIS (area probs gathered at emissive-hit time).
    pick_cdf: np.ndarray  # (Lpad,) f32 inclusive cdf, 1-terminated
    pick_prob: np.ndarray  # (Lpad,) f32 probability per light
    area_pick_prob: np.ndarray  # (A,) f32 — slice of pick_prob for area lights
    # scalars for reconstructing an emitter's pick probability at shade time
    # (instance-exact: the hit's world area is known there; a tri_light-keyed
    # gather would return instance 0's probability for every instance)
    pick_w_total: np.ndarray  # (1,) f32 sum of all selection weights
    pick_n: np.ndarray  # (1,) f32 total light count (for the uniform blend)

    # unified per-light record, rows ordered [point ++ spot ++ dir ++ area]
    # to match pick indices — ONE row gather replaces ~16 per-type table
    # gathers in the NEE sampler. Column layout:
    #   0:3  pos (point/spot) | v0 (area)      3:6  dir (spot/dir) | v1
    #   6:9  energy (point/spot/dir) | v2      9:12 normal (area)
    #   12:15 radiance (area)   15 cos_inner   16 cos_outer
    #   17 area                 18 pick_prob   19 pad
    light_table: np.ndarray  # (Lpad, 20) f32

    @property
    def total(self) -> int:
        return int(self.n_point[0] + self.n_spot[0] + self.n_dir[0] + self.n_area[0])


def _pad(a: np.ndarray, tail: tuple, cap: int) -> np.ndarray:
    out = np.zeros((max(cap, 1),) + tail, np.float32)
    out[: a.shape[0]] = a
    return out


def _cap(n: int) -> int:
    """Round capacity up (power of two, >=1) so shapes change rarely."""
    c = 1
    while c < n:
        c *= 2
    return c


def _lum(rgb: np.ndarray) -> np.ndarray:
    if rgb.shape[0] == 0:
        return np.zeros(0, np.float32)
    return (0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2]).astype(np.float32)


def pack_lights(
    point: PointLightsView,
    spot: SpotLightsView,
    directional: DirectionalLightsView,
    area: AreaLightsView,
) -> DeviceLights:
    pc, sc, dc, ac = (_cap(v.count) for v in (point, spot, directional, area))

    # per-light selection weights (relative emitted power proxies)
    w_point = 4.0 * np.pi * _lum(point.energy)
    cone = 2.0 * np.pi * (1.0 - 0.5 * (spot.cos_inner + spot.cos_outer)) if spot.count else np.zeros(0, np.float32)
    w_spot = _lum(spot.energy) * np.maximum(cone, 1e-3)
    # directional lights reach everything; weight by irradiance with a
    # large fixed aperture so they stay competitive
    w_dir = _lum(directional.energy) * (4.0 * np.pi)
    w_area = _lum(area.radiance) * area.area * np.pi if area.count else np.zeros(0, np.float32)
    weights = np.concatenate([w_point, w_spot, w_dir, w_area]).astype(np.float32)
    total = float(weights.sum())
    n = weights.shape[0]
    if n == 0 or total <= 0:
        prob = np.ones(max(n, 1), np.float32) / max(n, 1)
    else:
        # Defensive 50/50 blend with uniform: bounds the 1/pick_p firefly
        # amplification when the power heuristic misjudges a light's actual
        # contribution (e.g. a dim sun that nonetheless dominates shading).
        prob = 0.5 * weights / total + 0.5 / n
    cdf = np.cumsum(prob).astype(np.float32)
    if len(cdf):
        cdf[-1] = 1.0
    lpad = _cap(max(n, 1))
    prob_p = np.zeros(lpad, np.float32)
    cdf_p = np.ones(lpad, np.float32)
    prob_p[: len(prob)] = prob
    cdf_p[: len(cdf)] = cdf
    a0 = point.count + spot.count + directional.count
    area_prob = np.zeros(max(ac, 1), np.float32)
    if area.count:
        area_prob[: area.count] = prob[a0 : a0 + area.count]

    lpad_rows = max(lpad, 1)
    table = np.zeros((lpad_rows, 20), np.float32)
    r = 0
    for i in range(point.count):
        table[r, 0:3] = point.position[i]
        table[r, 6:9] = point.energy[i]
        r += 1
    for i in range(spot.count):
        table[r, 0:3] = spot.position[i]
        table[r, 3:6] = spot.direction[i]
        table[r, 6:9] = spot.energy[i]
        table[r, 15] = spot.cos_inner[i]
        table[r, 16] = spot.cos_outer[i]
        r += 1
    for i in range(directional.count):
        table[r, 3:6] = directional.direction[i]
        table[r, 6:9] = directional.energy[i]
        r += 1
    for i in range(area.count):
        table[r, 0:3] = area.v0[i]
        table[r, 3:6] = area.v1[i]
        table[r, 6:9] = area.v2[i]
        table[r, 9:12] = area.normal[i]
        table[r, 12:15] = area.radiance[i]
        table[r, 17] = area.area[i]
        r += 1
    table[:len(prob), 18] = prob

    return DeviceLights(
        n_point=np.array([point.count], np.int32),
        n_spot=np.array([spot.count], np.int32),
        n_dir=np.array([directional.count], np.int32),
        n_area=np.array([area.count], np.int32),
        point_pos=_pad(point.position, (3,), pc),
        point_energy=_pad(point.energy, (3,), pc),
        spot_pos=_pad(spot.position, (3,), sc),
        spot_dir=_pad(spot.direction, (3,), sc),
        spot_energy=_pad(spot.energy, (3,), sc),
        spot_cos_inner=_pad(spot.cos_inner, (), sc),
        spot_cos_outer=_pad(spot.cos_outer, (), sc),
        dir_dir=_pad(directional.direction, (3,), dc),
        dir_energy=_pad(directional.energy, (3,), dc),
        area_v0=_pad(area.v0, (3,), ac),
        area_v1=_pad(area.v1, (3,), ac),
        area_v2=_pad(area.v2, (3,), ac),
        area_normal=_pad(area.normal, (3,), ac),
        area_radiance=_pad(area.radiance, (3,), ac),
        area_area=_pad(area.area, (), ac),
        pick_cdf=cdf_p,
        pick_prob=prob_p,
        area_pick_prob=area_prob,
        pick_w_total=np.array([total], np.float32),
        pick_n=np.array([float(n)], np.float32),
        light_table=table,
    )

