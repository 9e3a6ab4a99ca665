"""`heavy10k`'s field with skinned characters: `heavy10k.py`'s generator,
unchanged, plus one mesh slot, the characters' rest pose, with one instance
a character, and the joints and weights the traffic law `skin` poses it by.

The characters are a stand-in for CesiumMan (not in the repository): a
closed tube skinned to a chain of joints along its axis
(`chip_smoke.py::skinned_tube`'s geometry), each vertex weighted over its
`influences` nearest joints. `heavy10k_skinned.json`'s `characters` block
holds the sizes and the placement.
"""

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from benchmark import scene as S
from benchmark.by_name import load_module

_heavy10k = load_module(Path(__file__).resolve().parent / "heavy10k.py")


@dataclass
class SkinnedSpec(S.SceneSpec):
    """A SceneSpec whose mesh slot `skin_slot` is the characters' rest pose,
    one instance a character, skinned by `joints` and `weights` to a chain
    whose joint j pivots at (0, pivots[j], 0) in the mesh's space."""

    skin_slot: int = -1
    joints: np.ndarray = None  # (V,4) i32
    weights: np.ndarray = None  # (V,4) f32, rows sum to 1
    pivots: np.ndarray = None  # (J,) f32


def tube(rings: int, segments: int, radius: float, height: float, material: int) -> S.Mesh:
    """A closed tube of rings x segments quads along y, from 0 to `height`."""
    y = np.repeat(np.linspace(0.0, height, rings + 1), segments)
    a = np.tile(np.arange(segments) * (2 * np.pi / segments), rings + 1)
    radial = np.stack([np.cos(a), np.zeros_like(a), np.sin(a)], 1)
    pos = radial * radius + np.stack([0 * y, y, 0 * y], 1)
    uvs = np.stack([a / (2 * np.pi), y / height], 1)
    r, s = np.meshgrid(np.arange(rings), np.arange(segments), indexing="ij")
    v00, v01 = r * segments + s, r * segments + (s + 1) % segments
    v10, v11 = v00 + segments, v01 + segments
    idx = np.concatenate([np.stack([v00, v11, v10], -1).reshape(-1, 3),
                          np.stack([v00, v01, v11], -1).reshape(-1, 3)])
    return S.make_mesh(pos, idx, radial, uvs, material, "character")


def chain_weights(y: np.ndarray, pivots: np.ndarray, influences: int):
    """(joints (V,k) i32, weights (V,k) f32) of the k nearest pivots of each
    height, w proportional to exp(-(d / spacing)^2), rows summing to 1."""
    d = np.abs(y[:, None] - pivots[None, :])
    joints = np.argsort(d, axis=1, kind="stable")[:, :influences]
    spacing = pivots[1] - pivots[0]
    w = np.exp(-(np.take_along_axis(d, joints, axis=1) / spacing) ** 2)
    return joints.astype(np.int32), (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def placements(view: np.ndarray, c: dict) -> np.ndarray:
    """(count,4,4) f32 matrices: the characters stand on the floor, scaled
    by `scale`, centred on the diagonal from the field's centre to the
    camera's ground point at `along` of the way, `apart` units apart
    across it, turned `yaw_deg` about y."""
    ground = np.array([view[0], 0.0, view[2]], np.float64)
    across = np.cross(ground / np.linalg.norm(ground), [0.0, 1.0, 0.0])
    n = c["count"]
    th = np.deg2rad(c["yaw_deg"])
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    out = np.zeros((n, 4, 4), np.float32)
    for k in range(n):
        out[k, :3, :3] = rot * c["scale"]
        out[k, :3, 3] = c["along"] * ground + (k - (n - 1) / 2) * c["apart"] * across
        out[k, 3, 3] = 1.0
    return out


def build(seed: int, cfg: dict) -> SkinnedSpec:
    base = _heavy10k.build(seed, cfg)
    c = cfg["characters"]
    color, params, tex = S.material_table([c["material"]])
    material = base.color.shape[0]
    mesh = tube(c["rings"], c["segments"], c["radius"], c["height"], material)
    pivots = np.linspace(0.0, c["height"], c["joints"]).astype(np.float32)
    joints, weights = chain_weights(mesh.positions[:, 1], pivots, c["influences"])
    fields = {f: getattr(base, f) for f in base.__dataclass_fields__}
    fields.update(
        meshes=base.meshes + [mesh],
        instances=base.instances + [placements(base.view, c)],
        color=np.concatenate([base.color, color]),
        params=np.concatenate([base.params, params]),
        tex=np.concatenate([base.tex, tex]),
    )
    return SkinnedSpec(**fields, skin_slot=len(base.meshes), joints=joints, weights=weights,
                       pivots=pivots)


def character_share(spec: SkinnedSpec, device, step: int = 1):
    """Each character's share of the primary hits at frame 0's rest pose:
    rays through the centres of every `step`-th pixel in each axis, traced
    by the plain reference. A list of floats (share of the rays that hit
    anything)."""
    import torch

    from benchmark.reference import Reference

    ref = Reference(spec, device)
    ref.set_instances(spec.instances)
    v = torch.as_tensor(spec.view, device=ref.dev)
    py, px = torch.meshgrid(torch.arange(0, spec.height, step, device=ref.dev),
                            torch.arange(0, spec.width, step, device=ref.dev), indexing="ij")
    r = (px.reshape(-1) + 0.5) * v[17]
    s = (py.reshape(-1) + 0.5) * v[18]
    d = torch.stack([v[9 + j] + r * v[3 + j] + s * v[6 + j] - v[j] for j in range(3)], 1)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    o = v[:3].expand_as(d)
    n = d.shape[0]
    hits = torch.full((n,), -1, dtype=torch.int64, device=ref.dev)
    for a in range(0, n, 65536):
        sl = slice(a, a + 65536)
        hit = ref.trace(tuple(o[sl].unbind(1)), tuple(d[sl].unbind(1)),
                        torch.full((d[sl].shape[0],), 1e26, device=ref.dev), False)
        hits[sl] = hit.inst
    first = sum(m.shape[0] for m in spec.instances[:spec.skin_slot])
    found = int((hits >= 0).sum())
    return [int((hits == first + k).sum()) / max(found, 1)
            for k in range(spec.instances[spec.skin_slot].shape[0])]
