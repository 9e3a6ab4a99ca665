"""Wavefront OBJ/MTL loader.

Fresh implementation with the semantics of the reference's obj loader
(crates/rfw-scene/src/loaders/obj.rs:27-253): triangulated faces with
per-face materials, MTL -> Disney mapping (Kd/Ks/Ns/Ke/Ni/d + map_Kd,
map_Ke, map_bump/norm, unknown-param map_pr/map_pm with metallic+roughness
merge), texture dedup through the Materials store.

Vectorized parse: faces are accumulated as raw index triplets and resolved
through a unique-corner remap in one numpy pass rather than per-face loops.

Host copy of `rfw_tpu/loaders/obj.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from rfw_tpu_torch.models.mesh3d import build_mesh3d
from rfw_tpu_torch.scene.descriptor import MeshDescriptor
from rfw_tpu_torch.scene.materials import Material, Materials
from rfw_tpu_torch.utils import log

_LOG = log.get("loaders.obj")


def _parse_mtl(path: str, materials: Materials) -> Dict[str, int]:
    """Parse an MTL file into the Materials store; returns name -> id."""
    out: Dict[str, int] = {}
    if not os.path.exists(path):
        _LOG.warning("mtl not found: %s", path)
        return out
    base = os.path.dirname(path)

    cur: Optional[Material] = None
    cur_name = ""
    metallic_map: Optional[str] = None
    roughness_map: Optional[str] = None

    def flush() -> None:
        nonlocal cur, metallic_map, roughness_map
        if cur is None:
            return
        # merge metallic + roughness maps into one glTF-layout texture
        # (reference obj.rs merges map_pm/map_pr into a single texture)
        if metallic_map or roughness_map:
            from rfw_tpu_torch.scene.materials import Texture

            mtex = Texture.load(metallic_map, srgb=False) if metallic_map else None
            rtex = Texture.load(roughness_map, srgb=False) if roughness_map else None
            if rtex is not None and mtex is not None:
                merged = rtex.merge_metallic_roughness(mtex)
            else:
                merged = rtex or mtex
            cur.metallic_roughness_tex = materials.push_texture(merged)
        out[cur_name] = materials.push(cur)
        cur, metallic_map, roughness_map = None, None, None

    def tex(args: List[str], srgb: bool) -> int:
        # ignore mtl texture options (-bm etc.): take the last token as path
        p = os.path.join(base, args[-1].replace("\\", "/"))
        if not os.path.exists(p):
            _LOG.warning("texture not found: %s", p)
            return -1
        return materials.load_texture(p, srgb=srgb)

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key, args = parts[0], parts[1:]
            if key == "newmtl":
                flush()
                cur = Material(name=args[0] if args else "")
                cur_name = args[0] if args else ""
            elif cur is None:
                continue
            elif key == "Kd":
                cur.color[:3] = [float(x) for x in args[:3]]
            elif key == "Ks":
                cur.specular[:3] = [float(x) for x in args[:3]]
            elif key == "Ns":
                # shininess -> roughness, Blinn-Phong correspondence
                ns = float(args[0])
                cur.roughness = float(np.sqrt(2.0 / (ns + 2.0)))
            elif key == "Ke":
                ke = np.array([float(x) for x in args[:3]], np.float32)
                if (ke > 0).any():
                    # emissive: color channels carry radiance (>1 flags emissive)
                    cur.color[:3] = np.maximum(ke, 1.0 + 1e-4) if ke.max() <= 1.0 else ke
            elif key == "Ni":
                cur.eta = float(args[0])
            elif key == "d":
                d = float(args[0])
                if d < 1.0:
                    cur.transmission = 1.0 - d
            elif key == "Pm":
                cur.metallic = float(args[0])
            elif key == "Pr":
                cur.roughness = float(args[0])
            elif key == "map_Kd":
                cur.diffuse_tex = tex(args, srgb=True)
            elif key == "map_Ke":
                cur.emissive_tex = tex(args, srgb=True)
            elif key in ("map_bump", "bump", "norm", "map_Kn"):
                cur.normal_tex = tex(args, srgb=False)
            elif key in ("map_Pr", "map_pr", "map_Ns"):
                roughness_map = os.path.join(base, args[-1].replace("\\", "/"))
                if not os.path.exists(roughness_map):
                    roughness_map = None
            elif key in ("map_Pm", "map_pm"):
                metallic_map = os.path.join(base, args[-1].replace("\\", "/"))
                if not os.path.exists(metallic_map):
                    metallic_map = None
    flush()
    return out


class ObjLoader:
    extensions = (".obj",)

    def load(self, path: str, materials: Materials) -> MeshDescriptor:
        positions: List[List[float]] = []
        uvs: List[List[float]] = []
        normals: List[List[float]] = []
        # face corners as (vi, ti, ni) with -1 sentinels; per-face material
        corners: List[Tuple[int, int, int]] = []
        face_mats: List[int] = []
        mtl_map: Dict[str, int] = {}
        cur_mat = 0

        def resolve(idx: str, count: int) -> int:
            i = int(idx)
            return i - 1 if i > 0 else count + i

        with open(path, "r", errors="replace") as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                key = parts[0]
                if key == "v":
                    positions.append([float(x) for x in parts[1:4]])
                elif key == "vt":
                    u = float(parts[1])
                    v = float(parts[2]) if len(parts) > 2 else 0.0
                    uvs.append([u, 1.0 - v])  # flip V like the reference (gl->tex)
                elif key == "vn":
                    normals.append([float(x) for x in parts[1:4]])
                elif key == "f":
                    face = []
                    for vert in parts[1:]:
                        comps = vert.split("/")
                        vi = resolve(comps[0], len(positions))
                        ti = (
                            resolve(comps[1], len(uvs))
                            if len(comps) > 1 and comps[1]
                            else -1
                        )
                        ni = (
                            resolve(comps[2], len(normals))
                            if len(comps) > 2 and comps[2]
                            else -1
                        )
                        face.append((vi, ti, ni))
                    # triangulate fan
                    for k in range(1, len(face) - 1):
                        corners += [face[0], face[k], face[k + 1]]
                        face_mats.append(cur_mat)
                elif key == "mtllib":
                    mtl_path = os.path.join(os.path.dirname(path), " ".join(parts[1:]))
                    mtl_map = _parse_mtl(mtl_path, materials)
                elif key == "usemtl":
                    cur_mat = mtl_map.get(parts[1] if len(parts) > 1 else "", 0)

        if not corners:
            raise ValueError(f"no faces in {path}")

        pos_arr = np.asarray(positions, np.float32)
        uv_arr = np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32)
        nrm_arr = np.asarray(normals, np.float32) if normals else np.zeros((0, 3), np.float32)

        # Unique (v,t,n) corners -> vertex array (vectorized dedup).
        corner_arr = np.asarray(corners, np.int64)  # (3T,3)
        uniq, inv = np.unique(corner_arr, axis=0, return_inverse=True)
        indices = inv.reshape(-1, 3).astype(np.int32)

        v_pos = pos_arr[uniq[:, 0]]
        v_uv = np.where(
            (uniq[:, 1:2] >= 0), uv_arr[np.maximum(uniq[:, 1], 0)] if len(uv_arr) else 0.0, 0.0
        ).astype(np.float32) if len(uv_arr) else None
        has_normals = len(nrm_arr) > 0 and (uniq[:, 2] >= 0).all()
        v_nrm = nrm_arr[uniq[:, 2]] if has_normals else None

        mesh = build_mesh3d(
            v_pos,
            indices,
            normals=v_nrm,
            uvs=v_uv,
            material_ids=np.asarray(face_mats, np.int32),
            name=os.path.basename(path),
        )
        _LOG.info("loaded %s: %d tris, %d verts", path, mesh.num_triangles, mesh.num_vertices)
        return MeshDescriptor(mesh=mesh, name=os.path.basename(path))
