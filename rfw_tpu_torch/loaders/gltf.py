"""glTF 2.0 loader (.gltf / .glb), hand-rolled (no external gltf dep).

Capabilities match what the reference gets from l3d + its gltf loader
(crates/rfw-scene/src/loaders/gltf.rs:26-130): meshes with POSITION/NORMAL/
TEXCOORD_0/TANGENT/JOINTS_0/WEIGHTS_0, per-primitive materials
(pbrMetallicRoughness -> Disney mapping), textures with mip gen, full node
hierarchy with TRS or matrix, skins (inverseBindMatrices + joints), and
animations (translation/rotation/scale channels, LINEAR/STEP/CUBICSPLINE
samplers). Output is a SceneDescriptor; ids are remapped into the target
Materials store at load time like the reference does.

Host copy of `rfw_tpu/loaders/gltf.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from rfw_tpu_torch.models.mesh3d import Mesh3D, build_mesh3d
from rfw_tpu_torch.scene.descriptor import (
    AnimationDescriptor,
    AnimChannelDescriptor,
    NodeDescriptor,
    SceneDescriptor,
    SkinDescriptor,
)
from rfw_tpu_torch.scene.materials import Material, Materials, Texture
from rfw_tpu_torch.utils import log
from rfw_tpu_torch.utils.image import decode_image

_LOG = log.get("loaders.gltf")

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


class _Gltf:
    """Parsed glTF document with accessor resolution."""

    def __init__(self, path: str) -> None:
        self.base = os.path.dirname(path)
        if path.endswith(".glb"):
            with open(path, "rb") as f:
                data = f.read()
            magic, _ver, _length = struct.unpack_from("<III", data, 0)
            if magic != 0x46546C67:
                raise ValueError("not a glb file")
            off = 12
            self.json: dict = {}
            self.bin: Optional[bytes] = None
            while off < len(data):
                clen, ctype = struct.unpack_from("<II", data, off)
                chunk = data[off + 8 : off + 8 + clen]
                if ctype == 0x4E4F534A:  # JSON
                    self.json = json.loads(chunk)
                elif ctype == 0x004E4942:  # BIN
                    self.bin = bytes(chunk)
                off += 8 + clen
        else:
            with open(path, "r") as f:
                self.json = json.load(f)
            self.bin = None
        self._buffers: Dict[int, bytes] = {}

    def buffer(self, i: int) -> bytes:
        if i in self._buffers:
            return self._buffers[i]
        spec = self.json["buffers"][i]
        uri = spec.get("uri")
        if uri is None:
            data = self.bin or b""
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            from urllib.parse import unquote

            with open(os.path.join(self.base, unquote(uri)), "rb") as f:
                data = f.read()
        self._buffers[i] = data
        return data

    def accessor(self, i: int) -> np.ndarray:
        """Resolve accessor -> (count, components) array (handles strides)."""
        acc = self.json["accessors"][i]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        if "bufferView" not in acc:
            return np.zeros((count, ncomp), dtype)
        bv = self.json["bufferViews"][acc["bufferView"]]
        buf = self.buffer(bv["buffer"])
        offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        itemsize = np.dtype(dtype).itemsize * ncomp
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            out = np.frombuffer(buf, dtype, count * ncomp, offset).reshape(count, ncomp)
        else:
            # glTF only guarantees stride*(count-1) + itemsize bytes — a view
            # ending exactly at the last element must not over-read
            nbytes = stride * (count - 1) + itemsize
            flat = np.frombuffer(buf, np.uint8, nbytes, offset)
            raw = np.lib.stride_tricks.as_strided(
                flat, shape=(count, itemsize), strides=(stride, 1)
            )
            out = raw.copy().view(dtype).reshape(count, ncomp)
        return out

    def image_path(self, i: int) -> Optional[str]:
        img = self.json["images"][i]
        uri = img.get("uri")
        if uri and not uri.startswith("data:"):
            from urllib.parse import unquote

            return os.path.join(self.base, unquote(uri))
        return None

    def image_array(self, i: int) -> np.ndarray:
        """Decode embedded (data-uri or bufferView) image."""
        img = self.json["images"][i]
        uri = img.get("uri")
        if uri and uri.startswith("data:"):
            raw = base64.b64decode(uri.split(",", 1)[1])
        elif "bufferView" in img:
            bv = self.json["bufferViews"][img["bufferView"]]
            buf = self.buffer(bv["buffer"])
            o = bv.get("byteOffset", 0)
            raw = buf[o : o + bv["byteLength"]]
        else:
            raise ValueError("image has neither uri nor bufferView")
        return decode_image(raw, f"glTF image {i}")


def _srgb_texture_set(g: _Gltf) -> set:
    """glTF texture indices holding gamma-encoded color data. Per the glTF
    spec only baseColor and emissive are sRGB; normal / metallic-roughness /
    occlusion maps are linear and must not be gamma-decoded at sample time."""
    srgb: set = set()
    for gm in g.json.get("materials", []):
        pbr = gm.get("pbrMetallicRoughness", {})
        if "baseColorTexture" in pbr:
            srgb.add(pbr["baseColorTexture"]["index"])
        if "emissiveTexture" in gm:
            srgb.add(gm["emissiveTexture"]["index"])
    return srgb


def _load_textures(g: _Gltf, materials: Materials) -> List[int]:
    """texture index -> Materials texture id, srgb classified per use.

    Decode runs on a TaskPool (reference rfw-utils task.rs asset-IO pool):
    file reads, zlib and numpy release the GIL for part of each decode (the
    JPEG entropy decoder is Python and holds it), so texture decodes
    overlap in part; pushes into the Materials store stay ordered on this thread."""
    from rfw_tpu_torch.utils.task import TaskPool

    srgb_set = _srgb_texture_set(g)
    entries = []  # (texture index, decode future | None)
    pool = TaskPool()

    def decode(src: int, srgb: bool, path):
        if path and os.path.exists(path):
            return Texture.load(path, srgb=srgb)
        return Texture.from_array(g.image_array(src), srgb=srgb)

    try:
        by_path = {}  # decode each (path, srgb) once even if shared
        for ti, tex in enumerate(g.json.get("textures", [])):
            src = tex.get("source")
            if src is None:
                entries.append((ti, None))
                continue
            path = g.image_path(src)
            # dedup decodes by file path when there is one, else by the
            # glTF source index (embedded images shared by several textures)
            key = (path if path else ("src", src), ti in srgb_set)
            fut = by_path.get(key)
            if fut is None:
                fut = pool.spawn(decode, src, ti in srgb_set, path)
                by_path[key] = fut
            entries.append((ti, fut))
        out = []
        for ti, fut in entries:
            if fut is None:
                out.append(-1)
                continue
            try:
                out.append(materials.push_texture(fut.result()))
            except Exception as e:  # missing/broken image -> no texture
                _LOG.warning("texture %d failed: %s", ti, e)
                out.append(-1)
    finally:
        pool.shutdown()
    return out


def _load_materials(g: _Gltf, materials: Materials, tex_map: List[int]) -> List[int]:
    """glTF material -> Disney Material (reference gltf.rs material remap)."""
    out = []
    for gm in g.json.get("materials", []):
        m = Material(name=gm.get("name", ""))
        pbr = gm.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        m.color = np.asarray(base, np.float32)
        m.metallic = float(pbr.get("metallicFactor", 1.0))
        m.roughness = float(pbr.get("roughnessFactor", 1.0))
        if "baseColorTexture" in pbr:
            m.diffuse_tex = tex_map[pbr["baseColorTexture"]["index"]]
        if "metallicRoughnessTexture" in pbr:
            m.metallic_roughness_tex = tex_map[pbr["metallicRoughnessTexture"]["index"]]
        if "normalTexture" in gm:
            m.normal_tex = tex_map[gm["normalTexture"]["index"]]
        emissive = np.asarray(gm.get("emissiveFactor", [0, 0, 0]), np.float32)
        strength = (
            gm.get("extensions", {})
            .get("KHR_materials_emissive_strength", {})
            .get("emissiveStrength", 1.0)
        )
        if (emissive > 0).any():
            e = emissive * strength
            m.color[:3] = np.maximum(e, 1.0 + 1e-4) if e.max() <= 1.0 else e
        if "emissiveTexture" in gm:
            m.emissive_tex = tex_map[gm["emissiveTexture"]["index"]]
        m.double_sided = bool(gm.get("doubleSided", False))
        ior = gm.get("extensions", {}).get("KHR_materials_ior", {})
        if "ior" in ior:
            m.eta = float(ior["ior"])
        trans = gm.get("extensions", {}).get("KHR_materials_transmission", {})
        if "transmissionFactor" in trans:
            m.transmission = float(trans["transmissionFactor"])
        out.append(materials.push(m))
    return out


def _load_mesh(g: _Gltf, gmesh: dict, mat_map: List[int]) -> Mesh3D:
    """Merge all primitives of one glTF mesh into a single Mesh3D
    (per-triangle material ids keep sub-meshes addressable, like the
    reference's VertexMesh ranges)."""
    all_pos, all_nrm, all_uv, all_idx, all_mat = [], [], [], [], []
    all_joints, all_weights = [], []
    any_skin = any("JOINTS_0" in p.get("attributes", {}) for p in gmesh["primitives"])
    n_targets = max(
        (len(p.get("targets", [])) for p in gmesh["primitives"]), default=0
    )
    all_targets = [[] for _ in range(n_targets)]  # per target: per-prim deltas
    all_targets_n = [[] for _ in range(n_targets)]  # NORMAL deltas
    all_targets_t = [[] for _ in range(n_targets)]  # TANGENT deltas (xyz)
    any_morph_n = any("NORMAL" in t for pr in gmesh["primitives"]
                      for t in pr.get("targets", []))
    any_morph_t = any("TANGENT" in t for pr in gmesh["primitives"]
                      for t in pr.get("targets", []))
    vbase = 0
    for prim in gmesh["primitives"]:
        if prim.get("mode", 4) != 4:
            _LOG.warning("skipping non-triangle primitive (mode=%s)", prim.get("mode"))
            continue
        attrs = prim["attributes"]
        pos = g.accessor(attrs["POSITION"]).astype(np.float32)
        n = pos.shape[0]
        nrm = (
            g.accessor(attrs["NORMAL"]).astype(np.float32)
            if "NORMAL" in attrs
            else None
        )
        uv = (
            g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
            if "TEXCOORD_0" in attrs
            else np.zeros((n, 2), np.float32)
        )
        if "indices" in prim:
            idx = g.accessor(prim["indices"]).astype(np.int64).reshape(-1, 3)
        else:
            idx = np.arange(n, dtype=np.int64).reshape(-1, 3)
        mat = mat_map[prim["material"]] if "material" in prim else 0
        all_pos.append(pos)
        all_nrm.append(nrm if nrm is not None else np.zeros((n, 3), np.float32))
        all_uv.append(uv)
        all_idx.append(idx + vbase)
        all_mat.append(np.full(idx.shape[0], mat, np.int32))
        for k in range(n_targets):
            tgs = prim.get("targets", [])
            tk = tgs[k] if k < len(tgs) else {}
            for key, out in (("POSITION", all_targets),
                             ("NORMAL", all_targets_n),
                             ("TANGENT", all_targets_t)):
                if key in tk:
                    out[k].append(
                        g.accessor(tk[key]).astype(np.float32)[:, :3])
                else:
                    out[k].append(np.zeros((n, 3), np.float32))
        if any_skin:
            if "JOINTS_0" in attrs:
                all_joints.append(g.accessor(attrs["JOINTS_0"]).astype(np.int32))
                all_weights.append(g.accessor(attrs["WEIGHTS_0"]).astype(np.float32))
            else:
                all_joints.append(np.zeros((n, 4), np.int32))
                w = np.zeros((n, 4), np.float32)
                w[:, 0] = 1.0
                all_weights.append(w)
        vbase += n

    pos = np.concatenate(all_pos)
    nrm = np.concatenate(all_nrm)
    has_normals = bool(np.abs(nrm).max() > 0)
    weights = None
    joints = None
    if any_skin:
        joints = np.concatenate(all_joints)
        weights = np.concatenate(all_weights)
        wsum = weights.sum(axis=-1, keepdims=True)
        weights = np.where(wsum > 0, weights / np.maximum(wsum, 1e-8), weights)
    morph_targets = None
    morph_normals = None
    morph_tangents = None
    if n_targets:
        morph_targets = np.stack(
            [np.concatenate(chunks) for chunks in all_targets]
        ).astype(np.float32)  # (K,V,3) position deltas
        # NORMAL/TANGENT deltas (reference inherits full morph semantics
        # from l3d): only materialized when any primitive supplies them
        if any_morph_n:
            morph_normals = np.stack(
                [np.concatenate(chunks) for chunks in all_targets_n]
            ).astype(np.float32)
        if any_morph_t:
            morph_tangents = np.stack(
                [np.concatenate(chunks) for chunks in all_targets_t]
            ).astype(np.float32)
    mesh = build_mesh3d(
        pos,
        np.concatenate(all_idx).astype(np.int32),
        normals=nrm if has_normals else None,
        uvs=np.concatenate(all_uv),
        material_ids=np.concatenate(all_mat),
        joints=joints,
        weights=weights,
        name=gmesh.get("name", ""),
        morph_targets=morph_targets,
        morph_normals=morph_normals,
        morph_tangents=morph_tangents,
    )
    return mesh


class GltfLoader:
    extensions = (".gltf", ".glb")

    def load(self, path: str, materials: Materials) -> SceneDescriptor:
        g = _Gltf(path)
        tex_map = _load_textures(g, materials)
        mat_map = _load_materials(g, materials, tex_map)

        meshes = [_load_mesh(g, gm, mat_map) for gm in g.json.get("meshes", [])]

        nodes: List[NodeDescriptor] = []
        for gn in g.json.get("nodes", []):
            nd = NodeDescriptor(name=gn.get("name", ""))
            if "matrix" in gn:
                nd.matrix = (
                    np.asarray(gn["matrix"], np.float32).reshape(4, 4).T
                )  # glTF is column-major
            nd.translation = np.asarray(gn.get("translation", [0, 0, 0]), np.float32)
            nd.rotation = np.asarray(gn.get("rotation", [0, 0, 0, 1]), np.float32)
            nd.scale = np.asarray(gn.get("scale", [1, 1, 1]), np.float32)
            if "mesh" in gn:
                nd.mesh_ids = [gn["mesh"]]
            nd.skin_id = gn.get("skin", -1)
            nd.children = list(gn.get("children", []))
            nd.weights = list(gn.get("weights", []))
            if not nd.weights and "mesh" in gn:
                # glTF: node weights override the mesh's default weights
                nd.weights = list(g.json["meshes"][gn["mesh"]].get("weights", []))
            nodes.append(nd)

        scene_idx = g.json.get("scene", 0)
        scenes = g.json.get("scenes", [{}])
        roots = list(scenes[scene_idx].get("nodes", []))

        skins = []
        for gs in g.json.get("skins", []):
            ibm = (
                g.accessor(gs["inverseBindMatrices"])
                .astype(np.float32)
                .reshape(-1, 4, 4)
                .transpose(0, 2, 1)  # column-major -> row-major
                if "inverseBindMatrices" in gs
                else np.tile(np.eye(4, dtype=np.float32), (len(gs["joints"]), 1, 1))
            )
            skins.append(
                SkinDescriptor(
                    name=gs.get("name", ""),
                    joint_nodes=list(gs["joints"]),
                    inverse_bind_matrices=np.ascontiguousarray(ibm),
                )
            )

        animations = []
        for ga in g.json.get("animations", []):
            channels = []
            for ch in ga.get("channels", []):
                target = ch["target"]
                if "node" not in target:
                    continue
                sampler = ga["samplers"][ch["sampler"]]
                times = g.accessor(sampler["input"]).astype(np.float32).reshape(-1)
                values = g.accessor(sampler["output"]).astype(np.float32)
                channels.append(
                    AnimChannelDescriptor(
                        node=target["node"],
                        path=target["path"],
                        times=times,
                        values=values,
                        interpolation=sampler.get("interpolation", "LINEAR"),
                    )
                )
            animations.append(
                AnimationDescriptor(name=ga.get("name", ""), channels=channels)
            )

        _LOG.info(
            "loaded %s: %d meshes, %d nodes, %d skins, %d animations",
            path, len(meshes), len(nodes), len(skins), len(animations),
        )
        return SceneDescriptor(
            name=os.path.basename(path),
            meshes=meshes,
            nodes=nodes,
            roots=roots,
            skins=skins,
            animations=animations,
        )
