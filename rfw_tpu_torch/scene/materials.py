"""Material + texture store.

Reference: crates/rfw-scene/src/material/list.rs:19-814 — `Materials` holds
TrackedStorage<Material> + TrackedStorage<Texture>, an emissive `light_flags`
BitVec (any color channel > 1 => treated as an area-light emitter,
list.rs:494), a texture-path dedup map, a reverse texture->material
dependency map (texture edit re-flags dependent materials :599-605), mipmap
generation on push (:517-527), and float->u32 device packing (:683-814).

TPU re-design: the Material stays a host dataclass; device lowering produces
the float SoA block of `rfw_tpu_torch.backend.structs.DeviceMaterials` (no 8-bit
packing — gathers want flat float columns). Textures carry full mip chains
as uint8 RGBA arrays; the backend flattens them into a device atlas.

Host copy of `rfw_tpu/scene/materials.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit. Where the original calls Pillow (decoding a texture
file, resizing to powers of two, matching metallic-roughness sizes), this
copy calls `rfw_tpu_torch.utils.image`, which computes Pillow's arrays
without it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from rfw_tpu_torch.backend.structs import (
    DeviceMaterials,
    MATFLAG_EMISSIVE,
    MATFLAG_HAS_DIFFUSE_MAP,
    MATFLAG_HAS_EMISSIVE_MAP,
    MATFLAG_HAS_METALLIC_MAP,
    MATFLAG_HAS_NORMAL_MAP,
    MATFLAG_HAS_ROUGHNESS_MAP,
    MATFLAG_HAS_SHEEN_MAP,
    TextureView,
)
from rfw_tpu_torch.utils.collections import TrackedStorage
from rfw_tpu_torch.utils import log
from rfw_tpu_torch.utils.image import read_image, resize_rgba

_LOG = log.get("materials")

MIN_TEXTURE_SIZE = 64  # reference enforces >=64px on push (list.rs:517-527)


# ------------------------------------------------------------------ textures
def _to_pow2(img: np.ndarray) -> np.ndarray:
    """Round dimensions up to powers of two (>= MIN_TEXTURE_SIZE) with
    Pillow's bilinear resampling so mip chains divide evenly."""
    h, w = img.shape[:2]

    def pow2(x: int) -> int:
        p = MIN_TEXTURE_SIZE
        while p < x:
            p *= 2
        return p

    nh, nw = pow2(h), pow2(w)
    if (nh, nw) == (h, w):
        return img
    return resize_rgba(img, (nw, nh), "bilinear")


def generate_mips(base: np.ndarray) -> List[np.ndarray]:
    """Box-filter mip chain down to 1x1 (reference l3d mipmap gen).

    Axes reduce independently so non-square chains (e.g. 4x1) stay valid."""
    mips = [base]
    cur = base.astype(np.float32)
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape[:2]
        if h > 1:
            nh = h // 2
            cur = 0.5 * (cur[0 : 2 * nh : 2] + cur[1 : 2 * nh : 2])
        if w > 1:
            nw = w // 2
            cur = 0.5 * (cur[:, 0 : 2 * nw : 2] + cur[:, 1 : 2 * nw : 2])
        mips.append(np.clip(cur + 0.5, 0, 255).astype(np.uint8))
    return mips


@dataclass
class Texture:
    """RGBA8 texture + mips. `srgb` marks color data (albedo/emissive);
    linear for normal/metalness maps."""

    mips: List[np.ndarray]
    path: Optional[str] = None
    srgb: bool = True

    @staticmethod
    def from_array(rgba: np.ndarray, path: Optional[str] = None, srgb: bool = True) -> "Texture":
        rgba = np.ascontiguousarray(rgba)
        if rgba.ndim == 2:
            rgba = np.stack([rgba] * 3 + [np.full_like(rgba, 255)], axis=-1)
        if rgba.shape[-1] == 3:
            rgba = np.concatenate(
                [rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)], axis=-1
            )
        rgba = _to_pow2(rgba.astype(np.uint8))
        return Texture(mips=generate_mips(rgba), path=path, srgb=srgb)

    @staticmethod
    def load(path: str, srgb: bool = True) -> "Texture":
        """Decode a PNG or JPEG file (chosen by its magic number)."""
        return Texture.from_array(read_image(path), path=path, srgb=srgb)

    @staticmethod
    def solid(rgba: Sequence[float], size: int = MIN_TEXTURE_SIZE) -> "Texture":
        px = np.clip(np.asarray(rgba, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        return Texture.from_array(np.tile(px, (size, size, 1)))

    @property
    def width(self) -> int:
        return self.mips[0].shape[1]

    @property
    def height(self) -> int:
        return self.mips[0].shape[0]

    def view(self) -> TextureView:
        return TextureView(mips=self.mips, srgb=self.srgb)

    def merge_metallic_roughness(self, other: Optional["Texture"]) -> "Texture":
        """Combine metallic (B) and roughness (G) maps into one texture,
        glTF layout (reference obj.rs merges map_pm/map_pr similarly)."""
        if other is None:
            return self
        a, b = self.mips[0], other.mips[0]
        if a.shape != b.shape:  # Pillow's default resize filter
            b = resize_rgba(b, (a.shape[1], a.shape[0]), "bicubic")
        out = a.copy()
        out[..., 2] = b[..., 2]
        return Texture.from_array(out, srgb=False)


# ----------------------------------------------------------------- materials
@dataclass
class Material:
    """Disney-principled material (reference Material + DeviceMaterial fields)."""

    name: str = ""
    color: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    specular: np.ndarray = field(default_factory=lambda: np.full(4, 0.5, np.float32))
    absorption: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    metallic: float = 0.0
    subsurface: float = 0.0
    specular_f: float = 0.5
    roughness: float = 0.5
    specular_tint: float = 0.0
    anisotropic: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    transmission: float = 0.0
    eta: float = 1.45
    custom0: float = 0.0
    custom1: float = 0.0
    custom2: float = 0.0
    custom3: float = 0.0
    # texture slots (indices into the Materials texture storage; -1 = none)
    diffuse_tex: int = -1
    normal_tex: int = -1
    metallic_roughness_tex: int = -1
    emissive_tex: int = -1
    sheen_tex: int = -1
    custom_tex: int = -1
    double_sided: bool = True

    @property
    def is_emissive(self) -> bool:
        """Any color channel > 1 => emissive (reference list.rs:494)."""
        return bool((self.color[:3] > 1.0).any())

    @property
    def emission(self) -> np.ndarray:
        """Emitted radiance: the color itself when emissive (reference
        treats color as radiance for emitters)."""
        return self.color[:3].astype(np.float32)


class Materials:
    """Material + texture storage with change tracking and dedup."""

    def __init__(self) -> None:
        self.materials: TrackedStorage[Material] = TrackedStorage()
        self.textures: TrackedStorage[Texture] = TrackedStorage()
        self._tex_by_path: Dict[str, int] = {}
        self._tex_to_mats: Dict[int, Set[int]] = {}
        # slot 0: default white material + default texture, like the reference
        self.push(Material(name="default"))
        self.push_texture(Texture.solid((1.0, 1.0, 1.0, 1.0)))

    # ---- materials ----------------------------------------------------
    def push(self, mat: Material) -> int:
        idx = self.materials.push(mat)
        for t in self._mat_textures(mat):
            self._tex_to_mats.setdefault(t, set()).add(idx)
        _LOG.info("added material %d (%s)", idx, mat.name)
        return idx

    def get(self, idx: int) -> Material:
        return self.materials[idx]

    def get_mut(self, idx: int) -> Material:
        return self.materials.get_mut(idx)

    def __len__(self) -> int:
        return len(self.materials)

    @staticmethod
    def _mat_textures(mat: Material) -> List[int]:
        return [
            t
            for t in (
                mat.diffuse_tex, mat.normal_tex, mat.metallic_roughness_tex,
                mat.emissive_tex, mat.sheen_tex, mat.custom_tex,
            )
            if t >= 0
        ]

    # ---- textures -----------------------------------------------------
    def push_texture(self, tex: Texture) -> int:
        if tex.path:
            key = os.path.abspath(tex.path)
            if key in self._tex_by_path:
                return self._tex_by_path[key]
        idx = self.textures.push(tex)
        if tex.path:
            self._tex_by_path[os.path.abspath(tex.path)] = idx
        return idx

    def load_texture(self, path: str, srgb: bool = True) -> int:
        key = os.path.abspath(path)
        if key in self._tex_by_path:
            return self._tex_by_path[key]
        return self.push_texture(Texture.load(path, srgb=srgb))

    def touch_texture(self, idx: int) -> None:
        """Mark texture changed and re-flag dependent materials
        (reference list.rs:599-605)."""
        self.textures.touch(idx)
        for m in self._tex_to_mats.get(idx, ()):
            self.materials.touch(m)

    # ---- lowering -----------------------------------------------------
    def light_flags(self) -> np.ndarray:
        """Per-slot emissive bit (reference light_flags BitVec)."""
        cap = self.materials.capacity
        out = np.zeros(cap, bool)
        for i, m in self.materials:
            out[i] = m.is_emissive
        return out

    def emission_table(self) -> np.ndarray:
        """(cap,3) emitted radiance per slot (zeros for non-emitters) — lets
        area-light extraction gather per-triangle radiance in one indexed
        read instead of a python loop per emissive triangle."""
        cap = self.materials.capacity
        out = np.zeros((cap, 3), np.float32)
        for i, m in self.materials:
            if m.is_emissive:
                out[i] = m.emission
        return out

    def to_device(self) -> DeviceMaterials:
        """Lower all materials to the SoA device block
        (reference update_device_materials/into_device_material :683-814)."""
        cap = max(1, self.materials.capacity)
        color = np.zeros((cap, 4), np.float32)
        specular = np.zeros((cap, 4), np.float32)
        absorption = np.zeros((cap, 4), np.float32)
        params = np.zeros((cap, 16), np.float32)
        flags = np.zeros(cap, np.int32)
        tex = np.full((cap, 6), -1, np.int32)
        color[:, 3] = 1.0
        for i, m in self.materials:
            color[i] = m.color
            specular[i] = m.specular
            absorption[i] = m.absorption
            params[i] = [
                m.metallic, m.subsurface, m.specular_f, m.roughness,
                m.specular_tint, m.anisotropic, m.sheen, m.sheen_tint,
                m.clearcoat, m.clearcoat_gloss, m.transmission, m.eta,
                m.custom0, m.custom1, m.custom2, m.custom3,
            ]
            f = 0
            if m.diffuse_tex >= 0:
                f |= MATFLAG_HAS_DIFFUSE_MAP
            if m.normal_tex >= 0:
                f |= MATFLAG_HAS_NORMAL_MAP
            if m.metallic_roughness_tex >= 0:
                f |= MATFLAG_HAS_ROUGHNESS_MAP | MATFLAG_HAS_METALLIC_MAP
            if m.emissive_tex >= 0:
                f |= MATFLAG_HAS_EMISSIVE_MAP
            if m.sheen_tex >= 0:
                f |= MATFLAG_HAS_SHEEN_MAP
            if m.is_emissive:
                f |= MATFLAG_EMISSIVE
            flags[i] = f
            tex[i] = [
                m.diffuse_tex, m.normal_tex, m.metallic_roughness_tex,
                m.emissive_tex, m.sheen_tex, m.custom_tex,
            ]
        return DeviceMaterials(
            color=color, specular=specular, absorption=absorption,
            params=params, flags=flags, tex=tex,
        ).validate()

    @property
    def any_changed(self) -> bool:
        return self.materials.any_changed or self.textures.any_changed

    def reset_changed(self) -> None:
        self.materials.reset_changed()
        self.textures.reset_changed()
