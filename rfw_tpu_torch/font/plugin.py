"""Backend-agnostic font rendering plugin.

Reference: crates/rfw-font/src/lib.rs:1-327 — glyph_brush layout writes
glyph alpha into a dynamic texture (`process_queued` poking tex_data
:174-196) and rebuilds a 2D quad mesh per draw; registered as a Plugin with
an update system; never touches a backend directly (that is what
"backend-agnostic" means — it only writes Scene 2D state).

TPU rebuild: PIL rasterizes the TTF into a glyph atlas texture (grown on
TextureTooSmall just like the reference), layout produces one textured
quad per glyph into a single Mesh2D. Queued sections are flushed by the
update system each frame.

Host copy of `rfw_tpu/font/plugin.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.

One deviation: the original's `DEFAULT_FONT` points at an asset of the
reference checkout, which a user of the port does not have. Here
`FontPlugin` needs its `font_path` and raises a `ValueError` without one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from rfw_tpu_torch.models.mesh2d import Mesh2D
from rfw_tpu_torch.scene.materials import Texture
from rfw_tpu_torch.scene.scene import Scene
from rfw_tpu_torch.utils import log

_LOG = log.get("font")


@dataclass
class Text:
    text: str
    px: float = 24.0
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


@dataclass
class Section:
    screen_position: Tuple[float, float] = (0.0, 0.0)
    texts: List[Text] = field(default_factory=list)


class _GlyphAtlas:
    """Grows-on-demand alpha atlas (reference TextureTooSmall resize)."""

    def __init__(self, font_path: str, size: int = 512) -> None:
        self.font_path = font_path
        self.size = size
        self.image = np.zeros((size, size), np.uint8)
        self.cursor_x = 0
        self.cursor_y = 0
        self.row_h = 0
        self.entries: Dict[Tuple[str, int], Tuple[int, int, int, int, dict]] = {}
        self._fonts: Dict[int, "object"] = {}
        self.dirty = True

    def _font(self, px: int):
        if px not in self._fonts:
            from PIL import ImageFont

            self._fonts[px] = ImageFont.truetype(self.font_path, px)
        return self._fonts[px]

    def glyph(self, ch: str, px: int):
        key = (ch, px)
        if key in self.entries:
            return self.entries[key]
        from PIL import Image, ImageDraw

        font = self._font(px)
        # render glyph to a temp image
        l, t, r, b = font.getbbox(ch)
        w, h = max(r - l, 1), max(b - t, 1)
        tmp = Image.new("L", (w, h), 0)
        ImageDraw.Draw(tmp).text((-l, -t), ch, fill=255, font=font)
        arr = np.asarray(tmp)

        if self.cursor_x + w + 1 >= self.size:
            self.cursor_x = 0
            self.cursor_y += self.row_h + 1
            self.row_h = 0
        if self.cursor_y + h + 1 >= self.size:
            self._grow()
            return self.glyph(ch, px)

        x, y = self.cursor_x, self.cursor_y
        self.image[y : y + h, x : x + w] = arr
        self.cursor_x += w + 1
        self.row_h = max(self.row_h, h)
        try:
            advance = font.getlength(ch)
        except Exception:
            advance = w
        meta = dict(bearing_x=l, bearing_y=t, advance=advance)
        self.entries[key] = (x, y, w, h, meta)
        self.dirty = True
        return self.entries[key]

    def _grow(self) -> None:
        new = np.zeros((self.size * 2, self.size * 2), np.uint8)
        new[: self.size, : self.size] = self.image
        # old UVs shift; simplest correct behavior: drop cache, re-render
        self.size *= 2
        self.image = new
        self.entries.clear()
        self.cursor_x = self.cursor_y = self.row_h = 0
        self.dirty = True
        _LOG.info("glyph atlas grown to %d", self.size)

    def texture(self) -> Texture:
        rgba = np.stack([np.full_like(self.image, 255)] * 3 + [self.image], axis=-1)
        return Texture.from_array(rgba, srgb=False)


class FontPlugin:
    """Queue sections with draw(); the update system flushes them into a
    Scene 2D mesh once per frame (reference Plugin::init + update system)."""

    def __init__(self, font_path: Optional[str] = None, atlas_size: int = 512) -> None:
        if font_path is None:
            raise ValueError("FontPlugin needs font_path: the path of a TrueType font file")
        self.atlas = _GlyphAtlas(font_path, atlas_size)
        self._queue: List[Section] = []
        self._mesh_id: Optional[int] = None
        self._tex_id: Optional[int] = None
        self._instance = None

    # Plugin protocol
    def init(self, instance) -> None:
        from rfw_tpu_torch.app.ecs import Stage

        instance.with_resource(self)
        instance.with_system(self._update_system, Stage.UPDATE)
        self._instance = instance

    def draw(self, section: Section) -> None:
        self._queue.append(section)

    def _update_system(self, world) -> None:
        scene = world.get(Scene)
        self.flush(scene)

    def flush(self, scene: Scene) -> None:
        """Build the text mesh for this frame's queued sections."""
        if not self._queue and self._mesh_id is None:
            return
        positions: List[np.ndarray] = []
        uvs: List[np.ndarray] = []
        colors: List[np.ndarray] = []

        for sec in self._queue:
            pen_x, pen_y = sec.screen_position
            for t in sec.texts:
                px = int(round(t.px))
                ascent = px  # approximation: bbox-based baseline
                for ch in t.text:
                    if ch == "\n":
                        pen_x = sec.screen_position[0]
                        pen_y += px * 1.2
                        continue
                    if ch == " ":
                        pen_x += px * 0.4
                        continue
                    x, y, w, h, meta = self.atlas.glyph(ch, px)
                    gx = pen_x + meta["bearing_x"]
                    gy = pen_y + meta["bearing_y"]
                    s = self.atlas.size
                    u0, v0 = x / s, y / s
                    u1, v1 = (x + w) / s, (y + h) / s
                    quad = np.array(
                        [
                            [gx, gy, 0], [gx + w, gy, 0], [gx + w, gy + h, 0],
                            [gx, gy, 0], [gx + w, gy + h, 0], [gx, gy + h, 0],
                        ],
                        np.float32,
                    )
                    quv = np.array(
                        [[u0, v0], [u1, v0], [u1, v1], [u0, v0], [u1, v1], [u0, v1]],
                        np.float32,
                    )
                    positions.append(quad)
                    uvs.append(np.asarray(quv, np.float32))
                    colors.append(np.tile(np.asarray(t.color, np.float32), (6, 1)))
                    pen_x += meta["advance"]
        self._queue.clear()

        if self.atlas.dirty:
            tex = self.atlas.texture()
            if self._tex_id is None:
                self._tex_id = scene.add_texture(tex)
            else:
                scene.materials.textures.overwrite(self._tex_id, tex)
                scene.materials.touch_texture(self._tex_id)
            self.atlas.dirty = False

        if positions:
            mesh = Mesh2D.new(
                np.concatenate(positions),
                np.concatenate(uvs),
                np.concatenate(colors),
                texture_id=self._tex_id if self._tex_id is not None else -1,
                name="font",
            )
        else:
            mesh = Mesh2D.new(np.zeros((0, 3), np.float32), texture_id=-1, name="font")
        if self._mesh_id is None:
            self._mesh_id = scene.add_2d_object(mesh)
            scene.add_2d_instance(self._mesh_id)
        else:
            scene.set_2d_object(self._mesh_id, mesh)
