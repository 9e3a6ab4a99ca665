"""The Backend contract: scene -> renderer boundary (copy of
`rfw_tpu/backend/contract.py`).

The reference defines a 14-method `Backend` trait
(crates/rfw-backend/src/lib.rs:35-82): set_{2d,3d}_mesh, set_{2d,3d}_instances,
unload_3d_meshes, set_materials, set_textures, set_{point,spot,area,
directional}_lights, set_skins, set_skybox, synchronize, render, resize.
The protocol batches `set_*` per-slot calls into (index, view) lists.

Implementations here:
  * rfw_tpu_torch.render.torch_backend.TorchBackend — the path tracer.
`rfw_tpu`'s `RecordingBackend`, the test fake that records the sync
stream, is not copied: the port's tests record with `rfw_tpu`'s.
"""

from __future__ import annotations

import enum
from typing import Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from rfw_tpu_torch.backend.lights import (
    AreaLightsView,
    DirectionalLightsView,
    PointLightsView,
    SpotLightsView,
)
from rfw_tpu_torch.backend.structs import (
    CameraView2D,
    CameraView3D,
    DeviceMaterials,
    InstancesView2D,
    InstancesView3D,
    MeshView2D,
    MeshView3D,
    SkinView,
    TextureView,
)


class RenderMode(enum.Enum):
    """Debug AOV views (reference RenderMode, rfw-backend/src/lib.rs:9-24).

    In a wavefront path tracer every AOV is a film channel; modes select
    which channel the tonemapped output shows.
    """

    DEFAULT = 0
    RESET = 1  # restart progressive accumulation (reference gpu-rt semantics)
    NORMAL = 2
    ALBEDO = 3
    GBUFFER = 4  # depth/t
    SCREEN_SPACE = 5  # hit position
    SSAO = 6  # ambient-occlusion-ish: 1-bounce visibility
    FILTERED_SSAO = 7


@runtime_checkable
class Backend(Protocol):
    """Stateless device cache fed by per-frame deltas from the scene layer."""

    # ---- geometry ----------------------------------------------------
    def set_3d_meshes(self, changed: Sequence[Tuple[int, MeshView3D]]) -> None:
        ...

    def unload_3d_meshes(self, ids: Sequence[int]) -> None:
        ...

    def set_3d_instances(self, changed: Sequence[Tuple[int, InstancesView3D]]) -> None:
        """`changed` pairs (mesh_id, instances for that mesh)."""
        ...

    def set_2d_meshes(self, changed: Sequence[Tuple[int, MeshView2D]]) -> None:
        ...

    def set_2d_instances(self, changed: Sequence[Tuple[int, InstancesView2D]]) -> None:
        ...

    # ---- appearance --------------------------------------------------
    def set_materials(self, materials: DeviceMaterials, changed: Sequence[int]) -> None:
        ...

    def set_textures(self, changed: Sequence[Tuple[int, TextureView]]) -> None:
        ...

    def set_skybox(self, skybox: Optional[TextureView]) -> None:
        ...

    # ---- lights ------------------------------------------------------
    def set_point_lights(self, lights: PointLightsView) -> None:
        ...

    def set_spot_lights(self, lights: SpotLightsView) -> None:
        ...

    def set_area_lights(self, lights: AreaLightsView) -> None:
        ...

    def set_directional_lights(self, lights: DirectionalLightsView) -> None:
        ...

    # ---- animation ---------------------------------------------------
    def set_skins(self, changed: Sequence[Tuple[int, SkinView]]) -> None:
        ...

    # ---- frame -------------------------------------------------------
    def synchronize(self) -> None:
        """Flush staged deltas into device buffers (arena repack, BVH
        build/refit, TLAS rebuild) — reference `Backend::synchronize`."""
        ...

    def render(
        self,
        view_2d: Optional[CameraView2D],
        view_3d: CameraView3D,
        mode: RenderMode = RenderMode.DEFAULT,
    ) -> np.ndarray:
        """Render one frame; returns (H,W,4) uint8 on host.

        Unlike the reference (presents to a swapchain) the backend returns
        the tonemapped frame for the host to stream/save."""
        ...

    def resize(self, width: int, height: int, scale: float = 1.0) -> None:
        ...

    # ---- construction --------------------------------------------------
    # Every implementation also provides the FromWindowHandle ctor
    # (reference rfw-backend/src/lib.rs:26-33) as a classmethod:
    #   Backend.from_window_handle(window, width=None, height=None,
    #                              scale=None, settings=None)
    # see init_from_window_handle below for the shared semantics.


def init_from_window_handle(backend_cls, window, width: Optional[int] = None,
                            height: Optional[int] = None,
                            scale: Optional[float] = None, settings=None,
                            **ctor_kwargs):
    """`FromWindowHandle::init` (reference rfw-backend/src/lib.rs:26-33):
    construct a backend sized to a window handle. `window` is any
    object with `inner_size()` and `scale_factor()` (they stand in for the
    raw OS handle — the renderer returns host arrays that the window
    provider presents, not a surface). Explicit width/height/
    scale override the window's, matching the reference signature.
    `ctor_kwargs` (e.g. `device`) go to the backend's constructor."""
    w, h = window.inner_size()
    width = int(width if width is not None else w)
    height = int(height if height is not None else h)
    scale = float(scale if scale is not None else window.scale_factor())
    backend = (backend_cls(width, height, settings, **ctor_kwargs)
               if settings is not None
               else backend_cls(width, height, **ctor_kwargs))
    backend.resize(width, height, scale)
    return backend

