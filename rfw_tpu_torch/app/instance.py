"""Instance — the application runtime.

Reference: rfw/src/lib.rs:47-52,106-277 — `Instance` owns the ECS world,
scheduler, window/event loop, and a boxed Backend, with the builder API
(with_plugin/with_system/with_resource) and the frame loop
(:300-401: events -> scheduler stages -> synchronize -> render).

TPU re-architecture: headless-first. There is no winit window; `render_frame`
pumps one frame and returns the tonemapped array, `run(n_frames)` streams
frames to a sink (PNG sequence / ffmpeg pipe / callback). The
synchronize+render systems are registered at PostUpdate exactly like the
reference's RenderSystem plugin (rfw/src/system/mod.rs:238-242).

Host copy of `rfw_tpu/app/instance.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit; `save_png` writes with `utils/png.py` where the
original calls Pillow.
"""

from __future__ import annotations

import enum
import os
from typing import Callable, Optional, Protocol, Union

import numpy as np

from rfw_tpu_torch.app.ecs import Scheduler, Stage, World
from rfw_tpu_torch.app.events import Events
from rfw_tpu_torch.app.input import Input
from rfw_tpu_torch.app.timer import GameTimer
from rfw_tpu_torch.backend.contract import Backend, RenderMode
from rfw_tpu_torch.scene.camera import Camera2D, Camera3D
from rfw_tpu_torch.scene.scene import Scene
from rfw_tpu_torch.utils import log

_LOG = log.get("app")


class ScaleMode(enum.Enum):
    """Render-resolution scaling (reference ScaleMode,
    rfw/src/lib.rs — HighDPI renders at the window's physical resolution,
    Regular at logical, Custom(f) at an arbitrary factor)."""

    REGULAR = "regular"  # scale 1.0
    HIGH_DPI = "high_dpi"  # scale by the display's dpi factor
    CUSTOM = "custom"  # explicit factor

    def factor(self, dpi: float = 1.0, custom: float = 1.0) -> float:
        if self is ScaleMode.REGULAR:
            return 1.0
        if self is ScaleMode.HIGH_DPI:
            return float(dpi)
        return float(custom)


def _resolve_scale(scale: Union[float, ScaleMode], dpi: float = 1.0) -> float:
    if isinstance(scale, ScaleMode):
        return scale.factor(dpi=dpi)
    return float(scale)


class Plugin(Protocol):
    """(reference Plugin trait: init(world, scheduler, instance))"""

    def init(self, instance: "Instance") -> None:
        ...


class RenderSystem:
    """Backend wrapper resource (reference rfw/src/system/mod.rs:8-17)."""

    def __init__(self, backend: Backend, width: int, height: int) -> None:
        self.backend = backend
        self.width = width
        self.height = height
        self.mode = RenderMode.DEFAULT
        self.last_frame: Optional[np.ndarray] = None


class Instance:
    def __init__(
        self,
        backend: Backend,
        width: int = 1280,
        height: int = 720,
        scale: Union[float, "ScaleMode"] = 1.0,
        dpi: float = 1.0,
    ) -> None:
        log.init()
        scale = _resolve_scale(scale, dpi)
        self.world = World()
        self.scheduler = Scheduler()
        backend.resize(width, height, scale)

        self.render_system = RenderSystem(backend, width, height)
        self.world.insert(self.render_system)
        self.world.insert(Scene())
        self.world.insert(Camera3D())
        self.world.insert(Camera2D.from_width_height(width, height, scale))
        self.world.insert(GameTimer())
        self.world.insert(Input())

        # frame stages (reference PreUpdate timer/event systems + PostUpdate
        # synchronize_system/render_system)
        self.scheduler.add_system(self._pre_update, Stage.PRE_UPDATE)
        self.scheduler.add_system(self._synchronize_system, Stage.POST_UPDATE)
        self.scheduler.add_system(self._render_frame_system, Stage.POST_UPDATE)

    # ---- builder API (reference with_* builders) -----------------------
    def with_plugin(self, plugin: Plugin) -> "Instance":
        plugin.init(self)
        return self

    def with_system(self, system: Callable[[World], None], stage: Stage = Stage.UPDATE) -> "Instance":
        self.scheduler.add_system(system, stage)
        return self

    def with_startup_system(self, system: Callable[[World], None]) -> "Instance":
        self.scheduler.add_startup_system(system)
        return self

    def with_resource(self, resource) -> "Instance":
        self.world.insert(resource)
        return self

    # ---- accessors ------------------------------------------------------
    @property
    def scene(self) -> Scene:
        return self.world.get(Scene)

    @property
    def camera(self) -> Camera3D:
        return self.world.get(Camera3D)

    @property
    def backend(self) -> Backend:
        return self.render_system.backend

    def get_scene(self) -> Scene:
        return self.scene

    # ---- frame systems ---------------------------------------------------
    def _pre_update(self, world: World) -> None:
        world.get(GameTimer).tick()
        world.get(Input).update()
        for res in list(world._resources.values()):
            if isinstance(res, Events):
                res.update()

    def _synchronize_system(self, world: World) -> None:
        world.get(Scene).synchronize(self.render_system.backend)

    def _render_frame_system(self, world: World) -> None:
        cam3 = world.get(Camera3D)
        cam2 = world.get(Camera2D)
        rs = self.render_system
        view3 = cam3.get_view(rs.width, rs.height)
        rs.last_frame = rs.backend.render(cam2.get_view(), view3, rs.mode)

    # ---- pumping ---------------------------------------------------------
    def render_frame(self, mode: Optional[RenderMode] = None) -> np.ndarray:
        """Run one full frame (all stages) and return the rendered image."""
        if mode is not None:
            self.render_system.mode = mode
        self.scheduler.run(self.world)
        return self.render_system.last_frame

    def run(
        self,
        frames: int,
        sink: Optional[Callable[[int, np.ndarray], None]] = None,
    ) -> None:
        """Frame loop (replaces the winit event loop, rfw/src/lib.rs:300-401)."""
        for i in range(frames):
            frame = self.render_frame()
            if sink is not None:
                sink(i, frame)

    def run_windowed(self, window, max_frames: Optional[int] = None) -> int:
        """The poll event loop (reference rfw/src/lib.rs:300-401): drain
        window events into the Events resources, let the ResizeEvent
        system resize the backend, run the scheduler on RedrawRequested,
        present the frame, request the next redraw on MainEventsCleared.

        `window` is any WindowHandle (HeadlessWindow for scripted runs,
        BrowserWindow for a live interactive session). Returns the number
        of presented frames; the loop ends on CloseRequested/Destroyed
        (or after `max_frames`)."""
        from rfw_tpu_torch.app.window import (
            CloseRequested, Destroyed, DeviceEvent, DeviceEvents,
            InputBundle, KeyState, ResizeEvent, ResizeEvents, Resized,
            ScaleFactorChanged, WindowEvent, WindowEvents,
        )

        if self.world.try_get(KeyState) is None:
            self.with_plugin(InputBundle())
            self.scheduler.add_system(self._resize_event_system,
                                      Stage.PRE_UPDATE)
        wevents: WindowEvents = self.world.get(WindowEvents)
        devents: DeviceEvents = self.world.get(DeviceEvents)
        revents: ResizeEvents = self.world.get(ResizeEvents)

        # initial ResizeEvent with the window's real size/scale
        # (reference lib.rs:320-329)
        w, h = window.inner_size()
        scale = window.scale_factor()
        revents.push(ResizeEvent(w, h, scale))

        frames = 0
        closing = False
        while not closing:
            for ev in window.poll_events():
                if isinstance(ev, DeviceEvent):
                    devents.push(ev)
                    continue
                if not isinstance(ev, WindowEvent):
                    _LOG.warning("unknown event %r dropped", ev)
                    continue
                if isinstance(ev, (CloseRequested, Destroyed)):
                    closing = True
                elif isinstance(ev, Resized):
                    revents.push(ResizeEvent(ev.width, ev.height, scale))
                elif isinstance(ev, ScaleFactorChanged):
                    scale = ev.scale_factor
                    revents.push(ResizeEvent(ev.width, ev.height, scale))
                wevents.push(ev)
            if closing:
                break
            # MainEventsCleared -> request_redraw; RedrawRequested ->
            # scheduler.run + present (the swapchain blit)
            window.request_redraw()
            if window.take_redraw():
                self.scheduler.run(self.world)
                window.present(self.render_system.last_frame)
                frames += 1
            if max_frames is not None and frames >= max_frames:
                break
        window.close()
        return frames

    def _resize_event_system(self, world: World) -> None:
        """Apply queued ResizeEvents to the backend (the reference routes
        winit resizes through the ResizeEvent resource into its render
        system rather than resizing inline)."""
        from rfw_tpu_torch.app.window import ResizeEvents

        last = None
        for ev in world.get(ResizeEvents).iter():
            last = ev
        if last is not None and (
            self.render_system.width != int(last.width * last.scale)
            or self.render_system.height != int(last.height * last.scale)
        ):
            self.resize(last.width, last.height, last.scale)

    def save_png(self, path: str) -> None:
        from rfw_tpu_torch.utils.png import write_png

        if self.render_system.last_frame is None:
            self.render_frame()
        write_png(path, self.render_system.last_frame)
        _LOG.info("saved %s", path)

    def resize(self, width: int, height: int,
               scale: Union[float, "ScaleMode"] = 1.0,
               dpi: float = 1.0) -> None:
        scale = _resolve_scale(scale, dpi)
        self.render_system.width = int(width * scale)
        self.render_system.height = int(height * scale)
        self.backend.resize(width, height, scale)
        self.world.insert(Camera2D.from_width_height(width, height, scale))
