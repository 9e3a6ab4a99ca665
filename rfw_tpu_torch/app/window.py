"""Windowing: event mirror + window-handle providers.

Reference: rfw/src/window.rs:20-345 mirrors winit's WindowEvent/
DeviceEvent enums into ECS resources and ships an `InputBundle` whose
PreUpdate systems fill `Input<VirtualKeyCode>` / `Input<MouseButton>`;
rfw/src/lib.rs:300-401 is the winit poll loop (window events -> Events
resources, RedrawRequested -> scheduler.run, MainEventsCleared ->
request_redraw); crates/rfw-backend/src/lib.rs:26-33 is
`FromWindowHandle` (backend constructed from a raw window handle).

TPU re-architecture: there is no winit/OS window on a headless TPU host,
so the "raw window handle" becomes a small `WindowHandle` protocol —
poll_events / present / request_redraw / inner_size / scale_factor —
with two providers:

  * `HeadlessWindow` — scripted event source + frame sink. Drives the
    full poll loop deterministically in tests and batch runs.
  * `BrowserWindow` — an actually interactive window on a headless
    host: a stdlib HTTP server streams the presented frames to a canvas
    page and maps browser key/mouse/wheel events back into the winit
    mirror. Zero dependencies: frames are encoded by the stdlib PNG
    writer of `utils/png.py`.

`Instance.run_windowed(window)` (instance.py) is the poll loop;
`Backend.from_window_handle` (backend/contract.py) is the B2 ctor seam.

Host copy of `rfw_tpu/app/window.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit; `BrowserWindow.present` encodes with
`utils/png.py` where the original calls Pillow.
"""

from __future__ import annotations

import enum
import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from rfw_tpu_torch.app.events import Events
from rfw_tpu_torch.app.input import Input
from rfw_tpu_torch.utils import log

_LOG = log.get("window")


class ElementState(enum.Enum):
    PRESSED = 0
    RELEASED = 1


class MouseButton(enum.Enum):
    LEFT = 0
    RIGHT = 1
    MIDDLE = 2
    BACK = 3
    FORWARD = 4
    OTHER = 5


# winit's VirtualKeyCode list (reference re-exports it verbatim,
# window.rs:11 `pub use winit::event::VirtualKeyCode`)
VirtualKeyCode = enum.Enum("VirtualKeyCode", [
    "Key1", "Key2", "Key3", "Key4", "Key5", "Key6", "Key7", "Key8",
    "Key9", "Key0",
    "A", "B", "C", "D", "E", "F", "G", "H", "I", "J", "K", "L", "M",
    "N", "O", "P", "Q", "R", "S", "T", "U", "V", "W", "X", "Y", "Z",
    "Escape",
    "F1", "F2", "F3", "F4", "F5", "F6", "F7", "F8", "F9", "F10", "F11",
    "F12", "F13", "F14", "F15", "F16", "F17", "F18", "F19", "F20",
    "F21", "F22", "F23", "F24",
    "Snapshot", "Scroll", "Pause",
    "Insert", "Home", "Delete", "End", "PageDown", "PageUp",
    "Left", "Up", "Right", "Down",
    "Back", "Return", "Space", "Compose", "Caret", "Numlock",
    "Numpad0", "Numpad1", "Numpad2", "Numpad3", "Numpad4", "Numpad5",
    "Numpad6", "Numpad7", "Numpad8", "Numpad9",
    "NumpadAdd", "NumpadDivide", "NumpadDecimal", "NumpadComma",
    "NumpadEnter", "NumpadEquals", "NumpadMultiply", "NumpadSubtract",
    "AbntC1", "AbntC2", "Apostrophe", "Apps", "Asterisk", "At", "Ax",
    "Backslash", "Calculator", "Capital", "Colon", "Comma", "Convert",
    "Equals", "Grave", "Kana", "Kanji",
    "LAlt", "LBracket", "LControl", "LShift", "LWin",
    "Mail", "MediaSelect", "MediaStop", "Minus", "Mute", "MyComputer",
    "NavigateForward", "NavigateBackward", "NextTrack", "NoConvert",
    "OEM102", "Period", "PlayPause", "Plus", "Power", "PrevTrack",
    "RAlt", "RBracket", "RControl", "RShift", "RWin",
    "Semicolon", "Slash", "Sleep", "Stop", "Sysrq", "Tab", "Underline",
    "Unlabeled", "VolumeDown", "VolumeUp", "Wake",
    "WebBack", "WebFavorites", "WebForward", "WebHome", "WebRefresh",
    "WebSearch", "WebStop", "Yen", "Copy", "Paste", "Cut",
])


# ---------------------------------------------------------------------------
# WindowEvent mirror (reference window.rs:73-218). Python variant classes
# instead of one Rust enum; `isinstance(ev, WindowEvent)` routes them.
# ---------------------------------------------------------------------------
class WindowEvent:
    """Base class for all window events."""


@dataclass(frozen=True)
class Suspended(WindowEvent):
    pass


@dataclass(frozen=True)
class Resumed(WindowEvent):
    pass


@dataclass(frozen=True)
class RedrawRequested(WindowEvent):
    pass


@dataclass(frozen=True)
class Resized(WindowEvent):
    width: int
    height: int


@dataclass(frozen=True)
class Moved(WindowEvent):
    x: int
    y: int


@dataclass(frozen=True)
class CloseRequested(WindowEvent):
    pass


@dataclass(frozen=True)
class Destroyed(WindowEvent):
    pass


@dataclass(frozen=True)
class DroppedFile(WindowEvent):
    path: str


@dataclass(frozen=True)
class HoveredFile(WindowEvent):
    path: str


@dataclass(frozen=True)
class HoveredFileCancelled(WindowEvent):
    pass


@dataclass(frozen=True)
class ReceivedCharacter(WindowEvent):
    char: str


@dataclass(frozen=True)
class Focused(WindowEvent):
    focused: bool


@dataclass(frozen=True)
class KeyboardInput(WindowEvent):
    state: ElementState
    virtual_keycode: Optional[VirtualKeyCode]
    scancode: int = 0
    is_synthetic: bool = False


@dataclass(frozen=True)
class ModifiersChanged(WindowEvent):
    shift: bool = False
    ctrl: bool = False
    alt: bool = False
    logo: bool = False


@dataclass(frozen=True)
class CursorMoved(WindowEvent):
    x: float
    y: float


@dataclass(frozen=True)
class CursorEntered(WindowEvent):
    pass


@dataclass(frozen=True)
class CursorLeft(WindowEvent):
    pass


@dataclass(frozen=True)
class MouseWheel(WindowEvent):
    delta_x: float
    delta_y: float
    pixel_delta: bool = False  # winit MouseScrollDelta::{Line,Pixel}Delta


@dataclass(frozen=True)
class MouseInput(WindowEvent):
    state: ElementState
    button: MouseButton


@dataclass(frozen=True)
class TouchpadPressure(WindowEvent):
    pressure: float
    stage: int


@dataclass(frozen=True)
class AxisMotion(WindowEvent):
    axis: int
    value: float


@dataclass(frozen=True)
class Touch(WindowEvent):
    phase: str  # started/moved/ended/cancelled
    x: float
    y: float
    finger: int = 0


@dataclass(frozen=True)
class ScaleFactorChanged(WindowEvent):
    scale_factor: float
    width: int
    height: int


@dataclass(frozen=True)
class ThemeChanged(WindowEvent):
    theme: str  # "light" | "dark"


# ---------------------------------------------------------------------------
# DeviceEvent mirror (reference window.rs:303-345)
# ---------------------------------------------------------------------------
class DeviceEvent:
    """Base class for raw device events (not window-relative)."""


@dataclass(frozen=True)
class DeviceAdded(DeviceEvent):
    device_id: int = 0


@dataclass(frozen=True)
class DeviceRemoved(DeviceEvent):
    device_id: int = 0


@dataclass(frozen=True)
class MouseMotion(DeviceEvent):
    dx: float
    dy: float
    device_id: int = 0


@dataclass(frozen=True)
class DeviceMouseWheel(DeviceEvent):
    delta_x: float
    delta_y: float
    device_id: int = 0


@dataclass(frozen=True)
class Motion(DeviceEvent):
    axis: int
    value: float
    device_id: int = 0


@dataclass(frozen=True)
class DeviceButton(DeviceEvent):
    button: int
    state: ElementState
    device_id: int = 0


@dataclass(frozen=True)
class DeviceKey(DeviceEvent):
    scancode: int
    state: ElementState
    virtual_keycode: Optional[VirtualKeyCode] = None
    device_id: int = 0


@dataclass(frozen=True)
class DeviceText(DeviceEvent):
    char: str
    device_id: int = 0


# ---------------------------------------------------------------------------
# ECS resources. World keys resources by TYPE, so each queue/state gets a
# concrete subclass (the reference's Events<WindowEvent> generic).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ResizeEvent:
    width: int
    height: int
    scale: float


class WindowEvents(Events):
    """Events[WindowEvent] resource."""


class DeviceEvents(Events):
    """Events[DeviceEvent] resource."""


class ResizeEvents(Events):
    """Events[ResizeEvent] resource (reference lib.rs:320-329, 349-372)."""


class KeyState(Input):
    """Input<VirtualKeyCode> resource (reference window.rs:24-42)."""


class MouseState(Input):
    """Input<MouseButton> resource (reference window.rs:44-57)."""


@dataclass
class WindowData:
    """Window position + latest cursor position (reference window.rs WindowData)."""

    position: Tuple[int, int] = (0, 0)
    mouse_position: Tuple[float, float] = (0.0, 0.0)


class InputBundle:
    """Plugin filling KeyState/MouseState (+WindowData) from WindowEvents
    every PreUpdate, exactly the reference's keycode/mousebutton systems
    (window.rs:24-57). Registered automatically by run_windowed."""

    def init(self, instance) -> None:
        w = instance.world
        if w.try_get(WindowEvents) is None:
            w.insert(WindowEvents())
        if w.try_get(DeviceEvents) is None:
            w.insert(DeviceEvents())
        if w.try_get(ResizeEvents) is None:
            w.insert(ResizeEvents())
        w.insert(KeyState())
        w.insert(MouseState())
        w.insert(WindowData())
        from rfw_tpu_torch.app.ecs import Stage

        instance.scheduler.add_system(self._drain, Stage.PRE_UPDATE)

    @staticmethod
    def _drain(world) -> None:
        keys: KeyState = world.get(KeyState)
        mouse: MouseState = world.get(MouseState)
        data: WindowData = world.get(WindowData)
        keys.update()
        mouse.update()
        for ev in world.get(WindowEvents).iter():
            if isinstance(ev, KeyboardInput) and ev.virtual_keycode is not None:
                if ev.state is ElementState.PRESSED:
                    keys.press(ev.virtual_keycode)
                else:
                    keys.release(ev.virtual_keycode)
            elif isinstance(ev, MouseInput):
                if ev.state is ElementState.PRESSED:
                    mouse.press(ev.button)
                else:
                    mouse.release(ev.button)
            elif isinstance(ev, CursorMoved):
                data.mouse_position = (ev.x, ev.y)
            elif isinstance(ev, Moved):
                data.position = (ev.x, ev.y)


# ---------------------------------------------------------------------------
# Window handle providers
# ---------------------------------------------------------------------------
class WindowHandle(Protocol):
    """The raw-window-handle equivalent (reference FromWindowHandle's
    `&W: HasRawWindowHandle` + the winit Window the event loop owns)."""

    def inner_size(self) -> Tuple[int, int]:
        ...

    def scale_factor(self) -> float:
        ...

    def poll_events(self) -> List[object]:
        """Drain pending events (WindowEvent and/or DeviceEvent instances)."""
        ...

    def present(self, frame: np.ndarray) -> None:
        """Receive the rendered (H,W,4) uint8 frame (the swapchain blit)."""
        ...

    def request_redraw(self) -> None:
        ...

    def take_redraw(self) -> bool:
        """True once per request_redraw (winit's RedrawRequested delivery)."""
        ...

    def close(self) -> None:
        ...


class HeadlessWindow:
    """Scripted window: a deterministic event source + frame sink.

    `script` is a sequence of event batches; each poll_events() call pops
    the next batch. When the script is exhausted the window emits
    CloseRequested once (so run_windowed terminates like a user closing
    the window). Presented frames are counted and the last one kept.
    """

    def __init__(
        self,
        width: int = 256,
        height: int = 144,
        scale: float = 1.0,
        script: Optional[Sequence[Sequence[object]]] = None,
    ) -> None:
        self._width = int(width)
        self._height = int(height)
        self._scale = float(scale)
        self._script: List[List[object]] = [list(b) for b in (script or [])]
        self._cursor = 0
        self._redraw = False
        self.presented = 0
        self.last_frame: Optional[np.ndarray] = None
        self.closed = False

    def inner_size(self) -> Tuple[int, int]:
        return (self._width, self._height)

    def scale_factor(self) -> float:
        return self._scale

    def poll_events(self) -> List[object]:
        if self._cursor < len(self._script):
            batch = self._script[self._cursor]
            self._cursor += 1
        elif self._cursor == len(self._script):
            batch = [CloseRequested()]
            self._cursor += 1
        else:
            batch = []
        for ev in batch:  # track size like a real window would
            if isinstance(ev, Resized):
                self._width, self._height = ev.width, ev.height
            elif isinstance(ev, ScaleFactorChanged):
                self._scale = ev.scale_factor
                self._width, self._height = ev.width, ev.height
        return batch

    def present(self, frame: np.ndarray) -> None:
        self.presented += 1
        self.last_frame = frame

    def request_redraw(self) -> None:
        self._redraw = True

    def take_redraw(self) -> bool:
        r = self._redraw
        self._redraw = False
        return r

    def close(self) -> None:
        self.closed = True


# JS KeyboardEvent.code -> VirtualKeyCode (browser side of the mirror)
_JS_CODE = {}
for _c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ":
    _JS_CODE[f"Key{_c}"] = VirtualKeyCode[_c]
for _d in "1234567890":
    _JS_CODE[f"Digit{_d}"] = VirtualKeyCode[f"Key{_d}"]
    _JS_CODE[f"Numpad{_d}"] = VirtualKeyCode[f"Numpad{_d}"]
for _f in range(1, 25):
    _JS_CODE[f"F{_f}"] = VirtualKeyCode[f"F{_f}"]
_JS_CODE.update({
    "Escape": VirtualKeyCode.Escape, "Space": VirtualKeyCode.Space,
    "Enter": VirtualKeyCode.Return, "NumpadEnter": VirtualKeyCode.NumpadEnter,
    "Backspace": VirtualKeyCode.Back, "Tab": VirtualKeyCode.Tab,
    "ArrowLeft": VirtualKeyCode.Left, "ArrowRight": VirtualKeyCode.Right,
    "ArrowUp": VirtualKeyCode.Up, "ArrowDown": VirtualKeyCode.Down,
    "Insert": VirtualKeyCode.Insert, "Home": VirtualKeyCode.Home,
    "Delete": VirtualKeyCode.Delete, "End": VirtualKeyCode.End,
    "PageDown": VirtualKeyCode.PageDown, "PageUp": VirtualKeyCode.PageUp,
    "ShiftLeft": VirtualKeyCode.LShift, "ShiftRight": VirtualKeyCode.RShift,
    "ControlLeft": VirtualKeyCode.LControl,
    "ControlRight": VirtualKeyCode.RControl,
    "AltLeft": VirtualKeyCode.LAlt, "AltRight": VirtualKeyCode.RAlt,
    "MetaLeft": VirtualKeyCode.LWin, "MetaRight": VirtualKeyCode.RWin,
    "Minus": VirtualKeyCode.Minus, "Equal": VirtualKeyCode.Equals,
    "BracketLeft": VirtualKeyCode.LBracket,
    "BracketRight": VirtualKeyCode.RBracket,
    "Semicolon": VirtualKeyCode.Semicolon,
    "Quote": VirtualKeyCode.Apostrophe, "Backquote": VirtualKeyCode.Grave,
    "Backslash": VirtualKeyCode.Backslash, "Comma": VirtualKeyCode.Comma,
    "Period": VirtualKeyCode.Period, "Slash": VirtualKeyCode.Slash,
    "CapsLock": VirtualKeyCode.Capital, "NumLock": VirtualKeyCode.Numlock,
    "ScrollLock": VirtualKeyCode.Scroll, "Pause": VirtualKeyCode.Pause,
    "PrintScreen": VirtualKeyCode.Snapshot,
    "NumpadAdd": VirtualKeyCode.NumpadAdd,
    "NumpadSubtract": VirtualKeyCode.NumpadSubtract,
    "NumpadMultiply": VirtualKeyCode.NumpadMultiply,
    "NumpadDivide": VirtualKeyCode.NumpadDivide,
    "NumpadDecimal": VirtualKeyCode.NumpadDecimal,
})
_JS_BUTTON = {0: MouseButton.LEFT, 1: MouseButton.MIDDLE,
              2: MouseButton.RIGHT, 3: MouseButton.BACK,
              4: MouseButton.FORWARD}

_PAGE = """<!doctype html><html><head><title>rfw_tpu</title><style>
body{margin:0;background:#111;display:flex;align-items:center;justify-content:center;height:100vh}
img{image-rendering:pixelated;outline:none}
</style></head><body><img id=v tabindex=0 width=%W% height=%H%><script>
const v=document.getElementById('v');v.focus();
function post(e){navigator.sendBeacon('/event',JSON.stringify(e));}
function tick(){const i=new Image();i.onload=()=>{v.src=i.src;setTimeout(tick,33);};
i.onerror=()=>setTimeout(tick,250);i.src='/frame.png?'+Date.now();}
tick();
const pos=e=>{const r=v.getBoundingClientRect();
return [(e.clientX-r.left)*%W%/r.width,(e.clientY-r.top)*%H%/r.height];};
window.addEventListener('keydown',e=>{if(!e.repeat)post({t:'key',code:e.code,down:1});e.preventDefault();});
window.addEventListener('keyup',e=>{post({t:'key',code:e.code,down:0});e.preventDefault();});
v.addEventListener('mousemove',e=>{const p=pos(e);post({t:'move',x:p[0],y:p[1],dx:e.movementX,dy:e.movementY});});
v.addEventListener('mousedown',e=>post({t:'btn',b:e.button,down:1}));
v.addEventListener('mouseup',e=>post({t:'btn',b:e.button,down:0}));
v.addEventListener('mouseenter',()=>post({t:'enter'}));
v.addEventListener('mouseleave',()=>post({t:'leave'}));
v.addEventListener('wheel',e=>{post({t:'wheel',dx:e.deltaX,dy:e.deltaY});e.preventDefault();});
window.addEventListener('beforeunload',()=>post({t:'close'}));
</script></body></html>"""


class BrowserWindow:
    """An interactive window on a headless host: stdlib HTTP server
    streaming presented frames to a browser canvas and mapping browser
    key/mouse events back into the winit mirror. Open the printed URL in
    any browser; closing the tab delivers CloseRequested."""

    def __init__(self, width: int = 512, height: int = 288,
                 scale: float = 1.0, port: int = 0) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._width = int(width)
        self._height = int(height)
        self._scale = float(scale)
        self._events: Deque[object] = deque()
        self._frame_png: Optional[bytes] = None
        self._frame_lock = threading.Lock()
        self._redraw = False
        self.closed = False
        win = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _ok(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                if self.path.startswith("/frame.png"):
                    with win._frame_lock:
                        png = win._frame_png
                    if png is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self._ok(png, "image/png")
                else:
                    page = (_PAGE.replace("%W%", str(win._width))
                            .replace("%H%", str(win._height)))
                    self._ok(page.encode(), "text/html")

            def do_POST(self) -> None:
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    win._push(msg)
                except Exception:  # noqa: BLE001 — malformed client data
                    pass
                self._ok(b"", "text/plain")

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}/"
        _LOG.info("BrowserWindow at %s", self.url)

    def _push(self, msg: dict) -> None:
        t = msg.get("t")
        if t == "key":
            key = _JS_CODE.get(msg.get("code"))
            state = (ElementState.PRESSED if msg.get("down")
                     else ElementState.RELEASED)
            self._events.append(KeyboardInput(state, key))
        elif t == "btn":
            b = _JS_BUTTON.get(int(msg.get("b", 0)), MouseButton.OTHER)
            state = (ElementState.PRESSED if msg.get("down")
                     else ElementState.RELEASED)
            self._events.append(MouseInput(state, b))
        elif t == "move":
            self._events.append(CursorMoved(float(msg["x"]), float(msg["y"])))
            self._events.append(MouseMotion(
                float(msg.get("dx", 0.0)), float(msg.get("dy", 0.0))))
        elif t == "wheel":
            self._events.append(MouseWheel(
                float(msg.get("dx", 0.0)), float(msg.get("dy", 0.0)),
                pixel_delta=True))
        elif t == "enter":
            self._events.append(CursorEntered())
        elif t == "leave":
            self._events.append(CursorLeft())
        elif t == "close":
            self._events.append(CloseRequested())

    # ---- WindowHandle ----------------------------------------------------
    def inner_size(self) -> Tuple[int, int]:
        return (self._width, self._height)

    def scale_factor(self) -> float:
        return self._scale

    def poll_events(self) -> List[object]:
        out: List[object] = []
        while self._events:
            out.append(self._events.popleft())
        return out

    def present(self, frame: np.ndarray) -> None:
        from rfw_tpu_torch.utils.png import encode_png

        png = encode_png(frame)
        with self._frame_lock:
            self._frame_png = png

    def request_redraw(self) -> None:
        self._redraw = True

    def take_redraw(self) -> bool:
        r = self._redraw
        self._redraw = False
        return r

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._server.shutdown()
            self._server.server_close()
