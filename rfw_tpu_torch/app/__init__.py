from rfw_tpu_torch.app.ecs import Scheduler, Stage
from rfw_tpu_torch.app.events import Events
from rfw_tpu_torch.app.input import Input
from rfw_tpu_torch.app.timer import GameTimer
from rfw_tpu_torch.app.instance import Instance, Plugin, RenderSystem
from rfw_tpu_torch.app.window import (
    BrowserWindow,
    DeviceEvent,
    DeviceEvents,
    ElementState,
    HeadlessWindow,
    InputBundle,
    KeyState,
    MouseButton,
    MouseState,
    ResizeEvent,
    ResizeEvents,
    VirtualKeyCode,
    WindowData,
    WindowEvent,
    WindowEvents,
    WindowHandle,
)
