"""The port's app layer against rfw_tpu's: `Instance` with its window loop
(`tests/test_window.py`'s cases: HeadlessWindow, InputBundle, resize, the
scale factor, `from_window_handle`, BrowserWindow's round trip over
localhost HTTP), the ECS, `TrackedStorage` and `Tracked`
(`tests/test_utils.py`'s cases), `SphereWorld` over 50 steps and
`FontPlugin`. Each case runs the same calls through both packages, each
Instance over a `_torch_scene.Recorder`, and what it observes (the frames
counted, the input states seen, the recorded backend calls with their
arguments, the trajectories, the glyph atlas and text mesh) must be
identical (`_torch_scene.same`); the original test's assertions are then
made on the port's result.
"""

import importlib
import json
import os
import urllib.request

import numpy as np
import pytest

from _torch_scene import Recorder, same

PKGS = ("rfw_tpu", "rfw_tpu_torch")
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(case):
    """`case(pkg)` through both packages; the results must be identical.
    Returns the port's."""
    ref, got = case("rfw_tpu"), case("rfw_tpu_torch")
    same(ref, got, case.__name__)
    return got


def instance(pkg, w=64, h=32):
    rec = Recorder()
    return mod(pkg, "app").Instance(rec, w, h), rec


# ------------------------------------------------------------- the window loop
def test_headless_close_ends_loop_and_counts_frames():
    def case(pkg):
        inst, rec = instance(pkg)
        win = mod(pkg, "app.window").HeadlessWindow(64, 32, script=[[], [], []])
        return inst.run_windowed(win), win.presented, win.closed, win.last_frame, rec.stream

    frames, presented, closed, last, _ = both(case)
    assert frames == presented == 3 and closed and last.shape == (32, 64, 4)


def test_input_bundle_fills_key_and_mouse_state():
    def case(pkg):
        W = mod(pkg, "app.window")
        inst, _ = instance(pkg)
        seen = []

        def probe(world):
            keys, mouse = world.get(W.KeyState), world.get(W.MouseState)
            seen.append((keys.pressed(W.VirtualKeyCode.W), keys.just_pressed(W.VirtualKeyCode.W),
                         mouse.pressed(W.MouseButton.LEFT)))

        inst.with_system(probe, mod(pkg, "app").Stage.UPDATE)
        P, R = W.ElementState.PRESSED, W.ElementState.RELEASED
        inst.run_windowed(W.HeadlessWindow(64, 32, script=[
            [W.KeyboardInput(P, W.VirtualKeyCode.W), W.MouseInput(P, W.MouseButton.LEFT)],
            [],
            [W.KeyboardInput(R, W.VirtualKeyCode.W), W.MouseInput(R, W.MouseButton.LEFT)],
        ]))
        return seen

    seen = both(case)
    assert seen == [(True, True, True), (True, False, True), (False, False, False)]


def test_cursor_and_device_events():
    def case(pkg):
        W = mod(pkg, "app.window")
        inst, _ = instance(pkg)
        got = []
        inst.with_system(lambda world: got.extend(world.get(W.DeviceEvents).iter()),
                         mod(pkg, "app").Stage.UPDATE)
        inst.run_windowed(W.HeadlessWindow(64, 32, script=[
            [W.CursorEntered(), W.CursorMoved(10.0, 20.0)], [W.MouseMotion(3.0, -2.0)]]))
        return inst.world.get(W.WindowData).mouse_position, got

    pos, got = both(case)
    assert pos == (10.0, 20.0) and len(got) == 1 and got[0].dx == 3.0


def test_resize_and_scale_factor():
    def case(pkg):
        W = mod(pkg, "app.window")
        inst, rec = instance(pkg, 64, 32)
        win = W.HeadlessWindow(64, 32, script=[[W.Resized(128, 64)], []])
        inst.run_windowed(win)
        inst2, _ = instance(pkg, 64, 32)
        inst2.run_windowed(W.HeadlessWindow(64, 32, script=[[W.ScaleFactorChanged(2.0, 64, 32)],
                                                             []]))
        return (rec.stream, inst.render_system.width, win.last_frame.shape,
                inst2.render_system.width, inst2.render_system.height)

    stream, width, shape, w2, h2 = both(case)
    assert ("resize", (128, 64, 1.0)) in stream and width == 128 and shape == (64, 128, 4)
    assert (w2, h2) == (128, 64)


def test_max_frames_and_window_events():
    def case(pkg):
        W = mod(pkg, "app.window")
        inst, _ = instance(pkg)
        frames = inst.run_windowed(W.HeadlessWindow(64, 32, script=[[] for _ in range(100)]),
                                   max_frames=5)
        inst2, _ = instance(pkg)
        got = []
        inst2.with_system(lambda world: got.append(list(world.get(W.WindowEvents).iter())),
                          mod(pkg, "app").Stage.UPDATE)
        inst2.run_windowed(W.HeadlessWindow(64, 32, script=[[W.MouseWheel(0.0, -120.0,
                                                                           pixel_delta=True)]]))
        return frames, got

    frames, got = both(case)
    assert frames == 5 and got[0][0].delta_y == -120.0


def test_frames_sync_the_scene_through_the_instance():
    """A scene authored through `app.scene` is synchronized into the
    backend on every frame, then rendered with the instance's cameras."""
    def case(pkg):
        inst, rec = instance(pkg)
        prim = mod(pkg, "models.primitives")
        sid = inst.scene.add_3d_object(prim.sphere(quality=1))
        h = inst.scene.add_3d_instance(sid)
        inst.scene.add_point_light((0, 2, 0), (5, 5, 5))
        inst.camera.look_at(np.array([0, 1, 4], np.float32), np.zeros(3, np.float32))

        def move(world):
            h.set_trs((0.1, 0, 0), (0, 0, 0, 1), (1, 1, 1))
            inst.scene._instances_changed = True
        inst.with_system(move)
        inst.run(2)
        inst.resize(80, 40, 1.5)
        inst.render_frame(mod(pkg, "backend.contract").RenderMode.NORMAL)
        return rec.stream

    stream = both(case)
    names = [c[0] for c in stream]
    assert names.count("render") == 3 and names.count("set_3d_instances") == 3


def test_from_window_handle():
    def case(pkg):
        W = mod(pkg, "app.window")
        rec = Recorder.from_window_handle(W.HeadlessWindow(320, 200, scale=1.0))
        cpu = mod(pkg, "render.cpu_reference").CpuReferenceBackend.from_window_handle(
            W.HeadlessWindow(16, 8))
        cpu.synchronize()
        frame = cpu.render(None, mod(pkg, "scene.camera").Camera3D().get_view(16, 8))
        return (rec.width, rec.height), (cpu.width, cpu.height), frame

    rec_size, cpu_size, frame = both(case)
    assert rec_size == (320, 200) and cpu_size == (16, 8) and frame.shape == (8, 16, 4)


def test_from_window_handle_torch_backend_sizes():
    from rfw_tpu_torch.app.window import HeadlessWindow
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings

    backend = TorchBackend.from_window_handle(
        HeadlessWindow(32, 16, scale=2.0),
        settings=TorchSettings(samples_per_frame=1, max_bounces=1), device="cpu")
    assert (backend.width, backend.height) == (64, 32)


def test_browser_window_round_trip():
    def case(pkg):
        W = mod(pkg, "app.window")
        win = W.BrowserWindow(32, 16)
        try:
            page = urllib.request.urlopen(win.url, timeout=10).read()
            frame = np.zeros((16, 32, 4), np.uint8)
            frame[..., 0] = 200
            frame[..., 3] = 255
            win.present(frame)
            png = urllib.request.urlopen(win.url + "frame.png", timeout=10).read()

            def post(payload):
                req = urllib.request.Request(win.url + "event", json.dumps(payload).encode(),
                                             {"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=10).read()

            for p in ({"t": "key", "code": "KeyW", "down": 1}, {"t": "btn", "b": 0, "down": 1},
                      {"t": "move", "x": 5, "y": 6, "dx": 1, "dy": 2},
                      {"t": "wheel", "dx": 0, "dy": -3}, {"t": "close"}):
                post(p)
            return b"frame.png" in page, png[:4], win.poll_events()
        finally:
            win.close()

    page_ok, magic, evs = both(case)
    assert page_ok and magic == b"\x89PNG"
    W = mod("rfw_tpu_torch", "app.window")
    assert W.KeyboardInput(W.ElementState.PRESSED, W.VirtualKeyCode.W) in evs
    assert W.CursorMoved(5.0, 6.0) in evs and W.CloseRequested() in evs


def test_browser_window_drives_full_loop():
    def case(pkg):
        W = mod(pkg, "app.window")
        inst, _ = instance(pkg, 32, 16)
        win = W.BrowserWindow(32, 16)
        try:
            win._push({"t": "key", "code": "Space", "down": 1})
            frames = []

            def probe(world):
                frames.append(world.get(W.KeyState).pressed(W.VirtualKeyCode.Space))
                if len(frames) == 2:
                    win._push({"t": "close"})

            inst.with_system(probe, mod(pkg, "app").Stage.UPDATE)
            n = inst.run_windowed(win, max_frames=10)
            return frames, n, win._frame_png is not None, win.closed
        finally:
            win.close()

    frames, n, presented, closed = both(case)
    assert frames[0] is True and 2 <= n <= 10 and presented and closed


# ------------------------------------------------ storages, ECS, scale mode
def test_storages_and_tracked():
    def case(pkg):
        U = mod(pkg, "utils")
        out = []
        s = U.FlaggedStorage()
        a = s.push("a")
        s.push("b")
        out.append((s.erase(a), a in s, s.push("c"), dict(iter(s)), len(s)))
        s.overwrite(5, "x")
        out.append((dict(iter(s)), 3 in s))
        with pytest.raises(KeyError):
            U.FlaggedStorage().erase(0)
        t = U.TrackedStorage()
        ids = [t.push(i) for i in range(4)]
        out.append(t.changed_indices())
        t.reset_changed()
        t.get_mut(ids[2])
        t.erase(ids[1])
        out.append((t.any_changed, t.changed_indices(), list(t.iter_changed()),
                    t.take_erased(), t.take_erased()))
        t.trigger_changed_all()
        t.touch(ids[1])  # erased: no mark
        out.append(t.changed_indices())
        v = U.Tracked(5)
        out.append(v.changed)
        v.reset_changed()
        out.append(v.changed)
        v.value = 6
        out.append((v.changed, v.value))
        avg = U.Averager(capacity=4)
        for x in (1, 2, 3, 4, 5):
            avg.add(x)
        out.append(avg.average())
        inst = mod(pkg, "app.instance")
        out.append([inst._resolve_scale(inst.ScaleMode.REGULAR, dpi=2.0),
                    inst._resolve_scale(inst.ScaleMode.HIGH_DPI, dpi=2.0),
                    inst._resolve_scale(0.5), inst.ScaleMode.CUSTOM.factor(custom=1.5)])
        return out

    out = both(case)
    assert out[0][:3] == ("a", False, 0) and out[2] == [0, 1, 2, 3]
    assert out[3][1] == [2] and out[3][3] == [1] and out[4] == [0, 2, 3]
    assert out[-2] == 3.5 and out[-1] == [1.0, 2.0, 0.5, 1.5]


def test_transform_guard_writes_once_on_exit():
    def case(pkg):
        lst = mod(pkg, "scene.instances").InstanceList3D()
        h = lst.allocate()
        lst.reset_changed()
        with h.transform() as t:
            t.translate((1, 2, 3)).rotate_y(np.pi / 2).scale(2.0)
            mid = bool(lst.changed[h.index])
        return mid, bool(lst.changed[h.index]), lst.matrices[h.index]

    mid, after, m = both(case)
    assert not mid and after
    np.testing.assert_allclose(m[:3, 0], [0, 0, -2], atol=1e-5)


def test_ecs_world_and_scheduler():
    def case(pkg):
        E = mod(pkg, "app.ecs")
        w = E.World()
        for i in range(5):
            w.spawn(pos=np.array([i, 0, 0], np.float32), vel=np.array([0, 1.0 * i, 0], np.float32))
        lone = w.spawn(pos=np.array([9, 9, 9], np.float32))
        batch = w.query("pos", "vel")
        batch.set("pos", batch.col("pos") + batch.col("vel"))
        out = [len(batch), w.get_component(batch.entities[3], "pos"), len(w.query("pos"))]
        w.despawn(batch.entities[1])
        w.add_component(lone, "vel", np.zeros(3, np.float32))
        b2 = w.query("pos", "vel")
        out += [b2.entities, b2.col("pos"), len(w.query("pos", "nope"))]
        order = []
        s = E.Scheduler()
        for stage in (E.Stage.POST_UPDATE, E.Stage.UPDATE, E.Stage.PRE_UPDATE):
            s.add_system(lambda world, st=stage: order.append(st.name), stage)
        s.add_startup_system(lambda world: order.append("startup"))
        s.run(w)
        s.run(w)
        return out, order

    out, order = both(case)
    assert out[0] == 5 and np.allclose(out[1], [3, 3, 0]) and out[2] == 6
    assert order == ["startup", "PRE_UPDATE", "UPDATE", "POST_UPDATE",
                     "PRE_UPDATE", "UPDATE", "POST_UPDATE"]


# ------------------------------------------------------------------ physics
def test_sphere_world_trajectories():
    """50 steps of a seeded pile of spheres (ground and pair contacts, an
    impulse, a static body): identical positions and velocities at every
    step."""
    def case(pkg):
        world = mod(pkg, "utils.physics").SphereWorld.new()
        rng = np.random.default_rng(9)
        for k in range(12):
            world.add_sphere(rng.uniform([-1, 0.5, -1], [1, 3, 1]).astype(np.float32),
                             radius=float(rng.uniform(0.2, 0.5)),
                             velocity=rng.normal(size=3).astype(np.float32))
        world.add_sphere((0, 0.3, 0), radius=0.3, mass=0)  # static
        world.apply_impulse(0, (2, 5, 0))
        world.apply_impulse_all((0, 1, 0))
        steps = []
        for _ in range(50):
            world.step(1 / 30)
            steps.append((world.positions.copy(), world.velocities.copy()))
        return steps

    steps = both(case)
    assert not np.allclose(steps[0][0], steps[-1][0])
    assert (steps[-1][0][:, 1] >= 0.2 - 1e-4).all()  # nothing sank through the ground


# --------------------------------------------------------------------- font
@pytest.mark.skipif(not os.path.exists(FONT), reason=f"no TrueType font at {FONT}")
def test_font_plugin_atlas_and_mesh():
    def case(pkg):
        F = mod(pkg, "font")
        inst, rec = instance(pkg, 96, 48)
        font = F.FontPlugin(font_path=FONT, atlas_size=32)  # small: the atlas grows
        inst.with_plugin(font)
        font.draw(F.Section((4, 4), [F.Text("Hello, port!", px=14),
                                     F.Text("\nAbc", px=20, color=(1, 0.5, 0, 1))]))
        inst.render_frame()
        font.draw(F.Section((10, 30), [F.Text("frame 2", px=14)]))
        inst.render_frame()
        a = font.atlas
        return a.size, a.image, a.entries, rec.stream

    size, image, entries, stream = both(case)
    assert size > 32 and image.max() == 255 and len(entries) > 10
    assert "set_2d_meshes" in [c[0] for c in stream]


def test_font_plugin_needs_a_font_path():
    from rfw_tpu_torch.font import FontPlugin

    with pytest.raises(ValueError, match="font_path"):
        FontPlugin()
