"""The asset-free examples' counterparts on rfw_tpu_torch, and the stdlib
PNG writer they save frames with.

Each of examples/torch_{cornell,physics,d2,interactive}.py runs its
`main([...])` on the CPU (`--device cpu`) at a tiny size for one or two
frames. `torch_cornell.py` at 16x16, 2 spp, 1 bounce is held against
examples/cornell.py's `main` at the same flags: the same keys
(threefry bit for bit), tonemapped uint8 frames within 1 on 99% of
pixels (the reference's PNG is read with Pillow here; the port's code
never imports it). The PNG writer's files decode with zlib alone to the
frame's pixels, through `write_png`, `Instance.save_png` and
`BrowserWindow.present`.
"""

import os
import struct
import sys
import urllib.request
import zlib

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: PNG colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, unfiltered PNG (what utils/png.py writes) -> (H, W, C)
    uint8, with every chunk's CRC checked."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = header
    assert depth == 8 and interlace == 0
    c = _CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()  # filter None
    return rows[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (9, 4, 4)])
def test_png_round_trip(tmp_path, shape):
    from rfw_tpu_torch.utils.png import write_png

    frame = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    write_png(tmp_path / "f.png", frame)
    got = decode_png((tmp_path / "f.png").read_bytes())
    np.testing.assert_array_equal(got, frame.reshape(*shape[:2], -1))


def test_save_png_and_present_decode_to_the_frame(tmp_path):
    """Instance.save_png and BrowserWindow.present encode the last frame
    without Pillow; both decode to its pixels."""
    from rfw_tpu_torch.app import Instance
    from rfw_tpu_torch.app.window import BrowserWindow
    from rfw_tpu_torch.models import sphere
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings

    app = Instance(TorchBackend(16, 8, TorchSettings(max_bounces=1, sky_intensity=0.5),
                                device="cpu"), 16, 8)
    app.scene.add_3d_instance(app.scene.add_3d_object(sphere(quality=1)))
    app.save_png(str(tmp_path / "f.png"))
    frame = app.render_system.last_frame
    assert frame.shape == (8, 16, 4) and frame.dtype == np.uint8
    np.testing.assert_array_equal(decode_png((tmp_path / "f.png").read_bytes()), frame)
    win = BrowserWindow(16, 8)
    try:
        win.present(frame)
        png = urllib.request.urlopen(win.url + "frame.png", timeout=10).read()
    finally:
        win.close()
    np.testing.assert_array_equal(decode_png(png), frame)


def _frames(out_dir, n, shape):
    names = sorted(os.listdir(out_dir))
    assert names == [f"frame_{i:04d}.png" for i in range(n)]
    frames = [decode_png(open(os.path.join(out_dir, x), "rb").read()) for x in names]
    assert all(f.shape == shape for f in frames)
    return frames


def test_torch_physics_main(tmp_path, capsys):
    """64 balls (65 instances with the floor): the frames after the first
    take the device motion route."""
    from examples.torch_physics import main

    main(["--size", "24x16", "--frames", "2", "--spp", "1", "--balls", "64",
          "--out-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "no --font given" in out and "frame 1 ok" in out
    assert "motion syncs on the device route: 1" in out
    frames = _frames(tmp_path, 2, (16, 24, 4))
    assert not np.array_equal(frames[0], frames[1])  # the balls fell


def test_torch_d2_main(tmp_path, capsys):
    from examples.torch_d2 import main

    main(["--size", "64x48", "--frames", "2", "--out-dir", str(tmp_path), "--device", "cpu"])
    assert "frame 1 ok" in capsys.readouterr().out
    f = _frames(tmp_path, 2, (48, 64, 4))[0]
    # the textured 2D quad's checker covers the centre of (140, 180)'s
    # 160x160 square, clipped to the frame
    assert len(np.unique(f[20:40, 40:60, :3].reshape(-1, 3), axis=0)) >= 2


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_torch_interactive_main(capsys, backend):
    from examples.torch_interactive import main

    flags = ["--cpu"] if backend == "oracle" else ["--device", "cpu"]
    main(["--size", "32x18", "--frames", "2", "--no-pica", "--port", "0", *flags])
    out = capsys.readouterr().out
    assert "spheres only" in out and "presented 2 frames" in out


def test_torch_cornell_matches_jax_example(tmp_path, capsys):
    """Same flags through both examples: the port's frame within 1 of the
    JAX example's on at least 99% of pixels."""
    from PIL import Image

    from examples import cornell, torch_cornell

    flags = ["--size", "16", "--spp", "2", "--bounces", "1"]
    torch_cornell.main([*flags, "--out", str(tmp_path / "t.png"), "--device", "cpu"])
    cornell.main([*flags, "--out", str(tmp_path / "j.png")])
    out = capsys.readouterr().out
    assert "2 spp in" in out and "Mrays/s on cpu" in out
    got = decode_png((tmp_path / "t.png").read_bytes()).astype(np.int32)
    ref = np.asarray(Image.open(tmp_path / "j.png")).astype(np.int32)
    assert got.shape == ref.shape == (16, 16, 4)
    assert (np.abs(got - ref).max(axis=-1) <= 1).mean() >= 0.99
    assert got[..., :3].mean() > 10  # lit, not black


def test_examples_need_a_card_unless_told(monkeypatch, tmp_path):
    import torch

    from examples import torch_cornell, torch_physics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        torch_cornell.main(["--size", "8", "--spp", "1", "--out", str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="cpu"):
        torch_physics.main(["--size", "8x8", "--frames", "1", "--out-dir", str(tmp_path)])
    assert not (tmp_path / "x.png").exists()
