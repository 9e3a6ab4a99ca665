"""`rfw_tpu_torch.utils.image`, the port's PNG/JPEG decoder and Pillow's
resampler, against Pillow, which `rfw_tpu` decodes and resizes textures
with, on seeded numpy images:

  * decode_image: every PNG colour type and bit depth (Pillow encodes
    those it writes; a few lines of zlib encode 2- and 4-bit grey, 16-bit
    colour and the Average and Paeth filters, which it does not), with
    tRNS; baseline JPEG at subsampling 4:4:4, 4:2:2 and 4:2:0,
    greyscale, progressive, odd sizes and restart markers. Bit for bit:
    no case differs from Pillow (libjpeg-turbo, islow IDCT, fancy
    upsampling);
  * resize_rgba: up and down scales with alpha 0, partial and 255, both
    filters, bit for bit;
  * the texture path: `Texture.from_array` (power-of-two resize),
    `Texture.load` and `merge_metallic_roughness` of both packages, mip
    for mip;
  * the fixtures of tests/golden/textures (written by its make.py, which
    phase 18 of chip_smoke.py decodes on the card's machine without
    Pillow) against a fresh Pillow decode and resize.
"""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from rfw_tpu_torch.utils.image import decode_image, read_image, resize_rgba

GOLDEN = Path(__file__).resolve().parent / "golden" / "textures"
ImageFile.MAXBLOCK = 1 << 22  # Pillow's progressive JPEG writer needs room


def _pillow(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def _saved(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(
        ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _png(samples: np.ndarray, depth: int, ctype: int, filters=(0,), plte=None, trns=None,
         interlace=0) -> bytes:
    """A PNG of (h, w, channels) samples at `depth` bits, each row filtered
    by the next of `filters` (0-4)."""
    h, w, _ = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth < 8:
        bits = (samples.reshape(h, -1)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    else:
        rows = samples.reshape(h, -1).astype(np.uint8)
    bpp = max(1, samples.shape[2] * depth // 8)
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        f = filters[y % len(filters)]
        enc = np.empty_like(row)
        for i in range(row.size):
            a = row[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else (
                b if abs(p - b) <= abs(p - c) else c)
            enc[i] = (row[i] - (0, a, b, (a + b) // 2, paeth)[f]) & 0xFF
        out.append(bytes([f]) + enc.astype(np.uint8).tobytes())
        prev = row
    png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                               0, 0, interlace))
    if plte is not None:
        png += _chunk(b"PLTE", plte)
    if trns is not None:
        png += _chunk(b"tRNS", trns)
    return png + _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b"")


def _noisy(seed, h, w, c):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 5 % 256, 255 - yy * 9 % 256], -1)[..., :c]
    return np.clip(base + rng.integers(-50, 50, (h, w, c)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------- PNG
def _pillow_png(case):
    a = _noisy(1, 13, 19, 4)
    rng = np.random.default_rng(2)
    if case == "1":
        return _saved(Image.fromarray(a[..., 0] > 128), "PNG")
    if case == "1-trns":
        return _saved(Image.fromarray(a[..., 0] > 128), "PNG", transparency=1)
    if case.startswith("L"):
        kw = {"transparency": int(a[0, 0, 0])} if case == "L-trns" else {}
        return _saved(Image.fromarray(a[..., 0]), "PNG", **kw)
    if case == "LA":
        return _saved(Image.fromarray(a[..., :2], "LA"), "PNG")
    if case.startswith("RGB-"):
        return _saved(Image.fromarray(a[..., :3]), "PNG", transparency=tuple(map(int, a[3, 4, :3])))
    if case == "RGB":
        return _saved(Image.fromarray(a[..., :3]), "PNG")
    if case == "RGBA":
        a[::3, :, 3] = 0
        return _saved(Image.fromarray(a), "PNG")
    if case.startswith("I;16"):
        g = rng.integers(0, 700, a.shape[:2]).astype(np.uint16)  # past 255: clipped
        kw = {"transparency": int(g[0, 0])} if case == "I;16-trns" else {}
        return _saved(Image.fromarray(g), "PNG", **kw)
    bits = int(case.split("-")[1])  # "P-<bits>[-trns]"
    p = Image.fromarray(a[..., :3]).quantize(1 << bits)
    kw = {"bits": bits} if bits < 8 else {}
    if case.endswith("trns"):
        kw["transparency"] = bytes(rng.integers(0, 256, 1 << min(bits, 4)).astype(np.uint8))
    return _saved(p, "PNG", **kw)


PILLOW_PNG = ["1", "1-trns", "L", "L-trns", "LA", "RGB", "RGB-trns", "RGBA", "I;16",
              "I;16-trns", "P-1", "P-2", "P-4", "P-8", "P-8-trns", "P-4-trns"]


@pytest.mark.parametrize("case", PILLOW_PNG)
def test_png_written_by_pillow(case):
    data = _pillow_png(case)
    ref = _pillow(data)
    got = decode_image(data)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.array_equal(got, ref)


# (colour type, bit depth, filters, tRNS): what Pillow does not write
HAND_PNG = [(0, 2, (0, 1, 2, 3, 4), None), (0, 4, (4,), b"\x00\x05"), (0, 16, (3,), b"\x01\x2c"),
            (2, 16, (4, 1), "key"), (4, 16, (2, 3), None), (6, 16, (0, 4), None),
            (6, 8, (3, 4), None), (3, 8, (4,), "short-plte"), (2, 8, (1, 2, 3, 4), "key")]


@pytest.mark.parametrize("ctype,depth,filters,trns", HAND_PNG,
                         ids=[f"type{c}-{d}bit-f{''.join(map(str, f))}" + ("-trns" if t else "")
                              for c, d, f, t in HAND_PNG])
def test_png_every_depth_and_filter(ctype, depth, filters, trns):
    rng = np.random.default_rng(depth + ctype)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    s = rng.integers(0, 1 << depth, (9, 11, ch))
    plte = None
    if trns == "key":
        trns = struct.pack(">HHH", *map(int, s[2, 3]))
    if trns == "short-plte":  # indices past PLTE's 200 entries, alpha for 7
        plte, trns = rng.integers(0, 256, 600).astype(np.uint8).tobytes(), bytes(range(7))
    data = _png(s, depth, ctype, filters, plte, trns)
    assert np.array_equal(decode_image(data), _pillow(data))


def test_unsupported_files_raise():
    s = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="tex.png: Adam7"):
        decode_image(_png(s, 8, 2, interlace=1), "tex.png")
    bad = bytearray(_png(s, 8, 2))
    bad[-20] ^= 1  # inside the IDAT chunk: its CRC no longer holds
    with pytest.raises(ValueError, match="bad CRC"):
        decode_image(bytes(bad), "bad.png")
    jpg = _saved(Image.fromarray(s), "JPEG")
    i = jpg.index(b"\xff\xc0")
    with pytest.raises(ValueError, match="arith.jpg: arithmetic-coded"):
        decode_image(jpg[:i + 1] + b"\xc9" + jpg[i + 2:], "arith.jpg")
    cmyk = _saved(Image.fromarray(np.zeros((4, 4, 4), np.uint8), "CMYK"), "JPEG")
    with pytest.raises(ValueError, match="cmyk.jpg: 4-component"):
        decode_image(cmyk, "cmyk.jpg")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        decode_image(b"GIF89a....", "x.gif")


# --------------------------------------------------------------------- JPEG
JPEG = [((37, 53), "RGB", {"subsampling": 2}), ((37, 53), "RGB", {"subsampling": 1}),
        ((37, 53), "RGB", {"subsampling": 0}), ((64, 48), "RGB", {"quality": 95}),
        ((31, 17), "L", {}), ((31, 17), "L", {"progressive": True}),
        ((45, 29), "RGB", {"progressive": True}),
        ((45, 29), "RGB", {"progressive": True, "subsampling": 0, "quality": 97}),
        ((40, 40), "RGB", {"restart_marker_blocks": 1}),
        ((40, 24), "RGB", {"restart_marker_rows": 1, "progressive": True}),
        ((1, 1), "RGB", {}), ((3, 7), "RGB", {"subsampling": 2}),
        ((100, 9), "RGB", {"quality": 20, "optimize": True})]


@pytest.mark.parametrize("size,mode,kw", JPEG,
                         ids=[f"{w}x{h}-{m}-" + "-".join(f"{k}{v}" for k, v in kw.items())
                              for (w, h), m, kw in JPEG])
def test_jpeg_matches_pillow(size, mode, kw):
    w, h = size
    a = _noisy(w * h, h, w, 3)
    data = _saved(Image.fromarray(a[..., 0] if mode == "L" else a), "JPEG", **kw)
    ref = _pillow(data)
    got = decode_image(data)
    assert got.shape == ref.shape == (h, w, 4)
    assert np.array_equal(got, ref), f"max difference {np.abs(got.astype(int) - ref).max()}"


# ---------------------------------------------------------------- resample
RESIZE = [((16, 16), (64, 64)), ((53, 37), (64, 64)), ((53, 37), (16, 32)),
          ((7, 100), (128, 8)), ((64, 64), (32, 32)), ((5, 3), (1, 1))]


@pytest.mark.parametrize("filt", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape,size", RESIZE, ids=[f"{s[1]}x{s[0]}-to-{z[0]}x{z[1]}"
                                                     for s, z in RESIZE])
def test_resize_matches_pillow(shape, size, filt):
    a = _noisy(sum(shape), *shape, 4)
    a[..., 3] = np.random.default_rng(9).choice([0, 1, 90, 200, 255], shape)
    ref = np.asarray(Image.fromarray(a).resize(size, getattr(Image, filt.upper())))
    assert np.array_equal(resize_rgba(a, size, filt), ref)


# ------------------------------------------------------------ texture path
@pytest.mark.parametrize("shape", [(16, 16), (53, 37, 4), (7, 100, 3), (64, 200, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_texture_from_array_matches_reference(shape):
    from rfw_tpu.scene.materials import Texture as JTexture
    from rfw_tpu_torch.scene.materials import Texture

    a = _noisy(len(shape), shape[0], shape[1], shape[2] if len(shape) == 3 else 1)
    a = a[..., 0] if len(shape) == 2 else a
    if a.ndim == 3 and a.shape[2] == 4:
        a[::4, :, 3] = 0
    got, ref = Texture.from_array(a), JTexture.from_array(a)
    assert len(got.mips) == len(ref.mips) and got.width >= 64 and got.height >= 64
    for g, r in zip(got.mips, ref.mips):
        assert np.array_equal(g, r)
    other = _noisy(3, 32, 128, 4)  # a power of two, but another size
    merged = got.merge_metallic_roughness(Texture.from_array(other))
    jmerged = ref.merge_metallic_roughness(JTexture.from_array(other))
    assert all(np.array_equal(g, r) for g, r in zip(merged.mips, jmerged.mips))


@pytest.mark.parametrize("name", ["base420_37x53.jpg", "mr_24x20.png", "palette_29x18.png"])
def test_texture_load_matches_reference(name, tmp_path):
    """Texture.load picks the decoder by the magic number: the file's
    extension says nothing."""
    from rfw_tpu.scene.materials import Texture as JTexture
    from rfw_tpu_torch.scene.materials import Texture

    path = tmp_path / f"{name}.texture"
    path.write_bytes((GOLDEN / name).read_bytes())
    got, ref = Texture.load(str(path), srgb=False), JTexture.load(str(path), srgb=False)
    assert got.srgb is ref.srgb is False and got.path == ref.path
    assert all(np.array_equal(g, r) for g, r in zip(got.mips, ref.mips))


MANIFEST = json.loads((GOLDEN / "manifest.json").read_text())


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_golden_textures_match_pillow(name):
    data = (GOLDEN / name).read_bytes()
    ref = _pillow(data)
    assert list(ref.shape) == MANIFEST[name]["shape"]
    assert hashlib.sha256(ref.tobytes()).hexdigest() == MANIFEST[name]["sha256"]
    got = read_image(GOLDEN / name)
    assert np.array_equal(got, ref)
    if (GOLDEN / f"{name}.npy").exists():
        assert np.array_equal(np.load(GOLDEN / f"{name}.npy"), ref)
    if (GOLDEN / f"{name}.pow2.npy").exists():
        pow2 = np.asarray(Image.fromarray(ref).resize((64, 64), Image.BILINEAR))
        assert np.array_equal(np.load(GOLDEN / f"{name}.pow2.npy"), pow2)
        assert np.array_equal(resize_rgba(got, (64, 64), "bilinear"), pow2)
