"""PNG and JPEG decoding and Pillow's resampler, on numpy and the standard
library.

Textures reach the renderer as (H, W, 4) uint8 RGBA arrays. `rfw_tpu`
decodes them with Pillow (`Image.open(...).convert("RGBA")`) and resizes
them with `Image.resize`; this module computes the same arrays without an
imaging package, so the port loads textured scenes where Pillow is absent:

  decode_image(data)        PNG (every colour type and bit depth, tRNS) or
                            JPEG (baseline and progressive Huffman), chosen
                            by the magic number, as Pillow's
                            `convert("RGBA")` gives it
  resize_rgba(img, size, f) Pillow's `Image.resize` of an RGBA image with
                            the "bilinear" or "bicubic" filter

The JPEG path follows libjpeg-turbo, which Pillow decodes with: the
accurate integer IDCT (`jidctint.c`), fancy upsampling of h2v1 and h2v2
chroma (`jdsample.c`), replication for other factors, and the fixed-point
YCbCr->RGB tables (`jdcolor.c`). The resampler follows Pillow's
`libImaging/Resample.c` and its RGBA<->RGBa premultiplication. Adam7
interlaced PNGs, arithmetic-coded, lossless, 12-bit and CMYK JPEGs raise
ValueError naming the file.
"""

from __future__ import annotations

import struct
import zlib
from array import array

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8"


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG or JPEG bytes -> (H, W, 4) uint8 RGBA, equal to
    `np.asarray(PIL.Image.open(BytesIO(data)).convert("RGBA"))`. `name`
    labels errors."""
    data = bytes(data)
    if data.startswith(PNG_MAGIC):
        return decode_png(data, name)
    if data.startswith(JPEG_MAGIC):
        return decode_jpeg(data, name)
    raise ValueError(f"{name}: neither a PNG nor a JPEG file (starts {data[:8]!r})")


def read_image(path) -> np.ndarray:
    """Decode the PNG or JPEG file at `path` (see `decode_image`)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), str(path))


# ---------------------------------------------------------------------- PNG
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _png_chunks(data: bytes, name: str):
    pos = len(PNG_MAGIC)
    while pos + 12 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if len(body) != n or zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: bad CRC or truncated {tag!r} chunk")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{name}: PNG ends without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered scanlines -> (h, stride) uint8 bytes."""
    h = raw.shape[0]
    kinds = raw[:, 0]
    cur = raw[:, 1:].astype(np.int32)
    stride = cur.shape[1]
    if not (kinds >= 3).any():
        # None, Sub and Up: a row at a time, Sub by a running sum per byte
        # of the pixel, Up by an add of the row above
        out = np.zeros((h + 1, stride), np.int32)
        for y in range(h):
            row = cur[y]
            if kinds[y] == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1)
            elif kinds[y] == 2:
                row = row + out[y]
            out[y + 1] = row & 0xFF
        return out[1:].astype(np.uint8)
    # Average and Paeth read the byte to the left, which is decoded in the
    # same row: sweep anti-diagonals of (row, pixel), every cell of which
    # depends only on the two diagonals before it, whatever each row's filter
    w = stride // bpp
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # row 0 and column 0: zeros
    src = cur.reshape(h, w, bpp)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        k = kinds[y][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[y + 1, x + 1] = (src[y, x] + pred) & 0xFF
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA as Pillow converts them, quirks
    included: 16-bit colour keeps its high byte, 16-bit grey clips at 255,
    and a tRNS key, held at the file's bit depth, is compared with the
    pixel at 8 bits."""
    ihdr, plte, trns, idat = None, None, None, []
    for tag, body in _png_chunks(data, name):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = body
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"{name}: PNG colour type {ctype} at bit depth {depth}")
    if interlace:
        raise ValueError(f"{name}: Adam7-interlaced PNG is not supported")
    ch = _PNG_CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    if raw.size < h * (stride + 1):
        raise ValueError(f"{name}: PNG image data too short")
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    if (raw[:, 0] > 4).any():
        raise ValueError(f"{name}: PNG filter type {int(raw[:, 0].max())}")
    rows = _unfilter(raw, max(1, ch * depth // 8))

    if depth == 16:  # big-endian samples
        wide = (rows[:, 0::2].astype(np.int32) << 8 | rows[:, 1::2]).reshape(h, w, ch)
        px = (wide >> 8).astype(np.uint8)  # Pillow's rawmodes ";16B" keep the high byte
    elif depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits * weights).sum(axis=-1, dtype=np.uint8)[..., None]
    else:
        px = rows.reshape(h, w, ch)

    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        # Pillow's palette: PLTE's entries, then black; alpha from tRNS
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        n = min(len(plte) // 3, 256)
        pal[:n, :3] = np.frombuffer(plte[:3 * n], np.uint8).reshape(n, 3)
        if trns is not None:
            t = np.frombuffer(trns[:256], np.uint8)
            pal[:t.size, 3] = t
        return pal[px[..., 0]]
    if ctype == 0 and depth == 16:
        out[..., :3] = np.minimum(wide, 255)  # I;16 -> RGBA clips
    elif ctype == 0 and depth < 8:
        out[..., :3] = px * (255 // ((1 << depth) - 1))  # 1/2/4-bit grey -> 8 bits
    elif ctype in (0, 4):
        out[..., :3] = px[..., :1]
        if ctype == 4:
            out[..., 3] = px[..., 1]
    else:
        out[..., :ch] = px
    if ctype in (0, 2) and trns is not None and len(trns) >= 2 * ch:
        key = struct.unpack(f">{ch}H", trns[:2 * ch]) * (3 // ch)
        if depth == 1 and ctype == 0:
            key = (255 if key[0] else 0,) * 3
        # Pillow casts each key channel to 8 bits (MAKE_UINT32): a 16-bit
        # key keeps its low byte while the pixel kept its high one
        hit = (out[..., :3] == np.array(key) & 0xFF).all(axis=-1)
        out[..., 3] = np.where(hit, 0, 255)
    return out


# --------------------------------------------------------------------- JPEG
#: zig-zag position -> natural (row-major) index in an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
_ZZ = [int(z) for z in ZIGZAG]


class _Huffman:
    """A DHT table as a 16-bit lookup: peek 16 bits, get code length and
    symbol packed as `length << 8 | symbol` (0: no such code)."""

    def __init__(self, counts, symbols):
        lut = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                lo = code << (16 - length)
                lut[lo:lo + (1 << (16 - length))] = length << 8 | symbols[k]
                code += 1
                k += 1
            code <<= 1
        self.lut = lut.tolist()


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


def _windows(seg: bytes) -> list:
    """One restart interval's entropy-coded bytes, stuffing removed, as
    32-bit big-endian windows at every byte offset: the `n` bits at bit
    `p` are `(w[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)` for n <= 16.
    Past the end the stream reads zeros, as libjpeg's does."""
    b = np.frombuffer(seg.replace(b"\xff\x00", b"\xff") + b"\0" * 8, np.uint8)
    w = (b[:-3].astype(np.int64) << 24 | b[1:-2].astype(np.int64) << 16
         | b[2:-1].astype(np.int64) << 8 | b[3:])
    return w.tolist()


def _segments(data: bytes, pos: int):
    """The entropy-coded data of a scan starting at `pos`: its restart
    intervals' bytes, and the position of the marker that ends the scan."""
    segs, start, i = [], pos, pos
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            segs.append(data[start:])
            return segs, len(data)
        m = data[i + 1]
        if m == 0x00 or m == 0xFF:  # stuffed byte, or a fill byte before a marker
            i += 1 if m == 0xFF else 2
            continue
        segs.append(data[start:i])
        if 0xD0 <= m <= 0xD7:  # RSTn
            start = i = i + 2
            continue
        return segs, i


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


class _Jpeg:
    def __init__(self, data: bytes, name: str):
        self.name = name
        self.q = {}
        self.dc, self.ac = {}, {}
        self.restart = 0
        self.comps = []
        self.progressive = False
        self.adobe = None
        self.jfif = False
        self.eobrun = 0
        self._parse(data)

    def fail(self, msg):
        raise ValueError(f"{self.name}: {msg}")

    # ---- markers
    def _parse(self, data: bytes):
        pos, frame = 2, False
        while True:
            while pos < len(data) and data[pos] != 0xFF:
                pos += 1  # garbage between markers, as libjpeg skips it
            while pos < len(data) and data[pos] == 0xFF:
                pos += 1
            if pos >= len(data):
                self.fail("JPEG ends without EOI")
            m = data[pos]
            pos += 1
            if m == 0xD9:  # EOI
                break
            if 0xD0 <= m <= 0xD7 or m == 0x01:
                continue
            (n,) = struct.unpack_from(">H", data, pos)
            body, pos = data[pos + 2:pos + n], pos + n
            if m in (0xC0, 0xC1, 0xC2):
                self._sof(body, m == 0xC2)
                frame = True
            elif 0xC3 <= m <= 0xCF and m not in (0xC4, 0xC8):
                kind = "arithmetic-coded" if m >= 0xC9 else "lossless or hierarchical"
                self.fail(f"{kind} JPEG (marker 0x{m:02X}) is not supported")
            elif m == 0xC4:
                self._dht(body)
            elif m == 0xDB:
                self._dqt(body)
            elif m == 0xDD:
                (self.restart,) = struct.unpack(">H", body[:2])
            elif m == 0xDA:
                if not frame:
                    self.fail("SOS before SOF")
                pos = self._scan(data, body, pos)
            elif m == 0xE0 and body.startswith(b"JFIF\0"):
                self.jfif = True
            elif m == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
                self.adobe = body[11]
        if not frame:
            self.fail("JPEG without a frame")

    def _sof(self, b, progressive):
        prec, h, w, nc = struct.unpack(">BHHB", b[:6])
        if prec != 8:
            self.fail(f"{prec}-bit JPEG is not supported")
        if nc not in (1, 3):
            self.fail(f"{nc}-component JPEG (CMYK or YCCK) is not supported")
        if h == 0 or w == 0:
            self.fail(f"JPEG of size {w}x{h} (a DNL-defined height is not supported)")
        self.h, self.w, self.progressive = h, w, progressive
        self.comps = [_Component(b[6 + 3 * i], b[7 + 3 * i] >> 4, b[7 + 3 * i] & 15,
                                 b[8 + 3 * i]) for i in range(nc)]
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        if any(not 1 <= c.h <= 4 or not 1 <= c.v <= 4 or self.hmax % c.h or self.vmax % c.v
               for c in self.comps):
            self.fail("JPEG sampling factors that are out of range or not integral ratios")
        self.mcux = -(-w // (8 * self.hmax))
        self.mcuy = -(-h // (8 * self.vmax))
        for c in self.comps:
            c.dw = -(-w * c.h // self.hmax)  # the component's sample size
            c.dh = -(-h * c.v // self.vmax)
            c.bx, c.by = self.mcux * c.h, self.mcuy * c.v  # its blocks, MCU-padded
            c.coef = array("i", bytes(4 * c.bx * c.by * 64))
            c.pred = 0

    def _dht(self, b):
        i = 0
        while i < len(b):
            tc, th = b[i] >> 4, b[i] & 15
            counts = list(b[i + 1:i + 17])
            syms = list(b[i + 17:i + 17 + sum(counts)])
            (self.ac if tc else self.dc)[th] = _Huffman(counts, syms)
            i += 17 + sum(counts)

    def _dqt(self, b):
        i = 0
        while i < len(b):
            pq, tq = b[i] >> 4, b[i] & 15
            if pq:
                zz = np.frombuffer(b[i + 1:i + 129], ">u2").astype(np.int64)
                i += 129
            else:
                zz = np.frombuffer(b[i + 1:i + 65], np.uint8).astype(np.int64)
                i += 65
            q = np.zeros(64, np.int64)
            q[ZIGZAG] = zz
            self.q[tq] = q

    # ---- scans
    def _scan(self, data, b, pos):
        ns = b[0]
        by_id = {c.id: c for c in self.comps}
        comps = []
        for i in range(ns):
            c = by_id.get(b[1 + 2 * i])
            if c is None:
                self.fail(f"scan names an unknown component {b[1 + 2 * i]}")
            c.td, c.ta = b[2 + 2 * i] >> 4, b[2 + 2 * i] & 15
            comps.append(c)
        ss, se, ah, al = b[1 + 2 * ns], b[2 + 2 * ns], b[3 + 2 * ns] >> 4, b[3 + 2 * ns] & 15
        segs, end = _segments(data, pos)
        if ns == 1:  # non-interleaved: the component's own blocks, one an MCU
            c = comps[0]
            units = [[(c, (y * c.bx + x) * 64)] for y in range(-(-c.dh // 8))
                     for x in range(-(-c.dw // 8))]
        else:
            units = [[(c, ((my * c.v + v) * c.bx + mx * c.h + u) * 64)
                      for c in comps for v in range(c.v) for u in range(c.h)]
                     for my in range(self.mcuy) for mx in range(self.mcux)]
        if not self.progressive:
            decode = self._baseline
        elif ss == 0:
            decode = self._dc_first if ah == 0 else self._dc_refine
        else:
            decode = self._ac_first if ah == 0 else self._ac_refine
        per = self.restart or len(units)
        try:
            for k in range(0, len(units), per):
                for c in comps:
                    c.pred = 0
                self.eobrun = 0
                seg = segs[k // per] if k // per < len(segs) else b""
                decode(_windows(seg), units[k:k + per], ss, se, al)
        except (KeyError, IndexError):
            self.fail("corrupt JPEG scan (a missing Huffman table or a bad code)")
        return end

    def _baseline(self, w, units, ss, se, al):
        p = 0
        zz = _ZZ
        for unit in units:
            for c, base in unit:
                coef = c.coef
                dc, ac = self.dc[c.td].lut, self.ac[c.ta].lut
                e = dc[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise KeyError("bad code")
                p += e >> 8
                s = e & 0xFF
                if s:
                    v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    c.pred += v - (1 << s) + 1 if v < 1 << (s - 1) else v
                coef[base] = c.pred
                k = 1
                while k < 64:
                    e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise KeyError("bad code")
                    p += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:
                        k += r
                        v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                        p += s
                        coef[base + zz[k & 63]] = v - (1 << s) + 1 if v < 1 << (s - 1) else v
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break

    def _dc_first(self, w, units, ss, se, al):
        p = 0
        for unit in units:
            for c, base in unit:
                e = self.dc[c.td].lut[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise KeyError("bad code")
                p += e >> 8
                s = e & 0xFF
                if s:
                    v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    c.pred += _extend(v, s)
                c.coef[base] = c.pred << al

    def _dc_refine(self, w, units, ss, se, al):
        p = 0
        for unit in units:
            for c, base in unit:
                if (w[p >> 3] >> (31 - (p & 7))) & 1:
                    c.coef[base] |= 1 << al
                p += 1

    def _ac_first(self, w, units, ss, se, al):
        p = 0
        zz = _ZZ
        eobrun = self.eobrun
        for unit in units:
            c, base = unit[0]
            if eobrun:
                eobrun -= 1
                continue
            coef, ac = c.coef, self.ac[c.ta].lut
            k = ss
            while k <= se:
                e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise KeyError("bad code")
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    k += r
                    v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    coef[base + zz[k & 63]] = _extend(v, s) << al
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                    eobrun -= 1
                    break
        self.eobrun = eobrun

    def _ac_refine(self, w, units, ss, se, al):
        """jdphuff.c's decode_mcu_AC_refine: correction bits for the
        coefficients already nonzero, new coefficients of +-1 << al."""
        p = 0
        zz = _ZZ
        p1, m1 = 1 << al, -1 << al
        eobrun = self.eobrun
        for unit in units:
            c, base = unit[0]
            coef, ac = c.coef, self.ac[c.ta].lut
            k = ss
            if not eobrun:
                while k <= se:
                    e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise KeyError("bad code")
                    p += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:
                        s = p1 if (w[p >> 3] >> (31 - (p & 7))) & 1 else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (w[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                            p += r
                        break
                    while k <= se:
                        i = base + zz[k]
                        if coef[i]:
                            if (w[p >> 3] >> (31 - (p & 7))) & 1 and not coef[i] & p1:
                                coef[i] += p1 if coef[i] >= 0 else m1
                            p += 1
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if s and k <= se:
                        coef[base + zz[k]] = s
                    k += 1
            if eobrun:
                while k <= se:
                    i = base + zz[k]
                    if coef[i]:
                        if (w[p >> 3] >> (31 - (p & 7))) & 1 and not coef[i] & p1:
                            coef[i] += p1 if coef[i] >= 0 else m1
                        p += 1
                    k += 1
                eobrun -= 1
        self.eobrun = eobrun

    # ---- samples
    def planes(self):
        """Each component's samples, (dh, dw) uint8, by the islow IDCT."""
        out = []
        for c in self.comps:
            if c.tq not in self.q:
                self.fail(f"missing quantization table {c.tq}")
            blocks = np.frombuffer(c.coef, np.int32).reshape(-1, 64)
            px = idct_islow(blocks, self.q[c.tq])
            img = px.reshape(c.by, c.bx, 8, 8).transpose(0, 2, 1, 3).reshape(8 * c.by, 8 * c.bx)
            out.append(img[:c.dh, :c.dw])
        return out


# jidctint.c's constants: FIX(x) = round(x * 2**13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(s0, s1, s2, s3, s4, s5, s6, s7, shift):
    """jidctint.c's one-dimensional pass (int64 arrays); each output is
    DESCALE(x, shift). Its zero-column and zero-row shortcuts give the
    same values as the full pass, so there are none here."""
    z1 = (s2 + s6) * _F0541
    tmp2 = z1 - s6 * _F1847
    tmp3 = z1 + s2 * _F0765
    tmp0 = (s0 + s4) << _CONST_BITS
    tmp1 = (s0 - s4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s7, s5, s3, s1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    return [(x + half) >> shift for x in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit_table() -> np.ndarray:
    """jdmaster.c's post-IDCT table, indexed by x & 1023 for an IDCT output
    x: x + 128 clamped to [0, 255] over [-384, 384), wrapping beyond."""
    j = np.arange(1024)
    return np.select([j < 128, j < 512, j < 896], [j + 128, 255, 0], j - 896).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def idct_islow(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg's accurate integer IDCT: (N, 64) coefficients in natural
    order and their (64,) quantization table -> (N, 8, 8) uint8 samples."""
    c = blocks.astype(np.int64).reshape(-1, 8, 8) * q.reshape(8, 8)
    ws = np.stack(_idct_1d(*(c[:, k, :] for k in range(8)),
                           _CONST_BITS - _PASS1_BITS), axis=1)  # columns
    out = np.stack(_idct_1d(*(ws[:, :, k] for k in range(8)),
                            _CONST_BITS + _PASS1_BITS + 3), axis=2)  # rows
    return _RANGE_LIMIT[out & 1023]


def _fancy_h2(x: np.ndarray, bias_left: int = 1, bias_right: int = 2,
              shift: int = 2) -> np.ndarray:
    """Horizontal 2x fancy upsampling of int32 `x` (rows, dw): the left
    output of a sample is (3 * it + its left neighbour + bias_left) >>
    shift, the right one likewise, as jdsample.c rounds them; the edge
    samples stand in for their missing neighbours."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + bias_left) >> shift
    out[:, 1::2] = (3 * x + right + bias_right) >> shift
    return out


def upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """A component plane (dh, dw) uint8 to the full sample grid by
    libjpeg-turbo's rules: h2v1 and h2v2 fancy (triangle) upsampling when
    the plane is more than 2 samples wide, replication otherwise."""
    if (fx, fy) == (1, 1):
        return plane
    x = plane.astype(np.int32)
    if fx == 2 and fy == 1 and x.shape[1] > 2:
        # h2v1_fancy_upsample: (3 * nearer + further + 1 or 2) >> 2
        return _fancy_h2(x).astype(np.uint8)
    if fx == 2 and fy == 2 and x.shape[1] > 2:
        # h2v2_fancy_upsample: column sums 3 * nearer row + further row,
        # then (3 * this + other + 8 or 7) >> 4; rows past the edge repeat
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
        out[0::2] = _fancy_h2(3 * x + up, 8, 7, shift=4)
        out[1::2] = _fancy_h2(3 * x + down, 8, 7, shift=4)
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, fy, axis=0), fx, axis=1)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(f):
        return int(f * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB of uint8 planes: (..., 3) uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Baseline or progressive Huffman JPEG bytes (greyscale or three
    components) -> (H, W, 4) uint8 RGBA, as Pillow (libjpeg-turbo, islow
    IDCT, fancy upsampling) decodes and converts them."""
    try:
        j = _Jpeg(data, name)
    except struct.error:
        raise ValueError(f"{name}: truncated JPEG marker segment") from None
    planes = j.planes()
    full = [upsample(p, j.hmax // c.h, j.vmax // c.v)[:j.h, :j.w]
            for p, c in zip(planes, j.comps)]
    out = np.empty((j.h, j.w, 4), np.uint8)
    out[..., 3] = 255
    if len(full) == 1:
        out[..., :3] = full[0][..., None]
        return out
    # libjpeg's default colour space for three components: RGB for an Adobe
    # transform 0 or component ids 'R', 'G', 'B' without JFIF, else YCbCr
    ids = tuple(c.id for c in j.comps)
    rgb = not j.jfif and (j.adobe == 0 if j.adobe is not None else ids == (82, 71, 66))
    out[..., :3] = np.stack(full, axis=-1) if rgb else ycc_to_rgb(*full)
    return out


# ----------------------------------------------------------------- resample
PRECISION_BITS = 32 - 8 - 2
_SUPPORT = {"bilinear": 1.0, "bicubic": 2.0}


def _filter(name: str, x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    if name == "bilinear":
        return np.where(x < 1.0, 1.0 - x, 0.0)
    a = -0.5
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int, name: str):
    """Resample.c's precompute_coeffs and normalize_coeffs_8bpc: per
    output pixel its first input pixel, and the fixed-point weights of its
    `ksize` taps (zeros past the pixel's own count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT[name] * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _filter(name, ((taps[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # the C loop's summation order
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << PRECISION_BITS)).astype(np.int64)
    return xmin, xmax, fixed


def _resample_axis(img: np.ndarray, out_size: int, name: str, axis: int) -> np.ndarray:
    """One pass of Resample.c over `axis` of (H, W, C) uint8."""
    in_size = img.shape[axis]
    xmin, xmax, k = _coeffs(in_size, out_size, name)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)
        acc += src[idx] * k[:, t, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_rgba(img: np.ndarray, size, filter: str = "bilinear") -> np.ndarray:
    """Pillow's `Image.fromarray(img).resize(size, filter)` for (H, W, 4)
    uint8 RGBA: premultiplied by alpha (RGBA -> RGBa), resampled across
    then down through a uint8 intermediate, and unpremultiplied (RGBa ->
    RGBA; colour under alpha 0 comes out 0). `size` is (width, height)."""
    if filter not in _SUPPORT:
        raise ValueError(f"filter {filter!r}: expected one of {tuple(_SUPPORT)}")
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) RGBA, got {img.shape}")
    w, h = int(size[0]), int(size[1])
    if (h, w) == img.shape[:2]:
        return img.copy()
    a = img[..., 3:].astype(np.int32)
    t = img[..., :3].astype(np.int32) * a + 128
    pre = np.concatenate([((t >> 8) + t) >> 8, a], axis=-1).astype(np.uint8)  # MULDIV255
    if w != img.shape[1]:
        pre = _resample_axis(pre, w, filter, 1)
    if h != img.shape[0]:
        pre = _resample_axis(pre, h, filter, 0)
    a = pre[..., 3:].astype(np.int32)
    rgb = pre[..., :3].astype(np.int32)
    un = np.minimum(255 * rgb // np.maximum(a, 1), 255)
    out = pre.copy()
    out[..., :3] = np.where((a == 0) | (a == 255), rgb, un)
    return out
