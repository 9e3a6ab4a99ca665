"""Write the texture fixtures: small PNGs and JPEGs made from seeded numpy
images by Pillow, each beside the (H, W, 4) uint8 array that Pillow's
`Image.open(...).convert("RGBA")` decodes from it (`<file>.npy`), the
64x64 arrays that Pillow's bilinear resize makes of the two that
`chip_smoke.py` phase 18 embeds in a glTF (`<file>.pow2.npy`), and a
1024x1024 JPEG of a smooth gradient (decode timing) whose decoded array
is recorded by its SHA-256 in `manifest.json`.

    python tests/golden/textures/make.py    # needs Pillow

`tests/test_torch_image.py` holds the files against a fresh Pillow
decode; phase 18 decodes them on the card's machine with `import PIL`
blocked and holds the port's decoder to these arrays.
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def _noisy(rng, h, w, c, amp=60):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 4 % 256, 255 - xx * 200 // max(w - 1, 1)], -1)[..., :c]
    return np.clip(base + rng.integers(-amp, amp, (h, w, c)), 0, 255).astype(np.uint8)


def images():
    """name -> (Pillow image, save keywords)."""
    rng = np.random.default_rng(16)
    rgba = _noisy(rng, 53, 37, 4)
    rgba[::5, :, 3] = 0  # alpha 0, partial and 255
    rgba[1::5, :, 3] = 255
    pal = Image.fromarray(_noisy(rng, 18, 29, 3)).quantize(24)
    grey16 = Image.fromarray(rng.integers(0, 1000, (12, 20)).astype(np.uint16))  # I;16
    yy, xx = np.mgrid[0:1024, 0:1024].astype(np.float32)
    smooth = np.stack([xx / 4.02, yy / 4.02, (xx + yy) / 8.03], -1)
    grad = np.clip(smooth + rng.normal(0, 3.5, smooth.shape), 0, 255).astype(np.uint8)
    return {
        "rgba_37x53.png": (Image.fromarray(rgba), {}),
        "palette_29x18.png": (pal, {"transparency": bytes(range(0, 240, 10))}),
        "grey16_20x12.png": (grey16, {"transparency": 300}),
        "mr_24x20.png": (Image.fromarray(_noisy(rng, 20, 24, 3)), {}),
        "base420_37x53.jpg": (Image.fromarray(_noisy(rng, 53, 37, 3)), {"subsampling": 2}),
        "base444_40x24.jpg": (Image.fromarray(_noisy(rng, 24, 40, 3)), {"subsampling": 0}),
        "base422_33x19.jpg": (Image.fromarray(_noisy(rng, 19, 33, 3)), {"subsampling": 1}),
        "grey_31x17.jpg": (Image.fromarray(_noisy(rng, 17, 31, 1)[..., 0]), {"quality": 90}),
        "prog420_45x29.jpg": (Image.fromarray(_noisy(rng, 29, 45, 3)),
                              {"progressive": True, "quality": 92}),
        "restart_48x32.jpg": (Image.fromarray(_noisy(rng, 32, 48, 3)),
                              {"restart_marker_blocks": 2, "quality": 80}),
        "gradient_1024.jpg": (Image.fromarray(grad), {"quality": 90}),
    }


#: the fixtures phase 18 embeds in its glTF: baseColor and metallic-roughness
EMBEDDED = ("base420_37x53.jpg", "mr_24x20.png")


def main():
    manifest = {}
    for name, (im, kw) in images().items():
        buf = io.BytesIO()
        im.save(buf, "JPEG" if name.endswith(".jpg") else "PNG", **kw)
        (HERE / name).write_bytes(buf.getvalue())
        with Image.open(HERE / name) as f:
            rgba = np.asarray(f.convert("RGBA"))
        manifest[name] = {"shape": list(rgba.shape),
                          "sha256": hashlib.sha256(rgba.tobytes()).hexdigest()}
        if name != "gradient_1024.jpg":
            np.save(HERE / f"{name}.npy", rgba)
        if name in EMBEDDED:
            np.save(HERE / f"{name}.pow2.npy",
                    np.asarray(Image.fromarray(rgba).resize((64, 64), Image.BILINEAR)))
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")


if __name__ == "__main__":
    main()
