"""PNG image I/O.

Functional equivalent of the reference's libpng codecs
(ref: src/image/image_io.cpp): float RGBA images in [0,1] <-> 8-bit PNG.
  * read: 8-bit expansion, 3- or 4-channel -> float/255, alpha 1 when absent
    (ref: image_io.cpp:55-80)
  * write: round + clamp to 0..255, RGBA (ref: image_io.cpp:132-149)

The writer encodes PNG with the standard library's zlib, so rendering
and saving need no imaging package; the reader decodes with Pillow. The
value conversions match the reference.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def read_rgb_image(path) -> np.ndarray:
    """Read a PNG into an [H, W, 4] float32 array in [0, 1]."""
    from PIL import Image as PILImage

    img = PILImage.open(path)
    if img.mode in ("I", "I;16", "I;16B", "I;16L"):
        # 16-bit channels: strip to the high byte like the reference's
        # PNG_TRANSFORM_STRIP_16 (ref: image_io.cpp:58); Pillow's direct
        # RGBA convert would clip instead.
        arr16 = np.asarray(img, dtype=np.uint32)
        img = PILImage.fromarray((arr16 >> 8).astype(np.uint8), mode="L")
    if img.mode not in ("RGB", "RGBA"):
        img = img.convert("RGBA")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.ones_like(arr[..., :1])], axis=-1)
    return arr


def write_rgb_image(path, image: np.ndarray) -> None:
    """Write an [H, W, 3|4] float image in [0,1] as an 8-bit RGBA PNG.

    Round+clamp matches the reference (ref: image_io.cpp:138-143):
    min(max(round(v*255), 0), 255). `path` may also be a binary file
    object; the codec is always PNG (ref: image_io.cpp writePNGImage).
    """
    image = np.asarray(image, dtype=np.float32)
    if image.shape[-1] == 3:
        image = np.concatenate([image, np.ones_like(image[..., :1])], axis=-1)
    data = np.clip(np.round(image * 255.0), 0, 255).astype(np.uint8)
    h, w = data.shape[:2]
    # One filter-type byte (0: none) before each RGBA8 scanline.
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), data.reshape(h, w * 4)], axis=1
    )
    png = (
        _PNG_SIGNATURE
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )
    if hasattr(path, "write"):
        path.write(png)
    else:
        with open(path, "wb") as f:
            f.write(png)
