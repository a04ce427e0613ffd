"""Image IO: linear-RGB arrays <-> image files.

Mirrors the reference IO surface (Ray.hs:241-260):
  * ``read_image``       — any PIL-readable file -> linear-RGB float array
                           (inverse sRGB transfer), like readImage.
  * ``write_image``      — linear-RGB -> proper sRGB-encoded PNG, like
                           writeImage (massiv-io converts Linear->sRGB).
  * ``write_image_sqrt`` — the reference's deliberately "slightly
                           incorrect" sqrt gamma encode (Ray.hs:254-260),
                           kept for pixel-parity with its test renders.
"""
from __future__ import annotations

import numpy as np


def _srgb_encode(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)


def _srgb_decode(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4))


def read_image(path: str) -> np.ndarray:
    """Read an image into a linear-RGB float64 [H, W, 3] array."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    data = np.asarray(img, np.float64) / 255.0
    return _srgb_decode(data)


def _to_png(path: str, encoded: np.ndarray):
    data = (np.clip(encoded, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    from PIL import Image
    Image.fromarray(data, "RGB").save(path)


def write_image(path: str, image) -> None:
    """Write linear-RGB [H, W, 3] with proper sRGB encoding."""
    _to_png(path, _srgb_encode(np.asarray(image, np.float64)))


def write_image_sqrt(path: str, image) -> None:
    """Write with sqrt gamma (Ray.hs:256-260)."""
    _to_png(path, np.sqrt(np.clip(np.asarray(image, np.float64), 0.0, None)))
