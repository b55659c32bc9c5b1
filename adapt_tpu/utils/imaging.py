"""Image post-processing helpers (reference utils/watermark.py, render.py).

Quantile normalization, watermark stamping, tonemap + write.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def quantile_normalize(img: np.ndarray, q: float = 0.99) -> np.ndarray:
    """Scale so the q-quantile maps to 1 (reference watermark.py:22-33)."""
    if q <= 0.0:
        return img
    hi = np.quantile(img, q)
    return img / max(hi, 1e-6)


def apply_watermark(img: np.ndarray) -> np.ndarray:
    """Stamp 'RENDERED WITH ADAPT-TPU' in the bottom-right corner."""
    try:
        import cv2
    except ImportError:
        return img
    out = np.ascontiguousarray(img)
    h, w = out.shape[:2]
    scale = max(w / 1024.0, 0.35)
    text = "RENDERED WITH ADAPT-TPU"
    (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, 1)
    org = (max(w - tw - 8, 0), max(h - 8, th))
    # cv2 putText only draws on uint8: render a mask, blend into the float
    mask = np.zeros((h, w), np.uint8)
    cv2.putText(mask, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale,
                255, 1, cv2.LINE_AA)
    lum = float(out.max()) or 1.0
    alpha = (mask.astype(np.float32) / 255.0)[..., None]
    return out * (1.0 - alpha) + lum * alpha


def tonemap(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """Clip + gamma to uint8."""
    return (np.clip(img, 0.0, 1.0) ** (1.0 / gamma) * 255).astype(np.uint8)


def write_image(path: str, img: np.ndarray, gamma: float = 2.2) -> None:
    """Write float [h,w,3] RGB to disk by extension (png/jpg/bmp/npy)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npy"):
        np.save(path, img.astype(np.float32))
        return
    u8 = tonemap(img, gamma)
    try:
        import cv2
        cv2.imwrite(path, u8[..., ::-1])
        return
    except ImportError:
        pass
    try:
        from PIL import Image
        Image.fromarray(u8).save(path)
    except ImportError:
        if not path.endswith(".png"):
            raise ImportError(f"writing {os.path.basename(path)} needs "
                              "cv2 or PIL; only .png and .npy are written "
                              "without them") from None
        with open(path, "wb") as f:
            f.write(png_bytes(u8))


def png_bytes(u8: np.ndarray) -> bytes:
    """Encode an (h, w, 3) uint8 RGB image as PNG with the stdlib alone
    (zlib + struct): 8-bit truecolor, no filtering."""
    h, w, _ = u8.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)   # filter byte 0 per row
    raw[:, 1:] = np.ascontiguousarray(u8, np.uint8).reshape(h, 3 * w)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def remove_fireflies(img: np.ndarray, thresh: float = 1.5) -> np.ndarray:
    """Conservative 3x3 outlier clamp (reference post_processing.py:14-32).

    A pixel whose luminance exceeds thresh x the max of its 8 neighbors is
    replaced by the neighborhood median.
    """
    h, w = img.shape[:2]
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    stack = np.stack([pad[dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)
                      if not (dy == 1 and dx == 1)], axis=0)   # (8,h,w,3)
    lum = img.mean(-1)
    nb_max = stack.mean(-1).max(0)
    med = np.median(stack, axis=0)
    fire = lum > thresh * np.maximum(nb_max, 1e-6)
    out = img.copy()
    out[fire] = med[fire]
    return out
