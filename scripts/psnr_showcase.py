#!/usr/bin/env python
"""Cross-renderer PSNR vs the reference's shipped showcase render.

The reference repo ships one render produced by its own (Taichi/CUDA)
pipeline whose scene state is recoverable: assets/adapt-cornell-sphere.png
is scenes/csphere/balls-multi.xml with the ceiling area emitter enabled
(reconstructed as scenes/csphere/balls-multi-showcase.xml; the shipped
image shows a lit luminaire quad that the current XML ships commented
out). The reference wrote it via utils/watermark.py:22 apply_watermark
(no quantile normalization: opts.py:20 default 0) + ti.tools.imwrite,
i.e. uint8 = clip(linear, 0, 1) * 255, (W, H) y-up field transposed to
row-major y-down -- the exact mapping of Renderer.image().

Usage: python scripts/psnr_showcase.py outputs/showcase.npy

The watermark band (bottom-right "RENDERED WITH AdaPT" stamp, additive
+1.0 over ~92x7 px) is excluded from the comparison.
"""
import os
import sys

import numpy as np


def psnr_vs_reference(img, ref_png="/root/reference/assets/"
                               "adapt-cornell-sphere.png"):
    """img: (H, W, 3) linear float (Renderer.image() output)."""
    import cv2
    raw = cv2.imread(ref_png)
    if raw is None:
        raise FileNotFoundError(f"reference render not found: {ref_png}")
    ref = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
    assert ref.shape[:2] == img.shape[:2], (ref.shape, img.shape)
    ours = np.clip(img, 0.0, 1.0) * 255.0
    mask = np.ones(ref.shape[:2], bool)
    mask[-10:, -100:] = False          # watermark stamp region
    d = (ours - ref.astype(np.float32))[mask]
    mse = float(np.mean(d * d))
    return 10.0 * np.log10(255.0 ** 2 / mse)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "outputs/showcase.npy"
    img = np.load(path)
    p = psnr_vs_reference(img)
    print(f"PSNR vs reference showcase render: {p:.2f} dB "
          f"({os.path.basename(path)})")


if __name__ == "__main__":
    main()
