"""Watermark detector CLI (port of ``ccedit_tpu/cli/detect_watermark.py``).

    python -m ccedit_tpu_torch.cli.detect_watermark sample_000.png [...]

Checks PNG images (``data/video.py::read_png``) for the SDV2 invisible
watermark: imwatermark's dwtDct decoder where it imports, else the
blue-channel LSB decoder of ``utils/watermark.py``'s fallback embedder.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.video import read_png
from ..utils.watermark import WATERMARK_BITS, decode_lsb


def bits_match_fraction(bits) -> float:
    ref = np.asarray(WATERMARK_BITS)
    got = np.asarray(bits[:len(ref)])
    if len(got) < len(ref):
        return 0.0
    return float((ref == got).mean())


def read_rgb01(path: str) -> np.ndarray:
    """A PNG as (H, W, 3) float32 RGB in [0, 1] (gray repeated, alpha
    dropped)."""
    img = read_png(path)
    img = np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img[..., :3]
    return img.astype(np.float32) / 255.0


def detect(path: str, threshold: float = 0.9) -> bool:
    img = read_rgb01(path)
    try:
        from imwatermark import WatermarkDecoder

        dec = WatermarkDecoder("bits", len(WATERMARK_BITS))
        bits = dec.decode((img[:, :, ::-1] * 255).astype(np.uint8), "dwtDct")
        return bits_match_fraction([int(b) for b in bits]) >= threshold
    except Exception:
        return bits_match_fraction(decode_lsb(img[None])) >= threshold


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("images", nargs="+")
    p.add_argument("--threshold", type=float, default=0.9)
    args = p.parse_args(argv)
    found = {}
    for path in args.images:
        found[path] = detect(path, args.threshold)
        print(f"{path}: {'WATERMARKED' if found[path] else 'clean'}")
    return found


if __name__ == "__main__":
    main()
