"""Scribble post-processing (port of ``ccedit_tpu/conditioning/annotators/
scribble.py``): an edge map in [0, 1] -> binarised scribble strokes, per
frame on the host: x 255 -> uint8 -> directional NMS (a float32 Gaussian
blur, sigma 3, then the pixels that are maxima along any of four line
orientations, above 127) -> the uint8 Gaussian blur (sigma 3) -> > 4 is a
stroke.  The blurs and the dilation are ``imgproc``'s stand-ins for cv2's.
"""

from __future__ import annotations

import numpy as np

from .imgproc import dilate, gaussian_blur_f32, gaussian_blur_u8

_LINES = tuple(np.array(f, dtype=np.uint8) for f in (
    [[0, 0, 0], [1, 1, 1], [0, 0, 0]], [[0, 1, 0], [0, 1, 0], [0, 1, 0]],
    [[1, 0, 0], [0, 1, 0], [0, 0, 1]], [[0, 0, 1], [0, 1, 0], [1, 0, 0]]))


def nms(x: np.ndarray, t: float, s: float) -> np.ndarray:
    """Directional non-maximum suppression of a (H, W) uint8 map: keep the
    blurred pixels that are maxima along a line orientation, then > t."""
    x = gaussian_blur_f32(x.astype(np.float32), s)
    y = np.zeros_like(x)
    for f in _LINES:
        np.putmask(y, dilate(x, f) == x, x)
    z = np.zeros_like(y, dtype=np.uint8)
    z[y > t] = 255
    return z


def scribble_postprocess(edge01: np.ndarray) -> np.ndarray:
    """(N, H, W) float edge maps in [0, 1] -> (N, H, W) float32 scribbles
    in {0, 1}."""
    frames = np.clip(np.asarray(edge01, np.float32) * 255.0, 0, 255).astype(np.uint8)
    out = []
    for e in frames:
        e = gaussian_blur_u8(nms(e, 127, 3.0), 3.0)
        e[e > 4] = 255
        e[e < 255] = 0
        out.append(e)
    return np.stack(out, axis=0).astype(np.float32) / 255.0
