"""The OpenCV operations of the annotators' host code, without OpenCV.

The JAX package calls ``cv2`` for the scribble post-process
(``scribble.py``: a float32 and a uint8 ``GaussianBlur``, ``dilate``) and
for openpose (``openpose.py``: ``resize`` with ``INTER_AREA``,
``INTER_CUBIC`` and ``INTER_LINEAR``, ``ellipse2Poly``, ``fillConvexPoly``,
``circle``, ``line``).  The GPU machine has no ``cv2``, so these are written
here in numpy, following OpenCV's own algorithms:

* ``gaussian_blur_u8`` is OpenCV's bit-exact 8-bit path: the kernel in
  1/256 units (rounded running sums), the horizontal pass summed exactly in 1/256 units,
  the vertical pass in 1/65536 units, then rounded half up (ksize
  ``round(6 sigma + 1) | 1``, BORDER_REFLECT_101).
* ``gaussian_blur_f32`` is the float path (ksize ``round(8 sigma + 1) | 1``),
  summed in float64 and rounded once to float32.
* ``resize`` builds each axis's weights as a (dst, src) matrix: ``INTER_AREA``
  at a fractional scale is OpenCV's overlap table (``computeResizeAreaTab``:
  each source cell's covered fraction over the cell width), not an adaptive
  average pool; ``INTER_CUBIC`` uses a = -0.75 and ``INTER_LINEAR`` the
  half-pixel centres of ``align_corners=False``, both with the source
  coordinate rounded to float32 as OpenCV does and edge replication.
  ``resize_matrices`` returns the two matrices, so a caller may apply them
  on the card.
* ``ellipse2Poly``, ``fill_convex_poly`` (16.16 fixed-point edge walk, its
  outline drawn with 8-connected lines), ``circle`` (filled, the midpoint
  walk of ``cv::Circle``) and ``line`` (8-connected, thickness 1) follow
  ``drawing.cpp``; a line is not clipped to the frame first, so one that
  leaves it may differ from OpenCV's by a pixel.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

INTER_LINEAR, INTER_CUBIC, INTER_AREA = 1, 2, 3


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source index of each of n + 2 pad positions under BORDER_REFLECT_101."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv::getGaussianKernel`` in float64 (sigma > 0)."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _bit_exact_kernel(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's 8-bit Gaussian kernel as integers in 1/256 units: the
    ``getGaussianKernelBitExact`` values, each half taken as the differences
    of its rounded running sums, the centre tap making the sum exactly 256."""
    scale2 = -0.125 / (sigma * sigma)
    half = (ksize - 1) // 2
    vals = np.array([math.exp(float(x * x) * scale2) for x in range(1 - ksize, 0, 2)][:half])
    k = vals / (2.0 * vals.sum() + 1.0)
    q = np.diff(np.concatenate([[0], np.rint(np.cumsum(k) * 256.0)])).astype(np.int64)
    return np.concatenate([q, [256 - 2 * q.sum()], q[::-1]])


def _padded(x: np.ndarray, pad: int) -> Tuple[np.ndarray, int, int]:
    h, w = x.shape[:2]
    return x[_reflect101(h, pad)][:, _reflect101(w, pad)], h, w


def gaussian_blur_u8(x: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` on a (H, W) uint8 image."""
    ksize = int(round(sigma * 3 * 2 + 1)) | 1
    k = _bit_exact_kernel(ksize, sigma)
    pad = ksize // 2
    xp, h, w = _padded(x.astype(np.int64), pad)
    horiz = sum(k[j] * xp[:, j:j + w] for j in range(ksize))
    horiz = np.minimum(horiz, 0xFFFF)  # the 16-bit intermediate saturates
    vert = sum(k[i] * horiz[i:i + h] for i in range(ksize))
    return np.clip((vert + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def gaussian_blur_f32(x: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` on a (H, W) float32 image."""
    ksize = int(round(sigma * 4 * 2 + 1)) | 1
    k = gaussian_kernel(ksize, sigma).astype(np.float32).astype(np.float64)
    pad = ksize // 2
    xp, h, w = _padded(x.astype(np.float64), pad)
    horiz = sum(k[j] * xp[:, j:j + w] for j in range(ksize))
    return sum(k[i] * horiz[i:i + h] for i in range(ksize)).astype(np.float32)


def dilate(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.dilate(x, kernel)`` for an odd (k, k) 0/1 structuring element
    anchored at its centre; the border never wins (BORDER_CONSTANT at the
    lowest value)."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    low = np.finfo(x.dtype).min if x.dtype.kind == "f" else np.iinfo(x.dtype).min
    xp = np.pad(x, ((ph, ph), (pw, pw)), constant_values=low)
    h, w = x.shape
    out = np.full_like(x, low)
    for i, j in zip(*np.nonzero(kernel)):
        np.maximum(out, xp[i:i + h, j:j + w], out=out)
    return out


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def _cubic_coeffs(fx: np.ndarray) -> np.ndarray:
    a = np.float32(-0.75)
    x = fx.astype(np.float32)
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = np.float32(1) - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


def _interp_matrix(src: int, dst: int, scale: float, interpolation: int) -> np.ndarray:
    """(dst, src) weights of one axis: taps at cvFloor of the float32
    half-pixel coordinate, indices replicated at the edges."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    frac = f - s.astype(np.float32)
    if interpolation == INTER_LINEAR:
        coeffs = np.stack([np.float32(1) - frac, frac], axis=-1)
        first = s
    else:
        coeffs = _cubic_coeffs(frac)
        first = s - 1
    m = np.zeros((dst, src), dtype=np.float64)
    rows = np.arange(dst)
    for t in range(coeffs.shape[1]):
        np.add.at(m, (rows, np.clip(first + t, 0, src - 1)), coeffs[:, t].astype(np.float64))
    return m


def _area_matrix(src: int, dst: int, scale: float) -> np.ndarray:
    """``computeResizeAreaTab``: cell dx covers [dx * scale, (dx + 1) * scale)
    of the source; each source pixel weighs its covered fraction of the cell
    (fractions under 1e-3 dropped), stored as float32 as OpenCV does."""
    m = np.zeros((dst, src), dtype=np.float64)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            m[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            m[dx, sx] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            m[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return m


def _axis_matrix(src: int, dst: int, inv_scale: float, interpolation: int) -> np.ndarray:
    scale = 1.0 / inv_scale
    if interpolation == INTER_AREA and scale >= 1.0:
        if abs(scale - round(scale)) < np.finfo(np.float64).eps * 4 and src % dst == 0:
            k = int(round(scale))  # the integer-ratio fast path: a plain mean
            m = np.zeros((dst, src))
            for dx in range(dst):
                m[dx, dx * k:(dx + 1) * k] = 1.0 / k
            return m
        return _area_matrix(src, dst, scale)
    if interpolation == INTER_AREA:  # upscaling: OpenCV takes the linear path
        interpolation = INTER_LINEAR
    return _interp_matrix(src, dst, scale, interpolation)


def resize_matrices(src_hw: Tuple[int, int], dsize: Optional[Tuple[int, int]] = None,
                    fx: float = 0.0, fy: float = 0.0,
                    interpolation: int = INTER_LINEAR) -> Tuple[np.ndarray, np.ndarray]:
    """The (dst_h, src_h) and (dst_w, src_w) float64 weight matrices of
    ``cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=...)`` on an image
    of ``src_hw``; ``dsize`` is (width, height) as in OpenCV."""
    sh, sw = src_hw
    if dsize is None:
        dw, dh = int(np.rint(sw * fx)), int(np.rint(sh * fy))
        inv_x, inv_y = fx, fy
    else:
        dw, dh = dsize
        inv_x, inv_y = dw / sw, dh / sh
    return (_axis_matrix(sh, dh, inv_y, interpolation),
            _axis_matrix(sw, dw, inv_x, interpolation))


def resize(img: np.ndarray, dsize: Optional[Tuple[int, int]] = None, fx: float = 0.0,
           fy: float = 0.0, interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize`` of a float32 (H, W) or (H, W, C) image."""
    my, mx = resize_matrices(img.shape[:2], dsize, fx, fy, interpolation)
    x = img.astype(np.float64)
    out = np.einsum("ah,hw...->aw...", my, x)
    out = np.einsum("bw,aw...->ab...", mx, out)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# drawing
# ---------------------------------------------------------------------------

# OpenCV's SinTable: sin of each whole degree 0..450, rounded to 7 digits
_SIN = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32)


def ellipse2Poly(center: Tuple[int, int], axes: Tuple[int, int], angle: int,
                 arc_start: int, arc_end: int, delta: int) -> np.ndarray:
    """``cv2.ellipse2Poly``: (n, 2) int32 points."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha, beta = float(_SIN[450 - angle]), float(_SIN[angle])
    pts: List[Tuple[int, int]] = []
    prev = None
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = axes[0] * float(_SIN[450 - a])
        y = axes[1] * float(_SIN[a])
        pt = (int(np.rint(center[0] + x * alpha - y * beta)),
              int(np.rint(center[1] + x * beta + y * alpha)))
        if pt != prev:
            pts.append(pt)
            prev = pt
    if len(pts) == 1:
        pts = [tuple(center), tuple(center)]
    return np.asarray(pts, dtype=np.int32)


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def line(img: np.ndarray, p0: Sequence[int], p1: Sequence[int], color) -> None:
    """``cv2.line`` at thickness 1, 8-connected (OpenCV's LineIterator walk,
    always from the left end); pixels off the image are skipped."""
    (x, y), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if x1 < x:
        (x, y), (x1, y1) = (x1, y1), (x, y)
    dx, dy = x1 - x, y1 - y
    sx, sy = (1 if dx >= 0 else -1), (1 if dy >= 0 else -1)
    dx, dy = abs(dx), abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus, minus = dx + dx, -(dy + dy)
    h, w = img.shape[:2]
    for _ in range(dx + 1):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color
        step_minor = err < 0
        err += minus + (plus if step_minor else 0)
        if steep:
            y += sy
            x += sx if step_minor else 0
        else:
            x += sx
            y += sy if step_minor else 0


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def fill_convex_poly(img: np.ndarray, pts, color) -> None:
    """``cv2.fillConvexPoly`` (LINE_8, integer points): the outline drawn
    with 8-connected lines, then OpenCV's two-edge scanline walk in 16.16
    fixed point."""
    v = [(int(p[0]), int(p[1])) for p in np.asarray(pts).reshape(-1, 2)]
    npts = len(v)
    h, w = img.shape[:2]
    if npts == 0:
        return
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = min(p[0] for p in v), max(p[0] for p in v)
    ymin, ymax = min(ys), max(ys)
    p0 = v[-1]
    for p in v:
        line(img, p0, p, color)
        p0 = p
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, ye=ymin, x=-_XY_ONE, dx=0),
            dict(idx=imin, di=npts - 1, ye=ymin, x=-_XY_ONE, dx=0)]
    y = ymin
    edges = npts
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = idx0 + e["di"]
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = v[idx][1]
                    if ty > y:
                        xs, xe = v[idx0][0] << _XY_SHIFT, v[idx][0] << _XY_SHIFT
                        e["ye"] = ty
                        num = (xe - xs) * 2 + (ty - y)
                        den = 2 * (ty - y)
                        e["dx"] = -(-num // den) if (num < 0) != (den < 0) else num // den
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += e["di"]
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + (_XY_ONE >> 1)) >> _XY_SHIFT
            xx2 = (edge[right]["x"] + (_XY_ONE >> 1)) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def circle(img: np.ndarray, center: Sequence[int], radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, thickness=-1)`` (LINE_8):
    the filled midpoint walk of ``cv::Circle``."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < h and xa < w and xb >= 0:
                _hline(img, yy, max(xa, 0), min(xb, w - 1), color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
