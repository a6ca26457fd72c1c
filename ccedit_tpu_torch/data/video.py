"""Host-side video and image IO (port of ``ccedit_tpu/data/video.py``).
Clips are uint8 (T, H, W, 3).  The decoders (the native threaded decode of
``data/native_decode.py`` when its library loads, else cv2 for video files,
PIL for frame directories, imageio for gifs) are imported inside the
functions that use them.  The validation-sampling writers (``to_uint8``,
``save_panel_grid``, and gifs without imageio) need only numpy and zlib,
which every machine the port runs on has; so do the PNG reader
(``read_png``) and ``load_image``'s PIL-exact bicubic resize, which the
image CLIs use."""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def select_keyframe_indices(n_frames: int, origin_fps: float, target_fps: float,
                            num_keyframes: int, start: int = 0) -> np.ndarray:
    """Stride round(origin/target); linspace over the clip when the strided
    window overruns it."""
    gap = max(int(round(origin_fps / target_fps)), 1)
    last = start + gap * (num_keyframes - 1)
    if last < n_frames:
        return np.arange(start, last + 1, gap)
    return np.linspace(0, n_frames - 1, num_keyframes).astype(int)


def _read_frames(path: str) -> Tuple[List[np.ndarray], Optional[float]]:
    if os.path.isdir(path):
        files = sorted(f for f in Path(path).iterdir() if f.suffix.lower() in IMAGE_EXTS)
        if not files:
            raise IOError(f"no frames in {path}")
        if all(f.suffix.lower() == ".png" for f in files):  # no PIL needed
            return [_rgb(read_png(f)) for f in files], None
        from PIL import Image

        return [np.asarray(Image.open(f).convert("RGB")) for f in files], None
    if path.lower().endswith(".gif"):
        import imageio.v3 as iio

        return [np.asarray(f)[..., :3] for f in iio.imread(path, index=None)], None
    if path.lower().endswith(VIDEO_EXTS):
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cannot open video {path}")
        try:
            fps = cap.get(cv2.CAP_PROP_FPS) or None
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        finally:
            cap.release()
        if not frames:
            raise IOError(f"no frames decoded from {path}")
        return frames, fps
    raise ValueError(f"unsupported video source {path!r}")


def moving_gradient_clip(t: int, h: int, w: int) -> np.ndarray:
    """A smooth moving-gradient (T, H, W, 3) uint8 clip: a synthetic input
    for timing and smoke runs, made without any file or decoder."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    clip = np.stack([np.stack([
        np.sin(2 * np.pi * (2 * xx + 0.05 * f + 0.3 * ch)) * np.cos(2 * np.pi * (yy + 0.03 * f))
        for ch in range(3)], axis=-1) for f in range(t)])
    return ((clip + 1.0) * 127.5).clip(0, 255).astype(np.uint8)


def probe_video(path: str) -> Tuple[int, float, int, int]:
    """(frame count, fps or 0, height, width) of a video file, from its
    container (cv2)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    try:
        return (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.get(cv2.CAP_PROP_FPS) or 0.0,
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
    finally:
        cap.release()


def load_video_keyframes(path: str, origin_fps: Optional[float] = None,
                         target_fps: float = 6.0, num_keyframes: int = 17,
                         size_hw: Tuple[int, int] = (512, 768)) -> np.ndarray:
    """(T, H, W, 3) uint8 keyframes, bicubic-resized to ``size_hw``.  A
    video file goes through the native decode when its library loads (the
    selected frames decoded and resized by OpenCV's bicubic in C++ threads,
    as in the JAX loader), else through cv2 (a directory of PNG frames
    through ``read_png``) and PIL's bicubic (``resize_bicubic_u8``, the same
    arithmetic without PIL); at the file's own size the two return the same
    frames."""
    from . import native_decode

    p = str(path)
    if p.lower().endswith(VIDEO_EXTS) and native_decode.available():
        n, file_fps, _, _ = probe_video(p)
        if n > 0:  # a container that reports no frame count takes the cv2 path
            idx = select_keyframe_indices(n, origin_fps or file_fps or 30.0, target_fps,
                                          num_keyframes)
            try:
                return native_decode.decode_clip_u8(p, idx, size_hw[0], size_hw[1])
            except IOError:
                pass  # the container over-reported its frame count: decode them all
    frames, file_fps = _read_frames(p)
    fps = origin_fps or file_fps or 30.0
    idx = select_keyframe_indices(len(frames), fps, target_fps, num_keyframes)
    out = [resize_bicubic_u8(frames[i], size_hw) for i in idx]
    return np.ascontiguousarray(np.stack(out))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type: gray, RGB, RGBA


def _unfilter_serial(f: int, line: list, prev: list, bpp: int) -> list:
    """PNG's average (3) and Paeth (4) filters, byte by byte: each byte
    depends on the one a pixel to its left."""
    cur = [0] * len(line)
    for i, x in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if f == 3:
            cur[i] = (x + ((a + b) >> 1)) & 255
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        cur[i] = (x + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
    return cur


def read_png(src) -> np.ndarray:
    """An 8-bit, non-interlaced gray, RGB or RGBA PNG (a path or its bytes)
    as uint8 (H, W, C), C = 1, 3 or 4 (numpy and zlib only).  Every other
    PNG raises ``ValueError``."""
    data = src if isinstance(src, (bytes, bytearray)) else Path(src).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("a PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG bit depth {depth}, colour type {ctype}, interlace {interlace}: "
                         "only 8-bit non-interlaced gray, RGB and RGBA are read")
    bpp = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    filters, rows = raw[:, 0], raw[:, 1:].astype(np.int32)
    out = np.zeros((h, w * bpp), np.int32)
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        f, line = filters[y], rows[y]
        if f == 0:
            cur = line
        elif f == 2:  # up
            cur = (line + prev) & 255
        elif f == 1:  # sub: a running sum per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 255
        elif f in (3, 4):
            cur = np.asarray(_unfilter_serial(int(f), line.tolist(), prev.tolist(), bpp),
                             np.int32)
        else:
            raise ValueError(f"PNG filter type {f}")
        out[y], prev = cur, cur
    return out.astype(np.uint8).reshape(h, w, bpp)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter (a = -0.5)."""
    x = np.abs(x)
    return np.where(x < 1.0, (1.5 * x - 2.5) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5, 0.0))


def _pil_coefficients(n_in: int, n_out: int):
    """PIL's 8-bit resampling coefficients on one axis (``precompute_coeffs``
    and ``normalize_coeffs_8bpc``): each output's first input and its
    fixed-point weights, 22 fractional bits."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    weights = np.zeros((n_out, ksize), np.int64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center - (-support) + 0.5), n_in)
        w = _bicubic((np.arange(lo, hi) - center + 0.5) / filterscale)
        if w.sum() != 0.0:
            w = w / w.sum()
        first[i] = lo
        weights[i, :hi - lo] = np.where(w < 0, np.trunc(w * (1 << 22) - 0.5),
                                        np.trunc(w * (1 << 22) + 0.5))
    return first, weights


def _pil_resample(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    first, weights = _pil_coefficients(img.shape[axis], n_out)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    taps = np.clip(first[:, None] + np.arange(weights.shape[1]), 0, src.shape[0] - 1)
    acc = np.full((n_out,) + src.shape[1:], 1 << 21, np.int64)
    for j in range(weights.shape[1]):
        acc += src[taps[:, j]] * weights[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    return np.moveaxis(np.clip(acc >> 22, 0, 255).astype(np.uint8), 0, axis)


def resize_bicubic_u8(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W, C) resized as PIL's ``Image.resize(..., BICUBIC)``
    does: the horizontal pass, then the vertical one, each rounded to 8
    bits, on PIL's fixed-point coefficients (antialiased when shrinking)."""
    if img.shape[1] != size_hw[1]:
        img = _pil_resample(img, size_hw[1], 1)
    if img.shape[0] != size_hw[0]:
        img = _pil_resample(img, size_hw[0], 0)
    return img


def load_image(path: str, size_hw: Tuple[int, int]) -> np.ndarray:
    """The TVI2V reference frame and the img2img source: RGB (gray
    repeated, alpha dropped, as PIL's ``convert("RGB")``), bicubic-resized
    to ``size_hw`` as PIL does, (H, W, 3) float32 in [-1, 1].  Reads PNG
    only (``read_png``); any other format needs PIL, which the image CLIs
    do not use."""
    if Path(path).suffix.lower() != ".png":
        raise ValueError(f"{path}: load_image reads PNG only (other formats need PIL); "
                         "convert the image to PNG")
    return resize_bicubic_u8(_rgb(read_png(path)), size_hw).astype(np.float32) / 127.5 - 1.0


def _rgb(img: np.ndarray) -> np.ndarray:
    """A ``read_png`` image as RGB: gray repeated, alpha dropped (PIL's
    ``convert("RGB")``)."""
    return np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img[..., :3]


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] floats -> uint8 pixels; uint8 passes through."""
    if frames.dtype == np.uint8:
        return frames
    return np.clip((frames + 1.0) * 127.5, 0, 255).astype(np.uint8)


def png_bytes(rgb: np.ndarray) -> bytes:
    """A uint8 (H, W, 3) image as the bytes of an 8-bit RGB PNG (numpy and
    zlib only)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """A uint8 (H, W, 3) image as an 8-bit RGB PNG file (``png_bytes``)."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def gif_palette_index(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB -> indices into ``write_gif``'s fixed 3-3-2 bit palette."""
    f = np.asarray(frames, dtype=np.uint8)
    return (f[..., 0] & 0xE0) | ((f[..., 1] & 0xE0) >> 3) | (f[..., 2] >> 6)


def gif_palette() -> np.ndarray:
    """The (256, 3) uint8 colours of ``write_gif``'s 3-3-2 bit palette."""
    i = np.arange(256)
    return np.stack([((i >> 5) & 7) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                     (i & 3) * 255 // 3], axis=-1).astype(np.uint8)


def write_gif(path: str, frames: np.ndarray, fps: float = 6.0) -> None:
    """uint8 (T, H, W, 3) as a looping GIF89a on the fixed 3-3-2 bit palette
    (numpy only).  The LZW stream holds only literals, at 9 bits with a
    clear code every 254 of them, so the decoder's code width never grows."""
    idx = gif_palette_index(frames)
    t, h, w = idx.shape
    delay = int(round(100.0 / fps))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), gif_palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for frame in idx.reshape(t, -1).astype(np.uint16):
        codes = np.append(np.insert(frame, np.arange(0, frame.size, 254), 256), 257)
        bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
        data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
        blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                          for i in range(0, len(data), 255))
        out += [b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0), b"\x08", blocks, b"\x00"]
    with open(path, "wb") as f:
        f.write(b"".join(out) + b"\x3b")


def save_panel_grid(rows: Sequence[np.ndarray], out_path: str, max_frames: int = 8) -> None:
    """The validation panel: each row a (T, H, W, 3) clip in [-1, 1] (or
    uint8), rows stacked vertically, at most ``max_frames`` frames of each
    side by side, cropped to the smallest row, written as a PNG."""
    t = min(min(r.shape[0] for r in rows), max_frames)
    h = min(r.shape[1] for r in rows)
    w = min(r.shape[2] for r in rows)
    grid = np.concatenate([np.concatenate([np.asarray(r[i][:h, :w]) for i in range(t)], axis=1)
                           for r in rows], axis=0)
    write_png(out_path, to_uint8(grid))


def save_video_frames(frames: np.ndarray, out_path: str, fps: float = 6.0) -> None:
    """uint8 (T, H, W, 3) -> .mp4 (cv2), .gif (imageio, or ``write_gif``
    where imageio is not installed) or a frame directory."""
    frames = np.asarray(frames, dtype=np.uint8)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    suffix = out.suffix.lower()
    if suffix == ".gif":
        try:
            import imageio
        except ImportError:
            write_gif(str(out), frames, fps)
            return
        imageio.mimsave(str(out), list(frames), duration=1000.0 / fps, loop=0)
    elif suffix in (".mp4", ".avi"):
        import cv2

        h, w = frames.shape[1:3]
        fourcc = cv2.VideoWriter_fourcc(*("mp4v" if suffix == ".mp4" else "XVID"))
        writer = cv2.VideoWriter(str(out), fourcc, fps, (w, h))
        try:
            for f in frames:
                writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        finally:
            writer.release()
    else:
        from PIL import Image

        out.mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(out / f"frame_{i:05d}.png")
