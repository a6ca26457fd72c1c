"""Host-side video and image IO for inference (port of the TV2V/TVI2V subset
of ``ccedit_tpu/data/video.py``).  Clips are uint8 (T, H, W, 3).  The decoders
(cv2 for video files, PIL for frame directories, imageio for gifs) are
imported inside the functions that use them."""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

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
        from PIL import Image

        files = sorted(f for f in Path(path).iterdir() if f.suffix.lower() in IMAGE_EXTS)
        if not files:
            raise IOError(f"no frames in {path}")
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


def load_video_keyframes(path: str, origin_fps: Optional[float] = None,
                         target_fps: float = 6.0, num_keyframes: int = 17,
                         size_hw: Tuple[int, int] = (512, 768)) -> np.ndarray:
    """(T, H, W, 3) uint8 keyframes, bicubic-resized to ``size_hw``."""
    from PIL import Image

    frames, file_fps = _read_frames(str(path))
    fps = origin_fps or file_fps or 30.0
    idx = select_keyframe_indices(len(frames), fps, target_fps, num_keyframes)
    out = [np.asarray(Image.fromarray(frames[i]).resize((size_hw[1], size_hw[0]), Image.BICUBIC))
           for i in idx]
    return np.ascontiguousarray(np.stack(out))


def load_image(path: str, size_hw: Tuple[int, int]) -> np.ndarray:
    """The TVI2V reference frame: RGB, bicubic-resized to ``size_hw``,
    (H, W, 3) float32 in [-1, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size_hw[1], size_hw[0]), Image.BICUBIC)
    return np.asarray(img).astype(np.float32) / 127.5 - 1.0


def save_video_frames(frames: np.ndarray, out_path: str, fps: float = 6.0) -> None:
    """uint8 (T, H, W, 3) -> .mp4 (cv2), .gif (imageio) or a frame directory."""
    frames = np.asarray(frames, dtype=np.uint8)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    suffix = out.suffix.lower()
    if suffix == ".gif":
        import imageio

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
