"""Data the port's scripts read on machines without a video decoder:
``bear_original/``, the eight 256x256 RGB frames of
``docs/artifacts/bear_smoke/bear_original.mp4`` (3 fps) as PNGs, decoded
with OpenCV, which ``data/video.py::load_video_keyframes`` reads as a frame
directory (``chip_smoke.py``'s auto-pipeline phase)."""

from pathlib import Path

BEAR_FRAMES = Path(__file__).resolve().parent / "bear_original"
