"""Extract a clip's centre keyframe to a PNG for editing (port of
``ccedit_tpu/cli/extract_centerframe.py``).

    python -m ccedit_tpu_torch.cli.extract_centerframe --video_path clip.mp4 \\
        --save_path centre.png [--H 512 --W 768 --num_keyframes 17]

The keyframes are the ones the TV2V/TVI2V sampler takes
(``load_video_keyframes``: a video file, or a directory of frames); the
middle one is written with the port's PNG writer.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.video import load_video_keyframes, to_uint8, write_png


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--video_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=768)
    p.add_argument("--original_fps", type=int, default=20)
    p.add_argument("--target_fps", type=int, default=6)
    p.add_argument("--num_keyframes", type=int, default=17)
    return p


def main(argv=None) -> Path:
    args = parser().parse_args(argv)
    frames = load_video_keyframes(args.video_path, args.original_fps, args.target_fps,
                                  args.num_keyframes, (args.H, args.W))
    out = Path(args.save_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_png(str(out), to_uint8(frames[args.num_keyframes // 2]))
    print(f"saved center keyframe ({args.num_keyframes // 2}) to {out}")
    return out


if __name__ == "__main__":
    main()
