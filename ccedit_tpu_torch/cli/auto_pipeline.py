"""Automatic reference-editing pipeline in one command (port of
``ccedit_tpu/cli/auto_pipeline.py``): the clip's centre keyframe
(``extract_centerframe``), its img2img edit (``sampling_image``, in place
of the reference's external pnp-diffusers step; ``--edited_frame`` skips it
with a frame edited elsewhere), then the TVI2V edit of the clip conditioned
on that frame (``sampling_tv2v_ref``, ``--prior_type ref``).

    python -m ccedit_tpu_torch.cli.auto_pipeline --video_path clip.mp4 \\
        --prompt "a robot bear" --config_path tvi2v --bf16 [--edited_frame edit.png]

``--config_path`` (a YAML or a built-in config name) is the TVI2V model;
the frame edit uses ``--image_config_path``, by default the same config
sampled as a one-frame clip.  Writes ``centerframe.png``,
``edited_frame/sample_000.png`` and ``tvi2v/`` under ``--save_path``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

from . import extract_centerframe, sampling_image, sampling_tv2v_ref


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--video_path", type=str, required=True)
    p.add_argument("--prompt", type=str, required=True,
                   help="edit prompt (drives both the frame edit and tvi2v)")
    p.add_argument("--config_path", type=str, required=True,
                   help="tvi2v (reference-conditioned) model config")
    p.add_argument("--ckpt_path", type=str, default="")
    p.add_argument("--image_config_path", type=str, default="",
                   help="2D model config for the frame edit (default: reuse --config_path's "
                        "base model)")
    p.add_argument("--image_ckpt_path", type=str, default="")
    p.add_argument("--edited_frame", type=str, default="",
                   help="skip the img2img step and use this edited frame")
    p.add_argument("--save_path", type=str, default="outputs/auto_pipeline")
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=768)
    p.add_argument("--original_fps", type=int, default=18)
    p.add_argument("--target_fps", type=int, default=6)
    p.add_argument("--num_keyframes", type=int, default=17)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=7.0)
    p.add_argument("--img2img_strength", type=float, default=0.75)
    p.add_argument("--prior_coefficient_x", type=float, default=0.03)
    p.add_argument("--prior_type", type=str, default="ref", choices=["video", "ref", "video_ref"])
    p.add_argument("--seed", type=int, default=201574)
    p.add_argument("--add_prompt", type=str, default="masterpiece, best quality,")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--fake_annotator", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tokenizer_assets", type=str, default="")
    p.add_argument("--save_type", type=str, default="mp4", choices=["gif", "mp4"],
                   help="the TVI2V videos' format (gif needs no OpenCV)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CUDA kernels need 'cuda'")
    return p


def main(argv=None) -> Dict[str, Path]:
    """Run the three steps; returns the paths of the centre frame, the
    edited frame and the TVI2V output directory."""
    args = parser().parse_args(argv)
    save = Path(args.save_path)
    save.mkdir(parents=True, exist_ok=True)
    common = (["--tokenizer_assets", args.tokenizer_assets, "--device", args.device]
              + (["--bf16"] if args.bf16 else [])
              + (["--fake_annotator"] if args.fake_annotator else []))
    center_png = extract_centerframe.main([
        "--video_path", args.video_path, "--save_path", str(save / "centerframe.png"),
        "--H", str(args.H), "--W", str(args.W), "--original_fps", str(args.original_fps),
        "--target_fps", str(args.target_fps), "--num_keyframes", str(args.num_keyframes)])
    print(f"[auto] centerframe -> {center_png}")

    if args.edited_frame:
        edited = Path(args.edited_frame)
    else:
        img_dir = save / "edited_frame"
        sampling_image.main([
            "--config_path", args.image_config_path or args.config_path,
            "--ckpt_path", args.image_ckpt_path or args.ckpt_path,
            "--prompt", args.prompt, "--negative_prompt", args.negative_prompt,
            "--init_image", str(center_png), "--img2img_strength", str(args.img2img_strength),
            "--H", str(args.H), "--W", str(args.W), "--sample_steps", str(args.sample_steps),
            "--cfg_scale", str(args.cfg_scale), "--save_path", str(img_dir),
            "--seed", str(args.seed)] + common)
        edited = img_dir / "sample_000.png"
        print(f"[auto] edited frame -> {edited}")

    out_dir = save / "tvi2v"
    sampling_tv2v_ref.main([
        "--seed", str(args.seed), "--config_path", args.config_path,
        "--ckpt_path", args.ckpt_path, "--H", str(args.H), "--W", str(args.W),
        "--original_fps", str(args.original_fps), "--target_fps", str(args.target_fps),
        "--num_keyframes", str(args.num_keyframes), "--sample_steps", str(args.sample_steps),
        "--sampler_name", "DPMPP2SAncestralSampler", "--cfg_scale", str(args.cfg_scale),
        "--prompt", args.prompt, "--add_prompt", args.add_prompt,
        "--negative_prompt", args.negative_prompt, "--video_path", args.video_path,
        "--reference_path", str(edited), "--save_path", str(out_dir),
        "--disable_check_repeat", "--prior_coefficient_x", str(args.prior_coefficient_x),
        "--prior_type", args.prior_type, "--save_type", args.save_type] + common)
    print(f"[auto] done -> {out_dir}")
    return {"centerframe": center_png, "edited_frame": edited, "tvi2v": out_dir}


if __name__ == "__main__":
    main()
