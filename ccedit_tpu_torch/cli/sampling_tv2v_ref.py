"""TVI2V inference CLI (text + video + edited reference frame -> video),
flag-compatible with the JAX package's ``ccedit_tpu/cli/sampling_tv2v_ref.py``:
the TV2V flags plus ``--reference_path`` and ``--prior_type``.

    python -m ccedit_tpu_torch.cli.sampling_tv2v_ref --video_path clip.mp4 \\
        --reference_path edited_centre_frame.png --prompt "a robot bear" \\
        --H 512 --W 768 --num_keyframes 17 --sample_steps 50 --cfg_scale 7 \\
        --prior_coefficient_x 0.03 --prior_type ref --bf16
"""

from .pipeline import PRIOR_TYPES, base_parser, run_pipeline


def main(argv=None):
    p = base_parser()
    p.add_argument("--reference_path", type=str, default="",
                   help="the edited centre/reference frame (an image file)")
    p.add_argument("--prior_type", type=str, default="ref", choices=PRIOR_TYPES)
    run_pipeline(p.parse_args(argv), reference_mode=True)


if __name__ == "__main__":
    main()
