"""Workload-level divergence of the int8 QK^T attention (kernel 1c) on one GPU.

    python -m ccedit_tpu_torch.scripts.int8_quality [--workload tv2v|tvi2v] [--steps N]

Port of ``scripts/int8_quality.py``, QK^T half only (the port has no W8A8
path).  Runs the full-width edit of ``cli/profile_tv2v.py`` (17x512x768;
TV2V at 30 steps, CFG 7.5 by default; TVI2V at 50 steps, CFG 7) twice with
the same seed, weights and noise, exact and then with ``set_quantized_qk
(True)``, and reports the divergence: latent cosine and PSNR, per-frame
pixel PSNR and SSIM, each edit's seconds and the quantized edit's kernel-1
launches by variant.  The weights are seeded random, so the numbers measure
the int8 arithmetic's divergence, not the perceptual quality of a trained
model.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def psnr(a, b, peak: float = 255.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else float(10.0 * np.log10(peak * peak / mse))


def ssim(a, b, peak: float = 255.0) -> float:
    """SSIM with uniform 8x8 windows, averaged over pixels and channels."""
    from scipy.ndimage import uniform_filter

    a, b = a.astype(np.float64), b.astype(np.float64)
    c1, c2 = (0.01 * peak) ** 2, (0.03 * peak) ** 2
    mu_a, mu_b = uniform_filter(a, size=8), uniform_filter(b, size=8)
    va = uniform_filter(a * a, size=8) - mu_a ** 2
    vb = uniform_filter(b * b, size=8) - mu_b ** 2
    cov = uniform_filter(a * b, size=8) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))
    return float(s.mean())


def cosine(a, b) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def divergence(lat_e, lat_q, frames_e, frames_q) -> dict:
    """Exact (``_e``) against quantized (``_q``): latents (1, T, h, w, 4)
    and uint8 frames (T, H, W, 3)."""
    lat_range = float(lat_e.max() - lat_e.min())
    per_psnr = [psnr(e, q) for e, q in zip(frames_e, frames_q)]
    per_ssim = [ssim(e, q) for e, q in zip(frames_e, frames_q)]
    return {"latent_cosine": cosine(lat_e, lat_q),
            "latent_psnr_db": psnr(lat_e, lat_q, peak=lat_range if lat_range > 0 else 1.0),
            "frame_psnr_db_min": min(per_psnr), "frame_psnr_db_mean": float(np.mean(per_psnr)),
            "frame_ssim_min": min(per_ssim), "frame_ssim_mean": float(np.mean(per_ssim)),
            "per_frame_psnr_db": per_psnr}


def main(argv=None) -> None:
    from ..cli.profile_tv2v import EDIT_GEOMETRY, build_edit
    from ..ops import attention as att

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=("tv2v", "tvi2v"), default="tv2v")
    ap.add_argument("--steps", type=int, default=None,
                    help="sampling steps (default: 30 for tv2v, 50 for tvi2v)")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_quality needs a CUDA device")
    device = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    steps = a.steps or (50 if a.workload == "tvi2v" else 30)
    _, edit, cfg_scale = build_edit(a.workload, device, a.seed, steps)
    edit(1, torch.Generator(device=device).manual_seed(a.seed))  # warm-up

    runs = {}
    try:
        for quant in (False, True):
            att.set_quantized_qk(quant)
            att.reset_launch_counts()
            t0 = time.perf_counter()
            frames, latents = edit(steps, torch.Generator(device=device).manual_seed(a.seed),
                                   return_latents=True)
            seconds = time.perf_counter() - t0
            runs[quant] = dict(frames=frames, latents=latents.float().cpu().numpy(),
                               seconds=seconds, launches=att.launch_counts())
    finally:
        att.set_quantized_qk(False)
    t, h, w = EDIT_GEOMETRY
    print(json.dumps({
        "gpu": smi, "workload": f"{a.workload} {t}f {h}x{w} {steps} steps CFG {cfg_scale}",
        "weights": "seeded random: measures the int8 arithmetic's divergence",
        "exact_seconds": runs[False]["seconds"], "qk8_seconds": runs[True]["seconds"],
        "qk8_launches": {k: n for k, n in runs[True]["launches"].items()
                         if k.startswith("spatial_attention[")},
        "qk8": divergence(runs[False]["latents"], runs[True]["latents"],
                          runs[False]["frames"], runs[True]["frames"]),
    }))


if __name__ == "__main__":
    main()
