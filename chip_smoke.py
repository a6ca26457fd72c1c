#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccedit_tpu_torch) on one GPU.

    python3 chip_smoke.py      # one GPU, about a minute with the kernels' build

Phases:
  1. device: CUDA present, one card; prints nvidia-smi's name and power limit.
  2. build: the CUDA kernels in ccedit_tpu_torch/csrc, with nvcc, timed.
  3. kernels: each kernel and variant against its plain PyTorch version in
     bf16 at the shapes the TV2V and TVI2V paths give it (17 frames at
     512x768, CFG-doubled), plus kernel 1's head_dim 160 instantiation at
     level 2 of 1024x1024, with the error tolerance and CUDA-event times.
  4. TV2V: the full-width SD-1.5 TV2V engine (seeded random weights, bf16,
     the luminance depth stand-in), its network through the kernels against
     plain attention, then one clip edit through ``edit_clip``: 17 frames at
     512x768, CFG 7.5, DPM++2S-ancestral, 3 steps (5 network rows).
  5. TVI2V: the full-width TVI2V engine (CFCA centre+self, structure and
     appearance ControlNets, seeded random weights, bf16, a seeded random
     full-size DPT-Hybrid depth annotator), its network check, then one
     reference-guided edit: 17x512x768, an edited reference frame (the
     centre frame with its colours shifted), ``--prior_type ref`` with
     prior_coefficient_x 0.03, CFG 7, 3 steps.
  Launch counts are reset just before each edit and read just after, per
  stage; every kernel of that path must have run (on the TVI2V path:
  kernel 1 at n_k = n_q and at n_k = 2 * n_q, kernel 2, and kernel 3 in
  both the VAE encoder and decoder).

The second-to-last line is the kernels' JSON record (``launches`` from the
TVI2V edit, ``launches_by_path`` from both), the last line the device
JSON.  Any failed phase exits non-zero before those lines.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

STEPS, SEED = 3, 0
T, H, W = 17, 512, 768
PRIOR_COEFFICIENT_X = 0.03
TOLERANCE = 2e-2  # max abs error, bf16 out: 2^-8 output rounding + bf16 P
# relative error of a full bf16 network forward, kernels vs plain attention:
# bf16 rounding differences inside attention compound through ~70 layers
ROUTE_TOLERANCE = 5e-2


def _variant_sum(stages, variant):
    return sum(n for counts in stages.values() for k, n in counts.items()
               if k.startswith("spatial_attention[") and variant in k)


# every kernel and variant: its wrapper ("kernel"), the shapes it is checked
# at ((B, H, N_q, D), N_k, compare batches), and its launch count from a
# path's per-stage counts
KERNELS = (
    dict(name="spatial_attention", kernel="spatial",
         source="ccedit_tpu_torch/csrc/spatial_attention.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:112",
         shapes=(((34, 8, 6144, 40), 6144, 1), ((34, 8, 1536, 80), 1536, 34),
                 ((34, 8, 1024, 160), 1024, 34)),
         count=lambda st: _variant_sum(st, "n_k=n_q")),
    dict(name="spatial_attention_1b", kernel="spatial",
         source="ccedit_tpu_torch/csrc/spatial_attention.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:93",
         shapes=(((34, 8, 6144, 40), 12288, 1), ((34, 8, 1536, 80), 3072, 34)),
         count=lambda st: _variant_sum(st, "n_k!=n_q")),
    dict(name="temporal_attention", kernel="temporal",
         source="ccedit_tpu_torch/csrc/temporal_attention.cu",
         replaces="ccedit_tpu/ops/temporal_attention.py:47",
         shapes=(((12288, 8, 17, 40), 17, 12288), ((3072, 8, 17, 80), 17, 3072),
                 ((768, 8, 17, 160), 17, 768)),
         count=lambda st: sum(c.get("temporal_attention", 0) for c in st.values())),
    dict(name="flash_attention", kernel="flash",
         source="ccedit_tpu_torch/csrc/flash_attention.cu",
         replaces="ccedit_tpu/ops/attention.py:203",
         shapes=(((17, 1, 6144, 512), 6144, 17),),
         count=lambda st: st.get("decode", {}).get("flash_attention", 0)),
    dict(name="flash_attention_encoder", kernel="flash",
         source="ccedit_tpu_torch/csrc/flash_attention.cu",
         replaces="ccedit_tpu/ops/attention.py:203",
         shapes=(((1, 1, 6144, 512), 6144, 1),),
         count=lambda st: st.get("encode", {}).get("flash_attention", 0)),
)
# the kernels each path must launch
PATH_KERNELS = {
    "tv2v": ("spatial_attention", "temporal_attention", "flash_attention"),
    "tvi2v": tuple(k["name"] for k in KERNELS),
}


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def model_layout(shape, gen, device):
    """A (B, H, N, D) bf16 operand as the model makes it: a head-split view
    of a (B, N, H*D) projection."""
    import torch

    b, h, n, d = shape
    x = torch.randn((b, n, h, d), generator=gen, device=device, dtype=torch.float32)
    return x.to(torch.bfloat16).permute(0, 2, 1, 3)


def check_kernels(device) -> list:
    import torch

    from ccedit_tpu_torch.ops import flash_attention as fa
    from ccedit_tpu_torch.ops import spatial_attention as sa
    from ccedit_tpu_torch.ops import temporal_attention as ta

    fns = {
        "spatial": (sa.kv_resident_attention, sa.plain_spatial_attention),
        "temporal": (ta.small_seq_attention, ta.plain_temporal_attention),
        "flash": (fa.flash_attention, fa.plain_flash_attention),
    }
    gen = torch.Generator(device=device).manual_seed(0)
    records = []
    for spec in KERNELS:
        name = spec["name"]
        kernel, plain = fns[spec["kernel"]]
        per_shape = []
        for shape, n_k, nb in spec["shapes"]:
            q = model_layout(shape, gen, device)
            k, v = (model_layout(shape[:2] + (n_k, shape[3]), gen, device) for _ in range(2))
            scale = shape[-1] ** -0.5
            full_ms = cuda_time_ms(lambda: kernel(q, k, v, scale), 5)
            qs, ks, vs = q[:nb], k[:nb], v[:nb]
            out = kernel(qs, ks, vs, scale)
            ref = plain(qs, ks, vs, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(out.float()).all().item())
            ms = cuda_time_ms(lambda: kernel(qs, ks, vs, scale), 5)
            plain_ms = cuda_time_ms(lambda: plain(qs, ks, vs, scale), 3)
            cmp_shape = (nb,) + tuple(shape[1:])
            print(f"[kernels] {name} q {shape} n_k {n_k}: full {full_ms:.4f} ms; compared on "
                  f"{cmp_shape}: max_abs_err {err:.3e} (tol {TOLERANCE:.0e}), "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            if not finite or not err <= TOLERANCE:
                raise RuntimeError(f"{name} at {shape} x {n_k} disagrees with its plain "
                                   f"version: max_abs_err {err} (finite={finite})")
            per_shape.append(dict(shape=list(shape), n_k=n_k, compare_shape=list(cmp_shape),
                                  max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  full_shape_ms=full_ms))
            del q, k, v, out, ref
            torch.cuda.empty_cache()
        first = per_shape[0]
        records.append(dict(name=name, route="cuda", source=spec["source"],
                            replaces=spec["replaces"], launches=0, max_abs_err=max(p["max_abs_err"] for p in per_shape),
                            ms=first["ms"], plain_ms=first["plain_ms"], shapes=per_shape))
    return records


def check_network_routes(engine, device, seed: int) -> float:
    """One full-width network forward through the kernels against the same
    forward with every attention on its plain version, at a small input
    (3 frames of 256x256: 1024-token spatial attention, 2048-key CFCA and
    2048-row temporal attention, every kernel route of the network).
    Returns max|diff| / max|plain|."""
    import torch

    from ccedit_tpu_torch.ops import attention as att

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((2, 3, 32, 32, 4), generator=gen, device=device).to(torch.bfloat16)
    ts = torch.tensor([500, 500], device=device)
    cond = {"crossattn": torch.randn((2, 77, 768), generator=gen, device=device).to(torch.bfloat16),
            "control_hint": torch.rand((2, 3, 256, 256, 3), generator=gen, device=device)
            .mul(2).sub(1).to(torch.bfloat16)}
    if engine.network.controlnet_img is not None:
        cond["cond_feat"] = torch.randn((2, 32, 32, 4), generator=gen,
                                        device=device).to(torch.bfloat16)
    with torch.no_grad():
        out_k = engine.network(x, ts, cond).float()
        saved = dict(att._ROUTES)
        att._ROUTES.update({k: att.plain_attention for k in saved})
        try:
            out_p = engine.network(x, ts, cond).float()
        finally:
            att._ROUTES.update(saved)
    if not bool(torch.isfinite(out_k).all()):
        raise FloatingPointError("network output through the kernels is not finite")
    return ((out_k - out_p).abs().max() / out_p.abs().max()).item()


def run_path(path: str, device, steps: int, seed: int) -> dict:
    """Build the path's full-width engine, check its network's routes, and
    edit one synthetic 17x512x768 clip with the launch counts reset just
    before and read, per stage, just after.  Returns the per-stage counts."""
    import numpy as np
    import torch

    from ccedit_tpu_torch.cli.pipeline import base_parser, edit_clip, load_engine
    from ccedit_tpu_torch.config import TV2V_CONFIG, TVI2V_CONFIG
    from ccedit_tpu_torch.data.video import moving_gradient_clip
    from ccedit_tpu_torch.ops import attention as att

    tvi2v = path == "tvi2v"
    cfg_scale = 7.0 if tvi2v else 7.5
    argv = ["--bf16", "--device", str(device), "--seed", str(seed), "--H", str(H),
            "--W", str(W), "--num_keyframes", str(T), "--sample_steps", str(steps),
            "--cfg_scale", str(cfg_scale)]
    args = base_parser().parse_args(argv + ([] if tvi2v else ["--fake_annotator"]))
    t0 = time.perf_counter()
    engine, _ = load_engine(args, steps, TVI2V_CONFIG if tvi2v else TV2V_CONFIG)
    torch.cuda.synchronize()
    modules = {"network": engine.network, "vae": engine.vae, "conditioner": engine.conditioner}
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in modules.items()}
    print(f"[{path}] engine built in {time.perf_counter() - t0:.1f} s: "
          f"{sum(n_params.values()) / 1e9:.3f} B parameters ("
          + ", ".join(f"{k} {v / 1e6:.1f} M" for k, v in n_params.items()) + "), bf16",
          flush=True)

    rel = check_network_routes(engine, device, seed)
    print(f"[{path}] network through kernels vs plain attention at 3x256x256: "
          f"max|diff|/max|plain| = {rel:.3e} (tol {ROUTE_TOLERANCE:.0e})", flush=True)
    if not rel <= ROUTE_TOLERANCE:
        raise RuntimeError(f"{path} network through the kernels disagrees with plain "
                           f"attention: {rel}")

    frames = moving_gradient_clip(T, H, W)
    extra = {}
    if tvi2v:  # the edited reference: the centre frame with its colours shifted
        extra = dict(reference=np.ascontiguousarray(np.roll(frames[T // 2], 1, axis=-1)),
                     prior_type="ref", prior_coefficient_x=PRIOR_COEFFICIENT_X)
    gen = torch.Generator(device=device).manual_seed(seed)
    stages, launches = {}, {}
    torch.cuda.reset_peak_memory_stats(device)
    att.reset_launch_counts()
    t0 = time.perf_counter()
    out = edit_clip(engine, frames, "a robot bear walking through the snow",
                    "ugly, low quality", cfg_scale, steps, gen, stage_seconds=stages,
                    stage_launches=launches, **extra)
    total = time.perf_counter() - t0
    counts = att.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    summed = {k: sum(c.get(k, 0) for c in launches.values()) for k in counts}
    if summed != counts:
        raise RuntimeError(f"per-stage launch counts {summed} do not add up to {counts}")
    print(f"[{path}] edit_clip {T}x{H}x{W}, {steps} steps ({2 * steps - 1} network rows), "
          f"CFG {cfg_scale}: {total:.2f} s; stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"; peak memory {peak_gb:.2f} GB", flush=True)
    print(f"[{path}] kernel launches by stage {json.dumps(launches)}", flush=True)
    if out.dtype != np.uint8 or out.shape != (T, H, W, 3):
        raise RuntimeError(f"edit_clip returned {out.dtype} {out.shape}")
    print(f"[{path}] output uint8 {out.shape}, mean {out.mean():.2f}, std {out.std():.2f}",
          flush=True)
    del engine, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def reset_launches():
    from ccedit_tpu_torch.ops import attention as att

    att.reset_launch_counts()


def main() -> int:
    # phase 1: device
    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if torch.cuda.device_count() < 1:
        return fail("no CUDA device")
    try:
        from ccedit_tpu_torch.ops import build
    except ImportError as e:
        return fail(f"the port package is not importable from here: {e}")
    device = torch.device("cuda:0")
    smi = gpu_line()
    print(smi, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    # phase 2: build
    path, seconds, log = build.build(verbose=True)
    print(f"[build] {path.name} in {seconds:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)
    build.library()

    # phase 3: kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = check_kernels(device)

    # phases 4 and 5: the TV2V and TVI2V edits, with the launch counts of each
    by_path = {p: run_path(p, device, steps=STEPS, seed=SEED) for p in PATH_KERNELS}
    for rec, spec in zip(records, KERNELS):
        rec["launches_by_path"] = {p: spec["count"](st) for p, st in by_path.items()}
        rec["launches"] = rec["launches_by_path"]["tvi2v"]
        for p, names in PATH_KERNELS.items():
            if rec["name"] in names and rec["launches_by_path"][p] <= 0:
                return fail(f"the {p} path never launched {rec['name']}")

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
