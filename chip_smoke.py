#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccedit_tpu_torch) on one GPU.

    python3 chip_smoke.py      # one GPU, a few minutes with the kernels' build

Phases:
  1. device: CUDA present, one card; prints nvidia-smi's name and power limit.
  2. build: the CUDA kernels in ccedit_tpu_torch/csrc, with nvcc, timed.
  3. kernels: each kernel and variant against its plain PyTorch version in
     bf16 at the shapes the TV2V, TVI2V and training paths give it (17
     frames at 512x768, CFG-doubled; training: 4 clips of 12 frames at
     384x512), plus kernel 1's head_dim 160 instantiation at level 2 of
     1024x1024, with the error tolerance and CUDA-event times.  The backward
     kernel (4) is held to ``plain_spatial_attention_bwd`` on dq, dk and dv.
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
  6. train: the full-width TV2V training engine of ``TV2V_TRAIN_CONFIG``
     (seeded random fp32 master weights, the zero-initialised temporal
     layers included; a random full-size DPT-Hybrid inside the step;
     ``use_checkpoint``; AdamW; bf16 autocast; ``spatial_tv2v``: only the
     UNet's temporal layers train).  Its trainable gradients through the
     kernels are held, tensor by tensor, to the same step on plain attention
     at a small input (12 frames of 256x512), and the same step with kernel
     4's dq and dk zeroed must fail that check; then ``Trainer.fit`` takes
     1 warm-up and 3 timed steps at batch 4 of 12-frame 384x512 synthetic
     clips.  The frozen
     parameters must stay bit-identical, every trainable tensor must move,
     and each step must launch the backward kernel 5 times at d 40 and 5 at
     d 80 (the UNet's level-0 and level-1 self-attentions).
  Launch counts are reset just before each path and read just after (per
  stage for the edits); every kernel of that path must have run (on the
  TVI2V path: kernel 1 at n_k = n_q and at n_k = 2 * n_q, kernel 2, and
  kernel 3 in both the VAE encoder and decoder).

The second-to-last line is the kernels' JSON record (``launches`` from the
training path for the kernels it runs, else from the TVI2V edit;
``launches_by_path`` from all three), the last line the device JSON.  Any
failed phase exits non-zero before those lines.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

STEPS, SEED = 3, 0
T, H, W = 17, 512, 768
PRIOR_COEFFICIENT_X = 0.03
TOLERANCE = 2e-2  # max abs error, bf16 out: 2^-8 output rounding + bf16 P
# backward kernel: max|kernel - plain| / max|plain| of dq, dk and dv; bf16
# P and dS feed its products, the outputs round to bf16
BWD_TOLERANCE = 2e-2
# relative error of a full bf16 network forward, kernels vs plain attention:
# bf16 rounding differences inside attention compound through ~70 layers
ROUTE_TOLERANCE = 5e-2
# ||g_kernels - g_plain|| / ||g_plain|| of the worst trainable tensor of a
# bf16-autocast training step (the forward's rounding differences, then the
# backward's, through the whole UNet): 2.3e-2 sound, 1.7e-1 with kernel 4's
# dq and dk zeroed (H100 run); the whole gradient's ratio, 4.3e-3 against
# 1.0e-2, separates the two far less and is only printed
GRAD_TOLERANCE = 6e-2
GRAD_CHECK_T = 12  # frames of the gradient check, the recipe's T
LEAF_FLOOR = 1e-2  # per-tensor ratios only where ||g_plain|| >= this of the largest
TRAIN_BATCH, TRAIN_T, TRAIN_H, TRAIN_W = 4, 12, 384, 512
TRAIN_STEPS = 4  # 1 warm-up + 3 timed
# backward launches a training step: the UNet's spatial self-attentions at
# level 0 (input blocks 1, 2; output blocks 9-11) and level 1 (4, 5; 6-8)
BWD_PER_STEP = {"d40": 5, "d80": 5}


def _variant_sum(stages, variant):
    return sum(n for counts in stages.values() for k, n in counts.items()
               if k.startswith("spatial_attention[") and variant in k)


# every kernel and variant: its wrapper ("kernel"), the shapes it is checked
# at ((B, H, N_q, D), N_k, compare batches), and its launch count from a
# path's per-stage counts
KERNELS = (
    dict(name="spatial_attention", kernel="spatial",
         source="ccedit_tpu_torch/csrc/spatial_attention.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:113",
         shapes=(((34, 8, 6144, 40), 6144, 1), ((34, 8, 1536, 80), 1536, 34),
                 ((34, 8, 1024, 160), 1024, 34), ((48, 8, 3072, 40), 3072, 4),
                 ((48, 8, 768, 80), 768, 48)),
         count=lambda st: _variant_sum(st, "n_k=n_q")),
    dict(name="spatial_attention_1b", kernel="spatial",
         source="ccedit_tpu_torch/csrc/spatial_attention.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:93",
         shapes=(((34, 8, 6144, 40), 12288, 1), ((34, 8, 1536, 80), 3072, 34)),
         count=lambda st: _variant_sum(st, "n_k!=n_q")),
    dict(name="temporal_attention", kernel="temporal",
         source="ccedit_tpu_torch/csrc/temporal_attention.cu",
         replaces="ccedit_tpu/ops/temporal_attention.py:48",
         shapes=(((12288, 8, 17, 40), 17, 12288), ((3072, 8, 17, 80), 17, 3072),
                 ((768, 8, 17, 160), 17, 768), ((12288, 8, 12, 40), 12, 12288),
                 ((3072, 8, 12, 80), 12, 3072), ((768, 8, 12, 160), 12, 768)),
         count=lambda st: sum(c.get("temporal_attention", 0) for c in st.values())),
    dict(name="flash_attention", kernel="flash",
         source="ccedit_tpu_torch/csrc/flash_attention.cu",
         replaces="ccedit_tpu/ops/attention.py:203",
         shapes=(((17, 1, 6144, 512), 6144, 17),),
         count=lambda st: st.get("decode", {}).get("flash_attention", 0)),
    dict(name="flash_attention_encoder", kernel="flash",
         source="ccedit_tpu_torch/csrc/flash_attention.cu",
         replaces="ccedit_tpu/ops/attention.py:203",
         shapes=(((1, 1, 6144, 512), 6144, 1), ((48, 1, 3072, 512), 3072, 4)),
         count=lambda st: sum(c.get("flash_attention", 0) for stage, c in st.items()
                              if stage != "decode")),
    dict(name="spatial_attention_bwd", kernel="spatial_bwd",
         source="ccedit_tpu_torch/csrc/spatial_attention_bwd.cu",
         replaces="ccedit_tpu/ops/attention.py:173",
         shapes=(((48, 8, 3072, 40), 3072, 4), ((48, 8, 768, 80), 768, 48),
                 ((8, 8, 1024, 160), 1024, 8), ((4, 8, 3072, 40), 6144, 1)),
         count=lambda st: sum(c.get("spatial_attention_bwd", 0) for c in st.values())),
)
# the kernels each path must launch
PATH_KERNELS = {
    "tv2v": ("spatial_attention", "temporal_attention", "flash_attention"),
    "tvi2v": tuple(k["name"] for k in KERNELS if k["name"] != "spatial_attention_bwd"),
    "train": ("spatial_attention", "temporal_attention", "flash_attention_encoder",
              "spatial_attention_bwd"),
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


def check_backward(shape, n_k, nb, gen, device) -> dict:
    """Kernel 4 at one shape: its full-shape time, and dq, dk, dv against
    ``plain_spatial_attention_bwd`` on the first ``nb`` batch rows (the
    plain version's fp32 scores do not fit at every full shape)."""
    import torch

    from ccedit_tpu_torch.ops import spatial_attention as sa

    q = model_layout(shape, gen, device)
    k, v = (model_layout(shape[:2] + (n_k, shape[3]), gen, device) for _ in range(2))
    do = model_layout(shape, gen, device)
    scale = shape[-1] ** -0.5
    b, h, n_q, _ = shape
    lse = torch.empty((b * h, n_q), device=device, dtype=torch.float32)
    out = sa._forward(q, k, v, scale, lse)
    full_ms = cuda_time_ms(lambda: sa.spatial_attention_bwd(q, k, v, out, do, lse, scale), 5)
    sl = slice(0, nb * h)
    qs, ks, vs, os_, dos, lses = q[:nb], k[:nb], v[:nb], out[:nb], do[:nb], lse[sl]
    grads = sa.spatial_attention_bwd(qs, ks, vs, os_, dos, lses, scale)
    refs = sa.plain_spatial_attention_bwd(*(x.float() for x in (qs, ks, vs, dos)), scale)
    torch.cuda.synchronize()
    errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs)]
    rels = [e / r.float().abs().max().item() for e, r in zip(errs, refs)]
    finite = all(bool(torch.isfinite(g.float()).all().item()) for g in grads)
    ms = cuda_time_ms(lambda: sa.spatial_attention_bwd(qs, ks, vs, os_, dos, lses, scale), 5)
    plain_ms = cuda_time_ms(lambda: sa.plain_spatial_attention_bwd(qs, ks, vs, dos, scale), 3)
    cmp_shape = (nb,) + tuple(shape[1:])
    print(f"[kernels] spatial_attention_bwd q {shape} n_k {n_k}: full {full_ms:.4f} ms; compared "
          f"on {cmp_shape}: dq/dk/dv max_abs_err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, "
          f"relative to max|plain| {rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e} "
          f"(tol {BWD_TOLERANCE:.0e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    if not finite or not max(rels) <= BWD_TOLERANCE:
        raise RuntimeError(f"spatial_attention_bwd at {shape} x {n_k} disagrees with its plain "
                           f"version: relative errors {rels} (finite={finite})")
    return dict(shape=list(shape), n_k=n_k, compare_shape=list(cmp_shape), max_abs_err=max(errs),
                max_rel_err=max(rels), ms=ms, plain_ms=plain_ms, full_shape_ms=full_ms)


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
        per_shape = []
        for shape, n_k, nb in spec["shapes"]:
            if spec["kernel"] == "spatial_bwd":
                per_shape.append(check_backward(shape, n_k, nb, gen, device))
                torch.cuda.empty_cache()
                continue
            kernel, plain = fns[spec["kernel"]]
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


def grad_errors(g, ref) -> dict:
    """``g`` against ``ref`` (dicts of tensors by name): the whole
    gradient's ||g - ref|| / ||ref||, and the worst tensor's ratio among
    those whose ||ref|| is at least LEAF_FLOOR of the largest (below it a
    tensor's true gradient is near zero, and its ratio is bf16 noise over
    nothing)."""
    diff = {n: (g[n] - ref[n]).norm().item() for n in ref}
    norm = {n: ref[n].norm().item() for n in ref}
    floor = LEAF_FLOOR * max(norm.values())
    leaves = {n: diff[n] / norm[n] for n in ref if norm[n] >= floor}
    worst = max(leaves, key=leaves.get)
    return dict(whole=math.sqrt(sum(d * d for d in diff.values()))
                / math.sqrt(sum(x * x for x in norm.values())),
                worst_leaf=leaves[worst], worst_leaf_name=worst, leaves_compared=len(leaves),
                leaves=len(ref))


def check_train_grads(engine, device, seed: int) -> dict:
    """The trainable parameters' gradients of one bf16-autocast training
    step through the kernels against the same step with every attention on
    its plain version, at 12 frames of 256x512 (2048-token level-0 and
    512-token level-1 spatial attention: kernels 1 and 4 at d 40 and 80;
    kernel 2 at T = 12, the recipe's, at both levels), with the same sigma,
    noise and VAE posterior noise.  The same step with a planted fault in
    kernel 4 (its dq and dk zeroed, dv kept) shows that the check can fail.
    Returns ``grad_errors`` of both against plain attention."""
    import numpy as np
    import torch

    from ccedit_tpu_torch.ops import attention as att
    from ccedit_tpu_torch.ops import spatial_attention as sa

    t = GRAD_CHECK_T
    rs = np.random.RandomState(seed)
    clip = rs.uniform(-1, 1, (1, t, 256, 512, 3)).astype(np.float32)
    batch = {"jpg": clip, "txt": ["a robot bear walking through the snow"], "control_hint": clip}
    gen = torch.Generator(device=device)
    overrides = dict(
        sigmas=torch.tensor([engine.denoiser.sigmas_np[500]], device=device),
        noise=torch.randn((1, t, 32, 64, 4), generator=gen.manual_seed(seed), device=device),
        vae_noise=torch.randn((1, t, 32, 64, 4), generator=gen, device=device))
    params = engine.trainable_parameters()

    def grads():
        for p in params.values():
            p.grad = None
        engine.backward_step(batch, gen.manual_seed(seed + 1), torch.bfloat16, **overrides)
        return {n: p.grad.float() for n, p in params.items()}

    att.reset_launch_counts()
    g_kernels = grads()
    counts = att.launch_counts()
    saved = dict(att._ROUTES)
    att._ROUTES.update({k: att.plain_attention for k in saved})
    try:
        g_plain = grads()
    finally:
        att._ROUTES.update(saved)
    kernel_bwd = sa.SpatialAttention.backward

    def faulty_bwd(ctx, do):
        dq, dk, dv, _ = kernel_bwd(ctx, do)
        return torch.zeros_like(dq), torch.zeros_like(dk), dv, None

    sa.SpatialAttention.backward = staticmethod(faulty_bwd)
    try:
        g_fault = grads()
    finally:
        sa.SpatialAttention.backward = staticmethod(kernel_bwd)
    for p in params.values():
        p.grad = None
    for key in ("spatial_attention_bwd[d40 n_k=n_q]", "spatial_attention_bwd[d80 n_k=n_q]"):
        if counts.get(key, 0) <= 0:
            raise RuntimeError(f"the gradient check never launched {key}: {counts}")
    if counts.get("temporal_attention", 0) <= 0:
        raise RuntimeError(f"the gradient check never launched temporal_attention: {counts}")
    if not all(bool(torch.isfinite(g).all()) for g in g_kernels.values()):
        raise FloatingPointError("training gradients through the kernels are not finite")
    return dict(kernels=grad_errors(g_kernels, g_plain), fault=grad_errors(g_fault, g_plain))


def run_train(device, seed: int) -> dict:
    """Phase 6: the TV2V training path at the recipe's batch and geometry.
    Returns the launch counts of the ``Trainer.fit`` run, as one stage."""
    import shutil

    import torch

    from ccedit_tpu_torch.cli.train import build_train_engine
    from ccedit_tpu_torch.config import TV2V_TRAIN_CONFIG, build_lr_scheduler
    from ccedit_tpu_torch.data.dataset import DataLoader, SyntheticVideoDataset
    from ccedit_tpu_torch.ops import attention as att
    from ccedit_tpu_torch.train.freeze import count_trainable, freeze_mask
    from ccedit_tpu_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    engine = build_train_engine(TV2V_TRAIN_CONFIG, device, seed)
    engine.make_optimizer(1e-4)  # sets the freeze policy's requires_grad flags
    torch.cuda.synchronize()
    net_counts = count_trainable(engine.network.named_parameters(),
                                 freeze_mask(engine.network.named_parameters(), engine.freeze_policy))
    total = sum(p.numel() for m in (engine.network, engine.vae, engine.conditioner)
                for p in m.parameters())
    print(f"[train] engine built in {time.perf_counter() - t0:.1f} s: freeze policy "
          f"{engine.freeze_policy}, {net_counts['trainable'] / 1e6:.1f} M trainable of "
          f"{total / 1e9:.3f} B parameters (network {net_counts['total'] / 1e6:.1f} M), fp32 "
          f"masters, bf16 autocast, use_checkpoint", flush=True)

    errs = check_train_grads(engine, device, seed)
    for which, e in errs.items():
        print(f"[train] trainable gradients ({which}) vs plain attention at {GRAD_CHECK_T}x256x512: "
              f"||diff||/||plain|| of the worst of {e['leaves_compared']} of {e['leaves']} "
              f"tensors {e['worst_leaf']:.3e} ({e['worst_leaf_name']}; tol {GRAD_TOLERANCE:.0e}"
              f"), of the whole gradient {e['whole']:.3e}", flush=True)
    if not errs["kernels"]["worst_leaf"] <= GRAD_TOLERANCE:
        raise RuntimeError(f"training gradients through the kernels disagree with plain "
                           f"attention: {errs['kernels']}")
    if not errs["fault"]["worst_leaf"] > GRAD_TOLERANCE:
        raise RuntimeError(f"the gradient check passes a kernel 4 with dq = dk = 0: "
                           f"{errs['fault']}")

    trainable = engine.trainable_parameters()
    named = [(f"{prefix}.{n}", p) for prefix, m in (("network", engine.network),
                                                   ("vae", engine.vae),
                                                   ("conditioner", engine.conditioner))
             for n, p in m.named_parameters()]
    before = {n: p.detach().cpu().clone() for n, p in named}
    logdir = "build/chip_smoke_train"
    shutil.rmtree(logdir, ignore_errors=True)
    loader = DataLoader(SyntheticVideoDataset(n_items=4 * TRAIN_BATCH, num_frames=TRAIN_T,
                                              size_hw=(TRAIN_H, TRAIN_W), seed=seed),
                        batch_size=TRAIN_BATCH, seed=seed)
    cfg = TrainerConfig(logdir=logdir, max_steps=TRAIN_STEPS, ckpt_every=0, log_every=1,
                        seed=seed, base_lr=TV2V_TRAIN_CONFIG["model"]["params"]["base_learning_rate"],
                        autocast_dtype=torch.bfloat16)
    trainer = Trainer(engine, cfg, build_lr_scheduler(
        TV2V_TRAIN_CONFIG["model"]["params"]["scheduler_config"]))
    torch.cuda.reset_peak_memory_stats(device)
    att.reset_launch_counts()
    result = trainer.fit(loader, TRAIN_BATCH, resume=False)
    torch.cuda.synchronize()
    counts = att.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    timed = result.step_seconds[1:]
    step_s = sum(timed) / len(timed)
    print(f"[train] Trainer.fit bs {TRAIN_BATCH} x {TRAIN_T} x {TRAIN_H}x{TRAIN_W}, "
          f"{result.step} steps: step seconds {[round(x, 4) for x in result.step_seconds]} "
          f"(first is the warm-up); {step_s:.4f} s per step, "
          f"{TRAIN_BATCH * TRAIN_T / step_s:.2f} frames/s; peak memory {peak_gb:.2f} GB; "
          f"losses {[round(x, 5) for x in result.losses]}", flush=True)
    print(f"[train] kernel launches over {result.step} steps {json.dumps(counts)}", flush=True)
    if result.step != TRAIN_STEPS or not all(math.isfinite(x) for x in result.losses):
        raise RuntimeError(f"training ended at step {result.step} with losses {result.losses}")
    per_step = {k: counts.get(f"spatial_attention_bwd[d{d} n_k=n_q]", 0) / result.step
                for k, d in (("d40", 40), ("d80", 80))}
    if (per_step != BWD_PER_STEP
            or counts["spatial_attention_bwd"] != sum(BWD_PER_STEP.values()) * result.step):
        raise RuntimeError(f"expected {BWD_PER_STEP} backward launches a step, got {per_step} "
                           f"({counts['spatial_attention_bwd']} in all)")
    changed_frozen, unmoved = [], []
    for n, p in named:
        same = torch.equal(before[n], p.detach().cpu())
        is_trainable = n.startswith("network.") and n[len("network."):] in trainable
        if is_trainable and same:
            unmoved.append(n)
        elif not is_trainable and not same:
            changed_frozen.append(n)
    print(f"[train] {len(trainable)} trainable tensors, {len(unmoved)} unmoved; "
          f"{len(named) - len(trainable)} frozen tensors, {len(changed_frozen)} changed", flush=True)
    if changed_frozen or unmoved:
        raise RuntimeError(f"frozen tensors changed: {changed_frozen[:5]}; trainable tensors "
                           f"that did not move: {unmoved[:5]}")
    del engine, trainer, before
    gc.collect()
    torch.cuda.empty_cache()
    return {"train": counts}


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

    # phases 4 and 5: the TV2V and TVI2V edits; phase 6: training; with the
    # launch counts of each
    by_path = {p: run_path(p, device, steps=STEPS, seed=SEED) for p in ("tv2v", "tvi2v")}
    by_path["train"] = run_train(device, SEED)
    for rec, spec in zip(records, KERNELS):
        rec["launches_by_path"] = {p: spec["count"](st) for p, st in by_path.items()}
        rec["launches"] = rec["launches_by_path"][
            "train" if rec["name"] in PATH_KERNELS["train"] else "tvi2v"]
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
