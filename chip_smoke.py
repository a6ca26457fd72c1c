#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccedit_tpu_torch) on one GPU.

    python3 chip_smoke.py      # one GPU, a few minutes with the kernels' build

Phases:
  1. device: CUDA present, one card; prints nvidia-smi's name and power limit.
  2. build: the CUDA kernels in ccedit_tpu_torch/csrc, with nvcc, timed.
  3. kernels: each kernel and variant against its plain PyTorch version in
     bf16 (max|err| / max|plain| and cosine) at the shapes the TV2V, TVI2V and training paths give it (17
     frames at 512x768, CFG-doubled; training: 4 clips of 12 frames at
     384x512), plus kernel 1's head_dim 160 instantiation at level 2 of
     1024x1024 and ragged rows (kernel 1 at (2,8,600,40) x 600 and x 1200
     and (2,8,600,80) x 600, kernel 3 at (2,1,600,512) x 600), with the error
     tolerance and CUDA-event times.  Each forward row is compared on its
     first and its last batch slice, and kernels 1 and 3 also have their
     log-sum-exp (the forward kernel 4 needs) held to the plain
     ``logsumexp``.  The backward
     kernel (4) is held to ``plain_spatial_attention_bwd`` on dq, dk and dv
     on its first and last batch slice (ragged rows (2,8,600,40) x 600 and
     x 1200 and (2,8,600,80) x 600 on every row), with the run-to-run
     difference of its atomically summed dq printed, and with delta left
     out at the training shapes, which it must fail; at d = 512 (VAE
     training: (12,1,1024,512), the 512x512 fine-tune's (4,1,4096,512) and a
     ragged (2,1,600,512)) likewise.
     Kernel 1c (the int8 QK^T path) is held to
     ``plain_spatial_attention_int8`` and, by cosine, to exact kernel 1.
     Every shape also gets its bound (``scripts/roofline.py``: the largest of
     the tensor, exponential and memory times on the H100's published peaks)
     and the time of PyTorch's ``scaled_dot_product_attention`` on the same
     tensors (its backward alone beside kernel 4, and forward and backward
     beside kernels 1 + 4), a yardstick the port never calls.
  3b. probes: each probe script's own run, counted: the seven kernel-5
     variants (``scripts/kv_resident_attn.py``) at (272, 6144, 40), their
     first rows held to their plain versions (row sums within 1e-3 of
     max|plain|, full attention within 2e-2 of it and at cosine >= 0.9999,
     limits that the full and softmax probes fail with log2 e left out of
     their exp2 scale), and the kernel-6 GEMMs (``scripts/int8_probe.py``)
     at 1024x512x1024 and 4096^3 (the int8 product exactly), and the kernel-7
     tile sweep (``scripts/profile_blocks.py``: kernel 3's template at
     head_dim 40 over nine (BM, BN) tiles at (34, 8, 6144, 40)), each held
     as the full kernel-5 probes are, limits that every tile pair fails with
     log2 e left out of its scale.
  4. TV2V: the full-width SD-1.5 TV2V engine (seeded random weights, bf16,
     the luminance depth stand-in), its network through the kernels against
     plain attention, then one clip edit through ``edit_clip``: 17 frames at
     512x768, CFG 7.5, DPM++2S-ancestral, 3 steps (5 network rows).  Then
     the same edit with ``set_quantized_qk(True)`` (same engine, seed and
     noise): it must launch only kernel 1c at d 40/80, and its final latents
     must stay within LATENT_COSINE of the exact edit's, while the same edit
     with a planted fault (the dequant factor left out of the folded logits
     scale) must not.
  5. TVI2V: the full-width TVI2V engine (CFCA centre+self, structure and
     appearance ControlNets, seeded random weights, bf16, a seeded random
     full-size DPT-Hybrid depth annotator), its network check, then one
     reference-guided edit: 17x512x768, an edited reference frame (the
     centre frame with its colours shifted), ``--prior_type ref`` with
     prior_coefficient_x 0.03, CFG 7, 3 steps; then its quantized edit and
     the planted fault, as in phase 4 (the CFCA quantized too).
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
     d 80 (the UNet's level-0 and level-1 self-attentions).  With the int8
     switch on, ``Trainer.fit`` must refuse to start.
  7. VAE training: the SD KL-f8 autoencoder of ``VAE_TRAIN_CONFIG`` with a
     full VGG16 LPIPS and the PatchGAN (seeded random weights, fp32 masters,
     bf16 autocast, hinge loss, KL weight 1e-6, the GAN term and the
     adaptive weight live from step 0).  The generator pass's gradients
     through kernels 3 and 4 (d = 512) are held, tensor by tensor, to the
     same pass on plain attention at the step's own batch (12 images of
     256x256), and the same pass with kernel 4's dq and dk zeroed must fail
     that check; then ``VAETrainer`` takes 1 warm-up and 3 timed steps on
     synthetic images made on the card.  Each step must launch kernel 4 at
     d = 512 twice and kernel 3 four times (twice with its lse, in the
     generator pass; twice without, in the discriminator pass under
     no_grad), LPIPS must stay bit-identical, and every autoencoder and
     discriminator tensor with a nonzero gradient must move.
  Launch counts are reset just before each path and read just after (per
  stage for the edits, per step in VAE training); every kernel of that path
  must have run (on the
  TVI2V path: kernel 1 at n_k = n_q and at n_k = 2 * n_q, kernel 2, and
  kernel 3 in both the VAE encoder and decoder; on the quantized edits
  kernel 1c in place of kernel 1; on the probe path every probe variant).

The second-to-last line is the kernels' JSON record (``launches`` from the
path named by each kernel's ``path``; ``launches_by_path`` from all; ``ms``,
``bound_ms`` and ``library_ms`` at the first full shape, ``compared_ms`` and
``plain_ms`` on the slice ``plain_shape``), the last line the device JSON.
Any failed phase exits non-zero before those lines.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import subprocess
import sys
import time

STEPS, SEED = 3, 0
T, H, W = 17, 512, 768  # profile_tv2v.EDIT_GEOMETRY, the edits' clip
# phase 3's forward kernels: max|kernel - plain| / max|plain| and cosine on
# the compared slice.  The sound error is the bf16 rounding of the output
# and of P, ~2^-9 of |o| each (first H100 readings 4.9e-4 to 7.8e-3 absolute
# on outputs whose max is ~0.1 to ~2); a relative limit holds the d = 512
# and d = 40 outputs (std ~0.02-0.05), which an absolute 2e-2 would not
TOLERANCE = 2e-2
COSINE = 0.9999
# kernel 1c against exact attention: tests/test_spatial_attention.py's bound
# for the JAX int8 path
INT8_COSINE = 0.9995
# cosine of a quantized 3-step edit's final latents with the exact edit's
# (same seed and noise); the edit with the dequant factor left out of the
# folded scale must fall below it.  First reading (H100): 0.99872 TV2V and
# 0.99753 TVI2V sound, 0.778 and 0.503 with the fault
LATENT_COSINE = 0.99
# backward kernel: max|kernel - plain| / max|plain| of dq, dk and dv; bf16
# P and dS feed its products, the outputs round to bf16, and kernel 4 at d
# 40/80/160 sums dQ with atomics in an order that changes from run to run
# (a few fp32 roundings, far inside the limit)
BWD_TOLERANCE = 2e-2
# the training shapes at which kernel 4 with delta left out must fail it
DELTA_FAULT_SHAPES = ((48, 8, 3072, 40), (48, 8, 768, 80))
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
# kernels 1 and 3's lse: max |lse - log2(sum exp(scale q.k))| (fp32 sums
# in another order)
LSE_TOLERANCE = 1e-3
# VAE training: the generator pass's gradients through kernels 3 and 4 at
# d = 512 against plain attention, ||g_kernels - g_plain|| / ||g_plain|| of
# the worst tensor (bf16 autocast through the whole VAE, LPIPS and the
# discriminator): 2.3e-2 sound (the mid q/k projections 0.75-1.0e-2), 1.0
# with kernel 4's dq and dk zeroed, where those projections lose their
# whole gradient (first H100 reading); the limit of phase 6
VAE_GRAD_TOLERANCE = 6e-2
VAE_STEPS = 4  # 1 warm-up + 3 timed
# launches a VAE training step: both mid-block attentions, with their lse and
# backward in the generator pass, without either in the discriminator pass
VAE_LAUNCHES_PER_STEP = {"flash_attention": 4, "flash_attention[lse]": 2, "flash_attention_bwd": 2}


def _variant_sum(stages, prefix, variant):
    """Kernel 1's launches of ``variant`` (n_k=n_q or n_k!=n_q): exact with
    ``prefix`` "d", kernel 1c with "int8 d"."""
    return sum(n for counts in stages.values() for k, n in counts.items()
               if k.startswith(f"spatial_attention[{prefix}") and variant in k)


# every kernel and variant: its wrapper ("kernel"), the shapes it is checked
# at ((B, H, N_q, D), N_k, compare batches), the path its JSON ``launches``
# come from, and its launch count from a path's per-stage counts
KERNELS = (
    dict(name="spatial_attention", kernel="spatial", path="train",
         source="ccedit_tpu_torch/csrc/spatial_attention.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:113",
         shapes=(((34, 8, 6144, 40), 6144, 1), ((34, 8, 1536, 80), 1536, 34),
                 ((34, 8, 1024, 160), 1024, 34), ((48, 8, 3072, 40), 3072, 4),
                 ((48, 8, 768, 80), 768, 48), ((2, 8, 600, 40), 600, 1),
                 ((2, 8, 600, 80), 600, 1)),
         count=lambda st: _variant_sum(st, "d", "n_k=n_q")),
    dict(name="spatial_attention_1b", kernel="spatial", path="tvi2v",
         source="ccedit_tpu_torch/csrc/spatial_attention.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:93",
         shapes=(((34, 8, 6144, 40), 12288, 1), ((34, 8, 1536, 80), 3072, 34),
                 ((2, 8, 600, 40), 1200, 1)),
         count=lambda st: _variant_sum(st, "d", "n_k!=n_q")),
    dict(name="spatial_attention_1c", kernel="spatial_int8", path="tvi2v_int8",
         source="ccedit_tpu_torch/csrc/spatial_attention_int8.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:190",
         shapes=(((34, 8, 6144, 40), 6144, 1), ((34, 8, 1536, 80), 1536, 34),
                 ((34, 8, 6144, 40), 12288, 1), ((34, 8, 1536, 80), 3072, 34)),
         count=lambda st: _variant_sum(st, "int8 d", "n_k")),
    dict(name="temporal_attention", kernel="temporal", path="train",
         source="ccedit_tpu_torch/csrc/temporal_attention.cu",
         replaces="ccedit_tpu/ops/temporal_attention.py:48",
         shapes=(((12288, 8, 17, 40), 17, 12288), ((3072, 8, 17, 80), 17, 3072),
                 ((768, 8, 17, 160), 17, 768), ((12288, 8, 12, 40), 12, 12288),
                 ((3072, 8, 12, 80), 12, 3072), ((768, 8, 12, 160), 12, 768)),
         count=lambda st: sum(c.get("temporal_attention", 0) for c in st.values())),
    dict(name="flash_attention", kernel="flash", path="tvi2v",
         source="ccedit_tpu_torch/csrc/flash_attention.cu",
         replaces="ccedit_tpu/ops/attention.py:203",
         shapes=(((17, 1, 6144, 512), 6144, 17),),
         count=lambda st: st.get("decode", {}).get("flash_attention", 0)),
    dict(name="flash_attention_encoder", kernel="flash", path="train",
         source="ccedit_tpu_torch/csrc/flash_attention.cu",
         replaces="ccedit_tpu/ops/attention.py:203",
         shapes=(((1, 1, 6144, 512), 6144, 1), ((48, 1, 3072, 512), 3072, 4)),
         count=lambda st: sum(c.get("flash_attention", 0) for stage, c in st.items()
                              if stage != "decode")),
    dict(name="spatial_attention_bwd", kernel="spatial_bwd", path="train",
         source="ccedit_tpu_torch/csrc/spatial_attention_bwd.cu",
         replaces="ccedit_tpu/ops/attention.py:173",
         shapes=(((48, 8, 3072, 40), 3072, 4), ((48, 8, 768, 80), 768, 48),
                 ((8, 8, 1024, 160), 1024, 8), ((4, 8, 3072, 40), 6144, 1),
                 ((2, 8, 600, 40), 600, 2), ((2, 8, 600, 40), 1200, 2),
                 ((2, 8, 600, 80), 600, 2)),
         count=lambda st: sum(c.get("spatial_attention_bwd", 0) for c in st.values())),
    dict(name="flash_attention_lse", kernel="flash_lse", path="vae_train",
         source="ccedit_tpu_torch/csrc/flash_attention.cu",
         replaces="ccedit_tpu/ops/attention.py:203",
         shapes=(((12, 1, 1024, 512), 1024, 12), ((2, 1, 600, 512), 600, 1)),
         count=lambda st: sum(c.get("flash_attention[lse]", 0) for c in st.values())),
    dict(name="flash_attention_bwd", kernel="flash_bwd", path="vae_train",
         source="ccedit_tpu_torch/csrc/flash_attention_bwd.cu",
         replaces="ccedit_tpu/ops/attention.py:173",
         shapes=(((12, 1, 1024, 512), 1024, 12), ((4, 1, 4096, 512), 4096, 4),
                 ((2, 1, 600, 512), 600, 2)),
         count=lambda st: sum(c.get("flash_attention_bwd", 0) for c in st.values())),
)
# the probes (kernels 5 and 6), checked and counted in phase 3b
GEMM_VARIANTS = (("int8", True), ("bf16", False))
# the kernels each path must launch
PATH_KERNELS = {
    "tv2v": ("spatial_attention", "temporal_attention", "flash_attention"),
    "tvi2v": ("spatial_attention", "spatial_attention_1b", "temporal_attention",
              "flash_attention", "flash_attention_encoder"),
    "tv2v_int8": ("spatial_attention_1c", "temporal_attention", "flash_attention"),
    "tvi2v_int8": ("spatial_attention_1c", "temporal_attention", "flash_attention",
                   "flash_attention_encoder"),
    "train": ("spatial_attention", "temporal_attention", "flash_attention_encoder",
              "spatial_attention_bwd"),
    "vae_train": ("flash_attention_lse", "flash_attention_bwd"),
}


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_time_ms(fn, iters: int) -> float:
    from ccedit_tpu_torch.scripts.roofline import cuda_time_ms as timed

    return timed(fn, iters)


def model_layout(shape, gen, device):
    """A (B, H, N, D) bf16 operand as the model makes it: a head-split view
    of a (B, N, H*D) projection."""
    import torch

    b, h, n, d = shape
    x = torch.randn((b, n, h, d), generator=gen, device=device, dtype=torch.float32)
    return x.to(torch.bfloat16).permute(0, 2, 1, 3)


def check_backward(kind, shape, n_k, nb, gen, device) -> dict:
    """Kernel 4 (``kind`` "spatial_bwd": d 40/80/160 after kernel 1;
    "flash_bwd": d = 512 after kernel 3) at one shape: its full-shape time,
    and dq, dk, dv against its plain version on the first and the last
    ``nb`` batch rows (the plain version's fp32 scores do not fit at every
    full shape); the run-to-run max |dq difference| of two identical calls
    (kernel 4 at d 40/80/160 sums dQ with atomics); the forward (with lse) +
    kernel 4 beside SDPA's forward and backward, and SDPA's backward alone.
    At the training shapes (``DELTA_FAULT_SHAPES``) the same check must
    refuse kernel 4 with delta left out (dS = P * dP), planted by handing it
    a zero output: delta = rowsum(dO * O) = 0."""
    import torch

    from ccedit_tpu_torch.ops import flash_attention as fa
    from ccedit_tpu_torch.ops import spatial_attention as sa
    from ccedit_tpu_torch.scripts import roofline

    name, forward, backward, plain = {
        "spatial_bwd": ("spatial_attention_bwd", sa._forward, sa.spatial_attention_bwd,
                        sa.plain_spatial_attention_bwd),
        "flash_bwd": ("flash_attention_bwd", fa._forward, fa.flash_attention_bwd,
                      sa.plain_spatial_attention_bwd)}[kind]
    q = model_layout(shape, gen, device)
    k, v = (model_layout(shape[:2] + (n_k, shape[3]), gen, device) for _ in range(2))
    do = model_layout(shape, gen, device)
    scale = shape[-1] ** -0.5
    b, h, n_q, _ = shape
    lse = torch.empty((b * h, n_q), device=device, dtype=torch.float32)
    out = forward(q, k, v, scale, lse)
    full_ms = cuda_time_ms(lambda: backward(q, k, v, out, do, lse, scale), 5)
    fwd_ms = cuda_time_ms(lambda: forward(q, k, v, scale, lse), 5)
    fwd_bwd_ms, backend = roofline.sdpa_ms(q, k, v, scale, 5, grad_out=do)
    bwd_ms, _ = roofline.sdpa_ms(q, k, v, scale, 5, grad_out=do, backward_only=True)

    def compare(sl, o):
        qs, ks, vs, os_, dos = q[sl], k[sl], v[sl], o[sl], do[sl]
        lses = lse[sl.start * h:sl.stop * h]
        grads = backward(qs, ks, vs, os_, dos, lses, scale)
        refs = plain(*(x.float() for x in (qs, ks, vs, dos)), scale)
        torch.cuda.synchronize()
        rels = [((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                for g, r in zip(grads, refs)]
        errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs)]
        finite = all(bool(torch.isfinite(g.float()).all().item()) for g in grads)
        return grads, errs, rels, finite

    slices = [slice(0, nb)] + ([slice(b - nb, b)] if nb < b else [])
    results = [compare(sl, out) for sl in slices]
    errs = [max(r[1][i] for r in results) for i in range(3)]
    rels = [max(r[2][i] for r in results) for i in range(3)]
    finite = all(r[3] for r in results)
    sl = slices[0]
    again = backward(q[sl], k[sl], v[sl], out[sl], do[sl], lse[:nb * h], scale)
    rerun_dq = (results[0][0][0].float() - again[0].float()).abs().max().item()
    del results, again
    fault = ""
    if kind == "spatial_bwd" and tuple(shape) in DELTA_FAULT_SHAPES:
        _, _, fault_rels, _ = compare(sl, torch.zeros_like(out))
        fault = (f"; with delta left out dq/dk/dv relative {fault_rels[0]:.3e}/"
                 f"{fault_rels[1]:.3e}/{fault_rels[2]:.3e}")
        if not max(fault_rels) > BWD_TOLERANCE:
            raise RuntimeError(f"the backward check passes {name} at {shape} with delta left "
                               f"out: relative errors {fault_rels}")
    qs, ks, vs, os_, dos, lses = q[sl], k[sl], v[sl], out[sl], do[sl], lse[:nb * h]
    ms = cuda_time_ms(lambda: backward(qs, ks, vs, os_, dos, lses, scale), 5)
    plain_ms = cuda_time_ms(lambda: plain(qs, ks, vs, dos, scale), 3)
    bound = roofline.attention_bound(b, h, n_q, n_k, shape[3], backward=True)
    cmp_shape = (nb,) + tuple(shape[1:])
    rows = " and ".join(f"[{x.start}:{x.stop}]" for x in slices)
    print(f"[kernels] {name} q {shape} n_k {n_k}: full {full_ms:.4f} ms (bound "
          f"{bound['bound_ms']:.4f} ms, {bound['bound_what']}; SDPA backward {bwd_ms} ms "
          f"[{backend}]; forward + kernel 4 {fwd_ms + full_ms:.4f} ms, SDPA fwd+bwd "
          f"{fwd_bwd_ms} ms); compared on {cmp_shape}, batch rows {rows}: dq/dk/dv "
          f"max_abs_err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, relative to max|plain| "
          f"{rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e} (tol {BWD_TOLERANCE:.0e}); run to run "
          f"max|ddq| {rerun_dq:.3e}{fault}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    if not finite or not max(rels) <= BWD_TOLERANCE:
        raise RuntimeError(f"{name} at {shape} x {n_k} disagrees with its plain "
                           f"version: relative errors {rels} (finite={finite})")
    return dict(shape=list(shape), n_k=n_k, compare_shape=list(cmp_shape), max_abs_err=max(errs),
                max_rel_err=max(rels), rerun_max_abs_ddq=rerun_dq, compared_ms=ms,
                plain_ms=plain_ms, ms=full_ms, fwd_with_lse_ms=fwd_ms,
                kernels_fwd_bwd_ms=fwd_ms + full_ms, library_ms=bwd_ms, library_bwd_ms=bwd_ms,
                library_fwd_bwd_ms=fwd_bwd_ms,
                library=f"scaled_dot_product_attention backward [{backend}]", **bound)


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def check_kernels(device) -> list:
    """Phase 3: every kernel and variant of the paths at its shapes."""
    import torch

    from ccedit_tpu_torch.ops import flash_attention as fa
    from ccedit_tpu_torch.ops import spatial_attention as sa
    from ccedit_tpu_torch.ops import temporal_attention as ta
    from ccedit_tpu_torch.scripts import roofline

    int8 = functools.partial(sa.kv_resident_attention, quantized_qk=True)

    def with_lse(q, k, v, scale):  # kernel 3 writing its lse, as under a grad
        b, h, n_q, _ = q.shape
        return fa._forward(q, k, v, scale, torch.empty((b * h, n_q), device=device))

    fns = {
        "spatial": (sa.kv_resident_attention, sa.plain_spatial_attention),
        "spatial_int8": (int8, sa.plain_spatial_attention_int8),
        "temporal": (ta.small_seq_attention, ta.plain_temporal_attention),
        "flash": (fa.flash_attention, fa.plain_flash_attention),
        "flash_lse": (with_lse, fa.plain_flash_attention),
    }
    gen = torch.Generator(device=device).manual_seed(0)
    records = []
    for spec in KERNELS:
        name = spec["name"]
        per_shape = []
        for shape, n_k, nb in spec["shapes"]:
            if spec["kernel"] in ("spatial_bwd", "flash_bwd"):
                per_shape.append(check_backward(spec["kernel"], shape, n_k, nb, gen, device))
                torch.cuda.empty_cache()
                continue
            kernel, plain = fns[spec["kernel"]]
            q = model_layout(shape, gen, device)
            k, v = (model_layout(shape[:2] + (n_k, shape[3]), gen, device) for _ in range(2))
            scale = shape[-1] ** -0.5
            full_ms = cuda_time_ms(lambda: kernel(q, k, v, scale), 5)
            library_ms, backend = roofline.sdpa_ms(q, k, v, scale, 5)
            bound = roofline.attention_bound(*shape[:3], n_k, shape[3],
                                             qk_int8=spec["kernel"] == "spatial_int8")
            # the first and the last nb batch rows: a tile schedule can go
            # wrong only at the far end of the grid
            slices = [slice(0, nb)] + ([slice(shape[0] - nb, shape[0])] if nb < shape[0] else [])
            err = rel = lse_err = 0.0
            cos, finite, extra, note = 1.0, True, {}, ""
            for sl in slices:
                qs, ks, vs = q[sl], k[sl], v[sl]
                out = kernel(qs, ks, vs, scale)
                ref = plain(qs, ks, vs, scale)
                torch.cuda.synchronize()
                e = (out.float() - ref.float()).abs().max().item()
                err, rel = max(err, e), max(rel, e / ref.float().abs().max().item())
                cos = min(cos, cosine(out, ref))
                finite &= bool(torch.isfinite(out.float()).all().item())
                if spec["kernel"] in ("spatial", "flash_lse"):
                    # the lse kernel 4 reads, against log2 of the plain logsumexp
                    b, h, n_q, _ = qs.shape
                    lse = torch.empty((b * h, n_q), device=device)
                    forward = sa._forward if spec["kernel"] == "spatial" else fa._forward
                    forward(qs, ks, vs, scale, lse)
                    s_ = torch.matmul(qs.float(), ks.float().transpose(-1, -2)) * scale
                    want = (torch.logsumexp(s_, dim=-1) / math.log(2.0)).reshape(b * h, n_q)
                    lse_err = max(lse_err, (lse - want).abs().max().item())
                    del s_, want
                if spec["kernel"] == "spatial_int8":  # against exact kernel 1 on the same slice
                    extra["cosine_to_exact"] = min(extra.get("cosine_to_exact", 1.0), cosine(
                        out, sa.kv_resident_attention(qs, ks, vs, scale)))
            if spec["kernel"] in ("spatial", "flash_lse"):
                extra["lse_max_abs_err"] = lse_err
                note = f", lse max_abs_err {lse_err:.3e} (tol {LSE_TOLERANCE:.0e})"
            if spec["kernel"] == "spatial_int8":
                extra["prepass_ms"] = cuda_time_ms(lambda: sa.quantize_qk(q, k, scale), 5)
                note = (f", cosine to exact kernel 1 {extra['cosine_to_exact']:.6f} (> "
                        f"{INT8_COSINE}), its pre-pass (quantize_qk) at the full shape "
                        f"{extra['prepass_ms']:.4f} ms")
            ms = cuda_time_ms(lambda: kernel(qs, ks, vs, scale), 5)
            plain_ms = cuda_time_ms(lambda: plain(qs, ks, vs, scale), 3)
            cmp_shape = (nb,) + tuple(shape[1:])
            rows = " and ".join(f"[{sl.start}:{sl.stop}]" for sl in slices)
            print(f"[kernels] {name} q {shape} n_k {n_k}: full {full_ms:.4f} ms (bound "
                  f"{bound['bound_ms']:.4f} ms, {bound['bound_what']}; SDPA {library_ms} ms "
                  f"[{backend}]); compared on {cmp_shape}, batch rows {rows}: max_abs_err "
                  f"{err:.3e}, relative "
                  f"{rel:.3e}, cosine {cos:.7f} (max|err|/max|plain| <= {TOLERANCE:.0e}, "
                  f"cosine >= {COSINE}){note}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
            if not finite or not rel <= TOLERANCE or not cos >= COSINE:
                raise RuntimeError(f"{name} at {shape} x {n_k} disagrees with its plain "
                                   f"version: max_abs_err {err}, relative {rel}, cosine "
                                   f"{cos} (finite={finite})")
            if not extra.get("lse_max_abs_err", 0.0) <= LSE_TOLERANCE:
                raise RuntimeError(f"{name} at {shape}: its lse is off by "
                                   f"{extra['lse_max_abs_err']} (tol {LSE_TOLERANCE})")
            if "cosine_to_exact" in extra and not extra["cosine_to_exact"] > INT8_COSINE:
                raise RuntimeError(f"{name} at {shape} x {n_k}: cosine to exact kernel 1 "
                                   f"{extra['cosine_to_exact']} <= {INT8_COSINE}")
            per_shape.append(dict(shape=list(shape), n_k=n_k, compare_shape=list(cmp_shape),
                                  max_abs_err=err, max_rel_err=rel, cosine=cos,
                                  compared_ms=ms, plain_ms=plain_ms,
                                  ms=full_ms, library_ms=library_ms,
                                  library=f"scaled_dot_product_attention [{backend}]",
                                  **bound, **extra))
            del q, k, v, out, ref
            torch.cuda.empty_cache()
        records.append(record(spec, per_shape))
    return records


def record(spec, per_shape) -> dict:
    """A kernel's JSON record: its first shape's numbers and every shape's
    in ``shapes``.  ``ms``, ``bound_ms`` and ``library_ms`` are at the full
    shape; ``compared_ms`` and ``plain_ms`` are the kernel's and the plain
    version's times on the compared slice, ``plain_shape``."""
    first = per_shape[0]
    return dict(name=spec["name"], route="cuda", source=spec["source"],
                replaces=spec["replaces"], launches=0,
                max_abs_err=max(p["max_abs_err"] for p in per_shape), ms=first["ms"],
                compared_ms=first["compared_ms"], plain_ms=first["plain_ms"],
                plain_shape=first["compare_shape"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=first["library_ms"],
                library=first["library"], shapes=per_shape)


def run_probes(device):
    """Phase 3b: the probe scripts' own runs, counted.
    ``kv_resident_attn.run`` runs kernel 5's seven variants at (272, 6144,
    40) and holds each one's first rows to ``plain_probe``;
    ``int8_probe.part_kernel`` runs kernel 6 at 1024x512x1024 and 4096^3
    against ``plain_gemm`` (the int8 product exactly); ``profile_blocks.sweep``
    runs kernel 7's nine tile pairs at (34, 8, 6144, 40) against the plain
    attention (``kr.compare``'s full-attention limits).  Then the probes
    that read the logits scale, and every kernel-7 tile pair, run with log2
    e left out of it (a softmax temperature off by ln 2), a planted fault
    that ``kr.compare`` must refuse.  Returns the probes' records and their launch counts by
    variant, as one stage ("probes")."""
    from ccedit_tpu_torch.ops import flash_attention as fa
    from ccedit_tpu_torch.scripts import int8_probe as ip
    from ccedit_tpu_torch.scripts import kv_resident_attn as kr
    from ccedit_tpu_torch.scripts import profile_blocks as pb

    reset_launches()
    split = kr.run(device, iters=5)
    gemms = ip.part_kernel(device, iters=5)
    sweep = pb.sweep(device, iters=5)
    counts = {f"attention_probe[{k}]": n for k, n in kr.probe.variant_launches.items()}
    for label, _ in GEMM_VARIANTS:
        counts[f"int8_gemm[{label}]"] = sum(n for k, n in ip.gemm.variant_launches.items()
                                            if k.startswith(label))
    counts.update({f"flash_attention_tiles[{k}]": n for k, n in pb.tiles.variant_launches.items()})
    print(f"[probes] launches {json.dumps(counts)}", flush=True)
    print(f"[probes] kv_resident_attn.run: kernel 1 {split['kernel1_ms']:.4f} ms exact, "
          f"{split['kernel1_int8_ms']:.4f} ms int8 (1c); split "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split["kernel1_split_ms"].items()),
          flush=True)
    records = []
    for r, key in zip(split["variants"], kr.VARIANTS):
        limits = (f"max|err|/max|plain| <= {kr.FULL_TOLERANCE}, cosine >= {kr.FULL_COSINE}"
                  if key[0] == "full" else f"max|err|/max|plain| <= {kr.ROWSUM_TOLERANCE}")
        print(f"[probes] kernel 5 {r['variant']} {tuple(split['shape'])}: {r['ms']:.4f} ms "
              f"(bound {r['bound_ms']:.4f} ms, {r['bound_what']}; {r['library']} "
              f"{r['library_ms']} ms); on {r['plain_shape']}: max_abs_err {r['max_abs_err']:.3e}, "
              f"relative {r['max_rel_err']:.3e}, cosine {r['cosine']:.7f} ({limits}), kernel "
              f"{r['compared_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms", flush=True)
        if not r["ok"]:
            raise RuntimeError(f"probe {r['variant']} disagrees with its plain version: {r}")
        records.append(dict(
            name=f"attention_probe[{r['variant']}]", route="cuda",
            source="ccedit_tpu_torch/csrc/attention_probe.cu",
            replaces="scripts/kv_resident_attn.py" + kr.REPLACES[key], launches=0,
            **{f: r[f] for f in ("max_abs_err", "max_rel_err", "cosine", "ms", "compared_ms",
                                 "plain_ms", "plain_shape", "bound_ms", "bound_by",
                                 "bound_what", "library_ms", "library")}))
    x = kr.inputs(device, b=kr.COMPARE_ROWS)
    log2e = kr._LOG2E
    kr._LOG2E = 1.0  # the planted fault
    try:
        for key in kr.VARIANTS:
            if key[0] == "qkt":  # reads no scale
                continue
            args = kr.call_args(x, *key)
            fault = kr.compare(key[0], kr.probe(key[0], *args), kr.plain_probe(key[0], *args))
            print(f"[probes] kernel 5 {kr.variant_name(*key)} without log2 e in its scale: "
                  f"relative {fault['max_rel_err']:.3e}, cosine {fault['cosine']:.7f}", flush=True)
            if fault["ok"]:
                raise RuntimeError(f"the probe check passes {kr.variant_name(*key)} with its "
                                   f"softmax temperature off by ln 2: {fault}")
    finally:
        kr._LOG2E = log2e
    qs, ks, vs = pb.compare_inputs(device)
    ref = fa.plain_flash_attention(qs, ks, vs, pb.SCALE)
    pb._LOG2E = 1.0  # the same planted fault in kernel 7's scale
    try:
        for bm, bn in pb.TILES:
            fault = kr.compare("full", pb.tiles(qs, ks, vs, pb.SCALE, bm, bn), ref)
            print(f"[probes] kernel 7 {pb.variant_name(bm, bn)} without log2 e in its scale: "
                  f"relative {fault['max_rel_err']:.3e}, cosine {fault['cosine']:.7f}", flush=True)
            if fault["ok"]:
                raise RuntimeError(f"the sweep check passes {pb.variant_name(bm, bn)} with its "
                                   f"softmax temperature off by ln 2: {fault}")
    finally:
        pb._LOG2E = log2e
    for label, _ in GEMM_VARIANTS:
        per_shape = []
        for g in gemms:
            if not g["variant"].startswith(label):
                continue
            print(f"[probes] kernel 6 {g['variant']}: {g['ms']:.4f} ms ({g['tops']:.1f} TOP/s; "
                  f"bound {g['bound_ms']:.4f} ms, {g['bound_what']}; {g['library']} "
                  f"{g['library_ms']:.4f} ms), max_abs_err {g['max_abs_err']:.3e}, relative "
                  f"{g['max_rel_err']:.3e} ({'exact' if label == 'int8' else 'tol %.0e' % ip.BF16_TOLERANCE}"
                  f"), plain {g['plain_ms']:.4f} ms", flush=True)
            if not g["ok"]:
                raise RuntimeError(f"gemm {g['variant']} disagrees with its plain version: {g}")
            mkn = [int(s) for s in g["variant"].split()[1].split("x")]
            per_shape.append(dict(shape=mkn, compare_shape=mkn, compared_ms=g["ms"], **g))
        records.append(record(dict(name=f"int8_gemm[{label}]",
                                   source="ccedit_tpu_torch/csrc/int8_gemm.cu",
                                   replaces="scripts/int8_probe.py:"
                                   + ("142" if label == "int8" else "159")), per_shape))
    for r in sweep:
        print(f"[probes] kernel 7 {r['variant']} {tuple(r['shape'])}: {r['ms']:.4f} ms (bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_what']}; {r['library']} {r['library_ms']} ms); "
              f"on {r['plain_shape']}: max_abs_err {r['max_abs_err']:.3e}, relative "
              f"{r['max_rel_err']:.3e}, cosine {r['cosine']:.7f} (max|err|/max|plain| <= "
              f"{kr.FULL_TOLERANCE}, cosine >= {kr.FULL_COSINE}), kernel "
              f"{r['compared_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms", flush=True)
        if not r["ok"]:
            raise RuntimeError(f"kernel 7 at {r['variant']} disagrees with its plain version: {r}")
        records.append(dict(
            name=f"flash_attention_tiles[{r['variant']}]", route="cuda",
            source="ccedit_tpu_torch/csrc/flash_tiles.cu",
            replaces="scripts/profile_blocks.py:36", launches=0,
            **{f: r[f] for f in ("max_abs_err", "max_rel_err", "cosine", "ms", "compared_ms",
                                 "plain_ms", "plain_shape", "bound_ms", "bound_by",
                                 "bound_what", "library_ms", "library")}))
    return records, {"probes": counts}


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


def edit_counted(edit, device, steps: int, seed: int, label: str):
    """One edit with the launch counts reset just before it and read, per
    stage, just after.  Returns (uint8 frames, latents, per-stage counts)."""
    import numpy as np
    import torch

    from ccedit_tpu_torch.ops import attention as att

    stages, launches = {}, {}
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    out, latents = edit(steps, torch.Generator(device=device).manual_seed(seed),
                        stage_seconds=stages, stage_launches=launches, return_latents=True)
    total = time.perf_counter() - t0
    counts = att.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    summed = {k: sum(c.get(k, 0) for c in launches.values()) for k in counts}
    if summed != counts:
        raise RuntimeError(f"per-stage launch counts {summed} do not add up to {counts}")
    print(f"[{label}] edit_clip {T}x{H}x{W}, {steps} steps ({2 * steps - 1} network rows): "
          f"{total:.2f} s; stages " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"; peak memory {peak_gb:.2f} GB", flush=True)
    print(f"[{label}] kernel launches by stage {json.dumps(launches)}", flush=True)
    if out.dtype != np.uint8 or out.shape != (T, H, W, 3):
        raise RuntimeError(f"edit_clip returned {out.dtype} {out.shape}")
    if not bool(torch.isfinite(latents).all()):
        raise FloatingPointError(f"{label}: the final latents are not finite")
    print(f"[{label}] output uint8 {out.shape}, mean {out.mean():.2f}, std {out.std():.2f}",
          flush=True)
    return out, latents, launches


def run_path(path: str, device, steps: int, seed: int) -> dict:
    """Build the path's full-width engine, check its network's routes, edit
    one synthetic 17x512x768 clip exactly, then with the int8 switch on
    (same engine, seed and noise), then with the switch on and the dequant
    factor left out of the folded scale.  Returns the per-stage counts of
    the exact and the quantized edit, as paths ``path`` and
    ``path + "_int8"``."""
    import torch

    from ccedit_tpu_torch.cli.profile_tv2v import build_edit
    from ccedit_tpu_torch.ops import attention as att
    from ccedit_tpu_torch.ops import spatial_attention as sa

    t0 = time.perf_counter()
    engine, edit, cfg_scale = build_edit(path, device, seed, steps)
    torch.cuda.synchronize()
    modules = {"network": engine.network, "vae": engine.vae, "conditioner": engine.conditioner}
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in modules.items()}
    print(f"[{path}] engine built in {time.perf_counter() - t0:.1f} s: "
          f"{sum(n_params.values()) / 1e9:.3f} B parameters ("
          + ", ".join(f"{k} {v / 1e6:.1f} M" for k, v in n_params.items()) + f"), bf16, CFG "
          f"{cfg_scale}", flush=True)

    rel = check_network_routes(engine, device, seed)
    print(f"[{path}] network through kernels vs plain attention at 3x256x256: "
          f"max|diff|/max|plain| = {rel:.3e} (tol {ROUTE_TOLERANCE:.0e})", flush=True)
    if not rel <= ROUTE_TOLERANCE:
        raise RuntimeError(f"{path} network through the kernels disagrees with plain "
                           f"attention: {rel}")

    _, exact, launches = edit_counted(edit, device, steps, seed, path)
    quantize = sa.quantize_qk

    def without_dequant(q, k, scale):  # the planted fault
        q8, k8, scales = quantize(q, k, scale)
        return q8, k8, torch.full_like(scales, scale)

    try:
        att.set_quantized_qk(True)
        _, quant, launches_int8 = edit_counted(edit, device, steps, seed, f"{path}_int8")
        sa.quantize_qk = without_dequant
        _, fault, _ = edit_counted(edit, device, steps, seed, f"{path}_int8 fault")
    finally:
        sa.quantize_qk = quantize
        att.set_quantized_qk(False)
    cos_quant, cos_fault = cosine(quant, exact), cosine(fault, exact)
    print(f"[{path}_int8] final latents vs the exact edit's: cosine {cos_quant:.6f}, with the "
          f"dequant factor left out {cos_fault:.6f} (limit {LATENT_COSINE})", flush=True)
    exact_left = {k: n for st in launches_int8.values() for k, n in st.items()
                  if k.startswith(("spatial_attention[d40", "spatial_attention[d80")) and n}
    if exact_left:
        raise RuntimeError(f"the quantized {path} edit still launched exact kernel 1: {exact_left}")
    if path == "tvi2v" and _variant_sum(launches_int8, "int8 d", "n_k!=n_q") <= 0:
        raise RuntimeError("the quantized TVI2V edit never ran the CFCA through kernel 1c")
    if not cos_quant >= LATENT_COSINE:
        raise RuntimeError(f"the quantized {path} edit left the exact one: cosine {cos_quant}")
    if not cos_fault < LATENT_COSINE:
        raise RuntimeError(f"the latent check passes a kernel 1c without its dequant factor: "
                           f"cosine {cos_fault}")
    del engine, edit
    gc.collect()
    torch.cuda.empty_cache()
    return {path: launches, f"{path}_int8": launches_int8}


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


def grads_three_ways(params, backward, function):
    """The gradients of ``params`` (a dict by name) that ``backward()``
    accumulates: through the kernels, with every attention on its plain
    version, and with a planted fault in the autograd ``function``'s
    backward (kernel 4's dq and dk zeroed, dv kept).  Returns the three
    dicts of fp32 gradients and the launch counts of the first run."""
    import torch

    from ccedit_tpu_torch.ops import attention as att

    def grads():
        for p in params.values():
            p.grad = None
        backward()
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
    kernel_bwd = function.backward

    def faulty_bwd(ctx, do):
        dq, dk, dv, _ = kernel_bwd(ctx, do)
        return torch.zeros_like(dq), torch.zeros_like(dk), dv, None

    function.backward = staticmethod(faulty_bwd)
    try:
        g_fault = grads()
    finally:
        function.backward = staticmethod(kernel_bwd)
    for p in params.values():
        p.grad = None
    return g_kernels, g_plain, g_fault, counts


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

    def backward():
        engine.backward_step(batch, gen.manual_seed(seed + 1), torch.bfloat16, **overrides)

    g_kernels, g_plain, g_fault, counts = grads_three_ways(params, backward, sa.SpatialAttention)
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
    # the int8 QK^T switch trains an int8 forward under the exact backward:
    # fit must refuse, by its guard, before any step
    steps_taken = []
    train_step = engine.train_step
    engine.train_step = lambda *a, **kw: steps_taken.append(1) or train_step(*a, **kw)
    try:
        att.set_quantized_qk(True)
        Trainer(engine, cfg).fit(loader, TRAIN_BATCH, resume=False)
    except RuntimeError as e:
        if "exact arithmetic" not in str(e) or steps_taken:
            raise RuntimeError(f"with the int8 switch on, Trainer.fit took {len(steps_taken)} "
                               f"steps and raised another error: {e}") from e
        print(f"[train] with the int8 switch on, Trainer.fit refuses before any step: {e}",
              flush=True)
    else:
        raise RuntimeError("Trainer.fit trained with the int8 QK^T switch on")
    finally:
        att.set_quantized_qk(False)
        del engine.train_step
    del engine, trainer, before
    gc.collect()
    torch.cuda.empty_cache()
    return {"train": counts}


def check_vae_grads(engine, x, noise) -> dict:
    """The generator parameters' gradients of one bf16-autocast generator
    pass through kernels 3 and 4 (d = 512) against the same pass with every
    attention on its plain version, with the same images and posterior
    noise; then the same pass with a planted fault in kernel 4 (its dq and
    dk zeroed, dv kept), which the check must refuse: the mid blocks' q and
    k projections get their gradient only through dq and dk.  Returns
    ``grad_errors`` of both, and the launch counts of the first pass."""
    import torch

    from ccedit_tpu_torch.ops import flash_attention as fa

    params = engine.generator_parameters()

    def backward():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss, _ = engine.generator_loss(x, 0, noise=noise)
        loss.backward(inputs=list(params.values()))

    g_kernels, g_plain, g_fault, counts = grads_three_ways(params, backward, fa.FlashAttention)
    if not all(bool(torch.isfinite(g).all()) for g in g_kernels.values()):
        raise FloatingPointError("VAE gradients through the kernels are not finite")
    qk = {n: (g_kernels[n] - g_plain[n]).norm().item() / g_plain[n].norm().item()
          for n in g_plain if ".attn_1.q.weight" in n or ".attn_1.k.weight" in n}
    return dict(kernels=grad_errors(g_kernels, g_plain), fault=grad_errors(g_fault, g_plain),
                qk=qk, counts=counts)


def run_vae_train(device, seed: int) -> dict:
    """Phase 7: VAE GAN training at the sd-vae-ft-mse fine-tune's 12 images
    of 256x256.  Returns its launch counts, as one stage."""
    import torch

    from ccedit_tpu_torch.cli.profile_tv2v import VAE_BATCH, VAE_SIZE
    from ccedit_tpu_torch.config import VAE_TRAIN_CONFIG
    from ccedit_tpu_torch.models.autoencoder_engine import build_vae_trainer
    from ccedit_tpu_torch.ops import attention as att

    t0 = time.perf_counter()
    engine, trainer = build_vae_trainer(VAE_TRAIN_CONFIG, device, seed, disc_start=0)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(engine, name).parameters())
                for name in ("ae", "disc", "lpips")}
    print(f"[vae_train] engine built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v / 1e6:.2f} M" for k, v in n_params.items())
          + f" parameters; fp32 masters, bf16 autocast; {engine.cfg}", flush=True)

    gen = torch.Generator(device=device).manual_seed(seed)

    def images():
        return torch.rand((VAE_BATCH, VAE_SIZE, VAE_SIZE, 3), generator=gen, device=device) * 2 - 1

    x = images()
    latent = VAE_SIZE // 2 ** (len(engine.ae.ch_mult) - 1)
    noise = torch.randn((VAE_BATCH, latent, latent, 4), generator=gen, device=device)
    errs = check_vae_grads(engine, x, noise)
    for which in ("kernels", "fault"):
        e = errs[which]
        print(f"[vae_train] generator gradients ({which}) vs plain attention at {VAE_BATCH}x"
              f"{VAE_SIZE}x{VAE_SIZE}: ||diff||/||plain|| of the worst of {e['leaves_compared']} "
              f"of {e['leaves']} tensors {e['worst_leaf']:.3e} ({e['worst_leaf_name']}; tol "
              f"{VAE_GRAD_TOLERANCE:.0e}), of the whole gradient {e['whole']:.3e}", flush=True)
    print(f"[vae_train] mid-attention q/k projections, kernels vs plain: "
          + ", ".join(f"{n} {r:.3e}" for n, r in errs["qk"].items())
          + f"; launches {json.dumps(errs['counts'])}", flush=True)
    if (errs["counts"].get("flash_attention_bwd", 0) != 2
            or errs["counts"].get("flash_attention[lse]", 0) != 2):
        raise RuntimeError(f"the gradient check did not launch kernel 3 with its lse and kernel 4 "
                           f"twice each: {errs['counts']}")
    if not errs["kernels"]["worst_leaf"] <= VAE_GRAD_TOLERANCE:
        raise RuntimeError(f"VAE gradients through the kernels disagree with plain attention: "
                           f"{errs['kernels']}")
    if not errs["fault"]["worst_leaf"] > VAE_GRAD_TOLERANCE:
        raise RuntimeError(f"the gradient check passes a kernel 4 with dq = dk = 0: {errs['fault']}")

    trained = {f"{m}.{n}": p for m in ("ae", "disc")
               for n, p in getattr(engine, m).named_parameters()}
    before = {n: p.detach().clone() for n, p in engine.named_parameters()}
    moved_grad = {n: False for n in trained}
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    seconds, logs, per_step = [], [], []
    for _ in range(VAE_STEPS):
        counts0 = att.launch_counts()
        t1 = time.perf_counter()
        step_logs = trainer.train_step(images(), gen)
        logs.append({k: float(v) for k, v in step_logs.items()})  # waits for the step
        seconds.append(time.perf_counter() - t1)
        counts1 = att.launch_counts()
        per_step.append({k: counts1.get(k, 0) - counts0.get(k, 0) for k in VAE_LAUNCHES_PER_STEP})
        for n, p in trained.items():
            moved_grad[n] |= p.grad is not None and bool(p.grad.any())
    torch.cuda.synchronize()
    counts = att.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    step_s = sum(seconds[1:]) / len(seconds[1:])
    print(f"[vae_train] VAETrainer {VAE_BATCH} x {VAE_SIZE}x{VAE_SIZE}, {VAE_STEPS} steps: step "
          f"seconds {[round(t, 4) for t in seconds]} (first is the warm-up); {step_s:.4f} s per "
          f"step, {VAE_BATCH / step_s:.2f} images/s; peak memory {peak_gb:.2f} GB", flush=True)
    print(f"[vae_train] logs of the last step {json.dumps(logs[-1])}", flush=True)
    print(f"[vae_train] kernel launches a step {json.dumps(per_step)}", flush=True)
    if any(st != VAE_LAUNCHES_PER_STEP for st in per_step):
        raise RuntimeError(f"expected {VAE_LAUNCHES_PER_STEP} launches a step, got {per_step}")
    if not all(math.isfinite(v) for step_logs in logs for v in step_logs.values()):
        raise FloatingPointError(f"VAE training logs are not finite: {logs}")
    changed_lpips = [n for n, p in engine.lpips.named_parameters()
                     if not torch.equal(p, before[f"lpips.{n}"])]
    unmoved = [n for n, p in trained.items() if moved_grad[n] and torch.equal(p, before[n])]
    print(f"[vae_train] {sum(moved_grad.values())} of {len(trained)} trained tensors had a "
          f"nonzero gradient, {len(unmoved)} of them unmoved; {len(changed_lpips)} LPIPS tensors "
          f"changed", flush=True)
    if changed_lpips or unmoved:
        raise RuntimeError(f"LPIPS tensors changed: {changed_lpips[:5]}; tensors with a gradient "
                           f"that did not move: {unmoved[:5]}")
    del engine, trainer, before
    gc.collect()
    torch.cuda.empty_cache()
    return {"vae_train": counts}


def reset_launches():
    """Every launch count to 0: the attention kernels' and the probes' (kernel
    7's tile sweep among them)."""
    from ccedit_tpu_torch.ops import attention as att
    from ccedit_tpu_torch.scripts import int8_probe as ip
    from ccedit_tpu_torch.scripts import kv_resident_attn as kr
    from ccedit_tpu_torch.scripts import profile_blocks as pb

    att.reset_launch_counts()
    for wrapper in (kr.probe, ip.gemm, pb.tiles):
        wrapper.launches = 0
        wrapper.variant_launches.clear()


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

    # phase 3: kernels against their plain versions; 3b: the probes'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = check_kernels(device)
    probe_records, probe_counts = run_probes(device)

    # phases 4 and 5: the TV2V and TVI2V edits, exact and quantized; phase
    # 6: training; phase 7: VAE training; with the launch counts of each
    by_path = {"probes": probe_counts}
    for p in ("tv2v", "tvi2v"):
        by_path.update(run_path(p, device, steps=STEPS, seed=SEED))
    by_path["train"] = run_train(device, SEED)
    by_path["vae_train"] = run_vae_train(device, SEED)
    for rec, spec in zip(records, KERNELS):
        rec["launches_by_path"] = {p: spec["count"](st) for p, st in by_path.items()}
        rec["launches"] = rec["launches_by_path"][spec["path"]]
        for p, names in PATH_KERNELS.items():
            if rec["name"] in names and rec["launches_by_path"][p] <= 0:
                return fail(f"the {p} path never launched {rec['name']}")
    for rec in probe_records:
        rec["launches"] = by_path["probes"]["probes"].get(rec["name"], 0)
        if rec["launches"] <= 0:
            return fail(f"the probe scripts never launched {rec['name']}")
    records += probe_records

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
