#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccedit_tpu_torch) on one GPU.

    python3 chip_smoke.py      # one GPU, a few minutes with the kernels' build

Phases:
  1. device: CUDA present, one card; prints nvidia-smi's name and power limit.
  2. build: the CUDA kernels in ccedit_tpu_torch/csrc, with nvcc, timed.
  3. kernels: each kernel and variant against its plain PyTorch version in
     bf16 (max|err| / max|plain| and cosine) at the shapes the TV2V, TVI2V and training paths give it (17
     frames at 512x768, CFG-doubled; training: 4 clips of 12 frames at
     384x512, and TVI2V's 17 frames whose CFCA runs kernels 1 and 4 at n_k
     = 2 n_q), plus kernel 1's head_dim 160 instantiation at level 2 of
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
     out at the training shapes (TVI2V's CFCA shapes among them), which it
     must fail; at d = 512 (VAE
     training: (12,1,1024,512), the 512x512 fine-tune's (4,1,4096,512) and a
     ragged (2,1,600,512)) likewise, with delta left out at every shape.
     Kernel 1c (the int8 QK^T path, with its pre-pass) is held to
     ``plain_spatial_attention_int8`` and, by cosine, to exact kernel 1, at
     the level-0/1 shapes and ragged rows ((2,8,600,40) x 600 and x 1200,
     (2,8,600,80) x 600); its pre-pass (``csrc/quantize_qk.cu``) is held
     bit for bit to its plain version (``quantize_qk``, padded) at the four
     level-0/1 shapes, on inputs planted with exact .5 ties.
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
     at 1024x512x1024 and 4096^3 (the int8 product exactly, which the int8
     product with B's transposition skipped must fail), and the kernel-7
     tile sweep (``scripts/profile_blocks.py``: kernel 1's template at
     head_dim 40 over the seven (BM, BN) tiles of ``TILES`` at (34, 8, 6144,
     40), each timed beside kernel 1 on the same tensors, (128, 128) being
     kernel 1's own instantiation), each held as the full kernel-5 probes
     are, limits that every tile pair fails with log2 e left out of its
     scale.
  4. TV2V: the full-width SD-1.5 TV2V engine (seeded random weights, bf16,
     the luminance depth stand-in), its network through the kernels against
     plain attention, then one clip edit through ``edit_clip``: 17 frames at
     512x768, CFG 7.5, DPM++2S-ancestral, 3 steps (5 network rows).  Then
     the same edit with ``set_quantized_qk(True)`` (same engine, seed and
     noise): it must launch only kernel 1c at d 40/80, and its final latents
     must stay within LATENT_COSINE of the exact edit's, while the same edit
     with a planted fault (the dequant factor left out of the folded logits
     scale, planted in the pre-pass wrapper that kernel 1c's forward calls,
     ``without_dequant``) must not.
  5. TVI2V: the full-width TVI2V engine (CFCA centre+self, structure and
     appearance ControlNets, seeded random weights, bf16, a seeded random
     full-size DPT-Hybrid depth annotator), its network check, then one
     reference-guided edit: 17x512x768, an edited reference frame (the
     centre frame with its colours shifted), ``--prior_type ref`` with
     prior_coefficient_x 0.03, CFG 7, 3 steps; then its quantized edit and
     the planted fault, as in phase 4 (the CFCA quantized too).
  4b. modes and swaps, on phase 4's engine before it is freed: an sdedit
     edit (strength 0.5, DPM++2M, 8 steps, 3 after the img2img pruning) whose final latents must be
     nearer, by cosine, to the clip's own VAE latents than phase 4's full
     edit's are; an Euler-ancestral inpaint of a white box in the clip
     (``make_inpaint_mask``); an Euler-EDM edit with s_churn 1; each finite
     and launching kernels 1, 2 and 3.  Then a seeded random rank-4 kohya
     LoRA over every UNet attention projection and the text encoder,
     merged by ``apply_lora``: no pair skipped, each merged bf16 weight
     equal to W + s up down computed in fp32 within its bf16 rounding.
  5b. TVI2V as shipped: the full-width engine of ``TVI2V_ZOE_CONFIG`` (a
     seeded random ZoeD_M12_N, BEiT-L/384 with live layer-scale gammas and
     bias tables, bf16).  The Zoe depth of the clip's first and last chunk
     in bf16 is held to the same module in fp32 by the cosine of the
     mean-centred maps (ZOE_COSINE), which the bf16 run with the
     relative-position bias left out must fail; the hint must show its
     2 %/85 % normalisation (at least k_lo values at -1 and n - k_hi + 1
     at +1); then phase 5's edit (exact only), which must launch kernels 1
     (n_k = n_q and 2 n_q), 2 and 3 (encoder and decoder).
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
  6b. TVI2V training: the full-width engine of ``TVI2V_TRAIN_CONFIG`` (CFCA
     centre+self, the structure and appearance ControlNets, a random
     full-size DPT-Hybrid, seeded random fp32 masters, bf16 autocast,
     ``use_checkpoint``; ``spatial_tv2v``: the temporal layers, the CFCA's
     ``*_temporal_ca`` and ``controlnet_img`` train).  (a) Its trainable
     gradients through the kernels are held to plain attention at 17 frames
     of 256x512 (kernel 4 at n_k = n_q and, in the CFCA, n_k = 2 n_q), and
     two planted faults must fail that check: kernel 4's dq and dk zeroed
     everywhere, and only on the CFCA's calls.  (b) ``Trainer.fit`` takes 1
     warm-up and 3 timed steps at the recipe's batch 1 of 17x384x512
     synthetic clips: frozen tensors bit-identical, every trainable tensor
     moved, kernel 4 launched ``TVI2V_BWD_PER_STEP`` times a step.  (c) One
     validation sampling (2 steps) writes its gifs and panel and launches
     kernels 1 (both variants), 2 and 3.  (d) At world size 1 over NCCL,
     the data-parallel gradient all-reduce with AdamW, plain and ZeRO,
     leaves the trainable tensors bit-identical to the same update without
     torch.distributed, and a whole step runs through that path.
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
  8. network variants, at full SD-1.5 width with seeded random weights
     (every zero-initialised layer drawn too, the learnable alphas off 1):
     (a) interpolation training (``INTERP_TRAIN_CONFIG``: the appearance
     ControlNet on the first and last frames, ``spatial_tv2v``): its
     gradients through the kernels held to plain attention at 17 frames
     of 256x512 (GRAD_TOLERANCE), refusing kernel 4's dq and dk zeroed
     everywhere and only on ``controlnet_img``'s first- and last-frame
     rows; ``Trainer.fit`` for 3 steps at 1 x 17 x 384x512 with kernel 4
     ``INTERP_BWD_PER_STEP`` times a step, frozen tensors bit-identical,
     trainable ones moved; a 2-step validation sample.  (b) one forward of
     RAIG's 2-D network (``ControlledUNetModel2DRAIG``) on (2, 64, 64, 4),
     its reference attention through kernel 1 at (2, 8, 4096, 40) with K/V
     from the bank, held to plain attention (ROUTE_TOLERANCE), refusing
     the query's own tokens as the bank.  (c) ControlNet3D in both modes
     and (d) a pseudo-3D UNet with temporal text cross-attention, Linear
     projections, learnable alphas, scale-shift norm and ``label_emb`` (a
     ``vector`` cond), each on (2, 17, 64, 96) through kernels 1 and 2,
     held to plain attention, refusing kernels 1 and 2 with their batch
     halves swapped.  Each part prints its seconds and peak memory.
  9. conditioning, with seeded random checkpoints in each reference file's
     layout (``annotators/random_weights.py``) read by ``build_annotator``:
     (a) the eight structure hints (lineart standard and learned, HED and
     PiDiNet soft edges, their scribbles, NormalBAE, openpose) on a
     17x512x768 clip with edges and colour, through the conditioner's CHUNK
     loop in bf16 (NormalBAE fp32), each printing its seconds; each
     backbone family's maps on the first chunk held to the same module in
     fp32 by channel-centred cosine (HINT_COSINE), which its planted fault
     must fail (PiDiNet with its PDC fold left out, HED with the sigmoid
     before the mean, NormalBAE with its refinements skipped, openpose
     without the BGR flip); lineart-standard held to a float64 numpy
     version, the scribble NMS to a scipy version (intersection over union
     of the pixels either marks), and the pose assembly to
     a person planted in synthetic maps.  (b) The TV2V 3-step edit of phase
     4 with its depth hint replaced by ``SoftEdgeEncoder`` (PiDiNet) and by
     ``OpenposeEncoder``, each launching kernels 1, 2 and 3.  (c) OpenCLIP
     ViT-H/14 text (penultimate, legacy) and vision and T5 v1.1-XL with
     CLIP-L through ``CLIPT5Embedder``, at full width in bf16 against fp32
     (TOWER_COSINE), and the native BPE tokenizer, built with g++ and chosen
     by ``load_tokenizer``, id for id against the Python one.  No step needs cv2.
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
# the shapes at which kernel 4 with delta left out must fail it: the
# training shapes (TV2V's, and TVI2V's CFCA at n_k = 2 n_q), and every d =
# 512 shape (VAE training)
DELTA_FAULT_SHAPES = ((48, 8, 3072, 40), (48, 8, 768, 80), (17, 8, 3072, 40),
                      (17, 8, 768, 80), (12, 1, 1024, 512), (4, 1, 4096, 512),
                      (2, 1, 600, 512))
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
# phase 6b, TVI2V training (TVI2V_TRAIN_CONFIG's batch 1 of 17-frame
# 384x512 clips); its gradient check at 17 frames of 256x512 (2048 tokens at
# level 0, 4096 CFCA keys), held to GRAD_TOLERANCE
TVI2V_TRAIN_T, TVI2V_TRAIN_H, TVI2V_TRAIN_W = 17, 384, 512
TVI2V_GRAD_H, TVI2V_GRAD_W = 256, 512
TVI2V_SAMPLE_STEPS = 2  # the validation sampling of phase 6b (c)
# backward launches a TVI2V training step, by kernel 4's variant.  n_k = n_q:
# the UNet's spatial self-attentions at level 0 (input blocks 1, 2; output
# blocks 9-11) and level 1 (4, 5; 6-8), 5 + 5 as in TV2V, plus the
# appearance ControlNet's (``controlnet_img``, trainable, encoder only: input
# blocks 1, 2 and 4, 5), 2 + 2.  n_k = 2 n_q: the CFCA (the
# ``*_temporal_ca`` block beside each of the UNet's 10 level-0/1 spatial
# transformers, its keys a frame's tokens and the centre frame's).  The
# structure ControlNet is frozen and reads nothing that needs a gradient, so
# it has no backward; level 2 (192 tokens) and the middle block are plain
# attention
TVI2V_BWD_PER_STEP = {"d40 n_k=n_q": 7, "d80 n_k=n_q": 7, "d40 n_k!=n_q": 5,
                      "d80 n_k!=n_q": 5}
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
# phase 8 (a): interpolation training at TVI2V's geometry (its gradient
# check at TVI2V_TRAIN_T x TVI2V_GRAD_H x TVI2V_GRAD_W, Trainer.fit at
# TVI2V_TRAIN_T x TVI2V_TRAIN_H x TVI2V_TRAIN_W), 1 warm-up + 2 timed steps
# and a 2-step validation sample.  Backward launches a step: the UNet's
# level-0 and level-1 spatial self-attentions (5 + 5, as in TV2V) and the
# appearance ControlNet's (input blocks 1, 2 and 4, 5, on the first and
# last frames), all at n_k = n_q
INTERP_TRAIN_STEPS, INTERP_SAMPLE_STEPS = 3, 2
INTERP_BWD_PER_STEP = {"d40 n_k=n_q": 7, "d80 n_k=n_q": 7}
# phase 8 (d): SDXL's vector width (ADM), the label_emb input
ADM_CHANNELS = 2816
# phase 4b: the modes and swaps on phase 4's engine (CFG 7.5): sdedit at
# strength 0.5 with DPM++2M over 8 steps (3 survive the img2img pruning, so
# the second step takes DPM++2M's second-order update), an Euler-ancestral
# inpaint of a white box, an Euler-EDM edit with churn; a rank-4 kohya LoRA
# at strength 0.8 over the UNet's attention projections and the text encoder
SDEDIT_STRENGTH, SDEDIT_STEPS, S_CHURN = 0.5, 8, 1.0
LORA_RANK, LORA_STRENGTH = 4, 0.8
# a merged bf16 weight against W + s * up @ down computed in fp32: its bf16
# rounding is at most 2^-8 of |target| (half a bf16 ulp); the limit is one
# ulp.  A pair merged at the wrong scale or not at all is off by ~1, since
# s * up @ down is several times W here
LORA_TOLERANCE = 2.0 ** -7
# phase 5b: the ZoeDepth hint of the first and last chunk computed in bf16,
# held to the same module in fp32 by the cosine of their mean-centred maps
# (the raw maps are positive, so their plain cosine is near 1 whatever they
# hold); the same bf16 run with the relative-position bias left out must
# fall below it.  First H100 reading, first chunk: 0.99947 sound, 0.99671
# without the bias (the card tests' 5 and 2 frames: 0.9976 without it)
ZOE_COSINE = 0.999


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
                 ((17, 8, 3072, 40), 6144, 4), ((17, 8, 768, 80), 1536, 17),
                 ((2, 8, 600, 40), 1200, 1)),
         count=lambda st: _variant_sum(st, "d", "n_k!=n_q")),
    dict(name="spatial_attention_1c", kernel="spatial_int8", path="tvi2v_int8",
         source="ccedit_tpu_torch/csrc/spatial_attention_int8.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:202",
         shapes=(((34, 8, 6144, 40), 6144, 1), ((34, 8, 1536, 80), 1536, 34),
                 ((34, 8, 6144, 40), 12288, 1), ((34, 8, 1536, 80), 3072, 34),
                 ((2, 8, 600, 40), 600, 1), ((2, 8, 600, 40), 1200, 1),
                 ((2, 8, 600, 80), 600, 1)),
         count=lambda st: _variant_sum(st, "int8 d", "n_k")),
    dict(name="quantize_qk", kernel="prepass", path="tvi2v_int8",
         source="ccedit_tpu_torch/csrc/quantize_qk.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:191",
         shapes=(((34, 8, 6144, 40), 6144, 34), ((34, 8, 1536, 80), 1536, 34),
                 ((34, 8, 6144, 40), 12288, 34), ((34, 8, 1536, 80), 3072, 34)),
         count=lambda st: sum(c.get("quantize_qk", 0) for c in st.values())),
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
                 ((17, 8, 3072, 40), 6144, 2), ((17, 8, 768, 80), 1536, 17),
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
    "tv2v_int8": ("spatial_attention_1c", "quantize_qk", "temporal_attention",
                  "flash_attention"),
    "tvi2v_int8": ("spatial_attention_1c", "quantize_qk", "temporal_attention",
                   "flash_attention", "flash_attention_encoder"),
    "train": ("spatial_attention", "temporal_attention", "flash_attention_encoder",
              "spatial_attention_bwd"),
    "tvi2v_train": ("spatial_attention", "spatial_attention_1b", "temporal_attention",
                    "flash_attention_encoder", "spatial_attention_bwd"),
    "tvi2v_train_sample": ("spatial_attention", "spatial_attention_1b", "temporal_attention",
                           "flash_attention", "flash_attention_encoder"),
    "vae_train": ("flash_attention_lse", "flash_attention_bwd"),
    "interp_train": ("spatial_attention", "temporal_attention", "flash_attention_encoder",
                     "spatial_attention_bwd"),
    "interp_train_sample": ("spatial_attention", "temporal_attention", "flash_attention",
                            "flash_attention_encoder"),
    "raig": ("spatial_attention",),
    "controlnet3d": ("spatial_attention", "temporal_attention"),
    "unet_variants": ("spatial_attention", "temporal_attention"),
    "tv2v_sdedit": ("spatial_attention", "temporal_attention", "flash_attention",
                    "flash_attention_encoder"),
    "tv2v_inpaint": ("spatial_attention", "temporal_attention", "flash_attention",
                     "flash_attention_encoder"),
    "tv2v_churn": ("spatial_attention", "temporal_attention", "flash_attention"),
    "tvi2v_zoe": ("spatial_attention", "spatial_attention_1b", "temporal_attention",
                  "flash_attention", "flash_attention_encoder"),
    "tv2v_softedge": ("spatial_attention", "temporal_attention", "flash_attention"),
    "tv2v_openpose": ("spatial_attention", "temporal_attention", "flash_attention"),
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
    At ``DELTA_FAULT_SHAPES`` the same check must refuse kernel 4 with delta
    left out (dS = P * dP), planted by handing it a zero output: delta =
    rowsum(dO * O) = 0."""
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
    if tuple(shape) in DELTA_FAULT_SHAPES:
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


def tie_inputs(shape, n_k, gen, device):
    """q and k in the model's layout for the pre-pass check, each with a
    head of exact half-integers whose amax is 127 (so x * 127 / amax is x
    itself and round-half-even decides every one of them): q's first head
    of its first batch row, k's last head of its last."""
    import torch

    q = model_layout(shape, gen, device)
    k = model_layout(shape[:2] + (n_k, shape[3]), gen, device)
    for x, (b, h) in ((q, (0, 0)), (k, (-1, -1))):
        x[b, h] = torch.round(x[b, h].float() * 20).div(2).to(x.dtype)
        x[b, h, 0, 0] = 127.0
    return q, k


def check_prepass(shape, n_k, gen, device) -> dict:
    """Kernel 1c's pre-pass (``csrc/quantize_qk.cu``) at one shape: q8, k8
    and the folded scales equal, bit for bit, to its plain version on the
    same tensors (``plain_prepass``: ``quantize_qk``, the JAX pre-pass bit
    for bit, with the kernel's padded rows), on inputs planted with exact .5
    ties (``tie_inputs``); its time beside ``quantize_qk``'s and the plain
    version's."""
    import torch

    from ccedit_tpu_torch.ops import spatial_attention as sa
    from ccedit_tpu_torch.scripts import roofline

    q, k = tie_inputs(shape, n_k, gen, device)
    scale = shape[-1] ** -0.5
    got, want = sa.prepass(q, k, scale), sa.plain_prepass(q, k, scale)
    torch.cuda.synchronize()
    same = [a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(got, want)]
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    ties = int(((q[0, 0].float() - q[0, 0].float().trunc()).abs() == 0.5).sum().item())
    ms = cuda_time_ms(lambda: sa.prepass(q, k, scale), 10)
    quantize_ms = cuda_time_ms(lambda: sa.quantize_qk(q, k, scale), 5)
    plain_ms = cuda_time_ms(lambda: sa.plain_prepass(q, k, scale), 5)
    bound = roofline.prepass_bound(*shape[:3], n_k, shape[3])
    print(f"[kernels] quantize_qk (pre-pass) q {shape} n_k {n_k}: {ms:.4f} ms (bound "
          f"{bound['bound_ms']:.4f} ms, {bound['bound_what']}); quantize_qk {quantize_ms:.4f} ms, "
          f"plain (quantize_qk + pad) {plain_ms:.4f} ms; q8/k8/scales bit-identical to the "
          f"plain version: {same} ({ties} ties in q's planted head), max_abs_err {err:.3e}",
          flush=True)
    if not all(same) or ties < 100:
        raise RuntimeError(f"the pre-pass at {shape} x {n_k} differs from quantize_qk: "
                           f"equal {same}, max_abs_err {err}, {ties} ties planted")
    return dict(shape=list(shape), n_k=n_k, compare_shape=list(shape), max_abs_err=err,
                max_rel_err=0.0, bit_identical=True, ties=ties, compared_ms=ms,
                plain_ms=plain_ms, quantize_qk_ms=quantize_ms, ms=ms, library_ms=None,
                library="none (no single PyTorch call quantizes per (batch, head))", **bound)


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
            if spec["kernel"] == "prepass":
                per_shape.append(check_prepass(shape, n_k, gen, device))
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
                extra["prepass_ms"] = cuda_time_ms(lambda: sa.prepass(q, k, scale), 5)
                extra["quantize_qk_ms"] = cuda_time_ms(lambda: sa.quantize_qk(q, k, scale), 5)
                note = (f", cosine to exact kernel 1 {extra['cosine_to_exact']:.6f} (> "
                        f"{INT8_COSINE}), its pre-pass at the full shape "
                        f"{extra['prepass_ms']:.4f} ms (quantize_qk {extra['quantize_qk_ms']:.4f} "
                        f"ms)")
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
    runs kernel 7's tile pairs (``TILES``) at (34, 8, 6144, 40) against the
    plain attention (``kr.compare``'s full-attention limits), each timed
    beside kernel 1 on the same tensors.  Then the probes
    that read the logits scale, and every kernel-7 tile pair, run with log2
    e left out of it (a softmax temperature off by ln 2), a planted fault
    that ``kr.compare`` must refuse, and kernel 6's int8 product runs with
    B's transposition skipped (``skip_transposition``), which its exact
    check must refuse.  Returns the probes' records and their launch counts
    by variant, as one stage ("probes")."""
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
          f"{split['kernel1_int8_ms']:.4f} ms int8 (1c); kernel 5's split of it "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split["kernel1_split_ms"].items())
          + f"; full plain bf16 / kernel 1 on the same tensors {split['full_over_kernel1']:.4f}",
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
    transpose = ip.transpose_int8
    ip.transpose_int8 = skip_transposition  # the planted fault, looked up by ip.gemm
    try:
        for m, k, n in ip.SHAPES:
            a, b = ip.operands(m, k, n, True, device)
            err = (ip.gemm(a, b).double() - ip.plain_gemm(a, b).double()).abs().max().item()
            print(f"[probes] kernel 6 int8 {m}x{k}x{n} with B's transposition skipped: "
                  f"max_abs_err {err:.3e} (exact required)", flush=True)
            if err == 0:
                raise RuntimeError(f"the gemm check passes int8 {m}x{k}x{n} with B's "
                                   "transposition skipped")
            del a, b
    finally:
        ip.transpose_int8 = transpose
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
        print(f"[probes] kernel 7 {r['variant']} {tuple(r['shape'])}: {r['ms']:.4f} ms, kernel 1 "
              f"{r['kernel1_ms']:.4f} ms on the same tensors (ratio {r['over_kernel1']:.4f}; bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_what']}; {r['library']} {r['library_ms']} ms); "
              f"on {r['plain_shape']}: max_abs_err {r['max_abs_err']:.3e}, relative "
              f"{r['max_rel_err']:.3e}, cosine {r['cosine']:.7f} (max|err|/max|plain| <= "
              f"{kr.FULL_TOLERANCE}, cosine >= {kr.FULL_COSINE}), kernel "
              f"{r['compared_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms", flush=True)
        if not r["ok"]:
            raise RuntimeError(f"kernel 7 at {r['variant']} disagrees with its plain version: {r}")
        records.append(dict(
            name=f"flash_attention_tiles[{r['variant']}]", route="cuda",
            source="ccedit_tpu_torch/csrc/attention_tiles.cu",
            replaces="scripts/profile_blocks.py:36", launches=0,
            **{f: r[f] for f in ("max_abs_err", "max_rel_err", "cosine", "ms", "kernel1_ms",
                                 "over_kernel1", "compared_ms", "plain_ms", "plain_shape",
                                 "bound_ms", "bound_by", "bound_what", "library_ms",
                                 "library")}))
    own = [r for r in sweep if r["variant"] == pb.variant_name(128, 128)]
    if own:
        best = min(sweep, key=lambda r: r["ms"])
        print(f"[probes] kernel 7 (128, 128), kernel 1's own instantiation, over kernel 1 on the "
              f"same tensors: {own[0]['over_kernel1']:.4f}; fastest pair {best['variant']} "
              f"{best['ms']:.4f} ms ({best['over_kernel1']:.4f} of kernel 1)", flush=True)
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
    resident_gb = torch.cuda.memory_allocated(device) / 1e9  # weights and earlier phases'
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
    print(f"[{label}] edit_clip {T}x{H}x{W}, {steps} steps: "
          f"{total:.2f} s; stages " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"; peak memory {peak_gb:.2f} GB ({resident_gb:.2f} GB allocated before it)",
          flush=True)
    print(f"[{label}] kernel launches by stage {json.dumps(launches)}", flush=True)
    if out.dtype != np.uint8 or out.shape != (T, H, W, 3):
        raise RuntimeError(f"edit_clip returned {out.dtype} {out.shape}")
    if not bool(torch.isfinite(latents).all()):
        raise FloatingPointError(f"{label}: the final latents are not finite")
    print(f"[{label}] output uint8 {out.shape}, mean {out.mean():.2f}, std {out.std():.2f}",
          flush=True)
    return out, latents, launches


def without_dequant(prepass):
    """``prepass`` (``ops/spatial_attention.py``, the pre-pass wrapper that
    kernel 1c's forward calls) with the planted fault of phases 4 and 5: the
    dequant factor left out of the folded scales, each (batch, head)'s
    scale overwritten with the bare logits scale."""
    import torch

    def faulty(q, k, scale):
        q8, k8, scales = prepass(q, k, scale)
        return q8, k8, torch.full_like(scales, scale)

    return faulty


def skip_transposition(x, width=None):
    """``int8_probe.transpose_int8`` with the planted fault of phase 3b:
    kernel 6's B passed on untransposed, its (K, N) bytes read as B^T (N,
    K)."""
    return x.reshape(x.shape[-1], x.shape[-2])


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
    print(f"[{path}] {torch.cuda.memory_allocated(device) / 1e9:.2f} GB allocated before the "
          "phase", flush=True)
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
    prepass = sa.prepass
    try:
        att.set_quantized_qk(True)
        _, quant, launches_int8 = edit_counted(edit, device, steps, seed, f"{path}_int8")
        sa.prepass = without_dequant(prepass)
        _, fault, launches_fault = edit_counted(edit, device, steps, seed, f"{path}_int8 fault")
    finally:
        sa.prepass = prepass
        att.set_quantized_qk(False)
    if sum(c.get("quantize_qk", 0) for c in launches_fault.values()) <= 0:
        raise RuntimeError(f"the {path} edit with the planted fault never ran the pre-pass")
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
    out = {path: launches, f"{path}_int8": launches_int8}
    if path == "tv2v":
        out.update(run_modes(engine, exact, device, seed))
    del engine, edit, modules  # ``modules`` holds the weights too
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_modes(engine, full_latents, device, seed: int) -> dict:
    """Phase 4b, on phase 4's TV2V engine: an sdedit edit, an inpaint edit
    and an Euler-EDM edit with churn (each finite, each launching kernels 1,
    2 and 3), then a kohya LoRA merged into the UNet and the text encoder.
    Returns the per-stage counts of the three edits as paths."""
    import torch

    from ccedit_tpu_torch.cli.pipeline import edit_clip
    from ccedit_tpu_torch.data.video import moving_gradient_clip
    from ccedit_tpu_torch.diffusion import make_discretization, make_sampler

    t0 = time.perf_counter()
    frames = moving_gradient_clip(T, H, W)
    boxed = frames.copy()
    boxed[:, H // 4:H // 2, W // 3:2 * W // 3] = 255  # the white box to regenerate
    sdedit_disc = make_discretization("legacy_ddpm", img2img_strength=SDEDIT_STRENGTH)
    if len(sdedit_disc(SDEDIT_STEPS)) < 4:  # a second step to a nonzero sigma
        raise RuntimeError(f"{SDEDIT_STEPS} sdedit steps at strength {SDEDIT_STRENGTH} leave "
                           "DPM++2M no second-order update")
    edits = {
        "tv2v_sdedit": (frames, make_sampler("dpmpp_2m", discretization=sdedit_disc),
                        SDEDIT_STEPS, {"sdedit": True}),
        "tv2v_inpaint": (boxed, make_sampler("euler_ancestral"), STEPS, {"inpainting": True}),
        "tv2v_churn": (frames, make_sampler("euler", s_churn=S_CHURN), STEPS, {}),
    }
    saved, counts, latents = engine.sampler, {}, {}
    try:
        for label, (clip, sampler, steps, kw) in edits.items():
            engine.sampler = sampler

            def edit(n_steps, generator, _clip=clip, _kw=kw, **more):
                return edit_clip(engine, _clip, "a robot bear walking through the snow",
                                 "ugly, low quality", 7.5, n_steps, generator, **_kw, **more)

            _, latents[label], counts[label] = edit_counted(edit, device, steps, seed, label)
    finally:
        engine.sampler = saved
    with torch.no_grad():
        z = engine.encode_first_stage(torch.from_numpy(frames)[None].to(device))
    cos_sdedit, cos_full = cosine(latents["tv2v_sdedit"], z), cosine(full_latents, z)
    print(f"[tv2v_sdedit] final latents vs the clip's own VAE latents: cosine {cos_sdedit:.6f}; "
          f"the full edit's {cos_full:.6f}", flush=True)
    if not cos_sdedit > cos_full:
        raise RuntimeError(f"the sdedit edit is no nearer the clip than the full edit: "
                           f"{cos_sdedit} <= {cos_full}")
    check_lora(engine, device, seed)
    print(f"[modes] phase 4b in {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def check_lora(engine, device, seed: int) -> None:
    """A seeded random rank-4 kohya LoRA over every UNet attention
    projection and the text encoder, written to ``build/`` and merged by
    ``apply_lora``: no pair may be skipped, and each merged bf16 weight must
    equal W + s * up @ down computed in fp32 within its bf16 rounding."""
    import pathlib

    import torch

    from ccedit_tpu_torch.cli.pipeline import apply_lora
    from ccedit_tpu_torch.io import lora as tl

    unet = engine.network.unet
    clip = next(e.transformer for e in engine.conditioner.embedders if hasattr(e, "transformer"))
    params = {"lora_unet_": dict(unet.named_parameters()),
              "lora_te_": dict(clip.named_parameters())}
    blocks = ([f"down_blocks_{b}_attentions_{a}" for b in range(3) for a in range(2)]
              + ["mid_block_attentions_0"]
              + [f"up_blocks_{b}_attentions_{a}" for b in (1, 2, 3) for a in range(3)])
    names = [f"lora_unet_{b}_transformer_blocks_0_{attn}_to_{p}" for b in blocks
             for attn in ("attn1", "attn2") for p in ("q", "k", "v", "out_0")]
    names += [f"lora_te_text_model_encoder_layers_{i}_{m}" for i in range(12)
              for m in ("self_attn_q_proj", "self_attn_k_proj", "self_attn_v_proj",
                        "self_attn_out_proj", "mlp_fc1", "mlp_fc2")]
    gen = torch.Generator().manual_seed(seed + 7)
    sd, targets = {}, {}
    for name in names:
        prefix = "lora_unet_" if name.startswith("lora_unet_") else "lora_te_"
        key = name[len(prefix):]
        target = (tl.unet_target(key, unet.num_res_blocks, len(unet.channel_mult))
                  if prefix == "lora_unet_" else tl.text_target(key))
        w = params[prefix][f"{target}.weight"]
        sd[f"{name}.lora_down.weight"] = torch.randn((LORA_RANK, w.shape[1]), generator=gen)
        sd[f"{name}.lora_up.weight"] = torch.randn((w.shape[0], LORA_RANK), generator=gen) * 0.1
        sd[f"{name}.alpha"] = torch.tensor(float(LORA_RANK) / 2)
        targets[name] = (w, w.detach().float().clone())
    path = pathlib.Path("build") / "chip_smoke_lora.pt"
    path.parent.mkdir(exist_ok=True)
    torch.save(sd, path)
    report = apply_lora(engine, str(path), LORA_STRENGTH)
    if report["skipped"] or len(report["merged"]) != len(names):
        raise RuntimeError(f"the LoRA merge skipped {report['skipped']}")
    worst = 0.0
    for name, (w, before) in targets.items():
        delta = (sd[f"{name}.lora_up.weight"] @ sd[f"{name}.lora_down.weight"]).to(device)
        target = before + LORA_STRENGTH * 0.5 * delta  # alpha / rank = 0.5
        err = ((w.float() - target).abs() / target.abs().clamp_min(1e-30)).max().item()
        worst = max(worst, err)
    print(f"[lora] {len(names)} pairs merged ({len(blocks)} UNet transformers, 12 text layers); "
          f"worst |W - (W0 + s up down)| / |W0 + s up down| {worst:.3e} "
          f"(limit {LORA_TOLERANCE:.3e})", flush=True)
    if not worst <= LORA_TOLERANCE:
        raise RuntimeError(f"a merged LoRA weight is off by {worst} of its value")


def centred_cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return cosine(a - a.mean(), b - b.mean())


def run_zoe(device, seed: int) -> dict:
    """Phase 5b: TVI2V as shipped.  The full-width engine of
    ``TVI2V_ZOE_CONFIG`` (a seeded random ZoeD_M12_N with live BEiT blocks,
    bf16), the Zoe depth of the clip's first and last chunk in bf16 against
    the same module in fp32 (and the planted fault, the bias left out), the
    hint's normalisation, then one reference-guided edit as phase 5's.
    Returns its per-stage counts as path ``tvi2v_zoe``."""
    import copy

    import torch

    from ccedit_tpu_torch.cli.profile_tv2v import build_edit
    from ccedit_tpu_torch.conditioning.annotators.base import CHUNK
    from ccedit_tpu_torch.conditioning.annotators.zoedepth import detect_depth_zoe
    from ccedit_tpu_torch.data.video import moving_gradient_clip

    t0 = time.perf_counter()
    print(f"[tvi2v_zoe] {torch.cuda.memory_allocated(device) / 1e9:.2f} GB allocated before the "
          "phase", flush=True)
    engine, edit, _ = build_edit("tvi2v_zoe", device, seed, STEPS)
    emb = next(e for e in engine.conditioner.embedders if getattr(e, "kind", "") == "depth_zoe")
    n_zoe = sum(p.numel() for p in emb.backbone.parameters())
    print(f"[tvi2v_zoe] engine built in {time.perf_counter() - t0:.1f} s; ZoeD_M12_N "
          f"{n_zoe / 1e6:.1f} M parameters, bf16", flush=True)
    clip = torch.from_numpy(moving_gradient_clip(T, H, W)).to(device)
    frames = clip.float() / 255.0  # the embedder's (x / 127.5 - 1 + 1) / 2
    zoe32 = copy.deepcopy(emb.backbone).float()
    readings = {}
    with torch.no_grad():
        last = (T - 1) // CHUNK * CHUNK
        for name, chunk in (("first", frames[:CHUNK]), ("last", frames[last:])):
            ref = detect_depth_zoe(zoe32, chunk)
            d16 = detect_depth_zoe(emb.backbone, chunk).float()
            fault = detect_depth_zoe(emb.backbone, chunk, rel_bias=False).float()
            if not (torch.isfinite(d16).all() and torch.isfinite(ref).all()):
                raise FloatingPointError(f"the Zoe depth of the {name} chunk is not finite")
            readings[name] = (centred_cosine(d16, ref), centred_cosine(fault, ref))
    del zoe32
    torch.cuda.empty_cache()
    for name, (sound, fault) in readings.items():
        print(f"[tvi2v_zoe] Zoe depth of the {name} chunk, bf16 vs fp32 on the card: centred "
              f"cosine {sound:.6f}; with the relative-position bias left out {fault:.6f} "
              f"(limit {ZOE_COSINE})", flush=True)
        if not sound >= ZOE_COSINE:
            raise RuntimeError(f"the bf16 Zoe depth left the fp32 one: {sound}")
        if not fault < ZOE_COSINE:
            raise RuntimeError(f"the Zoe check passes a depth without its bias: {fault}")
    torch.cuda.reset_peak_memory_stats(device)
    resident_gb = torch.cuda.memory_allocated(device) / 1e9
    with torch.no_grad():
        hint = emb(clip[None])[0, ..., 0]
    print(f"[tvi2v_zoe] the hint stage alone: peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB ({resident_gb:.2f} GB "
          "allocated before it)", flush=True)
    n = hint.numel()
    k_lo, k_hi = max(int(0.02 * n), 1), max(int(0.85 * n), 1)
    at_lo, at_hi = int((hint == -1.0).sum()), int((hint == 1.0).sum())
    print(f"[tvi2v_zoe] hint: {at_lo} of {n} values at -1 (k_lo {k_lo}), {at_hi} at +1 "
          f"(n - k_hi + 1 = {n - k_hi + 1})", flush=True)
    if not (bool(torch.isfinite(hint).all()) and at_lo >= k_lo and at_hi >= n - k_hi + 1):
        raise RuntimeError("the Zoe hint does not show its 2 %/85 % normalisation")
    _, _, launches = edit_counted(edit, device, STEPS, seed, "tvi2v_zoe")
    print(f"[tvi2v_zoe] phase 5b in {time.perf_counter() - t0:.1f} s", flush=True)
    del engine, edit, emb
    gc.collect()
    torch.cuda.empty_cache()
    return {"tvi2v_zoe": launches}


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


def everywhere(dq, dk) -> bool:
    """Where the planted fault of phases 6 and 7 acts: every kernel-4 call."""
    return True


def on_cfca(dq, dk) -> bool:
    """Phase 6b's second fault: only the CFCA's calls (n_k = 2 n_q), told
    apart by dk's row count differing from dq's."""
    return dk.shape[-2] != dq.shape[-2]


def grads_three_ways(params, backward, function, faults=(("dq = dk = 0", everywhere),)):
    """The gradients of ``params`` (a dict by name) that ``backward()``
    accumulates: through the kernels, with every attention on its plain
    version, and with each planted fault in the autograd ``function``'s
    backward (kernel 4's dq and dk zeroed, dv kept, on the calls where the
    fault's predicate of (dq, dk) holds).  Returns the fp32 gradients
    through the kernels, on plain attention and by fault name, and the
    launch counts of the first run."""
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
    g_faults = {}
    for name, where in faults:
        def faulty_bwd(ctx, do, _where=where):
            dq, dk, dv, _ = kernel_bwd(ctx, do)
            if _where(dq, dk):
                return torch.zeros_like(dq), torch.zeros_like(dk), dv, None
            return dq, dk, dv, None

        function.backward = staticmethod(faulty_bwd)
        try:
            g_faults[name] = grads()
        finally:
            function.backward = staticmethod(kernel_bwd)
    for p in params.values():
        p.grad = None
    return g_kernels, g_plain, g_faults, counts


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

    g_kernels, g_plain, g_faults, counts = grads_three_ways(params, backward, sa.SpatialAttention)
    for key in ("spatial_attention_bwd[d40 n_k=n_q]", "spatial_attention_bwd[d80 n_k=n_q]"):
        if counts.get(key, 0) <= 0:
            raise RuntimeError(f"the gradient check never launched {key}: {counts}")
    if counts.get("temporal_attention", 0) <= 0:
        raise RuntimeError(f"the gradient check never launched temporal_attention: {counts}")
    if not all(bool(torch.isfinite(g).all()) for g in g_kernels.values()):
        raise FloatingPointError("training gradients through the kernels are not finite")
    return dict(kernels=grad_errors(g_kernels, g_plain),
                fault=grad_errors(g_faults["dq = dk = 0"], g_plain))


def engine_parameters(engine) -> list:
    """(name, tensor) of every parameter of a training engine: the network's,
    the VAE's and the conditioner's (CLIP and the depth network)."""
    return [(f"{prefix}.{n}", p) for prefix, m in (("network", engine.network),
                                                  ("vae", engine.vae),
                                                  ("conditioner", engine.conditioner))
            for n, p in m.named_parameters()]


def check_frozen_and_moved(named, before, trainable, label: str) -> None:
    """After training: every frozen tensor of ``named`` bit-identical to
    ``before``, every trainable one (the network's, by name) moved."""
    import torch

    changed_frozen, unmoved = [], []
    for n, p in named:
        same = torch.equal(before[n], p.detach().cpu())
        is_trainable = n.startswith("network.") and n[len("network."):] in trainable
        if is_trainable and same:
            unmoved.append(n)
        elif not is_trainable and not same:
            changed_frozen.append(n)
    print(f"[{label}] {len(trainable)} trainable tensors, {len(unmoved)} unmoved; "
          f"{len(named) - len(trainable)} frozen tensors, {len(changed_frozen)} changed", flush=True)
    if changed_frozen or unmoved:
        raise RuntimeError(f"frozen tensors changed: {changed_frozen[:5]}; trainable tensors "
                           f"that did not move: {unmoved[:5]}")


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
    named = engine_parameters(engine)
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
    check_frozen_and_moved(named, before, trainable, "train")
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


def tvi2v_batch(t: int, h: int, w: int, seed: int) -> dict:
    """A TVI2V training batch of one synthetic clip in [-1, 1]: the clip,
    its prompt, the clip as the depth network's input and its centre frame
    as the reference (``cond_img``), as ``data/dataset.py`` makes items."""
    import numpy as np

    clip = np.random.RandomState(seed).uniform(-1, 1, (1, t, h, w, 3)).astype(np.float32)
    return {"jpg": clip, "txt": ["a robot bear walking through the snow"], "control_hint": clip,
            "cond_img": clip[:, t // 2].copy()}


def check_tvi2v_grads(engine, device, seed: int) -> dict:
    """Phase 6b (a): the trainable gradients of one bf16-autocast TVI2V step
    through the kernels against plain attention at 17 frames of 256x512
    (kernels 1 and 4 at d 40/80 with n_k = n_q and, in the CFCA, n_k = 2
    n_q; kernel 2 at T = 17; kernel 3 in the VAE encoder), with the same
    sigma, noise, VAE posterior noise and generator (the ucg draws and the
    reference latent's posterior sample).  Two planted faults, kernel 4's dq
    and dk zeroed everywhere and only on the CFCA's calls, must fail it."""
    import torch

    from ccedit_tpu_torch.ops import spatial_attention as sa

    t, h, w = TVI2V_TRAIN_T, TVI2V_GRAD_H, TVI2V_GRAD_W
    f = engine.latent_factor
    batch = tvi2v_batch(t, h, w, seed)
    gen = torch.Generator(device=device)
    zshape = (1, t, h // f, w // f, 4)
    overrides = dict(
        sigmas=torch.tensor([engine.denoiser.sigmas_np[500]], device=device),
        noise=torch.randn(zshape, generator=gen.manual_seed(seed), device=device),
        vae_noise=torch.randn(zshape, generator=gen, device=device))
    params = engine.trainable_parameters()

    def backward():
        engine.backward_step(batch, gen.manual_seed(seed + 1), torch.bfloat16, **overrides)

    faults = (("dq = dk = 0", everywhere), ("dq = dk = 0 on the CFCA", on_cfca))
    g_kernels, g_plain, g_faults, counts = grads_three_ways(params, backward,
                                                            sa.SpatialAttention, faults)
    want = [f"spatial_attention_bwd[{v}]" for v in TVI2V_BWD_PER_STEP] + ["temporal_attention",
                                                                          "flash_attention"]
    if any(counts.get(k, 0) <= 0 for k in want):
        raise RuntimeError(f"the TVI2V gradient check did not launch all of {want}: {counts}")
    if not all(bool(torch.isfinite(g).all()) for g in g_kernels.values()):
        raise FloatingPointError("TVI2V training gradients through the kernels are not finite")
    cfca = {n: (g_faults[faults[1][0]][n] - g_plain[n]).norm().item()
            / max(g_plain[n].norm().item(), 1e-30)
            for n in g_plain if "_temporal_ca" in n and ".attn1.to_k." in n}
    return dict(kernels=grad_errors(g_kernels, g_plain), counts=counts, cfca_to_k=cfca,
                **{name: grad_errors(g, g_plain) for name, g in g_faults.items()})


def check_distributed_step(engine, batch, device, seed: int) -> None:
    """Phase 6b (d): one step through the data-parallel path at world size
    1 (a process group over NCCL on a ``file://`` store): the reduced
    gradient (``parallel.mesh.all_reduce_grads``) and the AdamW update, plain
    and sharded (``ZeroRedundancyOptimizer``), must leave the trainable
    parameters bit-identical to the same update without torch.distributed.
    All three apply one gradient, computed once: two backward passes differ
    in the last bits, since kernel 4 sums dQ with atomics in an order that
    changes from run to run (printed).  Then one whole ``train_step``
    through the path, with ZeRO, must run and move every trainable tensor."""
    import os

    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch.parallel import mesh

    params = engine.trainable_parameters()
    start = {n: p.detach().clone() for n, p in params.items()}
    gen = torch.Generator(device=device)

    def restore():
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start[n])
                p.grad = None

    grads = []
    for _ in range(2):
        restore()
        engine.backward_step(batch, gen.manual_seed(seed + 2), torch.bfloat16)
        grads.append({n: p.grad.clone() for n, p in params.items()})
    rerun = max((grads[0][n] - grads[1][n]).abs().max().item() for n in params)

    def apply(zero: bool, reduce) -> dict:
        restore()
        optimizer = engine.make_optimizer(1e-4, zero=zero)
        for n, p in params.items():
            p.grad = grads[0][n].clone()
        if reduce is not None:
            reduce(params)
        optimizer.step()
        out = {n: p.detach().clone() for n, p in params.items()}
        del optimizer
        return out

    plain = apply(False, None)
    store = os.path.abspath("build/chip_smoke_dist_store")
    os.makedirs("build", exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=0, world_size=1)
    try:
        results = {"all-reduce + AdamW": apply(False, mesh.all_reduce_grads),
                   "all-reduce + ZeRO AdamW": apply(True, mesh.all_reduce_grads)}
        restore()
        optimizer = engine.make_optimizer(1e-4, zero=True)
        loss = engine.train_step(batch, optimizer, gen.manual_seed(seed + 2),
                                 autocast_dtype=torch.bfloat16, reduce_grads=mesh.all_reduce_grads)
        unmoved = [n for n, p in params.items() if torch.equal(p, start[n])]
        del optimizer
    finally:
        dist.destroy_process_group()
    for name, got in results.items():
        diff = [n for n in plain if not torch.equal(got[n], plain[n])]
        print(f"[tvi2v_train] world 1 ({dist.Backend.NCCL if device.type == 'cuda' else 'gloo'}"
              f"), {name}: {len(plain) - len(diff)} of {len(plain)} trainable tensors "
              f"bit-identical to the step without torch.distributed", flush=True)
        if diff:
            worst = max((got[n] - plain[n]).abs().max().item() for n in diff)
            raise RuntimeError(f"{name} at world 1 differs from the plain step on {len(diff)} "
                               f"tensors, max |diff| {worst}: {diff[:5]}")
    print(f"[tvi2v_train] two backward passes of one step: max |grad difference| {rerun:.3e} "
          f"(kernel 4's atomic dQ sums); a whole train_step through all_reduce_grads and ZeRO: "
          f"loss {float(loss):.5f}, {len(params) - len(unmoved)} of {len(params)} trainable "
          "tensors moved", flush=True)
    if not math.isfinite(float(loss)) or unmoved:
        raise RuntimeError(f"the distributed train_step: loss {float(loss)}, unmoved {unmoved[:5]}")
    restore()


def sample_counted(engine, trainer, batch, step: int, label: str, what: str) -> dict:
    """One validation sampling (``Trainer.log_samples``) outside the timed
    steps, its launch counts by stage (``sample``, ``decode``): its gifs
    and panel must be written.  Returns the stages' counts."""
    import torch

    from ccedit_tpu_torch.ops import attention as att

    decode, stages = engine.decode_first_stage, {}

    def counted_decode(z):
        torch.cuda.synchronize()
        start = att.launch_counts()
        out = decode(z)
        torch.cuda.synchronize()
        stages["decode"] = {k: n - start.get(k, 0) for k, n in att.launch_counts().items()}
        return out

    engine.decode_first_stage = counted_decode
    att.reset_launch_counts()
    t1 = time.perf_counter()
    try:
        image_dir = trainer.log_samples(batch, step)
    finally:
        del engine.decode_first_stage
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t1
    total = att.launch_counts()
    stages["sample"] = {k: n - stages["decode"].get(k, 0) for k, n in total.items()}
    files = sorted(p.name for p in image_dir.iterdir())
    want = [f"step{step:08d}_{kind}" for kind in ("input.gif", "panel.png", "sample.gif")]
    print(f"[{label}] validation sampling, {what}: {sample_s:.2f} s; files {files}; launches "
          f"by stage {json.dumps(stages)}", flush=True)
    if files != want or any((image_dir / f).stat().st_size == 0 for f in files):
        raise RuntimeError(f"validation sampling wrote {files}, not {want}")
    return stages


def run_tvi2v_train(device, seed: int) -> dict:
    """Phase 6b: TVI2V training (``TVI2V_TRAIN_CONFIG``: CFCA, the structure
    and appearance ControlNets, ``spatial_tv2v``) at full width: (a) the
    gradient check with its two planted faults, (b) ``Trainer.fit`` at the
    recipe's batch 1 of 17x384x512 (1 warm-up and 3 timed steps), (c) one
    validation sampling, (d) one step through the data-parallel path at
    world size 1.  Returns the launch counts of (b), one stage, and of (c),
    its sampling and decode stages, as paths ``tvi2v_train`` and
    ``tvi2v_train_sample``."""
    import shutil
    from pathlib import Path

    import torch

    from ccedit_tpu_torch import config
    from ccedit_tpu_torch.cli.train import build_train_engine
    from ccedit_tpu_torch.data.dataset import DataLoader, SyntheticVideoDataset
    from ccedit_tpu_torch.ops import attention as att
    from ccedit_tpu_torch.train.freeze import count_trainable, freeze_mask
    from ccedit_tpu_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    cfg = config.TVI2V_TRAIN_CONFIG
    model_params = cfg["model"]["params"]
    engine = build_train_engine(cfg, device, seed)
    engine.make_optimizer(1e-4)  # sets the freeze policy's requires_grad flags
    torch.cuda.synchronize()
    net_counts = count_trainable(engine.network.named_parameters(),
                                 freeze_mask(engine.network.named_parameters(), engine.freeze_policy))
    named = engine_parameters(engine)
    total = sum(p.numel() for _, p in named)
    print(f"[tvi2v_train] engine built in {time.perf_counter() - t0:.1f} s: freeze policy "
          f"{engine.freeze_policy}, {net_counts['trainable'] / 1e6:.1f} M trainable of "
          f"{total / 1e9:.3f} B parameters (network {net_counts['total'] / 1e6:.1f} M), fp32 "
          f"masters, bf16 autocast, use_checkpoint", flush=True)

    errs = check_tvi2v_grads(engine, device, seed)
    for which in ("kernels", "dq = dk = 0", "dq = dk = 0 on the CFCA"):
        e = errs[which]
        print(f"[tvi2v_train] trainable gradients ({which}) vs plain attention at "
              f"{TVI2V_TRAIN_T}x{TVI2V_GRAD_H}x{TVI2V_GRAD_W}: ||diff||/||plain|| of the worst of "
              f"{e['leaves_compared']} of {e['leaves']} tensors {e['worst_leaf']:.3e} "
              f"({e['worst_leaf_name']}; tol {GRAD_TOLERANCE:.0e}), of the whole gradient "
              f"{e['whole']:.3e}", flush=True)
    print(f"[tvi2v_train] CFCA to_k gradients with the CFCA-only fault: "
          + ", ".join(f"{n} {r:.3e}" for n, r in list(errs["cfca_to_k"].items())[:4])
          + f"; launches {json.dumps(errs['counts'])}", flush=True)
    if not errs["kernels"]["worst_leaf"] <= GRAD_TOLERANCE:
        raise RuntimeError(f"TVI2V training gradients through the kernels disagree with plain "
                           f"attention: {errs['kernels']}")
    for fault in ("dq = dk = 0", "dq = dk = 0 on the CFCA"):
        if not errs[fault]["worst_leaf"] > GRAD_TOLERANCE:
            raise RuntimeError(f"the TVI2V gradient check passes kernel 4 with {fault}: "
                               f"{errs[fault]}")

    trainable = engine.trainable_parameters()
    before = {n: p.detach().cpu().clone() for n, p in named}
    logdir = Path("build/chip_smoke_tvi2v_train")
    shutil.rmtree(logdir, ignore_errors=True)
    bs, t, h, w = 1, TVI2V_TRAIN_T, TVI2V_TRAIN_H, TVI2V_TRAIN_W
    loader = DataLoader(SyntheticVideoDataset(n_items=4 * bs, num_frames=t, size_hw=(h, w),
                                              seed=seed), batch_size=bs, seed=seed)
    trainer = Trainer(engine, TrainerConfig(
        logdir=str(logdir), max_steps=TRAIN_STEPS, ckpt_every=0, log_every=1, seed=seed,
        base_lr=model_params["base_learning_rate"], autocast_dtype=torch.bfloat16,
        sample_steps=TVI2V_SAMPLE_STEPS), config.build_lr_scheduler(model_params["scheduler_config"]))
    torch.cuda.reset_peak_memory_stats(device)
    att.reset_launch_counts()
    result = trainer.fit(loader, bs, resume=False)
    torch.cuda.synchronize()
    counts = att.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    timed = result.step_seconds[1:]
    step_s = sum(timed) / len(timed)
    print(f"[tvi2v_train] Trainer.fit bs {bs} x {t} x {h}x{w}, {result.step} steps: step seconds "
          f"{[round(x, 4) for x in result.step_seconds]} (first is the warm-up); {step_s:.4f} s "
          f"per step, {bs * t / step_s:.2f} frames/s; peak memory {peak_gb:.2f} GB; losses "
          f"{[round(x, 5) for x in result.losses]}", flush=True)
    print(f"[tvi2v_train] kernel launches over {result.step} steps {json.dumps(counts)}", flush=True)
    if result.step != TRAIN_STEPS or not all(math.isfinite(x) for x in result.losses):
        raise RuntimeError(f"TVI2V training ended at step {result.step} with losses {result.losses}")
    per_step = {v: counts.get(f"spatial_attention_bwd[{v}]", 0) / result.step
                for v in TVI2V_BWD_PER_STEP}
    if (per_step != TVI2V_BWD_PER_STEP or counts["spatial_attention_bwd"]
            != sum(TVI2V_BWD_PER_STEP.values()) * result.step):
        raise RuntimeError(f"expected {TVI2V_BWD_PER_STEP} backward launches a step, got "
                           f"{per_step} ({counts['spatial_attention_bwd']} in all)")
    check_frozen_and_moved(named, before, trainable, "tvi2v_train")
    del before

    # (c) one validation sampling, outside the timed steps, stage by stage
    stages = sample_counted(engine, trainer, next(iter(loader)), result.step, "tvi2v_train",
                            f"{TVI2V_SAMPLE_STEPS} steps at {t}x{h}x{w}")

    # (d) the data-parallel path at world size 1
    check_distributed_step(engine, tvi2v_batch(t, h, w, seed), device, seed)
    print(f"[tvi2v_train] phase 6b in {time.perf_counter() - t0:.1f} s", flush=True)
    del engine, trainer, named, trainable
    gc.collect()
    torch.cuda.empty_cache()
    return {"tvi2v_train": {"train": counts}, "tvi2v_train_sample": stages}


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

    g_kernels, g_plain, g_faults, counts = grads_three_ways(params, backward, fa.FlashAttention)
    if not all(bool(torch.isfinite(g).all()) for g in g_kernels.values()):
        raise FloatingPointError("VAE gradients through the kernels are not finite")
    qk = {n: (g_kernels[n] - g_plain[n]).norm().item() / g_plain[n].norm().item()
          for n in g_plain if ".attn_1.q.weight" in n or ".attn_1.k.weight" in n}
    return dict(kernels=grad_errors(g_kernels, g_plain),
                fault=grad_errors(g_faults["dq = dk = 0"], g_plain), qk=qk, counts=counts)


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


# ---------------------------------------------------------------------------
# phase 8: the network variants
# ---------------------------------------------------------------------------

def interp_batch(t: int, h: int, w: int, seed: int) -> dict:
    """An interpolation training batch of one synthetic clip: the clip, its
    prompt, the clip as the depth network's input and its first and last
    frames (``interpolate_first_last``), as ``data/dataset.py`` makes items."""
    import numpy as np

    clip = np.random.RandomState(seed).uniform(-1, 1, (1, t, h, w, 3)).astype(np.float32)
    return {"jpg": clip, "txt": ["a robot bear walking through the snow"], "control_hint": clip,
            "interpolate_first_last": np.stack([clip[:, 0], clip[:, -1]], axis=1)}


def on_first_last(dq, dk) -> bool:
    """Phase 8 (a)'s second fault: only ``controlnet_img``'s calls, whose
    batch is the clip's first and last frames (2 rows at batch 1; the
    UNet's rows are the 17 frames)."""
    return dq.shape[0] == 2


def part_stats(label: str, t0: float, device) -> None:
    import torch

    torch.cuda.synchronize()
    print(f"[variants] {label} in {time.perf_counter() - t0:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB", flush=True)


def run_interp_train(device, seed: int) -> dict:
    """Phase 8 (a): interpolation training (``INTERP_TRAIN_CONFIG``) at full
    width.  Returns the launch counts of ``Trainer.fit`` and, by stage, of
    its validation sampling."""
    import shutil
    from pathlib import Path

    import torch

    from ccedit_tpu_torch import config
    from ccedit_tpu_torch.cli.train import build_train_engine
    from ccedit_tpu_torch.data.dataset import DataLoader, SyntheticVideoDataset
    from ccedit_tpu_torch.ops import attention as att
    from ccedit_tpu_torch.ops import spatial_attention as sa
    from ccedit_tpu_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    cfg = config.INTERP_TRAIN_CONFIG
    model_params = cfg["model"]["params"]
    engine = build_train_engine(cfg, device, seed)
    torch.cuda.reset_peak_memory_stats(device)
    engine.make_optimizer(1e-4)  # sets the freeze policy's requires_grad flags
    if not engine.network.interpolate:
        raise RuntimeError("INTERP_TRAIN_CONFIG did not build the interpolation network")
    trainable = engine.trainable_parameters()
    print(f"[interp_train] engine built in {time.perf_counter() - t0:.1f} s: freeze policy "
          f"{engine.freeze_policy}, {sum(p.numel() for p in trainable.values()) / 1e6:.1f} M "
          "trainable, fp32 masters, bf16 autocast, use_checkpoint", flush=True)

    # the gradient check at 17 frames of 256x512, with its two faults
    t, h, w = TVI2V_TRAIN_T, TVI2V_GRAD_H, TVI2V_GRAD_W
    f = engine.latent_factor
    batch = interp_batch(t, h, w, seed)
    gen = torch.Generator(device=device)
    zshape = (1, t, h // f, w // f, 4)
    overrides = dict(
        sigmas=torch.tensor([engine.denoiser.sigmas_np[500]], device=device),
        noise=torch.randn(zshape, generator=gen.manual_seed(seed), device=device),
        vae_noise=torch.randn(zshape, generator=gen, device=device))

    def backward():
        engine.backward_step(batch, gen.manual_seed(seed + 1), torch.bfloat16, **overrides)

    faults = (("dq = dk = 0", everywhere),
              ("dq = dk = 0 on controlnet_img's first and last frames", on_first_last))
    g_kernels, g_plain, g_faults, counts = grads_three_ways(trainable, backward,
                                                            sa.SpatialAttention, faults)
    if not all(bool(torch.isfinite(g).all()) for g in g_kernels.values()):
        raise FloatingPointError("interpolation training gradients are not finite")
    errs = {"kernels": grad_errors(g_kernels, g_plain),
            **{name: grad_errors(g, g_plain) for name, g in g_faults.items()}}
    for which, e in errs.items():
        print(f"[interp_train] trainable gradients ({which}) vs plain attention at {t}x{h}x{w}: "
              f"||diff||/||plain|| of the worst of {e['leaves_compared']} of {e['leaves']} "
              f"tensors {e['worst_leaf']:.3e} ({e['worst_leaf_name']}; tol "
              f"{GRAD_TOLERANCE:.0e}), of the whole gradient {e['whole']:.3e}", flush=True)
    print(f"[interp_train] gradient check launches {json.dumps(counts)}", flush=True)
    if not errs["kernels"]["worst_leaf"] <= GRAD_TOLERANCE:
        raise RuntimeError(f"interpolation training gradients through the kernels disagree "
                           f"with plain attention: {errs['kernels']}")
    for name, _ in faults:
        if not errs[name]["worst_leaf"] > GRAD_TOLERANCE:
            raise RuntimeError(f"the interpolation gradient check passes kernel 4 with {name}: "
                               f"{errs[name]}")
    del g_kernels, g_plain, g_faults

    # Trainer.fit at the recipe's batch 1 of 17x384x512
    named = engine_parameters(engine)
    before = {n: p.detach().cpu().clone() for n, p in named}
    logdir = Path("build/chip_smoke_interp_train")
    shutil.rmtree(logdir, ignore_errors=True)
    bs, t, h, w = 1, TVI2V_TRAIN_T, TVI2V_TRAIN_H, TVI2V_TRAIN_W
    loader = DataLoader(SyntheticVideoDataset(n_items=4 * bs, num_frames=t, size_hw=(h, w),
                                              seed=seed), batch_size=bs, seed=seed)
    trainer = Trainer(engine, TrainerConfig(
        logdir=str(logdir), max_steps=INTERP_TRAIN_STEPS, ckpt_every=0, log_every=1, seed=seed,
        base_lr=model_params["base_learning_rate"], autocast_dtype=torch.bfloat16,
        sample_steps=INTERP_SAMPLE_STEPS), config.build_lr_scheduler(model_params["scheduler_config"]))
    att.reset_launch_counts()
    result = trainer.fit(loader, bs, resume=False)
    torch.cuda.synchronize()
    counts = att.launch_counts()
    step_s = sum(result.step_seconds[1:]) / len(result.step_seconds[1:])
    print(f"[interp_train] Trainer.fit bs {bs} x {t} x {h}x{w}, {result.step} steps: step seconds "
          f"{[round(x, 4) for x in result.step_seconds]} (first is the warm-up); {step_s:.4f} s "
          f"per step; losses {[round(x, 5) for x in result.losses]}", flush=True)
    print(f"[interp_train] kernel launches over {result.step} steps {json.dumps(counts)}",
          flush=True)
    if result.step != INTERP_TRAIN_STEPS or not all(math.isfinite(x) for x in result.losses):
        raise RuntimeError(f"interpolation training ended at step {result.step} with losses "
                           f"{result.losses}")
    per_step = {v: counts.get(f"spatial_attention_bwd[{v}]", 0) / result.step
                for v in INTERP_BWD_PER_STEP}
    if (per_step != INTERP_BWD_PER_STEP or counts["spatial_attention_bwd"]
            != sum(INTERP_BWD_PER_STEP.values()) * result.step):
        raise RuntimeError(f"expected {INTERP_BWD_PER_STEP} backward launches a step, got "
                           f"{per_step} ({counts['spatial_attention_bwd']} in all)")
    check_frozen_and_moved(named, before, trainable, "interp_train")
    del before

    # one validation sampling, stage by stage
    stages = sample_counted(engine, trainer, next(iter(loader)), result.step, "interp_train",
                            f"{INTERP_SAMPLE_STEPS} steps at {t}x{h}x{w}")
    part_stats("(a) interpolation training", t0, device)
    del engine, trainer, named, trainable
    gc.collect()
    torch.cuda.empty_cache()
    return {"interp_train": {"train": counts}, "interp_train_sample": stages}


def plain_in_chunks(q, k, v, scale, budget: int = 2 ** 32):
    """The plain attention over slices of the batch axis whose fp32 scores
    fit ``budget`` bytes: (34, 8, 6144, 40)'s scores alone are 41 GB."""
    import torch

    from ccedit_tpu_torch.ops import attention as att

    rows = max(1, budget // (8 * q.shape[1] * q.shape[2] * k.shape[2]))
    return torch.cat([att.plain_attention(q[i:i + rows], k[i:i + rows], v[i:i + rows], scale)
                      for i in range(0, q.shape[0], rows)])


def held_to_plain(fn, faults=()) -> dict:
    """``fn()`` (a tensor or a tuple of them) through the kernels, with its
    launch counts, against ``fn()`` with every attention on its plain
    version (over batch slices, ``plain_in_chunks``), and each planted fault
    (a context manager) against the same: the worst output's max|out -
    plain| / max|plain|."""
    import torch

    from ccedit_tpu_torch.ops import attention as att

    def outputs():
        with torch.no_grad():
            out = fn()
        return [o.float() for o in (out if isinstance(out, (tuple, list)) else (out,))]

    def worst(outs, ref):
        return max(((o - r).abs().max() / r.abs().max()).item() for o, r in zip(outs, ref))

    att.reset_launch_counts()
    kernels = outputs()
    torch.cuda.synchronize()
    counts = att.launch_counts()
    saved = dict(att._ROUTES)
    att._ROUTES.update({k: plain_in_chunks for k in saved})
    try:
        plain = outputs()
    finally:
        att._ROUTES.update(saved)
    errs = {}
    for name, fault in faults:
        with fault():
            errs[name] = worst(outputs(), plain)
    if not all(bool(torch.isfinite(o).all()) for o in kernels):
        raise FloatingPointError("outputs through the kernels are not finite")
    return dict(kernels=worst(kernels, plain), faults=errs, counts=counts)


def halves_swapped(*routes):
    """A planted fault: the named attention routes' kernels return their
    output with the batch's halves swapped (CFG's uc and c rows, or the
    two clips' temporal rows)."""
    import contextlib

    from ccedit_tpu_torch.ops import attention as att

    @contextlib.contextmanager
    def fault():
        saved = dict(att._ROUTES)
        for r in routes:
            att._ROUTES[r] = lambda q, k, v, s, _fn=saved[r]: _fn(q, k, v, s).roll(
                q.shape[0] // 2, dims=0)
        try:
            yield
        finally:
            att._ROUTES.update(saved)

    return fault


def own_tokens_as_reference():
    """A planted fault for RAIG: every reference attention reads the
    query's own tokens in place of its bank entry."""
    import contextlib

    from ccedit_tpu_torch.modules.transformer import SpatialTransformerCA

    @contextlib.contextmanager
    def fault():
        forward = SpatialTransformerCA.forward

        def faulty(self, x, context=None, ref_context=None, kv_reuse_every=0):
            if ref_context is not None:
                ref_context = x.reshape(x.shape[0], -1, x.shape[-1])
            return forward(self, x, context, ref_context, kv_reuse_every)

        SpatialTransformerCA.forward = faulty
        try:
            yield
        finally:
            SpatialTransformerCA.forward = forward

    return fault


def random_module(module, device, seed: int):
    """``module`` on ``device`` with seeded random weights (the
    zero-initialised layers and the alphas included), in bf16, eval mode."""
    import torch

    from ccedit_tpu_torch.io.checkpoint import randomize_weights_

    randomize_weights_(module.to(device), torch.Generator(device=device).manual_seed(seed))
    return module.to(torch.bfloat16).eval()


def check_held(label: str, res: dict, want: dict) -> dict:
    """Print a ``held_to_plain`` result and fail unless the kernels agree
    within ROUTE_TOLERANCE, every fault breaks it and every launch count of
    ``want`` (name -> least count) was reached."""
    print(f"[variants] {label}: max|kernels - plain| / max|plain| {res['kernels']:.3e} (tol "
          f"{ROUTE_TOLERANCE:.0e}); planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in res["faults"].items())
          + f"; launches {json.dumps(res['counts'])}", flush=True)
    if not res["kernels"] <= ROUTE_TOLERANCE:
        raise RuntimeError(f"{label} through the kernels disagrees with plain attention: "
                           f"{res['kernels']}")
    for name, err in res["faults"].items():
        if not err > ROUTE_TOLERANCE:
            raise RuntimeError(f"{label}'s check passes the planted fault {name}: {err}")
    short = {k: n for k, n in want.items() if res["counts"].get(k, 0) < n}
    if short:
        raise RuntimeError(f"{label} launched fewer than {short}: {res['counts']}")
    return res["counts"]


def run_variants(device, seed: int) -> dict:
    """Phase 8: the network variants at full SD-1.5 width.  (a) interpolation
    training; (b) one forward of RAIG's 2-D network on (2, 64, 64, 4),
    512x512 doubled for CFG; (c) ControlNet3D in both modes and (d) a
    pseudo-3D UNet with temporal text cross-attention, Linear projections,
    learnable alphas off 1, scale-shift norm and ``label_emb``, each on
    (2, 17, 64, 96); (b)-(d) held to plain attention, each refusing its
    planted fault.  Returns the launch counts of each part, by path."""
    import copy

    import torch

    from ccedit_tpu_torch import config
    from ccedit_tpu_torch.modules.controlnet import ControlNet3D
    from ccedit_tpu_torch.modules.unet import UNetModel

    t0 = time.perf_counter()
    by_path = run_interp_train(device, seed)
    sd15 = {k: tuple(v) if isinstance(v, list) else v for k, v in config._SD15_UNET.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = lambda *s: torch.randn(s, generator=gen, device=device).to(torch.bfloat16)

    # (b) RAIG
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    appearance = copy.deepcopy(config.TVI2V_CONFIG["model"]["params"]["network_config"]
                               ["params"]["controlnet_img_config"])
    with device:
        net = config.build_network({
            "target": "sgm.modules.diffusionmodules.controlmodel.ControlledUNetModel2DRAIG",
            "params": dict(config._SD15_UNET, controlnet_img_config=appearance)})
    net = random_module(net, device, seed)
    x, ts = bf16(2, 64, 64, 4), torch.tensor([999.0, 999.0], device=device)
    cond = {"crossattn": bf16(2, 77, sd15["context_dim"]), "cond_feat": bf16(2, 64, 64, 4)}
    res = held_to_plain(lambda: net(x, ts, cond),
                        (("the query's own tokens as the reference", own_tokens_as_reference()),))
    by_path["raig"] = {"forward": check_held("(b) RAIG at 2x512x512", res, {
        "spatial_attention[d40 n_k=n_q]": 12, "spatial_attention[d80 n_k=n_q]": 12})}
    del net
    part_stats("(b) RAIG", t1, device)

    # (c) ControlNet3D, both modes
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    with device:
        cn3d = ControlNet3D(**sd15)
    cn3d = random_module(cn3d, device, seed)
    x, hint = bf16(2, 17, 64, 96, 4), bf16(2, 17, 64, 96, 4)
    ctx = bf16(2, 77, sd15["context_dim"])
    stages = {}
    for mode in (False, True):
        cn3d.disable_temporal = mode
        label = "centre frame" if mode else "17 frames"
        res = held_to_plain(lambda: cn3d(x, hint, ts, context=ctx), (
            ("kernels 1 and 2 with their batch halves swapped",
             halves_swapped("spatial", "temporal")),))
        stages[label] = check_held(f"(c) ControlNet3D, {label}, at 2x17x512x768", res, {
            "spatial_attention[d40 n_k=n_q]": 1, "temporal_attention": 1})
    by_path["controlnet3d"] = stages
    del cn3d
    part_stats("(c) ControlNet3D", t1, device)

    # (d) the pseudo-3D UNet with the remaining options
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    with device:
        unet = UNetModel(**dict(sd15, unet_type="pseudo-3d", disable_temporal_text_ca=False,
                                use_linear_in_transformer=True, use_learnable_alpha=True,
                                use_scale_shift_norm=True, adm_in_channels=ADM_CHANNELS))
    unet = random_module(unet, device, seed)
    alphas = [p.float() for n, p in unet.named_parameters() if "alpha_temporal" in n]
    y = bf16(2, ADM_CHANNELS)
    res = held_to_plain(lambda: unet(x, ts, context=ctx, y=y), (
        ("kernels 1 and 2 with their batch halves swapped",
         halves_swapped("spatial", "temporal")),))
    print(f"[variants] (d) {len(alphas)} learnable alphas in "
          f"[{min(a.min().item() for a in alphas):.3f}, "
          f"{max(a.max().item() for a in alphas):.3f}]", flush=True)
    by_path["unet_variants"] = {"forward": check_held(
        "(d) pseudo-3D UNet (temporal text cross-attention, use_linear, alphas, scale-shift, "
        "label_emb) at 2x17x512x768", res,
        {"spatial_attention[d40 n_k=n_q]": 1, "temporal_attention": 1})}
    del unet
    part_stats("(d) pseudo-3D UNet options", t1, device)
    print(f"[variants] phase 8 in {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return by_path

# ---------------------------------------------------------------------------
# phase 9: conditioning
# ---------------------------------------------------------------------------

# the hints of phase 9 (a): (label, reference target, params, backbone family)
HINTS = (("lineart_standard", "LineartEncoder", {}, None),
         ("lineart_model", "LineartEncoder", {"lineart_standard": False}, "lineart_model"),
         ("softedge_hed", None, {}, "hed"),
         ("softedge_pidinet", "SoftEdgeEncoder", {"safe": True}, "pidinet"),
         ("scribble_hed", "ScribbleHEDEncoder", {}, "hed"),
         ("scribble_pidinet", "ScribblePidiNetEncoder", {}, "pidinet"),
         ("normal_bae", "NormalBaeEncoder", {}, "normal_bae"),
         ("openpose", "OpenposeEncoder", {}, "openpose"))
# phase 9 (b): the TV2V edit with its depth hint replaced
HINT_EDITS = (("tv2v_softedge", "SoftEdgeEncoder", "pidinet"),
              ("tv2v_openpose", "OpenposeEncoder", "openpose"))
# a backbone family's maps on the clip's first chunk in bf16 against the same
# module in fp32, by the cosine of the maps with each channel's mean taken
# out (the pose network's 57 maps each carry their own offset); each family's
# planted fault must fall below it.  NormalBAE stays fp32 (its refinements
# pick pixels by kappa order, which bf16 rounding reshuffles), so its check
# is exact and only its fault is informative.  First H100 reading: 0.99491
# (PiDiNet, 16 residual blocks) to 0.99995 (HED) sound, 0.085 (PiDiNet
# unfolded) to 0.867 (HED's sigmoid first) with the faults
HINT_COSINE = 0.99
# the text and image towers in bf16 against fp32, centred cosine
TOWER_COSINE = 0.999
# the host steps against their plain numpy versions: lineart-standard's
# max |difference| (values in [-1, 1]); the NMS by the intersection over
# union of the pixels either side marks (an empty union fails)
LINEART_TOLERANCE = 1e-3
NMS_IOU = 0.99
# the heatmap head's bias is set so that this share of the first frame's
# heatmap values passes 0.1, openpose's peak threshold: few peaks, so the
# host assembly of a random network stays small
POSE_HOT_SHARE = 1e-3


def channel_centred_cosine(a, b) -> float:
    """Cosine of two (N, H, W, C) maps, each channel less its own mean."""
    a, b = a.double(), b.double()
    return cosine(a - a.mean(dim=(0, 1, 2)), b - b.mean(dim=(0, 1, 2)))


def family_maps(family: str, model, frames, fault: bool = False):
    """A backbone family's maps on (N, H, W, 3) frames in [-1, 1], fp32;
    ``fault`` plants the family's fault here (HED: the sigmoid on each
    projection before their mean; NormalBAE: a copy whose refinement heads
    return their points' own estimate, so the refinements change nothing;
    openpose: the frames fed reversed, so that its BGR flip hands the
    network RGB; PiDiNet's, the PDC fold left out, is planted in its
    weights)."""
    import copy

    import torch
    import torch.nn.functional as F

    from ccedit_tpu_torch.conditioning.annotators.hed import detect_hed
    from ccedit_tpu_torch.conditioning.annotators.lineart_model import detect_lineart
    from ccedit_tpu_torch.conditioning.annotators.normalbae import detect_normalbae
    from ccedit_tpu_torch.conditioning.annotators.openpose import openpose_maps
    from ccedit_tpu_torch.conditioning.annotators.pidinet import detect_pidinet

    class KeepInit(torch.nn.Module):
        def forward(self, x):  # (B, C + 4, k) sampled points -> their estimate
            return x[:, -4:]

    if family == "lineart_model":
        return detect_lineart(model, frames)
    if family == "hed" and fault:
        x = ((frames + 1.0) * 127.5).permute(0, 3, 1, 2).to(next(model.parameters()).dtype)
        ups = [torch.sigmoid(F.interpolate(p.float(), size=frames.shape[1:3], mode="bilinear",
                                           align_corners=False)) for p in model(x)]
        return torch.stack(ups).mean(dim=0).permute(0, 2, 3, 1)
    if family == "hed":
        return detect_hed(model, frames)
    if family == "pidinet":
        return detect_pidinet(model, ((frames + 1.0) * 0.5).flip(-1))
    if family == "normal_bae":
        if fault:
            model = copy.deepcopy(model)
            for stage in ("res4", "res2", "res1"):
                setattr(model.decoder, f"out_conv_{stage}", KeepInit())
        return detect_normalbae(model, (frames + 1.0) * 0.5)
    return torch.cat(openpose_maps(model, frames.flip(-1) if fault else frames), dim=-1)


def write_hint_checkpoints(device, seed: int, first_frames) -> dict:
    """Seeded random checkpoints of every backbone family, in the reference
    files' layouts, written to ``build/chip_smoke_conditioning``; the pose
    network's heatmap bias is set on ``first_frames`` (POSE_HOT_SHARE).
    Returns {family: path}."""
    import pathlib

    import torch

    from ccedit_tpu_torch.conditioning.annotators.openpose import (bodypose_from_state_dict,
                                                                   openpose_maps)
    from ccedit_tpu_torch.conditioning.annotators.random_weights import random_checkpoint

    out_dir = pathlib.Path("build") / "chip_smoke_conditioning"
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    paths = {}
    for family, name in (("lineart_model", "sk_model.pth"), ("hed", "ControlNetHED.pth"),
                         ("pidinet", "table5_pidinet.pth"), ("normal_bae", "scannet.pt"),
                         ("openpose", "body_pose_model.pth")):
        sd = random_checkpoint(family, gen)
        if family == "openpose":
            with torch.no_grad():
                heat = openpose_maps(bodypose_from_state_dict(sd).to(device), first_frames)[0]
            hot = torch.quantile(heat[..., :18].flatten()[::7], 1.0 - POSE_HOT_SHARE).item()
            sd["Mconv7_stage6_L2.bias"] += 0.1 - hot
        torch.save(_to_cpu(sd), out_dir / name)
        paths[family] = str(out_dir / name)
    return paths


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def structured_clip(t: int, h: int, w: int):
    """The moving-gradient clip with hard edges and saturated colours in it
    (a red box moving right, a blue disc moving left, a dark horizontal
    line), so that every hint has edges, lines and colour to read."""
    import numpy as np

    from ccedit_tpu_torch.data.video import moving_gradient_clip

    clip = moving_gradient_clip(t, h, w).copy()
    yy, xx = np.mgrid[0:h, 0:w]
    for f in range(t):
        x0, y0 = int(w * (0.15 + 0.02 * f)), int(h * 0.3)
        clip[f, y0:y0 + h // 4, x0:x0 + w // 6] = (200, 30, 30)
        disc = (yy - 0.6 * h) ** 2 + (xx - w * (0.7 - 0.01 * f)) ** 2 < (0.12 * h) ** 2
        clip[f][disc] = (30, 40, 220)
        clip[f, int(0.8 * h):int(0.8 * h) + max(2, h // 128)] = 0
    return clip


def plain_lineart(frame):
    """lineart-standard in float64 numpy (scipy's correlate1d with edge
    replication, the lower median) on one (H, W, 3) frame in [-1, 1]."""
    import numpy as np
    from scipy.ndimage import correlate1d

    x255 = (frame.astype(np.float64) + 1.0) * 0.5 * 255.0
    r = np.arange(37) - 18.0
    k = np.exp(-r ** 2 / 72.0)
    k /= k.sum()
    g = correlate1d(correlate1d(x255, k, axis=0, mode="nearest"), k, axis=1, mode="nearest")
    intensity = np.clip((g - x255).min(axis=-1), 0.0, 255.0)
    above = np.sort(intensity[intensity > 8.0])
    med = above[(len(above) - 1) // 2] if len(above) else 0.0
    out = np.clip(intensity / max(16.0, med) * 127.0, 0.0, 255.0)
    return -(out / 255.0 * 2.0 - 1.0)


def plain_nms(edge_u8):
    """The scribble NMS in scipy: a float64 sigma-3 Gaussian (25 taps,
    mirrored border), the pixels that are maxima along a line orientation,
    then > 127."""
    import numpy as np
    from scipy.ndimage import correlate1d, maximum_filter

    from ccedit_tpu_torch.conditioning.annotators.scribble import _LINES

    r = np.arange(25) - 12.0
    k = np.exp(-r ** 2 / 18.0)
    k /= k.sum()
    x = edge_u8.astype(np.float64)
    x = correlate1d(correlate1d(x, k, axis=0, mode="mirror"), k, axis=1, mode="mirror")
    x = x.astype(np.float32)
    y = np.zeros_like(x)
    for f in _LINES:
        peak = maximum_filter(x, footprint=f.astype(bool), mode="constant", cval=-np.inf) == x
        y[peak] = x[peak]
    return np.where(y > 127, 255, 0).astype(np.uint8)


def pose_roundtrip(h: int, w: int):
    """A person planted as heatmap peaks and PAFs (one Gaussian per joint,
    unit vectors along each limb) -> (the canvas the host assembly draws,
    the canvas drawn from the planted joints)."""
    import numpy as np

    from ccedit_tpu_torch.conditioning.annotators import openpose as op

    joints = np.array([[0.50, 0.15], [0.50, 0.25], [0.40, 0.25], [0.36, 0.40], [0.33, 0.55],
                       [0.60, 0.25], [0.64, 0.40], [0.67, 0.55], [0.44, 0.55], [0.43, 0.72],
                       [0.42, 0.90], [0.56, 0.55], [0.57, 0.72], [0.58, 0.90], [0.47, 0.12],
                       [0.53, 0.12], [0.44, 0.13], [0.56, 0.13]])
    px = np.round(joints * [w, h]).astype(int)
    yy, xx = np.mgrid[0:h, 0:w]
    heat = np.zeros((h, w, 19), np.float32)
    for p, (x, y) in enumerate(px):
        heat[..., p] = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 18.0)
    paf = np.zeros((h, w, 38), np.float32)
    for k, (a, b) in enumerate(op.LIMB_SEQ):
        pa, pb = px[a - 1].astype(float), px[b - 1].astype(float)
        v = (pb - pa) / max(np.hypot(*(pb - pa)), 1e-3)
        for s in np.linspace(0.0, 1.0, 200):
            x, y = np.round(pa + s * (pb - pa)).astype(int)
            paf[max(y - 3, 0):y + 4, max(x - 3, 0):x + 4, op.MAP_IDX[k][0] - 19] = v[0]
            paf[max(y - 3, 0):y + 4, max(x - 3, 0):x + 4, op.MAP_IDX[k][1] - 19] = v[1]
    cand = np.concatenate([px / [w, h], np.ones((18, 1)), np.arange(18)[:, None]], axis=1)
    subset = np.concatenate([np.arange(18.0), [18.0, 18.0]])[None]
    return op.pose_canvas(heat, paf), op.draw_bodypose(np.zeros((h, w, 3), np.uint8), cand,
                                                       subset)


def check_hints(device, seed: int, clip, paths: dict) -> None:
    """Phase 9 (a): every hint on the clip through the conditioner's CHUNK
    loop (bf16 backbones; NormalBAE fp32), each backbone family's maps held
    to fp32 with its planted fault refused, and the host steps held to
    their plain numpy versions."""
    import copy

    import numpy as np
    import torch

    from ccedit_tpu_torch.conditioning.annotators.base import CHUNK, AnnotatorEmbedder, \
        build_annotator
    from ccedit_tpu_torch.conditioning.annotators.pidinet import PiDiNet
    from ccedit_tpu_torch.conditioning.annotators.scribble import nms
    from ccedit_tpu_torch.io.checkpoint import load_torch_state_dict

    frames = clip.float() / 127.5 - 1.0
    chunk = frames[:CHUNK]
    checked = set()
    for label, target, params, family in HINTS:
        t0 = time.perf_counter()
        if target is None:  # HED soft edge: no reference target of its own
            emb = AnnotatorEmbedder(label, backbone=build_annotator(
                "ScribbleHEDEncoder", {"ckpt_path": paths[family]}).backbone)
        else:
            emb = build_annotator(target, dict(params, ckpt_path=paths.get(family)))
        emb = emb.to(device).to(torch.bfloat16).eval()
        with torch.no_grad():
            if family is not None and family not in checked:
                checked.add(family)
                net32 = copy.deepcopy(emb.backbone).float()
                ref = family_maps(family, net32, chunk)
                sound = channel_centred_cosine(family_maps(family, emb.backbone, chunk), ref)
                fault = None  # lineart_model has no planted fault
                if family == "pidinet":  # the raw PDC weights as plain 3x3 convs
                    faulty = PiDiNet(pdcs=("cv",) * 16)
                    faulty.load_state_dict(load_torch_state_dict(paths[family]))
                    faulty = faulty.to(device).to(torch.bfloat16)
                    fault = channel_centred_cosine(family_maps(family, faulty, chunk), ref)
                    del faulty
                elif family != "lineart_model":
                    fault = channel_centred_cosine(
                        family_maps(family, emb.backbone, chunk, True), ref)
                del net32
                print(f"[conditioning] {family} maps of the first chunk, bf16 vs fp32 on the "
                      f"card: channel-centred cosine {sound:.6f}" + ("" if fault is None else
                      f"; with the planted fault {fault:.6f}") + f" (limit {HINT_COSINE})",
                      flush=True)
                if not sound >= HINT_COSINE:
                    raise RuntimeError(f"the bf16 {family} maps left the fp32 ones: {sound}")
                if fault is not None and not fault < HINT_COSINE:
                    raise RuntimeError(f"the {family} check passes its planted fault: {fault}")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            hint = emb(clip[None])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
        if hint.shape != (1, T, H, W, 3) or not bool(torch.isfinite(hint).all()) \
                or hint.abs().max().item() > 1.0:
            raise RuntimeError(f"the {label} hint is {tuple(hint.shape)}, finite "
                               f"{bool(torch.isfinite(hint).all())}, max |x| "
                               f"{hint.abs().max().item()}")
        print(f"[conditioning] {label} hint of {T}x{H}x{W}: {seconds:.3f} s "
              f"(mean {hint.mean().item():.4f}, std {hint.std().item():.4f}; with its build "
              f"and check {time.perf_counter() - t0:.1f} s)", flush=True)
        if label == "lineart_standard":
            err = float(np.abs(hint[0, 0, ..., 0].cpu().numpy()
                               - plain_lineart(frames[0].cpu().numpy())).max())
            print(f"[conditioning] lineart-standard on the card vs float64 numpy: max |diff| "
                  f"{err:.2e} (tol {LINEART_TOLERANCE:.0e})", flush=True)
            if not err <= LINEART_TOLERANCE:
                raise RuntimeError(f"lineart-standard disagrees with its numpy version: {err}")
        if label == "scribble_hed":
            with torch.no_grad():
                edge = family_maps("hed", emb.backbone.float(), frames[:1])[0, ..., 0]
            edge_u8 = np.clip(edge.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
            ours, plain = nms(edge_u8, 127, 3.0) > 0, plain_nms(edge_u8) > 0
            union = int((ours | plain).sum())
            if union == 0:
                raise RuntimeError("neither NMS marked a pixel: nothing was compared")
            iou = int((ours & plain).sum()) / union
            print(f"[conditioning] scribble NMS vs its scipy version: intersection over union "
                  f"{iou:.6f} of the {union} pixels either marks (limit {NMS_IOU}); marked "
                  f"{ours.mean():.6f} and {plain.mean():.6f} of the frame, "
                  f"{(edge_u8 > 127).mean():.4f} of the edge above 127", flush=True)
            if not iou >= NMS_IOU:
                raise RuntimeError(f"the scribble NMS disagrees with scipy's: IoU {iou}")
        del emb, hint
        torch.cuda.empty_cache()
    drawn, planted = pose_roundtrip(H, W)
    lit = drawn.any(-1) | planted.any(-1)
    agree = float((drawn == planted).all(-1)[lit].mean())
    print(f"[conditioning] pose assembly of a planted person: {agree:.6f} of the {int(lit.sum())} "
          "drawn pixels equal the planted pose's", flush=True)
    if not agree == 1.0:
        raise RuntimeError(f"the pose assembly did not recover the planted person: {agree}")


def random_tower_(module, generator):
    """Seeded random weights in place: matrices N(0, 1/fan_in), norm scales
    1 + N(0, 0.1^2), other vectors N(0, 0.1^2).  Returns the state dict
    drawn (the module's keys are the reference layout's)."""
    import torch

    sd = {}
    for k, v in module.state_dict().items():
        x = torch.randn(v.shape, generator=generator, device=generator.device)
        if v.dim() >= 2:
            x = x / max(1, v[0].numel()) ** 0.5
        elif k.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        sd[k] = x
    return sd


def check_towers(device, seed: int, clip) -> None:
    """Phase 9 (c): OpenCLIP ViT-H/14 text (penultimate, legacy) and vision,
    and T5 v1.1-XL with CLIP-L through ``CLIPT5Embedder``, at full width in
    bf16 against fp32, each loaded through the port's loaders; then the
    native tokenizer, built with g++, against the Python one."""
    import copy
    import json as _json
    import pathlib

    import numpy as np
    import torch

    from ccedit_tpu_torch.conditioning import embedders as E
    from ccedit_tpu_torch.conditioning import native_tokenizer
    from ccedit_tpu_torch.conditioning.tokenizer import (ClipTokenizer, bytes_to_unicode,
                                                         load_tokenizer)
    from ccedit_tpu_torch.modules.clip import CLIPTextModel
    from ccedit_tpu_torch.modules.openclip import (OpenCLIPTextModel, OpenCLIPVisionModel,
                                                   load_openclip_text, load_openclip_vision)
    from ccedit_tpu_torch.modules.t5 import T5Encoder, load_t5_encoder

    gen = torch.Generator(device=device).manual_seed(seed + 19)
    prompt = ["a robot bear walking through the snow", "ugly, low quality"]
    with device:
        text = OpenCLIPTextModel()
        vision = OpenCLIPVisionModel()
        d_model, d_kv, d_ff, heads, layers = E.T5TextEmbedder.SIZES["google/t5-v1_1-xl"]
        t5 = T5Encoder(d_model=d_model, d_kv=d_kv, d_ff=d_ff, heads=heads, layers=layers)
        clip_l = CLIPTextModel()
    load_openclip_text(text, random_tower_(text, gen))
    load_openclip_vision(vision, {"visual." + k: v for k, v in random_tower_(vision, gen).items()})
    t5_sd = random_tower_(t5, gen)
    for k in t5_sd:  # T5's own init folds 1/sqrt(d_kv) into q, as it never scales its logits
        if k.endswith("SelfAttention.q.weight"):
            t5_sd[k] = t5_sd[k] * d_kv ** -0.5
    load_t5_encoder(t5, t5_sd)
    clip_l.load_state_dict(random_tower_(clip_l, gen))
    t5_tokens = torch.randint(1, 32128, (2, 77), generator=gen, device=device)
    t5_tokens[:, 24:] = 0
    towers = {
        "OpenCLIP ViT-H/14 text (penultimate, legacy)": (
            E.OpenCLIPTextEmbedder(layer="penultimate", model=text), prompt, None),
        "OpenCLIP ViT-H/14 vision": (
            E.OpenCLIPImageEmbedder(model=vision), clip[[0, T - 1]].float() / 127.5 - 1.0, None),
        "T5 v1.1-XL + CLIP-L (CLIPT5Embedder)": (
            E.CLIPT5Embedder(clip=clip_l, t5=t5), None,
            lambda emb: {"clip": emb.clip.prepare(prompt, device), "t5": t5_tokens}),
    }
    for label, (emb, value, prepare) in towers.items():
        emb = emb.eval()
        n = sum(p.numel() for p in emb.parameters())
        prepared = prepare(emb) if prepare else emb.prepare(value, device)
        emb16 = copy.deepcopy(emb).to(torch.bfloat16)
        with torch.no_grad():
            ref = emb(prepared)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = emb16(prepared)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
        outs, refs = (out, ref) if isinstance(out, list) else ([out], [ref])
        cosines = [centred_cosine(o.float(), r) for o, r in zip(outs, refs)]
        print(f"[conditioning] {label}: {n / 1e6:.1f} M parameters, bf16 forward "
              f"{seconds * 1e3:.1f} ms, output {[tuple(o.shape) for o in outs]}; centred cosine "
              f"vs fp32 {', '.join(f'{c:.6f}' for c in cosines)} (limit {TOWER_COSINE})",
              flush=True)
        if not all(bool(torch.isfinite(o).all()) for o in outs) or \
                not min(cosines) >= TOWER_COSINE:
            raise RuntimeError(f"{label} in bf16 left fp32: {cosines}")
        del emb, emb16, ref, out
        torch.cuda.empty_cache()

    d = pathlib.Path("build") / "chip_smoke_conditioning"
    base = list(bytes_to_unicode().values())
    vocab = {v: i for i, v in enumerate(base + [b + "</w>" for b in base])}
    for extra in ("he", "lo</w>", "llo</w>", "ing</w>", "th", "in", "the</w>",
                  "<|startoftext|>", "<|endoftext|>"):
        vocab[extra] = len(vocab)
    (d / "vocab.json").write_text(_json.dumps(vocab))
    (d / "merges.txt").write_text("#version\nh e\nl o</w>\nl lo</w>\nt h\ni n\nth e</w>\n")
    t1 = time.perf_counter()
    lib = native_tokenizer.build_library()
    built = time.perf_counter() - t1
    native = load_tokenizer(str(d))  # the text encoders' own choice of tokenizer
    if not isinstance(native, native_tokenizer.NativeClipTokenizer):
        raise RuntimeError(f"load_tokenizer gave {type(native).__name__}, not the native one")
    py = ClipTokenizer(str(d / "vocab.json"), str(d / "merges.txt"))
    texts = prompt + ["hello the world", "The    QUICK brown fox, it's 42!", "",
                      "punctuation... everywhere?! (yes)", "thing in the inn " * 20]
    same = bool(np.array_equal(native(texts), py(texts)))
    print(f"[conditioning] native tokenizer {lib.name} built with g++ in {built:.1f} s; "
          f"{len(texts)} prompts id for id equal to the Python tokenizer's: {same}", flush=True)
    if not same:
        raise RuntimeError("the native tokenizer disagrees with the Python one")


def run_conditioning(device, seed: int) -> dict:
    """Phase 9: (a) every structure hint on ``structured_clip``, (b) the TV2V
    edit (on phase 4's clip) with
    the PiDiNet soft edge and with openpose as its hint, (c) the text and
    image towers and the native tokenizer.  Returns the edits' per-stage
    counts, as paths."""
    import copy

    import torch

    from ccedit_tpu_torch.cli.profile_tv2v import build_edit
    from ccedit_tpu_torch.config import TV2V_CONFIG

    t0 = time.perf_counter()
    print(f"[conditioning] {torch.cuda.memory_allocated(device) / 1e9:.2f} GB allocated before "
          "the phase", flush=True)
    clip = torch.from_numpy(structured_clip(T, H, W)).to(device)
    paths = write_hint_checkpoints(device, seed, clip[:1].float() / 127.5 - 1.0)
    check_hints(device, seed, clip, paths)
    print(f"[conditioning] (a) hints in {time.perf_counter() - t0:.1f} s", flush=True)

    t1 = time.perf_counter()
    by_path = {}
    for path, target, family in HINT_EDITS:
        t2 = time.perf_counter()
        cfg = copy.deepcopy(TV2V_CONFIG)
        specs = cfg["model"]["params"]["conditioner_config"]["params"]["emb_models"]
        hint = next(s for s in specs if s["input_key"] == "control_hint")
        hint.update(target=f"sgm.modules.encoders.modules.{target}",
                    params={"ckpt_path": paths[family]})
        engine, edit, cfg_scale = build_edit("tv2v", device, seed, STEPS, config=cfg)
        print(f"[{path}] engine built in {time.perf_counter() - t2:.1f} s, its hint "
              f"{target}, CFG {cfg_scale}", flush=True)
        _, _, by_path[path] = edit_counted(edit, device, STEPS, seed, path)
        del engine, edit
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[conditioning] (b) edits in {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    check_towers(device, seed, clip)
    print(f"[conditioning] (c) towers and tokenizer in {time.perf_counter() - t1:.1f} s; "
          f"phase 9 in {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


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
    by_path.update(run_zoe(device, SEED))
    by_path["train"] = run_train(device, SEED)
    by_path.update(run_tvi2v_train(device, SEED))
    by_path["vae_train"] = run_vae_train(device, SEED)
    # phase 8: the network variants; phase 9: conditioning
    by_path.update(run_variants(device, SEED))
    by_path.update(run_conditioning(device, SEED))
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
