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
 10. image sampling and the secondary entry points (``run_image``): SD-2.1-768
     at full width, the demo, the auto pipeline, InceptionV3 and FID, the
     safety filter and the watermark, the toy trainer.
 11. one clip over the cards (``run_clip_shard``): ``torchrun`` starts
     min(4, cards) ranks of this script (``--clip-shard-rank``, NCCL), each
     building the full-width TV2V engine from the same seed.  A TV2V
     network row (17x512x768, CFG-doubled, bf16, through the kernels) split
     on the height axis (``parallel/sampling.py::pick_clip_axis``) and
     gathered is held to the same row on one card (ROUTE_TOLERANCE, cosine
     CLIP_COSINE), and each planted fault of ``clip_shard_fault`` (halos
     left out, the GroupNorm on local statistics, k/v not gathered) must
     fail that check; a row at 16 frames on the frame axis likewise.  Rows
     whose UNet levels do not divide the ranks (GSPMD's padding): 17x576x1024
     on the height axis (level 3's 9 rows; level 2's 18 at 4 ranks), where
     the padding faults (its rows not zeroed before a conv, counted in the
     GroupNorm statistics) must fail, and 16x320x576 on the frame axis
     (level 3's 90 temporal rows at 4 ranks).  The rows again under W8A8
     (``clip_w8a8_row``: every scale equal on the ranks, the external form,
     the W8A8 faults).  At 576x1024 the first padded site must be blind to
     what its padding rows hold (``padded_site_check``: its real outputs
     bit for bit the same with the padding set to 1e3), which each padding
     fault must fail (pad_amax, the fused form at padded levels, under
     W8A8).  Then 3-step edits sampled split over the ranks (rank 0
     decodes), held to the one-card edit from the same seed by their final
     latents' cosine (LATENT_COSINE): TV2V at 512x768 and at 576x1024, W8A8
     TV2V, TVI2V, with every rank's launches by stage (kernel 1 only at the
     gathered n_k in the sharded TV2V sample; 1b, 2 and 3 on the TVI2V
     path); a 3-step blending sample at 4x512x768 and a 3-step sample of
     the interpolation network at 16x512x768, both on the frame axis, held
     likewise, where the blending hook on each rank's own frames
     (``blend_local``) and the interpolation controls added on every rank
     (``interp_local``) must fail; a row of RAIG's 2-D network at 2x512x512
     split on its rows.
     On a single card the phase runs at world 1 through the same code,
     where the sharded samples must equal the one-card ones bit for bit and
     the faults cannot act (the phase says so).  Phase 3 holds kernels 1
     and 1b at the gathered shapes (n_k = 4 n_q and 2 n_q; 8 n_q and 4 n_q
     for 1b; 576x1024's levels 0 and 1 at 4 ranks) with the log2 e fault.
 12. the W8A8 path (``ops/quant.py``; kernels 8-10: ``csrc/quantize_int8.cu``,
     ``int8_gemm.cu``'s dequant GEMM in its two forms, ``int8_conv.cu``).
     (a) Each kernel at the shapes the main path gives it (``W8A8_SHAPES``:
     the level-0 and level-1 3x3 convs of the CFG-doubled clip, the level-0
     TemporalConv, conv_in with K = 36, the VAE decoder's 3x3 and conv_out,
     the dense products of every level (320 -> 320, 320 -> 2560 and 1280 ->
     320 over 208,896 tokens, the level-1 and level-2 ones over 52,224 and
     13,056), the cross-attention k/v over 2,618 context tokens and the
     ResBlock embedding over 34): the quantizer's int8 values and scales bit
     for bit its plain version's, the raw int32 accumulators bit for bit,
     the epilogue's output within phase 3's gate, and the check refusing
     its planted faults (dense: the per-row scale dropped; conv: the window
     shifted one row, and one column); each with its bound, plain time and
     yardstick (``torch._int_mm`` + rescale; cuDNN's bf16 conv).  A dense
     shape that ``quant.gemm_route`` sends to the fused form (kernel 9 on
     the bf16 tokens, quantizing them in shared memory) is checked on that
     route too: its int8 values and scales bit for bit kernel 8's plain
     version's, its accumulators bit for bit, its output within the gate,
     the per-row scale dropped and one amax for 64 rows refused, its time
     beside the two launches it replaces.  The tile ``quant.gemm_tiles``
     picks must be the one kernel 9 reports.  The conv rows add the level-0
     stride-2 Downsample, a decoder ResBlock's 1x1 skip, the level-2 3x3,
     the temporal k = 1 conv, the VAE decoder's 512-channel 3x3 at 256x384,
     the VAE encoder's (0, 1) stride-2 downsample and the hint pyramid's
     first conv (Cp = 16, O = 16), so every tile of kernel 10 runs; at each,
     the tile ``quant.conv_tiles`` picks must be the one the kernel reports.
     (b) Run inside phases 4 and 5 on their engines before they are freed:
     the edit with ``CCEDIT_QUANT_MATMUL=1`` and with ``CCEDIT_INT8=1``,
     kernels 8-10 (kernel 9 in both forms) launched on both and on no other
     path, kernel 1c on the umbrella alone; the umbrella edit's final
     latents held to the same edit through the kernels' plain versions on
     the card (exact fp64 int8 products, TF32 off) by cosine
     (W8A8_LATENT_COSINE), which the edit with the weight scales read per
     input channel must fail, and bit for bit to the same edit with every
     dense product on the two-launch route (both with cuDNN's deterministic
     algorithms).
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

import contextlib
import copy
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
# training shapes (TV2V's, and TVI2V's CFCA at n_k = 2 n_q), every d = 512
# shape (VAE training) and every d = 64 one (an SD-2.x UNet's)
DELTA_FAULT_SHAPES = ((48, 8, 3072, 40), (48, 8, 768, 80), (17, 8, 3072, 40),
                      (17, 8, 768, 80), (12, 1, 1024, 512), (4, 1, 4096, 512),
                      (2, 1, 600, 512), (2, 10, 2304, 64), (2, 5, 9216, 64),
                      (2, 20, 576, 64), (2, 8, 600, 64))
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
    # single-clip sharding (phase 11): kernel 1 at the local queries of a
    # height split against the gathered keys (4 ranks: level 0; 2 ranks:
    # levels 0 and 1; 576x1024 at 4 ranks: levels 0 and 1), kernel 1b at
    # the CFCA's gathered centre + own keys; each row refuses log2 e left
    # out of its scale.  Counted on the sharded edits: every exact kernel-1
    # launch (at world 1 no key is gathered)
    dict(name="spatial_attention_gathered", kernel="spatial", path="clip_shard_tv2v",
         fault="log2e", source="ccedit_tpu_torch/csrc/spatial_attention.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:113",
         shapes=(((34, 8, 1536, 40), 6144, 1), ((34, 8, 3072, 40), 6144, 1),
                 ((34, 8, 768, 80), 1536, 34), ((34, 8, 2304, 40), 9216, 1),
                 ((34, 8, 576, 80), 2304, 34)),
         count=lambda st: _variant_sum(st, "d", "n_k")),
    dict(name="spatial_attention_1b_gathered", kernel="spatial", path="clip_shard_tvi2v",
         fault="log2e", source="ccedit_tpu_torch/csrc/spatial_attention.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:93",
         shapes=(((34, 8, 1536, 40), 12288, 1), ((34, 8, 3072, 40), 12288, 1),
                 ((34, 8, 768, 80), 3072, 34)),
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
    # head_dim 64, SD-2.1-768's heads: kernel 1 at its three levels (CFG
    # 2 x 5, 10, 20 heads of 9216, 2304, 576 tokens), kernel 1c and its
    # pre-pass at the two whose n_q is a multiple of 128 (the JAX gate's),
    # kernel 4 at all three levels and a ragged shape; each row also refuses its
    # planted fault (kernel 1: log2 e left out of its scale; kernel 1c and
    # the pre-pass: the dequant factor left out of the folded scales;
    # kernel 4: delta left out, DELTA_FAULT_SHAPES)
    dict(name="spatial_attention_d64", kernel="spatial", path="txt2img", fault="log2e",
         source="ccedit_tpu_torch/csrc/spatial_attention.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:113",
         shapes=(((2, 5, 9216, 64), 9216, 2), ((2, 10, 2304, 64), 2304, 2),
                 ((2, 20, 576, 64), 576, 2)),
         count=lambda st: _variant_sum(st, "d64", "n_k=n_q")),
    dict(name="spatial_attention_1c_d64", kernel="spatial_int8", path="txt2img_int8",
         fault="dequant", source="ccedit_tpu_torch/csrc/spatial_attention_int8.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:202",
         shapes=(((2, 5, 9216, 64), 9216, 2), ((2, 10, 2304, 64), 2304, 2)),
         count=lambda st: _variant_sum(st, "int8 d64", "n_k")),
    dict(name="quantize_qk_d64", kernel="prepass", path="txt2img_int8", fault="dequant",
         source="ccedit_tpu_torch/csrc/quantize_qk.cu",
         replaces="ccedit_tpu/ops/spatial_attention.py:191",
         shapes=(((2, 5, 9216, 64), 9216, 2), ((2, 10, 2304, 64), 2304, 2)),
         count=lambda st: sum(c.get("quantize_qk", 0) for c in st.values())),
    dict(name="spatial_attention_bwd_d64", kernel="spatial_bwd", path="txt2img_train",
         source="ccedit_tpu_torch/csrc/spatial_attention_bwd.cu",
         replaces="ccedit_tpu/ops/attention.py:173",
         shapes=(((2, 10, 2304, 64), 2304, 2), ((2, 5, 9216, 64), 9216, 1),
                 ((2, 20, 576, 64), 576, 2), ((2, 8, 600, 64), 600, 2)),
         count=lambda st: sum(c.get("spatial_attention_bwd[d64 n_k=n_q]", 0)
                              for c in st.values())),
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
    "txt2img": ("spatial_attention_d64", "flash_attention"),
    "img2img": ("spatial_attention_d64", "flash_attention", "flash_attention_encoder"),
    "txt2img_int8": ("spatial_attention_d64", "spatial_attention_1c_d64", "quantize_qk_d64",
                     "flash_attention"),
    "txt2img_train": ("spatial_attention_d64", "spatial_attention_bwd_d64"),
    "demo": ("spatial_attention_d64",),
    "auto_pipeline": ("spatial_attention", "spatial_attention_1b", "temporal_attention",
                      "flash_attention_encoder"),
    "clip_shard_tv2v": ("spatial_attention_gathered", "temporal_attention", "flash_attention"),
    "clip_shard_tvi2v": ("spatial_attention_gathered", "spatial_attention_1b_gathered",
                         "temporal_attention", "flash_attention", "flash_attention_encoder"),
    "clip_shard_tv2v_pad": ("spatial_attention_gathered", "temporal_attention",
                            "flash_attention"),
    "clip_shard_blend": ("spatial_attention", "temporal_attention"),
    "clip_shard_interp": ("spatial_attention", "temporal_attention"),
    "clip_shard_raig": ("spatial_attention_gathered",),
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


def check_prepass(shape, n_k, gen, device, fault: str = "") -> dict:
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
    note = ""
    if fault == "dequant":  # the same check must refuse the scales without the dequant factor
        faulty = without_dequant(sa.prepass)(q, k, scale)
        same_fault = [torch.equal(a, b) for a, b in zip(faulty, want)]
        note = f"; with the dequant factor left out equal {same_fault}"
        if all(same_fault):
            raise RuntimeError(f"the pre-pass check at {shape} passes the dequant fault")
    print(f"[kernels] quantize_qk (pre-pass) q {shape} n_k {n_k}: {ms:.4f} ms (bound "
          f"{bound['bound_ms']:.4f} ms, {bound['bound_what']}); quantize_qk {quantize_ms:.4f} ms, "
          f"plain (quantize_qk + pad) {plain_ms:.4f} ms; q8/k8/scales bit-identical to the "
          f"plain version: {same} ({ties} ties in q's planted head), max_abs_err {err:.3e}"
          f"{note}", flush=True)
    if not all(same) or ties < 100:
        raise RuntimeError(f"the pre-pass at {shape} x {n_k} differs from quantize_qk: "
                           f"equal {same}, max_abs_err {err}, {ties} ties planted")
    return dict(shape=list(shape), n_k=n_k, compare_shape=list(shape), max_abs_err=err,
                max_rel_err=0.0, bit_identical=True, ties=ties, compared_ms=ms,
                plain_ms=plain_ms, quantize_qk_ms=quantize_ms, ms=ms, library_ms=None,
                library="none (no single PyTorch call quantizes per (batch, head))", **bound)


def planted_forward_fault(fault: str, q, k, v, scale):
    """A forward row's planted fault: "log2e", kernel 1 with log2 e left out
    of its exp2 scale (exp2(s * scale) for exp(s * scale)); "dequant",
    kernel 1c with the dequant factor left out of the folded scales
    (``without_dequant`` around the pre-pass its forward looks up)."""
    from ccedit_tpu_torch.ops import spatial_attention as sa

    if fault == "log2e":
        return sa._forward(q, k, v, scale / sa._LOG2E)
    prepass = sa.prepass
    sa.prepass = without_dequant(prepass)
    try:
        return sa.kv_resident_attention(q, k, v, scale, quantized_qk=True)
    finally:
        sa.prepass = prepass


CLIP_SHARD_FAULTS = ("halo", "local_norm", "kv_local", "pad_unmasked", "pad_counted",
                     "pad_amax", "blend_local", "interp_local")
# the faults that act only where a UNet level is padded (pad_amax only under W8A8)
PAD_FAULTS = ("pad_unmasked", "pad_counted", "pad_amax")
# the faults that act only in a frame-axis sample: blending's, the interpolation network's
SAMPLE_FAULTS = ("blend_local", "interp_local")


@contextlib.contextmanager
def clip_shard_fault(fault: str):
    """A planted fault of single-clip sharding, on ``ClipShard`` while the
    block runs: "halo", every convolution's halo rows left as zeros (no
    exchange); "local_norm", every image GroupNorm on this rank's own
    statistics (the all-reduce skipped, the sums scaled as if every rank
    held the same); "kv_local", k and v not gathered (each rank attends to
    its own tokens only).  At a padded level (``parallel/shard.py``):
    "pad_unmasked", the padding rows not zeroed before a convolution reads
    them; "pad_counted", the image GroupNorms counting the padding rows into
    their statistics; "pad_amax", under W8A8 the GroupNorm -> SiLU -> QConv
    chain fused at padded levels too, so that kernel 8's per-tensor amax
    reads the normalised padding.  Under a frame split: "blend_local", the
    blending hook on this rank's frames alone (no gather: at one frame a
    rank it moves none, at two it raises); "interp_local", the interpolation
    network's first- and last-frame controls added on every rank, at its
    local first and last frame."""
    import importlib

    import torch

    from ccedit_tpu_torch.modules import layers
    from ccedit_tpu_torch.parallel.shard import ClipShard

    samplers = importlib.import_module("ccedit_tpu_torch.diffusion.samplers")
    unet = importlib.import_module("ccedit_tpu_torch.modules.unet")

    def zero_halo(self, x, dim, before, after):
        rows = lambda n: x.narrow(dim, 0, n).mul(0.0)
        return torch.cat([rows(before), x, rows(after)], dim=dim)

    def local_stats(self, stats):
        return stats.mul_(self.world)

    def no_gather(self, x, segments=1):
        return x

    sound_affine = layers.GroupNorm.sharded_affine

    def counted(self, x, shard):
        padding = ClipShard.padding
        ClipShard.padding = lambda self, x: None
        try:
            return sound_affine(self, x, shard)
        finally:
            ClipShard.padding = padding

    owner, name, fn = {
        "halo": (ClipShard, "halo", zero_halo),
        "local_norm": (ClipShard, "all_reduce_stats", local_stats),
        "kv_local": (ClipShard, "gather_tokens", no_gather),
        "pad_unmasked": (ClipShard, "zero_padding", lambda self, x, pad=None: x),
        "pad_counted": (layers.GroupNorm, "sharded_affine", counted),
        "pad_amax": (layers, "padded", lambda x: False),
        "blend_local": (samplers, "active", lambda: None),
        "interp_local": (unet, "frame_index", lambda t, index: index % t)}[fault]
    saved = getattr(owner, name)
    setattr(owner, name, fn)
    try:
        yield
    finally:
        setattr(owner, name, saved)


W8A8_CLIP_FAULTS = ("own_amax", "amax_sum", "fused_local_norm", "int8_halo_zero")


@contextlib.contextmanager
def w8a8_clip_fault(fault: str):
    """A planted fault of W8A8 under a clip shard while the block runs:
    "own_amax", each rank quantizing with its own amax (the amax all-reduce
    skipped); "amax_sum", the ranks' amaxes summed where they should take
    their MAX (the same wrong scale on every rank); "fused_local_norm", kernel 8's fused form taking each rank's
    own GroupNorm statistics under a spatial split (its external statistics
    left out; the unfused chain still all-reduces them); "int8_halo_zero", a
    ``QConv``'s int8 halo rows left as zeros (no exchange)."""
    import torch

    from ccedit_tpu_torch.modules.layers import GroupNorm
    from ccedit_tpu_torch.ops import quant
    from ccedit_tpu_torch.parallel.shard import ClipShard

    if fault in ("own_amax", "amax_sum"):
        import torch.distributed as dist

        def summed(self, word):
            dist.all_reduce(word.view(torch.float32), op=dist.ReduceOp.SUM, group=self.group)
            return word

        saved = ClipShard.all_reduce_amax
        ClipShard.all_reduce_amax = (lambda self, word: word) if fault == "own_amax" else summed
        try:
            yield
        finally:
            ClipShard.all_reduce_amax = saved
    elif fault == "fused_local_norm":
        sound = quant.norm_silu_quantize

        def local(x, norm, add=None, faults=0):
            spans = GroupNorm.spans_shard
            GroupNorm.spans_shard = lambda self, x, shard: False
            try:
                return sound(x, norm, add, faults)
            finally:
                GroupNorm.spans_shard = spans

        quant.norm_silu_quantize = local
        try:
            yield
        finally:
            quant.norm_silu_quantize = sound
    else:
        halo = ClipShard.halo

        def zero_int8_rows(self, x, dim, before, after):
            if x.dtype != torch.int8:
                return halo(self, x, dim, before, after)
            rows = lambda n: torch.zeros_like(x.narrow(dim, 0, n))
            return torch.cat([rows(before), x, rows(after)], dim=dim)

        ClipShard.halo = zero_int8_rows
        try:
            yield
        finally:
            ClipShard.halo = halo


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
                per_shape.append(check_prepass(shape, n_k, gen, device, spec.get("fault", "")))
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
                if spec.get("fault"):  # the same comparison must refuse the planted fault
                    bad = planted_forward_fault(spec["fault"], qs, ks, vs, scale)
                    f_rel = ((bad.float() - ref.float()).abs().max()
                             / ref.float().abs().max()).item()
                    f_cos = cosine(bad, ref)
                    extra["fault_rel"] = min(extra.get("fault_rel", math.inf), f_rel)
                    extra["fault_cosine"] = max(extra.get("fault_cosine", -1.0), f_cos)
                    if f_rel <= TOLERANCE and f_cos >= COSINE:
                        raise RuntimeError(f"{name} at {shape}: the check passes the planted "
                                           f"fault {spec['fault']} (relative {f_rel}, cosine "
                                           f"{f_cos})")
                    del bad
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
            if spec.get("fault"):
                note += (f"; planted fault {spec['fault']}: relative {extra['fault_rel']:.3e}, "
                         f"cosine {extra['fault_cosine']:.6f} (refused)")
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
    40) and holds each one's first rows to ``plain_probe``, ``run_d64`` its
    three plain-layout variants at head_dim 64 at SD-2.1-768's levels 0 and
    1, (10, 9216, 64) and (20, 2304, 64);
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
    splits64 = kr.run_d64(device, iters=5)
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
    per_variant = {}
    for split64 in splits64:
        shape = tuple(split64["shape"])
        print(f"[probes] kv_resident_attn.run_d64 {shape}: kernel 1 "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in split64["kernel1_ms"].items())
              + f" (SDPA {split64['library_ms']}); kernel 5's split "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in split64["kernel1_split_ms"].items())
              + f"; full plain bf16 / kernel 1 {split64['full_over_kernel1']:.4f}", flush=True)
        for r in split64["variants"]:
            print(f"[probes] kernel 5 {r['variant']} d64 {tuple(split64['probe_shape'])}: "
                  f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, {r['bound_what']}; "
                  f"{r['library']} {r['library_ms']} ms); on {r['plain_shape']}: max_abs_err "
                  f"{r['max_abs_err']:.3e}, relative {r['max_rel_err']:.3e}, cosine "
                  f"{r['cosine']:.7f}", flush=True)
            if not r["ok"]:
                raise RuntimeError(f"probe {r['variant']} d64 disagrees with its plain version: {r}")
            per_variant.setdefault(r["variant"], []).append(dict(
                shape=split64["probe_shape"], compare_shape=r["plain_shape"], **r))
    for key in kr.D64_VARIANTS:
        name = kr.variant_name(*key)
        records.append(record(dict(name=f"attention_probe[{name} d64]",
                                   source="ccedit_tpu_torch/csrc/attention_probe.cu",
                                   replaces="scripts/kv_resident_attn.py" + kr.REPLACES[key]),
                              per_variant[name]))
    log2e = kr._LOG2E
    kr._LOG2E = 1.0  # the planted fault
    try:
        cases = [(key, kr.inputs(device, b=kr.COMPARE_ROWS)) for key in kr.VARIANTS]
        cases += [(key, kr.inputs(device, b=kr.COMPARE_ROWS, n=kr.D64_SHAPES[1][2], d=kr.D64))
                  for key in kr.D64_VARIANTS]
        for key, x in cases:
            if key[0] == "qkt":  # reads no scale
                continue
            args = kr.call_args(x, *key)
            label = kr.variant_name(*key) + ("" if x["q"].shape[-1] == kr.D else " d64")
            fault = kr.compare(key[0], kr.probe(key[0], *args), kr.plain_probe(key[0], *args))
            print(f"[probes] kernel 5 {label} without log2 e in its scale: "
                  f"relative {fault['max_rel_err']:.3e}, cosine {fault['cosine']:.7f}", flush=True)
            if fault["ok"]:
                raise RuntimeError(f"the probe check passes {label} with its softmax "
                                   f"temperature off by ln 2: {fault}")
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
    out.update(run_w8a8_edits(path, edit, exact, launches, device, steps, seed))
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


# ---------------------------------------------------------------------------
# phase 10: image sampling and the secondary entry points
# ---------------------------------------------------------------------------

IMAGE_DIR = "build/chip_smoke_image"
IMAGE_SIZE = 768  # SD-2.1-768's images
# kernel 1 launches a network row at head_dim 64 (SD-2.1-768 at 768x768):
# 5 spatial self-attentions a level (input blocks 1, 2; output blocks 9-11
# at level 0, likewise at levels 1 and 2), 10 of them at a multiple of 128
# tokens (9216, 2304), 5 at 576; the middle block's 144 tokens stay plain
D64_PER_ROW, D64_ALIGNED_PER_ROW = 15, 10
# the d = 64 gradient check: the UNet's attn1 q/k projections through kernels
# 1 and 4 at (2, 64, 64, 4) latents (4096 and 1024 tokens) against plain
# attention, GRAD_TOLERANCE; kernel 4's dq and dk zeroed must exceed it
GRAD_D64_LATENT = 64
# phase 10 (d): InceptionV3's 2048-d features in bf16 against fp32 by cosine
INCEPTION_COSINE = 0.999
INCEPTION_IMAGES = 32  # images a set for FID
# phase 10 (e): the safety filter's images and the one its planted head flags
SAFETY_IMAGES, SAFETY_FLAGGED = 4, 1


def image_args(args, **changes):
    """A copy of ``sampling_image`` arguments with ``changes``."""
    import argparse

    out = argparse.Namespace(**vars(args))
    for k, v in changes.items():
        setattr(out, k, v)
    return out


def image_counted(session, args, label: str, rows_of):
    """One ``sample_images`` call with the launch counts reset just before it
    and read, per stage, just after; the final latents captured from the
    engine's ``sample``.  Returns (uint8 image, latents, per-stage counts,
    network rows)."""
    import torch

    from ccedit_tpu_torch.cli.sampling_image import sample_images
    from ccedit_tpu_torch.ops import attention as att

    engine = session.engine
    captured, sample = [], engine.sample
    engine.sample = lambda *a, **k: captured.append(sample(*a, **k)) or captured[-1]
    stages, launches = {}, {}
    rows0 = rows_of()
    reset_launches()
    t0 = time.perf_counter()
    try:
        image = sample_images(session, args, stage_seconds=stages, stage_launches=launches)[0]
    finally:
        engine.sample = sample
    total = time.perf_counter() - t0
    counts = att.launch_counts()
    summed = {k: sum(c.get(k, 0) for c in launches.values()) for k in counts}
    if summed != counts:
        raise RuntimeError(f"per-stage launch counts {summed} do not add up to {counts}")
    rows = rows_of() - rows0
    print(f"[{label}] {args.H}x{args.W}, {args.sample_steps} steps, {rows} network rows: "
          f"{total:.2f} s; stages " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
          + f"; image mean {image.mean():.2f}, std {image.std():.2f}", flush=True)
    print(f"[{label}] kernel launches by stage {json.dumps(launches)}", flush=True)
    if image.dtype.name != "uint8" or image.shape != (args.H, args.W, 3):
        raise RuntimeError(f"{label}: sample_images returned {image.dtype} {image.shape}")
    if not bool(torch.isfinite(captured[-1]).all()):
        raise FloatingPointError(f"{label}: the final latents are not finite")
    return image, captured[-1], launches, rows


def stage_sum(launches, key: str) -> int:
    return sum(c.get(key, 0) for c in launches.values())


def check_d64_grads(engine, device, seed: int) -> dict:
    """Kernel 4 at head_dim 64 on SD-2.1's UNet: the gradients of its attn1
    q and k projections through kernels 1 and 4 at (2, 64, 64, 4) latents
    against plain attention, refusing kernel 4 with dq and dk zeroed.
    Returns the launch counts of the run through the kernels."""
    import torch

    from ccedit_tpu_torch.ops import spatial_attention as sa

    net = engine.network
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    s = GRAD_D64_LATENT
    x = torch.randn((2, s, s, 4), generator=gen, device=device).to(torch.bfloat16)
    ts = torch.tensor([500, 300], device=device)
    cond = {"crossattn": torch.randn((2, 77, 1024), generator=gen, device=device)
            .to(torch.bfloat16)}
    params = {n: p for n, p in net.named_parameters()
              if n.endswith(("attn1.to_q.weight", "attn1.to_k.weight"))}
    flags = {n: p.requires_grad for n, p in net.named_parameters()}
    for n, p in net.named_parameters():
        p.requires_grad_(n in params)
    try:
        g_k, g_p, g_f, counts = grads_three_ways(
            params, lambda: net(x, ts, cond).float().square().mean().backward(),
            sa.SpatialAttention)
    finally:
        for n, p in net.named_parameters():
            p.requires_grad_(flags[n])
    err, fault = grad_errors(g_k, g_p), grad_errors(g_f["dq = dk = 0"], g_p)
    print(f"[txt2img_train] attn1 q/k gradients of {len(params)} tensors at (2, {s}, {s}, 4) "
          f"through kernels 1 + 4 vs plain attention: worst tensor {err['worst_leaf']:.3e} "
          f"({err['worst_leaf_name']}), whole {err['whole']:.3e} (tol {GRAD_TOLERANCE:.0e}); "
          f"with dq = dk = 0 worst {fault['worst_leaf']:.3e}; launches {json.dumps(counts)}",
          flush=True)
    if not err["worst_leaf"] <= GRAD_TOLERANCE:
        raise RuntimeError(f"the d = 64 gradients through kernel 4 disagree: {err}")
    if not fault["worst_leaf"] > GRAD_TOLERANCE:
        raise RuntimeError(f"the d = 64 gradient check passes kernel 4 without dq, dk: {fault}")
    return counts


def run_txt2img(device, seed: int) -> tuple:
    """Phase 10 (a): SD-2.1-768 at full width.  Returns (session, args,
    by_path, the txt2img image)."""
    import pathlib

    import numpy as np
    import torch

    from ccedit_tpu_torch.cli.profile_tv2v import build_txt2img, count_rows
    from ccedit_tpu_torch.data.video import write_png
    from ccedit_tpu_torch.ops import attention as att
    from ccedit_tpu_torch.ops import spatial_attention as sa

    t0 = time.perf_counter()
    vocab = pathlib.Path("build") / "chip_smoke_conditioning"  # phase 9's synthetic BPE files
    session, args = build_txt2img(device, seed, STEPS, IMAGE_SIZE,
                                  ["--tokenizer_assets", str(vocab)])
    engine = session.engine
    n = {k: sum(p.numel() for p in m.parameters()) for k, m in
         (("network", engine.network), ("vae", engine.vae), ("conditioner", engine.conditioner))}
    print(f"[txt2img] SD-2.1-768 built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v / 1e6:.1f} M" for k, v in n.items())
          + f" parameters, bf16, tokenizer {type(engine.conditioner.embedders[0].tokenizer).__name__}",
          flush=True)

    # the network through the kernels against plain attention at 768x768
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    f = IMAGE_SIZE // 8
    x = torch.randn((2, f, f, 4), generator=gen, device=device).to(torch.bfloat16)
    ts = torch.tensor([700, 700], device=device)
    cond = {"crossattn": torch.randn((2, 77, 1024), generator=gen, device=device)
            .to(torch.bfloat16)}
    res = held_to_plain(lambda: engine.network(x, ts, cond),
                        faults=(("spatial halves swapped", halves_swapped("spatial")),))
    counts = check_held(f"txt2img network at (2, {f}, {f}, 4)", res,
                        {"spatial_attention[d64 n_k=n_q]": D64_PER_ROW})
    by_path = {"txt2img_network": {"forward": counts}}
    del x, cond

    rows, hook = count_rows(engine.network)
    try:
        image, exact, by_path["txt2img"], n_rows = image_counted(session, args, "txt2img", rows)
        d64 = stage_sum(by_path["txt2img"], "spatial_attention[d64 n_k=n_q]")
        k3 = stage_sum(by_path["txt2img"], "flash_attention")
        if d64 != D64_PER_ROW * n_rows or k3 != 1:
            raise RuntimeError(f"txt2img launched kernel 1 at d = 64 {d64} times (want "
                               f"{D64_PER_ROW} x {n_rows} rows) and kernel 3 {k3} (want 1)")
        out_dir = pathlib.Path(IMAGE_DIR)
        out_dir.mkdir(parents=True, exist_ok=True)
        write_png(str(out_dir / "txt2img.png"), image)

        img2img = image_args(args, init_image=str(out_dir / "txt2img.png"),
                             img2img_strength=0.75)
        _, _, by_path["img2img"], rows_i = image_counted(session, img2img, "img2img", rows)
        k3 = stage_sum(by_path["img2img"], "flash_attention")
        if k3 != 2 or by_path["img2img"].get("encode", {}).get("flash_attention", 0) != 1:
            raise RuntimeError(f"img2img launched kernel 3 {k3} times (want the encoder's and "
                               "the decoder's)")

        prepass = sa.prepass
        try:
            att.set_quantized_qk(True)
            _, quant, by_path["txt2img_int8"], rows_q = image_counted(
                session, args, "txt2img_int8", rows)
            sa.prepass = without_dequant(prepass)
            _, fault, _, _ = image_counted(session, args, "txt2img_int8 fault", rows)
        finally:
            sa.prepass = prepass
            att.set_quantized_qk(False)
    finally:
        hook.remove()
    int8 = stage_sum(by_path["txt2img_int8"], "spatial_attention[int8 d64 n_k=n_q]")
    left = stage_sum(by_path["txt2img_int8"], "spatial_attention[d64 n_k=n_q]")
    if int8 != D64_ALIGNED_PER_ROW * rows_q or left != (D64_PER_ROW - D64_ALIGNED_PER_ROW) * rows_q:
        raise RuntimeError(f"the quantized image launched kernel 1c {int8} times and exact "
                           f"kernel 1 {left} (want {D64_ALIGNED_PER_ROW} and "
                           f"{D64_PER_ROW - D64_ALIGNED_PER_ROW} a row, {rows_q} rows)")
    cos_q, cos_f = cosine(quant, exact), cosine(fault, exact)
    print(f"[txt2img_int8] final latents vs the exact image's: cosine {cos_q:.6f}, with the "
          f"dequant factor left out {cos_f:.6f} (limit {LATENT_COSINE})", flush=True)
    if not cos_q >= LATENT_COSINE or not cos_f < LATENT_COSINE:
        raise RuntimeError(f"the quantized image's latent check: {cos_q} sound, {cos_f} with "
                           "the fault")
    by_path["txt2img_train"] = {"backward": check_d64_grads(engine, device, seed)}
    print(f"[txt2img] (a) in {time.perf_counter() - t0:.1f} s", flush=True)
    return session, args, by_path, np.ascontiguousarray(image)


def post(url: str, body: bytes, content_type: str) -> str:
    import urllib.request

    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise RuntimeError(f"POST {url}: HTTP {resp.status}")
        return resp.read().decode()


def page_images(page: str) -> list:
    """The base64 PNGs of a demo page, decoded by the port's reader."""
    import base64
    import re

    from ccedit_tpu_torch.data.video import read_png

    return [read_png(base64.b64decode(b))
            for b in re.findall(r"data:image/png;base64,([A-Za-z0-9+/=]+)", page)]


def run_demo(session, args, image) -> dict:
    """Phase 10 (b): the demo served on 127.0.0.1:0 in a thread, its model
    session the one of (a); a url-encoded txt2img POST and a multipart
    img2img POST, each answered with a decodable PNG."""
    import threading
    import urllib.parse

    from ccedit_tpu_torch.cli import demo
    from ccedit_tpu_torch.data.video import png_bytes
    from ccedit_tpu_torch.ops import attention as att

    t0 = time.perf_counter()
    base = image_args(args, save_path=f"{IMAGE_DIR}/demo")
    state = demo.DemoState(base, {"sd21_768": {"config": "sd21_768", "ckpt": ""}})
    state.sessions["sd21_768"] = session  # warm: the model of (a)
    server = demo.serve(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    fields = {"prompt": "a red fox in the snow", "seed": "3", "H": str(IMAGE_SIZE),
              "W": str(IMAGE_SIZE), "sample_steps": str(STEPS), "cfg_scale": "7.5",
              "num_samples": "1", "sampler_name": "EulerEDMSampler"}
    reset_launches()
    try:
        pages = [post(url, urllib.parse.urlencode(fields).encode(),
                      "application/x-www-form-urlencoded")]
        boundary = "----ccedit-chip-smoke"
        parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
                 .encode() for k, v in dict(fields, img2img_strength="0.5").items()]
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="init_image"; '
                     f'filename="init.png"\r\nContent-Type: image/png\r\n\r\n'.encode()
                     + png_bytes(image) + b"\r\n")
        pages.append(post(url, b"".join(parts) + f"--{boundary}--\r\n".encode(),
                          f"multipart/form-data; boundary={boundary}"))
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    counts = att.launch_counts()
    for label, page in zip(("txt2img", "img2img"), pages):
        images = page_images(page)
        if len(images) != 1 or images[0].shape != (IMAGE_SIZE, IMAGE_SIZE, 3):
            raise RuntimeError(f"the demo's {label} page holds {[i.shape for i in images]}")
        print(f"[demo] {label} POST: one {images[0].shape} PNG, mean {images[0].mean():.2f}",
              flush=True)
    print(f"[demo] (b) in {time.perf_counter() - t0:.1f} s; launches {json.dumps(counts)}",
          flush=True)
    return {"demo": {"requests": counts}}


def run_auto_pipeline(device) -> dict:
    """Phase 10 (c): ``auto_pipeline`` on the bear clip's frames at 512x768
    (8 keyframes, 3 steps a stage, the TVI2V config with seeded random
    weights, bf16): the centre frame, its img2img edit and the TVI2V video,
    each step's kernel launches counted."""
    import pathlib

    from ccedit_tpu_torch.assets import BEAR_FRAMES
    from ccedit_tpu_torch.cli import auto_pipeline, extract_centerframe, sampling_image
    from ccedit_tpu_torch.cli import sampling_tv2v_ref
    from ccedit_tpu_torch.data.video import read_png
    from ccedit_tpu_torch.ops import attention as att

    t0 = time.perf_counter()
    save = pathlib.Path(IMAGE_DIR) / "auto"
    stages, mains = {}, {}
    for label, module in (("centerframe", extract_centerframe), ("frame_edit", sampling_image),
                          ("tvi2v", sampling_tv2v_ref)):
        mains[module] = module.main

        def counted(argv, _main=module.main, _label=label):
            reset_launches()
            t1 = time.perf_counter()
            try:
                return _main(argv)
            finally:
                stages[_label] = att.launch_counts()
                print(f"[auto_pipeline] {_label} in {time.perf_counter() - t1:.1f} s", flush=True)

        module.main = counted
    try:
        out = auto_pipeline.main([
            "--video_path", str(BEAR_FRAMES), "--prompt", "a robot bear walking through the snow",
            "--config_path", "tvi2v", "--save_path", str(save), "--H", str(H), "--W", str(W),
            "--original_fps", "3", "--target_fps", "3", "--num_keyframes", "8",
            "--sample_steps", str(STEPS), "--cfg_scale", "7", "--bf16", "--device", str(device),
            "--save_type", "gif"])
    finally:
        for module, main_fn in mains.items():
            module.main = main_fn
    centre, edited = read_png(out["centerframe"]), read_png(out["edited_frame"])
    videos = sorted(p.name for p in out["tvi2v"].iterdir())
    tv = stages["tvi2v"]
    print(f"[auto_pipeline] centre frame {centre.shape}, edited frame {edited.shape}, "
          f"{out['tvi2v']}: {videos}; TVI2V launches {json.dumps(tv)}", flush=True)
    if centre.shape != (H, W, 3) or edited.shape != (H, W, 3) or \
            "bear_original_00.gif" not in videos:
        raise RuntimeError(f"auto_pipeline wrote {centre.shape}, {edited.shape}, {videos}")
    want = ("spatial_attention[d40 n_k=n_q]", "spatial_attention[d40 n_k!=n_q]",
            "temporal_attention")
    if any(tv.get(k, 0) <= 0 for k in want) or tv.get("flash_attention", 0) < 2:
        raise RuntimeError(f"the TVI2V stage missed a kernel (1, 1b, 2, or 3 in the encoder "
                           f"and the decoder): {tv}")
    print(f"[auto_pipeline] (c) in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"auto_pipeline": stages}


def run_inception(device, seed: int) -> None:
    """Phase 10 (d): InceptionV3 at full width with seeded random weights:
    the 2048-d features of a batch in bf16 against fp32 by cosine; FID of a
    set of images against itself near 0, against the set brightened
    larger."""
    import numpy as np
    import torch

    from ccedit_tpu_torch.modules.inception import randomize_inception_
    from ccedit_tpu_torch.utils import fid

    t0 = time.perf_counter()
    model = fid.fid_inception(device)
    randomize_inception_(model, torch.Generator(device=device).manual_seed(seed))
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:IMAGE_SIZE // 2, 0:IMAGE_SIZE // 2] / (IMAGE_SIZE // 2)
    base = [np.clip(np.stack([np.sin(6 * xx * (1 + i % 5) + i), np.cos(5 * yy + i),
                              xx * yy], -1) * 0.5 + 0.5 + rs.normal(0, 0.05, xx.shape + (3,)),
                    0, 1).astype(np.float32) for i in range(INCEPTION_IMAGES)]
    x = torch.from_numpy(np.stack(base[:8])).to(device)
    with torch.no_grad():
        f32 = model(x)[-1].float()
        f16 = model.to(torch.bfloat16)(x)[-1].float()
    model.float()
    cos = cosine(f16, f32)
    feats = fid.activations(model, base, batch_size=16)
    shifted = fid.activations(model, [np.clip(b + 0.25, 0, 1) for b in base], batch_size=16)
    stats = fid.statistics(feats)
    self_fid = fid.frechet_distance(*stats, *stats)
    shift_fid = fid.frechet_distance(*stats, *fid.statistics(shifted))
    print(f"[inception] features {tuple(f32.shape)} bf16 vs fp32 cosine {cos:.6f} (limit "
          f"{INCEPTION_COSINE}); FID of {INCEPTION_IMAGES} images against themselves "
          f"{self_fid:.4e}, against the brightened set {shift_fid:.4e}; "
          f"(d) in {time.perf_counter() - t0:.1f} s", flush=True)
    if not cos >= INCEPTION_COSINE or not abs(self_fid) < 1e-3 * shift_fid:
        raise RuntimeError(f"InceptionV3/FID check: cosine {cos}, FID self {self_fid}, "
                           f"shifted {shift_fid}")
    del model
    torch.cuda.empty_cache()


def run_safety(device, seed: int, image) -> None:
    """Phase 10 (e): the DeepFloyd filter with a seeded random CLIP ViT-L/14
    and a planted p head (``.npz``, read by ``from_files``) that flags
    exactly image SAFETY_FLAGGED: only that one may come back blurred; then
    the watermark's round trip through a PNG."""
    import pathlib

    import numpy as np
    import torch

    from ccedit_tpu_torch.cli.detect_watermark import detect
    from ccedit_tpu_torch.data.video import write_png
    from ccedit_tpu_torch.io.checkpoint import randomize_weights_
    from ccedit_tpu_torch.utils import safety, watermark

    t0 = time.perf_counter()
    with torch.device(device):
        clip = safety.clip_vit_l14()
    randomize_weights_(clip, torch.Generator(device=device).manual_seed(seed)).eval()
    base = torch.from_numpy(image).to(device).float() / 255.0
    imgs = torch.stack([base.roll(97 * i, dims=1) if i % 2 else base.flip(0).roll(31 * i, 0)
                        for i in range(SAFETY_IMAGES)])
    with torch.no_grad():
        feats = clip(safety.clip_process_images(imgs)).float().cpu().numpy().astype(np.float16)
    target = -np.ones(SAFETY_IMAGES)
    target[SAFETY_FLAGGED] = 4.0  # logits: the flagged image's far above 0, the rest below
    weights = np.linalg.lstsq(feats.astype(np.float64), target, rcond=None)[0]
    heads = pathlib.Path(IMAGE_DIR) / "safety"
    heads.mkdir(parents=True, exist_ok=True)
    np.savez(heads / "p_head_v1.npz", weights=weights[None].astype(np.float32),
             biases=np.zeros(1, np.float32))
    filt = safety.DeepFloydDataFiltering.from_files(p_head_path=str(heads / "p_head_v1.npz"))
    filt.model = clip
    with torch.no_grad():
        out = filt(imgs)
    changed = [not torch.equal(out[i], imgs[i]) for i in range(SAFETY_IMAGES)]
    blur = safety.gaussian_blur(imgs)[SAFETY_FLAGGED]
    print(f"[safety] CLIP ViT-L/14 {sum(p.numel() for p in clip.parameters()) / 1e6:.1f} M, "
          f"flags {filt.flags(imgs).tolist()}, changed {changed}; the flagged image equals "
          f"its blur: {torch.equal(out[SAFETY_FLAGGED], blur)}", flush=True)
    if changed != [i == SAFETY_FLAGGED for i in range(SAFETY_IMAGES)] or \
            not torch.equal(out[SAFETY_FLAGGED], blur):
        raise RuntimeError(f"the safety filter changed {changed}")
    marked = watermark.WatermarkEmbedder()(imgs[:1].cpu().numpy())
    write_png(str(heads / "marked.png"), np.round(marked[0] * 255).astype(np.uint8))
    write_png(str(heads / "clean.png"), image)
    bits_ok = watermark.decode_lsb(marked) == watermark.WATERMARK_BITS
    found, clean = detect(str(heads / "marked.png")), detect(str(heads / "clean.png"))
    print(f"[safety] watermark bits read back {bits_ok}; detect: marked {found}, clean {clean}; "
          f"(e) in {time.perf_counter() - t0:.1f} s", flush=True)
    if not bits_ok or not found or clean:
        raise RuntimeError("the watermark's round trip failed")
    del clip, filt
    torch.cuda.empty_cache()


def run_toy_train(device) -> None:
    """Phase 10 (f): three ``cli.train`` steps of ``TOY_MNIST_CONFIG`` on the
    card (pixel space, the synthetic MNIST set, batch 512 of 28x28x1, bf16
    autocast).  Its one attention (the middle block's, 49 tokens) is plain:
    this part runs no kernel."""
    import math as _math

    from ccedit_tpu_torch.cli import train

    t0 = time.perf_counter()
    _, result = train.main(["-b", "toy_mnist", "--max_steps", "3", "--device", str(device),
                            "--bf16", "-l", f"{IMAGE_DIR}/toy_logs", "--log_every", "1",
                            "--ckpt_every", "1000", "--seed", "0"])
    losses = [float(x) for x in result.losses]
    print(f"[toy_train] TOY_MNIST_CONFIG: {result.step} steps, losses {losses}; (f) in "
          f"{time.perf_counter() - t0:.1f} s (no kernel on this path)", flush=True)
    if result.step != 3 or not all(_math.isfinite(x) for x in losses):
        raise RuntimeError(f"toy training ended at step {result.step}, losses {losses}")


def run_image(device, seed: int) -> dict:
    """Phase 10: (a) SD-2.1-768 txt2img, img2img and int8, with the d = 64
    gradient check; (b) the demo; (c) the auto pipeline; (d) InceptionV3 and
    FID; (e) the safety filter and the watermark; (f) toy training.
    Returns the per-stage launch counts, as paths."""
    import torch

    t0 = time.perf_counter()
    print(f"[image] {torch.cuda.memory_allocated(device) / 1e9:.2f} GB allocated before the "
          "phase", flush=True)
    session, args, by_path, image = run_txt2img(device, seed)
    by_path.update(run_demo(session, args, image))
    del session
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(run_auto_pipeline(device))
    gc.collect()
    torch.cuda.empty_cache()
    run_inception(device, seed)
    run_safety(device, seed, image)
    run_toy_train(device)
    print(f"[image] phase 10 in {time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


CLIP_DIR = "build/chip_smoke_clip"  # phase 11's result file
CLIP_FRAME_T = 16  # frames of the frame-axis row: 16 divides 1, 2 and 4 ranks
CLIP_COSINE = 0.999  # a sharded network row against the one-GPU row
# padded UNet levels: 576x1024's level 3 has 9 rows (padded at 2 and 4
# ranks; level 2's 18 at 4); 16x320x576's level 3 folds to 2 x 5 x 9 = 90
# temporal rows (padded at 4 ranks)
CLIP_PAD = (576, 1024)
CLIP_FRAME_PAD = (16, 320, 576)
CLIP_BLEND_T = 4  # blending moves frame 3 onto frames 0 and 1: across ranks
CLIP_RAIG = 512  # RAIG's images, split on their rows
# a split W8A8 row or edit against one GPU's exact one: at most this many
# times as far (1 - cosine, and max|err|/max|ref|) as one GPU's W8A8 one.
# The split W8A8 row is not held to one GPU's W8A8 row itself: the split's
# GroupNorm statistics, summed in another order, move the one-GPU W8A8 row
# alone by max|err|/max|ref| 0.114, cosine 0.99028 and 4.3 % at some site's
# scale (``scripts/group_norm_route.py --rows`` on an H100), as far as W8A8
# is from exact (0.120, 0.99199): int8 codes flip behind the one-ulp
# differences and the flips cascade
W8A8_NOISE_FACTOR = 2.0


def clip_world() -> int:
    """Phase 11's ranks: one a card, at most four."""
    import torch

    return min(4, torch.cuda.device_count())


def clip_row(engine, device, t: int, seed: int, faults=(), h: int = H, w: int = W) -> dict:
    """One CFG-doubled network row at t x h x w (bf16, through the kernels,
    ``clip_inputs``), split over the ranks on ``pick_clip_axis``'s axis and
    gathered, against the same row on one GPU (rank 0): max|err| / max|ref|
    within ROUTE_TOLERANCE and cosine >= CLIP_COSINE, and on a spatial axis
    beyond one rank the row's k/v all-gathered (``parallel.shard.census``:
    its kv_all_gather records; its reblocks, where a UNet level is padded,
    are counted beside them), and where a level is padded its first padded
    site blind to what the padding holds (``padded_site_check``); each
    planted fault of ``clip_shard_fault`` in ``faults`` (two or more ranks)
    must fail one of those checks.  Rank 0 returns the numbers, the other
    ranks None."""
    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch.parallel.sampling import gather_clip, shard_clip_cond
    from ccedit_tpu_torch.parallel.shard import AXES, ClipShard, census, mesh_context

    rank, world = dist.get_rank(), dist.get_world_size()
    x, ts, cond, axis = clip_inputs(engine, device, t, seed, h, w)
    gathering = world > 1 and axis != 1  # the clip tokens' attentions gather k and v

    def sharded(padded_site=None):
        shard = ClipShard(axis, t, size=(h // 8, w // 8))
        xb = shard.block(x, axis).contiguous()
        cb = shard_clip_cond(cond, x.shape, axis, rank, world)
        keep = (first_padded_norm_site(padded_site) if padded_site is not None
                else contextlib.nullcontext())
        with mesh_context(shard), torch.no_grad(), census() as records, keep:
            y = engine.network(xb, ts, cb)
        kinds = [r["kind"] for r in records]
        reblocks = [r for r in records if r["kind"] == "reblock"]
        return (gather_clip(y, axis), kinds.count("kv_all_gather"),
                dict(count=len(reblocks), mb=sum(r["bytes"] for r in reblocks) / 1e6))

    def held(out, ref, gathers):
        rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        cos = cosine(out, ref)
        passes = rel <= ROUTE_TOLERANCE and cos >= CLIP_COSINE and (gathers > 0 or not gathering)
        return rel, cos, passes

    with torch.no_grad():
        ref = engine.network(x, ts, cond) if rank == 0 else None
    torch.cuda.synchronize()
    site = {}
    t0 = time.perf_counter()
    out, gathers, reblocks = sharded(site)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    blind = padded_site_check(site) if site else None  # a padded level's
    res = None
    if rank == 0:
        rel, cos, passes = held(out, ref, gathers)
        res = dict(frames=t, height=h, width=w, axis=AXES[axis], rel=rel, cosine=cos,
                   kv_all_gathers=gathers, reblocks=reblocks, seconds=seconds,
                   padded_site_blind_to_padding=blind)
        print(f"[clip_shard] row {t}x{h}x{w} on the {AXES[axis]} axis over {world} rank(s): "
              f"max|err|/max|ref| {rel:.3e} (tol {ROUTE_TOLERANCE:.0e}), cosine {cos:.6f} "
              f"(>= {CLIP_COSINE}), {gathers} k/v all-gathers, {reblocks['count']} reblocks "
              f"({reblocks['mb']:.3f} MB to rank 0), the padded site blind to its padding "
              f"{blind}, {seconds:.3f} s", flush=True)
        if not passes or blind is False:
            raise RuntimeError(f"the sharded row disagrees with the one-GPU row: {res}")
    for fault in faults:
        with clip_shard_fault(fault):
            bad, bad_gathers, _ = sharded()
        bad_blind = padded_site_check(site, fault) if site and fault in PAD_FAULTS else None
        if rank == 0:
            f_rel, f_cos, f_passes = held(bad, ref, bad_gathers)
            res[f"fault_{fault}"] = dict(rel=f_rel, cosine=f_cos, kv_all_gathers=bad_gathers,
                                         padded_site_blind_to_padding=bad_blind)
            print(f"[clip_shard] planted fault {fault}: max|err|/max|ref| {f_rel:.3e}, "
                  f"cosine {f_cos:.6f}, {bad_gathers} k/v all-gathers, the padded site blind "
                  f"to its padding {bad_blind} (refused)", flush=True)
            if f_passes and bad_blind is not False:
                raise RuntimeError(f"the sharded row check passes the planted fault {fault}")
        del bad
    del ref, out, site
    torch.cuda.empty_cache()
    return res


def clip_inputs(engine, device, t: int, seed: int, h: int = H, w: int = W):
    """Phase 11's CFG-doubled network row at t x h x w: (x, ts, cond,
    axis)."""
    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch.parallel.sampling import pick_clip_axis

    dtype = engine.network_dtype
    gen = torch.Generator(device=device).manual_seed(seed + t)
    x = torch.randn((2, t, h // 8, w // 8, 4), generator=gen, device=device).to(dtype)
    ts = torch.tensor([500.0, 500.0], device=device)
    cond = {"crossattn": (torch.randn((2, 77, 768), generator=gen, device=device)).to(dtype),
            "control_hint": (torch.rand((2, t, h, w, 3), generator=gen, device=device) * 2
                             - 1).to(dtype)}
    return x, ts, cond, pick_clip_axis(dist.get_world_size(), (1, t, h // 8, w // 8, 4))


@contextlib.contextmanager
def qconv_scales():
    """Record, while the block runs, the activation scale of every
    ``quant.qconv`` call in call order (``scales``, (1,) fp32 tensors: one a
    per-tensor quantization site of a forward), and how many sites came
    before the first GroupNorm whose statistics span the shard's ranks
    (``exact_sites``, None where none ran): up to there a split forward
    computes one GPU's values in the same order, so a MAX over the ranks
    gives one GPU's scale bit for bit."""
    from ccedit_tpu_torch.modules.layers import GroupNorm
    from ccedit_tpu_torch.ops import quant

    record = {"scales": [], "exact_sites": None}
    sound_qconv, sound_affine = quant.qconv, GroupNorm.sharded_affine

    def qconv(x, weight, bias, stride, padding):
        if not isinstance(x, quant.QuantizedActivation):  # as qconv quantizes it
            x = quant.quantize_activation(x)
        record["scales"].append(x.scale)
        return sound_qconv(x, weight, bias, stride, padding)

    def sharded_affine(self, x, shard):
        if record["exact_sites"] is None:
            record["exact_sites"] = len(record["scales"])
        return sound_affine(self, x, shard)

    quant.qconv, GroupNorm.sharded_affine = qconv, sharded_affine
    try:
        yield record
    finally:
        quant.qconv, GroupNorm.sharded_affine = sound_qconv, sound_affine


@contextlib.contextmanager
def first_spanning_norm_input(store: dict):
    """Keep the first input of kernel 8's fused form whose GroupNorm
    statistics span the shard's ranks (x, the norm, the addend) in
    ``store`` while the block runs."""
    from ccedit_tpu_torch.ops import quant
    from ccedit_tpu_torch.parallel.shard import active

    sound = quant.norm_silu_quantize

    def keeping(x, norm, add=None, faults=0):
        shard = active()
        if not store and shard is not None and norm.spans_shard(x, shard):
            store.update(x=x.clone(), norm=norm, add=None if add is None else add.clone(),
                         shard=shard)
        return sound(x, norm, add, faults)

    quant.norm_silu_quantize = keeping
    try:
        yield store
    finally:
        quant.norm_silu_quantize = sound


def external_norm_check(site: dict, fault: str = "") -> bool:
    """Kernel 8's external-statistics fused form on ``site`` (a real input
    of the split row) bit for bit its sharded plain chain (the sharded
    GroupNorm, SiLU, the per-tensor quantizer with the clip's amax) on every
    rank; with ``fault`` planted in the fused form.  Every rank returns the
    verdict over all ranks."""
    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch.ops import quant
    from ccedit_tpu_torch.parallel.shard import mesh_context

    x, norm, add = site["x"], site["norm"], site["add"]
    with mesh_context(site["shard"]), torch.no_grad():
        ref = quant.plain_norm_silu_quantize(x, norm, add)
        with w8a8_clip_fault(fault) if fault else contextlib.nullcontext():
            before = quant._NORM_SILU_QUANTIZE.variant_launches["external sharded"]
            got = quant.norm_silu_quantize(x, norm, add)
            took = quant._NORM_SILU_QUANTIZE.variant_launches["external sharded"] - before
    same = bool(torch.equal(got.q, ref.q) and torch.equal(got.scale, ref.scale))
    if not fault and x.is_cuda and took != 1:
        raise RuntimeError("the split row's spanning GroupNorm site did not take the "
                           "external-statistics form")
    verdicts = [None] * dist.get_world_size()
    dist.all_gather_object(verdicts, same)
    return all(verdicts)


@contextlib.contextmanager
def first_padded_norm_site(store: dict):
    """Keep the first GroupNorm -> SiLU -> conv chain (``norm_silu_conv``)
    whose image input has padding under the entered shard (the norm, the
    conv, x, the addend, the shard) in ``store`` while the block runs."""
    from ccedit_tpu_torch.modules import layers
    from ccedit_tpu_torch.parallel.shard import active

    sound = layers.norm_silu_conv

    def keeping(norm, conv, x, add=None):
        shard = active()
        if (not store and shard is not None and x.dim() == 4 and shard.spatial
                and shard.padding(x) is not None):
            store.update(norm=norm, conv=conv, x=x.clone(),
                         add=None if add is None else add.clone(), shard=shard)
        return sound(norm, conv, x, add)

    layers.norm_silu_conv = keeping
    try:
        yield store
    finally:
        layers.norm_silu_conv = sound


def padded_site_check(site: dict, fault: str = "") -> bool:
    """At a padded site of a split row (``first_padded_norm_site``: a
    GroupNorm whose statistics span the ranks, SiLU, a 3x3 conv with halos,
    under W8A8 its per-tensor amax), the chain run twice, on x as it came
    and on x with its padding rows set to 1e3: the padding must not reach a
    real row, so the real rows of the two outputs must be equal bit for bit
    on every rank; with ``fault`` planted.  Every rank returns the same
    answer."""
    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch.modules import layers
    from ccedit_tpu_torch.parallel.shard import mesh_context

    shard, x = site["shard"], site["x"]
    pad = shard.padding(x)
    probe = x.clone()
    probe.view(pad.lead + (-1,)).narrow(pad.dim, pad.valid, pad.block - pad.valid).fill_(1e3)
    outs = []
    planted = clip_shard_fault(fault) if fault else contextlib.nullcontext()
    with planted, mesh_context(shard), torch.no_grad():
        for v in (x, probe):
            y = layers.norm_silu_conv(site["norm"], site["conv"], v, site["add"])
            outs.append(shard.padding(y).real(y))
    same = torch.tensor([int(torch.equal(*outs))], device=x.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def clip_w8a8_row(engine, device, t: int, seed: int, faults=(), h: int = H,
                  w: int = W) -> dict:
    """Phase 11's W8A8 row (``CCEDIT_QUANT_MATMUL=1``): clip_row's inputs
    split over the ranks and gathered, against the same W8A8 row on one GPU
    (rank 0), each with the per-tensor scale of every ``qconv`` call
    (``qconv_scales``).  At world 1 the two must be equal bit for bit,
    scales too.  At two or more ranks: every site's scale equal on every
    rank; on a spatial axis the sites before the first GroupNorm whose
    statistics span the ranks (at least one) bit for bit one GPU's scales,
    and kernel 8's external-statistics form bit for bit its sharded plain
    chain at that GroupNorm's site (``external_norm_check``); and the split
    row as near one GPU's exact row as one GPU's W8A8 row is, within
    W8A8_NOISE_FACTOR (its distance to one GPU's W8A8 row, and each site's
    scale beside one GPU's, printed beside them).  Where a UNet level is
    padded, the first padded site's output must not see the padding
    (``padded_site_check``).  Each fault in ``faults`` must fail its check:
    own_amax and amax_sum the scales', fused_local_norm the external
    form's, int8_halo_zero the row's, pad_amax the padded site's.  Rank 0
    returns the numbers, the other ranks None."""
    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch.cli.profile_tv2v import int8_environment
    from ccedit_tpu_torch.ops import quant
    from ccedit_tpu_torch.parallel.sampling import gather_clip, shard_clip_cond
    from ccedit_tpu_torch.parallel.shard import AXES, ClipShard, mesh_context

    rank, world = dist.get_rank(), dist.get_world_size()
    x, ts, cond, axis = clip_inputs(engine, device, t, seed, h, w)

    def sharded(site=None, padded_site=None):
        shard = ClipShard(axis, t, size=(h // 8, w // 8))
        xb = shard.block(x, axis).contiguous()
        cb = shard_clip_cond(cond, x.shape, axis, rank, world)
        keep = first_spanning_norm_input(site) if site is not None else contextlib.nullcontext()
        keep_padded = (first_padded_norm_site(padded_site) if padded_site is not None
                       else contextlib.nullcontext())
        with mesh_context(shard), torch.no_grad(), qconv_scales() as record, keep, keep_padded:
            y = engine.network(xb, ts, cb)
        scales = torch.cat(record["scales"]).cpu().tolist()
        by_rank = [None] * world
        dist.all_gather_object(by_rank, scales)
        return gather_clip(y, axis), by_rank, record["exact_sites"]

    rel_of = lambda a, b: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def held(out, ref, exact, by_rank, ref_scales, exact_sites):
        same_scales = all(s == by_rank[0] for s in by_rank)
        exact_prefix = None  # one rank, or a frame split (its GroupNorms stay local)
        if world > 1 and axis != 1:  # the sites before the first spanning GroupNorm
            exact_prefix = (exact_sites is not None and exact_sites > 0
                            and by_rank[0][:exact_sites] == ref_scales[:exact_sites])
        scale_rel = max(abs(a - b) / b for a, b in zip(by_rank[0], ref_scales))
        first_off = next((i for i, (a, b) in enumerate(zip(by_rank[0], ref_scales))
                          if abs(a - b) > 1e-3 * b), None)
        noise = dict(rel=rel_of(ref, exact), distance=1 - cosine(ref, exact))
        to_exact = dict(rel=rel_of(out, exact), distance=1 - cosine(out, exact))
        return dict(rel=rel_of(out, ref), cosine=cosine(out, ref),
                    scales_equal_on_ranks=same_scales, scale_rel=scale_rel, sites=len(ref_scales),
                    first_site_off=first_off, exact_sites=exact_sites,
                    exact_sites_bit_for_bit=exact_prefix,
                    to_exact=to_exact, one_gpu_w8a8_to_exact=noise,
                    row_passes=all(to_exact[k] <= W8A8_NOISE_FACTOR * noise[k] for k in noise),
                    scales_pass=(same_scales and len(by_rank[0]) == len(ref_scales)
                                 and exact_prefix is not False))

    res = exact = None
    if rank == 0:
        with torch.no_grad():
            exact = engine.network(x, ts, cond)
    with int8_environment(CCEDIT_QUANT_MATMUL="1"):
        ref = ref_scales = None
        if rank == 0:
            with torch.no_grad(), qconv_scales() as record:
                ref = engine.network(x, ts, cond)
            ref_scales = torch.cat(record["scales"]).cpu().tolist()
        torch.cuda.synchronize()
        site, padded_site = {}, {}
        t0 = time.perf_counter()
        out, by_rank, exact_sites = sharded(site if world > 1 and axis != 1 else None,
                                            padded_site)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        external = external_norm_check(site) if site else None
        padded = padded_site_check(padded_site) if padded_site else None
        if rank == 0:
            res = dict(frames=t, height=h, width=w, axis=AXES[axis], seconds=seconds,
                       external_bit_for_bit=external, padded_site_blind_to_padding=padded,
                       **held(out, ref, exact, by_rank, ref_scales, exact_sites))
            if world == 1:
                res["bit_for_bit"] = bool(torch.equal(out, ref)) and by_rank[0] == ref_scales
            e, n = res["to_exact"], res["one_gpu_w8a8_to_exact"]
            print(f"[clip_shard] W8A8 row {t}x{h}x{w} on the {AXES[axis]} axis over {world} "
                  f"rank(s): to one GPU's exact row max|err|/max|ref| {e['rel']:.3e}, 1 - cosine "
                  f"{e['distance']:.3e} (one GPU's W8A8 row {n['rel']:.3e}, {n['distance']:.3e}; "
                  f"factor {W8A8_NOISE_FACTOR}); to one GPU's W8A8 row {res['rel']:.3e}, cosine "
                  f"{res['cosine']:.6f}; {res['sites']} per-tensor scales, equal on the ranks "
                  f"{res['scales_equal_on_ranks']}, largest difference to one GPU's "
                  f"{res['scale_rel']:.3e} (first above 1e-3 at site {res['first_site_off']}); "
                  f"the {res['exact_sites']} sites before the first spanning GroupNorm bit for "
                  f"bit one GPU's: {res['exact_sites_bit_for_bit']}; "
                  f"external-statistics form bit for bit its chain: {external}; the padded "
                  f"site blind to its padding: {padded}; bit for bit the one-GPU row: "
                  f"{res.get('bit_for_bit')}; {seconds:.3f} s", flush=True)
            if world == 1 and not res["bit_for_bit"]:
                raise RuntimeError("at world 1 the W8A8 row under mesh_context is not the "
                                   "one-GPU W8A8 row bit for bit")
            if (not (res["row_passes"] and res["scales_pass"]) or external is False
                    or padded is False):
                raise RuntimeError(f"the sharded W8A8 row disagrees with the one-GPU row: {res}")
        for fault in faults:
            planted = clip_shard_fault(fault) if fault in PAD_FAULTS else w8a8_clip_fault(fault)
            with planted:
                bad, bad_scales, _ = sharded()
            bad_external = external_norm_check(site, fault) if site and fault not in PAD_FAULTS \
                else None
            bad_padded = padded_site_check(padded_site, fault) if padded_site else None
            if rank == 0:  # the sites of the sound split row
                f = held(bad, ref, exact, bad_scales, ref_scales, exact_sites)
                f["external_bit_for_bit"] = bad_external
                f["padded_site_blind_to_padding"] = bad_padded
                res[f"fault_{fault}"] = f
                refused = {"own_amax": not f["scales_pass"],
                           "amax_sum": not f["scales_pass"],
                           "fused_local_norm": bad_external is False,
                           "int8_halo_zero": not f["row_passes"],
                           "pad_amax": bad_padded is False}[fault]
                print(f"[clip_shard] W8A8 planted fault {fault}: to one GPU's exact row "
                      f"max|err|/max|ref| {f['to_exact']['rel']:.3e}, 1 - cosine "
                      f"{f['to_exact']['distance']:.3e}; scales equal on the ranks "
                      f"{f['scales_equal_on_ranks']}, the first {exact_sites} one GPU's "
                      f"{f['exact_sites_bit_for_bit']}; external form bit for bit "
                      f"{bad_external}; the padded site blind to its padding "
                      f"{bad_padded}: refused by its check {refused}", flush=True)
                if not refused:
                    raise RuntimeError(f"the W8A8 row checks pass the planted fault {fault}")
            del bad
    del ref, exact, out, site, padded_site
    torch.cuda.empty_cache()
    return res


def clip_edit(path: str, edit, device, seed: int, exact=None, h: int = H,
              w: int = W) -> dict:
    """The 3-step edit (of a clip T x h x w) sampled split over the ranks
    (rank 0 decodes), then on one GPU (rank 0 alone) from the same generator
    seed: at world 1 the final latents must be equal bit for bit, else
    within LATENT_COSINE; or,
    with ``exact`` (a W8A8 edit: ``exact()`` gives one GPU's exact final
    latents), as near those as one GPU's edit is, within W8A8_NOISE_FACTOR
    in 1 - cosine (the cosine to one GPU's edit printed beside it).  Launch
    counts are reset just before the sharded edit and read, by stage, just
    after.  Rank 0 returns the numbers and its counts."""
    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch.ops import attention as att

    rank, world = dist.get_rank(), dist.get_world_size()
    edit(1, torch.Generator(device=device).manual_seed(seed))  # warm-up
    stages, launches = {}, {}
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    out, latents = edit(STEPS, torch.Generator(device=device).manual_seed(seed),
                        stage_seconds=stages, stage_launches=launches, return_latents=True)
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    per_rank = [None] * world
    dist.all_gather_object(per_rank, (launches, peak, total))
    res = None
    if rank == 0:
        print(f"[clip_shard] {path} edit {STEPS} steps over {world} rank(s): {total:.2f} s; "
              "stages " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
              + "; peak GB by rank " + ", ".join(f"{p[1]:.2f}" for p in per_rank), flush=True)
        for r, (counts, _, _) in enumerate(per_rank):
            print(f"[clip_shard] {path} rank {r} kernel launches by stage "
                  f"{json.dumps(counts)}", flush=True)
        if out is None or out.shape != (T, h, w, 3):
            raise RuntimeError(f"the sharded {path} edit returned no clip on rank 0")
        one, ref = edit(STEPS, torch.Generator(device=device).manual_seed(seed),
                        clip_shard=False, return_latents=True)
        same = torch.equal(latents, ref)
        cos = cosine(latents, ref)
        print(f"[clip_shard] {path} final latents vs the one-GPU edit's: cosine {cos:.6f} "
              f"(>= {LATENT_COSINE}), bit for bit {same}", flush=True)
        if not bool(torch.isfinite(latents).all()):
            raise FloatingPointError(f"the sharded {path} edit's latents are not finite")
        if world == 1 and not same:
            raise RuntimeError(f"at world 1 the sharded {path} sample is not engine.sample's")
        res = dict(seconds=total, stages=stages, cosine=cos, bit_for_bit=same,
                   peak_gb_by_rank=[p[1] for p in per_rank],
                   launches_by_rank=[p[0] for p in per_rank], launches=launches)
        if exact is None:
            if not cos >= LATENT_COSINE:
                raise RuntimeError(f"the sharded {path} edit left the one-GPU edit: cosine {cos}")
        else:
            ex = exact()
            res["distance_to_exact"] = 1 - cosine(latents, ex)
            res["one_gpu_distance_to_exact"] = 1 - cosine(ref, ex)
            print(f"[clip_shard] {path} final latents to one GPU's exact edit's: 1 - cosine "
                  f"{res['distance_to_exact']:.3e} (one GPU's {path} edit "
                  f"{res['one_gpu_distance_to_exact']:.3e}, factor {W8A8_NOISE_FACTOR})",
                  flush=True)
            if not res["distance_to_exact"] <= W8A8_NOISE_FACTOR * res["one_gpu_distance_to_exact"]:
                raise RuntimeError(f"the sharded {path} edit left one GPU's exact edit farther "
                                   f"than one GPU's {path} edit: {res}")
    dist.barrier()
    return res


def clip_sample(label: str, sharded, one, faults=()) -> dict:
    """A sample split over the ranks (``sharded()`` on every rank, the
    gathered latents) against the same sample on one GPU (``one()``, rank 0
    alone) from the same generator seed: at world 1 equal bit for bit, else
    final latents' cosine >= LATENT_COSINE.  Launch counts are reset just
    before the split sample and read just after (its path's counts).  Each
    planted fault of ``clip_shard_fault`` in ``faults`` (two or more ranks)
    must fail that check, or raise on every rank.  Rank 0 returns the
    numbers."""
    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch.ops import attention as att

    rank, world = dist.get_rank(), dist.get_world_size()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sharded()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"sample": {k: n for k, n in att.launch_counts().items() if n}}
    res = None
    if rank == 0:
        t1 = time.perf_counter()
        ref = one()
        torch.cuda.synchronize()
        one_seconds = time.perf_counter() - t1
        same, cos = torch.equal(out, ref), cosine(out, ref)
        print(f"[clip_shard] {label} over {world} rank(s): {seconds:.2f} s (one GPU "
              f"{one_seconds:.2f} s); final latents vs one GPU's: cosine {cos:.6f} "
              f"(>= {LATENT_COSINE}), bit for bit {same}; launches "
              f"{json.dumps(launches['sample'])}", flush=True)
        if not bool(torch.isfinite(out).all()):
            raise FloatingPointError(f"the split {label}'s latents are not finite")
        if (world == 1 and not same) or not cos >= LATENT_COSINE:
            raise RuntimeError(f"the split {label} left the one-GPU sample: cosine {cos}, "
                               f"bit for bit {same}")
        res = dict(seconds=seconds, one_gpu_seconds=one_seconds, cosine=cos, bit_for_bit=same,
                   launches=launches)
    for fault in faults:
        with clip_shard_fault(fault):
            try:
                bad, error = sharded(), None
            except (RuntimeError, ValueError) as e:  # raised by the hook itself, on every rank
                bad, error = None, f"{type(e).__name__}: {str(e).splitlines()[0]}"
        if rank == 0:
            f_cos = None if bad is None else cosine(bad, ref)
            res[f"fault_{fault}"] = dict(cosine=f_cos, error=error)
            reading = f"raised {error}" if bad is None else f"cosine {f_cos:.6f}"
            print(f"[clip_shard] {label} planted fault {fault}: final latents vs one GPU's "
                  f"{reading} (refused)", flush=True)
            if bad is not None and f_cos >= LATENT_COSINE:
                raise RuntimeError(f"the split {label}'s check passes the planted fault {fault}")
        del bad
    dist.barrier()
    return res


def clip_interp_sample(device, seed: int, faults=()) -> dict:
    """The interpolation network (``INTERP_TRAIN_CONFIG``'s, full width,
    seeded random weights, bf16) sampled 3 steps at CLIP_FRAME_T x 512 x 768
    through ``make_frame_sharded_sample``, split on the frame axis (the first
    and the last frame on two ranks), against ``engine.sample`` on one GPU;
    with the planted ``faults`` (``clip_sample``)."""
    import torch

    from ccedit_tpu_torch import config
    from ccedit_tpu_torch.conditioning.conditioner import Conditioner
    from ccedit_tpu_torch.diffusion import (DiscreteDenoiser, DPMPP2SAncestralSampler,
                                            LegacyDDPMDiscretization, VanillaCFG)
    from ccedit_tpu_torch.models.engine import CCEditEngine
    from ccedit_tpu_torch.parallel.sampling import gather_clip, make_frame_sharded_sample

    with device:
        net = config.build_network(copy.deepcopy(
            config.INTERP_TRAIN_CONFIG["model"]["params"]["network_config"]))
    engine = CCEditEngine(random_module(net, device, seed), DiscreteDenoiser(),
                          DPMPP2SAncestralSampler(LegacyDDPMDiscretization(), num_steps=STEPS),
                          Conditioner([]), guider=VanillaCFG(scale=7.5))
    t = CLIP_FRAME_T
    shape = (1, t, H // 8, W // 8, 4)
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = lambda *s: torch.randn(s, generator=gen, device=device).to(torch.bfloat16)
    hint = (torch.rand((1, t, H, W, 3), generator=gen, device=device) * 2 - 1).to(torch.bfloat16)
    ends = bf16(1, 2, H // 8, W // 8, 4)
    c = {"crossattn": bf16(1, 77, 768), "control_hint": hint, "interpolate_first_last": ends}
    uc = dict(c, crossattn=bf16(1, 77, 768))
    call = make_frame_sharded_sample(engine, shape, STEPS)
    draw = lambda: torch.Generator(device=device).manual_seed(seed)
    res = clip_sample(f"interpolation sample {STEPS} steps {t}x{H}x{W}",
                      lambda: gather_clip(call(c, uc, generator=draw()), call.axis),
                      lambda: engine.sample(c, uc, shape, num_steps=STEPS, generator=draw()),
                      faults)
    del engine, net
    torch.cuda.empty_cache()
    return res


def clip_blend_sample(engine, device, seed: int, faults=()) -> dict:
    """The TV2V engine's sampler in its blending mode (frames [: T/2]
    re-seeded from the noised x0's [T/2 + 1 :] before every step), 3 steps
    at CLIP_BLEND_T x 512 x 768 split on the frame axis, against the same
    sample on one GPU; with the planted ``faults`` (``clip_sample``)."""
    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch.parallel.sampling import (gather_clip, pick_clip_axis,
                                                    shard_clip_cond)
    from ccedit_tpu_torch.parallel.shard import ClipShard, clip_randn, mesh_context

    rank, world = dist.get_rank(), dist.get_world_size()
    t = CLIP_BLEND_T
    shape = (1, t, H // 8, W // 8, 4)
    dtype = engine.network_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    c = {"crossattn": torch.randn((1, 77, 768), generator=gen, device=device).to(dtype),
         "control_hint": (torch.rand((1, t, H, W, 3), generator=gen, device=device) * 2
                          - 1).to(dtype)}
    uc = dict(c, crossattn=torch.randn((1, 77, 768), generator=gen, device=device).to(dtype))
    x0 = torch.randn(shape, generator=gen, device=device)
    axis = pick_clip_axis(world, shape)
    shard = ClipShard(axis, t, size=shape[2:4])
    local = list(shape)
    local[axis] //= world

    def blend(cond, ucond, x0_part, shape_part):
        draw = torch.Generator(device=device).manual_seed(seed)
        x = clip_randn(shape_part, draw, device)
        return engine.sampler.sampling_blending(engine.make_denoise_fn(cond, ucond), x, x0_part,
                                                num_steps=STEPS, generator=draw)

    def sharded():
        cb = shard_clip_cond(c, shape, axis, rank, world)
        ub = shard_clip_cond(uc, shape, axis, rank, world)
        with mesh_context(shard), torch.no_grad():
            out = blend(cb, ub, shard.block(x0, axis).contiguous(), local)
        return gather_clip(out, axis)

    def one():
        with torch.no_grad():
            return blend(c, uc, x0, shape)

    return clip_sample(f"blending sample {STEPS} steps {t}x{H}x{W}", sharded, one, faults)


def clip_raig_row(device, seed: int) -> dict:
    """RAIG's 2-D network (full SD-1.5 width with TVI2V's appearance
    ControlNet, seeded random weights, bf16) on one CFG-doubled row of
    CLIP_RAIG x CLIP_RAIG images, split on the height axis (the JAX
    ``pick_clip_axis``'s axis 1 of the 4-D latent) and gathered, against the
    same row on one GPU: ROUTE_TOLERANCE and CLIP_COSINE.  Launch counts are
    reset just before the split row and read just after."""
    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch import config
    from ccedit_tpu_torch.ops import attention as att
    from ccedit_tpu_torch.parallel.sampling import gather_clip, pick_clip_axis
    from ccedit_tpu_torch.parallel.shard import AXES, ClipShard, census, mesh_context

    rank, world = dist.get_rank(), dist.get_world_size()
    appearance = copy.deepcopy(config.TVI2V_CONFIG["model"]["params"]["network_config"]
                               ["params"]["controlnet_img_config"])
    with device:
        net = config.build_network({
            "target": "sgm.modules.diffusionmodules.controlmodel.ControlledUNetModel2DRAIG",
            "params": dict(config._SD15_UNET, controlnet_img_config=appearance)})
    net = random_module(net, device, seed)
    n = CLIP_RAIG // 8
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = lambda *s: torch.randn(s, generator=gen, device=device).to(torch.bfloat16)
    x, ts = bf16(2, n, n, 4), torch.tensor([999.0, 999.0], device=device)
    cond = {"crossattn": bf16(2, 77, 768), "cond_feat": bf16(2, n, n, 4)}
    dim = pick_clip_axis(world, (1, n, n, 4))  # a dim of the (B, H, W, C) latent
    shard = ClipShard(dim + 1, 1, size=(n, n))
    reset_launches()
    with mesh_context(shard), torch.no_grad(), census() as records:
        out = gather_clip(net(shard.block(x, dim).contiguous(), ts, cond), dim)
    torch.cuda.synchronize()
    launches = {"forward": {k: v for k, v in att.launch_counts().items() if v}}
    gathers = sum(r["kind"] == "kv_all_gather" for r in records)
    res = None
    if rank == 0:
        with torch.no_grad():
            ref = net(x, ts, cond)
        rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        cos = cosine(out, ref)
        print(f"[clip_shard] RAIG row 2x{CLIP_RAIG}x{CLIP_RAIG} on the {AXES[shard.axis]} axis "
              f"over {world} rank(s): max|err|/max|ref| {rel:.3e} (tol {ROUTE_TOLERANCE:.0e}), "
              f"cosine {cos:.6f} (>= {CLIP_COSINE}), {gathers} k/v all-gathers; launches "
              f"{json.dumps(launches['forward'])}", flush=True)
        if not (rel <= ROUTE_TOLERANCE and cos >= CLIP_COSINE and (gathers or world == 1)):
            raise RuntimeError(f"the split RAIG row disagrees with the one-GPU row: {rel}, {cos}")
        res = dict(axis=AXES[shard.axis], rel=rel, cosine=cos, kv_all_gathers=gathers,
                   launches=launches)
    del net
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def clip_shard_rank() -> int:
    """Phase 11 on one rank of ``torchrun``: the TV2V row on the height axis
    (17 frames; with the planted faults at two or more ranks), the TV2V row
    on the frame axis (16 frames), the padded rows (CLIP_PAD on the height
    axis with the padding faults, CLIP_FRAME_PAD on the frame axis), the
    512x768 and padded rows again under W8A8 (``clip_w8a8_row``, the W8A8
    faults on the height axis, pad_amax on the padded row), the 3-step
    TV2V edit exact (512x768 and CLIP_PAD) and W8A8, the blending sample,
    the TVI2V edit, the interpolation sample and the RAIG row; rank 0
    writes the results to CLIP_DIR."""
    import torch
    import torch.distributed as dist

    from ccedit_tpu_torch.cli.profile_tv2v import build_edit, int8_environment, make_edit
    from ccedit_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {"world": world}
    engine, edit, _ = build_edit("tv2v", device, SEED, STEPS, clip_shard=True)
    split = world > 1  # the planted faults act only beyond one rank
    faults = (tuple(f for f in CLIP_SHARD_FAULTS if f not in PAD_FAULTS + SAMPLE_FAULTS)
              if split else ())
    res["tv2v_row"] = clip_row(engine, device, T, SEED, faults)
    if rank == 0 and not split:
        print("[clip_shard] world 1: the planted faults (halos, GroupNorm statistics, k/v "
              "gathers, the padding's zeros, statistics and amax, blending's gather, the "
              "interpolation controls' frames) need two or more ranks; not run", flush=True)
    res["frame_row"] = clip_row(engine, device, CLIP_FRAME_T, SEED)
    ph, pw = CLIP_PAD
    res["pad_row"] = clip_row(engine, device, T, SEED,
                              ("pad_unmasked", "pad_counted") if split else (), ph, pw)
    t_fp, h_fp, w_fp = CLIP_FRAME_PAD
    res["frame_pad_row"] = clip_row(engine, device, t_fp, SEED, (), h_fp, w_fp)
    res["tv2v_w8a8_row"] = clip_w8a8_row(engine, device, T, SEED,
                                         W8A8_CLIP_FAULTS if split else ())
    res["frame_w8a8_row"] = clip_w8a8_row(engine, device, CLIP_FRAME_T, SEED)
    res["pad_w8a8_row"] = clip_w8a8_row(engine, device, T, SEED,
                                        ("pad_amax",) if split else (), ph, pw)
    res["tv2v"] = clip_edit("tv2v", edit, device, SEED)
    edit_pad, _ = make_edit(engine, "tv2v", clip_shard=True, height=ph, width=pw)
    res["tv2v_pad"] = clip_edit("tv2v_pad", edit_pad, device, SEED, h=ph, w=pw)
    res["blend"] = clip_blend_sample(engine, device, SEED, ("blend_local",) if split else ())
    def exact_latents():
        with int8_environment():
            return edit(STEPS, torch.Generator(device=device).manual_seed(SEED), clip_shard=False,
                        return_latents=True)[1]

    with int8_environment(CCEDIT_QUANT_MATMUL="1"):
        res["tv2v_w8a8"] = clip_edit("tv2v_w8a8", edit, device, SEED, exact=exact_latents)
    del engine, edit
    torch.cuda.empty_cache()
    engine, edit, _ = build_edit("tvi2v", device, SEED, STEPS, clip_shard=True)
    res["tvi2v"] = clip_edit("tvi2v", edit, device, SEED)
    del engine, edit
    torch.cuda.empty_cache()
    res["interp"] = clip_interp_sample(device, SEED, ("interp_local",) if split else ())
    res["raig_row"] = clip_raig_row(device, SEED)
    if rank == 0:
        from pathlib import Path

        Path(CLIP_DIR).mkdir(parents=True, exist_ok=True)
        Path(CLIP_DIR, "result.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def run_clip_shard(seed: int) -> dict:
    """Phase 11: single-clip sharding under ``torchrun`` on ``clip_world()``
    cards (NCCL; world 1 on a single card).  Returns rank 0's per-stage
    counts of the sharded edits, as paths ``clip_shard_tv2v`` and
    ``clip_shard_tvi2v``."""
    import os
    import signal
    from pathlib import Path

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    world = clip_world()
    result = Path(CLIP_DIR, "result.json")
    result.unlink(missing_ok=True)
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), os.path.abspath(__file__), "--clip-shard-rank"]
    print(f"[clip_shard] {' '.join(cmd[1:])}", flush=True)
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        code = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise RuntimeError("phase 11's ranks did not finish in 600 s")
    if code != 0 or not result.exists():
        raise RuntimeError(f"phase 11's ranks failed (exit {code})")
    res = json.loads(result.read_text())
    tv2v = res["tv2v"]["launches"]
    if res["world"] > 1:  # the k/v gathers: no exact kernel-1 launch at n_k = n_q
        square = _variant_sum({"sample": tv2v["sample"]}, "d", "n_k=n_q")
        gathered = _variant_sum({"sample": tv2v["sample"]}, "d", "n_k!=n_q")
        if square or not gathered:
            raise RuntimeError(f"the sharded TV2V sample ran kernel 1 {square} times at n_k = "
                               f"n_q and {gathered} at the gathered n_k")
    print(f"[clip_shard] phase 11 at world {res['world']} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"clip_shard_tv2v": tv2v, "clip_shard_tvi2v": res["tvi2v"]["launches"],
            "clip_shard_tv2v_w8a8": res["tv2v_w8a8"]["launches"],
            "clip_shard_tv2v_pad": res["tv2v_pad"]["launches"],
            "clip_shard_blend": res["blend"]["launches"],
            "clip_shard_interp": res["interp"]["launches"],
            "clip_shard_raig": res["raig_row"]["launches"]}


# ---------------------------------------------------------------------------
# phase 12: the W8A8 path (ops/quant.py)

# (a): each kernel against its plain version at the shapes the main path
# gives it: (label, "conv" | "dense", input shape (N, H, W, C) / (N, L, C) /
# (M, C), output channels, kernel, stride, padding)
W8A8_SHAPES = (
    ("level-0 3x3", "conv", (34, 64, 96, 320), 320, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("level-1 3x3", "conv", (34, 32, 48, 640), 640, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("level-0 TemporalConv k=3", "conv", (12288, 17, 320), 320, (3,), (1,), ((1, 1),)),
    ("conv_in K=36", "conv", (34, 64, 96, 4), 320, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("VAE decoder 3x3", "conv", (17, 512, 768, 128), 128, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("VAE decoder conv_out", "conv", (17, 512, 768, 128), 3, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("level-0 Downsample s2", "conv", (34, 64, 96, 320), 320, (3, 3), (2, 2), ((1, 1), (1, 1))),
    ("level-0 decoder skip 1x1", "conv", (34, 64, 96, 960), 320, (1, 1), (1, 1),
     ((0, 0), (0, 0))),
    ("level-2 3x3", "conv", (34, 16, 24, 1280), 1280, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("level-0 temporal k=1", "conv", (12288, 17, 320), 320, (1,), (1,), ((0, 0),)),
    ("VAE decoder up conv 512", "conv", (17, 256, 384, 512), 512, (3, 3), (1, 1),
     ((1, 1), (1, 1))),
    ("VAE encoder downsample (0, 1)", "conv", (17, 512, 768, 128), 128, (3, 3), (2, 2),
     ((0, 1), (0, 1))),
    ("hint pyramid first conv", "conv", (34, 512, 768, 3), 16, (3, 3), (1, 1),
     ((1, 1), (1, 1))),
    ("dense 320->320", "dense", (208896, 320), 320),
    ("dense 320->2560", "dense", (208896, 320), 2560),
    ("dense 1280->320", "dense", (208896, 1280), 320),
    ("dense 640->640", "dense", (52224, 640), 640),
    ("dense 640->5120", "dense", (52224, 640), 5120),
    ("dense 2560->640", "dense", (52224, 2560), 640),
    ("dense 1280->1280", "dense", (13056, 1280), 1280),
    ("dense 1280->10240", "dense", (13056, 1280), 10240),
    ("dense 5120->1280", "dense", (13056, 5120), 1280),
    ("cross k/v 768->320", "dense", (2618, 768), 320),
    ("cross k/v 768->640", "dense", (2618, 768), 640),
    ("cross k/v 768->1280", "dense", (2618, 768), 1280),
    ("embedding 1280->320", "dense", (34, 1280), 320),
    ("embedding 1280->640", "dense", (34, 1280), 640),
    ("embedding 1280->1280", "dense", (34, 1280), 1280),
)
# (b): the umbrella edit's final latents against the same edit with the
# three kernels swapped for their plain versions on the card (exact fp64
# int8 products, TF32 off), by cosine; the edit with the weight scales read
# per input channel must fall below it
W8A8_LATENT_COSINE = 0.999
W8A8_KERNELS = (
    dict(name="quantize_int8", source="ccedit_tpu_torch/csrc/quantize_int8.cu",
         replaces="ccedit_tpu/ops/quant.py:61 (XLA in the JAX package, no Pallas kernel)"),
    dict(name="norm_silu_quantize", source="ccedit_tpu_torch/csrc/quantize_int8.cu",
         replaces="ccedit_tpu/ops/quant.py:61 per tensor with the GroupNorm and SiLU before "
                  "each ResBlock QConv (ccedit_tpu/modules/blocks.py:182-194; XLA in the JAX "
                  "package, no Pallas kernel)"),
    dict(name="int8_gemm_dequant", source="ccedit_tpu_torch/csrc/int8_gemm.cu",
         replaces="ccedit_tpu/ops/quant.py:75 (XLA in the JAX package, no Pallas kernel)"),
    dict(name="int8_gemm_bf16a", source="ccedit_tpu_torch/csrc/int8_gemm.cu",
         replaces="ccedit_tpu/ops/quant.py:75 with :61 per token (XLA in the JAX package, no "
                  "Pallas kernel)"),
    dict(name="int8_conv", source="ccedit_tpu_torch/csrc/int8_conv.cu",
         replaces="ccedit_tpu/ops/quant.py:91 (XLA in the JAX package, no Pallas kernel)"),
)
W8A8_PATH = "tv2v_int8_umbrella"  # the path whose launches the JSON reports
W8A8_LAUNCHED = ("quantize_int8", "norm_silu_quantize", "int8_gemm_dequant", "int8_gemm_bf16a",
                 "int8_conv")  # each W8A8 edit launches every one, no other edit any
# (a), kernel 8's fused norm form (quant.norm_silu_quantize) against its
# plain chain (GroupNorm module, SiLU, plain_quantize_int8) at the main
# path's GroupNorm -> SiLU -> QConv inputs: (label, x shape (S, ..., C),
# with the ResBlock's embedding add, eps, (gamma, beta) or None for random
# affine parameters).  The last row's u = gamma * xhat + beta lies on both
# sides of SiLU's minimum with every |silu| below 0.28: its amax needs the
# kernel's third pass.
NORM_SHAPES = (
    ("level-0 image (+ embedding)", (34, 64, 96, 320), True, 1e-5, None),
    ("level-0 image 640", (34, 64, 96, 640), False, 1e-5, None),
    ("level-0 temporal", (12288, 17, 320), False, 1e-5, None),
    ("level-1 image", (34, 32, 48, 640), True, 1e-5, None),
    ("level-1 temporal", (3072, 17, 640), False, 1e-5, None),
    ("level-2 image", (34, 16, 24, 1280), True, 1e-5, None),
    ("VAE decoder 128", (17, 512, 768, 128), False, 1e-6, None),
    ("VAE decoder 512", (17, 256, 384, 512), False, 1e-6, None),
    ("third pass", (8, 64, 96, 320), False, 1e-5, (0.3, -1.3)),
)
# its gate against the plain chain: the scale, every int8 code, the share
# of codes differing, the dequantized values' cosine (the sums run in
# another order than torch's GroupNorm, so values near a rounding boundary
# may land one step apart)
NORM_SCALE_TOLERANCE = 2.0 ** -7
NORM_CODES_DIFFERING = 1e-3
NORM_FAULTS = {1: "per-sample amax", 2: "statistics over the first half of the positions"}
# (a), the external-statistics fused form (an image GroupNorm's statistics
# summed over a height split's ranks) at a rank's block of the split
# network's inputs, on one card through ``group_norm_route.OrderOnlyShard``
# (this rank's sums standing for every rank's): (label, x shape, with the
# embedding add, eps, the world whose block it is); bit for bit its sharded
# plain chain
NORM_SPLIT_SHAPES = (
    ("level-0 image, height split over 2 (+ embedding)", (34, 32, 96, 320), True, 1e-5, 2),
    ("level-0 image, height split over 4 (+ embedding)", (34, 16, 96, 320), True, 1e-5, 4),
    ("level-1 image, height split over 4", (34, 8, 48, 640), False, 1e-5, 4),
)
# phase 3's GroupNorm (kernel 8's norm form, the port's GroupNorm module on
# the card): (label, x shape, eps); at most GROUP_NORM_DIFFERING of its bf16
# outputs may differ from fp64 statistics' (torch's bf16 GroupNorm, whose
# statistics stay in bf16, must exceed it)
GROUP_NORM_SHAPES = (
    ("level-0 image", (34, 64, 96, 320), 1e-5),
    ("level-0 temporal", (12288, 17, 320), 1e-5),
    ("VAE decoder 128", (17, 512, 768, 128), 1e-6),
)
GROUP_NORM_DIFFERING = 1e-2
GROUP_NORM_RECORD = dict(
    name="group_norm", source="ccedit_tpu_torch/csrc/quantize_int8.cu",
    replaces="ccedit_tpu/modules/blocks.py:182 nn.GroupNorm(dtype=bfloat16) (flax, XLA in the "
             "JAX package, no Pallas kernel; every GroupNorm of the networks)")
# the paths whose exact GroupNorms must launch it
GROUP_NORM_PATHS = ("tv2v", "tvi2v", "clip_shard_tv2v", "clip_shard_tvi2v")


def w8a8_operands(kind, x_shape, o, kernel, gen, device):
    """bf16 x, weight (torch layout) and bias, as a layer of the model sees
    them: x standard normal, weights N(0, 1/fan_in), biases N(0, 0.1^2)."""
    import torch

    c = x_shape[-1]
    w_shape = (o, c) + (tuple(kernel) if kind == "conv" else ())
    fan_in = c * math.prod(w_shape[2:])
    x = torch.randn(x_shape, generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn(w_shape, generator=gen, device=device) / math.sqrt(fan_in)).to(torch.bfloat16)
    b = (0.1 * torch.randn((o,), generator=gen, device=device)).to(torch.bfloat16)
    return x, w, b


def check_w8a8_shape(label, kind, x_shape, o, kernel=(), stride=(), padding=(), *, gen, device):
    """One shape of phase 12 (a): the quantizer bit for bit (activation and
    weight: int8 values and scales), the raw int32 accumulators bit for bit,
    the epilogue's output against its plain version (TOLERANCE, COSINE) and
    its planted fault refused (dense: the per-row scale dropped, the first
    row's read for every row; conv: the window shifted one row); times,
    bound and yardstick."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from ccedit_tpu_torch.ops import quant
    from ccedit_tpu_torch.scripts import roofline

    x, w, bias = w8a8_operands(kind, x_shape, o, kernel, gen, device)
    c = x_shape[-1]
    per_row = kind == "dense"
    x2 = x.reshape(-1, c)
    x8, sx = quant.quantize_int8(x2, per_row=per_row)
    w8, sw = quant.quantize_weight(w if kind == "dense" or len(kernel) == 2 else w[..., None])
    px8, psx = quant.plain_quantize_int8(x2, per_row)
    taps = math.prod(kernel) if kind == "conv" else 1
    w_rows = (w if kind == "dense" else
              (w if len(kernel) == 2 else w[..., None]).permute(0, 2, 3, 1)).reshape(o, -1)
    pw8, psw = quant.plain_quantize_int8(w_rows, True, taps)
    mismatches = int((x8 != px8).sum() + (sx != psx).sum() + (w8 != pw8).sum()
                     + (sw != psw).sum())
    del px8, psx, pw8, psw
    if kind == "dense":
        m = x2.shape[0]
        args = (x8, sx, w8, sw, bias)
        run, plain = quant.gemm_dequant, quant.plain_gemm_dequant
        # the per-row scale dropped: every row takes the first row's
        faults = {"per-row scale dropped": functools.partial(
            quant.gemm_dequant, x8, sx[:1].expand(m).contiguous(), w8, sw, bias)}
        tiles = quant.gemm_tiles(c, o)
        kernel_tiles = quant.kernel_gemm_tiles(c, o)
        if tiles != kernel_tiles:
            raise RuntimeError(f"w8a8 {label}: gemm_tiles {tiles} but the kernel takes "
                               f"{kernel_tiles}")
        ops = 2.0 * m * o * c
        nbytes = x8.numel() + w8.numel() + 4 * (sx.numel() + sw.numel()) + 2 * (o + m * o)

        def library():  # torch._int_mm and a torch rescale of its int32 product
            acc = torch._int_mm(x8, w8.t())
            return (acc.float() * sx[:, None] * sw).to(torch.bfloat16) + bias
    else:
        geom = quant.geometry(kernel, stride, padding)
        x4 = x8.view(x_shape[:3] + (-1,) if len(kernel) == 2 else x_shape[:2] + (1, -1))
        ho, wo = geom.out_hw(x4.shape[1], x4.shape[2])
        m = x4.shape[0] * ho * wo
        args = (x4, sx, w8, sw, bias)
        run = functools.partial(quant.conv_dequant, geom=geom)
        plain = functools.partial(quant.plain_conv_dequant, geom=geom)
        faults = {
            "window shifted one row": dataclasses.replace(geom, pt=geom.pt - 1, pb=geom.pb + 1),
            "window shifted one column": dataclasses.replace(geom, pl=geom.pl - 1,
                                                             pr=geom.pr + 1)}
        faults = {name: functools.partial(quant.conv_dequant, x4, sx, w8, sw, bias, shifted)
                  for name, shifted in faults.items()}
        tiles = quant.conv_tiles(x4.shape[-1], o)
        kernel_tiles = quant.kernel_conv_tiles(x4.shape[-1], o)
        if tiles != kernel_tiles:
            raise RuntimeError(f"w8a8 {label}: conv_tiles {tiles} but the kernel takes "
                               f"{kernel_tiles}")
        ops = 2.0 * m * o * c * taps
        nbytes = x4.numel() + w8.numel() + 4 * (1 + sw.numel()) + 2 * (o + m * o)
        xc = x.movedim(-1, 1)  # the exact path's own op: cuDNN bf16, channels-last memory

        def library():
            if len(kernel) == 2:
                return F.conv2d(xc, w, bias, stride, tuple(p for p, _ in padding))
            return F.conv1d(xc, w, bias, stride, padding[0][0])

    acc = run(*args, dtype=None)
    acc_plain = plain(*args, dtype=None)
    acc_equal = bool(torch.equal(acc, acc_plain))
    del acc, acc_plain
    out = run(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    cos = cosine(out, ref)
    exact = int((out != ref).sum())
    refused = {}
    for name, fault in faults.items():
        bad = fault(dtype=torch.bfloat16)
        refused[name] = (((bad.float() - ref.float()).abs().max()
                          / ref.float().abs().max()).item(), cosine(bad, ref))
        del bad
    del out
    fused = None
    if kind == "dense" and quant.gemm_route(c, o, x.dtype) == "fused":
        fused = check_fused_dense(label, x2, w8, sw, bias, ref, ops)
    del ref
    ms = cuda_time_ms(lambda: run(*args), 5)
    q_ms = cuda_time_ms(lambda: quant.quantize_int8(x2, per_row=per_row), 5)
    q_plain_ms = cuda_time_ms(lambda: quant.plain_quantize_int8(x2, per_row), 1)
    plain_ms = cuda_time_ms(lambda: plain(*args), 1)
    try:
        library_ms = cuda_time_ms(library, 5)
    except RuntimeError as e:  # a yardstick only: say why it is missing
        library_ms = None
        print(f"[w8a8] {label}: no library time ({e})", flush=True)
    bound = roofline.bound(int8_ops=ops, nbytes=nbytes)
    q_bound = roofline.bound(nbytes=x2.numel() * x2.element_size() + x8.numel()
                             + 4 * sx.numel())
    planted = "; ".join(f"planted fault ({name}): relative {f_rel:.3e}, cosine {f_cos:.6f}"
                        for name, (f_rel, f_cos) in refused.items())
    print(f"[w8a8] {label} x {tuple(x_shape)} -> {o}{f' tiles {tiles}' if tiles else ''}: "
          f"quantizer mismatches {mismatches}, int32 accumulators equal {acc_equal}; epilogue "
          f"max_abs_err {err:.3e}, relative {rel:.3e}, cosine {cos:.7f}, {exact} values differ "
          f"(<= {TOLERANCE:.0e}, >= {COSINE}); {planted}; kernel {ms:.4f} ms (bound "
          f"{bound['bound_ms']:.4f} ms, {bound['bound_what']}, "
          f"{100 * bound['bound_ms'] / ms:.1f} %), quantizer {q_ms:.4f} ms (bound "
          f"{q_bound['bound_ms']:.4f} ms, plain {q_plain_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"library {library_ms} ms", flush=True)
    if mismatches:
        raise RuntimeError(f"w8a8 {label}: the quantizer differs from its plain version in "
                           f"{mismatches} values")
    if not acc_equal:
        raise RuntimeError(f"w8a8 {label}: the int32 accumulators differ from the plain ones")
    if not (rel <= TOLERANCE and cos >= COSINE):
        raise RuntimeError(f"w8a8 {label} disagrees with its plain version: relative {rel}, "
                           f"cosine {cos}")
    for name, (f_rel, f_cos) in refused.items():
        if f_rel <= TOLERANCE and f_cos >= COSINE:
            raise RuntimeError(f"w8a8 {label}: the check passes the planted fault ({name}): "
                               f"relative {f_rel}, cosine {f_cos}")
    del args, x8, w8, x, w
    torch.cuda.empty_cache()
    return dict(label=label, kind=kind, shape=list(x_shape), out_channels=o, fused=fused,
                quantizer_mismatches=mismatches, accumulators_equal=acc_equal, max_abs_err=err,
                max_rel_err=rel, cosine=cos, values_differing=exact, tiles=tiles,
                faults={name: dict(rel=f_rel, cosine=f_cos)
                        for name, (f_rel, f_cos) in refused.items()},
                ms=ms, quantize_ms=q_ms, plain_ms=plain_ms,
                library_ms=library_ms, quantize_plain_ms=q_plain_ms,
                quantize_bound_ms=q_bound["bound_ms"], **bound)


def check_fused_dense(label, x2, w8, sw, bias, ref, ops) -> dict:
    """Phase 12 (a) on the fused route of a dense shape (``gemm_route``):
    kernel 9 on the bf16 tokens, its in-kernel quantization's int8 values
    and scales bit for bit kernel 8's plain version, its int32
    accumulators bit for bit, its output against the plain output
    (TOLERANCE, COSINE), and its planted faults refused (the per-row scale
    dropped: every row with its tile's first scale; one amax for 64 rows);
    its time beside the two launches it replaces."""
    import torch

    from ccedit_tpu_torch.ops import quant
    from ccedit_tpu_torch.scripts import roofline

    m, o = x2.shape[0], w8.shape[0]
    acc, q8, sx = quant.gemm_dequant_bf16a(x2, w8, sw, None, None, quantized=True)
    px8, psx = quant.plain_quantize_int8(x2, True)
    mismatches = int((q8 != px8).sum() + (sx != psx).sum())
    acc_equal = bool(torch.equal(acc, quant.plain_gemm_dequant(px8, psx, w8, sw, None, None)))
    del acc, q8, sx
    out = quant.gemm_dequant_bf16a(x2, w8, sw, bias)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    cos = cosine(out, ref)
    del out
    # a fault is refused when any check the kernel passes fails on it: the
    # quantization bit for bit (which one amax for 64 rows of similar
    # magnitude fails first), or the output's gate
    refused = {}
    for name, flag in (("per-row scale dropped", 2), ("one amax for 64 rows", 1)):
        bad, q8, sx = quant.gemm_dequant_bf16a(x2, w8, sw, bias, faults=flag, quantized=True)
        refused[name] = (((bad.float() - ref.float()).abs().max()
                          / ref.float().abs().max()).item(), cosine(bad, ref),
                         int((q8 != px8).sum() + (sx != psx).sum()))
        del bad, q8, sx
    del px8, psx
    ms = cuda_time_ms(lambda: quant.gemm_dequant_bf16a(x2, w8, sw, bias), 5)
    two_ms = cuda_time_ms(lambda: quant.gemm_dequant(
        *quant.quantize_int8(x2, per_row=True), w8, sw, bias), 5)
    plain_ms = cuda_time_ms(lambda: quant.plain_gemm_dequant_bf16a(x2, w8, sw, bias), 1)
    bound = roofline.bound(int8_ops=ops, nbytes=x2.numel() * x2.element_size() + w8.numel()
                           + 4 * sw.numel() + 2 * (o + m * o))
    planted = "; ".join(f"planted fault ({name}): relative {f_rel:.3e}, cosine {f_cos:.6f}, "
                        f"quantizer mismatches {f_mis}"
                        for name, (f_rel, f_cos, f_mis) in refused.items())
    print(f"[w8a8] {label} fused: quantizer mismatches {mismatches}, int32 accumulators equal "
          f"{acc_equal}; max_abs_err {err:.3e}, relative {rel:.3e}, cosine {cos:.7f}; {planted}; "
          f"kernel {ms:.4f} ms (bound {bound['bound_ms']:.4f} ms, {bound['bound_what']}, "
          f"{100 * bound['bound_ms'] / ms:.1f} %) against the two launches {two_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    if mismatches:
        raise RuntimeError(f"w8a8 {label}: the fused quantization differs from kernel 8's plain "
                           f"version in {mismatches} values")
    if not acc_equal:
        raise RuntimeError(f"w8a8 {label}: the fused int32 accumulators differ from the plain ones")
    if not (rel <= TOLERANCE and cos >= COSINE):
        raise RuntimeError(f"w8a8 {label} fused disagrees with its plain version: relative "
                           f"{rel}, cosine {cos}")
    for name, (f_rel, f_cos, f_mis) in refused.items():
        if f_rel <= TOLERANCE and f_cos >= COSINE and not f_mis:
            raise RuntimeError(f"w8a8 {label}: the fused check passes the planted fault "
                               f"({name}): relative {f_rel}, cosine {f_cos}")
    return dict(quantizer_mismatches=mismatches, accumulators_equal=acc_equal,
                max_abs_err=err, max_rel_err=rel, cosine=cos,
                faults={name: dict(rel=f_rel, cosine=f_cos, quantizer_mismatches=f_mis)
                        for name, (f_rel, f_cos, f_mis) in refused.items()},
                ms=ms, two_launches_ms=two_ms, plain_ms=plain_ms, library_ms=None, **bound)


def norm_operands(shape, add: bool, eps: float, affine, gen, device):
    """bf16 x with a per-sample spread (0.75-1.25) and a ramp along the
    positions (-0.5 .. 0.5) over N(0, 1) noise, a GroupNorm(32) with bf16
    weight 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1) (or the given constants),
    and an (S, C) addend 0.5 N(0, 1) or None."""
    import torch

    from ccedit_tpu_torch.modules.layers import GroupNorm

    s, c = shape[0], shape[-1]
    p = math.prod(shape[1:-1])
    norm = GroupNorm(32, c, eps=eps, temporal=len(shape) == 3).to(device, torch.bfloat16)
    with torch.no_grad():
        if affine is None:
            norm.weight.copy_(1 + 0.1 * torch.randn((c,), generator=gen, device=device))
            norm.bias.copy_(0.1 * torch.randn((c,), generator=gen, device=device))
        else:
            norm.weight.fill_(affine[0])
            norm.bias.fill_(affine[1])
    spread = 0.75 + 0.5 * torch.rand((s, 1, 1), generator=gen, device=device)
    ramp = torch.linspace(-0.5, 0.5, p, device=device)[None, :, None]
    x = (torch.randn((s, p, c), generator=gen, device=device) * spread + ramp)
    x = x.reshape(shape).to(torch.bfloat16)
    a = (0.5 * torch.randn((s, c), generator=gen, device=device)).to(torch.bfloat16) \
        if add else None
    return x, norm, a


def norm_gate(qa, ref) -> dict:
    """The fused form's int8 rows and scale against the plain chain's."""
    import torch

    diff = (qa.q.to(torch.int16) - ref.q.to(torch.int16)).abs()
    deq = qa.q.float() * qa.scale
    deq_ref = ref.q.float() * ref.scale
    res = dict(scale_rel=abs(qa.scale.item() - ref.scale.item()) / ref.scale.item(),
               max_code_diff=int(diff.max().item()),
               codes_differing=diff.count_nonzero().item() / diff.numel(),
               cosine=cosine(deq, deq_ref), max_abs_err=(deq - deq_ref).abs().max().item())
    res["passes"] = (res["scale_rel"] <= NORM_SCALE_TOLERANCE and res["max_code_diff"] <= 1
                     and res["codes_differing"] <= NORM_CODES_DIFFERING
                     and res["cosine"] >= COSINE)
    return res


def check_norm_shape(label, shape, add, eps, affine, *, gen, device) -> dict:
    """One row of phase 12 (a) for kernel 8's fused norm form: the gate
    against the plain chain, both planted faults refused by it, the third
    pass taken where (and only where) the row needs it; its time beside the
    unfused chain it replaces (the add, the GroupNorm module, the SiLU, the
    rows, kernel 8 per tensor) on the same tensors, the plain chain's and
    the bound."""
    import torch
    import torch.nn.functional as F

    from ccedit_tpu_torch.ops import quant
    from ccedit_tpu_torch.scripts import roofline

    x, norm, a = norm_operands(shape, add, eps, affine, gen, device)
    with torch.no_grad():
        ref = quant.plain_norm_silu_quantize(x, norm, a)
        before = quant.third_passes(device)
        gate = norm_gate(quant.norm_silu_quantize(x, norm, a), ref)
        third = quant.third_passes(device) - before
        refused = {NORM_FAULTS[f]: norm_gate(quant.norm_silu_quantize(x, norm, a, faults=f), ref)
                   for f in NORM_FAULTS}
        del ref

        def unfused():
            xa = x if a is None else x + quant.sample_addend(x, a)
            y = F.silu(norm(xa))
            return quant.quantize_int8(y.reshape(-1, y.shape[-1]), per_row=False)

        ms = cuda_time_ms(lambda: quant.norm_silu_quantize(x, norm, a), 5)
        unfused_ms = cuda_time_ms(unfused, 5)
        plain_ms = cuda_time_ms(lambda: quant.plain_norm_silu_quantize(x, norm, a), 1)
    bound = roofline.norm_quantize_bound(shape, add)
    print(f"[w8a8] fused norm {label} {shape}{' + addend' if add else ''}: scale rel "
          f"{gate['scale_rel']:.2e}, codes differing {gate['codes_differing']:.2e} (max "
          f"{gate['max_code_diff']}), cosine {gate['cosine']:.7f}, third passes {third}; "
          + "; ".join(f"planted fault ({k}): codes differing {v['codes_differing']:.2e} (max "
                      f"{v['max_code_diff']}), cosine {v['cosine']:.6f}" for k, v in refused.items())
          + f"; kernel {ms:.4f} ms (bound {bound['bound_ms']:.4f} ms, "
          f"{100 * bound['bound_ms'] / ms:.1f} %), unfused chain {unfused_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)
    if not gate["passes"]:
        raise RuntimeError(f"fused norm {label}: outside its gate against the plain chain: "
                           f"{gate}")
    for name, res in refused.items():
        if res["passes"]:
            raise RuntimeError(f"fused norm {label}: the gate passes the planted fault ({name}): "
                               f"{res}")
    if third != (1 if affine is not None else 0):
        raise RuntimeError(f"fused norm {label}: {third} third passes")
    del x, norm, a
    torch.cuda.empty_cache()
    return dict(label=label, kind="norm", shape=list(shape), add=add, third_passes=third,
                faults=refused, ms=ms, unfused_ms=unfused_ms, plain_ms=plain_ms,
                library_ms=None, **{k: v for k, v in gate.items() if k != "passes"}, **bound)


def check_external_norm_shape(label, shape, add, eps, world, *, gen, device) -> dict:
    """One row of phase 12 (a) for the external-statistics fused form: bit
    for bit its sharded plain chain (the sharded GroupNorm, SiLU, the
    per-tensor quantizer) under ``OrderOnlyShard``, on a block of the split
    over ``world``; its time beside the unsharded fused form's on the same
    tensor and the chain's."""
    import torch

    from ccedit_tpu_torch.ops import quant
    from ccedit_tpu_torch.parallel.shard import mesh_context
    from ccedit_tpu_torch.scripts import roofline
    from ccedit_tpu_torch.scripts.group_norm_route import OrderOnlyShard

    x, norm, a = norm_operands(shape, add, eps, None, gen, device)
    with torch.no_grad():
        with mesh_context(OrderOnlyShard(shape[1:3])):
            before = quant._NORM_SILU_QUANTIZE.variant_launches["external sharded"]
            ref = quant.plain_norm_silu_quantize(x, norm, a)
            got = quant.norm_silu_quantize(x, norm, a)
            if quant._NORM_SILU_QUANTIZE.variant_launches["external sharded"] != before + 1:
                raise RuntimeError(f"external norm {label}: the external-statistics form did "
                                   "not run")
            same = bool(torch.equal(got.q, ref.q) and torch.equal(got.scale, ref.scale))
            gate = norm_gate(got, ref)
            ms = cuda_time_ms(lambda: quant.norm_silu_quantize(x, norm, a), 5)
            chain_ms = cuda_time_ms(lambda: quant.plain_norm_silu_quantize(x, norm, a), 5)
        local_ms = cuda_time_ms(lambda: quant.norm_silu_quantize(x, norm, a), 5)
    bound = roofline.norm_quantize_bound(shape, add, external=True)
    print(f"[w8a8] external norm {label} {shape}: bit for bit the sharded plain chain {same} "
          f"(codes differing {gate['codes_differing']:.2e}); kernel {ms:.4f} ms (bound "
          f"{bound['bound_ms']:.4f} ms, {100 * bound['bound_ms'] / ms:.1f} %), the local-"
          f"statistics form {local_ms:.4f} ms, the sharded plain chain {chain_ms:.4f} ms",
          flush=True)
    if not same:
        raise RuntimeError(f"external norm {label}: not bit for bit its sharded chain: {gate}")
    del x, norm, a, ref, got
    torch.cuda.empty_cache()
    return dict(label=label, kind="external norm", shape=list(shape), add=add, world=world,
                bit_for_bit=same, ms=ms, local_ms=local_ms, plain_ms=chain_ms, library_ms=None,
                **{k: v for k, v in gate.items() if k != "passes"}, **bound)


def check_group_norm(device) -> dict:
    """Phase 3's GroupNorm row: the port's GroupNorm module on the card
    (kernel 8's norm form, ``quant.group_norm``) at GROUP_NORM_SHAPES against
    the plain fp32 form (``quant.plain_group_norm``: torch's fp32 GroupNorm
    of the bf16 input) at phase 3's gate, reporting whether it is bit for
    bit; at most GROUP_NORM_DIFFERING of its outputs differing from an
    fp64-statistics GroupNorm rounded to bf16, and torch's bf16 GroupNorm
    (bf16 statistics, the module before it kept fp32 ones) refused by that
    limit.  Times with CUDA events beside the plain form's and torch's bf16
    one (the library call) and the byte bound.  Returns the JSON record."""
    import torch
    import torch.nn.functional as F

    from ccedit_tpu_torch.ops import quant
    from ccedit_tpu_torch.scripts import roofline

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    rows = []
    for label, shape, eps in GROUP_NORM_SHAPES:
        x, norm, _ = norm_operands(shape, False, eps, None, gen, device)
        with torch.no_grad():
            launches = quant.group_norm.launches
            out = norm(x)
            if quant.group_norm.launches != launches + 1:
                raise RuntimeError(f"group norm {label}: the module did not launch kernel 8's "
                                   "norm form")
            plain = quant.plain_group_norm(x, norm)
            bf16_stats = F.group_norm(x.movedim(-1, 1), 32, norm.weight, norm.bias,
                                      eps).movedim(1, -1)
            ref = F.group_norm(x.movedim(-1, 1).double(), 32, norm.weight.double(),
                               norm.bias.double(), eps).movedim(1, -1).to(torch.bfloat16)
            share = lambda y: (y != ref).count_nonzero().item() / y.numel()
            err = (out.float() - plain.float()).abs().max().item()
            rel = err / plain.float().abs().max().item()
            row = dict(label=label, shape=list(shape), max_abs_err=err, max_rel_err=rel,
                       cosine=cosine(out, plain), bit_for_bit=bool(torch.equal(out, plain)),
                       differing_fp64=share(out), plain_differing_fp64=share(plain),
                       bf16_stats_differing_fp64=share(bf16_stats),
                       ms=cuda_time_ms(lambda: quant.group_norm(x, norm), 10),
                       plain_ms=cuda_time_ms(lambda: quant.plain_group_norm(x, norm), 10),
                       library_ms=cuda_time_ms(lambda: F.group_norm(
                           x.movedim(-1, 1), 32, norm.weight, norm.bias, eps), 10),
                       **roofline.group_norm_bound(shape))
        print(f"[group_norm] {label} {shape}: vs the plain fp32 form max|err| {err:.3e} "
              f"({rel:.2e} of max|plain|), cosine {row['cosine']:.7f}, bit for bit "
              f"{row['bit_for_bit']}; outputs differing from fp64 statistics: kernel "
              f"{row['differing_fp64']:.2e}, plain fp32 {row['plain_differing_fp64']:.2e}, "
              f"torch bf16 {row['bf16_stats_differing_fp64']:.2e} (limit "
              f"{GROUP_NORM_DIFFERING}); kernel {row['ms']:.4f} ms (bound "
              f"{row['bound_ms']:.4f}), plain {row['plain_ms']:.4f}, torch bf16 "
              f"{row['library_ms']:.4f}", flush=True)
        if not (rel <= TOLERANCE and row["cosine"] >= COSINE
                and row["differing_fp64"] <= GROUP_NORM_DIFFERING):
            raise RuntimeError(f"group norm {label}: outside its gate: {row}")
        if not row["bf16_stats_differing_fp64"] > GROUP_NORM_DIFFERING:
            raise RuntimeError(f"group norm {label}: the fp64-statistics check passes torch's "
                               f"bf16 statistics: {row}")
        rows.append(row)
        del x, norm, out, plain, bf16_stats, ref
        torch.cuda.empty_cache()
    first = {k: rows[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                     "max_abs_err")}
    return dict(GROUP_NORM_RECORD, route="cuda", launches=0, **first,
                library="torch's bf16 GroupNorm (F.group_norm, bf16 statistics)", shapes=rows)


def check_w8a8_kernels(device) -> list:
    """Phase 12 (a): kernels 8-10 at every shape of W8A8_SHAPES and kernel
    8's fused norm form at every shape of NORM_SHAPES; one JSON record a
    kernel (the quantizer's times at the first shape's activation, the
    fused norm form's at the first norm shape, the GEMM's at the first
    dense shape, the conv's at the first conv shape)."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    rows = [check_w8a8_shape(*spec, gen=gen, device=device) for spec in W8A8_SHAPES]
    norm_rows = [check_norm_shape(*spec, gen=gen, device=device) for spec in NORM_SHAPES]
    norm_rows += [check_external_norm_shape(*spec, gen=gen, device=device)
                  for spec in NORM_SPLIT_SHAPES]
    conv = next(r for r in rows if r["kind"] == "conv")
    dense = next(r for r in rows if r["kind"] == "dense")
    records = []
    fused = next(r for r in rows if r["fused"])
    for spec in W8A8_KERNELS:
        if spec["name"] == "norm_silu_quantize":
            first = {k: norm_rows[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "max_abs_err")}
            records.append(dict(name=spec["name"], route="cuda", source=spec["source"],
                                replaces=spec["replaces"], launches=0, **first, library=None,
                                shapes=norm_rows))
            continue
        if spec["name"] == "quantize_int8":
            first = dict(ms=conv["quantize_ms"], plain_ms=conv["quantize_plain_ms"],
                         library_ms=None, bound_ms=conv["quantize_bound_ms"], bound_by="bytes",
                         max_abs_err=0.0)
        elif spec["name"] == "int8_gemm_bf16a":
            first = {k: fused["fused"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                    "bound_by", "max_abs_err")}
        else:
            r = conv if spec["name"] == "int8_conv" else dense
            first = {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                       "max_abs_err")}
        records.append(dict(name=spec["name"], route="cuda", source=spec["source"],
                            replaces=spec["replaces"], launches=0, **first,
                            library={"int8_conv": "cuDNN bf16 conv (F.conv2d / F.conv1d)",
                                     "int8_gemm_dequant": "torch._int_mm + rescale"}.get(
                                         spec["name"]),
                            shapes=[r for r in rows if spec["name"] == "quantize_int8"
                                    or (spec["name"] == "int8_gemm_bf16a" and r["fused"])
                                    or (spec["name"] == "int8_gemm_dequant"
                                        and r["kind"] == "dense")
                                    or (spec["name"] == "int8_conv" and r["kind"] == "conv")]))
    print(f"[w8a8] phase 12 (a) in {time.perf_counter() - t0:.1f} s", flush=True)
    return records


@contextlib.contextmanager
def plain_w8a8():
    """The W8A8 layers through the kernels' plain versions on the card
    (``qlinear``/``qconv`` and the layers look the names up at each call):
    the weights quantized at every call, with no cache."""
    from ccedit_tpu_torch.ops import quant

    names = ("quantize_int8", "gemm_dequant", "gemm_dequant_bf16a", "conv_dequant",
             "norm_silu_quantize", "quantize_weight")
    saved = [getattr(quant, name) for name in names]
    for name in names:
        setattr(quant, name, getattr(quant, f"plain_{name}"))
    try:
        yield
    finally:
        for name, wrapper in zip(names, saved):
            setattr(quant, name, wrapper)


@contextlib.contextmanager
def two_launch_route():
    """Every dense product of the W8A8 layers through kernel 8 and kernel 9's
    int8 form (``qlinear`` looks ``gemm_route`` up at each call)."""
    from ccedit_tpu_torch.ops import quant

    sound = quant.gemm_route
    quant.gemm_route = lambda k, n, dtype: "two_launches"
    try:
        yield
    finally:
        quant.gemm_route = sound


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the exact convolutions left in a
    W8A8 edit, so two edits can be compared bit for bit."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def weight_scales_per_input_channel():
    """The planted fault of phase 12 (b): each layer's weight quantized as it
    should be, but its output channels' scales read from a per-input-channel
    scale vector (channel o takes input channel o's, wrapping)."""
    import torch

    from ccedit_tpu_torch.ops import quant

    sound = quant.quantize_weight

    def faulty(weight, dtype=None):
        w8, sw = sound(weight, dtype)
        dims = (0,) + tuple(range(2, weight.dim()))
        amax = weight.float().abs().amax(dim=dims)
        s_in = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
        idx = torch.arange(sw.numel(), device=sw.device) % s_in.numel()
        return w8, s_in[idx].contiguous()

    quant.quantize_weight = faulty
    try:
        yield
    finally:
        quant.quantize_weight = sound


def w8a8_launches(stages) -> dict:
    return {name: sum(c.get(name, 0) for c in stages.values())
            for name in W8A8_LAUNCHED + ("quantize_qk",)}


def weight_quantizations(edit, device, steps: int, seed: int, label: str):
    """``edit_counted`` with the weight cache's misses and hits counted:
    (latents, per-stage counts, (misses, hits))."""
    from ccedit_tpu_torch.ops import quant

    before = quant.WEIGHT_CACHE["misses"], quant.WEIGHT_CACHE["hits"]
    _, lat, st = edit_counted(edit, device, steps, seed, label)
    counts = (quant.WEIGHT_CACHE["misses"] - before[0], quant.WEIGHT_CACHE["hits"] - before[1])
    print(f"[{label}] weight quantizations {counts[0]}, cache hits {counts[1]}", flush=True)
    return lat, st, counts


def run_w8a8_edits(path, edit, exact, exact_launches, device, steps: int, seed: int) -> dict:
    """Phase 12 (b), on the engine of phase 4 or 5 before it is freed: the
    same edit as ``CCEDIT_QUANT_MATMUL=1`` (W8A8 alone) and ``CCEDIT_INT8=1``
    (W8A8 and the int8 QK^T), then the umbrella edit through the plain
    versions of kernels 8-10 (the fused norm form's plain chain, no weight
    cache) and with the weight scales read per input channel, and once
    more with every dense product on the two-launch route
    (``two_launch_route``), which must give the umbrella edit's final
    latents bit for bit (both with cuDNN's deterministic algorithms).
    Kernels 8-10 (kernel 8 in both forms, kernel 9 in both) must run on
    both W8A8 edits and not on the exact one nor the plain-version one;
    kernel 1c on the umbrella edit only; the first W8A8 edit quantizes the
    weights into the cache, the umbrella and two-launch edits after it
    quantize none; the umbrella edit's latents must stay within
    W8A8_LATENT_COSINE of the plain-version edit's, the fault's must not.
    Returns the per-stage counts as paths ``path + "_w8a8"`` and ``path +
    "_int8_umbrella"``."""
    import torch

    from ccedit_tpu_torch.cli.profile_tv2v import int8_environment

    t0 = time.perf_counter()
    rows = 2 * steps - 1
    runs, weights = {}, {}
    for mode, env in (("w8a8", {"CCEDIT_QUANT_MATMUL": "1"}),
                      ("int8_umbrella", {"CCEDIT_INT8": "1"})):
        is_umbrella = mode == "int8_umbrella"
        with int8_environment(**env), (deterministic_cudnn() if is_umbrella
                                       else contextlib.nullcontext()):
            t1 = time.perf_counter()
            lat, st, weights[mode] = weight_quantizations(edit, device, steps, seed,
                                                          f"{path}_{mode}")
            runs[mode] = (lat, st, time.perf_counter() - t1)
            if is_umbrella:
                with two_launch_route():
                    two_lat, two_st, weights["two launches"] = weight_quantizations(
                        edit, device, steps, seed, f"{path}_{mode} two launches")
                with plain_w8a8():
                    _, plain_lat, plain_st = edit_counted(edit, device, steps, seed,
                                                          f"{path}_{mode} plain W8A8")
                with weight_scales_per_input_channel():
                    _, fault_lat, _ = edit_counted(edit, device, steps, seed,
                                                   f"{path}_{mode} fault")
    for mode, (lat, st, secs) in runs.items():
        counts = w8a8_launches(st)
        print(f"[{path}_{mode}] {secs:.2f} s ({secs / rows:.3f} s a network row of {rows}, "
              f"the edit's stages included), launches {counts}, final latents' cosine to the "
              f"exact edit's {cosine(lat, exact):.6f}", flush=True)
        if min(counts[k] for k in W8A8_LAUNCHED) <= 0:
            raise RuntimeError(f"the {path} {mode} edit did not launch every W8A8 kernel: {counts}")
        if (counts["quantize_qk"] > 0) != (mode == "int8_umbrella"):
            raise RuntimeError(f"the {path} {mode} edit launched kernel 1c's pre-pass "
                               f"{counts['quantize_qk']} times")
    exact_counts = w8a8_launches(exact_launches)
    if any(exact_counts[k] for k in W8A8_LAUNCHED):
        raise RuntimeError(f"the exact {path} edit launched W8A8 kernels: {exact_counts}")
    if any(w8a8_launches(plain_st)[k] for k in W8A8_LAUNCHED):
        raise RuntimeError("the plain-version edit launched W8A8 kernels")
    if weights["w8a8"][0] <= 0 or weights["int8_umbrella"][0] or weights["two launches"][0]:
        raise RuntimeError(f"the weight cache: quantizations (misses, hits) by edit {weights}: "
                           f"the first W8A8 edit must fill it, the later ones quantize none")
    umbrella = runs["int8_umbrella"][0]
    two_counts = w8a8_launches(two_st)
    same = bool(torch.equal(two_lat, umbrella))
    print(f"[{path}_int8_umbrella] the two-launch route: launches {two_counts}, final latents "
          f"bit for bit the fused route's: {same} (max|diff| "
          f"{(two_lat.float() - umbrella.float()).abs().max().item():.3e})", flush=True)
    if two_counts["int8_gemm_bf16a"] or not two_counts["int8_gemm_dequant"]:
        raise RuntimeError(f"the two-launch route launched the fused kernel: {two_counts}")
    if not same:
        raise RuntimeError(f"the {path} umbrella edit differs between the fused and the "
                           f"two-launch routes")
    cos_plain, cos_fault = cosine(umbrella, plain_lat), cosine(fault_lat, plain_lat)
    diff = (umbrella.float() - plain_lat.float()).abs().max().item()
    print(f"[{path}_int8_umbrella] final latents vs the same edit through the plain W8A8 "
          f"versions: cosine {cos_plain:.7f} (max|diff| {diff:.3e}), with the weight scales "
          f"read per input channel {cos_fault:.6f} (limit {W8A8_LATENT_COSINE}); phase 12 (b) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if not cos_plain >= W8A8_LATENT_COSINE:
        raise RuntimeError(f"the {path} umbrella edit left its plain-version edit: {cos_plain}")
    if not cos_fault < W8A8_LATENT_COSINE:
        raise RuntimeError(f"the W8A8 latent check passes the per-input-channel weight scales: "
                           f"{cos_fault}")
    del exact
    torch.cuda.empty_cache()
    return {f"{path}_w8a8": runs["w8a8"][1], f"{path}_int8_umbrella": runs["int8_umbrella"][1]}


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
    group_norm_record = check_group_norm(device)
    probe_records, probe_counts = run_probes(device)
    # phase 12 (a): the W8A8 kernels against their plain versions
    w8a8_records = check_w8a8_kernels(device)

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
    # phase 10: image sampling and the secondary entry points
    by_path.update(run_image(device, SEED))
    # phase 11: one clip split over the cards (world 1 on one card)
    by_path.update(run_clip_shard(SEED))
    for rec, spec in zip(records, KERNELS):
        rec["launches_by_path"] = {p: spec["count"](st) for p, st in by_path.items()}
        rec["launches"] = rec["launches_by_path"][spec["path"]]
        for p, names in PATH_KERNELS.items():
            if rec["name"] in names and rec["launches_by_path"][p] <= 0:
                return fail(f"the {p} path never launched {rec['name']}")
    for rec, spec in zip(w8a8_records, W8A8_KERNELS):
        rec["launches_by_path"] = {p: w8a8_launches(st)[spec["name"]]
                                   for p, st in by_path.items() if p != "probes"}
        rec["launches"] = rec["launches_by_path"][W8A8_PATH]
        for p, n in rec["launches_by_path"].items():
            if (n > 0) != p.endswith(("_w8a8", "_int8_umbrella")):
                return fail(f"the {p} path launched {rec['name']} {n} times")
    records += w8a8_records
    group_norm_record["launches_by_path"] = {
        p: sum(c.get("group_norm", 0) for c in st.values())
        for p, st in by_path.items() if p != "probes"}
    group_norm_record["launches"] = group_norm_record["launches_by_path"]["tv2v"]
    for p in GROUP_NORM_PATHS:
        if group_norm_record["launches_by_path"][p] <= 0:
            return fail(f"the {p} path never launched group_norm")
    records.append(group_norm_record)
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
    # torchrun starts phase 11's ranks as ``chip_smoke.py --clip-shard-rank``
    sys.exit(clip_shard_rank() if sys.argv[1:] == ["--clip-shard-rank"] else main())
