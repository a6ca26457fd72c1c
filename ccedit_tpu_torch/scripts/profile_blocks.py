"""Kernel 7: kernel 1's Hopper forward at swept tile sizes, and per-block
timings, on one GPU.

    python -m ccedit_tpu_torch.scripts.profile_blocks [sweep] [blocks]

Port of ``scripts/profile_blocks.py``, which swept the block sizes of the
flash kernel the JAX edits ran.  ``sweep`` (the default) sweeps the tiles
of the port's: kernel 1's template (``csrc/spatial_attention.cuh``, bf16
Q.K^T, row layout) instantiated at head_dim 40 (``csrc/attention_tiles.cu``)
over BM (query rows a block, 64 a consumer warpgroup) and BN (keys a K/V
tile), the pairs of ``TILES`` (the others spill; the source's header says
why), at (34, 8, 6144, 40) with q = k = v and scale 0.158, as the TPU script
does: one JSON line a tile pair with its CUDA-event ms, its bound
(``scripts/roofline.py``), kernel 1 on the same tensors and the ratio to it
((128, 128) is kernel 1's own instantiation), PyTorch's
``scaled_dot_product_attention`` on the same tensors (a yardstick) and its
error against the plain version on one batch row of independent q, k and v
(``compare_inputs``; with q = k = v each row's own key dominates), held as
kernel 5's full probes are (``kv_resident_attn.compare``): max|err| /
max|plain| <= 2e-2 and cosine >= 0.9999, limits that the sweep fails with
log2 e left out of its exp2 scale.
``blocks`` times the port's ``ResBlock3D`` and ``SpatialTransformer3D`` at
(2, 17, 64, 96, 320) in bf16 (seeded random weights), one JSON line.  The
TPU script's compile cache and ``fori_loop`` slope timing are TPU
scaffolding and are not ported.

``tiles`` is the sweep's wrapper (a CPU tensor takes the plain version, a
CUDA tensor launches the instantiation or raises), counted in
``tiles.launches`` and ``tiles.variant_launches``.  The attention dispatch
never launches it: kernel 1 runs its own (128, 128) instantiation.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess

import torch

from ..ops import build
from ..ops.flash_attention import plain_flash_attention
from ..ops.spatial_attention import kv_resident_attention
from . import roofline
from .kv_resident_attn import compare

B, H, N, D = 34, 8, 6144, 40
SCALE = 0.158
# the (BM, BN) pairs of BM in {64, 128, 192} x BN in {64, 128, 256} that
# compile without spills (csrc/attention_tiles.cu says why the others do not)
TILES = ((64, 64), (64, 128), (64, 256), (128, 64), (128, 128), (192, 64), (192, 128))
COMPARE_BATCH = 1  # batch rows held to the plain version (its fp32 scores fit)
BLOCK_SHAPE = (2, 17, 64, 96, 320)  # (B, T, H, W, C): UNet level 0 at 512x768
_LOG2E = 1.0 / math.log(2.0)


def variant_name(bm: int, bn: int) -> str:
    return f"bm{bm} bn{bn}"


def tiles(q, k, v, scale: float, bm: int, bn: int) -> torch.Tensor:
    """Attention over (B, H, N, 40) through kernel 1's template at tiles
    (bm, bn).  A CPU tensor takes ``plain_flash_attention``; a CUDA tensor
    launches the instantiation or raises."""
    if not q.is_cuda:
        return plain_flash_attention(q, k, v, scale)
    if (bm, bn) not in TILES:
        raise ValueError(f"no kernel-7 instantiation at tiles {(bm, bn)}; have {TILES}")
    out = torch.empty_like(q)
    strides = build.attention_operand_strides(q, k, v, out, (D,))
    b, h, n_q, d = q.shape
    build.launch("ccedit_attention_tiles", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, h, n_q, k.shape[2], d, bm, bn, strides,
                 float(scale) * _LOG2E, build.stream_of(q))
    tiles.launches += 1
    tiles.variant_launches[variant_name(bm, bn)] += 1
    return out


tiles.launches = 0
tiles.variant_launches = collections.Counter()


def compare_inputs(device, shape=(B, H, N, D), rows: int = COMPARE_BATCH):
    """Independent seeded bf16 q, k, v of ``rows`` batch rows at ``shape``:
    the slice each tile pair is held to the plain version on."""
    gen = torch.Generator(device=device).manual_seed(1)
    return tuple(torch.randn((rows,) + tuple(shape[1:]), generator=gen, device=device)
                 .to(torch.bfloat16) for _ in range(3))


def sweep(device, iters: int = 5, shape=(B, H, N, D), rows: int = COMPARE_BATCH) -> list:
    """Every tile pair at ``shape`` on one seeded q (= k = v): its time,
    bound, kernel 1's time on the same tensors (``kernel1_ms``, timed
    beside each pair; ``over_kernel1`` the ratio) and SDPA's time at the
    full shape; and on ``compare_inputs`` its error against the plain
    version (``compare``: max|err|, max|err| / max|plain|, cosine and
    ``ok``) and both times."""
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    qs, ks, vs = compare_inputs(device, shape, rows)
    ref = plain_flash_attention(qs, ks, vs, SCALE)
    bound = roofline.attention_bound(*shape[:3], shape[2], shape[3])
    library_ms, backend = roofline.sdpa_ms(q, q, q, SCALE, iters)
    plain_ms = roofline.cuda_time_ms(lambda: plain_flash_attention(qs, ks, vs, SCALE),
                                     max(iters // 2, 1))
    records = []
    for bm, bn in TILES:
        checked = compare("full", tiles(qs, ks, vs, SCALE, bm, bn), ref)
        ms = roofline.cuda_time_ms(lambda: tiles(q, q, q, SCALE, bm, bn), iters)
        kernel1_ms = roofline.cuda_time_ms(lambda: kv_resident_attention(q, q, q, SCALE), iters)
        records.append(dict(
            variant=variant_name(bm, bn), shape=list(shape), ms=ms, kernel1_ms=kernel1_ms,
            over_kernel1=ms / kernel1_ms,
            compared_ms=roofline.cuda_time_ms(lambda: tiles(qs, ks, vs, SCALE, bm, bn), iters),
            plain_ms=plain_ms, plain_shape=list(qs.shape), library_ms=library_ms,
            library=f"scaled_dot_product_attention [{backend}]", **checked, **bound))
    return records


def blocks(device, iters: int = 5) -> dict:
    """The port's ``ResBlock3D`` and ``SpatialTransformer3D`` (8 heads of
    40, 77-token context) at BLOCK_SHAPE in bf16, CUDA-event ms a forward."""
    from ..io.checkpoint import randomize_weights_
    from ..modules.blocks import ResBlock3D
    from ..modules.transformer import SpatialTransformer3D

    gen = torch.Generator(device=device).manual_seed(0)
    b, _, _, _, c = BLOCK_SHAPE
    x = torch.randn(BLOCK_SHAPE, generator=gen, device=device).to(torch.bfloat16)
    emb = torch.randn((b, 1280), generator=gen, device=device).to(torch.bfloat16)
    ctx = torch.randn((b, 77, 768), generator=gen, device=device).to(torch.bfloat16)
    with device:
        rb = ResBlock3D(c, 1280)
        st = SpatialTransformer3D(c, 8, 40, context_dim=768)
    for m in (rb, st):
        randomize_weights_(m, gen).to(torch.bfloat16).eval()
    with torch.no_grad():
        return {"shape": list(BLOCK_SHAPE),
                "ResBlock3D_ms": roofline.cuda_time_ms(lambda: rb(x, emb), iters),
                "SpatialTransformer3D_ms": roofline.cuda_time_ms(lambda: st(x, ctx), iters)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parts", nargs="*", choices=("sweep", "blocks"))
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_blocks needs a CUDA device")
    device = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    parts = set(a.parts) or {"sweep"}
    if "sweep" in parts:
        for rec in sweep(device, a.iters):
            print(json.dumps(dict(gpu=smi, part="sweep", **rec)), flush=True)
    if "blocks" in parts:
        print(json.dumps(dict(gpu=smi, part="blocks", **blocks(device, a.iters))), flush=True)


if __name__ == "__main__":
    main()
