"""Kernel 10 (``csrc/int8_conv.cu``) at each of its instantiated tiles.

    python -m ccedit_tpu_torch.scripts.conv_tiles [--iters N] [--label SUBSTRING ...]

Run from the root of the checkout (it reads the conv rows of
``chip_smoke.py``'s phase 12 (a), ``W8A8_SHAPES``).  For each row it
quantizes seeded bf16 operands with kernel 8, then launches
``ccedit_int8_conv_tiled`` at every instantiated (BM, BN) tile that fits
O (the narrow ones for O <= 32, the wide ones above; BN 160 only where it
divides O) with the k-chunk
``quant.conv_tiles`` picks (and 64 bytes where Cp is a multiple of 64 but
not of 128, so that the chunk needs no zero tail), checks
each tile's int32 accumulators against the chosen tile's bit for bit, and
times its bf16 launch with CUDA events.  One JSON line a row: the tiles'
times, the chosen tile, the bound (``scripts/roofline.py``) and the card.
Needs a GPU; the numbers are what ``PERF.md`` quotes for the tile choice.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from ..ops import build, quant
from . import roofline

# the instantiations of csrc/int8_conv.cu's `run`: (BM, BN)
TILES = ((256, 8), (256, 16), (256, 32), (256, 128), (192, 160))


def candidates(o: int):
    """The instantiated (BM, BN) tiles worth timing at O output channels."""
    if o <= 32:
        return [t for t in TILES if t[1] >= o]
    return [t for t in TILES if t[1] >= 128 and (t[1] != 160 or o % 160 == 0)]


def launch_tiled(x8, sx, w8, sw, bias, geom, tiles, dtype):
    n, h, w, cp = x8.shape
    o = w8.shape[0]
    ho, wo = geom.out_hw(h, w)
    out = torch.empty((n, ho, wo, o), device=x8.device,
                      dtype=torch.int32 if dtype is None else dtype)
    build.launch("ccedit_int8_conv_tiled", quant._OUT_KINDS[dtype], x8.data_ptr(),
                 w8.data_ptr(), out.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 0 if bias is None or dtype is None else bias.data_ptr(), n, h, w, cp, o,
                 geom.kh, geom.kw, geom.sh, geom.sw, geom.pt, geom.pl, ho, wo, *tiles,
                 build.stream_of(x8))
    return out


def sweep_shape(label, x_shape, o, kernel, stride, padding, iters, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(sum(x_shape) + o)
    c = x_shape[-1]
    x = torch.randn(x_shape, generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((o, c) + tuple(kernel), generator=gen, device=device)
         / math.sqrt(c * math.prod(kernel))).to(torch.bfloat16)
    bias = (0.1 * torch.randn((o,), generator=gen, device=device)).to(torch.bfloat16)
    x4, w4, geom = quant._to_2d(x, w, stride, padding)
    x8, sx = quant.quantize_int8(x4.reshape(-1, c), per_row=False)
    x8 = x8.view(x4.shape[:3] + (-1,))
    w8, sw = quant.quantize_weight(w4)
    del x, w
    cp = x8.shape[-1]
    chosen = quant.conv_tiles(cp, o)
    ref = quant.conv_dequant(x8, sx, w8, sw, None, geom, dtype=None)
    ho, wo = geom.out_hw(x8.shape[1], x8.shape[2])
    m = x8.shape[0] * ho * wo
    bound = roofline.bound(int8_ops=2.0 * m * o * cp * geom.kh * geom.kw,
                           nbytes=x8.numel() + w8.numel() + 4 * (1 + o) + 2 * (o + m * o))
    rows = []
    # the chosen chunk, and 64 bytes where Cp splits into 64-byte chunks
    # with no zero tail but 128-byte ones with one
    chunks = [chosen[2]] + ([64] if cp % 128 and cp % 64 == 0 else [])
    for (bm, bn), chunk in ((t, ch) for t in candidates(o) for ch in chunks):
        tiles = (bm, bn, chunk)
        equal = bool(torch.equal(launch_tiled(x8, sx, w8, sw, None, geom, tiles, None), ref))
        ms = roofline.cuda_time_ms(
            lambda: launch_tiled(x8, sx, w8, sw, bias, geom, tiles, torch.bfloat16), iters)
        rows.append(dict(bm=bm, bn=bn, chunk=chunk, ms=ms,
                         accumulators_equal=equal, bound_share=bound["bound_ms"] / ms))
        print(f"[conv_tiles] {label} {tiles}: {ms:.4f} ms, "
              f"{100 * bound['bound_ms'] / ms:.1f} % of the bound, equal {equal}", flush=True)
    del x8, w8, ref
    torch.cuda.empty_cache()
    return dict(label=label, shape=list(x_shape), out_channels=o, chosen=list(chosen),
                tiles=rows, **bound)


def main(argv=None) -> int:
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--label", nargs="*", default=None,
                    help="only the rows whose label holds one of these")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_tiles needs a GPU")
    device = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0)
    bad = 0
    for label, kind, x_shape, o, *window in chip_smoke.W8A8_SHAPES:
        if kind != "conv" or (a.label and not any(s in label for s in a.label)):
            continue
        rec = sweep_shape(label, x_shape, o, *window, a.iters, device)
        bad += sum(not r["accumulators_equal"] for r in rec["tiles"])
        print(json.dumps(dict(rec, card=card)), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
