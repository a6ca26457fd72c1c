"""Kernel 10's time split by leaving parts of its work out, on one GPU.

    python -m ccedit_tpu_torch.scripts.conv_breakdown [--iters N]

Builds variants of ``csrc/int8_conv.cu`` (a patched copy each, compiled with
nvcc into ``build/conv_breakdown/``) and times each, in turns, beside the
kernel as it is, at the conv rows of ``chip_smoke.py``'s phase 12 (a)
(``W8A8_SHAPES``; run from the root of the checkout), on the tile
``quant.conv_tiles`` picks:

* ``no_mma``: the ring runs and the epilogue stores, but no wgmma is
  issued (the load path and the epilogue);
* ``no_im2col``: the im2col loads of A left out, the weights still loaded
  (the MMAs on stale A, the B loads and the epilogue);
* ``no_loads``: no TMA at all, each stage's barrier completed at once (the
  MMAs and the epilogue);
* ``no_epilogue``: the consumers go on to their next tile after its last
  wgmma (the loads and the MMAs);
* ``no_dequant``: the epilogue stores the raw accumulators' bits as bf16
  pairs (no dequant arithmetic);
* ``no_stores``: the epilogue dequantizes and stages the tile but writes
  nothing to device memory (no TMA store, no row stores).

The variants give wrong outputs and time only what remains.  One JSON line
a shape: each variant's times, the bound (``scripts/roofline.py``) and the
card's name and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from ..ops import build, quant
from . import roofline
from .bwd_breakdown import build_variants

SOURCE = "int8_conv.cu"
OUT = build.BUILD_DIR.parent / "conv_breakdown"
_MMA = ("          WgmmaS8<BN>::run(\n              acc[t], desc(stage + BM * boxes + within + a_base"
        " + t * 64 * chunk, 16, sbo, layout),\n              db, 1);")
_IM2COL = "              if (j < loads)\n                tma_load_im2col_4d("
_BYTES = "p.per * (loads * PIX + BN) * chunk"
_B_LOAD = "            tma_load_3d(sa + (p.per * BM + u * BN) * chunk"
_LAST_STAGE = "    if (lane == 0) mbar_arrive(&empty[prev]);  // the tile's last stage\n"
_RING_STORES = ("    if (rows > 0 && g.o % vec == 0) {", "    } else if (rows > 0) {")
VARIANTS = {
    "no_mma": ((_MMA, "          (void)db;"),),
    "no_im2col": ((_IM2COL, "              if (false)\n                tma_load_im2col_4d("),
                  (_BYTES, "p.per * BN * chunk")),
    "no_loads": ((_IM2COL, "              if (false)\n                tma_load_im2col_4d("),
                 (_BYTES, "0"), (_B_LOAD, "            if (false) " + _B_LOAD.lstrip())),
    "no_epilogue": ((_LAST_STAGE, _LAST_STAGE + "    continue;\n"),),
    "no_dequant": (
        ("pack_bf16(dequant<1>(acc[t][4 * j + 2 * h], sx, w0, has_bias, b0),\n"
         "                            dequant<1>(acc[t][4 * j + 2 * h + 1], sx, w1, has_bias, b1));",
         "pack_bf16(__int_as_float(acc[t][4 * j + 2 * h]),\n"
         "                            __int_as_float(acc[t][4 * j + 2 * h + 1]));"),
        ("y[e] = dequant<1>(a[e], sx, col_sw[q + e], has_bias, col_bias[q + e]);",
         "y[e] = __int_as_float(a[e]);")),
    "no_stores": (("for (int b = 0; b < BN / 32; ++b)", "for (int b = 0; b < 0; ++b)"),
                  (_RING_STORES[0], "    if (rows > 0 && kind == 7) {"),
                  (_RING_STORES[1], "    } else if (rows > 0 && kind == 7) {")),
}


def operands(x_shape, o, kernel, stride, padding, device):
    gen = torch.Generator(device=device).manual_seed(sum(x_shape) + o)
    c = x_shape[-1]
    x = torch.randn(x_shape, generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((o, c) + tuple(kernel), generator=gen, device=device)
         / math.sqrt(c * math.prod(kernel))).to(torch.bfloat16)
    bias = (0.1 * torch.randn((o,), generator=gen, device=device)).to(torch.bfloat16)
    x4, w4, geom = quant._to_2d(x, w, stride, padding)
    x8, sx = quant.quantize_int8(x4.reshape(-1, c), per_row=False)
    w8, sw = quant.quantize_weight(w4)
    return x8.view(x4.shape[:3] + (-1,)), sx, w8, sw, bias, geom


def run(device, iters: int = 10, labels=None) -> list:
    import chip_smoke

    fns = {"kernel": build.library().ccedit_int8_conv,
           **build_variants(VARIANTS, SOURCE, "ccedit_int8_conv", OUT)}
    records = []
    for label, kind, x_shape, o, *window in chip_smoke.W8A8_SHAPES:
        if kind != "conv" or (labels and not any(s in label for s in labels)):
            continue
        x8, sx, w8, sw, bias, geom = operands(x_shape, o, *window, device)
        n, h, w, cp = x8.shape
        ho, wo = geom.out_hw(h, w)
        out = torch.empty((n, ho, wo, o), device=device, dtype=torch.bfloat16)

        def call(fn):
            err = fn(1, x8.data_ptr(), w8.data_ptr(), out.data_ptr(), sx.data_ptr(),
                     sw.data_ptr(), bias.data_ptr(), n, h, w, cp, o, geom.kh, geom.kw, geom.sh,
                     geom.sw, geom.pt, geom.pl, ho, wo, build.stream_of(x8))
            if err != 0:
                raise RuntimeError(f"launch failed with error {err}")

        ms = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                ms[name].append(roofline.cuda_time_ms(lambda: call(fn), iters))
        m = n * ho * wo
        bound = roofline.bound(int8_ops=2.0 * m * o * cp * geom.kh * geom.kw,
                               nbytes=x8.numel() + w8.numel() + 4 * (1 + o) + 2 * (o + m * o))
        rec = dict(label=label, shape=list(x_shape), out_channels=o,
                   tiles=list(quant.conv_tiles(cp, o)), ms=ms, **bound)
        print("[conv_breakdown] " + label + ": " + ", ".join(
            f"{k} {min(v):.4f}" for k, v in ms.items()) + f" ms (bound {bound['bound_ms']:.4f})",
            flush=True)
        records.append(rec)
        del x8, w8, out
        torch.cuda.empty_cache()
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--label", nargs="*", default=None,
                    help="only the rows whose label holds one of these")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_breakdown needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    for rec in run(torch.device("cuda:0"), a.iters, a.label):
        print(json.dumps(dict(rec, card=card)), flush=True)


if __name__ == "__main__":
    main()
