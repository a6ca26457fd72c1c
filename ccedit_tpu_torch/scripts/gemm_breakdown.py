"""Kernel 9's time split by leaving parts of its work out, on one GPU.

    python -m ccedit_tpu_torch.scripts.gemm_breakdown [--iters N] [--label ...]

Builds variants of ``csrc/int8_gemm.cu`` (a patched copy each, compiled
with nvcc into ``build/gemm_breakdown/``; ``kernel`` is the source as it
is) and times each, in turns, at the dense rows of ``chip_smoke.py``'s
phase 12 (a) (``W8A8_SHAPES``; run from the root of the checkout), the
int8 form (``ccedit_int8_gemm``) and, where ``quant.gemm_route`` takes it,
the fused form on the bf16 activation (``fused_*``):

* ``no_mma``: the loads and the epilogue run, no wgmma is issued;
* ``no_loads``: no TMA load of A (nor of streamed B), each stage's
  barrier completed at once (the MMAs on stale tiles and the epilogue);
* ``no_epilogue``: the consumers go on to their next tile after its last
  wgmma (the loads and the MMAs);
* ``no_last_n_tile``: the walk without its last n tile (at N = 320 the
  second of two);
* ``no_dequant``: the epilogue stages the raw accumulators' bits, no
  dequant arithmetic; ``no_stores``: it dequantizes and stages the tile
  but stores nothing;
* ``magic_i2f``: the epilogue's int32 -> fp32 conversions on the FMA
  pipe (the high and low 16 bits as magic-number floats, one fused sum) in
  place of the conversion instruction;
* ``no_quantize`` (fused): neither the amax pass nor the in-place
  quantization (the MMAs on the raw bf16 bytes); ``no_quantize_writes``:
  the amax pass only; ``fdiv``: every value divided by ``__fdiv_rn`` and
  rounded by ``rintf`` (kernel 8's instructions) in place of the
  reciprocal, its two corrections and the magic-number rounding;
* ``registers_first``: the epilogue dequantizes the whole tile into
  registers first and waits for the previous tile's stores to have read
  the staging only before it writes it (the kernel waits before it
  dequantizes).

The variants give wrong outputs and time only what remains.  The inputs
are quantized by the plain versions, so only the one source is built.
One JSON line a shape: each variant's times, the bounds
(``scripts/roofline.py``; the fused form reads bf16 x) and the card's name
and power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess

import torch

from ..ops import build, quant
from . import roofline
from .bwd_breakdown import build_variants

SOURCE = "int8_gemm.cu"
OUT = build.BUILD_DIR.parent / "gemm_breakdown"
_MMA = "          WgmmaS8<BN>::run(acc, desc(a + kk * 32, 16, 1024, 1), desc(b + kk * 32, 16, 1024, 1), 1);"
_MMA_FUSED = ("          WgmmaS8<BN>::run(acc, desc(a + j * kBox + kk * 32, 16, 1024, 1),\n"
              "                           desc(b + kk * 32, 16, 1024, 1), 1);")
_LOADS = ("            tma_load_2d(st, &map_a, &full[s], 128 * ks, m0);\n"
          "            if (!p.resident) tma_load_2d(st + kBox, &map_w, &full[s], 128 * ks, n0);")
_LOADS_FUSED = "for (int c = 0; c < p.xc; ++c) tma_load_2d(st + c * kBox, &map_a, &full[s], 64 * c, m0);"
_TX = "mbar_expect_tx(&full[s], static_cast<uint32_t>(p.stage_bytes));"
_EPILOGUE = "    // epilogue: every consumer's tables and scales are written, and the"
_PASS1 = "for (int c = h; c < p.xc; c += 2) {"
_PASS2 = "for (int j = 0; j < p.kc; ++j) {\n        const int c = 2 * j + h;"
_N_TILES = "p.n_tiles = (n + BN - 1) / BN;"
_DEQUANT = ("dequant_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], sxr, w0,\n"
            "                                            w1, has_bias, b0, b1);")
_STORES = "for (int b = 0; b < BN / 32; ++b) tma_store_2d("
_I2F = ("  uint32_t v = pack_bf16(__fmul_rn(__fmul_rn(__int2float_rn(a0), sx), w0),\n"
        "                         __fmul_rn(__fmul_rn(__int2float_rn(a1), sx), w1));")
_MAGIC = ("__fmaf_rn(__int_as_float(0x4B400000 + (A >> 16)) - 12582912.f, 65536.f, "
          "__int_as_float(0x4B000000 | (A & 0xFFFF)) - 8388608.f)")
# the epilogue dequantizing into registers first, waiting for the previous
# tile's stores only before it writes the staging
_WAIT = ("    if (p.tma_store && threadIdx.x == 0) bulk_wait_read<0>();\n"
         "    named_sync(1, 256);\n    const int rs")
_W_FULL = "    if (p.resident && tile == static_cast<int>(blockIdx.x)) mbar_wait(&w_full, 0);\n"
_STAGE = ("          const uint32_t v = dequant_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], "
          "sxr, w0,\n                                            w1, has_bias, b0, b1);\n"
          "          *reinterpret_cast<uint32_t*>(ost + (j / 4) * kDenseBM * 64 + r * 64 +\n"
          "                                       (((j % 4) ^ ((r >> 1) & 3)) << 4) + 4 * t4) = v;\n"
          "        }\n      }\n")
_STAGE_LATER = ("          packed[2 * j + h] = dequant_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],"
                " sxr, w0, w1, has_bias, b0, b1);\n        }\n      }\n"
                "      if (threadIdx.x == 0) bulk_wait_read<0>();\n      named_sync(1, 256);\n"
                "#pragma unroll\n      for (int j = 0; j < BN / 8; ++j) {\n#pragma unroll\n"
                "        for (int h = 0; h < 2; ++h) {\n          const int r = 64 * w + r0 + 8 * h;\n"
                "          *reinterpret_cast<uint32_t*>(ost + (j / 4) * kDenseBM * 64 + r * 64 +\n"
                "                                       (((j % 4) ^ ((r >> 1) & 3)) << 4) + 4 * t4) =\n"
                "              packed[2 * j + h];\n        }\n      }\n")
_FAST = "const bool fast = scale >= 0x1p-100f && scale <= 0x1p100f;"
VARIANTS = {
    "kernel": (),
    "no_mma": ((_MMA, "          (void)b;"), (_MMA_FUSED, "          (void)b;")),
    "no_loads": ((_LOADS, ""), (_LOADS_FUSED, ""), (_TX, "mbar_expect_tx(&full[s], 0u);")),
    "no_epilogue": ((_EPILOGUE, "    continue;\n" + _EPILOGUE),),
    "no_last_n_tile": ((_N_TILES, "p.n_tiles = n > BN ? (n + BN - 1) / BN - 1 : 1;"),),
    "no_quantize": ((_PASS1, "for (int c = h; c < 0; c += 2) {"),
                    (_PASS2, _PASS2.replace("j < p.kc", "j < 0"))),
    "no_quantize_writes": ((_PASS2, _PASS2.replace("j < p.kc", "j < 0")),),
    "no_dequant": ((_DEQUANT, "static_cast<uint32_t>(acc[4 * j + 2 * h]) ^\n"
                              "              static_cast<uint32_t>(acc[4 * j + 2 * h + 1]) << 16;"),),
    "no_stores": ((_STORES, _STORES.replace("b < BN / 32", "b < 0")),),
    "magic_i2f": ((_I2F, _I2F.replace("__int2float_rn(a0)", _MAGIC.replace("A", "a0"))
                           .replace("__int2float_rn(a1)", _MAGIC.replace("A", "a1"))),),
    "fdiv": ((_FAST, "const bool fast = false;"),),
    "registers_first": (
        (_W_FULL, "    named_sync(1, 256);  // the tables are written\n" + _W_FULL),
        (_WAIT, "    const int rs"),
        ("      unsigned char* ost = smem + p.out_offset;\n",
         "      unsigned char* ost = smem + p.out_offset;\n      uint32_t packed[BN / 4];\n"),
        (_STAGE, _STAGE_LATER)),
}


def operands(m: int, k: int, n: int, device):
    gen = torch.Generator(device=device).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device=device) / math.sqrt(k)).to(torch.bfloat16)
    bias = (0.1 * torch.randn((n,), generator=gen, device=device)).to(torch.bfloat16)
    x8, sx = quant.plain_quantize_int8(x, True)
    w8, sw = quant.plain_quantize_int8(w, True)
    return x, x8, sx, w8, sw, bias


def run(device, iters: int = 10, labels=None) -> list:
    import chip_smoke

    fns = build_variants(VARIANTS, SOURCE, "ccedit_int8_gemm", OUT)
    fused_fns = {}
    for name, fn in fns.items():  # the fused entry of the same libraries
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        fused_fns[name] = lib.ccedit_int8_gemm_bf16a
        fused_fns[name].argtypes = build._SIGNATURES["ccedit_int8_gemm_bf16a"]
    records = []
    for label, kind, x_shape, n, *_ in chip_smoke.W8A8_SHAPES:
        if kind != "dense" or (labels and not any(s in label for s in labels)):
            continue
        m, k = x_shape
        x, x8, sx, w8, sw, bias = operands(m, k, n, device)
        out = torch.empty((m, n), device=device, dtype=torch.bfloat16)
        fused = quant.gemm_route(k, n, torch.bfloat16) == "fused"

        def call(fn, fused_form):
            if fused_form:
                err = fn(1, x.data_ptr(), w8.data_ptr(), out.data_ptr(), sw.data_ptr(),
                         bias.data_ptr(), 0, 0, 0, m, n, k, build.stream_of(x))
            else:
                err = fn(1, x8.data_ptr(), w8.data_ptr(), out.data_ptr(), sx.data_ptr(),
                         sw.data_ptr(), bias.data_ptr(), m, n, x8.shape[1], build.stream_of(x8))
            if err != 0:
                raise RuntimeError(f"launch failed with error {err}")

        runs = {name: (fn, False) for name, fn in fns.items()
                if "quantize" not in name and name != "fdiv"}
        if fused:
            runs.update({f"fused_{name}": (fn, True) for name, fn in fused_fns.items()})
        ms = {name: [] for name in runs}
        for _ in range(2):
            for name, (fn, fused_form) in runs.items():
                ms[name].append(roofline.cuda_time_ms(lambda: call(fn, fused_form), iters))
        bound = roofline.bound(int8_ops=2.0 * m * n * k,
                               nbytes=x8.numel() + w8.numel() + 4 * (m + n) + 2 * (n + m * n))
        fused_bound = roofline.bound(int8_ops=2.0 * m * n * k,
                                     nbytes=2 * x.numel() + w8.numel() + 4 * n + 2 * (n + m * n))
        rec = dict(label=label, shape=[m, k], out_channels=n, tiles=list(quant.gemm_tiles(k, n)),
                   ms=ms, **bound, fused_bound_ms=fused_bound["bound_ms"] if fused else None)
        print("[gemm_breakdown] " + label + f" tiles {quant.gemm_tiles(k, n)}: " + ", ".join(
            f"{name} {min(v):.4f}" for name, v in ms.items())
            + f" ms (bound {bound['bound_ms']:.4f}"
            + (f", fused {fused_bound['bound_ms']:.4f})" if fused else ")"), flush=True)
        records.append(rec)
        del x, x8, w8, out
        torch.cuda.empty_cache()
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--label", nargs="*", default=None,
                    help="only the rows whose label holds one of these")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_breakdown needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    for rec in run(torch.device("cuda:0"), a.iters, a.label):
        print(json.dumps(dict(rec, card=card)), flush=True)


if __name__ == "__main__":
    main()
