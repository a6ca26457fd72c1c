"""Kernel 6: the int8 matrix-rate probe on one GPU.

    python -m ccedit_tpu_torch.scripts.int8_probe [peak] [qkt] [conv] [kernel]

Port of ``scripts/int8_probe.py``. Its Pallas part (``part_pallas``: an int8
x int8 -> int32 and a bf16 x bf16 -> fp32 dot at (1024, 512) @ (512, 1024))
is a hand-written CUDA kernel, ``csrc/int8_gemm.cu`` (a warp-specialised TMA
+ wgmma GEMM; for int8 after B's transposition, ``transpose_int8``, since
8-bit wgmma reads only K-major operands); ``kernel`` runs it at that shape
and at 4096^3, holds the int32 result exactly to a float64 product, and
times both types beside their bounds.  The parts the JAX package left to XLA
(``part_peak``, ``part_qkt``, ``part_conv``) time PyTorch's own calls as
library yardsticks (``torch.matmul``, ``torch._int_mm``,
``torch.nn.functional.conv2d``); where PyTorch has no such call (a batched
int8 product, an int8 convolution) the script says so.  The TPU scripts'
compile cache and ``fori_loop`` slope timing are not ported: CUDA events
time the launches.  Prints one JSON line.

``gemm`` is the wrapper (a CPU tensor takes ``plain_gemm``, a CUDA tensor
launches the kernel or raises); ``gemm.launches`` and
``gemm.variant_launches`` count its launches.  ``transpose_int8`` (plain
version ``plain_transpose_int8``) is the transposing pre-kernel
(``csrc/transpose_int8.cu``) of the int8 product and of kernel 5's tr int8
probes.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess

import torch

from ..ops import build
from . import roofline

SHAPES = ((1024, 512, 1024), (4096, 4096, 4096))  # (M, K, N): part_pallas's, part_peak's
BF16_TOLERANCE = 1e-5  # bf16 product: max|err| / max|plain| (fp32 sums in another order)


def plain_gemm(a, b):
    """a @ b: int8 -> int32 through float64 (exact: |sum| <= K * 127^2 <
    2^53), bf16 (or fp32) -> fp32."""
    if a.dtype == torch.int8:
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    return torch.matmul(a.float(), b.float())


def plain_transpose_int8(x, width=None):
    """(..., rows, cols) -> (..., cols, width): x transposed, contiguous,
    with zero columns past ``rows`` (``width`` defaults to ``rows``)."""
    rows = x.shape[-2]
    width = rows if width is None else width
    return torch.nn.functional.pad(x.transpose(-1, -2), (0, width - rows)).contiguous()


def transpose_int8(x, width=None):
    """``plain_transpose_int8``'s function for a (rows, cols) or (batch,
    rows, cols) int8 tensor with a unit last stride.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if not x.is_cuda:
        return plain_transpose_int8(x, width)
    rows, cols = x.shape[-2:]
    width = rows if width is None else width
    if x.dtype != torch.int8 or x.dim() not in (2, 3):
        raise ValueError(f"transpose_int8 takes a 2-D or 3-D int8 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if cols % 16 or width % 16 or width < rows:
        raise ValueError(f"transpose_int8 takes cols and width multiples of 16, width >= rows; "
                         f"got {rows}x{cols} to width {width}")
    x3 = x if x.dim() == 3 else x[None]
    if x3.stride(-1) != 1 or any(s % 16 for s in x3.stride()[:2]) or x3.data_ptr() % 16:
        raise ValueError(f"transpose_int8 needs a unit last stride, other strides multiple of 16 "
                         f"and 16-byte alignment; got strides {x.stride()}")
    out = torch.empty(x.shape[:-2] + (cols, width), device=x.device, dtype=torch.int8)
    build.launch("ccedit_transpose_int8", x3.data_ptr(), out.data_ptr(), x3.shape[0], rows, cols,
                 width, x3.stride(0), x3.stride(1), build.stream_of(x))
    transpose_int8.launches += 1
    return out


transpose_int8.launches = 0


def gemm(a, b):
    """Kernel 6: (M, K) @ (K, N), row-major, int8 -> int32 or bf16 -> fp32;
    for int8, B is transposed first (``transpose_int8``, looked up at each
    call) and the kernel reads B^T.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if not a.is_cuda:
        return plain_gemm(a, b)
    int8 = a.dtype == torch.int8
    if a.dtype not in (torch.int8, torch.bfloat16) or b.dtype != a.dtype:
        raise ValueError(f"gemm takes int8 or bf16 operands, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mismatched shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()) or b.device != a.device:
        raise ValueError("gemm takes contiguous row-major operands on one device")
    (m, k), n = a.shape, b.shape[1]
    if m % 128 or n % 128 or k % (64 if int8 else 32):
        raise ValueError(f"gemm takes M, N % 128 == 0 and K % {64 if int8 else 32} == 0, "
                         f"got {m}x{k}x{n}")
    c = torch.empty((m, n), device=a.device, dtype=torch.int32 if int8 else torch.float32)
    if int8:  # 8-bit wgmma reads only K-major operands: B^T (N, K)
        b = transpose_int8(b)
    build.launch("ccedit_gemm", int(int8), a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                 build.stream_of(a))
    gemm.launches += 1
    gemm.variant_launches[f"{'int8' if int8 else 'bf16'} {m}x{k}x{n}"] += 1
    return c


gemm.launches = 0
gemm.variant_launches = collections.Counter()


def gemm_bound(m: int, k: int, n: int, int8: bool) -> dict:
    ops = 2.0 * m * n * k
    return roofline.bound(bf16_flops=0.0 if int8 else ops, int8_ops=ops if int8 else 0.0,
                          nbytes=(1 if int8 else 2) * (m * k + k * n) + 4.0 * m * n)


def operands(m: int, k: int, n: int, int8: bool, device, seed: int = 0):
    """Seeded operands: int8 uniform in [-127, 127) as the JAX probe draws
    them, bf16 standard normal."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if int8:
        return tuple(torch.randint(-127, 127, shape, generator=gen, device=device,
                                   dtype=torch.int8) for shape in ((m, k), (k, n)))
    return tuple(torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                 for shape in ((m, k), (k, n)))


def part_kernel(device, iters: int) -> list:
    """Kernel 6 at each shape and type: its error against ``plain_gemm``
    (``ok``: the int8 product exact, the bf16 one within BF16_TOLERANCE of
    max|plain|), its time beside its bound, the plain version's and that of
    the PyTorch call for the same product; for int8 also the device time of
    B's transposition alone (``transpose_ms``, part of ``ms``; from a CUDA
    graph, since its wrapper's host time exceeds it)."""
    out = []
    for m, k, n in SHAPES:
        for int8 in (True, False):
            a, b = operands(m, k, n, int8, device)
            c, ref = gemm(a, b).double(), plain_gemm(a, b).double()
            err = (c - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            del c, ref
            ms = roofline.cuda_time_ms(lambda: gemm(a, b), iters)
            lib = (lambda: torch._int_mm(a, b)) if int8 else (lambda: torch.matmul(a, b))
            extra = {"transpose_ms": roofline.cuda_graph_time_ms(lambda: transpose_int8(b), iters)
                     } if int8 else {}
            out.append(dict(variant=f"{'int8' if int8 else 'bf16'} {m}x{k}x{n}", ms=ms, **extra,
                            max_abs_err=err, max_rel_err=rel,
                            ok=err == 0 if int8 else rel <= BF16_TOLERANCE,
                            plain_ms=roofline.cuda_time_ms(lambda: plain_gemm(a, b), 3),
                            library_ms=roofline.cuda_time_ms(lib, iters),
                            library="torch._int_mm" if int8 else "torch.matmul",
                            tops=2.0 * m * n * k / ms / 1e9, **gemm_bound(m, k, n, int8)))
    return out


def part_peak(device, iters: int) -> list:
    """PyTorch's products at 4096^3 (library yardsticks)."""
    n = 4096
    a8, b8 = operands(n, n, n, True, device)
    abf, bbf = operands(n, n, n, False, device)
    ops = 2.0 * n ** 3
    calls = (("bf16 4096^3 torch.matmul", lambda: torch.matmul(abf, bbf)),
             ("int8 4096^3 -> int32 torch._int_mm", lambda: torch._int_mm(a8, b8)),
             ("bf16 x int8 4096^3 (int8 cast in-graph) torch.matmul",
              lambda: torch.matmul(abf, b8.to(torch.bfloat16))))
    return [dict(call=name, ms=(ms := roofline.cuda_time_ms(fn, iters)), tops=ops / ms / 1e9)
            for name, fn in calls]


def part_qkt(device, iters: int) -> list:
    """The attention QK^T shape (272, 6144, K) @ (272, K, 6144) in bf16
    through ``torch.matmul`` (bf16 scores: PyTorch has no bf16 -> fp32
    batched product); PyTorch has no batched int8 product."""
    out = []
    for k in (40, 128):
        gen = torch.Generator(device=device).manual_seed(k)
        q = torch.randn((272, 6144, k), generator=gen, device=device).to(torch.bfloat16)
        ms = roofline.cuda_time_ms(lambda: torch.matmul(q, q.transpose(1, 2)), iters)
        out.append(dict(call=f"bf16 K={k} torch.matmul (bf16 scores)", ms=ms,
                        tops=2.0 * 272 * 6144 * 6144 * k / ms / 1e9))
        out.append(dict(call=f"int8 K={k} -> int32", ms=None,
                        note="PyTorch has no batched int8 product"))
        del q
        torch.cuda.empty_cache()
    return out


def part_conv(device, iters: int) -> list:
    """The level-0 ResBlock conv3x3 (34, 320, 64, 96) in bf16 through
    cuDNN (``conv2d``); PyTorch has no int8 convolution on CUDA."""
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((34, 320, 64, 96), generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn((320, 320, 3, 3), generator=gen, device=device).to(torch.bfloat16)
    ms = roofline.cuda_time_ms(lambda: torch.nn.functional.conv2d(x, w, padding=1), iters)
    ops = 2.0 * 34 * 64 * 96 * 320 * 320 * 9
    return [dict(call="bf16 conv3x3 conv2d", ms=ms, tops=ops / ms / 1e9),
            dict(call="int8 conv3x3 -> int32", ms=None,
                 note="PyTorch has no int8 convolution on CUDA")]


PARTS = {"peak": part_peak, "qkt": part_qkt, "conv": part_conv, "kernel": part_kernel}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parts", nargs="*", help=f"any of {sorted(PARTS)} (default: all)")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args(argv)
    if set(a.parts) - set(PARTS):
        ap.error(f"unknown parts {sorted(set(a.parts) - set(PARTS))}; choose from {sorted(PARTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("int8_probe needs a CUDA device")
    device = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"gpu": smi}
    for part in a.parts or ("peak", "qkt", "conv", "kernel"):
        result[part] = PARTS[part](device, a.iters)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
