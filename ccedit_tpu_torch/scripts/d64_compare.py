"""Kernels 1, 1c and 4 at head_dim 64 against another tree's, on one GPU.

    python -m ccedit_tpu_torch.scripts.d64_compare [OTHER_CSRC ...] [--variants]

Builds this checkout's kernel library and one from each ``OTHER_CSRC`` (for
instance the parent commit's ``ccedit_tpu_torch/csrc``, unpacked with ``git
archive`` into ``build/``), then times, at the shapes of ``PERF.md``'s d =
64 rows, each library's kernel in turns (``ROUNDS`` rounds, the order flipped
every round) on the same tensors, through this tree's wrappers:

* kernel 1 at SD-2.1-768's three levels, (2, 5, 9216, 64), (2, 10, 2304,
  64) and the ragged (2, 20, 576, 64);
* kernel 1c with its pre-pass at the two the JAX gate quantizes;
* kernel 4 (its three launches) at (2, 10, 2304, 64), (2, 5, 9216, 64),
  the ragged (2, 20, 576, 64) and (2, 8, 600, 64).

``--variants`` adds patched copies of this tree's d = 64 design, each a
library of its own timed the same way (``VARIANTS``): ``bm128`` (kernels 1
and 1c at 128 query rows a block at every shape), ``eager_rescale`` (O and
l rescaled on every tile, as at the other head dims), ``no_exp2`` (kernel
1's d = 64 softmax without its exponentials: wrong outputs, a timing
probe), ``float2_dq`` (kernel 4's dQ added two columns an atomic, as at
the other head dims), ``four_stages`` (kernel 4's ring at 4 stages, as at
d = 40).

Operands are the model's layout (the head-split view of a (B, N, H * 64)
projection).  Each line has every library's times and their median, its
output's largest difference from this tree's relative to this tree's
largest value, the bound (``scripts/roofline.py``) and PyTorch's own call
on the same tensors (SDPA, cuDNN where it takes them; for kernel 4 its
backward alone), one JSON line a shape with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import torch

from ..ops import build
from ..ops import spatial_attention as sa
from . import roofline

FORWARD = ((2, 5, 9216, 64), (2, 10, 2304, 64), (2, 20, 576, 64))
INT8 = ((2, 5, 9216, 64), (2, 10, 2304, 64))
BACKWARD = ((2, 10, 2304, 64), (2, 5, 9216, 64), (2, 20, 576, 64), (2, 8, 600, 64))
OUT = build.BUILD_DIR.parent / "d64_compare"
ROUNDS = 10  # of each library's timing, in alternating order
# the sources the d = 64 kernels build from, and the variants' substitutions
# in them (``patched``)
SOURCES = ("spatial_attention.cu", "spatial_attention_int8.cu", "quantize_qk.cu",
           "spatial_attention_bwd.cu")
_CUH, _BWD = "spatial_attention.cuh", "spatial_attention_bwd.cu"
VARIANTS = {
    "bm128": ((_CUH, "return static_cast<long long>(n_q + 191) / 192 * batch_heads >= sms ? 192 : 128;",
               "return 128;"),),
    "eager_rescale": ((_CUH, "kLazy = 8.f;", "kLazy = -INFINITY;"),),
    "no_exp2": tuple((_CUH, f"sc[i{o}] = ex2(fmaf(sc[i{o}], sl2, -m{r}));",
                      f"sc[i{o}] = fmaf(sc[i{o}], sl2, -m{r});")
                     for o, r in (("", 0), (" + 1", 0), (" + 2", 1), (" + 3", 1))),
    "float2_dq": ((_BWD, "dq_piece<D, true>(ds, s_k, row0, D);", "dq_piece<D, false>(ds, s_k, row0, D);"),
                  (_BWD, "2 * (T::kD64 ? t & ~1 : t);", "2 * t;")),
    "four_stages": ((_BWD, "(D == 64 ? 2 :", "(D == 64 ? 4 :"),),
}


def other_library(csrc: Path, name: str) -> ctypes.CDLL:
    """The kernel library built from another tree's ``csrc`` into
    ``OUT/name``, with this tree's C signatures."""
    saved = build.CSRC, build.BUILD_DIR
    build.CSRC, build.BUILD_DIR = csrc.resolve(), OUT / name
    try:
        path, _, _ = build.build()
    finally:
        build.CSRC, build.BUILD_DIR = saved
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.ccedit_error_string.argtypes = (ctypes.c_int,)
    lib.ccedit_error_string.restype = ctypes.c_char_p
    return lib


def patched(name: str) -> Path:
    """A copy of this tree's headers and ``SOURCES`` under ``OUT/name/csrc``
    with variant ``name``'s substitutions; each must apply."""
    d = OUT / name / "csrc"
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    for src in [*SOURCES, *(p.name for p in build.CSRC.glob("*.cuh"))]:
        shutil.copy(build.CSRC / src, d / src)
    for src, old, new in VARIANTS[name]:
        text = (d / src).read_text()
        if old not in text:
            raise ValueError(f"variant {name}: {old[:60]!r} is not in {src}")
        (d / src).write_text(text.replace(old, new))
    return d


def on(lib, fn):
    """``fn`` with ``build.launch`` reaching ``lib``."""
    def call():
        saved = build.library
        build.library = lambda: lib
        try:
            return fn()
        finally:
            build.library = saved
    return call


def operand(shape, gen, device):
    b, h, n, d = shape
    return (torch.randn((b, n, h, d), generator=gen, device=device)
            .to(torch.bfloat16).permute(0, 2, 1, 3))


def timed(libs: dict, fn, iters: int, rounds: int = ROUNDS) -> tuple:
    """{library: [ms of each round]}, the libraries timed in turns whose
    order flips every round (the others then this tree, this tree then the
    others reversed), and {library: largest output difference from this
    tree's / its largest value}."""
    outs = {name: on(lib, fn)() for name, lib in libs.items()}
    want = [x.float() for x in (outs["this"] if isinstance(outs["this"], tuple)
                                else (outs["this"],))]
    diff = {}
    for name, got in outs.items():
        got = got if isinstance(got, tuple) else (got,)
        diff[name] = max(((g.float() - w).abs().max() / w.abs().max()).item()
                         for g, w in zip(got, want))
    order = [n for n in libs if n != "this"] + ["this"]
    ms = {name: [] for name in libs}
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            ms[name].append(roofline.cuda_time_ms(on(libs[name], fn), iters))
    return ms, diff


def medians(ms: dict) -> dict:
    return {name: sorted(v)[len(v) // 2] for name, v in ms.items()}


def run(device, others: dict, iters: int = 100) -> list:
    libs = {**others, "this": build.library()}
    gen = torch.Generator(device=device).manual_seed(0)
    records = []
    for shape in FORWARD:
        q, k, v = (operand(shape, gen, device) for _ in range(3))
        scale = shape[-1] ** -0.5
        for quant in (False, True):
            if quant and shape not in INT8:
                continue
            ms, diff = timed(libs, lambda: sa.kv_resident_attention(q, k, v, scale,
                                                                    quantized_qk=quant), iters)
            lib_ms, backend = roofline.sdpa_ms(q, k, v, scale, iters)
            b, h, n, d = shape
            records.append(dict(kernel="1c with its pre-pass" if quant else "1", shape=list(shape),
                                ms=ms, median_ms=medians(ms), max_rel_diff=diff, library_ms=lib_ms,
                                library=f"scaled_dot_product_attention [{backend}]",
                                **roofline.attention_bound(b, h, n, n, d, qk_int8=quant)))
        del q, k, v
    for shape in BACKWARD:
        q, k, v, do = (operand(shape, gen, device) for _ in range(4))
        scale = shape[-1] ** -0.5
        b, h, n, d = shape
        lse = torch.empty((b * h, n), device=device)
        out = sa._forward(q, k, v, scale, lse)
        ms, diff = timed(libs, lambda: sa.spatial_attention_bwd(q, k, v, out, do, lse, scale),
                         iters)
        lib_ms, backend = roofline.sdpa_ms(q, k, v, scale, iters, grad_out=do,
                                           backward_only=True)
        records.append(dict(kernel="4", shape=list(shape), ms=ms, median_ms=medians(ms),
                            max_rel_diff=diff,
                            library_ms=lib_ms,
                            library=f"scaled_dot_product_attention backward [{backend}]",
                            **roofline.attention_bound(b, h, n, n, d, backward=True)))
        del q, k, v, do, out
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", type=Path, help="other trees' csrc directories")
    ap.add_argument("--variants", action="store_true", help="add the patched variants")
    ap.add_argument("--iters", type=int, default=100)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("d64_compare needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    others = {str(p): other_library(p, f"other{i}") for i, p in enumerate(a.others)}
    if a.variants:
        others.update({name: other_library(patched(name), name) for name in VARIANTS})
    for record in run(torch.device("cuda:0"), others, a.iters):
        print(json.dumps(dict(gpu=smi, **record)), flush=True)


if __name__ == "__main__":
    main()
