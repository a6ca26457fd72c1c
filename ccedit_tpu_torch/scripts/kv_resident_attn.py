"""Kernel 5: probes that split kernel 1's time into its phases, on one GPU.

    python -m ccedit_tpu_torch.scripts.kv_resident_attn [d40] [d64]

Port of ``scripts/kv_resident_attn.py``: its seven Pallas kernels
(``make_call`` qkt / softmax / full in the (B, N, D) layout,
``make_tr_call`` qkt / full in the (B, D, N) layout, ``make_tr8_call`` qkt /
full on int8 q and k with one per-tensor scale each) are instantiations of
kernel 1's own Hopper template (``csrc/spatial_attention.cuh``, stopped
after a stage, in one of two layouts; ``csrc/attention_probe.cu``), at the
same B, N, D = 272, 6144, 40 (34 clips x 8 heads, kernel 1's level-0 shape).
The tr int8 variants first turn q8^T and k8^T into kernel 1c's (B, N, 48)
rows (``int8_probe.transpose_int8``, inside the call). The script runs each
variant once at that shape, holds its first rows to ``plain_probe``
(``compare``), times it beside its bound, its plain version and the PyTorch
call for the same function (where one exists), times kernel 1 (exact and
int8, 1c) on the same q, k, v, and prints one JSON line: qkt's time is
kernel 1's QK^T phase with its loads, softmax minus qkt the online softmax,
full minus softmax the P.V product, and full plain bf16 over kernel 1 (one
design now) should be 1. The TPU scripts' compile cache and ``fori_loop``
slope timing are TPU scaffolding and are not ported: CUDA events time the
launches.

``d64`` runs the three plain-layout variants (qkt, softmax, full) at head_dim
64, SD-2.x's heads, at SD-2.1-768's levels 0 and 1 as (B*H, N, 64) =
(10, 9216, 64) and (20, 2304, 64) (``D64_SHAPES``), each held to
``plain_probe`` on its first rows, with kernel 1 (exact and 1c) and SDPA on
the same tensors as (2, H, N, 64), both contiguous and as the head-split
view of a (2, N, H*64) projection (the model's layout: each token's 128-byte
row a head stride apart), one JSON line a shape.

``probe`` is the wrapper (a CPU tensor takes ``plain_probe``, a CUDA tensor
launches the kernel or raises); ``probe.launches`` and
``probe.variant_launches`` count its launches.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import math
import subprocess

import torch

from ..ops import build
from . import roofline
from .int8_probe import transpose_int8

B, N, D = 272, 6144, 40
INT8_WIDTH = 48  # kernel 1c's int8 row: D rounded up to 16 bytes
SCALE = D ** -0.5
# head_dim 64: (batch, heads, tokens) of SD-2.1-768's levels 0 and 1 (CFG
# batch 2); the probes run at (batch * heads, tokens, 64)
D64 = 64
D64_SHAPES = ((2, 5, 9216), (2, 10, 2304))
D64_VARIANTS = (("qkt", False, False), ("softmax", False, False), ("full", False, False))
_LOG2E = 1.0 / math.log(2.0)
_STAGES = {"qkt": 0, "softmax": 1, "full": 2}
# (stage, transposed layout, int8 q/k): the seven pallas_calls
VARIANTS = (("qkt", False, False), ("softmax", False, False), ("full", False, False),
            ("qkt", True, False), ("full", True, False),
            ("qkt", True, True), ("full", True, True))
# where each variant's TPU kernel is (scripts/kv_resident_attn.py)
REPLACES = {("qkt", False, False): ":195", ("softmax", False, False): ":201",
            ("full", False, False): ":206", ("qkt", True, False): ":177",
            ("full", True, False): ":182", ("qkt", True, True): ":156",
            ("full", True, True): ":162"}
# row sums: max|err| / max|plain| (fp32 sums of N terms in another order;
# the bf16 or int8 products are exact in fp32)
ROWSUM_TOLERANCE = 1e-3
# full: max|err| / max|plain| and cosine.  The sound error is the bf16
# rounding of o and of P, ~2^-9 of |o| each (a CPU emulation at N = 6144:
# 2.4e-3 and 1 - 3e-6); the softmax temperature off by ln 2 (log2 e left
# out of the exp2 scale) gives 0.67 and 0.955
FULL_TOLERANCE = 2e-2
FULL_COSINE = 0.9999
COMPARE_ROWS = 4  # of the 272: the plain version's fp32 scores fit


def variant_name(stage: str, transposed: bool, int8: bool) -> str:
    return f"{stage} {'tr' if transposed else 'plain'} {'int8' if int8 else 'bf16'}"


def quantize_per_tensor(x):
    """``run_int8``'s per-tensor symmetric int8: (scale s = max|x| / 127 as a
    host float, round(x / s) clipped to +-127)."""
    s = float(x.float().abs().max()) / 127.0
    return s, torch.round(x.float() / s).clamp(-127, 127).to(torch.int8)


def plain_probe(stage: str, q, k, v=None, scale: float = SCALE, transposed: bool = False):
    """The probes' plain version.  q and k (and v for full) are (B, N, D),
    or (B, D, N) when ``transposed``; ``scale`` is the whole logits scale
    (SCALE, or sq * sk * SCALE for int8 q and k).  qkt: the row sums of the
    raw scores; softmax: the row sums of exp(s * scale - rowmax), both (B,
    N) fp32; full: normalised attention in v's dtype and q's layout."""
    if transposed:
        q, k = q.transpose(1, 2), k.transpose(1, 2)
        v = None if v is None else v.transpose(1, 2)
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if stage == "qkt":
        return s.sum(-1)
    s = s * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)
    if stage == "softmax":
        return l
    o = (torch.matmul(p.to(v.dtype).float(), v.float()) / l[..., None]).to(v.dtype)
    return o.transpose(1, 2) if transposed else o


def compare(stage: str, out, ref) -> dict:
    """A probe's output against its plain version: max|err|, max|err| /
    max|plain|, cosine, and whether they pass the stage's limits."""
    out, ref = out.double(), ref.double()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    cos = (out.flatten() @ ref.flatten() / (out.norm() * ref.norm())).item()
    finite = bool(torch.isfinite(out).all())
    if stage == "full":
        ok = rel <= FULL_TOLERANCE and cos >= FULL_COSINE
    else:
        ok = rel <= ROWSUM_TOLERANCE
    return dict(max_abs_err=err, max_rel_err=rel, cosine=cos, ok=finite and ok)


def _layout(x, transposed: bool):
    """(batch, token, d) element strides of a probe operand."""
    s0, s1, s2 = x.stride()
    return (s0, s2, s1) if transposed else (s0, s1, s2)


def _check(name: str, x, dtype, shape, transposed: bool, device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must lie on {device}, got {x.device}")
    vec = 16 // x.element_size()
    # the unit-stride axis is d in the plain layout, the tokens in the tr one
    if x.stride(-1) != 1 or any(st % vec for st in x.stride()[:2]) or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit last stride, other strides multiple of "
                         f"{vec} and 16-byte alignment; got strides {x.stride()}")


def probe(stage: str, q, k, v=None, scale: float = SCALE, transposed: bool = False):
    """Kernel 5 (``plain_probe``'s function).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (int8: after the transposition
    of q and k) or raises."""
    if not q.is_cuda:
        return plain_probe(stage, q, k, v, scale, transposed)
    int8 = q.dtype == torch.int8
    if (stage, transposed, int8) not in VARIANTS:
        raise ValueError(f"no probe {variant_name(stage, transposed, int8)}")
    shape = tuple(q.shape)
    b, n, d = (shape[0], shape[2], shape[1]) if transposed else shape
    if d not in (D, D64) or n % 64:
        raise ValueError(f"the probes take head_dim {D} or {D64} and N % 64 == 0, got {shape}")
    if d == D64 and (stage, transposed, int8) not in D64_VARIANTS:
        raise ValueError(f"no probe {variant_name(stage, transposed, int8)} at head_dim {D64}")
    _check("q", q, q.dtype, shape, transposed, q.device)
    _check("k", k, q.dtype, shape, transposed, q.device)
    if stage == "full":
        _check("v", v, torch.bfloat16, shape, transposed, q.device)
        out = torch.empty(shape, device=q.device, dtype=torch.bfloat16)
        out_layout = _layout(out, transposed)
    else:
        v = q  # not read
        out = torch.empty((b, n), device=q.device, dtype=torch.float32)
        out_layout = (n, 1, 0)
    qk_layout = transposed
    if int8:  # 8-bit wgmma reads only K-major operands: kernel 1c's (B, N, 48) rows
        q, k = (transpose_int8(x, INT8_WIDTH) for x in (q, k))
        qk_layout = False
    layouts = _layout(q, qk_layout) + _layout(k, qk_layout) + (
        _layout(v, transposed) if stage == "full" else (0, 0, 0)) + out_layout
    build.launch("ccedit_attention_probe", _STAGES[stage], int(int8), int(transposed),
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, d,
                 (ctypes.c_longlong * 12)(*layouts), float(scale) * _LOG2E,
                 build.stream_of(q))
    probe.launches += 1
    probe.variant_launches[variant_name(stage, transposed, int8)
                           + ("" if d == D else f" d{d}")] += 1
    return out


probe.launches = 0
probe.variant_launches = collections.Counter()


def probe_bound(stage: str, int8: bool, b: int = B, n: int = N, d: int = D) -> dict:
    """The least time of a probe's work: its products (QK^T in int8 for
    int8 q/k), one exp2 a score past qkt, q and k (and v) read once, the row
    sums or o written once."""
    product = 2.0 * b * n * n * d
    qk_bytes = (1 if int8 else 2) * 2.0 * b * n * d
    if stage == "qkt":
        return roofline.bound(bf16_flops=0.0 if int8 else product,
                              int8_ops=product if int8 else 0.0, nbytes=qk_bytes + 4.0 * b * n)
    if stage == "softmax":
        return roofline.bound(bf16_flops=product, exps=float(b * n * n),
                              nbytes=qk_bytes + 4.0 * b * n)
    return roofline.bound(bf16_flops=product * (1 if int8 else 2),
                          int8_ops=product if int8 else 0.0, exps=float(b * n * n),
                          nbytes=qk_bytes + 2.0 * 2 * b * n * d)


def library_ms(x: dict, stage: str, transposed: bool, int8: bool, iters: int,
               scale: float = SCALE):
    """The time of the one PyTorch call that computes a variant's function
    on the same inputs, a yardstick the port never calls, and that call's
    name; (None, why) where there is none.  The bf16 qkt row sums are one
    ``torch.einsum`` (which sums k over its tokens before the product);
    full is SDPA on the (B, 1, N, D) bf16 q, k, v (for int8 q and k, on
    their bf16 originals)."""
    if stage == "qkt" and not int8:
        q, k = (x["qt"], x["kt"]) if transposed else (x["q"], x["k"])
        eq = "bdn,bdm->bn" if transposed else "bnd,bmd->bn"
        return roofline.cuda_time_ms(lambda: torch.einsum(eq, q, k), iters), (
            f"torch.einsum('{eq}')")
    if stage == "full":
        ms, backend = roofline.sdpa_ms(*(x[n][:, None] for n in ("q", "k", "v")), scale, iters)
        return ms, f"scaled_dot_product_attention [{backend}] on the (B, 1, N, D) bf16 inputs"
    if stage == "softmax":
        return None, "none: no single PyTorch call gives the row sums of exp(s - rowmax)"
    return None, "none: PyTorch has no batched int8 product on CUDA"


def inputs(device, seed: int = 0, b: int = B, n: int = N, d: int = D):
    """Seeded bf16 q, k, v (b, n, d), their (b, d, n) copies and the
    per-tensor int8 q and k of the transposed copies with their scales."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, n, d), generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sq, q8 = quantize_per_tensor(qt)
    sk, k8 = quantize_per_tensor(kt)
    return dict(q=q, k=k, v=v, qt=qt, kt=kt, vt=vt, q8=q8, k8=k8, sq=sq, sk=sk)


def call_args(x: dict, stage: str, transposed: bool, int8: bool):
    """The probe's (q, k, v, scale, transposed) for one variant on
    ``inputs``' tensors (the scale head_dim^-0.5)."""
    scale = x["q"].shape[-1] ** -0.5
    if int8:
        return x["q8"], x["k8"], x["vt"], x["sq"] * x["sk"] * scale, True
    if transposed:
        return x["qt"], x["kt"], x["vt"], scale, True
    return x["q"], x["k"], x["v"], scale, False


def run(device, iters: int = 5, b: int = B, n: int = N, rows: int = COMPARE_ROWS) -> dict:
    """Every variant at (b, n, D) on the same seeded inputs: its output's
    first ``rows`` rows against ``plain_probe`` (``compare``), its time at
    the full shape beside its bound and the library call, its and the plain
    version's time on those rows; then kernel 1 (exact and 1c) on the same
    inputs as (b / 8, 8, n, D): at the default (34, 8, 6144, 40), its
    level-0 shape; and the qkt probe on q and k rows 128 bytes apart beside
    its time on the contiguous 80-byte rows (``qkt_by_row_pitch_ms``)."""
    from ..ops import spatial_attention as sa

    x = inputs(device, b=b, n=n)
    records = []
    for stage, transposed, int8 in VARIANTS:
        q, k, v, scale, tr = call_args(x, stage, transposed, int8)
        part = (q[:rows], k[:rows], v[:rows], scale, tr)
        out = probe(stage, q, k, v, scale, tr)
        checked = compare(stage, out[:rows], plain_probe(stage, *part))
        del out
        ms = roofline.cuda_time_ms(lambda: probe(stage, q, k, v, scale, tr), iters)
        lib_ms, library = library_ms(x, stage, transposed, int8, iters)
        records.append(dict(
            variant=variant_name(stage, transposed, int8), ms=ms,
            compared_ms=roofline.cuda_time_ms(lambda: probe(stage, *part), iters),
            plain_ms=roofline.cuda_time_ms(lambda: plain_probe(stage, *part), max(iters // 2, 1)),
            plain_shape=[rows] + list(q.shape[1:]), library_ms=lib_ms, library=library,
            **checked, **probe_bound(stage, int8, b, n)))
    # the qkt probe again on rows 128 bytes apart (the first D columns of
    # (b, n, 64) tensors): the same TMA box rows a key tile as on the
    # contiguous 80-byte rows, a third more bytes
    wide = [torch.zeros((b, n, 64), device=device, dtype=torch.bfloat16) for _ in range(2)]
    for w, name in zip(wide, ("q", "k")):
        w[..., :D] = x[name]
    qw, kw = (w[..., :D] for w in wide)
    qkt_by_row_pitch = {"80": records[0]["ms"],
                        "128": roofline.cuda_time_ms(lambda: probe("qkt", qw, kw), iters)}
    del wide, qw, kw
    heads = (b // 8, 8, n, D)
    q4, k4, v4 = (x[name].view(heads) for name in ("q", "k", "v"))
    kernel1 = {quant: roofline.cuda_time_ms(
        lambda: sa.kv_resident_attention(q4, k4, v4, SCALE, quantized_qk=quant), iters)
        for quant in (False, True)}
    ms = {r["variant"]: r["ms"] for r in records}
    split = {"qk^T": ms["qkt plain bf16"],
             "softmax": ms["softmax plain bf16"] - ms["qkt plain bf16"],
             "p.v and output": ms["full plain bf16"] - ms["softmax plain bf16"]}
    return dict(shape=[b, n, D], variants=records, kernel1_ms=kernel1[False],
                kernel1_int8_ms=kernel1[True], kernel1_split_ms=split,
                full_over_kernel1=ms["full plain bf16"] / kernel1[False],
                qkt_by_row_pitch_ms=qkt_by_row_pitch)


def head_split(x, heads: int):
    """A contiguous (B * heads, N, d) probe operand as (B, heads, N, d) in the
    model's layout: the head-split view of a (B, N, heads * d) projection
    holding the same values."""
    bh, n, d = x.shape
    y = torch.empty((bh // heads, n, heads, d), device=x.device, dtype=x.dtype)
    y.copy_(x.view(bh // heads, heads, n, d).transpose(1, 2))
    return y.transpose(1, 2)


def run_d64(device, iters: int = 5, rows: int = COMPARE_ROWS) -> list:
    """The plain-layout variants at head_dim 64 at each of ``D64_SHAPES``
    (as (batch * heads, N, 64)): each one's first ``rows`` rows against
    ``plain_probe``, its time beside its bound and library call, then
    kernel 1 (exact and 1c) and SDPA on the same values as (batch, heads,
    N, 64), contiguous and head-split (``head_split``), and kernel 1's
    split.  One record a shape."""
    from ..ops import spatial_attention as sa

    out = []
    for batch, heads, n in D64_SHAPES:
        b = batch * heads
        x = inputs(device, b=b, n=n, d=D64)
        scale = D64 ** -0.5
        records = []
        for stage, transposed, int8 in D64_VARIANTS:
            q, k, v, _, _ = call_args(x, stage, transposed, int8)
            part = (q[:rows], k[:rows], v[:rows], scale, False)
            checked = compare(stage, probe(stage, q, k, v, scale)[:rows], plain_probe(stage, *part))
            ms = roofline.cuda_time_ms(lambda: probe(stage, q, k, v, scale), iters)
            lib_ms, library = library_ms(x, stage, transposed, int8, iters, scale)
            records.append(dict(
                variant=variant_name(stage, transposed, int8), ms=ms,
                compared_ms=roofline.cuda_time_ms(lambda: probe(stage, *part), iters),
                plain_ms=roofline.cuda_time_ms(lambda: plain_probe(stage, *part),
                                               max(iters // 2, 1)),
                plain_shape=[rows, n, D64], library_ms=lib_ms, library=library,
                **checked, **probe_bound(stage, int8, b, n, D64)))
        shape = (batch, heads, n, D64)
        layouts = {"contiguous": tuple(x[name].view(shape) for name in ("q", "k", "v")),
                   "head-split": tuple(head_split(x[name], heads) for name in ("q", "k", "v"))}
        kernel1 = {f"{quant} {name}": roofline.cuda_time_ms(
            lambda: sa.kv_resident_attention(*qkv, scale, quantized_qk=quant == "int8"), iters)
            for name, qkv in layouts.items() for quant in ("exact", "int8")}
        sdpa = {name: roofline.sdpa_ms(*qkv, scale, iters)[0] for name, qkv in layouts.items()}
        del layouts
        ms = {r["variant"]: r["ms"] for r in records}
        split = {"qk^T": ms["qkt plain bf16"],
                 "softmax": ms["softmax plain bf16"] - ms["qkt plain bf16"],
                 "p.v and output": ms["full plain bf16"] - ms["softmax plain bf16"]}
        out.append(dict(shape=list(shape), probe_shape=[b, n, D64], variants=records,
                        kernel1_ms=kernel1, library_ms=sdpa, kernel1_split_ms=split,
                        full_over_kernel1=ms["full plain bf16"] / kernel1["exact contiguous"],
                        **{f"kernel1_{k}": v for k, v in
                           roofline.attention_bound(batch, heads, n, n, D64).items()}))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parts", nargs="*", choices=("d40", "d64"))
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kv_resident_attn needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    parts = set(a.parts) or {"d40"}
    device = torch.device("cuda:0")
    if "d40" in parts:
        print(json.dumps(dict(gpu=smi, part="d40", **run(device, a.iters))), flush=True)
    if "d64" in parts:
        for record in run_d64(device, a.iters):
            print(json.dumps(dict(gpu=smi, part="d64", **record)), flush=True)


if __name__ == "__main__":
    main()
