"""Kernel 5: probes that split kernel 1's time into its phases, on one GPU.

    python -m ccedit_tpu_torch.scripts.kv_resident_attn

Port of ``scripts/kv_resident_attn.py``: its seven Pallas kernels
(``make_call`` qkt / softmax / full in the (B, N, D) layout, ``make_tr_call``
qkt / full in the (B, D, N) layout, ``make_tr8_call`` qkt / full on int8 q
and k with one per-tensor scale each) are one templated CUDA kernel,
``csrc/attention_probe.cu``, at the same B, N, D = 272, 6144, 40 (34 clips x
8 heads, kernel 1's level-0 shape).  The script runs each variant once at
that shape, holds its first rows to ``plain_probe`` (``compare``), times it
beside its bound, its plain version and the PyTorch call for the same
function (where one exists), times kernel 1 (exact and int8, 1c) on the
same q, k, v, and prints one JSON line: qkt's time is kernel 1's QK^T phase
with its staging, softmax - qkt the online softmax, full - softmax the P.V
product.  The TPU scripts' compile cache and ``fori_loop`` slope timing are
TPU scaffolding and are not ported: CUDA events time the launches.

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

B, N, D = 272, 6144, 40
SCALE = D ** -0.5
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
    version; a CUDA tensor launches the kernel or raises."""
    if not q.is_cuda:
        return plain_probe(stage, q, k, v, scale, transposed)
    int8 = q.dtype == torch.int8
    if (stage, transposed, int8) not in VARIANTS:
        raise ValueError(f"no probe {variant_name(stage, transposed, int8)}")
    shape = tuple(q.shape)
    b, n, d = (shape[0], shape[2], shape[1]) if transposed else shape
    if d != D or n % 64:
        raise ValueError(f"the probes take head_dim {D} and N % 64 == 0, got {shape}")
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
    layouts = _layout(q, transposed) + _layout(k, transposed) + (
        _layout(v, transposed) if stage == "full" else (0, 0, 0)) + out_layout
    build.launch("ccedit_attention_probe", _STAGES[stage], int(int8), int(transposed),
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n,
                 (ctypes.c_longlong * 12)(*layouts), float(scale) * _LOG2E,
                 build.stream_of(q))
    probe.launches += 1
    probe.variant_launches[variant_name(stage, transposed, int8)] += 1
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


def library_ms(x: dict, stage: str, transposed: bool, int8: bool, iters: int):
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
        ms, backend = roofline.sdpa_ms(*(x[n][:, None] for n in ("q", "k", "v")), SCALE, iters)
        return ms, f"scaled_dot_product_attention [{backend}] on the (B, 1, N, D) bf16 inputs"
    if stage == "softmax":
        return None, "none: no single PyTorch call gives the row sums of exp(s - rowmax)"
    return None, "none: PyTorch has no batched int8 product on CUDA"


def inputs(device, seed: int = 0, b: int = B, n: int = N):
    """Seeded bf16 q, k, v (b, n, D), their (b, D, n) copies and the
    per-tensor int8 q and k of the transposed copies with their scales."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, n, D), generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sq, q8 = quantize_per_tensor(qt)
    sk, k8 = quantize_per_tensor(kt)
    return dict(q=q, k=k, v=v, qt=qt, kt=kt, vt=vt, q8=q8, k8=k8, sq=sq, sk=sk)


def call_args(x: dict, stage: str, transposed: bool, int8: bool):
    """The probe's (q, k, v, scale, transposed) for one variant on
    ``inputs``' tensors."""
    if int8:
        return x["q8"], x["k8"], x["vt"], x["sq"] * x["sk"] * SCALE, True
    if transposed:
        return x["qt"], x["kt"], x["vt"], SCALE, True
    return x["q"], x["k"], x["v"], SCALE, False


def run(device, iters: int = 5, b: int = B, n: int = N, rows: int = COMPARE_ROWS) -> dict:
    """Every variant at (b, n, D) on the same seeded inputs: its output's
    first ``rows`` rows against ``plain_probe`` (``compare``), its time at
    the full shape beside its bound and the library call, its and the plain
    version's time on those rows; then kernel 1 (exact and 1c) on the same
    inputs as (b / 8, 8, n, D): at the default (34, 8, 6144, 40), its
    level-0 shape."""
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
                kernel1_int8_ms=kernel1[True], kernel1_split_ms=split)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kv_resident_attn needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(gpu=smi, **run(torch.device("cuda:0"), a.iters))))


if __name__ == "__main__":
    main()
