"""The H100's published peaks, the least time a kernel's work could take on
it, and the CUDA-event timing shared by ``chip_smoke.py`` and the probe
scripts.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the 700 W power limit): 989
TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s of HBM; exp2 at ~3.9 T/s on the
special-function units (16 a clock on each of 132 SMs at ~1.83 GHz, the
figure of the FlashAttention-3 paper, section 3).  A bound is the largest
of the tensor time, the exponential time and the time to move each input
once and write each output once.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
EXP2_PER_S = 3.9e12
HBM_BYTES_PER_S = 3.35e12


def bound(bf16_flops: float = 0.0, int8_ops: float = 0.0, exps: float = 0.0,
          nbytes: float = 0.0) -> dict:
    """``bound_ms`` (the largest of the three times), ``bound_by`` ("bytes"
    or "operations") and ``bound_what`` ("tensor", "exp" or "bytes")."""
    times = {"tensor": (bf16_flops / BF16_FLOPS + int8_ops / INT8_OPS) * 1e3,
             "exp": exps / EXP2_PER_S * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    what = max(times, key=times.get)
    return dict(bound_ms=times[what], bound_by="bytes" if what == "bytes" else "operations",
                bound_what=what)


def attention_bound(b: int, h: int, n_q: int, n_k: int, d: int, qk_int8: bool = False,
                    backward: bool = False) -> dict:
    """Softmax attention over (b, h, n_q | n_k, d) bf16 operands: QK^T and
    P.V (QK^T in int8 with ``qk_int8``), one exp2 a score, q, k, v read and
    o written.  ``backward``: the five products of the flash backward (S
    recomputed, dV, dP, dQ, dK), one exp2 a score, q, k, v, o, dO read and
    dQ, dK, dV written."""
    product = 2.0 * b * h * n_q * n_k * d
    exps = float(b * h * n_q * n_k)
    if backward:
        return bound(bf16_flops=5 * product, exps=exps,
                     nbytes=2.0 * b * h * d * (4 * n_q + 4 * n_k))
    return bound(bf16_flops=product * (1 if qk_int8 else 2), int8_ops=product if qk_int8 else 0.0,
                 exps=exps, nbytes=2.0 * b * h * d * (2 * n_q + 2 * n_k))


def cuda_time_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_backend(q, k, v, scale: float) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0, False, scale=scale)).name
    except (AttributeError, TypeError, ValueError, RuntimeError):
        return "unknown"


def sdpa_ms(q, k, v, scale: float, iters: int, grad_out: Optional[torch.Tensor] = None,
            backward_only: bool = False) -> Tuple[Optional[float], str]:
    """The time of PyTorch's own ``scaled_dot_product_attention`` on these
    inputs (forward, or forward and backward given ``grad_out``; with
    ``backward_only`` as well, the backward alone: one forward kept with
    ``retain_graph``, then only ``torch.autograd.grad`` timed), and the
    backend it took: a yardstick beside a kernel, never called by the port.
    (None, "out of memory") where it does not fit beside the caller's
    tensors."""
    import torch.nn.functional as F

    try:
        if grad_out is None:
            backend = sdpa_backend(q, k, v, scale)
            with torch.no_grad():
                ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                                  iters)
            return ms, backend
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        backend = sdpa_backend(qg, kg, vg, scale)
        if backward_only:
            out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            ms = cuda_time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), grad_out,
                                                          retain_graph=True), iters)
            return ms, backend

        def step():
            out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            torch.autograd.grad(out, (qg, kg, vg), grad_out)

        return cuda_time_ms(step, iters), backend
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None, "out of memory"
