"""Build the CUDA kernels in ``csrc/`` with nvcc and bind them with ctypes.

The sources compile into one shared library with a plain C interface, for
``sm_90a`` (H100): one nvcc per source, all started together, then one
link.  The library goes to ``build/kernels/`` at the root of the checkout,
named by a hash of the sources, so an edited source rebuilds and an
unchanged one loads in milliseconds.  Nothing builds at import: the first
kernel launch (or ``chip_smoke.py``'s build phase) does.  Every failure
raises: a missing ``nvcc``, a compile error, a refused launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # q, k, v, o, lse, batch, heads, n_q, n_k, head_dim, strides, scale_log2, stream
    "ccedit_spatial_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES,
                                 ctypes.c_float, _P),
    # q8, k8, v, o, scales, batch, heads, n_q, n_k, head_dim, strides, stream
    "ccedit_spatial_attention_int8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _P),
    # q, k, q8, k8, amax, scales, batch, heads, n_q, n_k, head_dim, strides, scale, stream
    "ccedit_quantize_qk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES,
                           ctypes.c_float, _P),
    # stage, int8, transposed, q, k, v, out, batch, n, head_dim, strides, scale_log2, stream
    "ccedit_attention_probe": (_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _STRIDES,
                               ctypes.c_float, _P),
    # int8, a, b, c, m, n, k, stream
    "ccedit_gemm": (_I, _P, _P, _P, _I, _I, _I, _P),
    # src, dst, batch, rows, cols, width, batch stride, row stride, stream
    "ccedit_transpose_int8": (_P, _P, _I, _I, _I, _I, ctypes.c_longlong, ctypes.c_longlong, _P),
    # q, k, v, out, dout, lse, stats, dq_acc, dq, dk, dv, batch, heads, n_q, n_k,
    # head_dim, strides, scale_log2, scale, stream
    "ccedit_spatial_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _STRIDES, ctypes.c_float, ctypes.c_float,
                                     _P),
    # q, k, v, o, lse, batch, heads, n_q, n_k, head_dim, strides, scale_log2, stream
    "ccedit_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES,
                               ctypes.c_float, _P),
    # q, k, v, out, dout, lse, delta, dq, dk, dv, batch, heads, n_q, n_k, head_dim,
    # strides, scale_log2, scale, stream
    "ccedit_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _STRIDES, ctypes.c_float, ctypes.c_float, _P),
    # q, k, v, o, batch, heads, n_q, n_k, head_dim, bm, bn, strides, scale_log2, stream
    "ccedit_attention_tiles": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _STRIDES,
                               ctypes.c_float, _P),
    # q, k, v, o, batch, heads, T, head_dim, strides, scale, stream
    "ccedit_temporal_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _STRIDES,
                                  ctypes.c_float, _P),
    # fp32, per_row, stages, x, q, scales, amax, rows, groups, len, len_p, stream
    "ccedit_quantize_int8": (_I, _I, _I, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P),
    # s, p, c, groups, long long[2] out: (statistics block, workspace bytes)
    "ccedit_norm_quantize_plan": (ctypes.c_longlong, ctypes.c_longlong, _I, _I, _P),
    # x, add, gamma, beta, affine_fp32, ext_scale, ext_shift, s, p, c, groups, eps, q,
    # scale, workspace, third, fault, stage, stream
    "ccedit_norm_silu_quantize": (_P, _P, _P, _P, _I, _P, _P, ctypes.c_longlong,
                                  ctypes.c_longlong, _I, _I, ctypes.c_float, _P, _P, _P, _P, _I,
                                  _I, _P),
    # x, gamma, beta, affine_fp32, s, p, c, groups, eps, out, workspace, stream
    "ccedit_group_norm": (_P, _P, _P, _I, ctypes.c_longlong, ctypes.c_longlong, _I, _I,
                          ctypes.c_float, _P, _P, _P),
    # out_kind, a8, w8, out, sx, sw, bias, m, n, k, stream
    "ccedit_int8_gemm": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # out_kind, x, w8, out, sw, bias, q_out, sx_out, faults, m, n, k, stream
    "ccedit_int8_gemm_bf16a": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # k, n, int[5] out: the (bm, bn, resident, stages, fused) ccedit_int8_gemm takes
    "ccedit_int8_gemm_tiles": (_I, _I, _P),
    # out_kind, x8, w8, out, sx, sw, bias, batch, h, w, cp, o, kh, kw, sh, sw,
    # pad_top, pad_left, ho, wo, stream
    "ccedit_int8_conv": (_I, _P, _P, _P, _P, _P, _P) + (_I,) * 13 + (_P,),
    # the same, then bm, bn, chunk (an instantiated tile), stream
    "ccedit_int8_conv_tiled": (_I, _P, _P, _P, _P, _P, _P) + (_I,) * 16 + (_P,),
    # cp, o, int[3] out: the (bm, bn, chunk) ccedit_int8_conv takes
    "ccedit_int8_conv_tiles": (_I, _I, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libccedit_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernels unless the library for these sources exists.
    Returns (library path, build seconds, compiler output); ``verbose`` adds
    ``-Xptxas -v`` so the output lists each kernel's registers and spills."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    nvcc, compile_flags = _nvcc(), [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *compile_flags, *(("-Xptxas", "-v") if verbose else ()), "-c",
               "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{logs[-1]}")
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, path)
    return path, time.perf_counter() - t0, "".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, built on first use and loaded once."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ccedit_error_string.argtypes = (ctypes.c_int,)
    lib.ccedit_error_string.restype = ctypes.c_char_p
    return lib


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd will differentiate through an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_operand(name: str, x: torch.Tensor, dtype: torch.dtype, device) -> None:
    """A (B, H, N, D) kernel operand of ``dtype`` on ``device``: unit D
    stride, other strides whole 16-byte vectors, 16-byte aligned."""
    if x.dim() != 4:
        raise ValueError(f"{name} must be (B, H, N, D), got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on the GPU, got {x.dtype}")
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must lie on {device}, got {x.device}")
    vec = 16 // x.element_size()
    if x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a unit head_dim stride, other strides multiple "
            f"of {vec} and 16-byte alignment; got strides {x.stride()}")


def _strides(operands) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(operands)))(
        *[s for x in operands for s in x.stride()[:3]])


def attention_operand_strides(q, k, v, out, head_dims: Sequence[int], **more):
    """Validate the bf16 (B, H, N, D) operands of a kernel launch (q, k, v,
    out, then ``more`` in order) and return their (batch, head, token)
    strides as the C array the kernels take."""
    if q.shape[-1] not in head_dims:
        raise ValueError(f"head_dim {q.shape[-1]} has no kernel instantiation "
                         f"(supported: {tuple(head_dims)})")
    operands = (("q", q), ("k", k), ("v", v), ("out", out)) + tuple(more.items())
    for name, x in operands:
        _check_operand(name, x, torch.bfloat16, q.device)
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"mismatched q/k/v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _strides([x for _, x in operands])


def prepass_operand_strides(q, k, head_dims: Sequence[int]):
    """Validate the bf16 (B, H, N, D) q and k of kernel 1c's pre-pass and
    return their (batch, head, token) strides as the C array it takes."""
    if q.shape[-1] not in head_dims:
        raise ValueError(f"head_dim {q.shape[-1]} has no int8 kernel instantiation "
                         f"(supported: {tuple(head_dims)})")
    for name, x in (("q", q), ("k", k)):
        _check_operand(name, x, torch.bfloat16, q.device)
    if q.shape[:2] != k.shape[:2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"mismatched q/k shapes {tuple(q.shape)}, {tuple(k.shape)}")
    return _strides((q, k))


def int8_attention_operand_strides(q8, k8, v, out, head_dims: Sequence[int]):
    """Validate kernel 1c's operands: int8 q8 and k8 whose rows are the head
    dim zero-padded to whole 16-byte vectors (``width`` columns), bf16 v and
    out; return their strides as the C array the kernel takes (in bytes for
    q8 and k8, elements for v and out)."""
    d = v.shape[-1]
    if d not in head_dims:
        raise ValueError(f"head_dim {d} has no int8 kernel instantiation "
                         f"(supported: {tuple(head_dims)})")
    width = -(-d // 16) * 16
    for name, x in (("q8", q8), ("k8", k8)):
        _check_operand(name, x, torch.int8, v.device)
        if x.shape[-1] != width:
            raise ValueError(f"{name} rows must be {width} wide (head_dim {d} padded), "
                             f"got {tuple(x.shape)}")
    for name, x in (("v", v), ("out", out)):
        _check_operand(name, x, torch.bfloat16, v.device)
    if (k8.shape[:3] != v.shape[:3] or q8.shape[:3] != out.shape[:3]
            or q8.shape[:2] != k8.shape[:2] or out.shape[-1] != d):
        raise ValueError(f"mismatched q8/k8/v/out shapes {tuple(q8.shape)}, "
                         f"{tuple(k8.shape)}, {tuple(v.shape)}, {tuple(out.shape)}")
    return _strides((q8, k8, v, out))


def launch(name: str, *args) -> None:
    """Call a C entry point; raise if the launch was refused or failed."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = (lib.ccedit_error_string(err).decode() if err > 0
               else "unsupported arguments")
        raise RuntimeError(f"{name} failed with error {err}: {msg}")


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
