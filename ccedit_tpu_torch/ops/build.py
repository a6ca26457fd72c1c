"""Build the CUDA kernels in ``csrc/`` with nvcc and bind them with ctypes.

The sources compile into one shared library with a plain C interface, for
``sm_90a`` (H100).  The library goes to ``build/kernels/`` at the root of the
checkout, named by a hash of the sources, so an edited source rebuilds and an
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
    # q, k, v, dout, lse, delta, dq, dk, dv, batch, heads, n_q, n_k, head_dim,
    # strides, scale_log2, scale, stream
    "ccedit_spatial_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _STRIDES, ctypes.c_float, ctypes.c_float,
                                     _P),
    # q, k, v, o, batch, heads, n_q, n_k, head_dim, strides, scale_log2, stream
    "ccedit_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES,
                               ctypes.c_float, _P),
    # q, k, v, o, batch, heads, T, head_dim, strides, scale, stream
    "ccedit_temporal_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _STRIDES,
                                  ctypes.c_float, _P),
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
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return path, seconds, log


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


def attention_operand_strides(q, k, v, out, head_dims: Sequence[int], **more):
    """Validate the (B, H, N, D) operands of a kernel launch (q, k, v, out,
    then ``more`` in order) and return their (batch, head, token) strides as
    the C array the kernels take."""
    if q.shape[-1] not in head_dims:
        raise ValueError(f"head_dim {q.shape[-1]} has no kernel instantiation "
                         f"(supported: {tuple(head_dims)})")
    operands = (("q", q), ("k", k), ("v", v), ("out", out)) + tuple(more.items())
    for name, x in operands:
        if x.dim() != 4:
            raise ValueError(f"{name} must be (B, H, N, D), got {tuple(x.shape)}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on the GPU, got {x.dtype}")
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, got {x.device}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a unit head_dim stride, other strides multiple "
                f"of 8 and 16-byte alignment; got strides {x.stride()}")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"mismatched q/k/v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return (ctypes.c_longlong * (3 * len(operands)))(
        *[s for _, x in operands for s in x.stride()[:3]])


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
