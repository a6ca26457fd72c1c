"""ctypes binding of the repo's C++ CLIP BPE tokenizer (port of
``ccedit_tpu/conditioning/native_tokenizer.py``).

``native/tokenizer/clip_bpe.cpp`` is compiled with ``g++`` at first use
(never at import) into ``build/native/libclip_bpe.so``, keyed by the
source's hash, and loaded with ctypes.  ``NativeClipTokenizer`` is a
drop-in for ``tokenizer.ClipTokenizer`` (the Python tokenizer stays the
behavioural reference), and ``tokenizer.load_tokenizer`` picks it for
vocab.json + merges.txt assets: ``__call__`` pads to ``max_len`` with EOS,
``encode`` strips BOS/EOS.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .tokenizer import MAX_LEN

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "tokenizer" / "clip_bpe.cpp"
BUILD_DIR = ROOT / "build" / "native"
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libclip_bpe_{digest}.so"


def build_library() -> Path:
    """Compile the tokenizer if its library for this source is not built."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(SOURCE),
                        "-o", str(tmp)], check=True, capture_output=True, text=True)
        tmp.replace(path)
    return path


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.clip_tokenizer_create.restype = ctypes.c_void_p
        lib.clip_tokenizer_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.clip_tokenizer_destroy.argtypes = [ctypes.c_void_p]
        lib.clip_tokenizer_encode.restype = ctypes.c_int32
        lib.clip_tokenizer_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                                              ctypes.POINTER(ctypes.c_int32)]
        _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the library is built or can be (a ``g++`` on the PATH)."""
    return library_path().exists() or shutil.which("g++") is not None


class NativeClipTokenizer:
    """``ClipTokenizer`` backed by the C++ implementation."""

    def __init__(self, vocab_path: str, merges_path: str):
        self._lib = load_library()
        self._handle = self._lib.clip_tokenizer_create(str(vocab_path).encode(),
                                                       str(merges_path).encode())
        if not self._handle:
            raise IOError(f"failed to load tokenizer assets {vocab_path}, {merges_path}")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.clip_tokenizer_destroy(self._handle)

    def _encode(self, text: str, max_len: int):
        buf = (ctypes.c_int32 * max_len)()
        n = self._lib.clip_tokenizer_encode(self._handle, text.encode("utf-8"), max_len, buf)
        return buf, n

    def encode(self, text: str, max_len: int = MAX_LEN):
        buf, n = self._encode(text, max_len)
        return list(buf[1:n - 1])

    def __call__(self, texts: Sequence[str], max_len: int = MAX_LEN) -> np.ndarray:
        out = np.empty((len(texts), max_len), dtype=np.int32)
        for i, text in enumerate(texts):
            out[i] = np.frombuffer(self._encode(text, max_len)[0], dtype=np.int32)
        return out
