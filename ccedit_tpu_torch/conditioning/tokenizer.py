"""CLIP BPE tokenizer (port of ``ccedit_tpu/conditioning/tokenizer.py``, which
is numpy-only but lives in a package whose ``__init__`` imports jax).

Reproduces the tokenization used by SD-1.5's text encoder (HF CLIPTokenizer /
openai CLIP simple_tokenizer semantics): byte-level BPE with the ``</w>``
end-of-word convention, lowercasing, whitespace collapse, BOS=49406,
EOS=49407, pad-with-EOS, max length 77.

The vocab/merges assets ship alongside model weights (vocab.json +
merges.txt); pass their paths to ``ClipTokenizer``.  ``HashTokenizer`` is a
deterministic stand-in for tests when no assets are present.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import json
import re
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

BOS = 49406
EOS = 49407
MAX_LEN = 77
VOCAB_SIZE = 49408

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode():
    """Map bytes to printable unicode chars (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class ClipTokenizer:
    """BPE tokenizer over user-supplied assets.

    Accepts either HF-style ``vocab.json`` + ``merges.txt`` or the openai
    ``bpe_simple_vocab_16e6.txt.gz`` merges file.
    """

    def __init__(
        self,
        vocab_path: Optional[str] = None,
        merges_path: Optional[str] = None,
        bpe_gz_path: Optional[str] = None,
    ):
        self.byte_encoder = bytes_to_unicode()
        if bpe_gz_path is not None:
            merges = gzip.open(bpe_gz_path).read().decode("utf-8").split("\n")
            merges = merges[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges]
            vocab = list(self.byte_encoder.values())
            vocab = vocab + [v + "</w>" for v in vocab]
            for m in merges:
                vocab.append("".join(m))
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = dict(zip(vocab, range(len(vocab))))
        else:
            if not (vocab_path and merges_path):
                raise ValueError("ClipTokenizer needs vocab.json + merges.txt or the .gz merges")
            self.encoder = json.loads(Path(vocab_path).read_text())
            lines = Path(merges_path).read_text(encoding="utf-8").split("\n")
            if lines and lines[0].startswith("#"):
                lines = lines[1:]
            merges = [tuple(l.split()) for l in lines if l and len(l.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)

        def get_pairs(word):
            return {(a, b) for a, b in zip(word, word[1:])}

        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def __call__(self, texts: Sequence[str], max_len: int = MAX_LEN) -> np.ndarray:
        """Batch-encode to (B, max_len) int32: BOS + ids + EOS, EOS-padded,
        truncated with EOS kept at the end (HF CLIPTokenizer semantics)."""
        out = np.full((len(texts), max_len), EOS, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)[: max_len - 2]
            row = [BOS] + ids + [EOS]
            out[i, : len(row)] = row
        return out


class HashTokenizer:
    """Deterministic test-only stand-in: stable word hashes into the CLIP id
    space. NOT compatible with pretrained weights."""

    def __call__(self, texts: Sequence[str], max_len: int = MAX_LEN) -> np.ndarray:
        out = np.full((len(texts), max_len), EOS, dtype=np.int32)
        for i, text in enumerate(texts):
            words = _clean(text).split()[: max_len - 2]
            ids = [
                int(hashlib.md5(w.encode()).hexdigest(), 16) % (VOCAB_SIZE - 2)
                for w in words
            ]
            row = [BOS] + ids + [EOS]
            out[i, : len(row)] = row
        return out


def load_tokenizer(asset_dir: Optional[str] = None) -> object:
    """Find tokenizer assets in asset_dir (vocab.json + merges.txt or
    bpe_simple_vocab_16e6.txt.gz); the hash stand-in without assets.
    vocab.json + merges.txt go to the native C++ tokenizer where it is
    built or can be (``native_tokenizer.available``), as in the JAX
    package; a failed build raises rather than falling back."""
    if asset_dir:
        d = Path(asset_dir)
        if (d / "vocab.json").exists() and (d / "merges.txt").exists():
            from .native_tokenizer import NativeClipTokenizer, available

            if available():
                return NativeClipTokenizer(str(d / "vocab.json"), str(d / "merges.txt"))
            return ClipTokenizer(str(d / "vocab.json"), str(d / "merges.txt"))
        gz = d / "bpe_simple_vocab_16e6.txt.gz"
        if gz.exists():
            return ClipTokenizer(bpe_gz_path=str(gz))
    return HashTokenizer()
