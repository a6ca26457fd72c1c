"""The T5 v1.1 encoder, and ByT5 (port of ``ccedit_tpu/modules/t5.py``), in
the HF ``T5EncoderModel`` key layout (``shared``,
``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}``, block 0's
``relative_attention_bias``, ``layer.{0,1}.layer_norm``,
``layer.1.DenseReluDense.{wi_0,wi_1,wo}``, ``encoder.final_layer_norm``),
so an HF state dict loads with ``load_t5_encoder``.

RMSNorm (scale only, eps 1e-6, the variance in fp32) before each sublayer;
the bidirectional relative-position bucket bias (32 buckets, max distance
128) computed once from block 0's table and shared by every block; no
1/sqrt(d) in the attention (logits and softmax in fp32); the gated
tanh-GELU feed-forward; no biases.  Padding (id 0) keys are masked with
-1e9, as the JAX package masks them (HF's encoder, called without an
attention mask as the reference calls it, would attend to them).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class T5RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps).to(x.dtype) * self.weight.to(x.dtype)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """HF T5's ``_relative_position_bucket``, bidirectional."""
    rel = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(rel, 1) / max_exact)
                         / np.log(max_distance / max_exact) * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(rel < max_exact, rel, large)


class T5SelfAttention(nn.Module):
    def __init__(self, d_model: int, heads: int, d_kv: int, has_bias: bool, buckets: int):
        super().__init__()
        inner = heads * d_kv
        self.heads, self.d_kv = heads, d_kv
        self.q = nn.Linear(d_model, inner, bias=False)
        self.k = nn.Linear(d_model, inner, bias=False)
        self.v = nn.Linear(d_model, inner, bias=False)
        self.o = nn.Linear(inner, d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(buckets, heads)

    def forward(self, x, bias):
        b, l, _ = x.shape

        def split(t):
            return t.reshape(b, l, self.heads, self.d_kv).transpose(1, 2)

        logits = torch.matmul(split(self.q(x)).float(), split(self.k(x)).float().transpose(-1, -2))
        weights = torch.softmax(logits + bias, dim=-1).to(x.dtype)
        out = torch.matmul(weights, split(self.v(x))).transpose(1, 2).reshape(b, l, -1)
        return self.o(out)


class _AttnLayer(nn.Module):
    def __init__(self, d_model, heads, d_kv, has_bias, buckets):
        super().__init__()
        self.SelfAttention = T5SelfAttention(d_model, heads, d_kv, has_bias, buckets)
        self.layer_norm = T5RMSNorm(d_model)


class _DenseGatedGelu(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.wi_0 = nn.Linear(d_model, d_ff, bias=False)
        self.wi_1 = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _FFLayer(nn.Module):
    def __init__(self, d_model, d_ff):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(d_model, d_ff)
        self.layer_norm = T5RMSNorm(d_model)


class T5Block(nn.Module):
    def __init__(self, d_model, heads, d_kv, d_ff, has_bias, buckets):
        super().__init__()
        self.layer = nn.ModuleList([_AttnLayer(d_model, heads, d_kv, has_bias, buckets),
                                    _FFLayer(d_model, d_ff)])

    def forward(self, x, bias):
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, d_model, heads, d_kv, d_ff, layers, buckets):
        super().__init__()
        self.block = nn.ModuleList(T5Block(d_model, heads, d_kv, d_ff, i == 0, buckets)
                                   for i in range(layers))
        self.final_layer_norm = T5RMSNorm(d_model)


class T5Encoder(nn.Module):
    """google/t5-v1_1-* / google/byt5-* encoder: (B, L) padded token ids ->
    (B, L, d_model)."""

    def __init__(self, vocab_size: int = 32128, d_model: int = 512, d_kv: int = 64,
                 d_ff: int = 1024, heads: int = 6, layers: int = 8, rel_buckets: int = 32,
                 rel_max_distance: int = 128):
        super().__init__()
        self.rel_buckets, self.rel_max_distance = rel_buckets, rel_max_distance
        self.shared = nn.Embedding(vocab_size, d_model)
        self.encoder = _Stack(d_model, heads, d_kv, d_ff, layers, rel_buckets)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        l = tokens.shape[1]
        x = self.shared(tokens)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        buckets = torch.as_tensor(relative_position_buckets(l, l, self.rel_buckets,
                                                            self.rel_max_distance),
                                  device=tokens.device)
        bias = table[buckets].permute(2, 0, 1)[None].float()  # (1, H, L, L)
        pad = (tokens == 0).float()
        bias = bias + pad[:, None, None, :] * -1e9
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)


def load_t5_encoder(model: T5Encoder, sd: Dict[str, torch.Tensor]) -> None:
    """An HF ``T5EncoderModel`` state dict (``encoder.embed_tokens``, tied to
    ``shared``, is not read) into ``model``, strictly."""
    sd = dict(sd)
    emb = sd.pop("encoder.embed_tokens.weight", None)
    sd.setdefault("shared.weight", emb)
    model.load_state_dict(sd)


def byt5_tokenize(texts: List[str], max_length: int = 77) -> np.ndarray:
    """ByT5Tokenizer: UTF-8 bytes + 3 (pad 0 / eos 1 / unk 2), truncated to
    max_length - 1, EOS appended, padded with 0."""
    out = np.zeros((len(texts), max_length), dtype=np.int32)
    for i, t in enumerate(texts):
        ids = [b + 3 for b in t.encode("utf-8")][: max_length - 1] + [1]
        out[i, : len(ids)] = ids
    return out
