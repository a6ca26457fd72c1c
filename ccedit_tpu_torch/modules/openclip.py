"""OpenCLIP text and vision towers (port of ``ccedit_tpu/modules/
openclip.py``), in open_clip's own key layout (``token_embedding``,
``positional_embedding``, ``transformer.resblocks.{i}.{ln_1, attn.in_proj_*,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}``, ``ln_final``,
``text_projection``; the vision tower's under ``visual.``), so an open_clip
checkpoint loads with ``load_openclip_text`` / ``load_openclip_vision``.

Pre-LN residual blocks with a fused-qkv attention (plain math, logits and
softmax in fp32, as the JAX package computes them) and an exact-GELU MLP;
the text tower's mask is causal.  The text tower returns every hidden state
the embedders read: ``penultimate`` (the input of the final block),
``last``, ``last_norm`` (``ln_final(last)``) and ``pooled`` (the EOT
position, the highest token id, of ``last_norm`` times
``text_projection``); with ``skip_last_layer`` the final block is not run
and ``penultimate_norm`` is ``ln_final(penultimate)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.normal_(self.in_proj_weight, std=width ** -0.5)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        b, l, w = x.shape
        d = w // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)

        def split(t):
            return t.reshape(b, l, self.heads, d).transpose(1, 2)

        logits = torch.matmul(split(q).float(), split(k).float().transpose(-1, -2)) * d ** -0.5
        if mask is not None:
            logits = logits + mask
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(weights, split(v)).transpose(1, 2).reshape(b, l, w)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, width: int, act: str):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)
        self.act = act

    def forward(self, x):
        h = self.c_fc(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.c_proj(h)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, act: str = "gelu"):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width, act)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, act: str = "gelu"):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads, act)
                                       for _ in range(layers))


class OpenCLIPTextModel(nn.Module):
    """ViT-H-14 text defaults: width 1024, 24 layers, 16 heads."""

    def __init__(self, vocab_size: int = 49408, max_len: int = 77, width: int = 1024,
                 heads: int = 16, layers: int = 24, embed_dim: Optional[int] = None):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(max_len, width) * 0.01)
        self.transformer = _Transformer(width, heads, layers)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.randn(width, embed_dim or width) * width ** -0.5)

    def forward(self, tokens: torch.Tensor, skip_last_layer: bool = False
                ) -> Dict[str, torch.Tensor]:
        b, l = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[:l].to(
            self.token_embedding.weight.dtype)
        mask = torch.full((l, l), float("-inf"), device=tokens.device).triu(1)
        blocks = self.transformer.resblocks
        out: Dict[str, torch.Tensor] = {}
        for i, block in enumerate(blocks[:-1] if skip_last_layer else blocks):
            if i == len(blocks) - 1:
                out["penultimate"] = x
            x = block(x, mask)
        if skip_last_layer:
            out["penultimate"] = x
            out["penultimate_norm"] = self.ln_final(x)
            return out
        out["last"] = x
        final = self.ln_final(x)
        out["last_norm"] = final
        eot = tokens.argmax(dim=-1)
        out["pooled"] = final[torch.arange(b, device=tokens.device), eot] @ self.text_projection
        return out


class OpenCLIPVisionModel(nn.Module):
    """ViT-H-14 defaults: 14 px patches, width 1280, 32 layers, 16 heads,
    output dim 1024.  (B, 3, H, W) CLIP-normalised -> pooled (B, out_dim),
    or (pooled, tokens (B, N, width)) with ``output_tokens``."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, width: int = 1280,
                 heads: int = 16, layers: int = 32, output_dim: int = 1024, act: str = "gelu"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(width) * 0.01)
        n_tok = (image_size // patch_size) ** 2 + 1
        self.positional_embedding = nn.Parameter(torch.randn(n_tok, width) * 0.01)
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, heads, layers, act)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.randn(width, output_dim) * width ** -0.5)

    def forward(self, images: torch.Tensor, output_tokens: bool = False):
        x = self.conv1(images.to(self.conv1.weight.dtype))
        b, w = x.shape[:2]
        x = x.reshape(b, w, -1).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(b, 1, w), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding[:x.shape[1]])
        for block in self.transformer.resblocks:
            x = block(x)
        x = self.ln_post(x)
        pooled = x[:, 0] @ self.proj
        return (pooled, x[:, 1:]) if output_tokens else pooled


def load_openclip_text(model: OpenCLIPTextModel, sd: Dict[str, torch.Tensor]) -> None:
    """An open_clip CLIP state dict's text tower (the ``visual.*`` keys and
    ``logit_scale`` are not read; a missing ``text_projection`` keeps its
    value) into ``model``, strictly otherwise."""
    sd = {k: v for k, v in sd.items() if not k.startswith(("visual.", "logit_scale"))
          and not (k.startswith("transformer.resblocks.")
                   and int(k.split(".")[2]) >= len(model.transformer.resblocks))}
    wanted = set(model.state_dict()) - ({"text_projection"} - set(sd))
    missing = sorted(wanted - set(sd))
    if missing or set(sd) - wanted:
        raise KeyError(f"open_clip text state dict: missing {missing[:5]}, "
                       f"unexpected {sorted(set(sd) - wanted)[:5]}")
    model.load_state_dict(sd, strict=False)


def load_openclip_vision(model: OpenCLIPVisionModel, sd: Dict[str, torch.Tensor]) -> None:
    """An open_clip state dict's vision tower (``visual.*``, or bare) into
    ``model``, strictly."""
    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    model.load_state_dict(sd)
