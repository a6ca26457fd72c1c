"""Conditioning embedders of the TV2V and TVI2V paths (port of
``ccedit_tpu/conditioning/embedders.py``: ``CLIPTextEmbedder``,
``IdentityEncoder``, ``VAEEmbedder``).  Each embedder has
``prepare(value)`` (host side: tokenise, ...) and ``forward(prepared)``
(device side)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..modules.clip import CLIPTextModel
from .tokenizer import load_tokenizer


def as_float_frames(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> [-1, 1] float32; float input passes through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 127.5 - 1.0
    return x


class Embedder(nn.Module):
    def prepare(self, value, device):
        return torch.as_tensor(value, device=device)


class CLIPTextEmbedder(Embedder):
    """SD-1.5 text conditioning: CLIP ViT-L/14 text transformer, 77 tokens."""

    def __init__(self, model: Optional[CLIPTextModel] = None, asset_dir: Optional[str] = None,
                 output_layer: str = "last", layer_idx: Optional[int] = None,
                 max_len: int = 77):
        super().__init__()
        self.tokenizer = load_tokenizer(asset_dir)
        self.transformer = model if model is not None else CLIPTextModel()
        self.output_layer, self.layer_idx, self.max_len = output_layer, layer_idx, max_len

    def prepare(self, value, device):
        if isinstance(value, str):
            value = [value]
        if isinstance(value, (list, tuple)) and (not value or isinstance(value[0], str)):
            value = self.tokenizer(list(value), self.max_len)
        return torch.as_tensor(np.asarray(value), dtype=torch.long, device=device)

    def forward(self, tokens):
        return self.transformer(tokens, output_layer=self.output_layer, layer_idx=self.layer_idx)


class IdentityEncoder(Embedder):
    def forward(self, prepared):
        return as_float_frames(prepared)


class VAEEmbedder(Embedder):
    """The edited reference frame -> its scaled VAE latent, through the
    engine's shared first stage: ``encode`` is set by the engine to
    ``CCEditEngine.encode_first_stage``: the posterior mode times the scale
    factor at inference, a posterior sample drawn from ``generator`` in
    training (the JAX embedder's ``rng``, as the reference samples it).
    (B, H, W, 3) pixels -> (B, H/8, W/8, 4); the interpolation network's
    (B, 2, H, W, 3) first and last frames -> (B, 2, H/8, W/8, 4), folded
    per frame as the VAE folds a clip."""

    wants_generator = True

    def __init__(self):
        super().__init__()
        self.encode: Optional[Callable] = None

    def forward(self, prepared, generator: Optional[torch.Generator] = None):
        if self.encode is None:
            raise RuntimeError("VAEEmbedder is not wired to an engine's VAE")
        return self.encode(prepared, generator=generator)
