"""Conditioning framework (port of ``ccedit_tpu/conditioning/conditioner.py``):
each embedder reads one batch key and routes its output to a conditioning key
(``txt`` -> crossattn, ``control_hint`` -> control_hint, ``cond_img`` ->
cond_feat, ``interpolate_first`` / ``interpolate_last`` /
``interpolate_first_last`` -> the same key, else by ndim: 2 vector, 3
crossattn, 4/5 concat); outputs landing
on one key are concatenated on the channel axis.  Training's classifier-free
dropout: ``embed(..., apply_ucg=True)`` zeroes an embedder's output per
batch element with probability ``ucg_rate``; an embedder with a
``legacy_ucg_value`` instead has its input strings replaced by that value
in ``prepare(..., apply_legacy_ucg=True)`` (the reference's
``possibly_get_ucg_val``).  Draws come from an explicit generator."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

_OUTPUT_KEY_OVERRIDES = {"txt": "crossattn", "control_hint": "control_hint",
                         "cond_img": "cond_feat", "interpolate_first": "interpolate_first",
                         "interpolate_last": "interpolate_last",
                         "interpolate_first_last": "interpolate_first_last"}
_DIM2KEY = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}


@dataclasses.dataclass
class EmbedderSpec:
    embedder: nn.Module
    input_key: str
    ucg_rate: float = 0.0
    legacy_ucg_value: Optional[str] = None

    def output_key(self, ndim: int) -> str:
        return _OUTPUT_KEY_OVERRIDES.get(self.input_key) or _DIM2KEY[ndim]


class Conditioner(nn.Module):
    def __init__(self, specs: Sequence[EmbedderSpec]):
        super().__init__()
        self.specs = list(specs)
        self.embedders = nn.ModuleList(s.embedder for s in self.specs)

    @property
    def device(self) -> torch.device:
        for p in self.parameters():
            return p.device
        return torch.device("cpu")

    def prepare(self, batch: Dict, apply_legacy_ucg: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        """Host side: strings -> tokens, arrays -> tensors on the device.
        ``apply_legacy_ucg`` (training) replaces each string of an embedder
        with a ``legacy_ucg_value`` by that value with probability
        ``ucg_rate``."""
        out = dict(batch)
        for spec in self.specs:
            if spec.input_key not in batch:
                continue
            value = batch[spec.input_key]
            if apply_legacy_ucg and spec.legacy_ucg_value is not None and spec.ucg_rate > 0:
                device = generator.device if generator is not None else "cpu"
                drop = torch.rand(len(value), generator=generator, device=device) < spec.ucg_rate
                value = [spec.legacy_ucg_value if d else v for v, d in zip(value, drop.tolist())]
            out[spec.input_key] = spec.embedder.prepare(value, self.device)
        return out

    def embed(self, prepared: Dict, apply_ucg: bool = False,
              generator: Optional[torch.Generator] = None) -> Dict:
        """Run every embedder and route its output.  ``apply_ucg`` (training)
        zeroes the output of an embedder without a ``legacy_ucg_value`` for
        each batch element with probability ``ucg_rate``; an embedder that
        ``wants_generator`` (``VAEEmbedder``) draws from ``generator``."""
        cond: Dict[str, torch.Tensor] = {}
        for spec in self.specs:
            if spec.input_key not in prepared:
                continue
            if generator is not None and getattr(spec.embedder, "wants_generator", False):
                emb = spec.embedder(prepared[spec.input_key], generator=generator)
            else:
                emb = spec.embedder(prepared[spec.input_key])
            if apply_ucg and spec.ucg_rate > 0.0 and spec.legacy_ucg_value is None:
                keep = torch.bernoulli(torch.full((emb.shape[0],), 1.0 - spec.ucg_rate,
                                                  device=emb.device), generator=generator)
                emb = emb * keep.to(emb.dtype).reshape((-1,) + (1,) * (emb.dim() - 1))
            key = spec.output_key(emb.dim())
            cond[key] = torch.cat([cond[key], emb], dim=-1) if key in cond else emb
        return cond

    def forward(self, batch: Dict) -> Dict:
        return self.embed(self.prepare(batch))

    def get_unconditional_conditioning(self, batch: Dict,
                                       batch_uc: Optional[Dict] = None) -> Tuple[Dict, Dict]:
        c = self.embed(self.prepare(batch))
        uc = self.embed(self.prepare(batch_uc if batch_uc is not None else batch))
        return c, uc
