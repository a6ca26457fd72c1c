"""Classifier-free guidance (port of ``ccedit_tpu/diffusion/guidance.py``):
the conditioning is doubled once, [uc; c] on the batch axis, and every
denoiser call doubles x and sigma."""

from __future__ import annotations

from typing import Dict, Optional

import torch

# the keys whose uc and c halves differ, as the JAX list (VanillaCFGTV2V's,
# with ``ref_context``); any other key must be the same in both and passes
DOUBLED_KEYS = ("vector", "crossattn", "concat", "cond_feat", "control_hint",
                "interpolate_first", "interpolate_last", "interpolate_first_last",
                "ref_context")


class IdentityGuider:
    """No guidance: one forward per step."""

    def prepare_cond(self, cond: Dict, uc: Optional[Dict]) -> Dict:
        return dict(cond)

    def expand(self, x, sigma):
        return x, sigma

    def combine(self, out, scale=None):
        return out


class VanillaCFG:
    """``uncond + scale * (cond - uncond)`` over a batch-doubled forward."""

    def __init__(self, scale: float = 7.5):
        self.scale = scale

    def prepare_cond(self, cond: Dict, uc: Optional[Dict]) -> Dict:
        uc = cond if uc is None else uc
        return {k: torch.cat([uc[k], v], dim=0) if k in DOUBLED_KEYS else v
                for k, v in cond.items()}

    def expand(self, x, sigma):
        return torch.cat([x, x], dim=0), torch.cat([sigma, sigma], dim=0)

    def combine(self, out, scale=None):
        x_u, x_c = out.chunk(2, dim=0)
        s = self.scale if scale is None else scale
        return x_u + s * (x_c - x_u)
