"""Exponential moving average of the trainable parameters (port of
``ccedit_tpu/train/ema.py``, the reference's LitEma): warm-up decay
``min(decay, (1 + n) / (10 + n))``.  The shadow covers the trainable subset
only: the EMA of a frozen parameter is the parameter itself."""

from __future__ import annotations

from typing import Dict

import torch


class Ema:
    def __init__(self, params: Dict[str, torch.Tensor], decay: float = 0.9999,
                 use_num_updates: bool = True):
        self.shadow = {name: p.detach().clone() for name, p in params.items()}
        self.num_updates = 0
        self.decay = decay
        self.use_num_updates = use_num_updates

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor]) -> None:
        self.num_updates += 1
        n = self.num_updates
        decay = min(self.decay, (1.0 + n) / (10.0 + n)) if self.use_num_updates else self.decay
        for name, s in self.shadow.items():
            s.sub_((1.0 - decay) * (s - params[name].detach()))

    def state_dict(self) -> Dict:
        return {"shadow": self.shadow, "num_updates": self.num_updates}

    def load_state_dict(self, state: Dict) -> None:
        for name, s in self.shadow.items():
            s.copy_(state["shadow"][name])
        self.num_updates = int(state["num_updates"])
