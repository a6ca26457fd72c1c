"""Parameter freeze policies (port of ``ccedit_tpu/train/freeze.py``).

Each policy is a predicate over a parameter's name in the port's sgm layout
(``unet.input_blocks.1.0.in_layers_temporal.2.weight``,
``controlnet.zero_convs.0.0.weight``, ...):

* ``none``: train everything; ``all``: train nothing;
* ``spatial``: train the temporal layers and every control branch;
* ``spatial_openlora``: ``spatial`` plus LoRA adapters;
* ``spatial_tv2v`` (``spatial`` under the TV2V engine): the structure
  ControlNet frozen, the appearance ``controlnet_img`` and the temporal
  layers trainable; ``spatial_tv2v_openlora`` adds LoRA adapters.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

FREEZE_POLICIES = ("none", "all", "spatial", "spatial_openlora", "spatial_tv2v",
                   "spatial_tv2v_openlora")


def _temporal(name: str) -> bool:
    return "temporal" in name or "alpha_temporal" in name


def policy_predicate(policy: str = "none") -> Callable[[str], bool]:
    """name -> trainable, for one of ``FREEZE_POLICIES``."""
    if policy == "none":
        return lambda name: True
    if policy == "all":
        return lambda name: False
    if policy in ("spatial", "spatial_openlora"):
        lora = policy == "spatial_openlora"
        return lambda name: _temporal(name) or "controlnet" in name or (lora and "lora" in name)
    if policy in ("spatial_tv2v", "spatial_tv2v_openlora"):
        lora = policy.endswith("openlora")

        def pred(name: str) -> bool:
            if "controlnet_img" in name:
                return True
            if "controlnet" in name:
                return False
            return (lora and "lora" in name) or _temporal(name)

        return pred
    raise ValueError(f"unknown freeze policy {policy!r}")


def freeze_mask(named: Iterable[Tuple[str, torch.Tensor]], policy: str = "none") -> Dict[str, bool]:
    """{name: trainable} over ``module.named_parameters()`` (or any
    (name, tensor) pairs)."""
    pred = policy_predicate(policy)
    return {name: pred(name) for name, _ in named}


def count_trainable(named: Iterable[Tuple[str, torch.Tensor]], mask: Dict[str, bool]) -> Dict[str, int]:
    sizes = {name: p.numel() for name, p in named}
    trainable = sum(n for name, n in sizes.items() if mask[name])
    total = sum(sizes.values())
    return {"trainable": trainable, "total": total, "frozen": total - trainable}
