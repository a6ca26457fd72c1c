"""ZeRO-1: the optimizer state sharded over the data-parallel ranks (port
of ``ccedit_tpu/parallel/zero.py`` with ``TrainerConfig.zero_sharding``).

The JAX package gives each optimizer-state leaf a sharding over the data
axis and lets XLA keep the shards resident.  Here the AdamW of
``CCEditEngine.make_optimizer`` becomes a
``torch.distributed.optim.ZeroRedundancyOptimizer``: each rank keeps the
Adam moments of its partition of the trainable parameters, steps it, and
broadcasts the updated parameters.  The parameters stay replicated (the
gradients are averaged by ``mesh.all_reduce_grads`` first).  Its
``param_groups`` are the LR scheduler's, as a plain AdamW's are.
Checkpoints: ``consolidate`` (a collective every rank calls) gathers the
full state on rank 0, which alone saves it; a resume loads the full state
on every rank and each keeps its partition.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

# ``torch.distributed.optim`` is imported where it is used: importing it
# scripts its functional optimizers, seconds that a run without ZeRO skips


def zero_adamw(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float):
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(list(params), optimizer_class=torch.optim.AdamW, lr=lr,
                                   weight_decay=weight_decay)


def is_zero(optimizer) -> bool:
    return type(optimizer).__name__ == "ZeroRedundancyOptimizer"


def full_state_dict(optimizer) -> Optional[Dict]:
    """The optimizer's full state: a plain optimizer's own; under ZeRO
    consolidated on rank 0 (every rank must call this), None elsewhere."""
    if not is_zero(optimizer):
        return optimizer.state_dict()
    optimizer.consolidate_state_dict(to=0)
    return optimizer.state_dict() if torch.distributed.get_rank() == 0 else None
