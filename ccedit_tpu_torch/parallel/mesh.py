"""Data parallelism over ``torch.distributed`` (port of
``ccedit_tpu/parallel/mesh.py``'s data axis).

The JAX package shards the batch over the mesh's ``data`` axis in
contiguous blocks (``P("data")``) and lets XLA emit the gradient psum.  Here
each process (one per GPU, started by ``torchrun``) holds a full replica of
the weights, takes its contiguous block of every global batch
(``batch_slice``) and, after the backward of each batch that applies an
optimizer step, averages the trainable gradients over the ranks
(``all_reduce_grads``).  With gradient accumulation the local gradients add
up over k batches and are reduced once, at the apply step: the math of
``optax.MultiSteps`` over a psum-ed step.  No ``DistributedDataParallel``
wrapper: the engine reaches into ``engine.network.*`` everywhere, and the
non-reentrant ``use_checkpoint`` would run under a wrapper's hooks.

Inside ``data_parallel`` (the engine's training step under a reducing
trainer) the ops that the JAX package's one SPMD program computes over the
global batch, and not per sample, reduce over the ranks: the MiDaS hint's
min-max (``reduce_over_data``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable

import torch
import torch.distributed as dist

# gradients are flattened into buckets of at most this many bytes (fp32)
BUCKET_BYTES = 64 << 20


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group of a ``torchrun`` launch and return this
    rank's device.  Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and
    torchrun's ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``); NCCL
    for CUDA, each rank on ``cuda:LOCAL_RANK``; gloo for the CPU.  Without
    a torchrun environment (no ``WORLD_SIZE``) it joins nothing and returns
    ``device``."""
    if "WORLD_SIZE" not in os.environ:
        return torch.device(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


_DATA_PARALLEL = [0]  # the depth of nested data_parallel blocks


@contextlib.contextmanager
def data_parallel():
    """While the block runs, a data-parallel step over the default group:
    ``reduce_over_data`` reduces over its ranks."""
    _DATA_PARALLEL[0] += 1
    try:
        yield
    finally:
        _DATA_PARALLEL[0] -= 1


def reduce_over_data(t: torch.Tensor, op) -> torch.Tensor:
    """``t`` reduced in place with ``op`` (``dist.ReduceOp``) over the ranks
    of the ``data_parallel`` step the caller runs in; as it is outside one,
    or outside a process group of more than one rank."""
    if _DATA_PARALLEL[0] and dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(t, op=op)
    return t


def batch_slice(batch_size: int, rank: int, world: int) -> slice:
    """This rank's contiguous block of a global batch (``P("data")``)."""
    if batch_size % world:
        raise ValueError(f"the global batch size {batch_size} does not divide by the "
                         f"world size {world}")
    local = batch_size // world
    return slice(rank * local, (rank + 1) * local)


@torch.no_grad()
def all_reduce_grads(params: Dict[str, torch.Tensor] | Iterable[torch.Tensor]) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ranks, the
    gradients flattened into fp32 buckets of at most ``BUCKET_BYTES`` (one
    all-reduce a bucket).  Every rank must call it with the same
    parameters in the same order.  A parameter without a gradient adds zero
    and keeps no gradient, as a single process's optimizer skips it: the
    graph, and with it which parameters have a gradient, is the same on
    every rank.  A no-op outside a process group."""
    if not dist.is_initialized():
        return
    params = list(params.values()) if isinstance(params, dict) else list(params)
    world = dist.get_world_size()
    bucket, size = [], 0
    for i, p in enumerate(params):
        bucket.append(p)
        size += p.numel() * 4
        if size >= BUCKET_BYTES or i == len(params) - 1:
            flat = torch.cat([(q.grad if q.grad is not None else torch.zeros_like(q))
                              .reshape(-1).float() for q in bucket])
            dist.all_reduce(flat)
            flat.div_(world)
            offset = 0
            for q in bucket:
                if q.grad is not None:
                    q.grad.copy_(flat[offset:offset + q.numel()].view_as(q))
                offset += q.numel()
            bucket, size = [], 0


def _reduced(value: float, op) -> float:
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op)
    return t.item()


def any_rank(flag: bool) -> bool:
    """``flag`` or'ed over the ranks (a max all-reduce): a host flag such
    as the SIGUSR1 save request, which one rank's signal sets, acted on by
    every rank at the same step."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    return bool(_reduced(float(flag), dist.ReduceOp.MAX))


def mean_over_ranks(value: float) -> float:
    """``value`` averaged over the ranks: a logged loss, each rank's the
    mean over its block, becomes the global batch's mean, as the JAX
    step's loss is."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    return _reduced(value, dist.ReduceOp.SUM) / dist.get_world_size()
