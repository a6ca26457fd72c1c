"""ZeRO-1's optimizer state per rank on the TV2V training recipe.

    torchrun --nproc_per_node 4 -m ccedit_tpu_torch.scripts.zero_state

Every rank builds the ``TV2V_TRAIN_CONFIG`` engine (seeded random fp32
masters, ``spatial_tv2v``), takes its block of the recipe's global batch (4
clips of 12 frames at 384x512: one clip a rank at world 4) and steps
``CCEditEngine.train_step`` under bf16 autocast with the gradient
all-reduce and the AdamW of ``make_optimizer(zero=True)``
(``parallel/zero.py``; a plain AdamW at world 1): one step that creates
the Adam moments, then ``--steps`` timed ones.  Rank 0 prints one JSON line
with every rank's optimizer-state bytes (the tensors its optimizer holds),
the bytes a plain AdamW would hold (two fp32 moments a trainable
parameter), the device memory allocated after a step and its peak, and the
seconds a step.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.distributed as dist


def state_bytes(optimizer) -> int:
    """The bytes of the tensors in ``optimizer``'s state (under ZeRO, this
    rank's partition)."""
    inner = getattr(optimizer, "optim", optimizer)
    return sum(v.numel() * v.element_size() for st in inner.state.values()
               for v in st.values() if torch.is_tensor(v))


def main(argv=None) -> None:
    from .. import config
    from ..cli.train import build_train_engine
    from ..data.dataset import SyntheticVideoDataset, collate
    from ..parallel.mesh import all_reduce_grads, batch_slice, init_distributed

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("zero_state needs a CUDA device")
    device = init_distributed("cuda")
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg = config.TV2V_TRAIN_CONFIG
    data = cfg["data"]["params"]
    bs, t = data["batch_size"], data["train"]["params"]["video_length"]
    h, w = data["train"]["params"]["resolution"]
    engine = build_train_engine(cfg, device, a.seed)
    optimizer = engine.make_optimizer(1e-4, zero=world > 1)
    n_train = sum(p.numel() for p in engine.trainable_parameters().values())
    ds = SyntheticVideoDataset(n_items=bs, num_frames=t, size_hw=(h, w), seed=a.seed)
    batch = collate([ds[i] for i in range(bs)[batch_slice(bs, rank, world)]])
    gen = torch.Generator(device=device).manual_seed(a.seed + rank)
    reduce = all_reduce_grads if world > 1 else None

    def step():
        loss = engine.train_step(batch, optimizer, gen, autocast_dtype=torch.bfloat16,
                                 reduce_grads=reduce)
        return float(loss)

    step()  # creates the Adam moments
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(a.steps):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    mine = dict(state_gb=state_bytes(optimizer) / 1e9,
                allocated_gb=torch.cuda.memory_allocated(device) / 1e9,
                peak_gb=torch.cuda.max_memory_allocated(device) / 1e9, step_seconds=times)
    ranks = [None] * world
    if dist.is_initialized():
        dist.all_gather_object(ranks, mine)
        dist.destroy_process_group()
    else:
        ranks = [mine]
    if rank != 0:
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"gpu": smi, "workload": "zero_state", "world": world,
                      "zero": world > 1, "batch_per_rank": bs // world, "frames": t,
                      "height": h, "width": w, "params_trainable": n_train,
                      "plain_adamw_state_gb": 2 * 4 * n_train / 1e9, "by_rank": ranks}))


if __name__ == "__main__":
    main()
