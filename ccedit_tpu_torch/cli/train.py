"""Training CLI (port of ``ccedit_tpu/cli/train.py``, the reference's main.py).

    python -m ccedit_tpu_torch.cli.train [-b config1.yaml ...] [key.sub=value ...] \\
        --name run1 --max_steps 10000 --synthetic_data --device cuda --bf16

Without ``-b`` the config is ``TV2V_TRAIN_CONFIG`` (the TV2V recipe: batch
4 of 12-frame 384x512 clips); YAMLs (PyYAML imported only then) merge over
nothing, left to right, and ``key=value`` dotlist overrides apply last.
The run directory ``{logdir}/{time}_{name}`` gets ``configs/merged.json``,
metrics and checkpoints; ``-r DIR`` resumes it from its newest checkpoint.
Initial weights: ``--init_ckpt`` (or the config's ``ckpt_path``), a
reference checkpoint loaded through ``io/checkpoint.py``, else seeded random
weights (``randomize_weights_``).  Data: WebVid from the config's
``data.params.train.params``, or with ``--synthetic_data`` (or no data
config) ``SyntheticVideoDataset`` clips at the config's ``video_length`` and
``resolution`` (default 8 frames of 64x64); a toy config's data target
(``sgm.data.mnist.MNISTLoader``, ``sgm.data.cifar10.CIFAR10Loader``, as in
``TOY_MNIST_CONFIG``) reads ``data/toy.py``'s images.  On CUDA ``--bf16`` is needed
(fp32 masters, bf16 autocast: the kernels take bf16).  ``--sample_every N``
samples ``--sample_steps`` steps from the batch's conditioning at step 1
and every N steps into ``{run}/images/``.

Data parallelism: one process a GPU under torchrun, the config's
``batch_size`` being the global batch (each rank takes its contiguous
block of it):

    torchrun --nproc_per_node 4 -m ccedit_tpu_torch.cli.train --mesh_data 4 ...

``--mesh_data`` must equal torchrun's world size (the default is the world
size); only rank 0 writes the run directory.
"""

from __future__ import annotations

import argparse
import datetime
import json
from pathlib import Path
from typing import Dict, Optional

import torch

from ..config import TV2V_TRAIN_CONFIG, build_engine, build_lr_scheduler, load_configs
from ..io.checkpoint import load_reference_checkpoint, load_torch_state_dict, randomize_weights_


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base", nargs="*", default=[],
                   help="config yaml(s) or built-in config names (toy_mnist, ...), merged "
                        "left-to-right")
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-r", "--resume", type=str, default="", help="run directory to resume")
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=None, help="override data batch size")
    p.add_argument("--ckpt_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--sample_every", type=int, default=0,
                   help="validation sampling at step 1 and every N steps (0: off)")
    p.add_argument("--sample_steps", type=int, default=10, help="steps of a validation sample")
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--scale_lr", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--mesh_data", type=int, default=None,
                   help="data-parallel size: torchrun's world size (default: that size)")
    p.add_argument("--synthetic_data", action="store_true", help="train on synthetic clips")
    p.add_argument("--init_ckpt", type=str, default="",
                   help="initial weights: a reference torch checkpoint (.ckpt/.pt/.safetensors); "
                        "overrides the config's model.params.ckpt_path")
    p.add_argument("--tokenizer_assets", type=str, default="")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 autocast over fp32 master weights (needed on CUDA)")
    args, unknown = p.parse_known_args(argv)
    overrides = [u for u in unknown if "=" in u and not u.startswith("-")]
    return args, overrides


def build_train_engine(cfg: Dict, device: torch.device, seed: int,
                       init_ckpt: str = "", tokenizer_assets: Optional[str] = None):
    """The engine of a training config on ``device`` in fp32, with a
    checkpoint's weights or seeded random ones (every parameter drawn, the
    zero-initialised temporal layers included)."""
    with device:
        engine = build_engine(cfg, asset_dir=tokenizer_assets or None)
    modules = engine.modules
    if init_ckpt:
        load_reference_checkpoint(engine, load_torch_state_dict(init_ckpt))
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        for m in modules:
            randomize_weights_(m, gen)
    for m in modules:
        m.to(dtype=torch.float32).train()
    return engine


def build_dataloader(cfg: Dict, args, rank: int = 0, world: int = 1):
    """The loader of this rank's block of each global batch, and the global
    batch size."""
    from ..data.dataset import DataLoader, SyntheticVideoDataset, WebVidDataset

    data_target = str((cfg.get("data") or {}).get("target") or "")
    data_cfg = (cfg.get("data") or {}).get("params") or {}
    train_cfg = ((data_cfg.get("train") or {}).get("params")) or {}
    bs = args.batch_size or data_cfg.get("batch_size", 1)
    if "mnist" in data_target.lower() or "cifar" in data_target.lower():
        # the toy image configs: IDX/pickle files, else the synthetic set
        from ..data.toy import build_toy_dataset

        ds = build_toy_dataset(data_target, data_cfg, train=True, seed=args.seed)
        return DataLoader(ds, batch_size=bs, seed=args.seed, rank=rank, world=world), bs
    if args.synthetic_data or "csv_path" not in train_cfg:
        ds = SyntheticVideoDataset(n_items=64, num_frames=train_cfg.get("video_length", 8),
                                   size_hw=tuple(train_cfg.get("resolution", (64, 64))),
                                   seed=args.seed)
    else:
        ds = WebVidDataset(data_root=train_cfg.get("data_root", "."),
                           csv_path=train_cfg["csv_path"],
                           num_frames=train_cfg.get("video_length", 9),
                           size_hw=tuple(train_cfg.get("resolution", (256, 384))),
                           seed=args.seed)
    return DataLoader(ds, batch_size=bs, seed=args.seed, rank=rank, world=world), bs


def main(argv=None):
    """Train; returns (engine, FitResult)."""
    args, overrides = parse_args(argv)
    from ..parallel import mesh
    from ..train.trainer import Trainer, TrainerConfig

    if torch.device(args.device).type == "cuda" and not args.bf16:
        raise SystemExit("on CUDA pass --bf16: the attention kernels take bf16")
    device = mesh.init_distributed(args.device)
    rank, world = mesh.rank(), mesh.world_size()
    if args.mesh_data is not None and args.mesh_data != world:
        raise SystemExit(f"--mesh_data {args.mesh_data} needs as many processes, one a GPU: "
                         f"launch with torchrun --nproc_per_node {args.mesh_data} (this run "
                         f"has {world})")
    if args.resume:
        logdir = Path(args.resume)
        base = json.loads((logdir / "configs" / "merged.json").read_text())
        cfg = load_configs(args.base, overrides, base=base)
    else:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        name = args.name or (Path(args.base[0]).stem if args.base else "tv2v_train")
        logdir = Path(args.logdir) / f"{now}_{name}"
        if world > 1:  # rank 0's clock names the run for every rank
            shared = [str(logdir)]
            torch.distributed.broadcast_object_list(shared, src=0)
            logdir = Path(shared[0])
        cfg = load_configs(args.base, overrides, base=None if args.base else TV2V_TRAIN_CONFIG)
        if rank == 0:
            (logdir / "configs").mkdir(parents=True, exist_ok=True)
            (logdir / "configs" / "merged.json").write_text(json.dumps(cfg, indent=1))

    model_params = (cfg.get("model") or {}).get("params") or {}
    engine = build_train_engine(cfg, device, args.seed,
                                args.init_ckpt or str(model_params.get("ckpt_path") or ""),
                                args.tokenizer_assets)
    loader, bs = build_dataloader(cfg, args, rank, world)
    trainer = Trainer(
        engine,
        TrainerConfig(logdir=str(logdir), max_steps=args.max_steps, ckpt_every=args.ckpt_every,
                      log_every=args.log_every, sample_every=args.sample_every,
                      sample_steps=args.sample_steps,
                      accumulate_grad_batches=args.accumulate_grad_batches,
                      base_lr=float(model_params.get("base_learning_rate", 1e-4)),
                      scale_lr=args.scale_lr, seed=args.seed,
                      autocast_dtype=torch.bfloat16 if args.bf16 else None),
        lr_schedule=build_lr_scheduler(model_params.get("scheduler_config")))
    result = trainer.fit(loader, batch_size=bs, resume=bool(args.resume))
    if rank == 0:
        print(f"training done at step {result.step}; logs in {logdir}")
    return engine, result


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
