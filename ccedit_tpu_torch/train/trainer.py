"""Training loop (port of ``ccedit_tpu/train/trainer.py``): LR scaling,
gradient accumulation, checkpoints with resume, CSV + JSONL metrics, the
SIGUSR1 save and the crash save.

One device: fp32 master weights, the loss under ``torch.autocast`` in
``autocast_dtype`` (bf16 on the GPU, so the attention kernels get bf16;
None keeps fp32, as on the CPU).  ``max_steps`` counts batches, each one
a ``CCEditEngine.train_step``; with
``accumulate_grad_batches`` = k the optimizer steps every k batches on the
mean of their gradients, and the EMA updates every batch (as the JAX
trainer's ``optax.MultiSteps`` and the reference's LitEma hook do).  A
checkpoint (``checkpoints/step_{step:09d}.pt``, the newest
``keep_ckpts`` kept) holds the trainable parameters, the optimizer and LR
scheduler states, the step and the EMA shadow; frozen weights come from the
engine's initial weights.  Every step draws its randomness from a generator
seeded by (seed, step), so a resumed run continues as the uninterrupted one
would.  Validation sampling (``sample_every``), wandb and multi-GPU training
are not ported (ROADMAP queue 1, "the rest of training").
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import signal
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from ..models.engine import CCEditEngine
from ..ops.attention import quantized_qk_enabled


def assert_exact_arithmetic() -> None:
    """Refuse to train with the int8 QK^T attention on (the JAX trainer's
    guard, QK half only: the port has no W8A8 path).  round() has zero
    gradient almost everywhere, so the quantized attention's gradient is
    the exact recompute's (``QuantizedSpatialAttention``, as in the JAX
    package): an int8 forward under an exact backward is an inconsistent
    pair to train on."""
    if quantized_qk_enabled():
        raise RuntimeError("training requires exact arithmetic: unset CCEDIT_QUANT_QK/"
                           "CCEDIT_INT8 or call set_quantized_qk(False) before fit()")


def scale_learning_rate(base_lr: float, accumulate: int, n_devices: int,
                        batch_size: int, cap: float = 1e-4) -> float:
    """lr = accumulate * n_devices * batch_size * base_lr, capped."""
    return min(accumulate * n_devices * batch_size * base_lr, cap)


@dataclasses.dataclass
class TrainerConfig:
    logdir: str = "logs/run"
    max_steps: int = 1000
    ckpt_every: int = 500  # 0: no checkpoints at all (timing runs)
    log_every: int = 10
    sample_every: int = 0
    accumulate_grad_batches: int = 1
    base_lr: float = 1e-4
    scale_lr: bool = True
    lr_cap: float = 1e-4
    seed: int = 42
    keep_ckpts: int = 3
    autocast_dtype: Optional[torch.dtype] = None


@dataclasses.dataclass
class FitResult:
    step: int
    lr: float
    losses: List[float]
    step_seconds: List[float]  # host seconds of each logged window, per batch
    ema: Optional[object] = None


class Trainer:
    def __init__(self, engine: CCEditEngine, cfg: TrainerConfig,
                 lr_schedule: Optional[Callable[[int], float]] = None):
        if cfg.sample_every:
            raise NotImplementedError("validation sampling (sample_every) is not ported yet "
                                      "(ROADMAP queue 1, 'the rest of training')")
        self.engine = engine
        self.cfg = cfg
        self.lr_schedule = lr_schedule
        self.logdir = Path(cfg.logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.ckpt_dir = self.logdir / "checkpoints"
        self.device = next(engine.network.parameters()).device

    # -- checkpointing ------------------------------------------------
    def checkpoints(self) -> List[Path]:
        """Saved checkpoints, oldest first."""
        return sorted(self.ckpt_dir.glob("step_*.pt"))

    def save(self, step: int, optimizer, scheduler, ema) -> None:
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        state = {"step": step,
                 "trainable": {n: p.detach().cpu() for n, p in self.engine.trainable_parameters().items()},
                 "optimizer": optimizer.state_dict(),
                 "lr_scheduler": scheduler.state_dict() if scheduler is not None else None,
                 "ema": ema.state_dict() if ema is not None else None}
        path = self.ckpt_dir / f"step_{step:09d}.pt"
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.checkpoints()[:-self.cfg.keep_ckpts]:
            old.unlink()

    def try_restore(self, optimizer, scheduler, ema) -> int:
        """Load the newest checkpoint, if any; returns its step (0 without)."""
        saved = self.checkpoints()
        if not saved:
            return 0
        state = torch.load(saved[-1], map_location="cpu", weights_only=True)
        params = self.engine.trainable_parameters()
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(state["trainable"][n])
        optimizer.load_state_dict(state["optimizer"])
        if scheduler is not None:
            scheduler.load_state_dict(state["lr_scheduler"])
        if ema is not None:
            if state["ema"] is None:  # re-seed from the restored weights
                ema.__init__(params, ema.decay, ema.use_num_updates)
                ema.num_updates = int(state["step"])
                print("[resume] checkpoint has no EMA shadow; re-seeded from restored params")
            else:
                ema.load_state_dict(state["ema"])
        print(f"[resume] restored step {state['step']} from {saved[-1]}")
        return int(state["step"])

    # -- logging ------------------------------------------------------
    def _log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, **metrics}
        csv_path = self.logdir / "metrics.csv"
        write_header = not csv_path.exists()
        with open(csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if write_header:
                w.writeheader()
            w.writerow(row)
        with open(self.logdir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")

    # -- main loop ----------------------------------------------------
    def fit(self, loader, batch_size: int, resume: bool = True) -> FitResult:
        assert_exact_arithmetic()
        cfg, eng = self.cfg, self.engine
        lr = (scale_learning_rate(cfg.base_lr, cfg.accumulate_grad_batches, 1, batch_size,
                                  cfg.lr_cap) if cfg.scale_lr else cfg.base_lr)
        optimizer = eng.make_optimizer(lr)
        scheduler = None
        if self.lr_schedule is not None:  # clamped past max_steps, as the JAX table is
            scheduler = torch.optim.lr_scheduler.LambdaLR(
                optimizer, lambda n: float(self.lr_schedule(min(n, cfg.max_steps))))
        ema = eng.make_ema() if eng.use_ema else None
        step = self.try_restore(optimizer, scheduler, ema) if resume else 0
        checkpointing = cfg.ckpt_every > 0

        usr1 = {"save": False}

        def on_usr1(signum, frame):
            usr1["save"] = True

        try:
            prev_handler = signal.signal(signal.SIGUSR1, on_usr1)
        except (ValueError, OSError):
            prev_handler = None  # not the main thread: no hook
        gen = torch.Generator(device=self.device)
        result = FitResult(step, lr, [], [])
        accum = cfg.accumulate_grad_batches
        t_last, step_last, t0 = time.perf_counter(), step, time.perf_counter()
        try:
            while step < cfg.max_steps:
                for batch in loader:
                    if step >= cfg.max_steps:
                        break
                    gen.manual_seed(cfg.seed * 1_000_003 + step)
                    loss = eng.train_step(batch, optimizer, gen, ema, scheduler,
                                          cfg.autocast_dtype, accumulate=accum,
                                          apply=(step + 1) % accum == 0)
                    step += 1
                    if step % cfg.log_every == 0:
                        loss_val = float(loss)  # waits for the step to finish
                        now = time.perf_counter()
                        per_step = (now - t_last) / (step - step_last)
                        t_last, step_last = now, step
                        result.losses.append(loss_val)
                        result.step_seconds.append(per_step)
                        print(f"step {step}: loss {loss_val:.4f} ({now - t0:.1f}s)", flush=True)
                        self._log(step, {"loss": loss_val, "seconds": now - t0,
                                         "step_seconds": per_step,
                                         "lr": optimizer.param_groups[0]["lr"]})
                    if checkpointing and (step % cfg.ckpt_every == 0 or usr1["save"]):
                        self.save(step, optimizer, scheduler, ema)
                        usr1["save"] = False
        except BaseException:
            if checkpointing:  # the crash save
                self.save(step, optimizer, scheduler, ema)
            raise
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGUSR1, prev_handler)
        if checkpointing:
            self.save(step, optimizer, scheduler, ema)
        result.step, result.ema = step, ema
        return result
