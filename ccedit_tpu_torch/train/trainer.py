"""Training loop (port of ``ccedit_tpu/train/trainer.py``): LR scaling,
gradient accumulation, checkpoints with resume, CSV + JSONL metrics (and
wandb when it imports and ``WANDB_PROJECT`` is set), validation sampling,
data parallelism with optional ZeRO-1, the SIGUSR1 save, the SIGUSR2 stack
dump and the crash save.

fp32 master weights, the loss under ``torch.autocast`` in
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
seeded by (seed, step, rank), so a resumed run continues as the
uninterrupted one would.

Data parallelism (``parallel/mesh.py``; one process a GPU under
``torchrun``, the process group joined before the trainer is built): the
loader gives each rank its block of the global batch, the gradients are
averaged over the ranks before each optimizer step, the LR scales with the
world size, and only rank 0 writes logs, checkpoints and samples.  With
``zero_sharding`` and more than one rank the AdamW state is sharded
(``parallel/zero.py``).  Validation sampling (``sample_every``) samples at
step 1 and every ``sample_every`` steps on the batch's conditioning, from
the EMA weights when there is an EMA, and writes
``images/step{step:08d}_{sample,input}.gif`` and ``_panel.png``; a failure
there is printed and training goes on.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import faulthandler
import json
import os
import signal
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.engine import CCEditEngine
from ..ops.attention import quantized_qk_enabled
from ..ops.quant import quantized_matmul_enabled
from ..parallel import mesh
from ..parallel.zero import full_state_dict, is_zero


def assert_exact_arithmetic() -> None:
    """Refuse to train with either int8 path on (the JAX trainer's guard).
    round() has zero gradient almost everywhere: through W8A8 convs and
    matmuls the gradients are silently wrong, and the quantized attention's
    gradient is the exact recompute's (``QuantizedSpatialAttention``, as in
    the JAX package), an int8 forward under an exact backward."""
    if quantized_matmul_enabled() or quantized_qk_enabled():
        raise RuntimeError(
            "training requires exact arithmetic: unset CCEDIT_QUANT_MATMUL/CCEDIT_QUANT_QK/"
            "CCEDIT_INT8 or call set_quantized_matmul(False) / set_quantized_qk(False) "
            "before fit()")


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
    zero_sharding: bool = False  # ZeRO-1 optimizer-state sharding (world size > 1)
    sample_every: int = 0  # 0: no validation sampling
    sample_steps: int = 10
    negative_prompt: str = "ugly, low quality"
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


def step_seed(seed: int, step: int, rank: int) -> int:
    """The seed of a step's generator on a rank (rank 0's is the
    single-process seed)."""
    return seed * 1_000_003 + step + (rank << 32)


class Trainer:
    def __init__(self, engine: CCEditEngine, cfg: TrainerConfig,
                 lr_schedule: Optional[Callable[[int], float]] = None):
        self.engine = engine
        self.cfg = cfg
        self.lr_schedule = lr_schedule
        self.rank, self.world = mesh.rank(), mesh.world_size()
        self.logdir = Path(cfg.logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.ckpt_dir = self.logdir / "checkpoints"
        self.device = next(engine.network.parameters()).device
        self._wandb = self._init_wandb() if self.rank == 0 else None

    # -- checkpointing ------------------------------------------------
    def checkpoints(self) -> List[Path]:
        """Saved checkpoints, oldest first."""
        return sorted(self.ckpt_dir.glob("step_*.pt"))

    def save(self, step: int, optimizer, scheduler, ema) -> None:
        """Every rank calls it (under ZeRO the optimizer state is gathered
        to rank 0 by a collective); rank 0 writes."""
        optimizer_state = full_state_dict(optimizer)
        if self.rank != 0:
            return
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        state = {"step": step,
                 "trainable": {n: p.detach().cpu() for n, p in self.engine.trainable_parameters().items()},
                 "optimizer": optimizer_state,
                 "lr_scheduler": scheduler.state_dict() if scheduler is not None else None,
                 "ema": ema.state_dict() if ema is not None else None}
        path = self.ckpt_dir / f"step_{step:09d}.pt"
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.checkpoints()[:-self.cfg.keep_ckpts]:
            old.unlink()

    def try_restore(self, optimizer, scheduler, ema) -> int:
        """Load the newest checkpoint, if any, on every rank (under ZeRO
        each keeps its partition of the full optimizer state); returns its
        step (0 without)."""
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
    def _init_wandb(self):
        """The wandb module, initialised, when it imports and
        ``WANDB_PROJECT`` is set; else None (CSV and JSONL only)."""
        project = os.environ.get("WANDB_PROJECT")
        if not project:
            return None
        try:
            import wandb

            wandb.init(project=project, dir=str(self.logdir), resume="allow")
        except Exception as e:  # an optional sink: the run goes on without it
            print(f"[log] wandb unavailable ({e!r}); JSONL/CSV sinks only", flush=True)
            return None
        return wandb

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
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    # -- validation sampling (the reference's ImageLogger / log_images) ----
    def _autocast(self):
        if self.cfg.autocast_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.cfg.autocast_dtype)

    @torch.no_grad()
    def log_samples(self, batch: Dict, step: int, ema=None) -> Path:
        """Sample ``sample_steps`` steps from the current weights (the EMA
        shadow's when ``ema`` is given, swapped in by ``merge_ema`` and
        swapped out after) on the conditioning of a training batch: its
        first clip for video, up to 8 samples for images, with
        ``negative_prompt`` as the unconditional text, noise from a
        generator seeded by ``seed + step``.  Writes
        ``images/step{step:08d}_sample.gif``, ``_input.gif`` and
        ``_panel.png`` (rows: input, hint, sample) for video, the panel
        (inputs over samples) for images.  Returns the image directory."""
        eng = self.engine
        x = np.asarray(batch[eng.input_key])
        is_video = x.ndim == 5
        n_keep = 1 if is_video else min(8, x.shape[0])
        kept = {k: v[:n_keep] for k, v in batch.items()}
        uc_batch = dict(kept, txt=[self.cfg.negative_prompt] * n_keep) if "txt" in kept else kept
        swap = eng.merge_ema(ema.shadow) if ema is not None else contextlib.nullcontext()
        with swap, self._autocast():
            c, uc = eng.conditioner.get_unconditional_conditioning(kept, uc_batch)
            z = eng.encode_first_stage(torch.as_tensor(x[:n_keep], device=self.device))
            gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + step)
            latents = eng.sample(c, uc, z.shape, num_steps=self.cfg.sample_steps, generator=gen)
            samples = eng.decode_first_stage(latents).float().cpu().numpy()
        if not np.isfinite(samples).all():
            raise FloatingPointError(f"validation samples at step {step} are not finite")
        from ..data.video import save_panel_grid, save_video_frames, to_uint8

        out_dir = self.logdir / "images"
        out_dir.mkdir(exist_ok=True)
        prefix = out_dir / f"step{step:08d}"
        if not is_video:  # the batch axis plays the frames of one panel row
            tile = lambda a: np.repeat(a, 3, axis=-1) if a.shape[-1] == 1 else a
            save_panel_grid([tile(x[:n_keep]), tile(samples)], f"{prefix}_panel.png")
            return out_dir
        save_video_frames(to_uint8(samples[0]), f"{prefix}_sample.gif", fps=4)
        save_video_frames(to_uint8(x[0]), f"{prefix}_input.gif", fps=4)
        rows = [x[0]]
        hint = batch.get("control_hint")
        if hint is not None and np.asarray(hint).ndim == 5:
            rows.append(np.asarray(hint)[0])
        save_panel_grid(rows + [samples[0]], f"{prefix}_panel.png")
        return out_dir

    # -- main loop ----------------------------------------------------
    def fit(self, loader, batch_size: int, resume: bool = True) -> FitResult:
        """Train to ``max_steps`` on ``loader``'s batches (each rank's block
        of the global batch); ``batch_size`` is the global batch."""
        assert_exact_arithmetic()
        cfg, eng = self.cfg, self.engine
        lr = (scale_learning_rate(cfg.base_lr, cfg.accumulate_grad_batches, self.world,
                                  batch_size, cfg.lr_cap) if cfg.scale_lr else cfg.base_lr)
        optimizer = eng.make_optimizer(lr, zero=cfg.zero_sharding and self.world > 1)
        reduce_grads = mesh.all_reduce_grads if self.world > 1 else None
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

        def on_usr2(signum, frame):  # the reference drops into pudb; headless: the stacks
            faulthandler.dump_traceback(all_threads=True)

        try:
            prev_handlers = (signal.signal(signal.SIGUSR1, on_usr1),
                             signal.signal(signal.SIGUSR2, on_usr2))
        except (ValueError, OSError):
            prev_handlers = None  # not the main thread: no hooks
        gen = torch.Generator(device=self.device)
        result = FitResult(step, lr, [], [])
        accum = cfg.accumulate_grad_batches
        t_last, step_last, t0 = time.perf_counter(), step, time.perf_counter()
        try:
            while step < cfg.max_steps:
                for batch in loader:
                    if step >= cfg.max_steps:
                        break
                    gen.manual_seed(step_seed(cfg.seed, step, self.rank))
                    loss = eng.train_step(batch, optimizer, gen, ema, scheduler,
                                          cfg.autocast_dtype, accumulate=accum,
                                          apply=(step + 1) % accum == 0,
                                          reduce_grads=reduce_grads)
                    step += 1
                    if step % cfg.log_every == 0:  # waits for the step to finish
                        loss_val = mesh.mean_over_ranks(float(loss))
                        now = time.perf_counter()
                        per_step = (now - t_last) / (step - step_last)
                        t_last, step_last = now, step
                        result.losses.append(loss_val)
                        result.step_seconds.append(per_step)
                        if self.rank == 0:
                            print(f"step {step}: loss {loss_val:.4f} ({now - t0:.1f}s)", flush=True)
                            self._log(step, {"loss": loss_val, "seconds": now - t0,
                                             "step_seconds": per_step,
                                             "lr": optimizer.param_groups[0]["lr"]})
                    # one rank's SIGUSR1 saves on every rank at the same step
                    if checkpointing and (mesh.any_rank(usr1["save"]) or step % cfg.ckpt_every == 0):
                        self.save(step, optimizer, scheduler, ema)
                        usr1["save"] = False
                    # step 1 too: the first grid shows the weights before training moved them
                    if (cfg.sample_every and self.rank == 0
                            and (step % cfg.sample_every == 0 or step == 1)):
                        try:
                            self.log_samples(batch, step, ema)
                        except Exception:  # a failed sample must not end the run
                            print(f"[log_samples] failed at step {step}:", flush=True)
                            traceback.print_exc()
        except BaseException:
            if checkpointing:
                self._crash_save(step, optimizer, scheduler, ema)
            raise
        finally:
            if prev_handlers is not None:
                signal.signal(signal.SIGUSR1, prev_handlers[0])
                signal.signal(signal.SIGUSR2, prev_handlers[1])
        if checkpointing:
            self.save(step, optimizer, scheduler, ema)
        result.step, result.ema = step, ema
        return result

    def _crash_save(self, step: int, optimizer, scheduler, ema) -> None:
        """The crash save (the reference's melk).  Under ZeRO with more
        than one rank it is skipped: gathering the sharded optimizer state
        is a collective that a failed rank would never join, so the other
        ranks would wait in it for ever; the newest periodic checkpoint
        stands.  Otherwise rank 0 writes its own replica, no collective
        involved."""
        if is_zero(optimizer) and self.world > 1:
            print(f"[crash] step {step}: no crash save under ZeRO with {self.world} ranks "
                  "(the state gather is a collective a failed rank would never join); the "
                  "newest periodic checkpoint stands", flush=True)
            return
        self.save(step, optimizer, scheduler, ema)
