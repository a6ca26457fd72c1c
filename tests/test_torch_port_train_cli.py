"""The port's train CLI end to end on the CPU, the counterpart of the JAX
package's ``tests/test_train_efficacy_tv2v.py``: ``cli/train.py`` with no
``-b`` (the TV2V recipe, ``TV2V_TRAIN_CONFIG``), narrowed by dotlist
overrides to a tiny network and VAE, the luminance depth stand-in and
3-frame 64x64 ``--synthetic_data`` clips, with the EMA on.

* 3 steps write metrics (CSV and JSONL, steps 1..3, finite losses) and a
  checkpoint a step holding the trainable parameters, the optimizer, the LR
  scheduler, the step and the EMA shadow;
* the logged LR is ``scale_learning_rate`` of the recipe's base LR times
  the recipe's warm-up multiplier;
* ``-r`` resumes the run from step 3 to step 5: AdamW's step count goes on
  from the restored state, and the step-4 EMA shadow is the LitEma update
  of the restored step-3 shadow; ``merge_ema`` swaps the shadow in and
  restores the trained weights;
* only the UNet's temporal parameters move (the zero-initialised biases
  among them move off zero); every other parameter of the network, the VAE
  and the conditioner is bit-identical to a fresh build from the seed.
"""

import json

import numpy as np
import pytest
import torch

from ccedit_tpu_torch.cli import train as train_cli
from ccedit_tpu_torch.config import build_lr_scheduler
from ccedit_tpu_torch.train.trainer import scale_learning_rate

torch.set_num_threads(1)
SEED = 7
NET = "model.params.network_config.params"
TINY = [f"{prefix}.{key}={value}" for prefix in (NET, f"{NET}.controlnet_config.params")
        for key, value in (("model_channels", 32), ("num_res_blocks", 1), ("num_heads", 2),
                           ("channel_mult", "[1,2]"), ("attention_resolutions", "[2,1]"))] + [
    "model.params.first_stage_config.params.ddconfig.ch=32",
    "model.params.first_stage_config.params.ddconfig.num_res_blocks=1",
    "model.params.conditioner_config.params.emb_models.1.params.fake_annotator=true",
    "model.params.use_ema=true",
    "data.params.train.params.video_length=3",
    "data.params.train.params.resolution=[64,64]",
]
COMMON = ["--device", "cpu", "--batch_size", "1", "--synthetic_data", "--ckpt_every", "1",
          "--log_every", "1", "--seed", str(SEED)]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    logroot = tmp_path_factory.mktemp("train_cli")
    _, first = train_cli.main(["--name", "tiny", "--logdir", str(logroot), "--max_steps", "3"]
                              + COMMON + TINY)
    logdir = next(logroot.glob("*_tiny"))
    rows_after_first = (logdir / "metrics.jsonl").read_text().splitlines()
    engine, second = train_cli.main(["-r", str(logdir), "--max_steps", "5"] + COMMON + TINY)
    return dict(logdir=logdir, first=first, second=second, engine=engine,
                rows_after_first=[json.loads(r) for r in rows_after_first])


def test_three_steps_write_metrics_and_checkpoints(runs):
    assert runs["first"].step == 3
    assert [r["step"] for r in runs["rows_after_first"]] == [1, 2, 3]
    csv_lines = (runs["logdir"] / "metrics.csv").read_text().splitlines()
    assert csv_lines[0].split(",") == ["step", "loss", "seconds", "step_seconds", "lr"]
    assert [int(line.split(",")[0]) for line in csv_lines[1:]] == [1, 2, 3, 4, 5]
    state = _load(runs["logdir"] / "checkpoints" / "step_000000003.pt")
    assert state["step"] == 3
    assert state["trainable"] and state["ema"]["num_updates"] == 3
    assert sorted(state["ema"]["shadow"]) == sorted(state["trainable"])
    assert state["lr_scheduler"] is not None and state["optimizer"]["state"]


def test_logged_lr_is_the_scaled_base_lr_times_the_warm_up(runs):
    assert scale_learning_rate(1e-6, 2, 1, 3) == pytest.approx(6e-6, rel=1e-12)
    assert scale_learning_rate(2e-5, 2, 1, 3) == 1e-4  # the cap
    cfg = json.loads((runs["logdir"] / "configs" / "merged.json").read_text())
    params = cfg["model"]["params"]
    lr = scale_learning_rate(params["base_learning_rate"], 1, 1, 1)
    assert runs["first"].lr == runs["second"].lr == lr
    schedule = build_lr_scheduler(params["scheduler_config"])
    rows = [json.loads(r) for r in (runs["logdir"] / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in rows)
    np.testing.assert_allclose([r["lr"] for r in rows], [lr * schedule(r["step"]) for r in rows],
                               rtol=1e-12, atol=0)


def test_resume_restores_the_optimizer_and_the_ema(runs):
    assert runs["second"].step == 5 and runs["second"].ema.num_updates == 5
    ckpts = runs["logdir"] / "checkpoints"
    assert sorted(p.name for p in ckpts.glob("*.pt")) == [
        "step_000000003.pt", "step_000000004.pt", "step_000000005.pt"]
    s3, s4, s5 = (_load(ckpts / f"step_00000000{n}.pt") for n in (3, 4, 5))
    for state, n in ((s3, 3), (s4, 4), (s5, 5)):
        assert {int(st["step"]) for st in state["optimizer"]["state"].values()} == {n}
    decay = min(runs["engine"].ema_decay, (1.0 + 4) / (10.0 + 4))
    for name, shadow in s3["ema"]["shadow"].items():
        want = shadow - (1.0 - decay) * (shadow - s4["trainable"][name])
        torch.testing.assert_close(s4["ema"]["shadow"][name], want, rtol=0, atol=1e-7)
    for name, value in s5["trainable"].items():
        assert torch.equal(value, runs["engine"].trainable_parameters()[name].detach()), name


def test_merge_ema_swaps_the_shadow_in_and_restores(runs):
    engine, shadow = runs["engine"], runs["second"].ema.shadow
    params = dict(engine.network.named_parameters())
    trained = {n: p.detach().clone() for n, p in params.items()}
    assert any(not torch.equal(shadow[n], trained[n]) for n in shadow)
    with engine.merge_ema(shadow):
        for n, p in params.items():
            assert torch.equal(p, shadow[n] if n in shadow else trained[n]), n
    for n, p in params.items():
        assert torch.equal(p, trained[n]), n


def test_only_temporal_parameters_move(runs):
    cfg = json.loads((runs["logdir"] / "configs" / "merged.json").read_text())
    fresh = train_cli.build_train_engine(cfg, torch.device("cpu"), SEED)
    trained = runs["engine"]
    trainable = set(trained.trainable_parameters())
    assert trainable and all(n.startswith("unet.") and "temporal" in n for n in trainable)
    moved, off_zero = 0, 0
    for module in ("network", "vae", "conditioner"):
        before = dict(getattr(fresh, module).named_parameters())
        for name, p in getattr(trained, module).named_parameters():
            same = torch.equal(p.detach(), before[name].detach())
            if module == "network" and name in trainable:
                moved += not same
                off_zero += bool(not same and not before[name].any())
            else:
                assert same, f"frozen {module} parameter changed: {name}"
    assert moved == len(trainable)
    assert off_zero > 0
