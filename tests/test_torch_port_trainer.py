"""The port's trainer on the CPU, its own semantics (the JAX trainer's, held
by behaviour): validation sampling, the wandb sink and the SIGUSR2 stack
dump, on ``TV2V_TRAIN_CONFIG`` narrowed to a tiny network and VAE (the
dotlist of ``test_torch_port_train_cli.py``), 3-frame 64x64 synthetic
clips, the EMA on.

* ``sample_every`` 2 over 4 steps samples at steps 1, 2 and 4 (step 1 too,
  as the reference's ImageLogger does), each writing
  ``images/step{step:08d}_{sample,input}.gif`` and ``_panel.png``;
* a sample is drawn from the EMA shadow (the network carries it while the
  sampler runs) and the trained weights are back afterwards;
* a sampler that raises is printed and training goes on to ``max_steps``;
* wandb attaches only with ``WANDB_PROJECT`` set and the module importable
  (a fake one in ``sys.modules``), and gets every logged row; without it
  the run keeps CSV and JSONL;
* SIGUSR2 during ``fit`` dumps every thread's stack and training goes on.
"""

import json
import os
import signal
import sys
import types

import numpy as np
import pytest
import torch

from ccedit_tpu_torch.cli.train import build_train_engine
from ccedit_tpu_torch.config import TV2V_TRAIN_CONFIG, apply_dotlist
from ccedit_tpu_torch.data.dataset import DataLoader, SyntheticVideoDataset
from ccedit_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)
NET = "model.params.network_config.params"
TINY = [f"{prefix}.{key}={value}" for prefix in (NET, f"{NET}.controlnet_config.params")
        for key, value in (("model_channels", 32), ("num_res_blocks", 1), ("num_heads", 2),
                           ("channel_mult", "[1,2]"), ("attention_resolutions", "[2,1]"))] + [
    "model.params.first_stage_config.params.ddconfig.ch=32",
    "model.params.first_stage_config.params.ddconfig.num_res_blocks=1",
    "model.params.conditioner_config.params.emb_models.1.params.fake_annotator=true",
    "model.params.use_ema=true",
]


@pytest.fixture(scope="module")
def cfg():
    return apply_dotlist(TV2V_TRAIN_CONFIG, TINY)


def _loader():
    return DataLoader(SyntheticVideoDataset(n_items=8, num_frames=3, size_hw=(64, 64), seed=0),
                      batch_size=1, seed=0)


def _trainer(cfg, logdir, **kw):
    engine = build_train_engine(cfg, torch.device("cpu"), seed=3)
    return Trainer(engine, TrainerConfig(logdir=str(logdir), ckpt_every=0, log_every=1, seed=3,
                                         sample_steps=2, **kw))


def test_sampling_at_step_one_and_every_n_from_the_ema(cfg, tmp_path):
    trainer = _trainer(cfg, tmp_path, max_steps=4, sample_every=2)
    eng = trainer.engine
    seen = []
    sample = eng.sample

    def recording_sample(*a, **kw):  # the trainable weights the sampler sees
        seen.append({n: p.detach().clone() for n, p in eng.trainable_parameters().items()})
        return sample(*a, **kw)

    log_samples = trainer.log_samples
    shadows, after = [], []

    def recording_log_samples(batch, step, ema=None):
        shadows.append({n: s.clone() for n, s in ema.shadow.items()})
        trained = {n: p.detach().clone() for n, p in eng.trainable_parameters().items()}
        out = log_samples(batch, step, ema)
        after.append(all(torch.equal(p, trained[n])
                         for n, p in eng.trainable_parameters().items()))
        return out

    eng.sample = recording_sample
    trainer.log_samples = recording_log_samples
    result = trainer.fit(_loader(), batch_size=1, resume=False)
    assert result.step == 4 and result.ema is not None
    names = sorted(p.name for p in (tmp_path / "images").iterdir())
    assert names == [f"step{s:08d}_{kind}" for s in (1, 2, 4)
                     for kind in ("input.gif", "panel.png", "sample.gif")]
    assert len(seen) == len(shadows) == 3 and all(after)
    for weights, shadow in zip(seen, shadows):
        for n, s in shadow.items():
            assert torch.equal(weights[n], s), n
    # the shadow differs from the trained weights, so the swap is seen
    trained = eng.trainable_parameters()
    assert any(not torch.equal(shadows[-1][n], trained[n]) for n in trained)
    from PIL import Image

    with Image.open(tmp_path / "images" / "step00000004_panel.png") as panel:
        assert panel.size == (3 * 64, 3 * 64)  # 3 frames; rows input, hint, sample
    with Image.open(tmp_path / "images" / "step00000004_sample.gif") as gif:
        assert gif.n_frames == 3 and gif.size == (64, 64)


def test_a_failed_sample_is_printed_and_training_goes_on(cfg, tmp_path, capsys):
    trainer = _trainer(cfg, tmp_path, max_steps=3, sample_every=2)
    calls = []

    def failing_sample(*a, **kw):
        calls.append(1)
        raise RuntimeError("planted sampler failure")

    trainer.engine.sample = failing_sample
    result = trainer.fit(_loader(), batch_size=1, resume=False)
    assert result.step == 3 and len(calls) == 2  # steps 1 and 2
    out = capsys.readouterr()
    assert "[log_samples] failed at step 1" in out.out and "planted sampler failure" in out.err
    rows = [json.loads(r) for r in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]


def test_wandb_sink_with_a_fake_module(cfg, tmp_path, monkeypatch):
    calls = {"init": [], "log": []}
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: calls["init"].append(kw)
    fake.log = lambda row, step: calls["log"].append((step, dict(row)))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.setenv("WANDB_PROJECT", "ccedit-port-test")
    trainer = _trainer(cfg, tmp_path, max_steps=2)
    trainer.fit(_loader(), batch_size=1, resume=False)
    assert calls["init"] == [dict(project="ccedit-port-test", dir=str(tmp_path), resume="allow")]
    rows = [json.loads(r) for r in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [step for step, _ in calls["log"]] == [1, 2]
    assert [row for _, row in calls["log"]] == rows


def test_without_wandb_the_run_keeps_csv_and_jsonl(cfg, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    monkeypatch.setenv("WANDB_PROJECT", "ccedit-port-test")
    trainer = _trainer(cfg, tmp_path, max_steps=1)
    assert trainer._wandb is None
    assert "wandb unavailable" in capsys.readouterr().out
    monkeypatch.delenv("WANDB_PROJECT")
    assert _trainer(cfg, tmp_path / "b", max_steps=1)._wandb is None
    trainer.fit(_loader(), batch_size=1, resume=False)
    assert (tmp_path / "metrics.csv").exists() and (tmp_path / "metrics.jsonl").exists()


def test_sigusr2_dumps_the_stacks_and_training_goes_on(cfg, tmp_path, capfd):
    trainer = _trainer(cfg, tmp_path, max_steps=2)
    step = trainer.engine.train_step
    sent = []

    def signalling_step(*a, **kw):
        if not sent:
            sent.append(1)
            os.kill(os.getpid(), signal.SIGUSR2)
        return step(*a, **kw)

    trainer.engine.train_step = signalling_step
    before = signal.getsignal(signal.SIGUSR2)
    result = trainer.fit(_loader(), batch_size=1, resume=False)
    assert result.step == 2 and sent
    err = capfd.readouterr().err
    assert "signalling_step" in err and ("Thread" in err or "Stack" in err)
    assert signal.getsignal(signal.SIGUSR2) == before
    assert np.isfinite(result.losses).all()
