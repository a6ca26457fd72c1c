"""``cli/train.py -b`` on a YAML of ``TVI2V_TRAIN_CONFIG`` at tiny widths (the
three networks narrowed, CLIP at width 16, the stand-in depth hint, the EMA
on, 3-frame 64x64 synthetic clips whose ``cond_img`` is the centre frame),
on the CPU: 3 steps with validation sampling every 2 steps, then ``-r`` to
step 5.

* metrics for steps 1..5 and a checkpoint at every step (the newest 3 kept);
* the samples at steps 1, 2 and 4 (the resumed run samples at step 4),
  each a sample and an input gif and a panel;
* the resume restores AdamW (its step counts go on) and the EMA;
* only ``spatial_tv2v``'s tensors move (the UNet's temporal layers, the
  CFCA's ``*_temporal_ca``, ``controlnet_img``); the structure ControlNet,
  the rest of the UNet, the VAE and the conditioner are bit-identical to a
  fresh build from the seed.
"""

import copy
import json

import pytest
import torch
import yaml

from ccedit_tpu_torch import config
from ccedit_tpu_torch.cli import train as train_cli
from ccedit_tpu_torch.modules.clip import CLIPTextModel

torch.set_num_threads(1)
SEED = 11
TINY = dict(model_channels=32, attention_resolutions=[2, 1], num_res_blocks=1,
            channel_mult=[1, 2], num_heads=2, context_dim=16)
COMMON = ["--device", "cpu", "--synthetic_data", "--ckpt_every", "1", "--log_every", "1",
          "--seed", str(SEED), "--sample_every", "2", "--sample_steps", "2"]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = copy.deepcopy(config.TVI2V_TRAIN_CONFIG)
    p = cfg["model"]["params"]
    net = p["network_config"]["params"]
    for params in (net, net["controlnet_config"]["params"], net["controlnet_img_config"]["params"]):
        params.update(TINY)
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, num_res_blocks=1)
    p["conditioner_config"]["params"]["emb_models"][1]["params"]["fake_annotator"] = True
    p["use_ema"] = True
    cfg["data"]["params"]["train"]["params"].update(video_length=3, resolution=[64, 64])
    root = tmp_path_factory.mktemp("tvi2v_train_cli")
    yaml_path = root / "tiny_tvi2v_train.yaml"
    yaml_path.write_text(yaml.safe_dump(cfg))
    clip_model = config.CLIPTextModel
    config.CLIPTextModel = lambda: CLIPTextModel(width=16, heads=2, layers=1)
    try:
        _, first = train_cli.main(["-b", str(yaml_path), "--logdir", str(root / "logs"),
                                   "--max_steps", "3"] + COMMON)
        logdir = next((root / "logs").glob("*_tiny_tvi2v_train"))
        engine, second = train_cli.main(["-r", str(logdir), "--max_steps", "5"] + COMMON)
        merged = json.loads((logdir / "configs" / "merged.json").read_text())
        fresh = train_cli.build_train_engine(merged, torch.device("cpu"), SEED)
    finally:
        config.CLIPTextModel = clip_model
    return dict(logdir=logdir, first=first, second=second, engine=engine, fresh=fresh)


def test_five_steps_metrics_checkpoints_and_samples(runs):
    assert runs["first"].step == 3 and runs["second"].step == 5
    rows = [json.loads(r) for r in (runs["logdir"] / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert all(r["loss"] > 0 for r in rows)
    ckpts = sorted(p.name for p in (runs["logdir"] / "checkpoints").glob("*.pt"))
    assert ckpts == [f"step_00000000{n}.pt" for n in (3, 4, 5)]
    images = sorted(p.name for p in (runs["logdir"] / "images").iterdir())
    assert images == [f"step{s:08d}_{kind}" for s in (1, 2, 4)
                      for kind in ("input.gif", "panel.png", "sample.gif")]


def test_resume_restores_adamw_and_the_ema(runs):
    ckpts = runs["logdir"] / "checkpoints"
    for n in (3, 4, 5):
        state = _load(ckpts / f"step_00000000{n}.pt")
        assert {int(s["step"]) for s in state["optimizer"]["state"].values()} == {n}
        assert state["ema"]["num_updates"] == n
    assert runs["second"].ema.num_updates == 5


def test_only_the_tvi2v_trainable_set_moves(runs):
    trained, fresh = runs["engine"], runs["fresh"]
    trainable = set(trained.trainable_parameters())
    assert any(n.startswith("controlnet_img.") for n in trainable)
    assert any("_temporal_ca" in n for n in trainable)
    assert not any(n.startswith("controlnet.") for n in trainable)
    moved = 0
    for module in ("network", "vae", "conditioner"):
        before = dict(getattr(fresh, module).named_parameters())
        for name, p in getattr(trained, module).named_parameters():
            same = torch.equal(p.detach(), before[name].detach())
            if module == "network" and name in trainable:
                moved += not same
            else:
                assert same, f"frozen {module} parameter changed: {name}"
    assert moved == len(trainable)
