"""CLI smoke of the port on the CPU: ``run_pipeline`` on the bundled bear
clip at tiny widths (64x64, 3 keyframes, 2 steps, ``--fake_annotator``)
writes its mp4s and its ``log_info.json`` ledger, and a second run skips the
job through the ledger."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from ccedit_tpu_torch import config
from ccedit_tpu_torch.cli import pipeline
from ccedit_tpu_torch.data.video import load_video_keyframes
from ccedit_tpu_torch.modules.clip import CLIPTextModel

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
BEAR = ROOT / "docs" / "artifacts" / "bear_smoke" / "bear_original.mp4"
TINY = dict(in_channels=4, out_channels=4, model_channels=32, attention_resolutions=[2, 1],
            num_res_blocks=1, channel_mult=[1, 2], num_heads=2, transformer_depth=1,
            context_dim=16)


@pytest.fixture
def tiny_config(tmp_path, monkeypatch):
    """The built-in TV2V config at tiny widths, as a YAML file; CLIP narrowed
    to the tiny context width."""
    cfg = json.loads(json.dumps(config.TV2V_CONFIG))
    p = cfg["model"]["params"]
    p["network_config"]["params"] = dict(TINY, disable_temporal_text_ca=True, controlnet_config={
        "target": "sgm.modules.diffusionmodules.controlmodel.ControlNet2D",
        "params": dict(TINY, hint_channels=3)})
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2, 2, 2],
                                                         num_res_blocks=1)
    path = tmp_path / "tiny_tv2v.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(config, "CLIPTextModel",
                        lambda: CLIPTextModel(width=16, heads=2, layers=1))
    return str(path)


def test_run_pipeline_on_the_bear_clip(tiny_config, tmp_path, capsys):
    out_dir = tmp_path / "out"
    argv = ["--device", "cpu", "--config_path", tiny_config, "--video_path", str(BEAR),
            "--prompt", "a brown bear walking", "--H", "64", "--W", "64",
            "--num_keyframes", "3", "--sample_steps", "2", "--fake_annotator",
            "--save_path", str(out_dir), "--seed", "0"]
    pipeline.run_pipeline(pipeline.base_parser().parse_args(argv))
    edited = out_dir / "bear_original_00.mp4"
    assert edited.exists() and (out_dir / "bear_original_original.mp4").exists()
    clip = load_video_keyframes(str(edited), 3, 3, 3, (64, 64))
    assert clip.shape == (3, 64, 64, 3) and clip.dtype == np.uint8
    ledger = json.loads((out_dir / "log_info.json").read_text())
    assert list(ledger) == ["bear_original::a brown bear walking"]
    assert ledger["bear_original::a brown bear walking"]["num_samples"] == 1

    pipeline.run_pipeline(pipeline.base_parser().parse_args(argv))
    assert "[skip] bear_original::a brown bear walking already done" in capsys.readouterr().out


def test_unported_options_and_geometry_raise():
    """Every JAX flag is ported now; what still raises, before any engine
    is built, is a geometry the UNet cannot round-trip and the flag
    combinations the JAX pipeline asserts against."""
    for argv, match in ((["--H", "250"], "multiples of 64"),
                        (["--sdedit_denoise_strength", "0.5", "--prior_coefficient_x", "0.3"],
                         "prior_coefficient_x should be 0"),
                        (["--sdedit_denoise_strength", "1.5"], "not in"),
                        (["--basemodel_path", "a.ckpt", "--basemodel_listpath", "list.txt"],
                         "only one of")):
        with pytest.raises(ValueError, match=match):
            pipeline.run_pipeline(pipeline.base_parser().parse_args(argv))


@pytest.mark.parametrize("key,value,match", [
    ("target", "x.ControlledUNetModel2DRAIG", "ControlledUNetModel2DRAIG"),
    ("disable_text_ca", True, "disable_text_ca"),  # a 2-D option: the UNet is pseudo-3D
])
def test_config_rejects_targets_outside_the_slice(key, value, match):
    """The RAIG target and ``disable_text_ca`` on a pseudo-3D UNet were
    refused until the network variants were ported: both now build as the
    JAX ``build_network`` builds them (RAIG's 2-D UNet with its reference
    attention; a pseudo-3D UNet, which has no use for the 2-D option).  What
    the port still refuses raises ``KeyError`` naming it: ``remat_policy``
    (a jax.checkpoint_policies name).  An engine target other than the
    video engines (sgm's ``DiffusionEngine``) was refused too until image
    sampling was ported: it builds now, as in the JAX ``build_engine``,
    without the TV2V engines' freeze-policy mapping."""
    from ccedit_tpu import config as jax_config

    cfg = json.loads(json.dumps(config.TV2V_CONFIG))
    net = cfg["model"]["params"]["network_config"]
    (net if key == "target" else net["params"])[key] = value
    with torch.device("meta"):
        engine = config.build_engine(cfg, fake_annotator=True)
    jnet = jax_config.build_network(net)
    assert engine.network.raig == jnet.raig == (match == "ControlledUNetModel2DRAIG")
    assert engine.network.unet.is_video == (jnet.unet.unet_type == "pseudo-3d")
    other = json.loads(json.dumps(cfg))
    other["model"]["params"]["network_config"]["params"]["remat_policy"] = "dots_saveable"
    with pytest.raises(KeyError, match="remat_policy"), torch.device("meta"):
        config.build_engine(other, fake_annotator=True)
    other = json.loads(json.dumps(cfg))
    other["model"]["target"] = "x.DiffusionEngine"
    other["model"]["params"]["freeze_model"] = "spatial"
    with torch.device("meta"):
        engine = config.build_engine(other, fake_annotator=True)
    assert engine.freeze_policy == jax_config.build_engine(other).freeze_policy == "spatial"


def test_batched_draw_equals_single_draws(tiny_config):
    """``edit_clips`` with batch_size 2 repeats the conditioning along the
    batch axis: with injected noise, each of its two draws equals a single
    draw with that sample's noise."""
    args = pipeline.base_parser().parse_args(["--device", "cpu", "--config_path", tiny_config,
                                              "--fake_annotator", "--seed", "0"])
    engine, _ = pipeline.load_engine(args, 2)
    rs = np.random.RandomState(3)
    frames = rs.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    shape, steps = (2, 3, 8, 8, 4), 2
    init = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    loop = torch.from_numpy(rs.standard_normal((steps,) + shape).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    edit = dict(prompt="a brown bear", negative_prompt="ugly", cfg_scale=7.5, num_steps=steps,
                generator=gen)
    both, latents = pipeline.edit_clips(engine, frames, batch_size=2, init_noise=init,
                                        loop_noise=loop, **edit)
    assert both.shape == (2, 3, 64, 64, 3) and latents.shape == shape
    assert not torch.allclose(latents[0], latents[1])
    for i in range(2):
        one, single = pipeline.edit_clips(engine, frames, init_noise=init[i:i + 1],
                                          loop_noise=loop[:, i:i + 1], **edit)
        np.testing.assert_allclose(latents[i:i + 1].numpy(), single.numpy(), rtol=1e-4, atol=1e-4)
        assert np.abs(both[i].astype(int) - one[0].astype(int)).max() <= 1


def test_num_samples_run_in_chunks_of_batch_size(tiny_config, tmp_path, monkeypatch):
    """``--num_samples 3 --batch_size 2`` draws 2 + 2 samples in two sampler
    calls (the JAX pipeline's loop) and writes the first 3."""
    calls = []
    edit_clips = pipeline.edit_clips

    def counted(*a, **kw):
        calls.append(kw["batch_size"])
        return edit_clips(*a, **kw)

    monkeypatch.setattr(pipeline, "edit_clips", counted)
    out_dir = tmp_path / "out"
    argv = ["--device", "cpu", "--config_path", tiny_config, "--video_path", str(BEAR),
            "--prompt", "a brown bear walking", "--H", "64", "--W", "64",
            "--num_keyframes", "3", "--sample_steps", "2", "--fake_annotator",
            "--num_samples", "3", "--batch_size", "2", "--save_path", str(out_dir)]
    pipeline.run_pipeline(pipeline.base_parser().parse_args(argv))
    assert calls == [2, 2]
    written = sorted(p.name for p in out_dir.glob("bear_original_0*.mp4"))
    assert written == [f"bear_original_{i:02d}.mp4" for i in range(3)]


def test_flags_are_the_jax_clis():
    """Both edit CLIs take every flag of the JAX ``base_parser``, with its
    defaults, choices and actions; the port adds only ``--device``."""
    from ccedit_tpu.cli import pipeline as jax_pipeline

    ref = {a.dest: a for a in jax_pipeline.base_parser()._actions}
    ours = {a.dest: a for a in pipeline.base_parser()._actions}
    assert set(ours) - set(ref) == {"device"} and not set(ref) - set(ours)
    for dest, a in ref.items():
        b = ours[dest]
        assert (b.option_strings, b.default, b.choices, type(b)) == \
            (a.option_strings, a.default, a.choices, type(a)), dest
