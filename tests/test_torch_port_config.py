"""Config and gate parity of the port against the JAX package, on the CPU:
the sampler a ``sampler_config`` builds (its eta, s_noise and
discretization params, and the EDM options, the EDM schedule and img2img
strength the port once refused), ``adm_in_channels`` (once refused, now
``label_emb`` in both), and kernel 1's dispatch gate ``supported`` with its
element size a required keyword."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu import config as jax_config
from ccedit_tpu.ops import spatial_attention as jax_sa
from ccedit_tpu_torch import config
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules.clip import CLIPTextModel
from ccedit_tpu_torch.ops import spatial_attention as sa

TINY = dict(in_channels=4, out_channels=4, model_channels=32, attention_resolutions=[2, 1],
            num_res_blocks=1, channel_mult=[1, 2], num_heads=2, transformer_depth=1,
            context_dim=16)
SAMPLER = {"target": "sgm.modules.diffusionmodules.sampling.DPMPP2SAncestralSampler",
           "params": {"num_steps": 3, "eta": 0.5, "s_noise": 0.9, "discretization_config": {
               "target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization",
               "params": {"linear_start": 0.001, "linear_end": 0.015}}}}


def _tiny_config(sampler_config=None, **unet):
    """The built-in TV2V config at tiny widths, with a sampler config and
    extra UNet params."""
    cfg = json.loads(json.dumps(config.TV2V_CONFIG))
    p = cfg["model"]["params"]
    p["network_config"]["params"] = dict(TINY, disable_temporal_text_ca=True, **unet,
                                         controlnet_config={
        "target": "sgm.modules.diffusionmodules.controlmodel.ControlNet2D",
        "params": dict(TINY, hint_channels=3)})
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2, 2, 2],
                                                         num_res_blocks=1)
    if sampler_config is not None:
        p["sampler_config"] = sampler_config
    return cfg


@pytest.fixture
def tiny_clip(monkeypatch):
    monkeypatch.setattr(config, "CLIPTextModel", lambda: CLIPTextModel(width=16, heads=2, layers=1))


def test_sampler_config_params_reach_the_sampler(tiny_clip):
    """eta, s_noise and the discretization params of a ``sampler_config``
    give the port the JAX engine's sigmas, ancestral split and chain: the
    same toy denoiser and injected noise through both samplers agree."""
    cfg = _tiny_config(SAMPLER)
    ours = config.build_engine(cfg, fake_annotator=True).sampler
    theirs = jax_config.build_engine(cfg).sampler
    assert (ours.eta, ours.s_noise, ours.num_steps) == (0.5, 0.9, 3)
    sigmas = ours.get_sigmas()
    np.testing.assert_array_equal(sigmas, theirs.get_sigmas())
    sig, nxt, down, up = theirs._ancestral_tables(sigmas, 0)
    table = ours.step_table(sigmas)
    for key, want in (("sigma", sig), ("next_sigma", nxt), ("sigma_down", down),
                      ("sigma_up", up)):
        np.testing.assert_array_equal([row[key] for row in table], want.astype(np.float32))
    assert up[0] > 0 and not np.allclose(down, nxt)  # eta < 1 splits the step

    rs = np.random.RandomState(5)
    shape = (1, 2, 4, 4, 4)
    x0 = rs.standard_normal(shape).astype(np.float32)
    noise = rs.standard_normal((3,) + shape).astype(np.float32)

    def denoise(x, sigma):  # works on jax arrays and torch tensors alike
        return 0.5 * x / (1.0 + sigma)

    ref = theirs(denoise, jnp.asarray(x0), jax.random.PRNGKey(0), noise_override=jnp.asarray(noise))
    out = ours(denoise, torch.from_numpy(x0), noise_override=torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    # the same chain at the defaults moves elsewhere: the params matter
    plain = config.build_sampler(None, 3)(denoise, torch.from_numpy(x0),
                                         noise_override=torch.from_numpy(noise))
    assert not np.allclose(plain.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("target,params,match", [
    ("EulerEDMSampler", {"s_churn": 0.5}, "s_churn"),
    ("LinearMultistepSampler", {"order": 4}, "order"),
    ("DPMPP2SAncestralSampler", {"discretization_config": {"target": "EDMDiscretization"}},
     "EDMDiscretization"),
    ("DPMPP2SAncestralSampler", {"discretization_config": {
        "target": "LegacyDDPMDiscretization", "params": {"img2img_strength": 0.5}}},
     "img2img_strength"),
])
def test_unported_sampler_options_raise(target, params, match):
    """These options were refused until the samplers, the EDM schedule and
    the img2img pruning were ported: each now builds what the JAX
    ``build_sampler`` builds, and what still raises is a target neither
    package has (``KeyError`` naming it) or an option its sampler lacks."""
    cfg = {"target": target, "params": dict(params, num_steps=6)}
    ours, ref = config.build_sampler(cfg), jax_config.build_sampler(cfg)
    assert type(ours).__name__ == type(ref).__name__ == target
    np.testing.assert_allclose(ours.get_sigmas(), ref.get_sigmas(), rtol=1e-6, atol=0)
    for key, value in params.items():
        if key != "discretization_config":
            assert getattr(ours, key) == value == getattr(ref, key)
    with pytest.raises(KeyError, match="FooSampler"):
        config.build_sampler({"target": "FooSampler", "params": params})
    if "discretization_config" in params:
        with pytest.raises(KeyError, match="FooDiscretization"):
            config.build_sampler({"target": target, "params": {
                "discretization_config": {"target": "FooDiscretization"}}})
    else:
        with pytest.raises(TypeError, match=match):
            config.build_sampler({"target": "DPMPP2MSampler", "params": {match: 1}})


def test_adm_in_channels_builds_label_emb(tiny_clip):
    """Both builders build ``label_emb`` from ``adm_in_channels`` (the port
    once refused it), and the two networks agree on a ``vector`` cond with
    the same weights (fp32, 1e-4 absolute); the vector moves the output."""
    cfg = _tiny_config(adm_in_channels=12)
    jnet = jax_config.build_engine(cfg).network
    tnet = config.build_engine(cfg, fake_annotator=True).network.eval()
    assert jnet.unet.adm_in_channels == 12
    assert tuple(tnet.unet.label_emb[0][0].weight.shape) == (128, 12)
    rs = np.random.RandomState(3)
    f32 = lambda *s: rs.standard_normal(s).astype(np.float32)
    x, ts = f32(1, 4, 8, 8, 4), np.array([300.0], np.float32)
    cond = {"crossattn": f32(1, 7, 16), "vector": f32(1, 12),
            "control_hint": rs.uniform(-1, 1, (1, 4, 64, 64, 3)).astype(np.float32)}
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ts),
                            jcond)

    def draw(path, s):
        scale = np.sqrt(np.prod(s.shape[:-1])) if path[-1].key == "kernel" else 10.0
        return (rs.standard_normal(s.shape) / scale
                + (path[-1].key == "scale")).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)["params"]
    tnet.unet.load_state_dict(from_jax("unet", params["unet"]))
    tnet.controlnet.load_state_dict(from_jax("controlnet", params["controlnet"]))
    ref = jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), jcond)
    with torch.no_grad():
        tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
        out = tnet(torch.from_numpy(x), torch.from_numpy(ts), tcond)
        other = tnet(torch.from_numpy(x), torch.from_numpy(ts), dict(tcond, vector=tcond["vector"] * 0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert (out - other).abs().max() > 1e-3


@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_supported_matches_the_jax_gate(itemsize):
    shapes = [(n_q, n_k, d) for n_q in (256, 512, 1536, 6144) for n_k in (n_q, 2 * n_q, 100)
              for d in (40, 80, 160)]
    for n_q, n_k, d in shapes:
        assert (sa.supported(n_q, n_k, d, itemsize=itemsize)
                == jax_sa.supported(n_q, n_k, d, itemsize=itemsize)), (n_q, n_k, d)
    with pytest.raises(TypeError):
        sa.supported(6144, 6144, 40)  # no default element size
    with pytest.raises(TypeError):
        sa.supported(6144, 6144, 40, itemsize)  # keyword only
