"""The port's samplers, discretizations, scalings and denoisers against the
JAX package, on the CPU in fp32.

Every sampler x {full, skip_steps, img2img strength 0.5, inpaint, blend}
runs the same toy ``denoise_fn`` from the same start on both sides.  The
JAX side runs its production path, drawing from ``jax.random``; the port is
handed those same draws as injected rows (``noise_override``): the test
replays the JAX samplers' key schedule (three-way splits a scan row, two-way
for DPM++2M and LMS; two rows a step where DPM++2S has a midpoint or Heun a
correction) and draws ``jax.random.normal`` from each key the JAX loop
uses.  Tolerance: max|port - jax| <= 1e-5 * max|jax|, the fp32 rounding of
a few steps.  The EDM and img2img schedules and the three scalings are held
to 1e-6; ``build_sampler``, ``build_denoiser`` and ``build_engine`` to the
JAX builders on inline config dicts.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu import config as jax_config
from ccedit_tpu.diffusion import discretization as jdisc
from ccedit_tpu.diffusion import samplers as jsamp
from ccedit_tpu.diffusion import scaling as jscal
from ccedit_tpu_torch import config
from ccedit_tpu_torch.diffusion import denoiser as tden
from ccedit_tpu_torch.diffusion import discretization as tdisc
from ccedit_tpu_torch.diffusion import samplers as tsamp
from ccedit_tpu_torch.diffusion import scaling as tscal
from ccedit_tpu_torch.modules.clip import CLIPTextModel

torch.set_num_threads(1)
STEPS, SKIP = 4, 2
IMG2IMG_STEPS = 8  # strength 0.5 keeps 4 of its 9 sigmas: 3 steps
SHAPE = (1, 5, 4, 4, 4)  # odd T: blending re-seeds frames [:2] from [3:]
OPTIONS = {
    "euler": dict(s_churn=1.0, s_tmin=1.0),  # churn only above sigma 1
    "heun": dict(s_churn=1.0, s_tmin=1.0),
    "euler_ancestral": dict(eta=1.0, s_noise=0.9),
    "dpmpp_2s_ancestral": dict(),
    "dpmpp_2m": dict(),
    "lms": dict(order=3),
}
MODES = ("full", "skip_steps", "img2img", "inpaint", "blend")


def denoise(x, sigma):  # jax arrays and torch tensors alike
    return 0.5 * x / (1.0 + sigma) + 0.1


def _split_rows(name, sig, nxt, eta):
    """Scan rows of each executed step in the JAX loop (DPM++2S: midpoint;
    Heun: correction) and the row whose key draws the loop noise."""
    if name == "dpmpp_2s_ancestral":
        down, _ = jsamp.get_ancestral_step(sig, nxt, eta)
        n = 2 if down >= 1e-14 else 1
        return n, n - 1
    if name == "heun":
        return (2 if nxt > 1e-14 else 1), 0
    return 1, 0


def jax_draws(name, sigmas, start, rng):
    """The draws of the JAX sampler ``name`` from ``rng``: the pre-step
    hook's and the loop's, one row each per executed step."""
    n = len(sigmas) - 1 - start
    pre, loop = np.zeros((n,) + SHAPE, np.float32), np.zeros((n,) + SHAPE, np.float32)
    ways = 2 if name in ("dpmpp_2m", "lms") else 3
    for i in range(n):
        rows, loop_row = _split_rows(name, sigmas[start + i], sigmas[start + i + 1],
                                     OPTIONS[name].get("eta", 1.0))
        for r in range(rows):
            rng, *keys = jax.random.split(rng, ways)
            if r == 0:
                pre[i] = np.asarray(jax.random.normal(keys[0], SHAPE, jnp.float32))
            if ways == 3 and r == loop_row:
                loop[i] = np.asarray(jax.random.normal(keys[1], SHAPE, jnp.float32))
    return pre, loop


def _discretizations(mode):
    kw = {"img2img_strength": 0.5} if mode == "img2img" else {}
    return jdisc.make_discretization("legacy_ddpm", **kw), tdisc.make_discretization(
        "legacy_ddpm", **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_sampler_mode_matches_jax(name, mode):
    rs = np.random.RandomState(10 * sorted(OPTIONS).index(name) + MODES.index(mode))
    x = rs.standard_normal(SHAPE).astype(np.float32)
    x0 = rs.standard_normal(SHAPE).astype(np.float32)
    mask = (rs.rand(*SHAPE[:-1], 1) > 0.5).astype(np.float32)
    jd, td = _discretizations(mode)
    steps = IMG2IMG_STEPS if mode == "img2img" else STEPS
    jsm = jsamp.make_sampler(name, discretization=jd, num_steps=steps, **OPTIONS[name])
    tsm = tsamp.make_sampler(name, discretization=td, num_steps=steps, **OPTIONS[name])
    sigmas = jsm.get_sigmas()
    np.testing.assert_array_equal(tsm.get_sigmas(), sigmas)
    rng = jax.random.PRNGKey(7)
    start = len(sigmas) - 1 - SKIP if mode == "skip_steps" else 0
    pre, loop = jax_draws(name, sigmas, start, rng)
    t = torch.from_numpy
    rows = {"pre": t(pre)} if mode in ("inpaint", "blend") else {}
    if tsm.draws_loop_noise:
        rows["loop"] = t(loop)
    rows = rows or None

    if mode == "skip_steps":
        ref = jsm.sdedit(SKIP, denoise, jnp.asarray(x), rng)
        out = tsm.sdedit(SKIP, denoise, t(x), noise_override=rows)
    elif mode == "inpaint":
        ref = jsm.sample_inpainting(denoise, jnp.asarray(x), rng, jnp.asarray(x0),
                                    jnp.asarray(mask))
        out = tsm.sample_inpainting(denoise, t(x), t(x0), t(mask), noise_override=rows)
    elif mode == "blend":
        ref = jsm.sampling_blending(denoise, jnp.asarray(x), rng, jnp.asarray(x0))
        out = tsm.sampling_blending(denoise, t(x), t(x0), noise_override=rows)
    else:
        ref = jsm(denoise, jnp.asarray(x), rng)
        out = tsm(denoise, t(x), noise_override=rows)
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and tuple(out.shape) == SHAPE
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_generator_draws_only_what_each_step_uses():
    """Without injected rows, the loop noise is drawn only where used: an
    ancestral sampler's last step (next_sigma = 0) and EDM steps with gamma
    = 0 draw nothing, so the generator ends where the used rows end."""
    x = torch.zeros(SHAPE)
    for sampler, used in ((tsamp.EulerAncestralSampler(num_steps=STEPS), STEPS - 1),
                          (tsamp.EulerEDMSampler(num_steps=STEPS, s_churn=1.0, s_tmin=1.0),
                           None)):
        gen = torch.Generator().manual_seed(0)
        sampler(denoise, x, generator=gen)
        sigmas = sampler.get_sigmas()
        if used is None:
            used = int((sampler._gammas(sigmas) > 0).sum())
        ref = torch.Generator().manual_seed(0)
        for _ in range(used):
            torch.randn(SHAPE, generator=ref)
        assert torch.equal(torch.randn(3, generator=gen), torch.randn(3, generator=ref))


def test_injected_rows_are_checked():
    sampler = tsamp.DPMPP2MSampler(num_steps=STEPS)
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="no loop noise"):
        sampler(denoise, x, noise_override=torch.zeros((STEPS,) + SHAPE))
    with pytest.raises(ValueError, match="one row per sampler step"):
        tsamp.EulerAncestralSampler(num_steps=STEPS)(
            denoise, x, noise_override=torch.zeros((STEPS - 1,) + SHAPE))


@pytest.mark.parametrize("n,params", [(5, {}), (7, dict(sigma_min=0.1, sigma_max=20.0, rho=5.0))])
@pytest.mark.parametrize("strength", [None, 0.5, 0.25])
def test_edm_and_img2img_sigmas(n, params, strength):
    kw = dict(params, **({} if strength is None else {"img2img_strength": strength}))
    ref = jdisc.make_discretization("edm", **kw)(n)
    ours = tdisc.make_discretization("edm", **kw)(n)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    legacy = jdisc.make_discretization("legacy_ddpm", **({} if strength is None else
                                                         {"img2img_strength": strength}))
    ours = tdisc.make_discretization("legacy_ddpm", **({} if strength is None else
                                                       {"img2img_strength": strength}))
    for flip in (False, True):
        np.testing.assert_allclose(ours(n, flip=flip), legacy(n, flip=flip), rtol=1e-6, atol=0)
    if strength is not None:
        assert len(ours(n)) == max(int(strength * (n + 1)), 1)


@pytest.mark.parametrize("name,kwargs", [("eps", {}), ("edm", {}), ("edm", {"sigma_data": 1.0}),
                                         ("v", {})])
def test_scalings(name, kwargs):
    sigma = np.asarray([0.03, 0.5, 1.0, 14.6], np.float32)[:, None]
    ref = jscal.make_scaling(name, **kwargs)(jnp.asarray(sigma))
    ours = tscal.SCALINGS[name](**kwargs)(torch.from_numpy(sigma))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def _toy_net(x, c_noise, cond):  # jax arrays and torch tensors alike
    c = c_noise.reshape((-1,) + (1,) * (x.ndim - 1))
    return 0.3 * x + 0.01 * c + cond


def _sgm(name, **params):
    return {"target": f"sgm.x.{name}", "params": params}


DENOISERS = [
    _sgm("DiscreteDenoiser", num_idx=1000, scaling_config=_sgm("EpsScaling"),
         discretization_config=_sgm("LegacyDDPMDiscretization")),
    _sgm("DiscreteDenoiser", num_idx=1000, scaling_config=_sgm("VScaling"),
         weighting_config=_sgm("VWeighting"),
         discretization_config=_sgm("LegacyDDPMDiscretization", linear_start=0.001)),
    _sgm("Denoiser", scaling_config=_sgm("EDMScaling"), weighting_config=_sgm("EDMWeighting")),
    _sgm("Denoiser", scaling_config=_sgm("VScaling")),
    _sgm("Denoiser", scaling_config=_sgm("EpsScaling")),
]


@pytest.mark.parametrize("cfg", DENOISERS, ids=lambda c: f"{c['target'][6:]}-"
                         f"{c['params']['scaling_config']['target'][6:]}")
def test_build_denoiser(cfg):
    ref_d = jax_config.build_denoiser(cfg)
    ours_d = config.build_denoiser(cfg)
    assert type(ours_d).__name__ == type(ref_d).__name__
    rs = np.random.RandomState(1)
    x = rs.standard_normal((3, 2, 4, 4)).astype(np.float32)
    sigma = np.asarray([0.05, 1.3, 11.0], np.float32)
    ref = ref_d(_toy_net, jnp.asarray(x), jnp.asarray(sigma), 0.2)
    ours = ours_d(_toy_net, torch.from_numpy(x), torch.from_numpy(sigma), 0.2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours_d.w(torch.from_numpy(sigma)).numpy(),
                               np.asarray(ref_d.w(jnp.asarray(sigma))), rtol=1e-6)


SAMPLER_CONFIGS = [
    _sgm("EulerEDMSampler", num_steps=5, s_churn=0.5, s_tmin=0.1, s_tmax=10.0, s_noise=1.003,
         discretization_config=_sgm("EDMDiscretization", sigma_max=40.0)),
    _sgm("HeunEDMSampler", num_steps=4,
         discretization_config=_sgm("LegacyDDPMDiscretization", img2img_strength=0.5)),
    _sgm("EulerAncestralSampler", num_steps=6, eta=0.7, s_noise=0.9),
    _sgm("DPMPP2SAncestralSampler", num_steps=3, eta=0.5),
    _sgm("DPMPP2MSampler", num_steps=8, discretization_config=_sgm("EDMDiscretization")),
    _sgm("LinearMultistepSampler", num_steps=6, order=2),
]


@pytest.mark.parametrize("cfg", SAMPLER_CONFIGS, ids=lambda c: c["target"][6:])
def test_build_sampler(cfg):
    ref = jax_config.build_sampler(cfg)
    ours = config.build_sampler(cfg)
    assert type(ours).__name__ == type(ref).__name__
    for k in ("num_steps", "s_churn", "s_tmin", "s_tmax", "s_noise", "eta", "order"):
        assert getattr(ours, k, None) == getattr(ref, k, None), k
    np.testing.assert_allclose(ours.get_sigmas(), ref.get_sigmas(), rtol=1e-6, atol=0)


def test_build_engine_takes_every_scaling_and_the_continuous_denoiser(monkeypatch):
    """An inline TV2V config at tiny widths with the continuous ``Denoiser``
    on v scaling and an EDM-schedule Heun sampler builds in both packages,
    and the two denoisers and samplers agree."""
    monkeypatch.setattr(config, "CLIPTextModel", lambda: CLIPTextModel(width=16, heads=2, layers=1))
    tiny = dict(in_channels=4, out_channels=4, model_channels=32, attention_resolutions=[2, 1],
                num_res_blocks=1, channel_mult=[1, 2], num_heads=2, transformer_depth=1,
                context_dim=16)
    cfg = json.loads(json.dumps(config.TV2V_CONFIG))
    p = cfg["model"]["params"]
    p["network_config"]["params"] = dict(tiny, disable_temporal_text_ca=True, controlnet_config={
        "target": "sgm.x.ControlNet2D", "params": dict(tiny, hint_channels=3)})
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2, 2, 2],
                                                         num_res_blocks=1)
    p["denoiser_config"] = DENOISERS[3]
    p["sampler_config"] = SAMPLER_CONFIGS[1]
    ref = jax_config.build_engine(cfg)
    ours = config.build_engine(cfg, fake_annotator=True)
    assert type(ours.denoiser) is tden.Denoiser
    assert type(ours.sampler) is tsamp.HeunEDMSampler
    np.testing.assert_allclose(ours.sampler.get_sigmas(), ref.sampler.get_sigmas(), rtol=1e-6)
    x = np.random.RandomState(2).standard_normal((2, 4)).astype(np.float32)
    sigma = np.asarray([0.4, 3.0], np.float32)
    np.testing.assert_allclose(
        ours.denoiser(_toy_net, torch.from_numpy(x), torch.from_numpy(sigma), 0.0).numpy(),
        np.asarray(ref.denoiser(_toy_net, jnp.asarray(x), jnp.asarray(sigma), 0.0)),
        rtol=1e-6, atol=1e-6)
