"""The training slice's modules, port against the JAX package on the CPU in
fp32, on the same inputs (numpy, seeded) and the same injected draws:

* the ``DiscreteSampling`` sigma table, and ``EDMSampling`` from injected
  normals;
* every loss weighting;
* ``StandardDiffusionLoss`` l2 and l1 with sigma, noise and offset-noise
  overrides (``offset_noise_varying_dim=3`` on a (B, T, H, W, C) latent),
  through the same analytic network;
* the three LR schedules at steps 0..N;
* the EMA after several updates;
* classifier-free dropout at rates 0 and 1 (deterministic): Bernoulli
  zeroing, and the legacy empty-string prompt replacement;
* ``freeze_mask`` for every policy on the tiny TV2V and TVI2V networks: the
  port's trainable set equals the JAX mask's, name for name, carried through
  ``io/jax_params.py::from_jax``.

Tolerance 1e-5 (relative on the loss and the weightings, whose values reach
the thousands), 1e-4 absolute where a CLIP text tower runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _TINY, _tiny_batch, _tiny_network
from ccedit_tpu.conditioning.conditioner import Conditioner as JaxConditioner
from ccedit_tpu.conditioning.conditioner import EmbedderSpec as JaxSpec
from ccedit_tpu.conditioning.embedders import CLIPTextEmbedder as JaxCLIPEmbedder
from ccedit_tpu.conditioning.embedders import IdentityEncoder as JaxIdentity
from ccedit_tpu.diffusion import DiscreteDenoiser as JaxDenoiser
from ccedit_tpu.diffusion import loss as jloss
from ccedit_tpu.diffusion import sigma_sampling as jss
from ccedit_tpu.diffusion import weighting as jw
from ccedit_tpu.modules import clip as jclip
from ccedit_tpu.modules import controlnet as jcn
from ccedit_tpu.modules import unet as jun
from ccedit_tpu.train import ema as jema
from ccedit_tpu.train import freeze as jfreeze
from ccedit_tpu.train import lr_schedule as jlr
from ccedit_tpu_torch.conditioning.conditioner import Conditioner, EmbedderSpec
from ccedit_tpu_torch.conditioning.embedders import CLIPTextEmbedder, IdentityEncoder
from ccedit_tpu_torch.diffusion import DiscreteDenoiser, DiscreteSampling, EDMSampling
from ccedit_tpu_torch.diffusion import weighting as tw
from ccedit_tpu_torch.diffusion.loss import StandardDiffusionLoss
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules import clip as tclip
from ccedit_tpu_torch.modules import controlnet as tcn
from ccedit_tpu_torch.modules import unet as tun
from ccedit_tpu_torch.train import ema as tema
from ccedit_tpu_torch.train import freeze as tfreeze
from ccedit_tpu_torch.train import lr_schedule as tlr

torch.set_num_threads(1)
CLIP = dict(width=16, heads=2, layers=1)


def test_discrete_sigma_table_and_edm_sigmas(monkeypatch):
    port, ref = DiscreteSampling(), jss.DiscreteSampling()
    np.testing.assert_allclose(port.sigmas_np, np.asarray(ref.sigmas), rtol=1e-6, atol=0)
    idx = np.array([0, 1, 499, 998, 999])
    np.testing.assert_array_equal(port.idx_to_sigma(torch.from_numpy(idx)).numpy(),
                                  np.asarray(ref.idx_to_sigma(jnp.asarray(idx))))
    drawn = port(64, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (64,) and set(drawn.tolist()) <= set(port.sigmas_np.tolist())

    z = np.random.RandomState(0).standard_normal(7).astype(np.float32)
    monkeypatch.setattr(jss.jax.random, "normal", lambda key, shape: jnp.asarray(z))
    edm_ref = np.asarray(jss.EDMSampling(p_mean=-1.0, p_std=1.5)(jax.random.PRNGKey(0), 7))
    edm = EDMSampling(p_mean=-1.0, p_std=1.5)(7, normals=torch.from_numpy(z))
    np.testing.assert_allclose(edm.numpy(), edm_ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["unit", "edm", "v", "eps"])
def test_weighting(name):
    sigma = np.array([0.03, 0.5, 1.0, 7.3, 14.6], np.float32)
    ref = np.asarray(jw.make_weighting(name)(jnp.asarray(sigma)))
    np.testing.assert_allclose(tw.make_weighting(name)(torch.from_numpy(sigma)).numpy(), ref,
                               rtol=1e-6, atol=0)


def _jax_net(x, c_noise, cond):
    return 0.9 * x + 1e-3 * c_noise.reshape((-1,) + (1,) * (x.ndim - 1)).astype(x.dtype) + cond["a"]


def _port_net(x, c_noise, cond):
    return (0.9 * x + 1e-3 * c_noise.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
            + cond["a"])


@pytest.mark.parametrize("loss_type", ["l2", "l1"])
def test_standard_diffusion_loss(loss_type):
    rs = np.random.RandomState(1)
    shape = (2, 3, 4, 5, 4)  # (B, T, H, W, C)
    x, noise = (rs.standard_normal(shape).astype(np.float32) for _ in range(2))
    a = rs.standard_normal((1, 1, 1, 1, 4)).astype(np.float32)
    table = DiscreteSampling().sigmas_np
    sigmas = table[[300, 700]]
    port_loss = StandardDiffusionLoss(DiscreteSampling(), loss_type, offset_noise_level=0.1,
                                      offset_noise_varying_dim=3)
    ref_loss = jloss.StandardDiffusionLoss(jss.DiscreteSampling(), loss_type,
                                           offset_noise_level=0.1, offset_noise_varying_dim=3)
    vshape = port_loss.offset_shape(shape)
    assert vshape == ref_loss._offset_shape(shape) == (2, 3, 1, 1, 4)
    offset = rs.standard_normal(vshape).astype(np.float32)
    ref = ref_loss(jax.random.PRNGKey(0), _jax_net, JaxDenoiser(scaling="eps", weighting="eps"),
                   {"a": jnp.asarray(a)}, jnp.asarray(x), noise_override=jnp.asarray(noise),
                   sigma_override=jnp.asarray(sigmas), offset_override=jnp.asarray(offset))
    out = port_loss(_port_net, DiscreteDenoiser(), {"a": torch.from_numpy(a)}, torch.from_numpy(x),
                    noise_override=torch.from_numpy(noise),
                    sigma_override=torch.from_numpy(sigmas),
                    offset_override=torch.from_numpy(offset))
    assert out.shape == (2,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=0)


@pytest.mark.parametrize("name,kwargs", [
    ("LambdaWarmUpCosineScheduler",
     dict(warm_up_steps=10, lr_min=0.1, lr_max=1.0, lr_start=0.01, max_decay_steps=50)),
    ("LambdaWarmUpCosineScheduler2",
     dict(warm_up_steps=[5, 5], f_min=[0.1, 0.2], f_max=[1.0, 0.8], f_start=[0.01, 0.05],
          cycle_lengths=[20, 30])),
    ("LambdaLinearScheduler",
     dict(warm_up_steps=[5, 5], f_min=[0.1, 0.2], f_max=[1.0, 0.8], f_start=[1e-6, 0.05],
          cycle_lengths=[20, 30])),
])
def test_lr_schedule(name, kwargs):
    port, ref = tlr.SCHEDULERS[name](**kwargs), getattr(jlr, name)(**kwargs)
    np.testing.assert_allclose([port(n) for n in range(61)], [float(ref(n)) for n in range(61)],
                               rtol=1e-12, atol=1e-15)


def test_ema_after_several_updates():
    rs = np.random.RandomState(2)
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: rs.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    port = tema.Ema({k: torch.from_numpy(v.copy()) for k, v in init.items()}, decay=0.9)
    ref = jema.EmaState.create({k: jnp.asarray(v) for k, v in init.items()}, decay=0.9)
    for _ in range(6):
        params = {k: rs.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        port.update({k: torch.from_numpy(v) for k, v in params.items()})
        ref = ref.update({k: jnp.asarray(v) for k, v in params.items()})
    assert port.num_updates == int(ref.num_updates) == 6
    for k in shapes:
        np.testing.assert_allclose(port.shadow[k].numpy(), np.asarray(ref.shadow[k]),
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def clip_pair():
    rs = np.random.RandomState(3)
    model = jclip.CLIPTextModel(**CLIP)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))
    params = jax.tree_util.tree_map(
        lambda s: (rs.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)["params"]
    jtext = JaxCLIPEmbedder()
    jtext.model = model
    tmodel = tclip.CLIPTextModel(**CLIP)
    tmodel.load_state_dict(from_jax("clip", params))
    return jtext, params, CLIPTextEmbedder(tmodel)


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_ucg_dropout(clip_pair, rate):
    """At rate 1 the legacy prompt replacement gives every prompt the
    embedding of "" and the Bernoulli dropout zeroes the output; at rate 0
    nothing changes."""
    jtext, clip_params, ttext = clip_pair
    vec = np.random.RandomState(4).standard_normal((2, 6)).astype(np.float32)
    batch = {"txt": ["a robot bear", "a red car"], "vec": vec}
    jcond = JaxConditioner([JaxSpec(jtext, "txt", ucg_rate=rate, legacy_ucg_value=""),
                            JaxSpec(JaxIdentity(), "vec", ucg_rate=rate)])
    key = jax.random.PRNGKey(5)
    ref = jcond.embed({"embedder_0": clip_params, "embedder_1": None},
                      jcond.prepare(batch, rng=key, apply_legacy_ucg=True), rng=key,
                      apply_ucg=True)
    tcond = Conditioner([EmbedderSpec(ttext, "txt", ucg_rate=rate, legacy_ucg_value=""),
                         EmbedderSpec(IdentityEncoder(), "vec", ucg_rate=rate)])
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = tcond.embed(tcond.prepare(batch, apply_legacy_ucg=True, generator=gen),
                          apply_ucg=True, generator=gen)
        clean = tcond.embed(tcond.prepare(batch))
        empty = tcond.embed(tcond.prepare({"txt": ["", ""]}))["crossattn"]
    assert sorted(out) == sorted(ref) == ["crossattn", "vector"]
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-4)
    want_txt, want_vec = (empty, torch.zeros_like(clean["vector"])) if rate else (
        clean["crossattn"], clean["vector"])
    torch.testing.assert_close(out["crossattn"], want_txt, rtol=0, atol=0)
    torch.testing.assert_close(out["vector"], want_vec, rtol=0, atol=0)


def _tv2v_jax_network():
    return jcn.CCEditNetwork(
        unet=jun.UNetModel(unet_type="pseudo-3d", disable_temporal_text_ca=True, **_TINY),
        controlnet=jcn.ControlNet2D(hint_channels=3, **_TINY))


def _tv2v_port_network():
    return tcn.CCEditNetwork(tun.UNetModel(unet_type="pseudo-3d", **_TINY),
                             tcn.ControlNet2D(hint_channels=3, **_TINY))


def _tvi2v_port_network():
    return tcn.CCEditNetwork(
        tun.UNetModel(unet_type="pseudo-3d", enable_attention3d_crossframe=True,
                      st3dca_ca_type="center_self", **_TINY),
        tcn.ControlNet2D(hint_channels=3, **_TINY),
        tcn.ControlNet2D(hint_channels=4, input_hint_identity=True, no_add_x=True,
                         disable_text_ca=True, **_TINY),
        crossframe_type="reference")


@pytest.fixture(scope="module")
def networks():
    x, tt, cond = _tiny_batch()
    tv2v_cond = {k: v for k, v in cond.items() if k != "cond_feat"}
    out = {}
    for name, jnet, args, port in (
            ("tv2v", _tv2v_jax_network(), (x, tt, tv2v_cond), _tv2v_port_network()),
            ("tvi2v", _tiny_network(), (x, tt, cond), _tvi2v_port_network())):
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), *args)["params"]
        out[name] = (shapes, port)
    return out


@pytest.mark.parametrize("policy", tfreeze.FREEZE_POLICIES)
@pytest.mark.parametrize("net", ["tv2v", "tvi2v"])
def test_freeze_mask_matches_jax_name_for_name(networks, net, policy):
    shapes, port = networks[net]
    jmask = jfreeze.freeze_mask(shapes, policy)
    ours = tfreeze.freeze_mask(port.named_parameters(), policy)
    theirs = {}
    for branch, tree in jmask.items():
        # carry the mask through the weight converter: 1.0 = trainable
        as_arrays = jax.tree_util.tree_map(
            lambda m, s: np.full(s.shape, float(m), np.float32), tree, shapes[branch])
        kind = "unet" if branch == "unet" else "controlnet"
        for name, value in from_jax(kind, as_arrays).items():
            assert bool(value.min()) == bool(value.max())
            theirs[f"{branch}.{name}"] = bool(value.max())
    assert ours == theirs
    counts = tfreeze.count_trainable(port.named_parameters(), ours)
    assert counts["trainable"] + counts["frozen"] == counts["total"]
    if net == "tv2v" and policy == "spatial_tv2v":  # the TV2V recipe: temporal layers only
        trainable = [n for n, t in ours.items() if t]
        assert trainable and all("temporal" in n and n.startswith("unet.") for n in trainable)
