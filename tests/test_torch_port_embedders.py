"""The non-text embedders of the port against the JAX package, on the CPU in
fp32: the down-blur identities, ``ConcatTimestepEmbedderND``,
``ClassEmbedder``, ``SpatialRescaler``, ``LowScaleEncoder``,
``GaussianEncoder`` and the in/outpainting hints.  Inputs come from numpy
seeds; the JAX draws are replaced by their overrides (``noise_override``,
``t_override``, ``rand_override``) or made certain (one blur factor, or
probabilities 0 and 1), so both sides compute the same function.  Weights
are the JAX ones, copied.  Tolerance: 1e-5 of the largest magnitude (the
mask hints exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.conditioning import embedders as JE
from ccedit_tpu_torch.conditioning import embedders as TE
from ccedit_tpu_torch.io.jax_params import from_jax

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _x(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 24, 40, 3), (1, 3, 24, 40, 3)])
@pytest.mark.parametrize("factors,probs", [([2.0], None), ([1.5, 3.0], [0.0, 1.0]), ([3.0], None)])
def test_custom_identity_down_blur(shape, factors, probs):
    x = _x(shape)
    j = JE.CustomIdentityEncoder(down_blur_factor=factors, down_blur_probs=probs)
    t = TE.CustomIdentityEncoder(down_blur_factor=factors, down_blur_probs=probs)
    ref = j.embed(None, jnp.asarray(x), rng=jax.random.PRNGKey(0))
    ours = t(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert _rel(ours.numpy(), ref) <= 1e-5
    assert t.wants_generator


def test_custom_identity_fixed_factor_and_identity():
    x = _x((2, 24, 40, 3), 1)
    for kw in ({"downsample_factor": 2}, {}):
        ref = JE.CustomIdentityEncoder(**kw).embed(None, jnp.asarray(x))
        ours = TE.CustomIdentityEncoder(**kw)(torch.from_numpy(x))
        assert _rel(ours.numpy(), ref) <= 1e-5


def test_down_blur_draws_from_the_generator():
    t = TE.CustomIdentityEncoder(down_blur_factor=[1.0, 4.0], down_blur_probs=[0.5, 0.5])
    x = torch.from_numpy(_x((1, 16, 16, 3), 2))
    gen = torch.Generator().manual_seed(3)
    outs = [t(x, generator=gen) for _ in range(16)]
    changed = [bool((o != x).any()) for o in outs]
    assert any(changed) and not all(changed)
    again = [bool((t(x, generator=g) != x).any())
             for g in [torch.Generator().manual_seed(3)] for _ in range(16)]
    assert again == changed


def test_custom_identity_down_cond():
    x = _x((2, 3, 24, 40, 3), 4)
    j = JE.CustomIdentityDownCondEncoder(outdim=8, down_blur_factor=[2.0])
    t = TE.CustomIdentityDownCondEncoder(outdim=8, down_blur_factor=[2.0])
    ref = j.embed(None, jnp.asarray(x), rng=jax.random.PRNGKey(1))
    ours = t(torch.from_numpy(x), generator=torch.Generator().manual_seed(1))
    assert ours.shape == ref.shape == (2, 3, 24, 40, 11)
    assert _rel(ours.numpy(), ref) <= 1e-5
    plain = TE.CustomIdentityDownCondEncoder(outdim=8)(torch.from_numpy(x))
    np.testing.assert_array_equal(plain.numpy(), x)


def test_concat_timestep_and_class_embedders():
    v = np.random.RandomState(5).uniform(0, 1000, (3, 2)).astype(np.float32)
    ref = JE.ConcatTimestepEmbedderND(16).embed(None, jnp.asarray(v))
    ours = TE.ConcatTimestepEmbedderND(16)(torch.from_numpy(v))
    assert _rel(ours.numpy(), ref) <= 1e-5
    ref1 = JE.ConcatTimestepEmbedderND(16).embed(None, jnp.asarray(v[:, 0]))
    assert _rel(TE.ConcatTimestepEmbedderND(16)(torch.from_numpy(v[:, 0])).numpy(), ref1) <= 1e-5
    for seq in (False, True):
        j = JE.ClassEmbedder(8, n_classes=10, add_sequence_dim=seq)
        params = j.init_params(jax.random.PRNGKey(2), None)
        t = TE.ClassEmbedder(8, n_classes=10, add_sequence_dim=seq)
        t.embedding.weight.data = torch.from_numpy(np.asarray(params["embedding"]))
        idx = np.array([0, 3, 9])
        ref = j.embed(params, jnp.asarray(idx))
        ours = t(t.prepare(idx, "cpu"))
        np.testing.assert_array_equal(ours.detach().numpy(), np.asarray(ref))
        np.testing.assert_array_equal(t.get_unconditional_conditioning(2),
                                      j.get_unconditional_conditioning(2))


@pytest.mark.parametrize("kw", [dict(factor=0.5, method="bilinear"),
                                dict(factor=0.5, method="nearest", n_stages=2),
                                dict(factor=0.5, method="area"),
                                dict(factor=0.5, method="bilinear", out_channels=5, kernel_size=3,
                                     bias=True)])
def test_spatial_rescaler(kw):
    x = _x((2, 3, 32, 48, 3), 6)
    j = JE.SpatialRescaler(**kw)
    params = j.init_params(jax.random.PRNGKey(3), x)
    t = TE.SpatialRescaler(in_channels=3, **kw)
    if params is not None:
        t.channel_mapper.weight.data = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(params["kernel"]), (3, 2, 0, 1))))
        t.channel_mapper.bias.data = torch.from_numpy(
            np.random.RandomState(7).standard_normal(5).astype(np.float32))
        params = dict(params, bias=jnp.asarray(t.channel_mapper.bias.data.numpy()))
    ref = j.embed(params, jnp.asarray(x))
    with torch.no_grad():
        ours = t(torch.from_numpy(x))
    assert ours.shape == ref.shape and _rel(ours.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("out_size", [None, 16])
def test_low_scale_encoder(out_size):
    x = _x((2, 8, 8, 4), 8)
    noise = _x((2, 8, 8, 4), 9)
    t_idx = np.array([5, 200])
    j = JE.LowScaleEncoder(max_noise_level=250, out_size=out_size, scale_factor=0.5)
    t = TE.LowScaleEncoder(max_noise_level=250, out_size=out_size, scale_factor=0.5)
    jp = j.prepare(x, noise_override=noise, t_override=t_idx)
    tp = t.prepare(x, "cpu", noise_override=noise, t_override=t_idx)
    assert _rel(tp.numpy(), jp) <= 1e-6
    np.testing.assert_array_equal(t.last_noise_level, j.last_noise_level)
    ref = j.embed(None, jnp.asarray(jp))
    assert _rel(t(tp).numpy(), ref) <= 1e-6
    drawn = t.prepare(x, "cpu", generator=torch.Generator().manual_seed(0))
    assert drawn.shape == x.shape and (t.last_noise_level < 250).all()


def test_gaussian_encoder():
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, resolution=32,
              attn_resolutions=())
    x = _x((2, 32, 32, 3), 10)
    j = JE.GaussianEncoder(**kw)
    params = j.init_params(jax.random.PRNGKey(4), x)
    t = TE.GaussianEncoder(**kw)
    sd = {k[len("encoder."):]: v for k, v in from_jax("vae", {"encoder": params}).items()}
    t.model.load_state_dict(sd)
    noise = _x((2, 16, 16, 4), 11)
    ref_z, ref_kl = j.embed_with_kl(params, jnp.asarray(x), noise_override=noise)
    with torch.no_grad():
        z, kl = t.embed_with_kl(torch.from_numpy(x), noise_override=noise)
        mode = t(torch.from_numpy(x))
    assert z.shape == ref_z.shape == (2, 256, 4)
    assert _rel(z.numpy(), ref_z) <= 1e-4 and _rel(kl.numpy(), ref_kl) <= 1e-4
    assert _rel(mode.numpy(), j.embed(params, jnp.asarray(x))) <= 1e-4
    with pytest.raises(NotImplementedError):
        TE.GaussianEncoder(double_z=False, **kw)


@pytest.mark.parametrize("cls", ["InpaintingEncoder", "OutpaintingEncoder"])
def test_band_hints(cls):
    x = _x((2, 3, 20, 28, 3), 12)
    draws = np.array([0.1, 0.7, 0.4, 0.95], np.float32)
    j, t = getattr(JE, cls)(), getattr(TE, cls)()
    ref = j.embed(None, j.prepare(x, rand_override=draws))
    ours = t(t.prepare(x, "cpu", rand_override=draws))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    drawn = t.prepare(x, "cpu", generator=torch.Generator().manual_seed(0))
    assert drawn.shape == x.shape and (drawn.numpy() == 1.0).any()
