"""The VAE-training slice's modules on the CPU, port against the JAX package
in fp32: LPIPS (full VGG16), the PatchGAN discriminator (batch statistics),
the GAN losses, ``DiagonalGaussian``'s KL and NLL, the VAE with attention
blocks at ``attn_resolutions`` (the repair), ``LatentLPIPS``, the config
builders, kernel 4's plain d = 512 backward and the ``FlashAttention``
Function's CPU path, and the kernel-7 sweep's plain version.

Weights are made with numpy from a seed in the JAX layout (the trees'
shapes from ``jax.eval_shape``) and mapped with ``from_jax``; inputs are
numpy too.  Tolerances are stated with each test: fp32 on both sides, so
what differs is summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu import config as jconfig
from ccedit_tpu.models import autoencoder_engine as jae
from ccedit_tpu.modules import discriminator as jdisc
from ccedit_tpu.modules import lpips as jlpips
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu.ops import attention as jatt
from ccedit_tpu_torch import config
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.models import autoencoder_engine as ae
from ccedit_tpu_torch.modules import discriminator as disc
from ccedit_tpu_torch.modules.lpips import LPIPS
from ccedit_tpu_torch.modules.vae import AutoencoderKL, DiagonalGaussian
from ccedit_tpu_torch.ops import attention as port_attention
from ccedit_tpu_torch.ops import flash_attention as fa
from ccedit_tpu_torch.scripts import profile_blocks as pb

torch.set_num_threads(1)
GEOM = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32)


def numpy_params(module, *args, seed: int, method=None):
    """The flax module's parameter tree, every leaf drawn with numpy: conv
    and dense kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), biases
    N(0, 0.05^2)."""
    kw = {} if method is None else {"method": method}
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args)
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            std = int(np.prod(leaf.shape[:-1])) ** -0.5
            return (rs.standard_normal(leaf.shape) * std).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.05 * rs.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


def images(seed, n=2, size=32):
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 2 - 1).astype(np.float32)


@pytest.fixture(scope="module")
def lpips_pair():
    x = jnp.asarray(images(0))
    params = numpy_params(jlpips.LPIPS(), x, x, seed=1)
    port = LPIPS()
    port.load_state_dict(from_jax("lpips", params))  # strict: taming's vgg.pth keys
    return params, port


def test_lpips_matches_jax_in_tamings_layout(lpips_pair):
    """(2, 32, 32, 3) pairs in [-1, 1] through the full VGG16; 1e-5 of the
    output's scale.  The state dict is taming's ``vgg.pth`` layout, and the
    module is frozen in eval mode."""
    params, port = lpips_pair
    a, b = images(2), images(3)
    ref = np.asarray(jlpips.LPIPS().apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    out = port(torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    convs = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    slices = [1, 1, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5]
    taming = {f"net.slice{s}.{i}.{leaf}" for s, i in zip(slices, convs) for leaf in ("weight", "bias")}
    taming |= {f"lin{k}.model.1.weight" for k in range(5)}
    assert set(port.state_dict()) == taming
    port.train()
    assert not port.training and not any(p.requires_grad for p in port.parameters())


@pytest.mark.parametrize("n_layers", [2, 3])
def test_discriminator_matches_jax_with_batch_statistics(n_layers):
    """Two calls on two batches: each normalises with its own batch's
    statistics (train and eval mode alike: no running averages); 1e-5 of the
    logits' scale.  Keys are taming's ``main.{i}``."""
    x0, x1 = images(4), images(5)
    jm = jdisc.NLayerDiscriminator(n_layers=n_layers)
    params = numpy_params(jm, jnp.asarray(x0), seed=6)
    port = disc.NLayerDiscriminator(n_layers=n_layers)
    port.load_state_dict(from_jax("disc", params))
    main = {0, 3 * n_layers + 2} | {3 * n - 1 for n in range(1, n_layers + 1)}
    assert {int(k.split(".")[1]) for k in port.state_dict() if k.endswith("weight")} == (
        main | {3 * n for n in range(1, n_layers + 1)})
    for x in (x0, x1, np.concatenate([x0, x1])):
        ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
        for mode in (True, False):
            out = port.train(mode)(torch.from_numpy(x)).detach().numpy()
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_discriminator_init_is_tamings():
    """``discriminator_init``: conv weights N(0, 0.02), norm scales
    N(1, 0.02), norm biases 0, conv biases U(+-1/sqrt(fan_in)); seeded."""
    gen = torch.Generator().manual_seed(0)
    m = disc.discriminator_init(disc.NLayerDiscriminator(), gen)
    again = disc.discriminator_init(disc.NLayerDiscriminator(), torch.Generator().manual_seed(0))
    for (name, p), q in zip(m.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        layer = m.main[int(name.split(".")[1])]
        if isinstance(layer, torch.nn.Conv2d) and name.endswith("weight"):
            assert abs(p.std().item() - 0.02) < 0.002 and abs(p.mean().item()) < 0.002
        elif isinstance(layer, torch.nn.Conv2d):
            assert p.abs().max().item() <= layer.weight[0].numel() ** -0.5
        elif name.endswith("weight"):
            assert abs(p.mean().item() - 1.0) < 0.01 and 0.01 < p.std().item() < 0.03
        else:
            assert torch.equal(p, torch.zeros_like(p))


@pytest.mark.parametrize("kind", ["hinge", "vanilla"])
def test_gan_losses_match_jax(kind):
    rs = np.random.RandomState(7)
    real, fake = (rs.standard_normal((2, 6, 6, 1)).astype(np.float32) * 2 for _ in range(2))
    ref = getattr(jdisc, f"{kind}_d_loss")(jnp.asarray(real), jnp.asarray(fake))
    out = getattr(disc, f"{kind}_d_loss")(torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)


def test_diagonal_gaussian_matches_jax():
    """mean, std, var, kl(), nll() and an injected-noise sample, with
    log-variances outside the [-30, 20] clamp; rtol 1e-5 (exp in
    fp32 rounds a last bit apart)."""
    rs = np.random.RandomState(8)
    moments = rs.standard_normal((2, 8, 8, 8)).astype(np.float32)
    moments[0, 0, 0, 4:] = (-40.0, 30.0, 0.5, -0.5)
    sample = rs.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = jvae.DiagonalGaussian(jnp.asarray(moments))
    port = DiagonalGaussian(torch.from_numpy(moments))
    for name in ("mean", "std", "var", "logvar"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5)
    np.testing.assert_allclose(port.kl().numpy(), np.asarray(ref.kl()), rtol=1e-5)
    np.testing.assert_allclose(port.nll(torch.from_numpy(sample)).numpy(),
                               np.asarray(ref.nll(jnp.asarray(sample))), rtol=1e-5)
    np.testing.assert_allclose(port.sample(noise=torch.from_numpy(sample)).numpy(),
                               np.asarray(ref.mean + ref.std * sample), rtol=1e-5)


def test_vae_with_attn_resolutions_matches_jax():
    """``attn_resolutions=(16,)``: an attention block after each res block at
    16x16, in the encoder (``encoder.down.1.attn.0``) and the decoder
    (``decoder.up.1.attn.{0,1}``); encode_moments, decode and the forward
    with injected noise against JAX ``AutoencoderKL`` at 1e-4."""
    x = images(9)
    jm = jvae.AutoencoderKL(attn_resolutions=(16,), **GEOM)
    params = numpy_params(jm, jnp.asarray(x), jax.random.PRNGKey(0), seed=10)
    port = AutoencoderKL(attn_resolutions=(16,), **GEOM)
    port.load_state_dict(from_jax("vae", params))
    keys = {k.rsplit(".", 2)[0] for k in port.state_dict() if ".attn." in k}
    assert keys == {"encoder.down.1.attn.0", "decoder.up.1.attn.0", "decoder.up.1.attn.1"}
    moments = jm.apply({"params": params}, jnp.asarray(x), method=jvae.AutoencoderKL.encode_moments)
    z = np.random.RandomState(11).standard_normal((2, 16, 16, 4)).astype(np.float32)
    dec = jm.apply({"params": params}, jnp.asarray(z), method=jvae.AutoencoderKL.decode)
    with torch.no_grad():
        np.testing.assert_allclose(port.encode_moments(torch.from_numpy(x)).numpy(),
                                   np.asarray(moments), atol=1e-4, rtol=0)
        np.testing.assert_allclose(port.decode(torch.from_numpy(z)).numpy(), np.asarray(dec),
                                   atol=1e-4, rtol=0)
        xrec, posterior = port(torch.from_numpy(x), noise=torch.from_numpy(z))
    ref = jvae.DiagonalGaussian(moments)
    zref = ref.mean + ref.std * z
    dec_ref = jm.apply({"params": params}, zref, method=jvae.AutoencoderKL.decode)
    np.testing.assert_allclose(xrec.numpy(), np.asarray(dec_ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(posterior.kl().numpy(), np.asarray(ref.kl()), rtol=1e-4)


def test_config_builders_read_attn_resolutions_and_the_loss():
    """``build_vae`` no longer raises on ``attn_resolutions``; and
    ``build_autoencoder_engine(VAE_TRAIN_CONFIG)`` gives the JAX builder's
    loss configuration and the SD KL-f8 widths (83.65 M parameters, built on
    the meta device)."""
    first = {"target": "sgm.models.autoencoder.AutoencoderKL",
             "params": {"embed_dim": 4, "ddconfig": dict(
                 GEOM, ch_mult=[1, 2], attn_resolutions=[16], z_channels=4)}}
    vae = config.build_vae(first)
    assert any(".attn." in k for k in vae.state_dict())
    with torch.device("meta"):
        eng = config.build_autoencoder_engine(config.VAE_TRAIN_CONFIG)
    ref = jconfig.build_autoencoder_engine(config.VAE_TRAIN_CONFIG)
    assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(ref.cfg)
    assert sum(p.numel() for p in eng.ae.parameters()) == 83_653_863
    assert not any(".attn." in k for k in eng.ae.state_dict())  # mid blocks only
    assert eng.lpips.training is False and isinstance(eng.disc, disc.NLayerDiscriminator)


def test_latent_lpips_matches_jax(lpips_pair):
    """Latent L2 + LPIPS through a frozen decoder, and the
    perceptual_weight_on_inputs branch; rtol 1e-4 (the perceptual terms
    are ~1e-3, sums of fp32 VGG16 features in another order)."""
    lp_params, port_lpips = lpips_pair
    jm = jvae.AutoencoderKL(**GEOM)
    x = images(12)
    params = numpy_params(jm, jnp.asarray(x), jax.random.PRNGKey(0), seed=13)
    rs = np.random.RandomState(14)
    lat_in = (rs.standard_normal((2, 16, 16, 4)) * 0.3).astype(np.float32)
    lat_pred = (lat_in + rs.standard_normal((2, 16, 16, 4)) * 0.1).astype(np.float32)
    ref_loss, ref_log = jae.LatentLPIPS(jm, 1.0, 0.7, 0.5)(
        {"decoder": params, "lpips": lp_params}, jnp.asarray(lat_in), jnp.asarray(lat_pred),
        image_inputs=jnp.asarray(x))
    decoder = AutoencoderKL(**GEOM)
    decoder.load_state_dict(from_jax("vae", params))
    port = ae.LatentLPIPS(decoder, 1.0, 0.7, 0.5)
    port.lpips.load_state_dict(port_lpips.state_dict())
    with torch.no_grad():
        loss, log = port(torch.from_numpy(lat_in), torch.from_numpy(lat_pred), torch.from_numpy(x))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    assert set(log) == set(ref_log)
    for k in log:
        np.testing.assert_allclose(log[k].item(), float(ref_log[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("shape,n_k", [((2, 1, 512, 512), 512), ((1, 1, 300, 512), 200)])
def test_flash_backward_plain_matches_jax(shape, n_k):
    """Kernel 4's plain d = 512 backward (``flash_attention_bwd`` on CPU
    tensors) and the ``FlashAttention`` Function's CPU path (through
    ``flash_attention`` with autograd on) against the JAX package's own
    backward, ``_xla_attention_bwd`` (off the TPU the vjp of
    ``_xla_attention``), at 1e-4 absolute; nothing launches."""
    rs = np.random.RandomState(n_k)
    kshape = shape[:2] + (n_k, shape[3])
    q, k, v, do = (rs.standard_normal(s).astype(np.float32) for s in (shape, kshape, kshape, shape))
    scale = 512 ** -0.5
    ref = jatt._xla_attention_bwd(scale, tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(do))
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    plain = fa.flash_attention_bwd(qt, kt, vt, None, dot, None, scale)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = port_attention.launch_counts()
    port_attention.dot_product_attention(*leaves, scale).backward(torch.from_numpy(do))
    assert port_attention.launch_counts() == before
    assert port_attention.attention_route(leaves[0], leaves[1]) == (
        "flash" if min(shape[2], n_k) >= 512 else "plain")
    for ours, through, theirs in zip(plain, leaves, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4, rtol=0)
        np.testing.assert_allclose(through.grad.numpy(), np.asarray(theirs), atol=1e-4, rtol=0)
    function = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    fa.FlashAttention.apply(*function, scale).backward(torch.from_numpy(do))
    for through, theirs in zip(function, ref):
        np.testing.assert_allclose(through.grad.numpy(), np.asarray(theirs), atol=1e-4, rtol=0)


def test_tile_sweep_plain_matches_xla():
    """Kernel 7's function (``profile_blocks.tiles`` on a CPU tensor, its
    plain version) against ``_xla_attention`` at (1, 2, 512, 40), q = k = v
    and the TPU script's scale 0.158, at 2e-5 absolute; nothing launches."""
    q = np.random.RandomState(15).standard_normal((1, 2, 512, 40)).astype(np.float32)
    ref = jatt._xla_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), pb.SCALE)
    qt = torch.from_numpy(q)
    before = pb.tiles.launches
    for bm, bn in pb.TILES:
        np.testing.assert_allclose(pb.tiles(qt, qt, qt, pb.SCALE, bm, bn).numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=0)
    assert pb.tiles.launches == before
