"""The ``lpips`` diffusion loss, port against the JAX package on the CPU in
fp32: ``StandardDiffusionLoss.make_lpips_fn`` over the port's VGG16 LPIPS
(``modules/lpips.py``, weights through ``from_jax("lpips")``) against the
JAX ``make_lpips_fn`` on the same weights, on 3-channel (B, T, H, W, 3)
inputs whose leading dims fold into the batch; then the loss itself with
injected sigmas and noise through the same analytic network, its value
and its gradient with respect to the network's input term.  Tolerance
1e-5 of the value's scale (1e-4 on the gradient through the whole VGG16).
The semantics are the JAX package's: ``lpips`` needs a ``perceptual_fn``
(a ``ValueError`` without one, so ``build_loss`` never builds it from a
config) and is not weighted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu import config as jconfig
from ccedit_tpu.diffusion import DiscreteDenoiser as JaxDenoiser
from ccedit_tpu.diffusion import loss as jloss
from ccedit_tpu.diffusion import sigma_sampling as jss
from ccedit_tpu.modules import lpips as jlpips
from ccedit_tpu_torch import config
from ccedit_tpu_torch.diffusion import DiscreteDenoiser, DiscreteSampling
from ccedit_tpu_torch.diffusion.loss import StandardDiffusionLoss
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules.lpips import LPIPS

torch.set_num_threads(1)
SHAPE = (2, 2, 32, 32, 3)  # (B, T, H, W, 3)


def _fill(shapes, seed):
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            std = int(np.prod(leaf.shape[:-1])) ** -0.5
            return (rs.standard_normal(leaf.shape) * std).astype(np.float32)
        return (0.05 * rs.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


@pytest.fixture(scope="module")
def lpips_pair():
    x = jnp.zeros((2, 32, 32, 3))
    params = _fill(jax.eval_shape(lambda: jlpips.LPIPS().init(jax.random.PRNGKey(0), x, x)), 5)
    port = LPIPS()
    port.load_state_dict(from_jax("lpips", params))
    return params, port


def _clips(seed):
    rs = np.random.RandomState(seed)
    return [(rs.rand(*SHAPE) * 2 - 1).astype(np.float32) for _ in range(2)]


def test_make_lpips_fn_matches_jax(lpips_pair):
    params, port = lpips_pair
    a, b = _clips(0)
    ref = np.asarray(jloss.StandardDiffusionLoss.make_lpips_fn(params)(jnp.asarray(a),
                                                                      jnp.asarray(b)))
    out = StandardDiffusionLoss.make_lpips_fn(port)(torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (SHAPE[0],) and ref.shape == (SHAPE[0],)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # the per-sample mean over its frames
    frames = port(torch.from_numpy(a.reshape(-1, 32, 32, 3)),
                  torch.from_numpy(b.reshape(-1, 32, 32, 3))).reshape(SHAPE[0], -1)
    torch.testing.assert_close(out, frames.mean(dim=1), rtol=0, atol=0)


def _jax_net(x, c_noise, cond):
    return 0.9 * x + 1e-3 * c_noise.reshape((-1,) + (1,) * (x.ndim - 1)).astype(x.dtype) + cond["a"]


def _port_net(x, c_noise, cond):
    return (0.9 * x + 1e-3 * c_noise.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
            + cond["a"])


def test_lpips_loss_and_its_gradient_match_jax(lpips_pair):
    params, port = lpips_pair
    x, noise = _clips(1)
    a = (np.random.RandomState(2).standard_normal((1, 1, 1, 1, 3)) * 0.3).astype(np.float32)
    sigmas = DiscreteSampling().sigmas_np[[20, 60]]  # small sigmas: the output stays image-like
    ref_loss = jloss.StandardDiffusionLoss(
        jss.DiscreteSampling(), "lpips",
        perceptual_fn=jloss.StandardDiffusionLoss.make_lpips_fn(params))

    def jax_loss(a_):
        return jnp.mean(ref_loss(jax.random.PRNGKey(0), _jax_net,
                                 JaxDenoiser(scaling="eps", weighting="eps"), {"a": a_},
                                 jnp.asarray(x), noise_override=jnp.asarray(noise),
                                 sigma_override=jnp.asarray(sigmas)))

    ref, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(a))
    port_loss = StandardDiffusionLoss(DiscreteSampling(), "lpips",
                                      perceptual_fn=StandardDiffusionLoss.make_lpips_fn(port))
    at = torch.from_numpy(a).requires_grad_(True)
    out = port_loss(_port_net, DiscreteDenoiser(), {"a": at}, torch.from_numpy(x),
                    noise_override=torch.from_numpy(noise),
                    sigma_override=torch.from_numpy(sigmas))
    assert out.shape == (SHAPE[0],)
    out.mean().backward()
    assert float(ref) > 0
    np.testing.assert_allclose(float(out.mean().detach()), float(ref), rtol=1e-5, atol=0)
    ref_grad = np.asarray(ref_grad)
    assert np.abs(ref_grad).max() > 0
    np.testing.assert_allclose(at.grad.numpy(), ref_grad, rtol=0,
                               atol=1e-4 * np.abs(ref_grad).max())
    assert not any(p.grad is not None for p in port.parameters())  # LPIPS stays frozen


def test_lpips_needs_a_perceptual_fn_as_in_jax():
    for make in (lambda: StandardDiffusionLoss(DiscreteSampling(), "lpips"),
                 lambda: jloss.StandardDiffusionLoss(jss.DiscreteSampling(), "lpips")):
        with pytest.raises(ValueError, match="perceptual_fn"):
            make()
    cfg = {"target": "sgm.modules.diffusionmodules.loss.StandardDiffusionLoss",
           "params": {"type": "lpips"}}
    for build in (config.build_loss, jconfig.build_loss):
        with pytest.raises(ValueError, match="perceptual_fn"):
            build(cfg)
    with pytest.raises(ValueError):
        StandardDiffusionLoss(DiscreteSampling(), "l3")
