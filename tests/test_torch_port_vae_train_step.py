"""VAE GAN training on the CPU, port against the JAX package in fp32, at the
tiny configuration of ``tests/test_vae_training.py``'s trainer test
(``ch=32``, ``ch_mult=(1, 2)``, 1 res block, resolution 32,
``disc_num_layers=2``, the full VGG16 LPIPS):

* ``AutoencodingEngine.generator_loss``: the loss, every log entry
  (``d_weight`` included, with the GAN term live and before
  ``disc_start``) and the gradients of the trainable subset against
  ``jax.value_and_grad`` of the JAX ``generator_loss``, the same
  ``noise_override``;
* ``discriminator_loss`` (hinge and vanilla, live and gated): the loss, its
  logs and the discriminator's gradients;
* one ``VAETrainer.train_step`` against the JAX ``_train_step`` (its
  ``DiagonalGaussian.sample`` patched to take the injected noise of each
  pass): both passes' logs, and the Adam-updated parameters where the
  gradient is well above fp32 noise (Adam's first step is -lr * sign(g)
  there), the frozen LPIPS unchanged.

Weights are numpy draws in the JAX layout mapped with ``from_jax``; images
and noise are numpy.  The JAX sides are jitted (op by op they take minutes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.models import autoencoder_engine as jae
from ccedit_tpu.modules import discriminator as jdisc
from ccedit_tpu.modules import lpips as jlpips
from ccedit_tpu.modules import vae as jvae
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.models import autoencoder_engine as ae
from ccedit_tpu_torch.modules.vae import AutoencoderKL

torch.set_num_threads(1)
GEOM = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32)
LOSS = dict(disc_num_layers=2, disc_weight=0.75, regularization_weights={"kl_loss": 1e-6})
DISC_START = 3
# gradients: max|port - JAX| of each tensor within this fraction of the
# largest gradient of the subset (fp32 through VGG16 and the VAE in another
# order; noise-level gradients, such as k biases', differ by their size)
GRAD_TOL = 1e-4
LOG_RTOL = 1e-5


def _numpy_tree(shapes, rs):
    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            std = int(np.prod(leaf.shape[:-1])) ** -0.5
            return (rs.standard_normal(leaf.shape) * std).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.05 * rs.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def setup():
    """The JAX params (numpy draws from one seed), images, both passes'
    posterior noise, and ``port(disc_start, disc_loss)`` which builds the
    port's engine on the same weights."""
    rs = np.random.RandomState(0)
    x = (rs.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    eps_g, eps_d = (rs.standard_normal((2, 16, 16, 4)).astype(np.float32) for _ in range(2))
    key, xj = jax.random.PRNGKey(0), jnp.asarray(x)
    shapes = {
        "ae": jax.eval_shape(lambda a: jvae.AutoencoderKL(**GEOM).init(key, a, key), xj),
        "disc": jax.eval_shape(lambda a: jdisc.NLayerDiscriminator(n_layers=2).init(key, a), xj),
        "lpips": jax.eval_shape(lambda a: jlpips.LPIPS().init(key, a, a), xj)}
    params = {k: _numpy_tree(v["params"], rs) for k, v in shapes.items()}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    params["logvar"] = jnp.asarray(0.0, jnp.float32)

    def port(disc_start, disc_loss="hinge"):
        eng = ae.AutoencodingEngine(AutoencoderKL(**GEOM), ae.LPIPSWithDiscriminatorConfig(
            disc_start=disc_start, disc_loss=disc_loss, **LOSS))
        for name in ("ae", "disc", "lpips"):
            getattr(eng, name).load_state_dict(from_jax(name if name != "ae" else "vae",
                                                        params[name]))
        return eng

    return dict(params=params, x=x, eps_g=eps_g, eps_d=eps_d, port=port)


def jax_engine(disc_start, disc_loss="hinge"):
    return jae.AutoencodingEngine(jvae.AutoencoderKL(**GEOM), jae.LPIPSWithDiscriminatorConfig(
        disc_start=disc_start, disc_loss=disc_loss, **LOSS))


def assert_logs_match(port_log, jax_log, prefix=""):
    assert set(port_log) == {prefix + k for k in jax_log}
    for k, v in jax_log.items():
        np.testing.assert_allclose(float(port_log[prefix + k]), float(v), rtol=LOG_RTOL,
                                   atol=1e-7, err_msg=k)


def assert_grads_match(port_named, jax_sd):
    """Each tensor's max|diff| within GRAD_TOL of the subset's largest
    gradient."""
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax_sd.values())
    assert set(port_named) == set(jax_sd)
    for name, p in port_named.items():
        err = (p.grad - jax_sd[name]).abs().max().item()
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.fixture(scope="module")
def jax_generator(setup):
    """jit(value_and_grad) of the JAX generator_loss over the ``ae``
    subset, the global step traced (one compile for both cases)."""
    eng, params = jax_engine(DISC_START), setup["params"]

    def loss(g, step):
        return eng.generator_loss({**params, **g}, jnp.asarray(setup["x"]), jax.random.PRNGKey(1),
                                  step, noise_override=jnp.asarray(setup["eps_g"]))

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("step", [5, 0], ids=["disc-live", "disc-gated"])
def test_generator_loss_matches_jax(setup, jax_generator, step):
    (ref_loss, ref_log), ref_grads = jax_generator({"ae": setup["params"]["ae"]}, jnp.asarray(step))
    eng = setup["port"](DISC_START)
    loss, log = eng.generator_loss(torch.from_numpy(setup["x"]), step,
                                   noise=torch.from_numpy(setup["eps_g"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOG_RTOL)
    assert_logs_match(log, ref_log)
    assert float(log["d_weight"]) > 0  # computed before disc_start too, as in JAX
    assert_grads_match({n: p for n, p in eng.ae.named_parameters()},
                       from_jax("vae", ref_grads["ae"]))
    assert all(p.grad is None for p in eng.lpips.parameters())


@pytest.mark.parametrize("kind", ["hinge", "vanilla"])
@pytest.mark.parametrize("step", [5, 0], ids=["disc-live", "disc-gated"])
def test_discriminator_loss_matches_jax(setup, kind, step):
    eng_j, params = jax_engine(DISC_START, kind), setup["params"]

    def loss(d):
        return eng_j.discriminator_loss({**params, "disc": d}, jnp.asarray(setup["x"]),
                                        jax.random.PRNGKey(2), jnp.asarray(step),
                                        noise_override=jnp.asarray(setup["eps_d"]))

    (ref_loss, ref_log), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params["disc"])
    eng = setup["port"](DISC_START, kind)
    loss, log = eng.discriminator_loss(torch.from_numpy(setup["x"]), step,
                                       noise=torch.from_numpy(setup["eps_d"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOG_RTOL, atol=1e-7)
    assert_logs_match(log, ref_log)
    if step >= DISC_START:
        assert_grads_match(dict(eng.disc.named_parameters()), from_jax("disc", ref_grads))
    else:
        assert all(not p.grad.any() for p in eng.disc.parameters())
    assert all(p.grad is None for p in eng.ae.parameters())


def test_train_step_matches_jax(setup, monkeypatch):
    """One step with the GAN live from step 0: the generator's Adam update,
    then the discriminator pass on the updated autoencoder with its own
    posterior noise."""
    lr = 1e-3
    params, x = setup["params"], setup["x"]
    noises = [jnp.asarray(setup["eps_g"]), jnp.asarray(setup["eps_d"])]

    def sample(self, rng):  # traced once per pass: G, then D
        return self.mean + self.std * noises.pop(0)

    monkeypatch.setattr(jvae.DiagonalGaussian, "sample", sample)
    trainer = jae.VAETrainer(jax_engine(0), lr=lr)
    state = {"params": params, "opt_g": trainer.opt_g.init(trainer._g_subset(params)),
             "opt_d": trainer.opt_d.init(params["disc"]), "step": jnp.asarray(0, jnp.int32)}
    new_state, ref_logs = trainer.train_step(state, jnp.asarray(x), jax.random.PRNGKey(3))
    assert not noises and int(new_state["step"]) == 1

    eng = setup["port"](0)
    lpips_before = {n: p.clone() for n, p in eng.lpips.named_parameters()}
    port = ae.VAETrainer(eng, lr=lr)
    logs = port.train_step(torch.from_numpy(x), noise_g=torch.from_numpy(setup["eps_g"]),
                           noise_d=torch.from_numpy(setup["eps_d"]))
    assert port.step == 1
    assert_logs_match(logs, {k[len("train/"):]: v for k, v in ref_logs.items()}, "train/")
    for name, p in eng.lpips.named_parameters():
        assert torch.equal(p, lpips_before[name]), name
    for mod, kind, key in ((eng.ae, "vae", "ae"), (eng.disc, "disc", "disc")):
        ref, before = from_jax(kind, new_state["params"][key]), from_jax(kind, params[key])
        largest = max(p.grad.abs().max() for p in mod.parameters())
        for name, p in mod.named_parameters():
            assert (ref[name] - before[name]).abs().max() <= lr * 1.001, name
            assert not torch.equal(p.detach(), before[name]), name
            # Adam's first step is -lr * g / (|g| + eps): where |g| is far
            # above fp32 noise, both frameworks step by lr * sign(g)
            sure = p.grad.abs() > 1e-3 * largest
            torch.testing.assert_close(p.detach()[sure], ref[name][sure], atol=1e-6, rtol=0)
