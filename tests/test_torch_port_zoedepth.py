"""ZoeDepth (the TVI2V structure hint as shipped) in the port against the JAX
package, on the CPU in fp32, with the same weights: a seeded random state
dict in the HF ``ZoeDepthForDepthEstimation`` layout at the tiny width of
``tests/test_depth_parity.py`` (hidden 32, 4 heads, 4 layers), which the
port loads as it is and ``convert_zoedepth`` converts for JAX.  The
layer-scale gammas are near HF's 0.1 and the relative-position bias tables
N(0, 1), so every BEiT block and its bias matter.

Tolerances: the relative-position index exactly and the bias-table
interpolation to 1e-6 (1e-6 relative too on the full tables); the depth
maps to 1e-4 * max|JAX|; the normalised hint to 1e-4 absolute.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccedit_tpu.conditioning.annotators import base as jbase
from ccedit_tpu.conditioning.annotators import zoedepth as jzd
from ccedit_tpu_torch.conditioning.annotators import base as tbase
from ccedit_tpu_torch.conditioning.annotators import zoedepth as tzd
from ccedit_tpu_torch.io.jax_params import from_jax

torch.set_num_threads(1)
TINY = dict(hidden=32, heads=4, layers=4, patch=16, out_indices=(0, 1, 2, 3),
            neck_hidden=(16, 24, 32, 32), fusion_ch=32, n_bins=8, bin_embedding_dim=16,
            num_attractors=(4, 2, 2, 1), num_relative_features=8)
GRID = (4, 4)  # the tiny checkpoint's pretraining window (64x64 inputs)


def hf_state_dict(seed: int):
    """Seeded random weights in the HF layout (the port module's names)."""
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in tzd.ZoeDepthN(**TINY, pretrain_grid=GRID).state_dict().items():
        shape = tuple(v.shape)
        x = rs.standard_normal(shape)
        if k.endswith(("lambda_1", "lambda_2")):
            x = 0.1 + 0.02 * x
        elif k.endswith("relative_position_bias_table"):
            pass
        elif "layernorm" in k and k.endswith("weight"):
            x = 1.0 + 0.1 * x
        elif len(shape) >= 2:
            x = x / np.sqrt(np.prod(shape[1:]))
        else:
            x = 0.1 * x
        sd[k] = torch.from_numpy(x.astype(np.float32))
    return sd


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def weights():
    sd = hf_state_dict(0)
    model = tzd.zoedepth_from_state_dict(sd).eval()
    return sd, model, jzd.convert_zoedepth(_numpy(sd), layers=4), jzd.ZoeDepthN(**TINY)


@pytest.mark.parametrize("window", [(4, 4), (6, 4), (3, 5)])
def test_rel_position_index_and_table_interpolation(window):
    np.testing.assert_array_equal(tzd.beit_relative_position_index(*window),
                                  jzd.beit_relative_position_index(*window))
    table = np.random.RandomState(7).standard_normal((7 * 7 + 3, 4)).astype(np.float32)
    ours = tzd.interpolate_rel_bias_table(torch.from_numpy(table), window, old_grid=GRID)
    ref = jzd.interpolate_rel_bias_table(table, window, old_grid=GRID)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)


def test_forward_matches_jax(weights):
    sd, model, params, jmodel = weights
    x = np.random.RandomState(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref_depth, ref_rel = jmodel.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        depth, rel = model(torch.from_numpy(x))
    for ours, ref in ((depth, ref_depth), (rel, ref_rel)):
        ref = np.asarray(ref)
        assert ours.shape == ref.shape
        assert np.abs(ours.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("hw", [(64, 64), (80, 96)])
def test_detect_depth_matches_jax(weights, hw):
    """``detect_depth_zoe``: normalisation, edge padding to a multiple of
    32 (80x96 -> 96x96, a 6x6 grid whose tables are resampled from the
    4x4 checkpoint window), resize and crop."""
    sd, model, params, jmodel = weights
    frames = np.random.RandomState(2).uniform(0, 1, (3,) + hw + (3,)).astype(np.float32)
    grid = jzd.zoedepth_grid_for(*hw)
    assert tzd.zoedepth_grid_for(*hw) == grid
    ref = np.asarray(jzd.detect_depth_zoe(jzd.adapt_zoedepth_grid(params, grid),
                                          jnp.asarray(frames), jmodel))
    with torch.no_grad():
        ours = tzd.detect_depth_zoe(model, torch.from_numpy(frames)).numpy()
        no_bias = tzd.detect_depth_zoe(model, torch.from_numpy(frames), rel_bias=False).numpy()
    assert ours.shape == ref.shape == (3,) + hw
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
    # the bias matters: leaving it out moves the map by a share of its spread
    assert np.abs(no_bias - ref).max() > 1e-2 * (ref.max() - ref.min())


def test_adapt_grid_equals_conversion_at_the_grid(weights):
    sd, model, _, _ = weights
    direct = jzd.convert_zoedepth(_numpy(sd), layers=4, grid=(6, 4))
    ours = tzd.adapt_zoedepth_grid(model, (6, 4))
    for i, table in enumerate(ours):
        np.testing.assert_allclose(table.numpy(), direct["backbone"][f"blocks_{i}"]["rel_bias"],
                                   atol=1e-6, rtol=1e-6)
    # the per-grid cache: reused while the tables stand, rebuilt from the
    # checkpoint tables (never re-resampled) when they change
    first, _ = model.grid_bias((6, 4))
    assert model.grid_bias((6, 4))[0] is first
    fresh = tzd.zoedepth_from_state_dict(sd)
    fresh.grid_bias((6, 4))
    with torch.no_grad():
        fresh.rel_bias_tables()[0].mul_(2.0)
    np.testing.assert_allclose(fresh.grid_bias((6, 4))[0][0].numpy(), 2.0 * ours[0].numpy(),
                               atol=1e-6, rtol=0)
    assert tzd.zoedepth_grid_for(512, 768) == (32, 48)


def test_zoe_postprocess():
    depth = np.random.RandomState(3).gamma(2.0, 1.5, (2 * 3, 16, 24)).astype(np.float32)
    ref = np.asarray(jbase.zoe_postprocess(jnp.asarray(depth), 2))
    ours = tbase.zoe_postprocess(torch.from_numpy(depth), 2).numpy()
    assert ours.shape == ref.shape == (6, 16, 24, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    n = 3 * 16 * 24  # per sample: at least k_lo values at -1, n - k_hi + 1 at +1
    per = ours[..., 0].reshape(2, -1)
    assert ((per == -1.0).sum(1) >= max(int(0.02 * n), 1)).all()
    assert ((per == 1.0).sum(1) >= n - max(int(0.85 * n), 1) + 1).all()


def test_depth_zoe_embedder_through_build_annotator(weights, tmp_path, monkeypatch):
    """The ``DepthZoeEncoder`` embedder end to end on both sides from one
    HF-layout file: [-1, 1] -> [0, 1], depth, clip-global normalisation.
    The JAX ``build_annotator`` builds the production-size model, so the
    JAX side is narrowed to the file's width; the port sizes the model to
    the file."""
    sd, _, _, _ = weights
    path = tmp_path / "zoe_tiny.pt"
    torch.save(sd, path)
    monkeypatch.setattr(jzd, "ZoeDepthN", functools.partial(jzd.ZoeDepthN, **TINY))
    monkeypatch.setattr(jzd, "convert_zoedepth",
                        functools.partial(jzd.convert_zoedepth, layers=4))
    video = np.random.RandomState(4).randint(0, 256, (1, 7, 80, 96, 3)).astype(np.uint8)
    ref = np.asarray(jbase.build_annotator("DepthZoeEncoder", {"ckpt_path": str(path)})
                     .embed(None, video))
    emb = tbase.build_annotator("DepthZoeEncoder", {"ckpt_path": str(path)})
    assert emb.backbone_loaded and isinstance(emb.backbone, tzd.ZoeDepthN)
    with torch.no_grad():
        ours = emb(torch.from_numpy(video)).numpy()  # 7 frames: chunks of 5 and 2
    assert ours.shape == ref.shape == (1, 7, 80, 96, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def test_from_jax_inverts_convert_zoedepth(weights):
    sd, _, params, _ = weights
    back = from_jax("zoedepth", params)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_state_dict_layout_is_hfs():
    """The port's names and shapes are HF ``ZoeDepthForDepthEstimation``'s
    (a tiny config of it, built in memory)."""
    transformers = pytest.importorskip("transformers")
    backbone = transformers.BeitConfig(
        image_size=64, patch_size=16, hidden_size=32, num_hidden_layers=4,
        num_attention_heads=4, intermediate_size=128, use_relative_position_bias=True,
        use_mean_pooling=False, out_features=["stage1", "stage2", "stage3", "stage4"],
        reshape_hidden_states=False, layer_scale_init_value=0.1)
    cfg = transformers.ZoeDepthConfig(
        backbone_config=backbone, neck_hidden_sizes=[16, 24, 32, 32], fusion_hidden_size=32,
        bottleneck_features=32, bin_embedding_dim=16, num_attractors=[4, 2, 2, 1],
        num_relative_features=8,
        bin_configurations=[{"n_bins": 8, "min_depth": 1e-3, "max_depth": 10.0}])
    hf = {k: tuple(v.shape) for k, v in
          transformers.ZoeDepthForDepthEstimation(cfg).state_dict().items()}
    ours = {k: tuple(v.shape) for k, v in
            tzd.ZoeDepthN(**TINY, pretrain_grid=GRID).state_dict().items()}
    assert ours == hf


def test_random_init_keeps_every_block_live():
    model = tzd.randomize_zoedepth_(tzd.ZoeDepthN(**TINY, pretrain_grid=GRID),
                                    torch.Generator().manual_seed(0))
    for layer in model.backbone.encoder.layer:
        assert torch.all(layer.lambda_1 == 0.1) and torch.all(layer.lambda_2 == 0.1)
    for table in model.rel_bias_tables():
        assert 0.5 < table.std().item() < 2.0
