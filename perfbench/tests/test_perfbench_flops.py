"""The count of a row's and each stage's FLOPs from the shapes (the plain
reference on the meta device) equals FlopCounterMode's count of the
reference run on real tensors at a tiny size."""

import pytest
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops as F
from perfbench.reference import build
from perfbench.reference.depth import zoe_depth
from perfbench.tests.tiny import tiny_spec


def counted(fn):
    """FLOPs of a real run; the math attention, whose products the counter
    sees (the CPU's fused kernel is not among its formulas)."""
    with FlopCounterMode(display=False) as c:
        with torch.no_grad(), sdpa_kernel(SDPBackend.MATH):
            fn()
    return c.get_total_flops()


@pytest.mark.parametrize("workload", ["tv2v.edit", "tvi2v.edit"])
def test_meta_count_matches_a_real_run(workload):
    _, _, config, traffic, _ = tiny_spec(workload)
    want = F.edit_flops(config, traffic)
    torch.manual_seed(0)
    mods = build(config)
    net, vae, clip, ann = (mods[k] for k in ("network", "vae", "clip", "annotator"))
    t, h, w = traffic["frames"], traffic["height"] // 8, traffic["width"] // 8
    x = torch.randn(2, t, 4, h, w)
    steps = torch.tensor([10, 10])
    ctx = torch.randn(2, 77, 768)
    feats = torch.randn(2, t, net.ch, h, w)
    feat = torch.randn(1, 4, h, w) if hasattr(net, "controlnet_img") else None
    both = None if feat is None else feat.expand(2, -1, -1, -1)
    full = counted(lambda: net(x, steps, ctx, feats, both))
    if feat is None:
        assert want["row"] == full
    else:  # the appearance branch counted once a row, not on both halves
        cn = net.controlnet_img
        one = counted(lambda: cn(feat, cn.hint_features(feat), steps[:1], ctx[:1]))
        assert want["row"] == full - one
    frames = torch.rand(t, 3, traffic["height"], traffic["width"]) * 2 - 1
    assert want["decode"] == counted(lambda: vae.decode(torch.randn(t, 4, h, w)))
    assert want["text"] == counted(lambda: clip(torch.zeros(2, 77, dtype=torch.long)))
    hint = (lambda: zoe_depth(ann, frames)) if config["annotator"] == "depth_zoe" else (
        lambda: ann(frames))
    assert want["hint"] == counted(hint)
    assert want["row"] > 0 and want["hint"] > 0


def test_attention_bound():
    # exp-bound at head_dim 40, tensor-bound at 160
    b40 = F.attention_bound_s(34, 8, 6144, 6144, 40)
    assert b40 == pytest.approx(34 * 8 * 6144 ** 2 / F.EXP2_PER_S)
    b160 = F.attention_bound_s(34, 8, 1024, 1024, 160)
    assert b160 == pytest.approx(4.0 * 34 * 8 * 1024 ** 2 * 160 / F.BF16_FLOPS)
