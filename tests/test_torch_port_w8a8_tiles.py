"""Kernel 10 (``csrc/int8_conv.cu``) on the CPU: a test-only torch mirror
of its order of work, held bit for bit to ``quant.plain_conv_acc`` and to
JAX's own int32 convolution, its tile chooser over the full-width
networks, and its epilogue.

The mirror builds the int32 accumulators as the kernel does: the tile
``quant.conv_tiles(Cp, O)`` = (BM pixels, BN channels, k-chunk bytes); for
each output tile of BM consecutive pixels in (N, Ho, Wo) order x BN
channels, each stage of 128 bytes of K (128 / chunk boxes: consecutive
(tap, k-chunk) pairs, the last stage filled up with boxes of channels
past Cp), each box's A as the im2col map
delivers it (128- or 64-pixel columns walked through the map's pixel box from each
column's first pixel, the box's corners computed as the kernel's host code
computes them; input position oh * sh - pt + dy, ow * sw - pl + dx; zeros
outside the image, past Cp and past the last image), the B box from the
(Cp, taps, O) view of the weights (zeros past Cp and past O), summed in
int32.  int32 sums of int8 products are exact in any order, so every tile
and order must give the plain version's accumulators exactly.

The chooser is checked at every (Cp, O) and window that the full-width
TV2V and TVI2V networks (ControlNet and hint pyramid included) and the
VAE give kernel 10 with W8A8 on, recorded on the ``meta`` device by
wrapping ``quant.conv_dequant`` (``test_census_*`` in
``test_torch_port_w8a8.py`` run only at tiny widths).
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import chip_smoke
import test_torch_port_w8a8 as w8
from ccedit_tpu.ops import quant as jquant
from ccedit_tpu_torch import config
from ccedit_tpu_torch.ops import attention as att
from ccedit_tpu_torch.ops import quant

torch.set_num_threads(1)

# the instantiations of csrc/int8_conv.cu's `run`: (BM, BN) -> blocks an SM
KERNEL_TILES = {(256, 8): 2, (256, 16): 2, (256, 32): 2, (256, 128): 1, (192, 160): 1}
SMEM = {1: 224 * 1024, 2: 110 * 1024}  # the kernel's dynamic shared memory by blocks an SM


def pixel_box(h, w, geom, ho, wo):
    """The im2col map's pixel box as the kernel's host code sets it:
    ({W, H} lower corners, {W, H} upper corners)."""
    lower = (-geom.pl, -geom.pt)
    upper = (-geom.pl + (wo - 1) * geom.sw - (w - 1), -geom.pt + (ho - 1) * geom.sh - (h - 1))
    return lower, upper


def im2col_box(x8, start, count, geom, lower, upper, dy, dx, c0, chunk):
    """``count`` pixels x ``chunk`` channels from channel c0 as one im2col
    load delivers them: the traversal of the pixel box from ``start`` (n,
    h, w), w stepping by sw to the box's last column, then h by sh, then n,
    each pixel read at (h + dy, w + dx); zeros outside the tensor."""
    n_img, hh, ww, cp = x8.shape
    nw = (ww - 1 + upper[0] - lower[0]) // geom.sw + 1  # positions a box row
    nh = (hh - 1 + upper[1] - lower[1]) // geom.sh + 1
    n, h, w = start
    first = (n * nh + (h - lower[1]) // geom.sh) * nw + (w - lower[0]) // geom.sw
    idx = torch.arange(first, first + count)
    pw = lower[0] + (idx % nw) * geom.sw + dx
    ph = lower[1] + (idx // nw % nh) * geom.sh + dy
    pn = idx // (nw * nh)
    ok = (pn < n_img) & (ph >= 0) & (ph < hh) & (pw >= 0) & (pw < ww)
    box = torch.zeros((count, chunk), dtype=torch.int8)
    cols = max(0, min(chunk, cp - c0))
    box[ok, :cols] = x8[pn[ok], ph[ok], pw[ok], c0:c0 + cols]
    return box


def mirror_conv_acc(x8, w8_rows, geom, tiles=None):
    """The int32 (N, Ho, Wo, O) accumulators in kernel 10's order of work."""
    n, h, w, cp = x8.shape
    o = w8_rows.shape[0]
    ho, wo = geom.out_hw(h, w)
    m = n * ho * wo
    bm, bn, chunk = tiles or quant.conv_tiles(cp, o)
    taps = geom.kh * geom.kw
    chunks = -(-cp // chunk)
    lower, upper = pixel_box(h, w, geom, ho, wo)
    assert (w - 1 + upper[0] - lower[0]) // geom.sw + 1 == wo
    assert (h - 1 + upper[1] - lower[1]) // geom.sh + 1 == ho
    view = w8_rows.reshape(o, taps, cp)  # the (Cp, taps, O) map, innermost first
    # the (tap, first channel) boxes in K order, `per` a stage; the last
    # stage filled up with boxes of channels past Cp (zeros)
    per = 128 // chunk
    boxes = [(tap, c * chunk) for tap in range(taps) for c in range(chunks)]
    boxes += [(taps - 1, chunks * chunk)] * (-len(boxes) % per)
    out = torch.empty((m, o), dtype=torch.int32)
    pixels = 128 if bm % 128 == 0 else 64  # output pixels of one im2col load
    for m0 in range(0, m, bm):
        starts = []
        for j in range(bm // pixels):  # each load's first pixel
            pix = m0 + pixels * j
            if pix < m:  # a load wholly past M is not issued
                b, rest = divmod(pix, ho * wo)
                oh, ow = divmod(rest, wo)
                starts.append((j, (b, oh * geom.sh - geom.pt, ow * geom.sw - geom.pl)))
        for n0 in range(0, o, bn):
            acc = torch.zeros((bm, bn), dtype=torch.int32)
            for stage in range(0, len(boxes), per):  # 128 bytes of K a stage
                part = torch.zeros((bm, bn), dtype=torch.int64)
                for tap, c0 in boxes[stage:stage + per]:
                    dy, dx = divmod(tap, geom.kw)
                    a = torch.zeros((bm, chunk), dtype=torch.int8)
                    for j, start in starts:
                        a[pixels * j:pixels * (j + 1)] = im2col_box(
                            x8, start, pixels, geom, lower, upper, dy, dx, c0, chunk)
                    b = torch.zeros((bn, chunk), dtype=torch.int8)
                    rows, cols = min(bn, o - n0), max(0, min(chunk, cp - c0))
                    b[:rows, :cols] = view[n0:n0 + rows, tap, c0:c0 + cols]
                    part += a.long() @ b.long().t()
                acc += part.to(torch.int32)
            rows, cols = min(bm, m - m0), min(bn, o - n0)
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return out.reshape(n, ho, wo, o)


def mirror_epilogue(acc, sx, sw, bias, dtype):
    """The kernel's dequant, value for value: each product rounded in fp32
    (__fmul_rn), bf16 rounding, the bias added in fp32 and rounded again."""
    y = acc.float() * sx.reshape(())
    y = y * sw
    if dtype == torch.bfloat16:
        y = y.to(torch.bfloat16).float()
        if bias is not None:
            y = y + bias.to(torch.bfloat16).float()
        return y.to(torch.bfloat16)
    return y if bias is None else y + bias.float()


def _operands(x_shape, o, kernel, stride, padding, seed, zero=False):
    """int8 x8 (N, H, W, Cp) and w8 (O, taps * Cp) from seeded numpy
    inputs through the quantizer's plain version, their scales, the
    window, and JAX's int8 operands as ``ccedit_tpu/ops/quant.py`` makes
    them."""
    x, w, bias, kj = w8._window_inputs(x_shape, o, tuple(kernel), seed, zero)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    x4, w4, geom = quant._to_2d(xt, wt, stride, padding)
    x8, sx = quant.plain_quantize_int8(x4.reshape(-1, x4.shape[-1]), False)
    x8 = x8.view(x4.shape[:3] + (-1,))
    w8_rows, sw = quant.quantize_weight(w4)
    xq, _ = jquant._symmetric_q(jnp.asarray(x), tuple(range(x.ndim)))
    wq, _ = jquant._symmetric_q(jnp.asarray(kj), tuple(range(kj.ndim - 1)))
    return x8, sx, w8_rows, sw, torch.from_numpy(bias), geom, xq, wq


def _jax_acc(xq, wq, stride, padding):
    """JAX's int32 product, called as ``ccedit_tpu/ops/quant.py:101``
    calls it."""
    dims = ("NHWC", "HWIO", "NHWC") if xq.ndim == 4 else ("NWC", "WIO", "NWC")
    out = lax.conv_general_dilated(xq, wq, window_strides=tuple(stride), padding=padding,
                                   dimension_numbers=dims, preferred_element_type=jnp.int32)
    out = np.asarray(out)
    return out[:, :, None] if xq.ndim == 3 else out


# every window of test_torch_port_w8a8.py, then the tails: M past a tile,
# O of 3, 16 and 160 + 8, Cp 16, 48 and 80 (a 64-byte chunk's zero tail),
# O = 320 over two BN-160 tiles, a 1-D k = 1
TAILS = (
    ("M tail, O 3, Cp 48", (2, 13, 17, 40), 3, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("O 16, Cp 16", (3, 10, 11, 3), 16, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("O 168, Cp 80", (2, 9, 10, 80), 168, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("O 320 two N tiles, Cp 48, stride 2", (2, 15, 18, 33), 320, (3, 3), (2, 2),
     ((1, 1), (1, 1))),
    ("(0, 1) stride 2, Cp 80", (1, 12, 18, 70), 40, (3, 3), (2, 2), ((0, 1), (0, 1))),
    ("1d k1 M tail", (40, 9, 20), 24, (1,), (1,), ((0, 0),)),
)
CASES = w8.WINDOWS + TAILS


@pytest.mark.parametrize("label,x_shape,o,kernel,stride,padding", CASES,
                         ids=[c[0] for c in CASES])
def test_mirror_accumulators_bit_for_bit(label, x_shape, o, kernel, stride, padding):
    x8, _, w8_rows, _, _, geom, xq, wq = _operands(x_shape, o, kernel, stride, padding,
                                                   seed=len(label), zero="zero" in label)
    acc = mirror_conv_acc(x8, w8_rows, geom)
    plain = quant.plain_conv_acc(x8, w8_rows, geom)
    assert acc.dtype == plain.dtype == torch.int32 and acc.shape == plain.shape
    assert torch.equal(acc, plain)
    np.testing.assert_array_equal(acc.numpy(), _jax_acc(xq, wq, stride, padding))
    if "zero" not in label:
        assert acc.abs().max() > 0


@pytest.mark.parametrize("tiles", sorted(KERNEL_TILES), ids=lambda t: f"bm{t[0]}-bn{t[1]}")
@pytest.mark.parametrize("chunk", (32, 64, 128))
def test_mirror_every_tile_and_chunk(tiles, chunk):
    """Every instantiated tile at every chunk width gives the same exact
    accumulators (the 3x3 stride-2 window on Cp 80, O 40, M 150)."""
    x8, _, w8_rows, _, _, geom, xq, wq = _operands((3, 9, 19, 70), 40, (3, 3), (2, 2),
                                                   ((1, 1), (1, 1)), seed=chunk)
    acc = mirror_conv_acc(x8, w8_rows, geom, tiles + (chunk,))
    assert torch.equal(acc, quant.plain_conv_acc(x8, w8_rows, geom))


def test_mirror_sees_a_shifted_window():
    """The mirror is not the plain version in disguise: the box walked from
    a start one column off (what a wrong left corner would load) changes
    the accumulators."""
    x8, _, w8_rows, _, _, geom, _, _ = _operands((2, 8, 9, 32), 16, (3, 3), (1, 1),
                                                 ((1, 1), (1, 1)), seed=3)
    shifted = dataclasses.replace(geom, pl=geom.pl - 1, pr=geom.pr + 1)
    assert not torch.equal(mirror_conv_acc(x8, w8_rows, shifted),
                           quant.plain_conv_acc(x8, w8_rows, geom))


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("with_bias", (True, False))
def test_epilogue_bit_for_bit(dtype, with_bias):
    x8, sx, w8_rows, sw, bias, geom, _, _ = _operands((2, 11, 13, 40), 24, (3, 3), (1, 1),
                                                      ((1, 1), (1, 1)), seed=7)
    acc = mirror_conv_acc(x8, w8_rows, geom)
    b = bias.to(dtype) if with_bias else None
    out = mirror_epilogue(acc, sx, sw, b, dtype)
    ref = quant.plain_epilogue(acc, sx.reshape(()), sw, b, dtype)
    assert out.dtype == ref.dtype and torch.equal(out, ref)
    assert torch.equal(ref, quant.plain_conv_dequant(x8, sx, w8_rows, sw, b, geom, dtype))


# ---- the chooser at the full-width networks' convs ----

GEOMETRY = (512, 768, 17)  # the headline clip: (H, W, T)


@pytest.fixture(scope="module")
def conv_census():
    """{(Cp, O, window, input shape): calls} of kernel 10 over a CFG-batch
    forward of the TV2V and TVI2V networks and a VAE encode (reference
    frame and clip) and decode, full widths, W8A8 on, on the meta device."""
    calls = collections.Counter()

    def record(x8, sx, w8_rows, sw, bias, geom, dtype=torch.bfloat16):
        calls[(x8.shape[-1], w8_rows.shape[0], geom, tuple(x8.shape))] += 1
        ho, wo = geom.out_hw(x8.shape[1], x8.shape[2])
        return torch.empty((x8.shape[0], ho, wo, w8_rows.shape[0]), dtype=dtype,
                           device=x8.device)

    def attention(q, k, v, scale):
        return torch.empty_like(q)

    h, w, t = GEOMETRY
    with torch.device("meta"):
        nets = [config.build_network(c["model"]["params"]["network_config"])
                for c in (config.TV2V_CONFIG, config.TVI2V_CONFIG)]
        vae = config.build_vae(config.TV2V_CONFIG["model"]["params"]["first_stage_config"])
    saved_routes, saved_state, saved_conv = dict(att._ROUTES), quant._STATE["matmul"], \
        quant.conv_dequant
    att._ROUTES.update({name: attention for name in saved_routes})
    quant.set_quantized_matmul(True)
    quant.conv_dequant = record
    try:
        with torch.no_grad(), torch.device("meta"):
            x = torch.empty(2, t, h // 8, w // 8, 4)
            cond = {"crossattn": torch.empty(2, 77, 768),
                    "control_hint": torch.empty(2, t, h, w, 3),
                    "cond_feat": torch.empty(2, h // 8, w // 8, 4)}
            for net in nets:
                net(x, torch.empty(2), cond)
            vae.encode_moments(torch.empty(1, h, w, 3))
            vae.encode_moments(torch.empty(1, t, h, w, 3))
            vae.decode(torch.empty(1, t, h // 8, w // 8, 4))
    finally:
        att._ROUTES.update(saved_routes)
        quant._STATE["matmul"] = saved_state
        quant.conv_dequant = saved_conv
    return calls


def test_census_covers_the_networks(conv_census):
    pairs = {(cp, o) for cp, o, _, _ in conv_census}
    # the UNet trunk, the hint pyramid (3 -> 16 at Cp 16 .. 256 -> 320), the
    # VAE's conv_in / conv_out and its widths
    assert {(320, 320), (640, 640), (1280, 1280), (2560, 1280), (1920, 640), (960, 320),
            (16, 320), (16, 16), (16, 32), (32, 96), (96, 256), (256, 320),
            (128, 3), (16, 128), (512, 512), (256, 128)} <= pairs, sorted(pairs)
    assert sum(conv_census.values()) > 200


def test_chooser_at_every_census_conv(conv_census):
    """Every (Cp, O) the networks give kernel 10 gets an instantiated tile
    whose ring holds at least two stages and the staged output tile, a
    chunk of 128 bytes for Cp > 64 (64, 32 below), BN 160 at the odd
    multiples of 160, the narrow tile at O <= 32 and BN 128 elsewhere;
    every window fits the im2col map's corner and offset limits."""
    for cp, o, geom, shape in conv_census:
        bm, bn, chunk = quant.conv_tiles(cp, o)
        assert (bm, bn) in KERNEL_TILES, (cp, o)
        smem = SMEM[KERNEL_TILES[(bm, bn)]]
        pitch = bn + (8 if (bn // 8) % 2 == 0 else 0)
        stage = (bm + bn) * 128  # 128 bytes of K a stage
        # the ring beside the TMA-store epilogue's bf16 staging (192 x 160),
        # or holding the staged tile itself
        out = bm * bn * 2 if (bm, bn) == (192, 160) else 0
        assert (smem - 1024 - out) // stage >= 2 and bm * pitch * 4 + 1024 <= smem
        assert chunk == (128 if cp > 64 else 64 if cp > 32 else 32)
        assert -(-cp // chunk) * chunk - cp < chunk
        if o % 160 == 0 and o % 128:
            assert (bm, bn) == (192, 160)
        if o <= 32:
            assert o <= bn <= 32 and bm == 256
        if o > 32 and (o % 160 or o % 128 == 0):
            assert (bm, bn) == (256, 128)
        ho, wo = geom.out_hw(shape[1], shape[2])
        lower, upper = pixel_box(shape[1], shape[2], geom, ho, wo)
        assert all(-128 <= v <= 127 for v in lower + upper)
        assert geom.kh * geom.kw <= 256 and max(geom.sh, geom.sw) <= 8


def test_smoke_rows_are_census_shapes(conv_census):
    """chip_smoke.py's phase 12 (a) conv rows are shapes the networks give
    kernel 10 at the headline clip (input shape after the quantizer's
    padding, O and window)."""
    census = {(shape, o, geom) for _, o, geom, shape in conv_census}
    for label, kind, x_shape, o, *window in chip_smoke.W8A8_SHAPES:
        if kind != "conv":
            continue
        geom = quant.geometry(*window)
        shape = tuple(x_shape[:-1]) + (() if len(x_shape) == 4 else (1,)) \
            + (quant.padded(x_shape[-1]),)
        assert (shape, o, geom) in census, label
