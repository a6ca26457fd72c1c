"""The structure annotators of the port against the JAX package, on the CPU
in fp32, and the port's cv2 stand-ins (``annotators/imgproc.py``) against
cv2 itself.

Each weighted kind gets one seeded random state dict in its reference
checkpoint's key layout, written with ``torch.save`` and read by both
packages' ``build_annotator`` (the JAX one converts it; NormalBAE at the
reduced spec of ``tests/test_normalbae.py``, the JAX builder narrowed by
monkeypatching ``NNET`` and ``convert_normalbae``).  Clips are (1, 2, 64, 64,
3) from numpy seeds.  Tolerances: each network's output within 1e-4 of its
largest magnitude; the hints after the whole post-process within 1e-4,
except where the post-process quantises: PiDiNet's ``safe_step`` is held on
the pixels whose JAX edge lies at least 1e-3 from a step, the scribbles on
the pixels whose JAX uint8 blur is not the threshold 4, and the pose
canvases on at least 99 % of their pixels.  The stand-ins: the float32
blur within 1e-6 of the range, the uint8 blur within 1 grey level (it is
bit-exact here), every resize within 1e-4 of the range, ``ellipse2Poly``,
circles and lines (inside the frame) exactly, and the drawn pose within 1 % of the limb pixels.
"""

import copy
import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

cv2 = pytest.importorskip("cv2")

from ccedit_tpu.conditioning.annotators import base as jbase  # noqa: E402
from ccedit_tpu.conditioning.annotators import hed as jhed  # noqa: E402
from ccedit_tpu.conditioning.annotators import normalbae as jnb  # noqa: E402
from ccedit_tpu.conditioning.annotators import openpose as jop  # noqa: E402
from ccedit_tpu.conditioning.annotators import pidinet as jpd  # noqa: E402
from ccedit_tpu.conditioning.annotators import scribble as jscr  # noqa: E402
from ccedit_tpu_torch.conditioning.annotators import base as tbase  # noqa: E402
from ccedit_tpu_torch.conditioning.annotators import hed as thed  # noqa: E402
from ccedit_tpu_torch.conditioning.annotators import imgproc  # noqa: E402
from ccedit_tpu_torch.conditioning.annotators import lineart_model as tlm  # noqa: E402
from ccedit_tpu_torch.conditioning.annotators import normalbae as tnb  # noqa: E402
from ccedit_tpu_torch.conditioning.annotators import openpose as top  # noqa: E402
from ccedit_tpu_torch.conditioning.annotators import pidinet as tpd  # noqa: E402
from ccedit_tpu_torch.conditioning.annotators import scribble as tscr  # noqa: E402

torch.set_num_threads(1)
NB_STAGES = ((8, 1, 3, 1, 1), (8, 2, 3, 2, 6), (16, 1, 5, 2, 6), (16, 1, 3, 2, 6),
             (16, 2, 5, 1, 6), (24, 1, 5, 2, 6), (24, 1, 3, 1, 6))
NB_STEM, NB_HEAD, NB_UP = 8, 32, (24, 16, 16, 8)


def _random_sd(shapes, seed, gain=1.0, bias=0.1):
    """N(0, gain^2 / fan_in) weights, N(0, bias^2) vectors."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, shape in shapes.items():
        x = rs.standard_normal(shape)
        if len(shape) >= 2:
            x = x * gain / np.sqrt(np.prod(shape[1:]))
        else:
            x = x * bias
        out[k] = torch.from_numpy(x.astype(np.float32))
    return out


def _shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def lineart_sd(seed=1):
    return _random_sd(_shapes(tlm.LineartGenerator()), seed)


def hed_sd(seed=2):
    sd = _random_sd(_shapes(thed.ControlNetHED()), seed, gain=1.4)
    sd["norm"] = torch.tensor([[[[120.0]], [[110.0]], [[100.0]]]])
    for k in sd:
        if "convs.0.weight" in k and k.startswith("block1"):
            sd[k] = sd[k] / 60.0  # inputs in 0..255
    return {"netNetwork." + k: v for k, v in sd.items()}


def pidinet_sd(seed=3):
    shapes = _shapes(tpd.PiDiNet())
    shapes = {k: (v[:2] + (3, 3) if len(v) == 4 and v[-1] == 5 else v) for k, v in shapes.items()}
    sd = _random_sd(shapes, seed, gain=1.2)
    return {"state_dict": {"module." + k: v for k, v in sd.items()}}


def normalbae_sd(seed=4):
    sd = _random_sd(_shapes(tnb.NNET(NB_STEM, NB_HEAD, NB_STAGES, NB_UP)), seed, gain=1.0)
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 0.5
        elif k.endswith(".weight") and sd[k].dim() == 1:
            sd[k] = 1.0 + sd[k]
    return {"model." + k: v for k, v in sd.items()}


def openpose_sd(seed=5):
    shapes = {k[len("convs."):]: v for k, v in _shapes(top.BodyPoseModel()).items()}
    sd = _random_sd(shapes, seed, gain=1.4, bias=0.02)
    sd["conv1_1.weight"] = sd["conv1_1.weight"] * 4.0
    # keep the heatmaps' peaks above thre1 few, so the assembly is small
    sd["Mconv7_stage6_L2.bias"] = sd["Mconv7_stage6_L2.bias"] * 0 - 0.05
    return sd


def _clip(seed=0, t=2, h=64, w=64):
    rs = np.random.RandomState(seed)
    base = rs.uniform(-1, 1, (1, 1, h // 8, w // 8, 3)).astype(np.float32)
    smooth = np.repeat(np.repeat(base, 8, axis=2), 8, axis=3)  # blocky, so edges exist
    noise = rs.uniform(-0.2, 0.2, (1, t, h, w, 3)).astype(np.float32)
    return np.clip(smooth + noise, -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("annot")
    out = {}
    for name, sd in (("sk_model.pth", lineart_sd()), ("ControlNetHED.pth", hed_sd()),
                     ("table5_pidinet.pth", pidinet_sd()), ("scannet.pt", normalbae_sd()),
                     ("body_pose_model.pth", openpose_sd())):
        torch.save(sd, d / name)
        out[name] = str(d / name)
    return out


@pytest.fixture
def narrow_jax_normalbae(monkeypatch):
    monkeypatch.setattr(jnb, "NNET", functools.partial(
        jnb.NNET, stem_ch=NB_STEM, head_ch=NB_HEAD, stages=NB_STAGES, up_dims=NB_UP))
    monkeypatch.setattr(jnb, "convert_normalbae",
                        functools.partial(jnb.convert_normalbae, stages=NB_STAGES))


def _both(target, params):
    j = jbase.build_annotator(target, params)
    t = tbase.build_annotator(target, params)
    assert t.kind == j.kind
    return j, t


def _run(j, t, video):
    ref = np.asarray(j.embed(None, jnp.asarray(video)))
    with torch.no_grad():
        ours = t(torch.from_numpy(video)).numpy()
    assert ours.shape == ref.shape
    return ours, ref


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


# ---------------------------------------------------------------------------
# networks and hints
# ---------------------------------------------------------------------------

def test_lineart_standard_matches_jax():
    video = _clip(1)
    ours, ref = _run(*_both("LineartEncoder", {}), video)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    assert (ours != 1.0).mean() > 0.01  # lines were drawn


def test_lineart_model_matches_jax(ckpts):
    video = _clip(2)
    j, t = _both("LineartEncoder", {"lineart_standard": False, "ckpt_path": ckpts["sk_model.pth"]})
    ours, ref = _run(j, t, video)
    assert _rel(ours, ref) <= 1e-4
    assert ref.std() > 1e-3


def test_hed_softedge_matches_jax(ckpts):
    video = _clip(3)
    sd = torch.load(ckpts["ControlNetHED.pth"])
    j = jbase.AnnotatorEmbedder("softedge_hed", backbone_params=jhed.convert_hed(
        {k: v.numpy() for k, v in sd.items()}))
    t = tbase.AnnotatorEmbedder("softedge_hed", backbone=thed.hed_from_state_dict(sd))
    ours, ref = _run(j, t, video)
    assert _rel(ours, ref) <= 1e-4 and ref.std() > 1e-3
    frames = torch.from_numpy(video[0])
    with torch.no_grad():  # the sigmoid on each projection before the mean
        ups = [torch.sigmoid(F.interpolate(q, size=frames.shape[1:3], mode="bilinear",
                                           align_corners=False))
               for q in t.backbone(((frames + 1.0) * 127.5).permute(0, 3, 1, 2))]
        fault = torch.stack(ups).mean(dim=0).permute(0, 2, 3, 1)
    jedge = np.asarray(jhed.detect_hed(j.backbone_params, jnp.asarray(video[0]), jhed.HEDNetwork()))
    assert _rel(fault.numpy(), jedge) > 1e-2  # the order of mean and sigmoid matters


def test_hed_scribble_matches_jax(ckpts):
    video = _clip(3)
    ours, ref = _run(*_both("ScribbleHEDEncoder", {"ckpt_path": ckpts["ControlNetHED.pth"]}), video)
    sd = torch.load(ckpts["ControlNetHED.pth"])
    params = jhed.convert_hed({k: v.numpy() for k, v in sd.items()})
    jedge = np.asarray(jhed.detect_hed(params, jnp.asarray(video[0]), jhed.HEDNetwork()))
    _check_scribble(ours, ref, _jax_scribble_blur(jedge[..., 0]))


def _jax_scribble_blur(edge01):
    """The JAX scribble path's uint8 blur, before its threshold."""
    frames = np.clip(edge01.astype(np.float32) * 255.0, 0, 255).astype(np.uint8)
    return np.stack([cv2.GaussianBlur(jscr.nms(e, 127, 3.0), (0, 0), 3.0) for e in frames])


def _check_scribble(ours, ref, blur):
    held = blur != 4
    assert held.mean() > 0.9
    np.testing.assert_array_equal(ours[0][held], ref[0][held])
    assert (ref == -1.0).any() and (ref == 1.0).any()  # strokes and background


@pytest.mark.parametrize("safe", [False, True])
def test_pidinet_softedge_matches_jax(ckpts, safe):
    video = _clip(4)
    j, t = _both("SoftEdgeEncoder", {"ckpt_path": ckpts["table5_pidinet.pth"], "safe": safe})
    ours, ref = _run(j, t, video)
    if not safe:
        assert _rel(ours, ref) <= 1e-4 and ref.std() > 1e-3
        return
    bgr = torch.from_numpy((video[0] + 1.0) * 0.5).flip(-1)
    with torch.no_grad():
        edge3 = tpd.detect_pidinet(t.backbone, bgr).numpy()[..., 0] * 3.0
    held = np.abs(edge3 - np.round(edge3)) >= 1e-3
    assert held.mean() > 0.99
    np.testing.assert_array_equal(ours[0][held], ref[0][held])


def test_pidinet_network_and_fold(ckpts):
    sd = torch.load(ckpts["table5_pidinet.pth"])["state_dict"]
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    x = np.random.RandomState(6).uniform(0, 1, (2, 48, 40, 3)).astype(np.float32)
    ref = np.asarray(jpd.PiDiNet().apply(
        {"params": jpd.convert_pidinet({k: v.numpy() for k, v in sd.items()})}, jnp.asarray(x)))
    model = tpd.pidinet_from_state_dict(sd)
    with torch.no_grad():
        outs = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        # every PDC weight loaded as a plain 3x3 conv: the fold left out
        unfolded = tpd.PiDiNet(pdcs=("cv",) * 16)
        unfolded.load_state_dict(sd)
        unfolded = unfolded(torch.from_numpy(x).permute(0, 3, 1, 2))[-1]
    for o, r in zip(outs, ref):
        assert _rel(o.permute(0, 2, 3, 1).numpy(), r) <= 1e-4
    assert _rel(unfolded.permute(0, 2, 3, 1).numpy(), ref[-1]) > 1e-2  # the fold matters
    for op in ("cd", "ad", "rd", "cv"):
        w = np.random.RandomState(7).standard_normal((4, 2, 3, 3)).astype(np.float32)
        np.testing.assert_allclose(tpd.convert_pdc_weight(op, torch.from_numpy(w)).numpy(),
                                   jpd.convert_pdc_weight(op, w), atol=1e-6, rtol=0)


def test_scribble_pidinet_matches_jax(ckpts):
    video = _clip(5)
    ours, ref = _run(*_both("ScribblePidiNetEncoder", {"ckpt_path": ckpts["table5_pidinet.pth"]}),
                     video)
    sd = {k.replace("module.", ""): v.numpy()
          for k, v in torch.load(ckpts["table5_pidinet.pth"])["state_dict"].items()}
    bgr = jnp.asarray(((video[0] + 1.0) * 0.5)[..., ::-1])
    jedge = np.asarray(jpd.detect_pidinet(jpd.convert_pidinet(sd), bgr))[..., 0]
    _check_scribble(ours, ref, _jax_scribble_blur(jedge))


def test_normalbae_matches_jax(ckpts, narrow_jax_normalbae):
    video = _clip(6)
    j, t = _both("NormalBaeEncoder", {"ckpt_path": ckpts["scannet.pt"]})
    assert [tuple(s) for s in tnb._stages_of(
        {k[6:]: v for k, v in torch.load(ckpts["scannet.pt"]).items()})] == list(NB_STAGES)
    ours, ref = _run(j, t, video)
    assert _rel(ours, ref) <= 1e-4 and ref.std() > 1e-2
    # every stage's prediction, the refinements' top-k picks among them
    x = np.random.RandomState(8).standard_normal((1, 64, 96, 3)).astype(np.float32)
    jouts = jnb.NNET().apply({"params": j.backbone_params}, jnp.asarray(x))
    with torch.no_grad():
        touts = t.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        skipped = copy.deepcopy(t.backbone)
        for stage in ("res4", "res2", "res1"):  # each refinement returns its input's estimate
            setattr(skipped.decoder, f"out_conv_{stage}", _KeepInit())
        skipped = skipped(torch.from_numpy(x).permute(0, 3, 1, 2))[-1]
    for o, r in zip(touts, jouts):
        assert _rel(o.permute(0, 2, 3, 1).numpy(), np.asarray(r)) <= 1e-4
    assert _rel(skipped.permute(0, 2, 3, 1).numpy(), np.asarray(jouts[-1])) > 1e-2


class _KeepInit(torch.nn.Module):
    """A refinement head that returns the sampled points' own estimate (the
    last 4 of its input channels): NormalBAE with its refinements skipped."""

    def forward(self, x):
        return x[:, -4:]


def test_normalbae_top_k_ties_go_to_the_lower_index():
    """lax.top_k's order among exact kappa ties, which the port's stable
    sort keeps."""
    import jax

    kappa = np.array([[3.0, 1.0, 1.0, 2.0, 1.0, 1.0, 0.5, 1.0]], np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(-kappa), 4)
    tidx = torch.sort(torch.from_numpy(-kappa), dim=1, descending=True, stable=True).indices[:, :4]
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_openpose_maps_and_hint_match_jax(ckpts):
    video = _clip(7)
    j, t = _both("OpenposeEncoder", {"ckpt_path": ckpts["body_pose_model.pth"]})
    frames = video[0]
    # the network's maps, as the JAX estimator computes them before assembly
    x255 = np.clip((frames + 1.0) * 127.5, 0, 255)[..., ::-1]
    est = jop.BodyEstimator(j.backbone_params)
    h, w = frames.shape[1:3]
    scale = 0.5 * 368.0 / h
    resized = cv2.resize(x255[0].astype(np.float32), None, fx=scale, fy=scale,
                         interpolation=cv2.INTER_CUBIC)
    padded, _ = jop._pad_to_stride(resized, 8, 128.0)
    paf, heat = est._apply(est.params, jnp.asarray(padded[None] / 256.0 - 0.5, jnp.float32))
    heat = cv2.resize(np.asarray(heat[0]), (padded.shape[1], padded.shape[0]),
                      interpolation=cv2.INTER_LINEAR)
    heat = cv2.resize(heat[:resized.shape[0], :resized.shape[1]], (w, h),
                      interpolation=cv2.INTER_LINEAR)
    with torch.no_grad():
        theat, tpaf = top.openpose_maps(t.backbone, torch.from_numpy(frames))
        fheat, _ = top.openpose_maps(t.backbone, torch.from_numpy(frames[..., ::-1].copy()))
    assert _rel(theat[0].numpy(), heat) <= 1e-4
    assert _rel(fheat[0].numpy(), heat) > 1e-2  # the BGR flip matters
    ours, ref = _run(j, t, video)
    assert (ours == ref).all(-1).mean() >= 0.99
    assert (ref < 1.0).any()  # a pose was drawn


def test_pose_assembly_matches_jax():
    """Peaks, limbs and people from the same maps (two synthetic stick
    figures: Gaussian joints, PAFs along each limb)."""
    h, w = 96, 128
    rs = np.random.RandomState(9)
    heat = np.zeros((h, w, 19), np.float32)
    paf = np.zeros((h, w, 38), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for person in range(2):
        joints = np.stack([rs.uniform(10 + 60 * person, 60 + 60 * person, 18),
                           rs.uniform(10, h - 10, 18)], axis=1)
        for p, (x, y) in enumerate(joints):
            heat[..., p] = np.maximum(heat[..., p], np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 8.0))
        for k, (a, b) in enumerate(jop.LIMB_SEQ):
            pa, pb = joints[a - 1], joints[b - 1]
            v = (pb - pa) / max(np.linalg.norm(pb - pa), 1e-3)
            for s in np.linspace(0, 1, 60):
                x, y = (pa + s * (pb - pa)).round().astype(int)
                ys, xs = slice(max(y - 2, 0), y + 3), slice(max(x - 2, 0), x + 3)
                paf[ys, xs, jop.MAP_IDX[k][0] - 19] = v[0]
                paf[ys, xs, jop.MAP_IDX[k][1] - 19] = v[1]
    jpeaks, tpeaks = jop.find_peaks(heat), top.find_peaks(heat)
    assert jpeaks == tpeaks
    jconn, jspecial = jop.assemble_limbs(jpeaks, paf, h)
    tconn, tspecial = top.assemble_limbs(tpeaks, paf, h)
    assert jspecial == tspecial
    for a, b in zip(jconn, tconn):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jcand, jsub = jop.merge_subsets(jpeaks, jconn, jspecial)
    tcand, tsub = top.merge_subsets(tpeaks, tconn, tspecial)
    np.testing.assert_array_equal(jcand, tcand)
    np.testing.assert_array_equal(jsub, tsub)
    assert len(tsub) >= 1


def test_pose_canvas_matches_cv2_drawing():
    """A fixed candidate and subset drawn by the JAX package (cv2) and by
    the port (imgproc): >= 99 % of the limb pixels equal."""
    rs = np.random.RandomState(10)
    h, w = 512, 768
    cand = np.concatenate([rs.uniform(0.05, 0.95, (36, 2)), rs.uniform(0.5, 1, (36, 1)),
                           np.arange(36)[:, None]], axis=1)
    subset = np.concatenate([np.arange(36).reshape(2, 18), np.full((2, 2), 10.0)], axis=1)
    subset[0, 5] = -1  # a missing joint: its limbs are skipped
    ref = jop.draw_bodypose(np.zeros((h, w, 3), np.uint8), cand, subset)
    ours = top.draw_bodypose(np.zeros((h, w, 3), np.uint8), cand, subset)
    drawn = ref.any(-1) | ours.any(-1)
    assert drawn.sum() > 5000
    assert (ours == ref).all(-1)[drawn].mean() >= 0.99


def test_annotators_run_without_cv2(ckpts, monkeypatch, narrow_jax_normalbae):
    """Every kind through the port with ``import cv2`` failing."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    video = torch.from_numpy(_clip(11))
    for target, params in (
            ("LineartEncoder", {}),
            ("LineartEncoder", {"lineart_standard": False, "ckpt_path": ckpts["sk_model.pth"]}),
            ("SoftEdgeEncoder", {"ckpt_path": ckpts["table5_pidinet.pth"], "safe": True}),
            ("ScribblePidiNetEncoder", {"ckpt_path": ckpts["table5_pidinet.pth"]}),
            ("ScribbleHEDEncoder", {"ckpt_path": ckpts["ControlNetHED.pth"]}),
            ("NormalBaeEncoder", {"ckpt_path": ckpts["scannet.pt"]}),
            ("OpenposeEncoder", {"ckpt_path": ckpts["body_pose_model.pth"]}),
            ("DepthMidasEncoder", {"fake_annotator": True})):
        with torch.no_grad():
            out = tbase.build_annotator(target, params)(video)
        assert out.shape == video.shape and bool(torch.isfinite(out).all()), target


@pytest.mark.parametrize("target,file", [("SoftEdgeEncoder", "table5_pidinet.pth"),
                                         ("OpenposeEncoder", "body_pose_model.pth"),
                                         ("LineartEncoder", "sk_model.pth")])
def test_a_weighted_kind_without_a_checkpoint_names_its_file(target, file):
    params = {"lineart_standard": False} if target == "LineartEncoder" else {}
    emb = tbase.build_annotator(target, dict(params, fake_annotator=True))
    with pytest.raises(RuntimeError, match=file):
        emb(torch.zeros(1, 1, 32, 32, 3))


# ---------------------------------------------------------------------------
# the cv2 stand-ins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (37, 53), (128, 192)])
def test_blurs_and_dilate_match_cv2(shape):
    rs = np.random.RandomState(12)
    x = (rs.rand(*shape) * 255).astype(np.uint8)
    x[rs.rand(*shape) > 0.9] = 255
    ours = imgproc.gaussian_blur_u8(x, 3.0).astype(int)
    assert np.abs(ours - cv2.GaussianBlur(x, (0, 0), 3.0)).max() <= 1
    xf = x.astype(np.float32)
    ref = cv2.GaussianBlur(xf, (0, 0), 3.0)
    assert np.abs(imgproc.gaussian_blur_f32(xf, 3.0) - ref).max() <= 1e-6 * 255
    for f in tscr._LINES:
        np.testing.assert_array_equal(imgproc.dilate(ref, f), cv2.dilate(ref, kernel=f))


@pytest.mark.parametrize("hw,kw", [
    ((512, 768), dict(fx=0.359375, fy=0.359375, interpolation=cv2.INTER_AREA)),
    ((300, 200), dict(fx=0.6133, fy=0.6133, interpolation=cv2.INTER_AREA)),
    ((512, 768), dict(fx=0.5, fy=0.5, interpolation=cv2.INTER_AREA)),
    ((64, 64), dict(fx=2.875, fy=2.875, interpolation=cv2.INTER_CUBIC)),
    ((23, 35), dict(dsize=(280, 184), interpolation=cv2.INTER_LINEAR)),
    ((184, 276), dict(dsize=(768, 512), interpolation=cv2.INTER_LINEAR)),
    ((50, 70), dict(dsize=(33, 21), interpolation=cv2.INTER_LINEAR)),
])
def test_resize_matches_cv2(hw, kw):
    x = np.random.RandomState(13).rand(*hw, 3).astype(np.float32) * 255
    kw = dict(kw)
    dsize = kw.pop("dsize", None)
    ref = cv2.resize(x, dsize, **kw)
    ours = imgproc.resize(x, dsize, **kw)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-4 * 255


def test_drawing_primitives_match_cv2():
    rs = np.random.RandomState(14)
    for _ in range(50):
        center = (int(rs.randint(-5, 130)), int(rs.randint(-5, 100)))
        axes, angle = (int(rs.randint(0, 80)), 4), int(rs.randint(-400, 400))
        np.testing.assert_array_equal(imgproc.ellipse2Poly(center, axes, angle, 0, 360, 1),
                                      cv2.ellipse2Poly(center, axes, angle, 0, 360, 1))
        a, b = np.zeros((96, 128), np.uint8), np.zeros((96, 128), np.uint8)
        cv2.circle(a, center, 4, 255, thickness=-1)
        imgproc.circle(b, center, 4, 255)
        np.testing.assert_array_equal(a, b)
        p, q = (tuple(int(v) for v in rs.randint(3, 90, 2)) for _ in range(2))
        a[:] = 0
        b[:] = 0
        cv2.line(a, p, q, 255)
        imgproc.line(b, p, q, 255)
        np.testing.assert_array_equal(a, b)

