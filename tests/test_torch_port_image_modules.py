"""The image slice's modules and small CLIs, port against the JAX package on
the CPU:

* InceptionV3 (every tap, ``resize_input`` and ``normalize_input``) with
  the same seeded weights through ``from_jax("inception")``, 1e-4 of the
  largest value; ``load_inception`` reads a ``pytorch_fid`` state dict
  (``fc`` and ``AuxLogits`` left out); FID's statistics and distance, and
  ``fid`` over two image sets, against the JAX ``utils/fid.py`` (1e-6 of
  the distance);
* the safety filter: ``predict_proba``, the CLIP preprocessing (1e-4: two
  fp32 resize contractions in another order, divided by CLIP's std of
  ~0.27), the 99-tap blur (1e-5), CLIP ViT-L's quick-GELU tower at a narrow width
  (1e-4), the pass-through without weights (one warning), and
  ``from_files`` with a written checkpoint and planted ``.npz`` heads
  blurring exactly the flagged image;
* the watermark's embed and ``decode_lsb`` array for array against JAX,
  and ``detect`` on PNGs;
* the toy datasets item for item (synthetic, IDX files, CIFAR pickles) and
  the tar-shard dataset and data module sample for sample;
* ``pnp_generate_config``: ``yaml.safe_load`` of the port's file equals
  that of the JAX CLI's;
* ``extract_centerframe`` on the bear clip's frames against the JAX CLI's
  PNG of the mp4, at the clip's own 256x256 (a resize is OpenCV's bicubic
  for the mp4, PIL's for a frame directory): the port writes the decoded
  frame itself, the JAX CLI its round trip through [-1, 1] floats, whose
  truncating ``to_uint8`` lowers some values by 1; ``sampling_image``'s flag surface (the JAX one plus
  ``--device``);
* the demo: ``parse_multipart`` against the JAX parser, the bounded session
  cache, and an HTTP round trip on 127.0.0.1 (a url-encoded txt2img POST
  and a multipart img2img POST, each answered with a decodable PNG);
* ``auto_pipeline`` with ``--edited_frame`` on a tiny TVI2V config;
* the PNG reader against PIL (8-bit gray, RGB, RGBA, every row filter), the
  writer through PIL, and the reader refusing what it does not read.
"""

import argparse
import gzip
import io
import json
import pickle
import re
import struct
import sys
import tarfile
import threading
import urllib.parse
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from ccedit_tpu.cli import demo as jdemo
from ccedit_tpu.cli import detect_watermark as jdw
from ccedit_tpu.cli import extract_centerframe as jextract
from ccedit_tpu.cli import pnp_generate_config as jpnp
from ccedit_tpu.cli import sampling_image as jsi
from ccedit_tpu.data import toy as jtoy
from ccedit_tpu.data import webdataset as jwds
from ccedit_tpu.modules import inception as jinc
from ccedit_tpu.modules import openclip as joc
from ccedit_tpu.utils import fid as jfid
from ccedit_tpu.utils import safety as jsafety
from ccedit_tpu.utils import watermark as jwm
from ccedit_tpu_torch import config
from ccedit_tpu_torch.assets import BEAR_FRAMES
from ccedit_tpu_torch.cli import auto_pipeline, demo, detect_watermark, extract_centerframe
from ccedit_tpu_torch.cli import pnp_generate_config, sampling_image
from ccedit_tpu_torch.data import toy, webdataset
from ccedit_tpu_torch.data.video import png_bytes, read_png, write_png
from ccedit_tpu_torch.io.checkpoint import randomize_weights_
from ccedit_tpu_torch.io.jax_params import from_jax
from ccedit_tpu_torch.modules import inception, openclip
from ccedit_tpu_torch.utils import fid, safety, watermark

torch.set_num_threads(1)
BEAR_MP4 = "docs/artifacts/bear_smoke/bear_original.mp4"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


# ---- InceptionV3 and FID -------------------------------------------------

@pytest.fixture(scope="module")
def inception_pair():
    rs = np.random.RandomState(0)
    jm = jinc.InceptionV3(output_blocks=(0, 1, 2, 3), resize_input=True, normalize_input=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 80, 80, 3)))

    def draw(path, s):
        leaf = getattr(path[-1], "key", "")
        v = rs.standard_normal(s.shape)
        if leaf == "kernel":
            return (v * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        if leaf == "bn_var":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (v * 0.1 + (1.0 if leaf == "bn_scale" else 0.0)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)["params"]
    tm = inception.InceptionV3(output_blocks=(0, 1, 2, 3), resize_input=True,
                               normalize_input=True).eval()
    inception.load_inception(tm, from_jax("inception", params))
    return jm, params, tm


def test_inception_taps_match_jax(inception_pair):
    jm, params, tm = inception_pair
    x = np.random.RandomState(1).uniform(0, 1, (2, 96, 80, 3)).astype(np.float32)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
    assert [tuple(o.shape) for o in out][-1] == (2, 2048)
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) <= 1e-4


def test_load_inception_reads_a_pytorch_fid_state_dict(inception_pair):
    _, _, tm = inception_pair
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    sd["fc.weight"], sd["AuxLogits.fc.weight"] = torch.zeros(1008, 2048), torch.zeros(10, 768)
    fresh = inception.InceptionV3()
    inception.load_inception(fresh, sd)
    assert torch.equal(fresh.Mixed_7c.branch_pool.conv.weight, tm.Mixed_7c.branch_pool.conv.weight)
    del sd["Mixed_5b.branch1x1.bn.running_var"]
    with pytest.raises(KeyError, match="running_var"):
        inception.load_inception(fresh, sd)


def test_fid_matches_jax(inception_pair):
    jm, params, tm = inception_pair
    rs = np.random.RandomState(2)
    a = [rs.uniform(0, 1, (64, 64, 3)).astype(np.float32) for _ in range(5)]
    b = [np.clip(x + 0.3, 0, 1) for x in a]
    jfeats = jfid.activations(params, a, batch_size=2, model=jinc.InceptionV3(
        resize_input=True, normalize_input=True))
    tmodel = fid.fid_inception()
    inception.load_inception(tmodel, tm.state_dict())
    feats = fid.activations(tmodel, a, batch_size=2)
    assert feats.shape == (5, 2048) and _rel(feats, jfeats) <= 1e-4
    fa, fb = rs.standard_normal((64, 8)), rs.standard_normal((64, 8)) + 1.0
    for ta, tb in ((fa, fb), (fa, fa)):
        mine = fid.frechet_distance(*fid.statistics(ta), *fid.statistics(tb))
        ref = jfid.frechet_distance(*jfid.statistics(ta), *jfid.statistics(tb))
        assert abs(mine - ref) <= 1e-6 * max(abs(ref), 1.0)
    assert abs(fid.frechet_distance(*fid.statistics(fa), *fid.statistics(fa))) < 1e-6
    d = fid.fid(tmodel, a, b, batch_size=3)
    assert np.isfinite(d) and d > fid.fid(tmodel, a, a, batch_size=3)


# ---- the safety filter ---------------------------------------------------

def test_predict_proba_preprocessing_and_blur_match_jax():
    rs = np.random.RandomState(3)
    feats = rs.standard_normal((4, 16)).astype(np.float16)
    w, bias = rs.standard_normal((1, 16)).astype(np.float32) * 5, np.array([0.3], np.float32)
    np.testing.assert_array_equal(safety.predict_proba(feats, w, bias),
                                  jsafety.predict_proba(feats, w, bias))
    imgs = rs.uniform(0, 1, (2, 120, 90, 3)).astype(np.float32)
    np.testing.assert_allclose(safety.clip_process_images(torch.from_numpy(imgs))
                               .permute(0, 2, 3, 1).numpy(),
                               np.asarray(jsafety.clip_process_images(jnp.asarray(imgs))),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(safety.gaussian_blur(torch.from_numpy(imgs)).numpy(),
                               np.asarray(jsafety.gaussian_blur(jnp.asarray(imgs))),
                               atol=1e-5, rtol=0)


def _tiny_clip():
    return openclip.OpenCLIPVisionModel(patch_size=14, width=32, heads=2, layers=2,
                                        output_dim=16, act="quick_gelu")


def test_quick_gelu_vision_tower_matches_jax():
    model = _tiny_clip().eval()
    randomize_weights_(model, torch.Generator().manual_seed(4))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jm = joc.OpenCLIPVisionModel(patch_size=14, width=32, heads=2, layers=2, output_dim=16,
                                 act="quick_gelu")
    x = np.random.RandomState(5).standard_normal((2, 3, 224, 224)).astype(np.float32)
    ref = jm.apply({"params": joc.convert_openclip_vision(sd, layers=2)},
                   jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert _rel(out.numpy(), ref) <= 1e-4


def test_filter_passes_through_without_weights():
    filt = safety.DeepFloydDataFiltering.from_files()
    x = torch.rand(2, 32, 32, 3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert filt(x) is x and filt(x) is x
    assert len([w for w in caught if "passthrough" in str(w.message)]) == 1
    jf = jsafety.DeepFloydDataFiltering.from_files()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_array_equal(np.asarray(jf(x.numpy())), x.numpy())


def test_from_files_blurs_exactly_the_flagged_image(tmp_path, monkeypatch):
    model = _tiny_clip()
    randomize_weights_(model, torch.Generator().manual_seed(6))
    torch.save({f"visual.{k}": v for k, v in model.state_dict().items()}, tmp_path / "clip.pt")
    monkeypatch.setattr(safety, "clip_vit_l14", _tiny_clip)
    imgs = torch.rand(3, 48, 64, 3, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        feats = model.eval()(safety.clip_process_images(imgs)).numpy().astype(np.float16)
    target = np.array([-1.0, 4.0, -1.0])
    w = np.linalg.lstsq(feats.astype(np.float64), target, rcond=None)[0]
    np.savez(tmp_path / "p_head_v1.npz", weights=w[None].astype(np.float32),
             biases=np.zeros(1, np.float32))
    filt = safety.DeepFloydDataFiltering.from_files(clip_ckpt=str(tmp_path / "clip.pt"),
                                                    p_head_path=str(tmp_path / "p_head_v1.npz"))
    assert filt.flags(imgs).tolist() == [False, True, False]
    out = filt(imgs)
    assert torch.equal(out[0], imgs[0]) and torch.equal(out[2], imgs[2])
    assert torch.equal(out[1], safety.gaussian_blur(imgs)[1])


# ---- the watermark -------------------------------------------------------

def test_watermark_matches_jax_and_detect_reads_it(tmp_path):
    rs = np.random.RandomState(8)
    imgs = rs.uniform(0, 1, (2, 40, 30, 3)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        marked, jmarked = watermark.WatermarkEmbedder()(imgs), jwm.WatermarkEmbedder()(imgs)
    np.testing.assert_array_equal(marked, jmarked)
    assert watermark.WATERMARK_BITS == jwm.WATERMARK_BITS
    assert watermark.decode_lsb(marked) == jwm.decode_lsb(jmarked) == watermark.WATERMARK_BITS
    write_png(str(tmp_path / "m.png"), np.round(marked[0] * 255).astype(np.uint8))
    write_png(str(tmp_path / "c.png"), np.zeros((40, 30, 3), np.uint8))
    for name, want in (("m.png", True), ("c.png", False)):
        assert detect_watermark.detect(str(tmp_path / name)) is want
        assert jdw.detect(str(tmp_path / name)) is want
    assert detect_watermark.main([str(tmp_path / "m.png")]) == {str(tmp_path / "m.png"): True}


# ---- datasets ------------------------------------------------------------

def _same_item(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


def test_toy_datasets_match_jax_item_for_item(tmp_path):
    rs = np.random.RandomState(9)
    for mine, ref in ((toy.MNISTDataset(n_synthetic=16, seed=3),
                       jtoy.MNISTDataset(n_synthetic=16, seed=3)),
                      (toy.CIFAR10Dataset(n_synthetic=16, seed=4, train=False),
                       jtoy.CIFAR10Dataset(n_synthetic=16, seed=4, train=False))):
        assert mine.synthetic and len(mine) == len(ref) == 16
        for i in range(16):
            _same_item(mine[i], ref[i])
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    images = rs.randint(0, 256, (6, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, (6,)).astype(np.uint8)
    with gzip.open(raw / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 0x0803, 6, 28, 28) + images.tobytes())
    with open(raw / "train-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 0x0801, 6) + labels.tobytes())
    batches = tmp_path / "cifar-10-batches-py"
    batches.mkdir()
    with open(batches / "test_batch", "wb") as f:
        pickle.dump({b"data": rs.randint(0, 256, (5, 3072)).astype(np.uint8),
                     b"labels": list(range(5))}, f)
    for mine, ref in ((toy.build_toy_dataset("sgm.data.mnist.MNISTLoader", {"root": str(tmp_path)}),
                       jtoy.build_toy_dataset("sgm.data.mnist.MNISTLoader", {"root": str(tmp_path)})),
                      (toy.CIFAR10Dataset(str(tmp_path), train=False),
                       jtoy.CIFAR10Dataset(str(tmp_path), train=False))):
        assert not mine.synthetic and len(mine) == len(ref)
        for i in range(len(ref)):
            _same_item(mine[i], ref[i])
    with pytest.raises(ValueError):
        toy.build_toy_dataset("sgm.data.other.Loader")


def _write_shard(path, samples):
    with tarfile.open(path, "w") as tf:
        for name, data in samples:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def test_tar_shards_match_jax_sample_for_sample(tmp_path):
    rs = np.random.RandomState(10)
    img = rs.randint(0, 256, (12, 10, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    npy = io.BytesIO()
    np.save(npy, rs.standard_normal((3, 2)).astype(np.float32))
    _write_shard(tmp_path / "shard-000.tar", [
        ("a.png", buf.getvalue()), ("a.txt", b"a red fox"), ("a.cls", b" 3 "),
        ("a.json", b'{"fps": 6}'), ("b.npy", npy.getvalue()), ("b.txt", b"snow"),
        ("c.mp4", b"\x00\x01raw")])
    _write_shard(tmp_path / "shard-001.tar", [("d.txt", b"second shard"), ("d.id", b"7")])
    for shard in ("shard-000.tar", "shard-001.tar"):
        mine = list(webdataset.iterate_shard(str(tmp_path / shard)))
        ref = list(jwds.iterate_shard(str(tmp_path / shard)))
        assert len(mine) == len(ref) > 0
        for a, b in zip(mine, ref):
            _same_item(a, b)
    np.testing.assert_array_equal(next(webdataset.iterate_shard(
        str(tmp_path / "shard-000.tar")))["png"], img)
    kw = dict(shuffle_shards=True, seed=5, repeat=False)
    for src in (str(tmp_path), str(tmp_path / "shard-*.tar")):
        mine = [s["__key__"] for s in webdataset.TarShardDataset(src, **kw)]
        assert mine == [s["__key__"] for s in jwds.TarShardDataset(src, **kw)]
        assert sorted(mine) == ["a", "b", "c", "d"]
    cfg = {"train": {"shards": str(tmp_path), "batch_size": 3}}
    mine = webdataset.StableDataModuleFromConfig(**cfg).train_dataloader()
    ref = jwds.StableDataModuleFromConfig(**cfg).train_dataloader()
    for _ in range(3):  # the train loader repeats its shards
        assert [s["__key__"] for s in next(mine)] == [s["__key__"] for s in next(ref)]
    with pytest.raises(FileNotFoundError):
        webdataset.TarShardDataset(str(tmp_path / "none-*.tar"))


# ---- the small CLIs -------------------------------------------------------

def _run_jax_main(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    main()


@pytest.mark.parametrize("prompt", ["a robot bear, walking: in snow", "yes", "1.5",
                                    "it's \"quoted\" # not a comment", ""])
def test_pnp_config_yaml_equals_jax(tmp_path, monkeypatch, prompt):
    argv = ["--image_path", "c.png", "--prompt", prompt, "--steps", "30",
            "--guidance_scale", "6.5"]
    pnp_generate_config.main(argv + ["--save_path", str(tmp_path / "port.yaml")])
    _run_jax_main(jpnp.main, argv + ["--save_path", str(tmp_path / "jax.yaml")], monkeypatch)
    mine = yaml.safe_load((tmp_path / "port.yaml").read_text())
    assert mine == yaml.safe_load((tmp_path / "jax.yaml").read_text())
    assert mine["prompt"] == prompt and mine["n_timesteps"] == 30


def test_extract_centerframe_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    common = ["--H", "256", "--W", "256", "--original_fps", "3", "--target_fps", "3",
              "--num_keyframes", "5"]
    out = extract_centerframe.main(["--video_path", str(BEAR_FRAMES), "--save_path",
                                    str(tmp_path / "port.png")] + common)
    _run_jax_main(jextract.main, ["--video_path", BEAR_MP4, "--save_path",
                                  str(tmp_path / "jax.png")] + common, monkeypatch)
    mine, ref = read_png(out), np.asarray(Image.open(tmp_path / "jax.png")).astype(int)
    np.testing.assert_array_equal(mine, read_png(sorted(BEAR_FRAMES.iterdir())[2]))
    assert set(np.unique(mine.astype(int) - ref)) <= {0, 1}


def test_image_flag_surface_is_the_jax_one_plus_device():
    def flags(p):
        return {a.dest: (a.default, a.required, tuple(a.choices or ())) for a in p._actions
                if a.dest != "help"}

    mine = flags(sampling_image.add_image_args(argparse.ArgumentParser()))
    ref = flags(jsi.add_image_args(argparse.ArgumentParser()))
    assert set(mine) - set(ref) == {"device"} and not set(ref) - set(mine)
    for k in ref:
        assert mine[k] == ref[k], k


# ---- the demo ------------------------------------------------------------

def _multipart(fields, files, boundary="----test-boundary"):
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
             .encode() for k, v in fields.items()]
    parts += [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; '
              f'filename="{k}.png"\r\nContent-Type: image/png\r\n\r\n'.encode() + data + b"\r\n"
              for k, data in files.items()]
    return (b"".join(parts) + f"--{boundary}--\r\n".encode(),
            f"multipart/form-data; boundary={boundary}")


def test_multipart_parser_matches_jax():
    body, ctype = _multipart({"prompt": "a fox, ünïcode", "seed": "3", "empty": ""},
                             {"init_image": png_bytes(np.full((4, 5, 3), 9, np.uint8))})
    assert demo.parse_multipart(body, ctype) == jdemo.parse_multipart(body, ctype)
    fields, files = demo.parse_multipart(body, ctype)
    assert fields["prompt"] == "a fox, ünïcode" and read_png(files["init_image"]).shape == (4, 5, 3)


def test_demo_session_cache_is_bounded(monkeypatch):
    built = []
    monkeypatch.setattr(demo, "build_image_session", lambda args: built.append(
        args.config_path) or object())
    args = demo.parser().parse_args(["--config_path", "sd21_768", "--device", "cpu"])
    versions = {v: {"config": v, "ckpt": ""} for v in ("a", "b", "c")}
    state = demo.DemoState(args, versions, cache_size=2)
    for v in ("a", "b", "a", "c", "b"):
        state.session({"version": v}, state.request_args({"version": v}))
    assert built == ["a", "b", "c", "b"]  # "b" was evicted by "c", "a" kept by its reuse
    assert list(state.sessions) == ["c", "b"]
    assert demo.parse_versions(demo.parser().parse_args(
        ["--config_path", "sd21_768", "--version", "x=cfg.yaml:ck.pt"])) == {
        "sd21_768": {"config": "sd21_768", "ckpt": ""}, "x": {"config": "cfg.yaml", "ckpt": "ck.pt"}}


def _tiny_sd21():
    import copy

    cfg = copy.deepcopy(config.SD21_768_CONFIG)
    p = cfg["model"]["params"]
    p["network_config"]["params"].update(
        model_channels=32, channel_mult=[1, 2], attention_resolutions=[2, 1], num_res_blocks=1,
        num_head_channels=16, context_dim=32, use_checkpoint=False)
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2, 2, 2],
                                                        num_res_blocks=1)
    return cfg


def test_demo_http_round_trip(tmp_path, monkeypatch):
    from ccedit_tpu_torch.conditioning import embedders

    monkeypatch.setitem(embedders.OpenCLIPTextEmbedder.ARCHS, "ViT-H-14", (32, 2, 2))
    monkeypatch.setitem(config.BUILTIN_CONFIGS, "tiny_sd21", _tiny_sd21())
    args = demo.parser().parse_args(["--config_path", "tiny_sd21", "--device", "cpu",
                                     "--save_path", str(tmp_path / "out")])
    state = demo.DemoState(args, demo.parse_versions(args))
    server = demo.serve(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    fields = {"prompt": "a fox", "seed": "1", "H": "64", "W": "64", "sample_steps": "2",
              "num_samples": "1"}

    def post(body, ctype):
        req = urllib.request.Request(base + "/generate", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            return r.read().decode()

    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        pages = [post(urllib.parse.urlencode(fields).encode(),
                      "application/x-www-form-urlencoded")]
        init = png_bytes(np.random.RandomState(11).randint(0, 256, (64, 64, 3)).astype(np.uint8))
        pages.append(post(*_multipart(dict(fields, img2img_strength="0.5"),
                                      {"init_image": init})))
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    import base64

    for page in pages:
        found = re.findall(r"data:image/png;base64,([A-Za-z0-9+/=]+)", page)
        assert len(found) == 1
        assert read_png(base64.b64decode(found[0])).shape == (64, 64, 3)
    assert len(state.sessions) == 1  # one warm session served both requests


# ---- the auto pipeline ---------------------------------------------------

def test_auto_pipeline_with_an_edited_frame(tmp_path, monkeypatch):
    import copy

    from ccedit_tpu_torch.modules import clip as tclip

    cfg = copy.deepcopy(config.TVI2V_CONFIG)
    p = cfg["model"]["params"]
    tiny = dict(model_channels=32, channel_mult=[1, 2], attention_resolutions=[2, 1],
                num_res_blocks=1, num_heads=2, context_dim=16)
    p["network_config"]["params"].update(tiny)
    for key in ("controlnet_config", "controlnet_img_config"):
        p["network_config"]["params"][key]["params"].update(tiny)
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2, 2, 2],
                                                        num_res_blocks=1)
    monkeypatch.setitem(config.BUILTIN_CONFIGS, "tiny_tvi2v", cfg)
    monkeypatch.setattr(config, "CLIPTextModel",
                        lambda **kw: tclip.CLIPTextModel(width=16, heads=2, layers=1))
    edited = tmp_path / "edited.png"
    write_png(str(edited), np.random.RandomState(12).randint(0, 256, (64, 64, 3))
              .astype(np.uint8))
    out = auto_pipeline.main([
        "--video_path", str(BEAR_FRAMES), "--prompt", "a robot bear", "--config_path",
        "tiny_tvi2v", "--edited_frame", str(edited), "--save_path", str(tmp_path / "auto"),
        "--H", "64", "--W", "64", "--original_fps", "3", "--target_fps", "3",
        "--num_keyframes", "3", "--sample_steps", "2", "--fake_annotator", "--device", "cpu",
        "--save_type", "gif"])
    assert read_png(out["centerframe"]).shape == (64, 64, 3)
    assert out["edited_frame"] == edited
    names = sorted(x.name for x in out["tvi2v"].iterdir())
    assert names == ["bear_original_00.gif", "bear_original_original.gif", "log_info.json"]


# ---- the PNG codec -------------------------------------------------------

@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3), ("RGBA", 4)])
@pytest.mark.parametrize("options", [{}, {"optimize": True}, {"compress_level": 0}])
def test_png_reader_matches_pil(tmp_path, mode, channels, options):
    """8-bit gray, RGB and RGBA as PIL writes them (its filter choice per
    row: none, sub, up, average and Paeth all occur on a smooth image
    with noisy rows), from a path and from bytes."""
    rs = np.random.RandomState(channels)
    yy, xx = np.mgrid[0:45, 0:61]
    img = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, (xx + 2 * yy) % 256, xx * 4 % 256],
                   -1)[..., :channels].astype(np.uint8)
    img[::5] = rs.randint(0, 256, img[::5].shape)
    Image.fromarray(img[..., 0] if channels == 1 else img, mode).save(tmp_path / "a.png",
                                                                      **options)
    want = np.asarray(Image.open(tmp_path / "a.png")).reshape(img.shape)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), want)
    np.testing.assert_array_equal(read_png((tmp_path / "a.png").read_bytes()), want)


def test_png_writer_round_trips_and_the_reader_refuses_other_pngs(tmp_path):
    img = np.random.RandomState(13).randint(0, 256, (7, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png_bytes(img)))), img)
    Image.fromarray(np.zeros((4, 4), np.uint16), "I;16").save(tmp_path / "deep.png")
    with pytest.raises(ValueError, match="bit depth"):
        read_png(str(tmp_path / "deep.png"))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(b"GIF89a...")
