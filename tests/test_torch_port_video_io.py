"""The port's host IO for training: the validation-sampling writers
against the JAX package's (``to_uint8`` and the panel of
``save_panel_grid``, bit for bit; the port writes its PNG and, where
imageio is missing, its GIF with numpy and zlib alone, since the GPU
machine has neither cv2 nor PIL nor imageio), and the native threaded
decode (``data/native_decode.py``) against the cv2 path on the bundled
bear clip: the same frames at the file's own size, through
``load_video_keyframes`` and the training dataset.  The native tests skip
when the library does not load (it links OpenCV), as ``tests/test_data.py``
does."""

from pathlib import Path

import numpy as np
import pytest

from ccedit_tpu.data import video as jvideo
from ccedit_tpu_torch.data import dataset, native_decode
from ccedit_tpu_torch.data import video as tvideo

ROOT = Path(__file__).resolve().parents[1]
BEAR = str(ROOT / "docs" / "artifacts" / "bear_smoke" / "bear_original.mp4")


def _read(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def test_to_uint8_matches_jax_bit_for_bit():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-1.3, 1.3, 997), [-1.0, 1.0, 0.0, -0.996, 0.996]]
                       ).astype(np.float32).reshape(2, 3, -1)
    np.testing.assert_array_equal(tvideo.to_uint8(x), jvideo.to_uint8(x))
    u8 = rs.randint(0, 256, (4, 5), dtype=np.uint8)
    assert tvideo.to_uint8(u8) is u8 and jvideo.to_uint8(u8) is u8


def test_save_panel_grid_matches_jax_bit_for_bit(tmp_path):
    """Rows of different lengths and sizes (cropped to the smallest, at
    most 8 frames), floats in [-1, 1] and a uint8 row."""
    rs = np.random.RandomState(1)
    rows = [rs.uniform(-1, 1, (10, 24, 32, 3)).astype(np.float32),
            rs.uniform(-1, 1, (9, 20, 36, 3)).astype(np.float32),
            rs.randint(0, 256, (12, 24, 30, 3)).astype(np.uint8)]
    ours, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    tvideo.save_panel_grid(rows, str(ours))
    jvideo.save_panel_grid(rows, str(theirs))
    got, want = _read(ours), _read(theirs)
    assert got.shape == (3 * 20, 8 * 30, 3)
    np.testing.assert_array_equal(got, want)


def test_gif_writer_round_trips_its_palette(tmp_path):
    """``write_gif`` (the gif path without imageio): every frame decodes,
    with PIL and with imageio, to the 3-3-2 bit palette's colours of its
    pixels; frames wider than one LZW clear period and odd sizes."""
    import imageio.v3 as iio

    rs = np.random.RandomState(2)
    frames = rs.randint(0, 256, (3, 37, 53, 3)).astype(np.uint8)
    path = tmp_path / "clip.gif"
    tvideo.write_gif(str(path), frames, fps=4)
    want = tvideo.gif_palette()[tvideo.gif_palette_index(frames)]
    got = iio.imread(path, index=None)[..., :3]
    np.testing.assert_array_equal(got, want)
    from PIL import Image

    with Image.open(path) as im:
        assert im.n_frames == 3 and im.info["duration"] == 250 and im.info["loop"] == 0
    # the quantisation error is at most a palette step
    assert int(np.abs(want.astype(int) - frames).max()) <= 85


def test_save_video_frames_without_imageio_writes_the_gif(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_imageio(name, *a, **kw):
        if name == "imageio":
            raise ImportError("no imageio")
        return real_import(name, *a, **kw)

    frames = np.random.RandomState(3).randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    monkeypatch.setattr(builtins, "__import__", no_imageio)
    tvideo.save_video_frames(frames, str(tmp_path / "a.gif"), fps=4)
    monkeypatch.undo()
    tvideo.write_gif(str(tmp_path / "b.gif"), frames, fps=4)
    assert (tmp_path / "a.gif").read_bytes() == (tmp_path / "b.gif").read_bytes()


@pytest.fixture
def native():
    if not native_decode.available():
        pytest.skip("native decode library not built (native/build.sh, needs OpenCV)")


def test_native_decode_equals_the_cv2_path(native):
    n, fps, h, w = tvideo.probe_video(BEAR)
    assert n > 0 and h > 0 and w > 0
    frames, _ = tvideo._read_frames(BEAR)
    idx = np.arange(0, n, 2)
    np.testing.assert_array_equal(native_decode.decode_clip_u8(BEAR, idx, h, w),
                                  np.stack([frames[i] for i in idx]))
    as_float = native_decode.decode_clip(BEAR, idx, h, w)
    np.testing.assert_allclose(as_float, np.stack([frames[i] for i in idx]) / 127.5 - 1.0,
                               rtol=0, atol=1e-6)
    with native_decode.DecodePool(n_threads=2) as pool:
        jobs = [pool.submit_clip(BEAR, idx, h, w) for _ in range(3)]
        for job in jobs:
            np.testing.assert_array_equal(pool.wait(job), as_float)


def test_keyframe_loader_and_dataset_take_the_native_decode(native, monkeypatch, capsys):
    """At the file's own size ``load_video_keyframes`` returns the same
    frames whichever decoder runs; the training dataset returns the same
    items (its resize follows the decode), and its loader says which
    decoder it uses."""
    n, fps, h, w = tvideo.probe_video(BEAR)
    calls = []
    decode = native_decode.decode_clip_u8
    monkeypatch.setattr(native_decode, "decode_clip_u8",
                        lambda *a: calls.append(a) or decode(*a))
    with_native = tvideo.load_video_keyframes(BEAR, None, 1.5, 3, (h, w))
    ds_native = dataset.TextVideoDataset([(BEAR, "a bear")], num_frames=3, size_hw=(64, 96))
    item = ds_native[0]
    assert len(calls) == 2 and ds_native.decoder == "native"
    dataset.DataLoader(ds_native, batch_size=1)
    assert "native threaded decode" in capsys.readouterr().out
    monkeypatch.setattr(native_decode, "available", lambda: False)
    without = tvideo.load_video_keyframes(BEAR, None, 1.5, 3, (h, w))
    ds_cv2 = dataset.TextVideoDataset([(BEAR, "a bear")], num_frames=3, size_hw=(64, 96))
    assert ds_cv2.decoder == "cv2" and len(calls) == 2
    np.testing.assert_array_equal(with_native, without)
    np.testing.assert_array_equal(item["jpg"], ds_cv2[0]["jpg"])
