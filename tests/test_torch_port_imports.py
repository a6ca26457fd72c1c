"""The port stands alone: importing it, its engine, its CLIs (the train CLI
included), its data parallelism, single-clip sharding and native decode
binding, its samplers, ZoeDepth, the LoRA merge, its training modules
(VAE training's too), ``unet_extras``, the kernel-7 sweep script, the
collective and ZeRO measurement scripts, every
structure annotator, embedder and text tower and the native tokenizer
binding (which builds nothing at import), the image CLIs, InceptionV3,
FID, the safety filter, the watermark, the toy and tar-shard datasets, and
``chip_smoke.py``'s imports pulls in
neither JAX/flax nor the file-IO libraries (cv2, PIL, imageio, yaml), which
the GPU machine may not have; the annotators also run without cv2
(``test_torch_port_annotators.py``).  With those libraries blocked outright
the image slice's modules import and their host IO runs: the PNG reader and
writer, the frame-directory keyframe loader, a built-in config by name, the
toy set, the flat YAML, the multipart parser and the watermark; and the
single-clip sharding modules import, pick an axis and cut a conditioning
dict."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CODE = """
import sys
sys.path.insert(0, {root!r})
import ccedit_tpu_torch
import ccedit_tpu_torch.models.engine
import ccedit_tpu_torch.config
import ccedit_tpu_torch.cli.pipeline
import ccedit_tpu_torch.cli.sampling_tv2v
import ccedit_tpu_torch.cli.sampling_tv2v_ref
import ccedit_tpu_torch.cli.profile_tv2v
import ccedit_tpu_torch.ops.quant
import ccedit_tpu_torch.scripts.int8_quality
import ccedit_tpu_torch.cli.train
import ccedit_tpu_torch.data.dataset
import ccedit_tpu_torch.data.native_decode
import ccedit_tpu_torch.data.video
import ccedit_tpu_torch.parallel.mesh
import ccedit_tpu_torch.parallel.sampling
import ccedit_tpu_torch.parallel.shard
import ccedit_tpu_torch.parallel.zero
import ccedit_tpu_torch.diffusion.loss
import ccedit_tpu_torch.diffusion.sigma_sampling
import ccedit_tpu_torch.diffusion.weighting
import ccedit_tpu_torch.train.ema
import ccedit_tpu_torch.train.freeze
import ccedit_tpu_torch.train.lr_schedule
import ccedit_tpu_torch.train.trainer
import ccedit_tpu_torch.conditioning.annotators.dpt_midas
import ccedit_tpu_torch.conditioning.annotators.zoedepth
import ccedit_tpu_torch.conditioning.annotators.base
import ccedit_tpu_torch.conditioning.annotators.hed
import ccedit_tpu_torch.conditioning.annotators.imgproc
import ccedit_tpu_torch.conditioning.annotators.lineart
import ccedit_tpu_torch.conditioning.annotators.lineart_model
import ccedit_tpu_torch.conditioning.annotators.normalbae
import ccedit_tpu_torch.conditioning.annotators.openpose
import ccedit_tpu_torch.conditioning.annotators.pidinet
import ccedit_tpu_torch.conditioning.annotators.random_weights
import ccedit_tpu_torch.conditioning.annotators.scribble
import ccedit_tpu_torch.conditioning.embedders
import ccedit_tpu_torch.conditioning.native_tokenizer
import ccedit_tpu_torch.modules.openclip
import ccedit_tpu_torch.modules.t5
import ccedit_tpu_torch.diffusion.denoiser
import ccedit_tpu_torch.diffusion.discretization
import ccedit_tpu_torch.diffusion.samplers
import ccedit_tpu_torch.diffusion.scaling
import ccedit_tpu_torch.io.checkpoint
import ccedit_tpu_torch.io.jax_params
import ccedit_tpu_torch.io.lora
import ccedit_tpu_torch.models.autoencoder_engine
import ccedit_tpu_torch.modules.discriminator
import ccedit_tpu_torch.modules.lpips
import ccedit_tpu_torch.modules.unet_extras
import ccedit_tpu_torch.ops.attention
import ccedit_tpu_torch.ops.build
import ccedit_tpu_torch.ops.flash_attention
import ccedit_tpu_torch.scripts.profile_blocks
import ccedit_tpu_torch.scripts.clip_collectives
import ccedit_tpu_torch.scripts.zero_state
import ccedit_tpu_torch.assets
import ccedit_tpu_torch.cli.auto_pipeline
import ccedit_tpu_torch.cli.demo
import ccedit_tpu_torch.cli.detect_watermark
import ccedit_tpu_torch.cli.extract_centerframe
import ccedit_tpu_torch.cli.pnp_generate_config
import ccedit_tpu_torch.cli.sampling_image
import ccedit_tpu_torch.data.toy
import ccedit_tpu_torch.data.webdataset
import ccedit_tpu_torch.modules.inception
import ccedit_tpu_torch.utils.fid
import ccedit_tpu_torch.utils.safety
import ccedit_tpu_torch.utils.watermark
import chip_smoke
chip_smoke.reset_launches()
assert ccedit_tpu_torch.conditioning.native_tokenizer._LIB is None  # built at first use only
print(sorted(m for m in ("jax", "flax", "ccedit_tpu", "cv2", "PIL", "imageio", "yaml")
             if m in sys.modules))
"""


def test_port_imports_no_jax_and_no_io_libraries():
    out = subprocess.run([sys.executable, "-c", CODE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


BLOCKED = """
import sys
sys.path.insert(0, {root!r})
BLOCK = ("jax", "flax", "ccedit_tpu", "cv2", "PIL", "imageio", "yaml")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"{{name}} is blocked")
        return None


sys.meta_path.insert(0, Blocker())
import numpy as np
import ccedit_tpu_torch.assets as assets
import ccedit_tpu_torch.cli.auto_pipeline
import ccedit_tpu_torch.cli.demo as demo
import ccedit_tpu_torch.cli.detect_watermark as dw
import ccedit_tpu_torch.cli.extract_centerframe
import ccedit_tpu_torch.cli.pnp_generate_config as pnp
import ccedit_tpu_torch.cli.sampling_image
import ccedit_tpu_torch.config as config
import ccedit_tpu_torch.data.toy as toy
import ccedit_tpu_torch.data.video as video
import ccedit_tpu_torch.data.webdataset
import ccedit_tpu_torch.modules.inception
import ccedit_tpu_torch.utils.fid
import ccedit_tpu_torch.utils.safety
import ccedit_tpu_torch.utils.watermark as wm
import ccedit_tpu_torch.parallel.sampling as clip_sampling
import ccedit_tpu_torch.parallel.shard as shard
import torch
assert clip_sampling.pick_clip_axis(4, (1, 17, 64, 96, 4)) == 2
assert clip_sampling.pick_clip_axis(4, (1, 16, 64, 96, 4)) == 1
cut = clip_sampling.shard_clip_cond({{"concat": torch.zeros(1, 17, 64, 96, 4),
                                     "crossattn": torch.zeros(1, 77, 8)}},
                                    (1, 17, 64, 96, 4), 2, 1, 4)
assert cut["concat"].shape == (1, 17, 16, 96, 4) and cut["crossattn"].shape == (1, 77, 8)
assert shard.ClipShard(2, 17, size=(64, 96)).world == 1 and shard.active() is None
# what the GPU machine runs of them needs none of the blocked modules
frames = video.load_video_keyframes(str(assets.BEAR_FRAMES), 3, 3, 4, (64, 96))
assert frames.shape == (4, 64, 96, 3)
png = video.png_bytes(frames[0])
assert (video.read_png(png) == frames[0]).all()
assert config.load_config("sd21_768")["model"]["params"]["network_config"]["params"][
    "num_head_channels"] == 64
assert toy.MNISTDataset(n_synthetic=4)[0]["jpg"].shape == (28, 28, 1)
assert pnp.flat_yaml({{"a": "1.5", "b": 2}}) == 'a: "1.5"\\nb: 2\\n'
assert demo.parse_multipart(b"--x\\r\\nContent-Disposition: form-data; name=\\"p\\"\\r\\n\\r\\nv\\r\\n--x--\\r\\n",
                            "multipart/form-data; boundary=x") == ({{"p": "v"}}, {{}})
marked = wm.WatermarkEmbedder()(frames[:1].astype(np.float32) / 255.0)
assert wm.decode_lsb(marked) == wm.WATERMARK_BITS
print("ok")
"""


def test_new_modules_import_and_run_with_jax_and_io_libraries_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCKED.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
