"""The port stands alone: importing it, its engine, its CLIs (the train CLI
included), its data parallelism and native decode binding, its samplers, ZoeDepth, the LoRA merge, its training modules
(VAE training's too), ``unet_extras``, the kernel-7 sweep script, every
structure annotator, embedder and text tower and the native tokenizer
binding (which builds nothing at import), and ``chip_smoke.py``'s
imports pulls in
neither JAX/flax nor the file-IO libraries (cv2, PIL, imageio, yaml), which
the GPU machine may not have; the annotators also run without cv2
(``test_torch_port_annotators.py``)."""

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
import ccedit_tpu_torch.cli.train
import ccedit_tpu_torch.data.dataset
import ccedit_tpu_torch.data.native_decode
import ccedit_tpu_torch.data.video
import ccedit_tpu_torch.parallel.mesh
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


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
