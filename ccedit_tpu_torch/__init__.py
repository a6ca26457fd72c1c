"""ccedit-tpu-torch: the PyTorch/CUDA port of ccedit_tpu.

The JAX package ``ccedit_tpu`` stays the reference; this package mirrors its
module paths and class names (``ccedit_tpu_torch/modules/unet.py::UNetModel``
is the counterpart of ``ccedit_tpu/modules/unet.py::UNetModel``) and runs the
TV2V and the reference-guided TVI2V clip edits on one NVIDIA H100.  Plain
tensor code is PyTorch; the attention kernels the JAX package ran in Pallas
on these paths are CUDA C++ written for ``sm_90a`` (``csrc/``), built with
nvcc at first use.

Public layouts follow the JAX package: video (B, T, H, W, C), attention
(B, Heads, N, D).  Parameter names follow the reference sgm/LDM state-dict
keys, so a reference checkpoint loads with a strict ``load_state_dict``.
"""

__version__ = "0.1.0"
