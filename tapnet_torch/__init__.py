"""tapnet_torch — the PyTorch/CUDA port of tapnet_tpu for NVIDIA Hopper.

A second package beside the JAX reference: the same configs, sampler, env,
actor and serving surface, in PyTorch, with the decode-step kernels written
by hand in CUDA C++ for sm_90a (`csrc/`, built by nvcc at first use). It
imports nothing of JAX or of `tapnet_tpu`.
"""

from tapnet_torch.config import CONFIGS, TAPConfig  # noqa: F401
from tapnet_torch.infer import PackingPlan, PackingStep, pack  # noqa: F401

__version__ = "0.1.0"
