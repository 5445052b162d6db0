"""tapnet_torch — the PyTorch/CUDA port of tapnet_tpu for NVIDIA Hopper.

A second package beside the JAX reference: the same configs, sampler, env,
actor and critic, serving surface and REINFORCE trainer, in PyTorch, with
the kernels written by hand in CUDA C++ for sm_90a (`csrc/`, built by nvcc
at first use). It imports nothing of JAX or of `tapnet_tpu`.
"""

from tapnet_torch.config import CONFIGS, TAPConfig  # noqa: F401
from tapnet_torch.infer import PackingPlan, PackingStep, pack  # noqa: F401
from tapnet_torch.train.reinforce import (init_train_state,  # noqa: F401
                                          make_train_step)
from tapnet_torch.train.trainer import TrainLoopConfig, train  # noqa: F401

__version__ = "0.1.0"
