"""tapnet_torch stands alone: importing it pulls in no JAX, no flax, no
optax, nothing of tapnet_tpu and not the `msgpack` package (the port reads
the JAX package's msgpack checkpoints with its own decoder), and neither
matplotlib (imported inside the render functions only) nor tensorflow or
tensorboard (the events file is written by hand). Checked in a fresh
interpreter, since this test process has JAX loaded already
(tests/conftest.py)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import tapnet_torch
import tapnet_torch.infer, tapnet_torch.convert
import tapnet_torch.env.core, tapnet_torch.env.sampler
import tapnet_torch.models.tapnet, tapnet_torch.models.features
import tapnet_torch.ops.actor_step, tapnet_torch.ops.policy_step
import tapnet_torch.train.rollout
import tapnet_torch.ops.reward, tapnet_torch.ops.replay
import tapnet_torch.ops.env
import tapnet_torch.train.reinforce, tapnet_torch.train.metrics
import tapnet_torch.train.checkpoints, tapnet_torch.train.trainer
import tapnet_torch.profile_pack, tapnet_torch.profile_phases
import tapnet_torch.kernel_times, tapnet_torch.grad_witness
import tapnet_torch.cli
import tapnet_torch.utils.data, tapnet_torch.utils.debug
import tapnet_torch.utils.msgpack, tapnet_torch.utils.profiling
import tapnet_torch.benchmarks, tapnet_torch.oracle, tapnet_torch.native
import tapnet_torch.parallel, tapnet_torch.parallel.scaling
import tapnet_torch.utils.trace_events
import tapnet_torch.utils.viz, tapnet_torch.parallel.tp
import tapnet_torch.train.metrics, tapnet_torch.profile_anchor
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "tapnet_tpu", "msgpack", "matplotlib",
                                    "tensorflow", "tensorboard"))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports the port only: its module-level imports pull in
    no JAX either (it exits non-zero without a card before doing work)."""
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    for name in ("jax", "flax", "optax", "tapnet_tpu", "msgpack"):
        assert f"import {name}" not in src and f"from {name}" not in src
