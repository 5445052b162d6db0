"""The port's measurement machinery on the CPU: `tapnet_torch.benchmarks`,
`cli bench`, `utils.profiling.device_time_ms` and `utils.trace_events`.

Every function of `tapnet_tpu/benchmarks.py` exists in the port under its
name; every `measure_*` runs on the CPU at batch 8, iters 2, runs 2 and
returns the JAX functions' row keys (literals below, read from that file's
code; the JAX benchmarks are not run); no device anchor appears on the CPU.
The grouped heuristic-rollout call holds the same checksums through K4's
plain version and through the general path. The trace reader reads a real
CPU trace written by `utils.profiling.trace` and a synthetic one with
kernel events.
"""

import ast
import json
import os

import pytest
import torch

from tapnet_torch import benchmarks as BM
from tapnet_torch import cli
from tapnet_torch import random as R
from tapnet_torch.config import CONFIGS
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.utils import trace_events as TE
from tapnet_torch.utils.profiling import device_time_ms, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = CONFIGS["2d-basic"]
SMALL = dict(batch=8, iters=2, runs=2, device="cpu")
# tapnet_tpu/benchmarks.py: _stats, measure_pack_stats, bench.py's record
STATS_KEYS = {"value", "min", "max", "runs", "iters", "batch"}
PACK_KEYS = STATS_KEYS | {"policy", "plans_per_s"}
ANCHORS = {"device_ms_per_batch", "device_env_steps_per_s",
           "device_ms_per_rollout", "device_ms_per_step"}
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline",
                 "vs_native_1thread", "host_oracle_steps_per_s",
                 "host_native_1t_steps_per_s", "wall_env_steps_per_s",
                 "train_env_steps_per_s", "env_min", "env_max", "train_min",
                 "train_max", "runs"}


def test_every_jax_benchmark_function_is_ported():
    path = os.path.join(ROOT, "tapnet_tpu", "benchmarks.py")
    with open(path) as f:
        names = {n.name for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef)}
    # the JAX package's profiler guard; the port's is _anchor (it raises
    # on the card instead of warning)
    names.discard("_try_device_ms")
    assert names and not [n for n in names if not hasattr(BM, n)]


@pytest.mark.parametrize("policy", ["greedy", "sample", "best", "first"])
def test_measure_pack_stats(policy):
    out = BM.measure_pack_stats(CFG, hidden=32, policy=policy, **SMALL)
    assert set(out) == PACK_KEYS and not ANCHORS & set(out)
    assert out["policy"] == policy and out["value"] > 0
    assert (out["runs"], out["iters"], out["batch"]) == (2, 2, 8)


@pytest.mark.parametrize("fused", [None, True, False])
def test_measure_env_stats(fused):
    out = BM.measure_env_stats(CFG, fused=fused, **SMALL)
    assert set(out) == STATS_KEYS and out["value"] > 0
    assert not ANCHORS & set(out)
    assert BM.measure_env_steps_per_s(CFG, 8, 2, fused=fused,
                                      device="cpu") > 0


def test_measure_train_and_policy_rollout_stats():
    out = BM.measure_train_stats(CFG, hidden=32, **SMALL)
    assert set(out) == STATS_KEYS and out["value"] > 0
    assert not ANCHORS & set(out)
    assert BM.measure_train_steps_per_s(CFG, 8, 32, 2, device="cpu") > 0
    out = BM.measure_policy_rollout_stats(CFG, hidden=32, **SMALL)
    assert set(out) == STATS_KEYS and out["value"] > 0
    assert not ANCHORS & set(out)


def test_host_baselines():
    assert BM.measure_oracle_steps_per_s(CFG, n_instances=2) > 0
    assert BM.measure_native_steps_per_s(CFG, n_instances=8) > 0
    scaling = BM.measure_native_thread_scaling(CFG, 8, threads=(1, 2))
    assert set(scaling) == {"1", "2"} and min(scaling.values()) > 0


def test_grouped_env_call_checksums():
    """One call = `group` rollouts checksummed on the device; K4's plain
    version and the general path give the same sums, and so do the group's
    rollouts one by one."""
    from tapnet_torch.env import core as E

    dev = torch.device("cpu")
    inst = sample_batch(R.key(0), 8, CFG)
    keys = BM._key_groups(2, 3, 8, dev)
    assert keys.shape == (2, 3, 8, 2)
    assert torch.equal(keys[1, 2], R.split(R.key(1 + 1 * 3 + 2), 8))
    fused = BM._env_call(CFG, inst, 3, True, dev)(keys[1])
    general = BM._env_call(CFG, inst, 3, False, dev)(keys[1])
    acc_r = torch.zeros(())
    acc_a = torch.zeros((), dtype=torch.int64)
    for g in range(3):
        _, a, r = E.rollout_batch(inst, keys[1, g], CFG, "random")
        acc_r += r.sum()
        acc_a += a.sum()
    for got in (fused, general):
        assert torch.equal(got[0], acc_r) and torch.equal(got[1], acc_a)


def test_headline_record_on_the_cpu():
    """The record main() prints (bench.py's keys and the device it ran on),
    at a CPU size."""
    rec = json.loads(json.dumps(BM.headline(batch=8, env_iters=2,
                                            train_iters=1, runs=1,
                                            device="cpu")))
    assert set(rec) == HEADLINE_KEYS | {"device"}
    assert rec["device"] == "cpu" and rec["value"] > 0
    assert rec["vs_baseline"] > 0 and rec["vs_native_1thread"] is not None


def test_cli_bench(capsys):
    assert cli.main(["--device", "cpu", "bench", "--config", "2d-basic",
                     "--batch", "8", "--iters", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"env_steps_per_s", "batch"}
    assert out["batch"] == 8 and out["env_steps_per_s"] > 0


def test_device_time_ms_is_none_on_the_cpu():
    assert not torch.cuda.is_available()
    assert device_time_ms(lambda: torch.ones(4).sum()) is None


def test_trace_events_reads_a_cpu_trace(tmp_path):
    with trace(str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = TE.latest_trace(str(tmp_path))
    ops = TE.op_times(path)
    assert any("mm" in name for name in ops.get("cpu_op", {}))
    with pytest.raises(ValueError):   # a CPU trace has no device events
        TE.device_op_times(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        TE.latest_trace(str(tmp_path / "missing"))


def test_trace_events_sums_kernel_events(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k4", "ts": 0, "dur": 250.0},
        {"ph": "X", "cat": "kernel", "name": "k4", "ts": 300, "dur": 150.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 500,
         "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 900.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]
    path = tmp_path / "trace_1_2.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert TE.device_op_times(str(tmp_path)) == {"k4": 0.4,
                                                 "Memcpy HtoD": 0.1}
    assert TE.device_op_times(str(path)) == TE.device_op_times(
        str(tmp_path))
    assert TE.op_times(str(path))["cpu_op"] == {"aten::mm": 0.9}
