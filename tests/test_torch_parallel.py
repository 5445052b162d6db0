"""Data parallelism over torch.distributed (`tapnet_torch.parallel`, the
sharded `make_train_step(mesh=...)`, `train(mesh=...)`, `cli train --mesh`)
on CPU gloo ranks.

- `initialize_distributed` is a no-op without configuration, reads
  torchrun's environment and obeys explicit arguments over it (the JAX
  package's tests/test_distributed.py checks the same of its version).
- A world-1 mesh step is bit-equal to the unsharded step over 2 steps
  (params, Adam state, key, metrics), with exactly one gradient all-reduce
  and one metrics all-reduce a step and no other collective.
- Two gloo ranks (spawned, 60 s timeout) against a world of one on the
  same global batch (2d-basic, batch 8, hidden 32): the integer parts of a
  step (instances, sampled actions, reward terms) bit-equal; the two ranks'
  states bit-identical; against the world of one the tier-2 tolerances of
  tests/test_torch_train.py: loss_critic rtol 1e-5, loss_actor and
  grad_norm rtol 1e-4, reward/C/P/S rtol 1e-5 (means of equal values in
  another order), every parameter and Adam moment within 5e-5 of its
  leaf's max magnitude after 2 steps.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_mesh_worker as W
from tapnet_torch.config import CONFIGS
from tapnet_torch.parallel import distributed as D
from tapnet_torch.parallel import mesh as M
from tapnet_torch.parallel.scaling import run_ranks, scaling_report
from tapnet_torch.train.reinforce import init_train_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK")
NAME, B, HIDDEN = "2d-basic", 8, 32


@pytest.fixture
def mesh1():
    """A world-1 gloo group in this process, torn down after the test."""
    assert not dist.is_initialized()
    mesh = M.cpu_mesh(1)
    yield mesh
    dist.destroy_process_group()


@pytest.fixture
def fake_init(monkeypatch):
    calls = {}

    def init_process_group(backend, init_method=None, world_size=-1,
                           rank=-1, timeout=None):
        calls["args"] = (backend, init_method, world_size, rank)

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for var in TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    return calls


def test_initialize_distributed_noop_without_config(fake_init):
    assert D.initialize_distributed() is False
    assert "args" not in fake_init


def test_initialize_distributed_from_torchrun_env(fake_init, monkeypatch):
    for var, v in zip(TORCHRUN_ENV, ("10.0.0.1", "1234", "4", "2", "0")):
        monkeypatch.setenv(var, v)
    assert D.initialize_distributed(backend="gloo") is True
    assert fake_init["args"] == ("gloo", "tcp://10.0.0.1:1234", 4, 2)


def test_initialize_distributed_explicit_override(fake_init, monkeypatch):
    for var, v in zip(TORCHRUN_ENV, ("10.0.0.1", "1234", "4", "2", "0")):
        monkeypatch.setenv(var, v)
    assert D.initialize_distributed("10.0.0.9:99", 2, 1,
                                    backend="gloo") is True
    assert fake_init["args"] == ("gloo", "tcp://10.0.0.9:99", 2, 1)
    for var in TORCHRUN_ENV:
        monkeypatch.delenv(var)
    with pytest.raises(ValueError):   # a coordinator without a world size
        D.initialize_distributed("10.0.0.9:99")


def test_shard_leading_axis_takes_the_ranks_rows():
    mesh = M.DataMesh(None, 2, 1, torch.device("cpu"))
    x = torch.arange(12).reshape(6, 2)
    tree = {"a": x, "b": (x[:, 0], np.arange(6))}
    out = M.shard_leading_axis(tree, mesh)
    assert torch.equal(out["a"], x[3:])
    assert torch.equal(out["b"][0], x[3:, 0])
    assert torch.equal(out["b"][1], torch.arange(3, 6))
    assert torch.equal(D.make_global(x, mesh, "data"), x[3:])
    assert torch.equal(D.make_global(x, mesh), x)
    assert D.local_value(x) is x
    with pytest.raises(ValueError):
        M.shard_leading_axis(torch.zeros(5), mesh)
    with pytest.raises(ValueError):
        make_train_step(CONFIGS[NAME], 7, HIDDEN, mesh=mesh)


@pytest.fixture
def two_cards(monkeypatch):
    """Rank 1 of a torchrun world of two on a host with two cards, faked on
    the CPU: the group joins on a call to init_process_group, set_device
    moves the current card. Returns the fake's state."""
    state = {"init": False, "card": 0}

    def init_process_group(backend, init_method=None, world_size=-1,
                           rank=-1, timeout=None):
        state.update(init=True, backend=backend)

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(dist, "is_initialized", lambda: state["init"])
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_backend",
                        lambda group=None: state["backend"])
    monkeypatch.setattr(dist, "destroy_process_group", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["card"])
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: state.update(
        card=torch.device("cuda", d).index if isinstance(d, int)
        else torch.device(d).index))
    for var, v in zip(TORCHRUN_ENV, ("127.0.0.1", "1234", "2", "1", "1")):
        monkeypatch.setenv(var, v)
    return state


def test_data_mesh_takes_the_local_card(two_cards):
    """In a group of two, rank 1 (LOCAL_RANK 1) computes on cuda:1: "cuda"
    names it, and another card raises instead of putting two ranks on
    one."""
    assert D.initialize_distributed(backend="nccl") is True
    assert two_cards["card"] == 1
    assert M.data_mesh("cuda").device == torch.device("cuda", 1)
    assert M.data_mesh("cuda:1").device == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="cuda:1"):
        M.data_mesh("cuda:0")


def test_cli_train_mesh_puts_the_rank_on_its_card(two_cards, monkeypatch):
    """`torchrun --nproc_per_node=2 -m tapnet_torch.cli train --mesh`: rank
    1 joins the group before it resolves "cuda", so both the train device
    and the mesh's are cuda:1."""
    from tapnet_torch import cli
    from tapnet_torch.train import trainer

    got = {}
    monkeypatch.setattr(trainer, "train", lambda cfg, loop, resume, device,
                        mesh: got.update(device=device, mesh=mesh))
    assert cli.main(["train", "--mesh", "--config", NAME, "--epochs", "1",
                     "--batch", "8"]) == 0
    assert two_cards["backend"] == "nccl"
    assert got["device"] == torch.device("cuda", 1)
    assert got["mesh"].device == torch.device("cuda", 1)
    assert (got["mesh"].world_size, got["mesh"].rank) == (2, 1)


@pytest.mark.parametrize("name,p2d,k", [("2d-basic", 0.0, 1),
                                        ("multi-container", 0.5, 2)])
def test_world1_mesh_step_is_the_unsharded_step(mesh1, name, p2d, k):
    cfg = CONFIGS[name]
    runs = []
    for mesh in (None, mesh1):
        ts = init_train_state(0, cfg, HIDDEN, device="cpu")
        step = make_train_step(cfg, B, HIDDEN, mesh=mesh, mixed_p2d=p2d,
                               steps_per_call=k, device="cpu")
        ms = []
        for _ in range(2):
            ts, m = step(ts)
            ms.append(m)
        runs.append((W.state_tensors(ts), ms))
    (s0, m0), (s1, m1) = runs
    assert s0.keys() == s1.keys()
    for k_ in s0:
        assert torch.equal(s0[k_], s1[k_]), k_
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        for k_ in a:
            assert torch.equal(a[k_], b[k_]), k_


def test_mesh_step_collectives(mesh1, monkeypatch):
    """One all-reduce of the flat gradient buffer and one of the metrics a
    step, and no other collective (the JAX package's sharded step shows its
    gradient psum as an all-reduce, tests/test_aux.py)."""
    cfg = CONFIGS[NAME]
    ts = init_train_state(0, cfg, HIDDEN, device="cpu")
    step = make_train_step(cfg, B, HIDDEN, mesh=mesh1)
    calls = []
    real = dist.all_reduce

    def all_reduce(t, *a, **kw):
        calls.append(t.numel())
        return real(t, *a, **kw)

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    for other in ("broadcast", "all_gather", "reduce_scatter",
                  "all_gather_into_tensor", "reduce_scatter_tensor"):
        monkeypatch.setattr(dist, other, lambda *a, _n=other, **k:
                            pytest.fail(f"the step called {_n}"))
    ts, _ = step(ts)
    n_params = sum(p.numel() for p in ts.parameters())
    assert calls == [n_params, 6]


def test_two_ranks_match_one(mesh1):
    """World 2 (two spawned gloo ranks) against world 1, same global
    batch; see the module docstring for the tolerances."""
    ref = W.train_steps(mesh1, NAME, B, HIDDEN, 2)
    ranks = run_ranks(W.train_steps, 2, (NAME, B, HIDDEN, 2), device="cpu",
                      timeout_s=60)
    for part in ("actions", "terms"):
        got = torch.cat([r["ints"][part] for r in ranks])
        assert torch.equal(got, ref["ints"][part]), part
    for i, want in enumerate(ref["ints"]["instances"]):
        got = torch.cat([r["ints"]["instances"][i] for r in ranks])
        assert torch.equal(got, want)
    r0, r1 = ranks
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    assert r0["metrics"] == r1["metrics"]
    assert r0["step"] == r1["step"] == 2
    assert torch.equal(r1["probe"], torch.zeros(3))
    for got, want in zip(r0["metrics"], ref["metrics"]):
        rtol = {"loss_actor": 1e-4, "grad_norm": 1e-4}
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=rtol.get(k, 1e-5),
                                       err_msg=k)
    for k, want in ref["state"].items():
        got = r0["state"][k]
        if want.dtype.is_floating_point:
            scale = float(want.abs().max()) + 1e-9
            np.testing.assert_allclose(got.numpy() / scale,
                                       want.numpy() / scale, atol=5e-5,
                                       err_msg=k)
        else:
            assert torch.equal(got, want), k


def test_scaling_report_over_gloo_ranks():
    rows = scaling_report(CONFIGS[NAME], (1, 2), per_device_batch=4,
                          hidden=HIDDEN, iters=1, device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["batch"] for r in rows] == [4, 8]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["train_steps_per_s"] > 0 and r["efficiency"] > 0
               for r in rows)


def test_cli_train_mesh_single_process(tmp_path):
    """`cli train --mesh` without torchrun: a world of one (gloo)."""
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m", "tapnet_torch.cli", "--device", "cpu",
         "train", "--mesh", "--config", NAME, "--epochs", "1",
         "--steps-per-epoch", "2", "--batch", "8", "--valid-batch", "8",
         "--hidden", str(HIDDEN), "--ckpt-dir", str(tmp_path / "ckpt")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"step": 2' in out.stdout
    assert (tmp_path / "ckpt" / "ckpt_00000002.pt").exists()


@pytest.mark.slow
def test_two_rank_trainer_with_resume(tmp_path):
    """train(mesh=...) over two gloo ranks with a restart: generation 1
    trains one epoch and exits, generation 2 resumes (rank 0 reads the
    checkpoint, the broadcast carries it) and trains to step 8. Rank 0
    alone writes the metrics and checkpoints; the final state equals an
    uninterrupted run in one process within the tolerances above."""
    from tapnet_torch.train.trainer import TrainLoopConfig, train

    work = str(tmp_path / "dist")
    g1 = run_ranks(W.trainer_run, 2, (work, 1), device="cpu", timeout_s=300)
    assert [r["step"] for r in g1] == [4, 4]
    lines1 = open(os.path.join(work, "metrics.jsonl")).read().splitlines()
    g2 = run_ranks(W.trainer_run, 2, (work, 2), device="cpu", timeout_s=300)
    assert [r["step"] for r in g2] == [8, 8]
    lines2 = open(os.path.join(work, "metrics.jsonl")).read().splitlines()
    assert len(lines1) == 1 and len(lines2) == 3
    assert '"event": "resumed"' in lines2[1]
    assert g2[0]["ckpt"].endswith("ckpt_00000008.pt")
    for k in g2[0]["state"]:
        assert torch.equal(g2[0]["state"][k], g2[1]["state"][k]), k
    loop = TrainLoopConfig(epochs=2, steps_per_epoch=4, batch=16,
                           valid_batch=16, hidden=32, seed=0)
    ref = W.state_tensors(train(CONFIGS[NAME], loop, resume=False,
                                device="cpu"))
    for k, want in ref.items():
        got = g2[0]["state"][k]
        if want.dtype.is_floating_point:
            scale = float(want.abs().max()) + 1e-9
            np.testing.assert_allclose(got.numpy() / scale,
                                       want.numpy() / scale, atol=5e-5,
                                       err_msg=k)
        else:
            assert torch.equal(got, want), k
