"""Rank functions of tests/test_torch_parallel.py and test_torch_tp.py,
run by `tapnet_torch.parallel.scaling.run_ranks` in spawned processes (a
spawned rank imports this module by name, so it imports torch and the port
only). Each returns CPU tensors, numbers and strings."""

import copy
import os

import torch
from torch.distributed.tensor import DTensor

from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.models.tapnet import TAPNetActor
from tapnet_torch.ops.reward import fused_reward
from tapnet_torch.parallel.distributed import broadcast_from_main
from tapnet_torch.parallel.mesh import replicate
from tapnet_torch.parallel.tp import data_model_mesh, shard_params_tp
from tapnet_torch.train import checkpoints as ckpt
from tapnet_torch.train.reinforce import (init_train_state, make_train_step,
                                          step_batch)
from tapnet_torch.train.rollout import rollout_batch_record
from tapnet_torch.train.trainer import TrainLoopConfig, train


def state_tensors(ts) -> dict:
    """Parameters, Adam moments and count, key and step of a TrainState."""
    out = {f"actor.{k}": v.detach().clone()
           for k, v in ts.actor.state_dict().items()}
    out.update({f"critic.{k}": v.detach().clone()
                for k, v in ts.critic.state_dict().items()})
    out.update(mu=ts.opt._mu.clone(), nu=ts.opt._nu.clone(),
               count=ts.opt._count.clone(), key=ts.key.clone(),
               step=torch.tensor(ts.step))
    return out


def integer_parts(ts, cfg, batch, mesh):
    """A step's integer parts on this rank's rows, by the step's own key
    schedule (`step_batch`) and the calls `_batch_losses` makes: the
    instances, the sampled actions and the five reward terms."""
    _, inst, act_keys = step_batch(ts.key, batch, cfg, mesh=mesh)
    states, record, _ = rollout_batch_record(ts.actor, inst, act_keys, cfg)
    terms = fused_reward(states.heightmap, states.placements, inst.dims,
                         cfg.reward_terms)[2]
    return {"instances": [x.clone() for x in inst],
            "actions": record.action.T.clone(),
            "terms": torch.stack(list(terms), 1)}


def train_steps(mesh, name: str, batch: int, hidden: int, n_steps: int):
    """n_steps sharded train steps from init_train_state(0) (rank 1's copy
    perturbed first, then broadcast from rank 0); returns the first step's
    integer parts, every step's metrics, the final state and what the
    broadcasts left on this rank."""
    cfg = CONFIGS[name]
    ts = init_train_state(0, cfg, hidden, device=mesh.device)
    if mesh.rank != 0:
        with torch.no_grad():
            for p in ts.parameters():
                p.add_(1.0)
        ts.step = 99
    ts = broadcast_from_main(ts, mesh.group)
    probe = replicate(torch.full((3,), float(mesh.rank)), mesh)
    ints = integer_parts(ts, cfg, batch, mesh)
    step = make_train_step(cfg, batch, hidden, mesh=mesh)
    metrics = []
    for _ in range(n_steps):
        ts, m = step(ts)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"ints": ints, "metrics": metrics, "state": state_tensors(ts),
            "probe": probe, "step": ts.step}


def trainer_run(mesh, workdir: str, epochs: int):
    """trainer.train() with a mesh: 2d-basic, 4 steps an epoch, global batch
    16, resuming from workdir/ckpt; returns the final step."""
    loop = TrainLoopConfig(epochs=epochs, steps_per_epoch=4, batch=16,
                           valid_batch=16, hidden=32, seed=0,
                           ckpt_dir=os.path.join(workdir, "ckpt"),
                           metrics_path=os.path.join(workdir,
                                                     "metrics.jsonl"))
    ts = train(CONFIGS["2d-basic"], loop, resume=True, mesh=mesh)
    return {"step": ts.step, "state": state_tensors(ts),
            "ckpt": ckpt.latest_checkpoint(loop.ckpt_dir)}


def tp_forward(mesh, cfg_kwargs, hidden, state_dict, tokens, shapes):
    """For each (n_data, n_model) of `shapes`: the actor's logits on
    `tokens` replicated and TP-sharded over a data_model_mesh of that shape,
    and the placements of its sharded parameters; then the errors that a
    mesh larger or smaller than the group raises."""
    actor = TAPNetActor(TAPConfig(**cfg_kwargs), hidden)
    actor.load_state_dict(state_dict)
    out = {}
    with torch.no_grad():
        ref = actor(*tokens)
        for n_data, n_model in shapes:
            dm = data_model_mesh(n_data, n_model, device="cpu")
            tp = shard_params_tp(copy.deepcopy(actor), dm)
            placements = {
                name: str(p.placements) for name, p in tp.named_parameters()
                if isinstance(p, DTensor)}
            out[n_data, n_model] = (tp(*tokens), placements,
                                    list(dm.get_coordinate()))
    errors = []
    for n_data, n_model in ((mesh.world_size, 2), (1, 1)):
        try:
            data_model_mesh(n_data, n_model, device="cpu")
        except (RuntimeError, ValueError) as e:
            errors.append(f"{type(e).__name__}: {e}")
    return ref, out, errors
