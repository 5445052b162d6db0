"""Actor-critic REINFORCE: one train step, the port of
`tapnet_tpu/train/reinforce.py`.

loss_actor = -mean((R - V).detach() * sum_t log pi), loss_critic =
mean((V - R)^2), a global-norm clip without epsilon (as optax's
`clip_by_global_norm`), then Adam. One step:

1. sample the instance batch on the device (`split(k_inst, batch)`);
2. roll the actor out without gradients, one `actor_select_step` kernel
   launch per decode step on the card, keeping its per-instance logp;
3. replay the record differentiably (`rollout.replay_logp_sum`): on the
   card the replay kernel's backward (the step-grid schedule for rolling
   configs and N > 31), with the rollout's logp as the value;
4. the C/P/S rewards through the `heightmap_reductions` kernel;
5. the critic on the reset state; the losses; clip; Adam.

The key schedule is the JAX package's: `key, k_inst, k_act = split(key, 3)`,
instances from `split(k_inst, batch)`, action keys `split(k_act, batch)`,
so a key samples the same instances and trajectories on both sides.
"""

from __future__ import annotations

import dataclasses

import torch

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.models.features import build_tokens
from tapnet_torch.models.tapnet import (TAPNetActor, TAPNetCritic,
                                        init_critic, init_params)
from tapnet_torch.ops.reward import batched_reward_terms
from tapnet_torch.train.rollout import replay_logp_sum, rollout_batch_record
from tapnet_torch.types import Instance


@dataclasses.dataclass
class TrainState:
    """Actor, critic, their Adam state, the step count and the threefry key
    (int64[2]) that drives instance and action sampling. A train step
    updates it in place."""

    actor: TAPNetActor
    critic: TAPNetCritic
    opt: torch.optim.Adam
    step: int
    key: torch.Tensor

    def parameters(self):
        return list(self.actor.parameters()) + list(self.critic.parameters())


def make_optimizer(params, lr: float = 5e-4) -> torch.optim.Adam:
    """Adam as optax.adam(lr): betas (0.9, 0.999), eps 1e-8 outside the
    square root. The clip is `clip_by_global_norm_`, applied first."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum((g * g).sum() for g in grads))


def clip_by_global_norm_(grads, clip: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g / norm * clip when norm >= clip
    (no epsilon, unlike torch.nn.utils.clip_grad_norm_). Returns the norm
    before clipping."""
    norm = global_norm(grads)
    for g in grads:
        g.copy_(torch.where(norm < clip, g, g / norm * clip))
    return norm


def train_state(actor: TAPNetActor, critic: TAPNetCritic, key: torch.Tensor,
                lr: float = 5e-4) -> TrainState:
    """A step-0 TrainState around given modules and key (e.g. weights
    converted from the JAX package with `convert.params_from_flax`)."""
    params = list(actor.parameters()) + list(critic.parameters())
    return TrainState(actor, critic, make_optimizer(params, lr), 0, key)


def init_train_state(seed: int, cfg: TAPConfig, hidden: int = 128,
                     lr: float = 5e-4, device="cuda") -> TrainState:
    """Seeded actor and critic (`init_params` / `init_critic`) and the key
    `split(key(seed))[1]`, as the JAX package keeps it. Runs on `cuda`
    unless `device="cpu"`."""
    device = resolve_device(device)
    kp_ks = R.split(R.key(seed, device))
    return train_state(init_params(seed, cfg, hidden, device),
                       init_critic(seed, cfg, hidden, device), kp_ks[1], lr)


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the train path runs on cuda by default and no "
                           "CUDA device is available; pass device='cpu' for "
                           "the reference path")
    return device


def _batch_losses(actor, critic, instances: Instance, keys, cfg: TAPConfig,
                  temperature: float):
    """(actor_loss, critic_loss, R [B], reward terms); the record and the
    rollout's logp carry no gradient."""
    states, record, logp0 = rollout_batch_record(
        actor, instances, keys, cfg, greedy=False, temperature=temperature,
        with_logp=True)
    logp = replay_logp_sum(actor, instances, record, cfg, temperature,
                           logp0=logp0)
    static, dynamic, hm = build_tokens(instances, E.reset(instances, cfg),
                                       cfg)
    V = critic(static, dynamic, hm)
    terms = batched_reward_terms(states.heightmap, states.placements,
                                 instances.dims)
    Rw = E.reward_from_terms(terms, cfg.reward_terms)
    adv = Rw - V.detach()
    actor_loss = -(adv * logp).mean()
    critic_loss = ((V - Rw) ** 2).mean()
    return actor_loss, critic_loss, Rw, terms


def make_train_step(cfg: TAPConfig, batch: int, hidden: int = 128,
                    lr: float = 5e-4, clip: float = 2.0,
                    temperature: float = 1.0, critic_weight: float = 1.0,
                    mesh=None, from_dataset: bool = False,
                    compute_dtype=None, mixed_p2d: float = 0.0,
                    steps_per_call: int = 1, device="cuda"):
    """The train step: TrainState -> (TrainState, metrics), updating the
    state in place. With from_dataset=True it is (TrainState, Instance
    batch) -> (TrainState, metrics). Metrics are 0-d tensors on the device:
    loss_actor, loss_critic, reward, C, P, S and grad_norm (before the
    clip). Runs on `cuda` unless `device="cpu"`."""
    if mesh is not None:
        raise NotImplementedError("data parallelism (parallel/) is not "
                                  "ported yet (ROADMAP.md, port Queue 1)")
    if mixed_p2d > 0:
        raise NotImplementedError("sample_batch_mixed is not ported yet "
                                  "(ROADMAP.md, port Queue 1)")
    if steps_per_call != 1:
        raise NotImplementedError("steps_per_call > 1 (CUDA graphs over "
                                  "several steps) is not ported yet "
                                  "(ROADMAP.md, port Queue 1)")
    if compute_dtype not in (None, torch.float32, "float32"):
        raise NotImplementedError("the port trains in float32 only "
                                  "(ROADMAP.md, port Queue 1)")
    device = resolve_device(device)

    def train_step(ts: TrainState, instances: Instance = None):
        if ts.key.device != device:
            raise ValueError(f"TrainState is on {ts.key.device}, the step "
                             f"on {device}")
        if ts.actor.hidden != hidden:
            raise ValueError(f"actor hidden {ts.actor.hidden} != {hidden}")
        ks = R.split(ts.key, 3)
        key, k_inst, k_act = ks[0], ks[1], ks[2]
        if instances is None:
            instances = sample_batch(k_inst, batch, cfg)
        act_keys = R.split(k_act, instances.dims.shape[0])
        params = ts.parameters()
        ts.opt.zero_grad(set_to_none=True)
        actor_loss, critic_loss, Rw, terms = _batch_losses(
            ts.actor, ts.critic, instances, act_keys, cfg, temperature)
        (actor_loss + critic_weight * critic_loss).backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        gnorm = clip_by_global_norm_([p.grad for p in params], clip)
        for g in ts.opt.param_groups:
            g["lr"] = lr
        ts.opt.step()
        ts.step += 1
        ts.key = key

        vol, denom_c, denom_p, s_num, s_den = terms
        f = lambda n, d: (n.float() / d.clamp(min=1).float()).mean()
        metrics = {
            "loss_actor": actor_loss.detach(),
            "loss_critic": critic_loss.detach(),
            "reward": Rw.mean(),
            "C": f(vol, denom_c),
            "P": f(vol, denom_p),
            "S": f(s_num, s_den),
            "grad_norm": gnorm,
        }
        return ts, metrics

    if from_dataset:
        return train_step
    return lambda ts: train_step(ts)
