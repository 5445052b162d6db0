"""Actor-critic REINFORCE: the train step, the port of
`tapnet_tpu/train/reinforce.py`.

loss_actor = -mean((R - V).detach() * sum_t log pi), loss_critic =
mean((V - R)^2), a global-norm clip without epsilon (as optax's
`clip_by_global_norm`), then Adam. One step:

1. sample the instance batch on the device (`split(k_inst, batch)`; with
   `mixed_p2d` > 0 a mixed 2D/3D batch, `sample_batch_mixed`);
2. roll the actor out without gradients, one `actor_select_step` kernel
   launch per decode step on the card, keeping its per-instance logp;
3. replay the record differentiably (`rollout.replay_logp_sum`): on the
   card the replay kernel's backward (the step-grid schedule for rolling
   configs and N > 31), with the rollout's logp as the value;
4. the C/P/S reward terms and the reward in one `reward_kernel` launch
   (`ops.reward.fused_reward`);
5. the critic on the reset state; the losses; clip; Adam (`Adam`: optax's
   arithmetic on flat float32 moments, the same on the CPU and the card).

`compute_dtype=torch.bfloat16` is the JAX package's bf16 step: actor and
critic compute in bfloat16 (flax `dtype`), the parameters, the gradients,
Adam's state and the clip stay float32, the logits and the losses are
float32; on the card the rollout and the replay launch the bfloat16
instantiations of the actor-step and replay kernels. Every cast of a
parameter to bfloat16 happens inside the step, so a CUDA graph of it
reads the weights Adam updated. The default is float32 on both devices.

The key schedule is the JAX package's: `key, k_inst, k_act = split(key, 3)`,
instances from `split(k_inst, batch)`, action keys `split(k_act, batch)`,
so a key samples the same instances and trajectories on both sides.

`steps_per_call = k > 1` runs k steps per call on the same key stream as k
calls at k = 1 and returns the last step's metrics, as the JAX package's
`lax.scan` of steps does. On the CPU that is k eager steps; on the card one
step captured as a CUDA graph (`GraphedSteps`) and replayed k times.

With a `mesh` (`parallel.mesh.DataMesh`) the step computes the same
function of the global batch as without: the keys follow the global
schedule and each rank samples and rolls out only its rows of it; after
`backward()` one all-reduce of the flat gradient buffer, divided by the
world size (the single gradient psum XLA inserts in the JAX package), then
the same clip and Adam on every rank, so the ranks' parameters stay
bit-identical; one more all-reduce makes the metrics global means.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import check_mixed, mix_flat, sample_instance
from tapnet_torch.models.features import build_tokens
from tapnet_torch.models.tapnet import (TAPNetActor, TAPNetCritic,
                                        init_critic, init_params)
from tapnet_torch.ops.reward import fused_reward
from tapnet_torch.train.rollout import replay_logp_sum, rollout_batch_record
from tapnet_torch.types import Instance


class Adam(torch.optim.Optimizer):
    """optax.adam(lr, b1, b2, eps) over one parameter group:

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
        p -= lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

    The moments of all parameters live in two flat float32 buffers and the
    count in one float32 0-d tensor, all on the parameters' device and
    updated in place (about 20 launches a step, whatever the number of
    parameters), and no step reads a host value, so a step can be captured
    in a CUDA graph. The same arithmetic runs on the CPU and on the card.
    `state[p]` holds views of the buffers under torch.optim.Adam's keys
    (step, exp_avg, exp_avg_sq), so state dicts keep that layout."""

    def __init__(self, params, lr: float = 5e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        if len(self.param_groups) != 1:
            raise ValueError("Adam takes one parameter group")
        ps = self.param_groups[0]["params"]
        n = sum(p.numel() for p in ps)
        self._mu = torch.zeros(n, dtype=torch.float32, device=ps[0].device)
        self._nu = torch.zeros_like(self._mu)
        self._count = torch.zeros((), dtype=torch.float32,
                                  device=ps[0].device)
        self._bind()

    def _bind(self):
        off = 0
        for p in self.param_groups[0]["params"]:
            n = p.numel()
            self.state[p] = {"step": self._count,
                             "exp_avg": self._mu[off:off + n].view_as(p),
                             "exp_avg_sq": self._nu[off:off + n].view_as(p)}
            off += n

    def __getstate__(self):
        return {**super().__getstate__(), "_mu": self._mu, "_nu": self._nu,
                "_count": self._count}

    def load_state_dict(self, state_dict):
        """Copy a state dict (this class's or torch.optim.Adam's) into the
        buffers, which keep their identity."""
        super().load_state_dict(state_dict)
        loaded = dict(self.state)
        self._bind()
        with torch.no_grad():
            for p, s in loaded.items():
                for k in ("exp_avg", "exp_avg_sq"):
                    self.state[p][k].copy_(s[k])
                self._count.copy_(s["step"])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        lr, eps = group["lr"], group["eps"]
        ps = group["params"]
        g = torch.cat([(p.grad if p.grad is not None
                        else torch.zeros_like(p)).reshape(-1) for p in ps])
        self._mu.mul_(b1).add_(g * (1 - b1))
        self._nu.mul_(b2).add_(g * g * (1 - b2))
        self._count.add_(1)
        mu_hat = self._mu / (1 - torch.pow(b1, self._count))
        nu_hat = self._nu / (1 - torch.pow(b2, self._count))
        upd = mu_hat.div_(nu_hat.sqrt_().add_(eps)).mul_(-lr)
        torch._foreach_add_(ps, [u.view_as(p) for u, p in zip(
            upd.split([p.numel() for p in ps]), ps)])


@dataclasses.dataclass
class TrainState:
    """Actor, critic, their Adam state, the step count and the threefry key
    (int64[2]) that drives instance and action sampling. A train step
    updates it in place."""

    actor: TAPNetActor
    critic: TAPNetCritic
    opt: Adam
    step: int
    key: torch.Tensor

    def parameters(self):
        return list(self.actor.parameters()) + list(self.critic.parameters())


def make_optimizer(params, lr: float = 5e-4) -> Adam:
    """Adam as optax.adam(lr): betas (0.9, 0.999), eps 1e-8 outside the
    square root. The clip is `clip_by_global_norm_`, applied first."""
    return Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


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
    """`device` as a torch.device; "cuda" names the current card
    ("cuda:0"), as the tensors made on it report their device. Raises
    where there is no card."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the train path runs on cuda by default and "
                               "no CUDA device is available; pass "
                               "device='cpu' for the reference path")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _batch_losses(actor, critic, instances: Instance, keys, cfg: TAPConfig,
                  temperature: float, dtype=torch.float32):
    """(actor_loss, critic_loss, R [B], reward terms) with actor and critic
    in the compute dtype `dtype`; the record and the rollout's logp carry
    no gradient."""
    states, record, logp0 = rollout_batch_record(
        actor, instances, keys, cfg, greedy=False, temperature=temperature,
        with_logp=True, dtype=dtype)
    logp = replay_logp_sum(actor, instances, record, cfg, temperature,
                           logp0=logp0, dtype=dtype)
    static, dynamic, hm = build_tokens(instances, E.reset(instances, cfg),
                                       cfg)
    V = critic(static, dynamic, hm, dtype)
    _, _, terms, Rw = fused_reward(states.heightmap, states.placements,
                                   instances.dims, cfg.reward_terms)
    adv = Rw - V.detach()
    actor_loss = -(adv * logp).mean()
    critic_loss = ((V - Rw) ** 2).mean()
    return actor_loss, critic_loss, Rw, terms


class GraphedSteps:
    """`steps_per_call` train steps per call on the card: one step captured
    as a CUDA graph, replayed k times.

    The graph reads and writes the parameters, gradients and Adam buffers
    of the TrainState it was captured for, and a static key buffer: a call
    copies the state's key in, replays, and hands back a copy of the new
    key and copies of the last step's metrics. A call with any other state
    (a deep copy, other modules or another optimizer) captures anew for
    it, after `warm_up`: one eager step on a side stream, on a copy of the
    state, so kernels are built and libraries initialised (a mesh's NCCL
    communicator too) outside the capture. A capture that fails raises;
    nothing runs eagerly instead. It captures in "thread_local" mode, so
    that a mesh's NCCL watchdog thread may query its events meanwhile."""

    def __init__(self, body, k: int, device: torch.device):
        self.body, self.k, self.device = body, k, device
        self.graph = self._sig = self._key = self._metrics = None

    @staticmethod
    def _signature(ts: TrainState):
        tensors = [t for m in (ts.actor, ts.critic)
                   for t in list(m.parameters()) + list(m.buffers())]
        tensors += [p.grad for p in ts.parameters()]
        tensors += [v for s in ts.opt.state.values() for v in s.values()
                    if isinstance(v, torch.Tensor)]
        return tuple(None if t is None else (t.data_ptr(), t.shape)
                     for t in tensors)

    def warm_up(self, ts: TrainState):
        """One eager step on a deep copy of `ts` on a side stream; `ts`
        stays as it is."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            warm = copy.deepcopy(ts)
            self.body(warm, warm.key)
            del warm
        torch.cuda.current_stream(self.device).wait_stream(side)

    def capture(self, ts: TrainState):
        """Capture one step bound to `ts`, dropping any earlier graph (after
        a `warm_up`)."""
        self.graph = self._sig = self._key = self._metrics = None
        for p in ts.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        key = ts.key.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            new_key, metrics = self.body(ts, key)
            key.copy_(new_key)
        self.graph, self._key, self._metrics = graph, key, metrics
        self._sig = self._signature(ts)

    def __call__(self, ts: TrainState):
        if self.graph is None or self._signature(ts) != self._sig:
            self.warm_up(ts)
            self.capture(ts)
        self._key.copy_(ts.key)
        for _ in range(self.k):
            self.graph.replay()
        ts.key = self._key.clone()
        ts.step += self.k
        return ts, {k: v.clone() for k, v in self._metrics.items()}


def step_batch(key: torch.Tensor, batch: int, cfg: TAPConfig,
               mixed_p2d: float = 0.0, mesh=None, instances: Instance = None):
    """The key schedule of one step: `key, k_inst, k_act = split(key, 3)`;
    the instances of `split(k_inst, batch)` (mixed 2D/3D with `mixed_p2d` >
    0) unless `instances` (a global batch) is given; the action keys
    `split(k_act, B)`. With a mesh, this rank's rows of both. Returns
    (next key, instances, action keys)."""
    ks = R.split(key, 3)
    new_key, k_inst, k_act = ks[0], ks[1], ks[2]
    if instances is None:
        keys = R.split(k_inst, batch)
        if mesh is not None:
            keys = keys[mesh.rows(batch)]
        instances = sample_instance(
            keys, cfg, mix_flat(keys, mixed_p2d) if mixed_p2d > 0 else None)
        B = batch
    else:
        B = instances.dims.shape[0]
        if mesh is not None:
            instances = instances.index(mesh.rows(B))
    act_keys = R.split(k_act, B)
    if mesh is not None:
        act_keys = act_keys[mesh.rows(B)]
    return new_key, instances, act_keys


_MEAN_METRICS = ("loss_actor", "loss_critic", "reward", "C", "P", "S")

_COMPUTE_DTYPES = {None: torch.float32, torch.float32: torch.float32,
                   "float32": torch.float32, torch.bfloat16: torch.bfloat16,
                   "bfloat16": torch.bfloat16}


def compute_dtype_of(compute_dtype) -> torch.dtype:
    """float32 for None, torch.float32 or "float32"; bfloat16 for
    torch.bfloat16 or "bfloat16"; any other value raises
    NotImplementedError."""
    try:
        return _COMPUTE_DTYPES[compute_dtype]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"the port computes in float32 or bfloat16, not {compute_dtype} "
            "(ROADMAP.md)") from None


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
    clip). `steps_per_call` > 1: that many steps per call (on the card as
    replays of a CUDA graph), the last one's metrics. `mixed_p2d` > 0:
    each sampled instance is flat (2D) with that probability
    (`sample_batch_mixed`, 3D configs only). `mesh`: a
    `parallel.mesh.DataMesh`; the step runs on its device, sharded over
    its ranks (`batch`, and a given dataset batch, are global and a
    multiple of the world size; the state is replicated, e.g. by
    `parallel.distributed.broadcast_from_main`). `compute_dtype`: None or
    float32 (the default on both devices), or bfloat16 (`compute_dtype_of`).
    Runs on `cuda` unless `device="cpu"`."""
    if mixed_p2d > 0:
        check_mixed(cfg)
    dtype = compute_dtype_of(compute_dtype)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call {steps_per_call} < 1")
    if from_dataset and steps_per_call != 1:
        raise ValueError("steps_per_call > 1 needs on-device sampling "
                         "(from_dataset=False)")
    if mesh is not None:
        mesh.rows(batch)   # a ValueError unless the world size divides it
        device = mesh.device
    device = resolve_device(device)

    def body(ts: TrainState, key: torch.Tensor, instances: Instance = None):
        """One step from `key`: updates the parameters and the Adam state
        in place; returns the next key and the metrics."""
        new_key, instances, act_keys = step_batch(key, batch, cfg, mixed_p2d,
                                                  mesh, instances)
        params = ts.parameters()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_zero_([p.grad for p in params])
        actor_loss, critic_loss, Rw, terms = _batch_losses(
            ts.actor, ts.critic, instances, act_keys, cfg, temperature,
            dtype)
        (actor_loss + critic_weight * critic_loss).backward()
        if mesh is not None:
            mesh.all_reduce_mean_([p.grad for p in params])
        gnorm = clip_by_global_norm_([p.grad for p in params], clip)
        for g in ts.opt.param_groups:
            g["lr"] = lr
        ts.opt.step()

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
        if mesh is not None:
            # the rank means become global means; grad_norm is already one
            # value on every rank
            mesh.all_reduce_mean_([metrics[k] for k in _MEAN_METRICS])
        return new_key, metrics

    def check(ts: TrainState):
        if ts.key.device != device:
            raise ValueError(f"TrainState is on {ts.key.device}, the step "
                             f"on {device}")
        if ts.actor.hidden != hidden:
            raise ValueError(f"actor hidden {ts.actor.hidden} != {hidden}")

    def train_step(ts: TrainState, instances: Instance = None):
        check(ts)
        ts.key, metrics = body(ts, ts.key, instances)
        ts.step += 1
        return ts, metrics

    if from_dataset:
        return train_step
    if steps_per_call == 1:
        return lambda ts: train_step(ts)
    if device.type == "cuda":
        graphed = GraphedSteps(body, steps_per_call, device)

        def graph_steps(ts: TrainState):
            check(ts)
            return graphed(ts)

        graph_steps.graphed = graphed
        return graph_steps

    def cpu_steps(ts: TrainState):
        for _ in range(steps_per_call):
            ts, metrics = train_step(ts)
        return ts, metrics

    return cpu_steps
