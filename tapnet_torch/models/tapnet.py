"""TAP-Net pointer actor as a `torch.nn.Module`, the port of the actor in
`tapnet_tpu/models/tapnet.py`.

Same function as the flax module, parameter for parameter (`convert.py`
maps a flax actor tree onto this module's `state_dict`):

- `embed_static`: a residual MLP over the static (block, rot) tokens and a
  key projection, run once per rollout;
- `head`: score[t, c] = v . tanh(key_t + dyn_t + q_c), where dyn_t is a
  narrow MLP over the merged (dynamic flags ++ static dims) token and q_c a
  query over [heightmap encoding, mean key, previous-action embedding, mean
  merged token] for container c; `head_ctx` is the same head with the two
  means passed in and any subset of the tokens scored.

Module names follow the flax tree (`token_enc.Dense_0`, `hm_enc.Dense_1`,
...). `nn.Linear` stores [out, in]; flax kernels are [in, out].

The compute dtype is flax's `dtype` field (`param_dtype` float32): the
parameters stay float32 and every layer casts them at use, so gradients
flow back through the cast. Every method takes the dtype as an argument
(float32 by default), which the rollout and the train step pass. In
bfloat16 a Dense layer is the product of the cast input and weight,
accumulated in float32 and rounded once, then the bias added as a second
bfloat16 op (`_dense`); LayerNorm takes its statistics and its arithmetic
in float32 and rounds its output (`_LayerNorm`); the logits are float32.
In float32 every method computes what it computed before it had a dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tapnet_torch.config import TAPConfig
from tapnet_torch.models.features import merge_tokens

F32 = torch.float32


def _dense(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)` with float32 parameters: in float32 the
    layer itself; otherwise x and the weight cast to `dtype`, their product
    (float32 accumulation, one rounding), then the bias added in `dtype`,
    not fused into the product (flax rounds twice)."""
    if dtype == F32:
        return lin(x)
    y = x.to(dtype) @ lin.weight.to(dtype).T
    return y if lin.bias is None else y + lin.bias.to(dtype)


def _full(p: torch.Tensor) -> torch.Tensor:
    """A parameter as a whole tensor: a DTensor (a tensor-parallel shard,
    `parallel/tp.py`) gathered, any other tensor as it is."""
    full = getattr(p, "full_tensor", None)
    return p if full is None else full()


class _LayerNorm(nn.Module):
    """flax.linen.LayerNorm: fast variance E[x^2] - E[x]^2 clipped at 0,
    eps 1e-6, y = (x - mu) * (rsqrt(var + eps) * scale) + bias, the
    statistics and the arithmetic in float32 (flax `_compute_stats`,
    `_normalize`), the output cast to `dtype`."""

    def __init__(self, n: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x, dtype=F32):
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
        y = (x - mu) * (torch.rsqrt(var + 1e-6) * self.scale) + _full(
            self.bias)
        return y.to(dtype)


class _TokenEncoder(nn.Module):
    """Residual MLP over static tokens [..., T, 4] -> [..., T, h]. Flax
    names the outer Dense of `Dense(relu(Dense(y)))` first: block b uses
    inner Dense_{2b+2} and outer Dense_{2b+1}."""

    def __init__(self, hidden: int, blocks: int = 2):
        super().__init__()
        self.blocks = blocks
        self.Dense_0 = nn.Linear(4, hidden)
        for b in range(blocks):
            setattr(self, f"LayerNorm_{b}", _LayerNorm(hidden))
            setattr(self, f"Dense_{2 * b + 1}", nn.Linear(hidden, hidden))
            setattr(self, f"Dense_{2 * b + 2}", nn.Linear(hidden, hidden))

    def forward(self, static, dtype=F32):
        x = _dense(self.Dense_0, static, dtype)
        for b in range(self.blocks):
            y = getattr(self, f"LayerNorm_{b}")(x, dtype)
            inner = getattr(self, f"Dense_{2 * b + 2}")
            outer = getattr(self, f"Dense_{2 * b + 1}")
            x = x + _dense(outer, torch.relu(_dense(inner, y, dtype)), dtype)
        return x


class _HeightmapEncoder(nn.Module):
    """Dense encoder over flattened [W, D] grids with max/mean summaries:
    [..., C, W, D, 1] -> [..., C, h]."""

    def __init__(self, hidden: int, cells: int):
        super().__init__()
        self.Dense_0 = nn.Linear(cells + 2, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)

    def forward(self, hm_grid, dtype=F32):
        x = hm_grid.to(dtype).flatten(-3)                     # [..., C, W*D]
        feats = torch.cat([x, x.amax(-1, keepdim=True),
                           x.mean(-1, keepdim=True)], dim=-1)
        return _dense(self.Dense_1,
                      torch.relu(_dense(self.Dense_0, feats, dtype)), dtype)


class TAPNetActor(nn.Module):
    """Logits over the flat (block, rot, container) action space."""

    def __init__(self, cfg: TAPConfig, hidden: int = 128):
        super().__init__()
        self.cfg = cfg
        self.hidden = hidden
        self.token_enc = _TokenEncoder(hidden)
        self.key_proj = nn.Linear(hidden, hidden, bias=False)
        self.dyn_hidden = nn.Linear(8, 32)
        self.dyn_proj = nn.Linear(32, hidden, bias=False)
        self.hm_enc = _HeightmapEncoder(
            hidden, cfg.target_width * cfg.target_depth)
        self.prev_embed = nn.Embedding(cfg.num_actions + 1, hidden)
        self.query = nn.Linear(3 * hidden + 8, hidden)
        self.v = nn.Parameter(torch.zeros(hidden, 1))

    def forward(self, static, dynamic, hm_grid, prev_action=None,
                dtype=F32):
        """Pointer logits [B, A] f32 from the raw tokens, flax's
        `TAPNetActor.__call__`: static [B, T, 4], dynamic [B, T, 4] (the
        static dims appended here), hm_grid [B, C, W, D, 1], prev_action
        [B] (None: the decode start, -1)."""
        if prev_action is None:
            prev_action = torch.full(static.shape[:1], -1, dtype=torch.int32,
                                     device=static.device)
        return self.head(self.embed_static(static, dtype),
                         merge_tokens(static, dynamic), hm_grid, prev_action,
                         dtype)

    def embed_static(self, static, dtype=F32):
        """Static attention keys: [B, T, 4] -> [B, T, h] in the compute
        dtype `dtype`."""
        return _dense(self.key_proj, self.token_enc(static, dtype), dtype)

    def head(self, static_emb, dynamic, hm_grid, prev_action, dtype=F32):
        """Pointer logits [B, A] f32 from static keys [B, T, h] (in the
        compute dtype), merged tokens [B, T, 8], hm_grid [B, C, W, D, 1] and
        the previous action [B] in [-1, A) (-1 = decode start)."""
        return self.head_ctx(static_emb, dynamic, hm_grid, prev_action,
                             static_emb.mean(1), dynamic.to(dtype).mean(1),
                             dtype)

    def head_ctx(self, static_emb, dynamic, hm_grid, prev_action, ctx, dsum,
                 dtype=F32):
        """`head` with the two full-token summaries passed in (ctx = mean
        static key [B, h], dsum = mean merged token [B, 8]) and the token
        inputs allowed to be a subset of the T tokens: static_emb
        [B, Tk, h] and dynamic [B, Tk, 8] give scores [B, Tk*C] for exactly
        the tokens given, token-major and container-minor. The windowed
        head and the windowed replay of rolling configs score only the
        window's tokens through it (train/rollout.py). In bfloat16 the
        attention runs in bfloat16 as flax's does, with the scores rounded
        to bfloat16 before they become float32 logits."""
        dyn = _dense(self.dyn_proj,
                     torch.relu(_dense(self.dyn_hidden, dynamic, dtype)),
                     dtype)
        hm = self.hm_enc(hm_grid, dtype)                      # [B, C, h]
        idx = (prev_action.long() + 1).clamp(0, self.cfg.num_actions)
        prev = self.prev_embed.weight[idx].to(dtype)          # [B, h]
        C = hm.shape[1]
        qin = torch.cat([hm, ctx.to(dtype)[:, None].expand(-1, C, -1),
                         prev[:, None].expand(-1, C, -1),
                         dsum.to(dtype)[:, None].expand(-1, C, -1)], dim=-1)
        q = _dense(self.query, qin, dtype)                    # [B, C, h]
        act = torch.tanh(static_emb[:, :, None, :] + dyn[:, :, None, :]
                         + q[:, None, :, :])                  # [B, Tk, C, h]
        scores = (act @ self.v.to(dtype))[..., 0]             # [B, Tk, C]
        return scores.reshape(scores.shape[0], -1).float()


class TAPNetCritic(nn.Module):
    """State-value baseline over the reset state, the port of
    `tapnet_tpu.models.tapnet.TAPNetCritic`: one Dense over the (static ++
    dynamic) token, the heightmap encoder, mean and max pooling of both,
    then a three-layer MLP to a scalar. Names follow the flax tree
    (`Dense_0`, `hm_enc`, `Dense_1..3`)."""

    def __init__(self, cfg: TAPConfig, hidden: int = 128):
        super().__init__()
        self.cfg = cfg
        self.hidden = hidden
        self.Dense_0 = nn.Linear(8, hidden)
        self.hm_enc = _HeightmapEncoder(
            hidden, cfg.target_width * cfg.target_depth)
        self.Dense_1 = nn.Linear(4 * hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, hidden)
        self.Dense_3 = nn.Linear(hidden, 1)

    def forward(self, static, dynamic, hm_grid, dtype=F32):
        """V [B] float32 from static [B, T, 4], dynamic [B, T, 4] (not
        merged) and hm_grid [B, C, W, D, 1], computed in `dtype`."""
        tok = torch.relu(_dense(self.Dense_0, torch.cat([static, dynamic], -1),
                                dtype))
        hm = self.hm_enc(hm_grid, dtype)                      # [B, C, h]
        z = torch.cat([tok.mean(-2), tok.amax(-2), hm.mean(-2),
                       hm.amax(-2)], -1)
        z = torch.relu(_dense(self.Dense_1, z, dtype))
        z = torch.relu(_dense(self.Dense_2, z, dtype))
        return _dense(self.Dense_3, z, dtype)[..., 0].float()


def embed_static_T(actor: TAPNetActor, static_t: torch.Tensor,
                   dtype=F32) -> torch.Tensor:
    """Transposed twin of `embed_static`: [4, M] -> [h, M], every GEMM as
    W @ X with the M columns last, so the actor kernel's [T, h, B] key
    operand is born batch-last (cf. `tapnet_tpu.models.tapnet.embed_static_T`:
    the same formula, LayerNorm statistics over the feature axis 0). In
    bfloat16 it rounds where the JAX twin does, which is not where flax's
    LayerNorm does: the normalised value is rounded, then scale and bias
    are two bfloat16 ops, and the variance is not clipped at 0."""
    te = actor.token_enc

    def dense(lin, x):
        return lin.weight.to(dtype) @ x + lin.bias.to(dtype)[:, None]

    x = dense(te.Dense_0, static_t.to(dtype))
    for b in range(te.blocks):
        ln = getattr(te, f"LayerNorm_{b}")
        xf = x.float()
        mu = xf.mean(0, keepdim=True)
        var = (xf * xf).mean(0, keepdim=True) - mu * mu
        y = ((xf - mu) * torch.rsqrt(var + 1e-6)).to(dtype)
        y = y * ln.scale.to(dtype)[:, None] + ln.bias.to(dtype)[:, None]
        y = dense(getattr(te, f"Dense_{2 * b + 1}"),
                  torch.relu(dense(getattr(te, f"Dense_{2 * b + 2}"), y)))
        x = x + y
    return actor.key_proj.weight.to(dtype) @ x


def _lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator):
    """flax lecun_normal: truncated normal (+-2 std), variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        t.copy_(torch.nn.init.trunc_normal_(
            torch.empty(t.shape), 0.0, 1.0, -2.0, 2.0, generator=g) * std)


def _init_(module: nn.Module, g: torch.Generator, hidden: int):
    for m in module.modules():
        if isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               / math.sqrt(hidden))


def init_params(seed: int, cfg: TAPConfig, hidden: int = 128,
                device=None) -> TAPNetActor:
    """A seeded actor, initialised the way flax initialises it (lecun-normal
    Dense kernels, zero biases, unit LayerNorm scales, normal(1/sqrt(h))
    embedding rows): same law, torch's own draws."""
    g = torch.Generator().manual_seed(int(seed))
    actor = TAPNetActor(cfg, hidden)
    _init_(actor, g, hidden)
    _lecun_normal_(actor.v, hidden, g)
    return actor.to(device).eval()


def init_critic(seed: int, cfg: TAPConfig, hidden: int = 128,
                device=None) -> TAPNetCritic:
    """A seeded critic, initialised by flax's law (lecun-normal kernels,
    zero biases) from its own generator stream (seed + 1)."""
    g = torch.Generator().manual_seed(int(seed) + 1)
    critic = TAPNetCritic(cfg, hidden)
    _init_(critic, g, hidden)
    return critic.to(device)
