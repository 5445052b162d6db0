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
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tapnet_torch.config import TAPConfig


class _LayerNorm(nn.Module):
    """flax.linen.LayerNorm: fast variance E[x^2] - E[x]^2 clipped at 0,
    eps 1e-6, y = (x - mu) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, n: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
        return (x - mu) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias


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

    def forward(self, static):
        x = self.Dense_0(static)
        for b in range(self.blocks):
            y = getattr(self, f"LayerNorm_{b}")(x)
            inner = getattr(self, f"Dense_{2 * b + 2}")
            outer = getattr(self, f"Dense_{2 * b + 1}")
            x = x + outer(torch.relu(inner(y)))
        return x


class _HeightmapEncoder(nn.Module):
    """Dense encoder over flattened [W, D] grids with max/mean summaries:
    [..., C, W, D, 1] -> [..., C, h]."""

    def __init__(self, hidden: int, cells: int):
        super().__init__()
        self.Dense_0 = nn.Linear(cells + 2, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)

    def forward(self, hm_grid):
        x = hm_grid.flatten(-3)                               # [..., C, W*D]
        feats = torch.cat([x, x.amax(-1, keepdim=True),
                           x.mean(-1, keepdim=True)], dim=-1)
        return self.Dense_1(torch.relu(self.Dense_0(feats)))


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

    def embed_static(self, static):
        """Static attention keys: [B, T, 4] -> [B, T, h]."""
        return self.key_proj(self.token_enc(static))

    def head(self, static_emb, dynamic, hm_grid, prev_action):
        """Pointer logits [B, A] f32 from static keys [B, T, h], merged
        tokens [B, T, 8], hm_grid [B, C, W, D, 1] and the previous action
        [B] in [-1, A) (-1 = decode start)."""
        return self.head_ctx(static_emb, dynamic, hm_grid, prev_action,
                             static_emb.mean(1), dynamic.mean(1))

    def head_ctx(self, static_emb, dynamic, hm_grid, prev_action, ctx, dsum):
        """`head` with the two full-token summaries passed in (ctx = mean
        static key [B, h], dsum = mean merged token [B, 8]) and the token
        inputs allowed to be a subset of the T tokens: static_emb
        [B, Tk, h] and dynamic [B, Tk, 8] give scores [B, Tk*C] for exactly
        the tokens given, token-major and container-minor. The windowed
        head and the windowed replay of rolling configs score only the
        window's tokens through it (train/rollout.py)."""
        dyn = self.dyn_proj(torch.relu(self.dyn_hidden(dynamic)))
        hm = self.hm_enc(hm_grid)                             # [B, C, h]
        idx = (prev_action.long() + 1).clamp(0, self.cfg.num_actions)
        prev = self.prev_embed.weight[idx]                    # [B, h]
        C = hm.shape[1]
        qin = torch.cat([hm, ctx[:, None].expand(-1, C, -1),
                         prev[:, None].expand(-1, C, -1),
                         dsum[:, None].expand(-1, C, -1)], dim=-1)
        q = self.query(qin)                                   # [B, C, h]
        act = torch.tanh(static_emb[:, :, None, :] + dyn[:, :, None, :]
                         + q[:, None, :, :])                  # [B, Tk, C, h]
        scores = (act @ self.v)[..., 0]                       # [B, Tk, C]
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

    def forward(self, static, dynamic, hm_grid):
        """V [B] from static [B, T, 4], dynamic [B, T, 4] (not merged) and
        hm_grid [B, C, W, D, 1]."""
        tok = torch.relu(self.Dense_0(torch.cat([static, dynamic], -1)))
        hm = self.hm_enc(hm_grid)                             # [B, C, h]
        z = torch.cat([tok.mean(-2), tok.amax(-2), hm.mean(-2),
                       hm.amax(-2)], -1)
        z = torch.relu(self.Dense_1(z))
        z = torch.relu(self.Dense_2(z))
        return self.Dense_3(z)[..., 0].float()


def embed_static_T(actor: TAPNetActor, static_t: torch.Tensor) -> torch.Tensor:
    """Transposed twin of `embed_static`: [4, M] -> [h, M], every GEMM as
    W @ X with the M columns last, so the actor kernel's [T, h, B] key
    operand is born batch-last (cf. `tapnet_tpu.models.tapnet.embed_static_T`:
    the same formula, LayerNorm statistics over the feature axis 0)."""
    te = actor.token_enc

    def dense(lin, x):
        return lin.weight @ x + lin.bias[:, None]

    x = dense(te.Dense_0, static_t)
    for b in range(te.blocks):
        ln = getattr(te, f"LayerNorm_{b}")
        mu = x.mean(0, keepdim=True)
        var = (x * x).mean(0, keepdim=True) - mu * mu
        y = (x - mu) * torch.rsqrt(var + 1e-6)
        y = y * ln.scale[:, None] + ln.bias[:, None]
        y = dense(getattr(te, f"Dense_{2 * b + 1}"),
                  torch.relu(dense(getattr(te, f"Dense_{2 * b + 2}"), y)))
        x = x + y
    return actor.key_proj.weight @ x


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
