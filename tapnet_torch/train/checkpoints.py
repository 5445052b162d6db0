"""Checkpoint and resume, the port of `tapnet_tpu/train/checkpoints.py`.

The whole TrainState is saved: both modules' state dicts, the Adam state,
the step count and the threefry key that drives instance and action
sampling, so a restore continues the exact trajectory. Files are
`ckpt_{step:08d}.pt` (torch.save), written to a temporary name and moved
into place with `os.replace`; `latest.json` names the newest.
`restore_checkpoint` also reads the JAX package's `ckpt_*.msgpack` (flax's
`to_bytes` of its TrainState, decoded by `utils.msgpack`), so a JAX run
resumes or evaluates in the port; the port writes only `.pt`.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from tapnet_torch.convert import flax_to_state_dict
from tapnet_torch.train.reinforce import TrainState
from tapnet_torch.utils import msgpack


def save_checkpoint(ckpt_dir: str, ts: TrainState) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{ts.step:08d}.pt")
    tmp = path + ".tmp"
    torch.save({"actor": ts.actor.state_dict(),
                "critic": ts.critic.state_dict(),
                "opt": ts.opt.state_dict(), "step": int(ts.step),
                "key": ts.key.cpu()}, tmp)
    os.replace(tmp, path)  # atomic: no torn checkpoints on kill -9
    meta = os.path.join(ckpt_dir, "latest.json")
    with open(meta + ".tmp", "w") as f:
        json.dump({"step": int(ts.step), "path": path}, f)
    os.replace(meta + ".tmp", meta)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    meta = os.path.join(ckpt_dir, "latest.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        path = json.load(f)["path"]
    return path if os.path.exists(path) else None


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load a checkpoint (the port's `.pt` or the JAX package's `.msgpack`)
    into `template` (modules and optimizer built by `init_train_state`) on
    the template's device; returns it."""
    if path.endswith(".msgpack"):
        with open(path, "rb") as f:
            return load_flax_train_state(msgpack.unpackb(f.read()), template)
    dev = template.key.device
    d = torch.load(path, map_location=dev, weights_only=True)
    template.actor.load_state_dict(d["actor"])
    template.critic.load_state_dict(d["critic"])
    template.opt.load_state_dict(d["opt"])
    template.step = int(d["step"])
    template.key = d["key"].to(dev)
    return template


@torch.no_grad()
def load_flax_train_state(tree: dict, template: TrainState) -> TrainState:
    """Copy a JAX TrainState's state dict into `template`: the params at
    /params/{actor,critic}, optax's chain state at /opt_state (clip, then
    adam: /opt_state/1/0/{count, mu, nu}, mu and nu params-shaped), /step
    and /key (uint32[2]). Dense kernels of the params and of both moments
    are transposed by `convert.flax_to_state_dict`; the moments go into the
    Adam buffers in parameter order, the int32 count becomes the float32
    count, the key int64[2]."""
    adam = tree["opt_state"]["1"]["0"]
    for part, module in (("actor", template.actor),
                         ("critic", template.critic)):
        module.load_state_dict(flax_to_state_dict(tree["params"][part]))
        mu = flax_to_state_dict(adam["mu"][part])
        nu = flax_to_state_dict(adam["nu"][part])
        for name, p in module.named_parameters():
            state = template.opt.state[p]
            state["exp_avg"].copy_(mu[name])
            state["exp_avg_sq"].copy_(nu[name])
            state["step"].fill_(float(adam["count"]))
    template.step = int(tree["step"])
    template.key = torch.from_numpy(
        np.asarray(tree["key"]).astype(np.int64)).to(template.key.device)
    return template
