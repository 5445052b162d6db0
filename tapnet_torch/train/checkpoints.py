"""Checkpoint and resume, the port of `tapnet_tpu/train/checkpoints.py`.

The whole TrainState is saved: both modules' state dicts, the Adam state,
the step count and the threefry key that drives instance and action
sampling, so a restore continues the exact trajectory. Files are
`ckpt_{step:08d}.pt` (torch.save), written to a temporary name and moved
into place with `os.replace`; `latest.json` names the newest. Reading the
JAX package's msgpack checkpoints is not ported (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from tapnet_torch.train.reinforce import TrainState


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
    """Load a checkpoint into `template` (modules and optimizer built by
    `init_train_state`) on the template's device; returns it."""
    dev = template.key.device
    d = torch.load(path, map_location=dev, weights_only=True)
    template.actor.load_state_dict(d["actor"])
    template.critic.load_state_dict(d["critic"])
    template.opt.load_state_dict(d["opt"])
    template.step = int(d["step"])
    template.key = d["key"].to(dev)
    return template
