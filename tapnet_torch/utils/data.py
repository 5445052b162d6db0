"""Instance dataset files: save, load, iterate. The port of
`tapnet_tpu/utils/data.py`.

A dataset is one `.npz` with the Instance fields under the JAX package's
names and dtypes (int32 `dims`, `pos0`, `n_total`; bool `up`, `rot`; batch
first) and a `.npz.json` sidecar holding the TAPConfig, so a file written
by either package loads in both. Arrays are numpy; a caller moves a batch to
its device (`Instance.to`), as for `make_train_step(from_dataset=True)`.
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterator, Optional

import numpy as np

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.types import Instance

DTYPES = {"dims": np.int32, "pos0": np.int32, "n_total": np.int32,
          "up": np.bool_, "rot": np.bool_}


def generate_dataset(path: str, cfg: TAPConfig, num: int, seed: int = 0,
                     batch_size: int = 512, device="cuda") -> str:
    """Sample `num` instances on `device` in chunks of `batch_size` (chunk
    i from `fold_in(key(seed), i)`, as the JAX package chunks) and write
    one .npz + config sidecar. Runs on `cuda` unless `device="cpu"`."""
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.train.reinforce import resolve_device

    dev = resolve_device(device)
    chunks = []
    for i in range(math.ceil(num / batch_size)):
        n = min(batch_size, num - i * batch_size)
        batch = sample_batch(R.fold_in(R.key(seed, dev), i), n, cfg)
        chunks.append([x.cpu().numpy() for x in batch])
    merged = Instance(*[np.concatenate(parts) for parts in zip(*chunks)])
    save_instances(path, merged, cfg)
    return path


def save_instances(path: str, instances: Instance,
                   cfg: Optional[TAPConfig] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f: np.asarray(getattr(instances, f), dtype=DTYPES[f])
              for f in Instance._fields}
    np.savez_compressed(path, **arrays)
    if cfg is not None:
        with open(path + ".json", "w") as f:
            json.dump(cfg.__dict__, f, indent=1)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def load_instances(path: str) -> Instance:
    with np.load(_npz(path)) as z:
        return Instance(*[z[f] for f in Instance._fields])


def load_config(path: str) -> TAPConfig:
    with open(_npz(path) + ".json") as f:
        return TAPConfig(**json.load(f))


class PackDataset:
    """Minibatch iterator over a saved instance file: numpy Instances of
    `batch_size` rows, in file order or shuffled by
    `np.random.default_rng(shuffle_seed)` (the JAX package's order); a
    last partial batch is dropped."""

    def __init__(self, path: str, batch_size: int,
                 shuffle_seed: Optional[int] = None):
        self.instances = load_instances(path)
        self.n = self.instances.dims.shape[0]
        self.batch_size = batch_size
        self.shuffle_seed = shuffle_seed

    def __len__(self) -> int:
        return self.n // self.batch_size

    def __iter__(self) -> Iterator[Instance]:
        order = np.arange(self.n)
        if self.shuffle_seed is not None:
            np.random.default_rng(self.shuffle_seed).shuffle(order)
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield Instance(*[x[idx] for x in self.instances])
