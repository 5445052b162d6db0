"""Visualization: render initial/target containers and packing sequences,
the port of `tapnet_tpu/utils/viz.py` (the same six functions, figures,
titles, limits, dpi and frame rate, so the same inputs give the same
pixels).

2D tasks render block rectangles in the x-z plane; 3D tasks render
per-container heightmap images (`render_3d`) or block voxels
(`render_3d_blocks`). Every function takes the port's `Instance` /
`EnvState` of ONE instance: its fields without the batch axis, or a batch
of one, which is squeezed. Tensors may sit on the card; they are moved to
the host once at entry. `render_sequence` and `render_animation` replay
the actions through the port's `reset` / `step` on the host, as the JAX
functions replay through `E.reset` / `E.step`. Host code only: matplotlib
is imported inside each function (after `matplotlib.use("Agg")`), so the
module imports without it and a function raises matplotlib's own
ImportError where it is absent. PNG and GIF output.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tapnet_torch.config import TAPConfig
from tapnet_torch.types import (EnvState, Instance, PLACE_CONTAINER, PLACE_ROT,
                                PLACE_X, PLACE_Y, PLACE_Z, PLACE_STABLE)


def _host(tup, ndim: int):
    """A NamedTuple of one instance as numpy on the host: `ndim` is its
    first field's rank without the batch axis; a batch of one is
    squeezed."""
    first = tup[0]
    if first.ndim == ndim + 1:
        if first.shape[0] != 1:
            raise ValueError(f"render takes one instance or a batch of one, "
                             f"not a batch of {first.shape[0]}")
        tup = type(tup)(*(x[0] for x in tup))
    return type(tup)(*(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x) for x in tup))


def _actions(actions) -> list:
    if isinstance(actions, torch.Tensor):
        actions = actions.detach().cpu().numpy()
    return np.asarray(actions).reshape(-1).tolist()


def _replay(instance: Instance, actions, cfg: TAPConfig):
    """(the actions taken, [the reset state, the state after each]) of one
    instance, through the port's env on the host."""
    from tapnet_torch.env import core as E

    steps = [a for a in _actions(actions) if a >= 0]
    batch = Instance(*(torch.from_numpy(np.asarray(x))[None]
                       for x in instance))
    state = E.reset(batch, cfg)
    frames = [state]
    for a in steps:
        state = E.step(state, torch.full((1,), a, dtype=torch.int32), batch,
                       cfg)
        frames.append(state)
    return steps, [_host(st, 3) for st in frames]


def _colors(n: int):
    import matplotlib.cm as cm
    return [cm.tab20(i % 20) for i in range(n)]


def _rotated(dims, r, cfg):
    w, d, h = (int(v) for v in dims)
    if r == 1:
        v = [w, d, h]
        a0, a1 = cfg.rot_axes
        v[a0], v[a1] = v[a1], v[a0]
        w, d, h = v
    return w, d, h


def render_2d(instance: Instance, state: EnvState, cfg: TAPConfig,
              path: Optional[str] = None, title: str = ""):
    """Initial container + each target container, blocks colored by index."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    instance, state = _host(instance, 2), _host(state, 3)
    n = int(instance.n_total)
    cols = _colors(n)
    C = cfg.num_containers
    fig, axes = plt.subplots(1, 1 + C, figsize=(4 * (1 + C), 4))
    axes = np.atleast_1d(axes)

    ax = axes[0]
    ax.set_title("initial")
    for b in range(n):
        x, _, z = (int(v) for v in instance.pos0[b])
        w, _, h = (int(v) for v in instance.dims[b])
        ax.add_patch(Rectangle((x, z), w, h, facecolor=cols[b],
                               edgecolor="k", linewidth=0.8))
        ax.text(x + w / 2, z + h / 2, str(b), ha="center", va="center",
                fontsize=8)
    ax.set_xlim(0, cfg.container_width)
    ax.set_ylim(0, cfg.container_height)
    ax.set_aspect("equal")

    for c in range(C):
        ax = axes[1 + c]
        ax.set_title(f"target {c}")
        top = 1
        for b in range(n):
            pl = state.placements[b]
            if int(pl[PLACE_CONTAINER]) != c:
                continue
            w, _, h = _rotated(instance.dims[b], int(pl[PLACE_ROT]), cfg)
            x, z = int(pl[PLACE_X]), int(pl[PLACE_Z])
            hatch = None if int(pl[PLACE_STABLE]) else "//"
            ax.add_patch(Rectangle((x, z), w, h, facecolor=cols[b],
                                   edgecolor="k", linewidth=0.8, hatch=hatch))
            ax.text(x + w / 2, z + h / 2, str(b), ha="center", va="center",
                    fontsize=8)
            top = max(top, z + h)
        ax.set_xlim(0, cfg.target_width)
        ax.set_ylim(0, max(top, cfg.container_height))
        ax.set_aspect("equal")

    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def render_3d(instance: Instance, state: EnvState, cfg: TAPConfig,
              path: Optional[str] = None, title: str = ""):
    """Heightmap images per target container (top-down, annotated max h)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    C = cfg.num_containers
    hm = _host(state, 3).heightmap
    fig, axes = plt.subplots(1, C, figsize=(4 * C, 4), squeeze=False)
    for c in range(C):
        ax = axes[0][c]
        im = ax.imshow(hm[c].T, origin="lower", cmap="viridis")
        ax.set_title(f"target {c} (max h = {hm[c].max()})")
        fig.colorbar(im, ax=ax, shrink=0.8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def _draw_block_3d(ax, x, y, z, w, d, h, color):
    """One axis-aligned box as a bar3d voxel."""
    ax.bar3d(x, y, z, w, d, h, color=color, edgecolor="k", linewidth=0.4,
             alpha=0.95, shade=True)


def render_3d_blocks(instance: Instance, state: EnvState, cfg: TAPConfig,
                     path: Optional[str] = None, title: str = ""):
    """Block-level 3D view: initial container + each target container.

    Every placed block is drawn as a colored voxel box at its recorded
    (x, y, landing) position with its rotated dims, not a heightmap.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    instance, state = _host(instance, 2), _host(state, 3)
    n = int(instance.n_total)
    cols = _colors(n)
    C = cfg.num_containers
    fig = plt.figure(figsize=(4 * (1 + C), 4.2))

    ax = fig.add_subplot(1, 1 + C, 1, projection="3d")
    ax.set_title("initial")
    for b in range(n):
        x, y, z = (int(v) for v in instance.pos0[b])
        w, d, h = (int(v) for v in instance.dims[b])
        _draw_block_3d(ax, x, y, z, w, d, h, cols[b])
    ax.set_xlim(0, cfg.container_width)
    ax.set_ylim(0, max(cfg.container_depth, 1))
    ax.set_zlim(0, cfg.container_height)

    for c in range(C):
        ax = fig.add_subplot(1, 1 + C, 2 + c, projection="3d")
        ax.set_title(f"target {c}")
        top = 1
        for b in range(n):
            pl = state.placements[b]
            if int(pl[PLACE_CONTAINER]) != c:
                continue
            w, d, h = _rotated(instance.dims[b], int(pl[PLACE_ROT]), cfg)
            x, y, z = int(pl[PLACE_X]), int(pl[PLACE_Y]), int(pl[PLACE_Z])
            _draw_block_3d(ax, x, y, z, w, d, h, cols[b])
            top = max(top, z + h)
        ax.set_xlim(0, cfg.target_width)
        ax.set_ylim(0, max(cfg.target_depth, 1))
        ax.set_zlim(0, max(top, cfg.container_height))
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def render_animation(instance: Instance, actions: Sequence[int],
                     cfg: TAPConfig, path: str, fps: int = 2):
    """Animated GIF of the transport sequence (2D rectangles or 3D voxels).

    Each frame replays the trajectory prefix through the env (the same
    transition as training) and draws the target container(s) after that
    placement; the first frame is the empty start. Requires a .gif path
    (PillowWriter).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter
    from matplotlib.patches import Rectangle

    instance = _host(instance, 2)
    steps, frames = _replay(instance, actions, cfg)
    n = int(instance.n_total)
    cols = _colors(n)
    C = cfg.num_containers
    three_d = cfg.dim == 3
    fig = plt.figure(figsize=(4 * C, 4))

    def draw(i):
        fig.clf()
        placements = frames[i].placements
        label = "start" if i == 0 else (
            f"t={i - 1}: block {int(cfg.decompose_action(steps[i - 1])[0])}")
        for c in range(C):
            if three_d:
                ax = fig.add_subplot(1, C, 1 + c, projection="3d")
            else:
                ax = fig.add_subplot(1, C, 1 + c)
            ax.set_title(f"target {c} — {label}", fontsize=9)
            for b in range(n):
                pl = placements[b]
                if int(pl[PLACE_CONTAINER]) != c:
                    continue
                w, d, h = _rotated(instance.dims[b], int(pl[PLACE_ROT]), cfg)
                x, y, z = (int(pl[PLACE_X]), int(pl[PLACE_Y]),
                           int(pl[PLACE_Z]))
                if three_d:
                    _draw_block_3d(ax, x, y, z, w, d, h, cols[b])
                else:
                    ax.add_patch(Rectangle((x, z), w, h, facecolor=cols[b],
                                           edgecolor="k", linewidth=0.6))
            if three_d:
                ax.set_xlim(0, cfg.target_width)
                ax.set_ylim(0, max(cfg.target_depth, 1))
                ax.set_zlim(0, cfg.container_height * 1.5)
            else:
                ax.set_xlim(0, cfg.target_width)
                ax.set_ylim(0, cfg.container_height * 1.5)
                ax.set_aspect("equal")

    anim = FuncAnimation(fig, draw, frames=len(frames))
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def render(instance: Instance, state: EnvState, cfg: TAPConfig,
           path: Optional[str] = None, title: str = "",
           blocks_3d: bool = True):
    """`render_2d` for 2D configs; `render_3d_blocks` (or, with
    `blocks_3d=False`, `render_3d`) for 3D ones."""
    if cfg.dim == 2:
        return render_2d(instance, state, cfg, path, title)
    if blocks_3d:
        return render_3d_blocks(instance, state, cfg, path, title)
    return render_3d(instance, state, cfg, path, title)


def render_sequence(instance: Instance, actions: Sequence[int],
                    cfg: TAPConfig, path: str):
    """Replay a trajectory, one panel per placement (2D rects / 3D voxels)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    instance = _host(instance, 2)
    steps, frames = _replay(instance, actions, cfg)
    frames = frames[1:]
    k = max(len(frames), 1)
    three_d = cfg.dim == 3
    fig = plt.figure(figsize=(3 * k, 3.5))
    cols = _colors(int(instance.n_total))
    for i, st in enumerate(frames):
        b, r, c = cfg.decompose_action(steps[i])
        ax = fig.add_subplot(1, k, 1 + i,
                             projection="3d" if three_d else None)
        ax.set_title(f"t={i}: block {int(b)}" + (" rot" if r else ""),
                     fontsize=9)
        for bb in range(int(instance.n_total)):
            pl = st.placements[bb]
            if pl[PLACE_CONTAINER] < 0:
                continue
            w, d, h = _rotated(instance.dims[bb], int(pl[PLACE_ROT]), cfg)
            x, y, z = int(pl[PLACE_X]), int(pl[PLACE_Y]), int(pl[PLACE_Z])
            if three_d:
                _draw_block_3d(ax, x, y, z, w, d, h, cols[bb])
            else:
                ax.add_patch(Rectangle((x, z), w, h, facecolor=cols[bb],
                                       edgecolor="k", linewidth=0.6))
        if three_d:
            ax.set_xlim(0, cfg.target_width)
            ax.set_ylim(0, max(cfg.target_depth, 1))
            ax.set_zlim(0, cfg.container_height * 1.5)
        else:
            ax.set_xlim(0, cfg.target_width)
            ax.set_ylim(0, cfg.container_height * 1.5)
            ax.set_aspect("equal")
            ax.set_xticks([])
            ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
