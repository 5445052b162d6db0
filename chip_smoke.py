#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `tapnet_torch/csrc/` (one nvcc per
source, all started at once), then runs, and fails on the first fault:

1. device: the card's name and power limit (nvidia-smi); TF32 off, and
   bf16 products reduced in f32 (no reduced-precision reduction);
2. select_step (K1) vs its plain version: greedy rollouts of 2d-basic at
   batch 4096 and 2d-rot, 3d-basic, multi-container at batch 512 (plus
   2d-basic at a ragged batch of 100 and a capped lb-hard 2D config), every
   step through both on the same scores; every integer output equal;
3. actor_select_step (K2) vs its plain version: sampled rollouts of the same
   configs (less the capped one) at hidden 128, every step through both
   modes and the full plain version on the same inputs: the full mode's
   integer outputs equal, logits and logp within 1e-5; the main path's
   mode (live columns, no logits) integer outputs equal, logp within 1e-5;
4. the main path: `tapnet_torch.pack()` on 2d-basic, hidden 128, seeded
   weights: greedy and sample at batch 4096, best-of-16 on 256 instances;
   every instance complete, heightmaps replayed from the placements,
   rewards in (0, 3], the launch counters up by N per rollout, and a small
   batch agreeing with the CPU reference path;
5. times (CUDA events, median of 25): each kernel per launch, its plain
   version (K2: both modes, the live columns of the timed step, the bound
   over them and the all-token bound beside it), the registers, stack and
   spills of K1, K2 and K4 from ptxas, and a whole pack() per policy;
6. heightmap_reductions (K3's reductions alone) vs its plain version,
   bit-equal, on the final heightmaps of sampled rollouts (2d-basic at
   batch 4096, 3d-basic and multi-container at 512) and on all-zero
   heightmaps;
7. replay_logp forward and backward (K5) vs their plain versions on the
   card's own rollout records: 2d-basic at 4096, 2d-rot, 3d-basic,
   multi-container and multi-container-capped at 512, 2d-basic at a
   ragged 100, a padded 8-block config at temperature 0.7, a 3D and a 2D
   config with 4 containers at 512; values within
   1e-5 relative, every gradient within 5e-5 of the plain result's max
   magnitude (sums over instances in another order); two backward
   launches bit-identical; the forward against the rollout's own logp
   (the train step's primal) within the same value tolerance;
8. the train path: `init_train_state` + `make_train_step` on 2d-basic at
   hidden 128 and batch 4096 for 5 steps, the launch counts per step
   (actor_select_step 10, replay backward 1, heightmap_reductions 1 (the
   whole reward in one launch), replay forward 0) and finite metrics; one step repeated from a copy of
   the state bit for bit; a step at batch 256 against the CPU reference
   path; `train()` for 2 epochs x 5 steps with metrics and checkpoints, and
   a resume from the epoch-1 checkpoint ending on the same params;
9. times: K3 and K5 per launch with their plain versions (K3 also against
   amax + sum; K5's bound over its live columns, the all-token bound
   beside it), and the whole train step (host clock, median of 10);
10. fused_rollout_batch (K4) vs its plain version, bit-equal on every state
   field, the actions and the rewards, for `first` and `random`: the six
   CONFIGS (2d-rolling too: 50 blocks, window 10, ragged block counts) and
   one case per remaining branch (lb-hard with rotation, two containers
   uncapped, a tight cap that strands blocks, capped with 2 and 3
   containers, 3D capped, a 3D target 20 cells deep under a cap, a 3D
   rolling window, five mcs cases) at batch
   512, 2d-basic at a ragged 100 and at 4096;
11. select_step (K1) and actor_select_step (K2, both modes) under the mcs
   placement rule vs their plain versions, lockstep rollouts as in 2 and
   3, on a 2D mcs-soft and a 3D two-container mcs-hard config at batch
   512;
12. the heuristic main path: `pack(policy="first")` and `pack("random")` on
   each of the six CONFIGS at batch 4096: one K4 and one K3 launch per
   call, plans complete (or, under a cap, every unpacked block a no-op
   step), heightmaps replayed from the placements; then a repeated call
   bit-identical, the card against the `device="cpu"` path on every field
   at batch 256, and `evaluate(baselines=True)` against the CPU path;
13. times: K4 per launch for `random` on each of the six CONFIGS at batch
   4096 with the plain version beside it, and `pack(first)` /
   `pack(random)` on 2d-basic (host clock, median of 20);
14. actor_select_step (K2, both modes) with a rolling window and two
   precedence limbs vs its plain version, lockstep rollouts as in 3:
   2d-rolling (50 blocks,
   window 10), a 12-block window-4 config with rotation, a 34-block
   window-6 config (two limbs) and a 3D window config, at batch 512 and a
   ragged 100, 2d-rolling also at 4096;
15. the step-grid replay (K5f-steps, K5b-steps) vs its plain version on the
   same configs' records and a 4-container window config (tolerances of
   7), forced onto 2d-basic at 4096
   against the monolithic kernels, against the rollout's own logp, and two
   backward launches bit-identical;
16. the rolling main path, 2d-rolling at hidden 128: `pack()` greedy and
   sample at 4096, best-of-16 on 256 (K1 x50 per greedy call, K2 x50 per
   sampled one), plans complete and replayed, card vs CPU at 256; 3 train
   steps at batch 4096 (per step K2 50, K5b-steps 1, K3 1, no forward
   replay), a bit-identical repeat, a step at batch 64 against the CPU path,
   `train()` for 2 epochs x 2 steps with a resume; then one train step of
   multi-container-capped at batch 256 (K1 x10, K5b x1 on the recorded mask,
   K3 x1) against the CPU path;
17. times at 2d-rolling, batch 4096: K2 per launch (both modes, as in 5),
   K1 per launch (also at the capped train step's shape,
   multi-container-capped at batch 256, each after a lockstep greedy
   rollout against its plain version), K5f-steps and K5b-steps per call,
   each with its plain version and its
   bound counted over the (instance, step) pairs that have an action in
   this run (the token work over the live columns only, whose share it
   prints; the all-token bound beside it); `pack()` per policy and the
   train step (host clock);
18. past a kernel's coverage, the fallbacks the routers pick
   (`train.rollout.routes`) on the card: 2 train steps of 2d-basic at
   hidden 544 (past the widest width K2 and K5 take, 512), batch 256 (K1
   x10 and K3 x1 per step, no K2, no K5: the general replay) and a step
   against the CPU path; sampled pack() at hidden 544 (K1 x10) against the
   CPU path;
   pack(first/random) on a 17 x 16 3D target (no K4) equal to the CPU
   path; and K2, K5b, K1 and K4
   called directly outside their coverage raise NotImplementedError;
19. K1 and K4 where a split-and-join placement can go wrong (the configs
   of tests/test_torch_place_edges.py: duplicate score rows and equal
   landing heights, lb-hard with and without a stable offset, mcs ties,
   a 16 x 16 target with 8 containers, where K4 keeps its heightmaps out of
   shared memory, 62 blocks under a window, 16 (rotation, container) pairs
   under a cap, a tight cap) at batch 37 and 512: bit-equal to their plain
   versions and two launches bit-identical;
20. the whole C/P/S reward in one launch (`reward_kernel`, K3 redesigned)
   vs its plain version on the same tensors, bit-equal on maxh, under, the
   five terms and the reward: the pack(first/random) plans of the six
   CONFIGS at batch 4096, zero heightmaps and a capped plan that strands
   blocks; then its time, its plain version's, amax + sum, and the
   launches and device time per call of the fused launch and of the path it
   replaced (the reductions, then the composition as PyTorch ops);
21. `make_train_step(steps_per_call=k)` as a CUDA graph: 2d-basic at batch
   4096 (k = 8), 2d-rolling at 4096 (k = 4), multi-container-capped at 256
   (k = 4, the K1 route) and 2d-basic at hidden 544, batch 256 (k = 2, the
   fallback route): one step captured and replayed k times, the launches
   counted by the capture (1 x the per-step counts; the eager warm-up step
   on a copy the same), none counted by a call of k replays, one call
   bit-identical to
   k single steps (params, Adam state, key, metrics), a deterministic
   repeat, and the wall ms per step with the device's idle share at k and
   at 1; then `train()` with `steps_per_call=2` at batch 256: epoch lines
   at the JAX trainer's step numbers and an exact resume;
22. driver config 5, mixed 2D/3D batches (multi-container, hidden 128,
   p2d 0.5): `sample_batch_mixed` at batch 4096 on the card == on the CPU
   (flat blocks one cell deep at y = 0, volumes conserved); K1, K2 (both
   modes), K5f/K5b, K4 (first, random) and the one-launch reward against
   their plain versions on mixed batches (512 and a ragged 100, p2d 0.5
   and 1.0, and a two-container mcs config), as phases 2, 3, 7, 10, 20;
   3 mixed train steps at batch 4096 (K2 10, K5b 1, K3 1 per step), a
   bit-identical repeat, a step at 256 against the CPU path, and
   `steps_per_call=4` as a graph (phase 21's checks, the wall ms per step
   and idle share at k = 4 and 1); `evaluate(mixed_p2d, baselines=True)`
   at 4096 with the launches the routes imply (K1 10, K4 2, K3 2), at 256
   against the CPU path; `python -m tapnet_torch.cli` train (steps per
   call 2, a trace, nan checks; epoch lines at the JAX trainer's steps
   with its keys), eval (one JSON line) and generate (the file equal to
   sample_batch on the CPU chunk by chunk, the instances per second), a
   from_dataset step at 4096 fed by PackDataset over that file;
   `train(nan_checks=True)` on a NaN parameter raising
   FloatingPointError naming it; K1, K2, K4 and K5b per launch on mixed
   and on 3D-only batches at 4096, each held against its plain version on
   the same operands there (K1, K4 bit-equal, K2 within TOL, K5b within
   GRAD_TOL), and K3's reductions and the one-launch reward bit-equal at
   4096 on a mixed batch (a sampled rollout's final state, pack
   first/random);
23. the benchmark entry point and data parallelism: `python -m
   tapnet_torch.benchmarks` (its `main()`) at 2d-basic, batch 4096: the
   headline record with the oracle and native baselines measured, the
   device anchors present, positive and no larger than the unprofiled
   wall time per call of the timed windows (within ANCHOR_OVER_WALL),
   vs_baseline finite, and the launches of every kernel it ran; the
   benchmark's grouped call (one CUDA graph of 16 K4 rollouts) against
   the same rollouts run eagerly with the same keys, checksums bit-equal,
   and both timed; `python -m tapnet_torch.cli bench` as a subprocess; a
   world-1 NCCL mesh (`parallel.data_mesh`) train step at batch 4096
   bit-equal to the unsharded step from the same state over 3 steps
   (launches K2 10, K5b 1, K3 1 a step) and over one call at
   steps_per_call=4 (the gradient and metrics all-reduces captured in the
   graph), with the wall ms per step of both; where two cards are visible,
   two NCCL ranks against one process within the tier-2 tolerances (one
   card: logged, no scaling number);
24. the bf16 compute dtype (`make_train_step(compute_dtype=bfloat16)`, the
   JAX train step's accelerator dtype): K2's bf16 instantiation (both
   modes; its products on the tensor cores) against its plain bf16 version
   in lockstep sampled rollouts (2d-basic at 4096, 2d-rolling at 512 and
   4096, multi-container at 512): logits within 1e-2 + 2^-7 |logit|, flags
   and mask equal, actions agreeing on > 0.99 of the (instance, step)
   pairs and, where they agree, the state rows equal and logp within the
   logit tolerance, every output but the logits alike in the two modes,
   two launches of each mode bit-identical; the same checks where the
   tiling can break (`actor_bf16_shapes`: hidden 32, 64, 96 at 2d-basic,
   batch 256; a ragged batch of 100; multi-container at temperature 0.7,
   batch 256) and `ops.actor_step.smem_bytes` against the kernel's own
   plan (`tapnet_actor_smem_bytes`) for the six CONFIGS, every hidden
   width 32-256, both dtypes; K5f, K5b,
   K5f-steps and K5b-steps in bf16 against their plain bf16 versions on
   the card's own bf16 records (2d-basic at 4096, multi-container at 512,
   2d-rolling at 4096): values within 1e-2 relative, also against the
   rollout's own logp, every gradient within BF16_GRAD_TOL of the plain
   result's max magnitude, two backward launches bit-identical; the same
   checks of both schedules (the step grid forced onto monolithic configs)
   where the tensor-core tiling of the bf16 body can break
   (`replay_bf16_shapes`: hidden 32, 64, 96 at 2d-basic, batch 256; a
   ragged batch of 100; multi-container at temperature 0.7 and a mixed
   p2d 0.5 batch of 512; multi-container-capped at 256 on its own K1
   record), with the largest scaled gradient error over all of them, and
   `ops.replay.smem_bytes` against the kernel's own plan
   (`tapnet_replay_smem_bytes`) for the six CONFIGS, every hidden width
   32-256, both kernels, schedules and dtypes; the bf16 backward's
   deferred contractions alone (`ops.replay.grad_outer_bf16`, wgmma) on
   the records of real bf16 backwards (`kept_backward`) at hidden 32, 96
   and 128 on `GO_CASES` and at batch 4096 on 2d-basic and 2d-rolling,
   each within GRAD_TOL of its plain version, two launches bit-identical
   and equal to the backward's own launch; the bf16
   train step at
   2d-basic, hidden 128, batch 4096: 5 steps with K2 10, K5b 1, K3 1 and no
   K5f a step, finite metrics, a bit-identical repeat, a step at batch 256
   against the CPU bf16 path (scripts/tpu_parity.py's gate: actions agree on
   > 0.9, mean rewards within 0.02; reward, C, P, S within 0.02, loss_critic
   within 10%), steps_per_call=8 as a graph bit-equal to 8 eager bf16 steps
   (phase 21's checks), 3 bf16 steps of 2d-rolling (K2 50, K5b-steps 1, K3
   1 a step), `grad_outer_bf16` launched once a step in both (counted
   where csrc/replay.cu launches it); times: `grad_outer_bf16` alone at
   4096 with its plain version and its bound (the records' bytes against
   its hi and lo products at the dense bf16 peak), and K2's main-path mode (2d-basic and 2d-rolling) and
   K5f/K5b, K5f-steps/K5b-steps per launch in bf16 and f32 on the same
   inputs in turns, their plain bf16
   versions and bf16 bounds (bytes at each operand's width; the products at
   the dense bf16 tensor-core peak, the rest at the f32 rate), and the f32
   and bf16 train steps at 2d-basic k = 8 and 2d-rolling k = 4 (host clock
   and `utils.profiling.device_time_ms`, in turns). `chip_smoke.phase_24(
   dev)` runs it alone after `ops._build.build_all()`;
25. the JAX package's last modules: `env.core.rollout` (one instance) on
   the card for the six CONFIGS x {first, random}, 3 seeds each,
   bit-equal to the same call on the CPU and to its `rollout_batch` row;
   `python -m tapnet_torch.cli render` (2d-rot to a PNG, 3d-basic
   `--sequence` to a GIF): the files' magic and sizes where matplotlib
   imports, else the JAX package's ModuleNotFoundError (which case held
   and the matplotlib / tensorboard versions are logged); `train()` with
   `tb_dir` (2d-basic, batch 256, 2 x 2 steps): the events file reads back
   to the JSONL's (tag, step, value) triples; tensor parallelism on a
   world-1 NCCL group, `data_model_mesh(1, 1)` and `shard_params_tp` on a
   hidden-128 actor, its forward at batch 4096 bit-equal to the
   replicated one, the spec tree logged. `chip_smoke.phase_25(dev)` runs
   it alone after `ops._build.build_all()`;
26. K2 and K5 at hidden widths above 128 (K5's head in two passes of 16
   instances; K2's products once over the tile on the weight ring, its
   query's step-invariant part made once per rollout by `query_parts`):
   the routers take them at hidden 256 on
   2d-basic and 2d-rolling; at hidden 160, 192, 224 and 256 K2 (both
   modes, both dtypes) and K5 (K5f/K5b where the config is monolithic,
   K5f-steps/K5b-steps always, both dtypes) against their plain versions
   on `wide_shapes` (2d-basic at 512, a ragged 100, multi-container at
   temperature 0.7; 2d-rolling at 512 at hidden 160 and 256) at the
   tolerances of phases 3, 7, 15 and 24, backward repeats bit-identical
   (the float32 replay above 128: 3xTF32 products and `grad_outer_tf32`;
   the bfloat16 one: the weight ring, `csrc/ring_bf16.cuh`);
   `ops.replay.smem_bytes` and `record_floats` against the kernel's
   exports; `query_parts` (the tensor cores; 3xTF32 in float32) against
   its plain version at every width on 2d-basic and 2d-rolling, a ragged
   batch of 100 and BASELINE.json config 5 (multi-container mixed) in both
   dtypes, repeats bit-identical; the replay backward's helpers alone
   (`ops.replay.grad_outer_tf32`, `grad_outer_bf16`, `reduce_tiles`) on
   the operands of real backward launches (`kept_backward`):
   `grad_outer_tf32` (wgmma 3xTF32) and `grad_outer_bf16` (wgmma bf16)
   at hidden 160 and 256 on `GO_CASES` and at 4096 within GRAD_TOL of
   their plain versions and equal to the backward's own launch,
   `reduce_tiles` bit for bit against its plain version and the
   backward's own sums (batch 4096, hidden 128 and 256, both dtypes,
   2d-basic and 2d-rolling, and a [chunks, 100] sum; each of its load
   widths taken, as the library counts its launches); the witness record of a rounding-decided ReLU gate
   (2d-rolling, hidden 160, batch 256, seed 10: `grad_witness`), K5b-steps
   f32 against its plain version with the gates within their rounding
   bound of 0 counted and, with the rows they feed left out, within
   GRAD_TOL; at hidden 256: pack() on
   2d-basic at 4096 (greedy K1 x10, sample and best-of-16 K2 x10, no
   select_step; `query_parts` once a rollout) and against the CPU path;
   3 f32 and 3 bf16 train steps at
   batch 4096 (K2 10, `query_parts` 1, K5b 1, K3 1 a step; the helper
   kernels' launches counted over these and the 2d-rolling steps:
   `grad_outer_tf32` 1 a f32 step, `grad_outer_bf16` 1 a bf16 step,
   `reduce_tiles` 1, 2 on the step grid), each repeated
   bit for bit, a
   step at batch 256 against the CPU path (the bf16 one under
   scripts/tpu_parity.py's gate); steps_per_call graphs (2d-basic k = 8 in
   both dtypes, 2d-rolling k = 4: phase 21's checks); a 2d-rolling train
   step in each dtype (K2 50, `query_parts` 1, K5b-steps 1, K3 1); at
   the main paths'
   shapes (batch 4096: 2d-basic, and 2d-rolling's step grid) K2 in bf16
   over a whole rollout and in f32, both modes, at its middle step, and
   K5f/K5b (2d-basic) and K5f-steps/K5b-steps (2d-rolling) in both dtypes
   on one record, each against its plain version at the same tolerances,
   on the operands they are then timed on; K2 f32, K5b bf16 and K5b-steps
   bf16 launched twice bit-identical; times at 4096 of K2's main-path
   mode (on the kernels line with the full mode's and 2d-rolling's
   beside it), of `query_parts` (both dtypes, with its plain version) and of
   `grad_outer_tf32` and `reduce_tiles` alone on a f32 backward's
   operands of 2d-basic and 2d-rolling (with `torch.sum(part, 0)` beside
   `reduce_tiles`) and of `grad_outer_bf16` on a bf16 one's, and of the
   four
   replay kernels in both dtypes, in turns, with their plain versions and
   bounds (the float32 ones also with the products at the 3xTF32 rate)
   and, beside K5b and K5b-steps, the fallback replay (`replay_logp_sum(
   kernel=False)`, forward and backward) on the same record.
   `chip_smoke.phase_26(dev)` runs it alone after
   `ops._build.build_all()`. (The train step against the fallback it
   replaced: `python -m tapnet_torch.profile_pack --train --hidden 256
   --routes kernels,fallback`.)
27. K2 and K5 at every hidden width up to 512: the kernels take the
   multiples of 32 up to 256 and of 64 up to 512 (the WX form above 256,
   csrc/geo.cuh), any other width on operands padded with zeros
   (`ops.actor_step.kernel_width`, `pad_head`). At hidden 48 (run at 64),
   288 (at 320), 384 and 512 on `wx_shapes` (2d-basic at 512,
   multi-container at temperature 0.7; at 288 and 512 also 2d-rolling and
   a ragged batch of 100): K2 (both modes, both dtypes) and K5 (all four
   schedules, forward and backward, both dtypes) against their plain
   versions under phases 3, 7, 24 and 26's TOL and GRAD_TOL, backward and
   bf16 K2 repeats bit-identical; `grad_outer_tf32` and the bf16
   `grad_outer` alone at 512 on `GO_CASES` (a block takes a row half of
   G); `query_parts` alone at 384 and 512 on `QP_CASES` (in f32 3xTF32
   with each 16 columns of K summed apart) within TOL; the plan and WX
   scratch mirrors against the kernels' own at every multiple of 32 up to 512.
   The main path at 512 and 48:
   sampled `pack()` at batch 4096 (K2 x10, `query_parts` x1 at 512, no
   select_step), one train step each of
   2d-basic and 2d-rolling at 512 in f32 and bf16 and of 2d-basic at 48,
   batch 4096, with every launch counted (K2 N, `query_parts` 1 above
   128, K5b or K5b-steps 1, K3 1 a step, the helpers' launches; no
   select_step, no general replay) and each path kernel launched;
   `python -m tapnet_torch.cli train --hidden 512` (2d-basic, batch 4096,
   4 steps), whose trace names K2's, `query_parts`' and K5's kernels and
   not K1's; `steps_per_call` graphs (phase 21's checks but for the
   profiler's breakdown, which `profile_pack` gives: 2d-basic k = 8 at 512
   in both dtypes, batch 4096; 2d-rolling k = 4 at 512 in both dtypes at
   batch 1024, for time); then at batch 4096, on the operands
   they are timed on, K2 (512 both dtypes, 48) at its middle step with a
   sampled decode step on K2's route and on the fallback's (K1 and the
   head as PyTorch ops) beside it, `query_parts` at 512, K5f/K5b
   (2d-basic, 512 and 48) and K5f-steps/K5b-steps (2d-rolling, 512) in
   both dtypes with the fallback replay beside the backward, and
   `grad_outer_tf32`, `grad_outer` and `reduce_tiles` at 512
   (`reduce_tiles` bit for bit on the f32 backwards' partial rows and
   d_ctx chunk partials), each held to its plain version and timed with
   its plain version and bound. `chip_smoke.phase_27(dev)` runs it alone
   after `ops._build.build_all()` (~100 s).

It prints the kernel table as one JSON line (each entry with its "dtype";
the bf16 instantiations as entries of their own, and the hidden-256
instantiations too, with a "hidden" key; the float32 hidden-256 replay
entries add "bound_3xtf32_ms", the backward ones "fallback_ms", and
K5b-steps' the witness record's "witness"; the float32 K2 and
`query_parts` entries above hidden 128 add "bound_3xtf32_ms" too (at
512 also "f32_rate_bound_ms"), and their "bound_ms" is the lower of
that and the bound at the plain f32 rate;
`query_parts`' "library_ms" is two torch.mm; `grad_outer_tf32`,
`grad_outer` (bfloat16; also a hidden-128 entry from phase 24) and
`reduce_tiles` are hidden-256 entries with 2d-rolling's figures beside
2d-basic's, `reduce_tiles`' "library_ms" `torch.sum(part, 0)`; phase 27
adds entries with "hidden" 512 and 48 (and "kernel_width" where the
kernel ran on padded operands), K2's with "fallback_ms" and
"kernel_route_ms", a sampled decode step on the fallback's route and on
K2's, the backward replays' with the fallback replay's "fallback_ms"),
then the nvidia-smi line,
then `{"ok": true, "device": {...}}` as the last line. Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
HIDDEN = 128
REPS = 25
TOL = 1e-5            # logits / logp, kernel vs plain (accumulation order)
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (data sheet)
F32_OPS_S = 67e12      # H100 SXM f32 outside the tensor cores (data sheet)
BF16_TC_OPS_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
TF32X3_OPS_S = 495e12 / 3  # 3xTF32: three dense TF32 passes a product
# int32 adds, compares and max: the data sheet's f32 rate counts 2 operations
# per FMA on 128 lanes per SM; integer instructions run on 64 lanes per SM
# and count 1 each (132 SMs x 64 lanes x 1.98 GHz)
I32_OPS_S = F32_OPS_S / 4
B_MAIN = 4096          # the main paths' batch
# device anchor / unprofiled wall per call at most: the profiler stretches
# kernels, up to 1.5% read on the saturated K4 graph of the headline
ANCHOR_OVER_WALL = 1.03


_T0 = time.perf_counter()


def log(msg):
    """A line of the run, stamped with the seconds since the script's
    start (where a later change must cut the run's time)."""
    print(f"[{time.perf_counter() - _T0:6.0f} s] {msg}", flush=True)


# ------------------------------------------------------------------ #
# phases 2 and 3: kernels vs plain versions, lockstep rollouts

def _instances(cfg, B, dev, seed, p2d=0.0):
    """B instances from key(seed); with p2d > 0 a mixed 2D/3D batch."""
    from tapnet_torch import random as R
    from tapnet_torch.env.sampler import sample_batch, sample_batch_mixed
    if p2d > 0:
        return sample_batch_mixed(R.key(seed, dev), B, cfg, p2d)
    return sample_batch(R.key(seed, dev), B, cfg)


def _equal(name, got, want):
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"{name}: {bad} of {got.numel()} differ")


def check_select_step(cfg, B, actor, dev, keep=None, p2d=0.0):
    """Greedy rollout; at every step select_step and select_place_ref get
    the same scores and state and must agree on every output. Returns the
    operands of the middle step when `keep` is set (for timing)."""
    from tapnet_torch.models.features import dynamic_flags, static_tokens
    from tapnet_torch.ops import policy_step as PS
    from tapnet_torch.train import rollout as RO
    from tapnet_torch.types import EnvState

    inst = _instances(cfg, B, dev, SEED + 1, p2d)
    static = static_tokens(inst, cfg)
    kept = None
    with torch.no_grad():
        se = actor.embed_static(static)
        (dw, dd, dh), packed, hm, plc = RO._batch_last(inst, cfg)
        prev = torch.full((B,), -1, dtype=torch.int32, device=dev)
        for t in range(cfg.num_blocks):
            hm_b = RO._hm_batch_major(hm, cfg)
            flags = dynamic_flags(inst, packed.T.bool(), cfg)
            mask = RO._step_mask(flags, EnvState(hm_b, packed.T.bool(), None,
                                                 None), inst, cfg)
            logits = RO._head_logits(actor, static, se, flags, hm_b, prev,
                                     t, cfg)
            score = RO._masked_logits(logits, mask, 1.0).T.contiguous()
            ops = (score, mask.T.int().contiguous(), packed, hm, plc,
                   dw, dd, dh)
            if keep and t == cfg.num_blocks // 2:
                kept = ops
            got = PS.select_step(*ops, cfg=cfg)
            want = PS.select_place_ref(cfg, *ops)
            for name, g, w in zip(("packed", "hm", "plc", "act"), got, want):
                _equal(f"select_step {name} step {t}", g, w)
            packed, hm, plc, prev = got
    if cfg.target_height == 0 and not bool(packed.bool().all()):
        raise AssertionError("select_step rollout left blocks unpacked")
    return kept


def actor_operands(actor, inst, cfg, keys, dtype=torch.float32):
    """Per-rollout operands of actor_select_step (as the rollout builds),
    the float ones in the compute dtype `dtype`; at a hidden width the
    kernel does not take, se, ctx and the head operands padded with zeros
    to `kernel_width` (`pad_head`), as the rollout pads them."""
    from tapnet_torch.models.features import static_tokens
    from tapnet_torch.models.tapnet import embed_static_T
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.train import rollout as RO

    B = inst.dims.shape[0]
    T = cfg.num_blocks * cfg.num_rot
    static = static_tokens(inst, cfg)
    static_t4 = static.permute(2, 1, 0).reshape(4, T * B)
    se_htb = embed_static_T(actor, static_t4, dtype).reshape(-1, T, B)
    upm, rotm = AS.precedence_bitmasks(inst, cfg)
    g_all = RO._gumbel_all(keys, cfg).transpose(1, 2).contiguous()
    hk = AS.kernel_width(actor.hidden)
    o = dict(se=AS.pad_hidden(se_htb.permute(2, 1, 0), hk, 2).contiguous(),
             ctx=AS.pad_hidden(se_htb.mean(1), hk, 0).contiguous(),
             statp=static_t4.to(dtype).reshape(4, T, B).contiguous(),
             statm=static.to(dtype).mean(1).T.contiguous(), upm=upm,
             rotm=rotm, fits=AS.fits_planes(inst, cfg),
             params=AS.pad_head(AS.head_operands(actor, cfg, dtype), hk),
             g_all=g_all)
    o["params_t"] = AS.transposed(o["params"])
    return o


def hold_k2(ops, cfg, temperature, params_t, at):
    """Both modes of K2 in float32 on one step's operands against the full
    plain version: the full mode's integer outputs equal, logits and logp
    within TOL; the main path's mode (logits=False, live columns): integer
    outputs equal to the full plain version's, logp within TOL. `at` names
    the step in a failure. Returns (the main-path mode's outputs, the max
    logit/logp error)."""
    from tapnet_torch.ops import actor_step as AS

    names = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    want = AS.actor_select_step_ref(*ops, cfg, temperature)
    err = 0.0
    for logits in (True, False):
        got = AS.actor_select_step(*ops, cfg, temperature, logits=logits,
                                   params_t=params_t)
        what = f"actor_select_step(logits={logits})"
        for name, g, w in zip(names, got, want):
            if name == "logits" and not logits:
                if g is not None:
                    raise AssertionError(f"{what} returned logits")
            elif name in ("logits", "logp"):
                d = (g - w).abs()
                lim = TOL + TOL * w.abs()
                if not bool((d <= lim).all()):
                    raise AssertionError(
                        f"{what} {name} {at}: max err {d.max().item()}")
                err = max(err, d.max().item())
            else:
                _equal(f"{what} {name} {at}", g, w)
    return got, err


def check_actor_step(cfg, B, actor, dev, keep=None, p2d=0.0,
                     temperature=1.0):
    """Sampled rollout at `temperature`; at every step both modes of
    actor_select_step and the full plain version get the same inputs
    (`hold_k2`). The rollout advances on the main-path mode's outputs.
    Returns the middle step's operands when `keep` is set and the max
    logit/logp error."""
    from tapnet_torch import random as R
    from tapnet_torch.train import rollout as RO

    N = cfg.num_blocks
    inst = _instances(cfg, B, dev, SEED + 2, p2d)
    kept, err = None, 0.0
    with torch.no_grad():
        o = actor_operands(actor, inst, cfg, R.split(R.key(SEED + 3, dev), B))
        (dw, dd, dh), packed, hm, plc = RO._batch_last(inst, cfg)
        prev = torch.full((1, B), -1, dtype=torch.int32, device=dev)
        for t in range(N):
            tf = torch.full((1, 1), t, dtype=torch.float32, device=dev) / N
            ops = (tf, packed, hm, plc, prev, dw, dd, dh, o["upm"],
                   o["rotm"], o["fits"], o["g_all"][t], o["se"], o["ctx"],
                   o["statp"], o["statm"], o["params"])
            if keep and t == N // 2:
                kept = ops
            got, e = hold_k2(ops, cfg, temperature, o["params_t"],
                             f"step {t}")
            err = max(err, e)
            packed, hm, plc, prev = got[0], got[1], got[2], got[3][None]
    return kept, err


# ------------------------------------------------------------------ #
# phase 4: the main path

def replay_heightmaps(plan, dims, cfg):
    """Rebuild each heightmap from the plan's placements in transport order;
    every block must land on the footprint's maximum. dims int[B, N, 3]."""
    B = len(plan)
    C, W, D = cfg.num_containers, cfg.target_width, cfg.target_depth
    hm = np.zeros((B, C, W, D), np.int64)
    bi = np.arange(B)
    xs = np.arange(W)[None, :, None]
    ys = np.arange(D)[None, None, :]
    for a in plan.actions.T:
        live = a >= 0
        blk = np.maximum(a, 0) // (cfg.num_rot * C)
        c, r, x, y, z, _ = plan.states.placements[bi, blk].T
        d = dims[bi, blk]
        if cfg.dim == 2:
            w, dd, h = (np.where(r == 1, d[:, 2], d[:, 0]), d[:, 1],
                        np.where(r == 1, d[:, 0], d[:, 2]))
        else:
            w, dd, h = (np.where(r == 1, d[:, 1], d[:, 0]),
                        np.where(r == 1, d[:, 0], d[:, 1]), d[:, 2])
        fp = ((xs >= x[:, None, None]) & (xs < (x + w)[:, None, None])
              & (ys >= y[:, None, None]) & (ys < (y + dd)[:, None, None]))
        cur = hm[bi, c]
        land = np.where(fp, cur, 0).max(axis=(1, 2))
        if not np.array_equal(land[live], z[live]):
            raise AssertionError("a block does not land on its footprint")
        new = np.where(fp & live[:, None, None], (z + h)[:, None, None], cur)
        hm[bi, c] = new
    if not np.array_equal(hm, plan.states.heightmap):
        raise AssertionError("heightmaps disagree with the placements")


def check_plan(plan, inst, cfg, name):
    B = len(plan)
    if not all(plan.complete(i) for i in range(B)):
        raise AssertionError(f"{name}: incomplete plans")
    r = plan.rewards
    if not (np.isfinite(r).all() and (r > 0).all() and (r <= 3).all()):
        raise AssertionError(f"{name}: rewards outside (0, 3]")
    replay_heightmaps(plan, inst.dims.cpu().numpy(), cfg)
    log(f"  {name}: B={B} complete, heightmaps replayed, reward mean "
        f"{r.mean():.6f} min {r.min():.6f} max {r.max():.6f}")


def main_path(cfg, actor, dev):
    """pack() greedy / sample at 4096, best-of-16 on 256; returns the
    launch counts of the run and the plans."""
    from tapnet_torch import pack
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import policy_step as PS

    N = cfg.num_blocks
    wide = int(actor.v.numel() > 128)  # query_parts: once per rollout
    inst = _instances(cfg, 4096, dev, SEED + 4)
    best_inst = inst.index(slice(0, 256))
    counters = (PS.select_step, AS.actor_select_step, AS.query_parts)
    for f in counters:
        f.launches = 0
    runs = {}
    for policy, x, want in (("greedy", inst, (N, 0, 0)),
                            ("sample", inst, (0, N, wide)),
                            ("best", best_inst, (0, N, wide))):
        before = [f.launches for f in counters]
        plan = pack(x, cfg, actor, policy=policy, key=SEED + 5,
                    n_samples=16)
        got = tuple(f.launches - b for f, b in zip(counters, before))
        if got != want:
            raise AssertionError(f"pack({policy}) launches "
                                 f"(select_step, actor_select_step, "
                                 f"query_parts) = {got}, expected {want}")
        runs[policy] = (plan, x)
    launches = {"select_step": PS.select_step.launches,
                "actor_select_step": AS.actor_select_step.launches,
                "query_parts": AS.query_parts.launches}
    for policy, (plan, x) in runs.items():
        check_plan(plan, x, cfg, f"pack({policy})")
    return launches, inst


def check_against_cpu(cfg, actor, inst, dev):
    """A small batch: the card's kernel paths vs the CPU reference path."""
    from tapnet_torch import pack

    small = inst.index(slice(0, 256))
    actor_cpu = type(actor)(cfg, actor.hidden)
    actor_cpu.load_state_dict({k: v.cpu() for k, v in
                               actor.state_dict().items()})
    out = {}
    for policy in ("greedy", "sample"):
        a = pack(small, cfg, actor, policy=policy, key=SEED + 6)
        b = pack(small.to("cpu"), cfg, actor_cpu, policy=policy,
                 key=SEED + 6, device="cpu")
        same = (a.actions == b.actions).all(axis=1)
        frac = float(same.mean())
        if frac < 0.95:
            raise AssertionError(f"pack({policy}) card vs CPU: only {frac} "
                                 "of the trajectories agree")
        if not np.allclose(a.rewards[same], b.rewards[same], atol=1e-6):
            raise AssertionError(f"pack({policy}) rewards differ")
        out[policy] = frac
        log(f"  pack({policy}) B=256 card vs CPU reference: {frac:.4f} of "
            "trajectories equal, their rewards within 1e-6")
    return out


# ------------------------------------------------------------------ #
# phase 5: times

def time_gpu(fn, reps=REPS, sleep_cycles=2_000_000, warm=3):
    """Median device time of fn() in ms. Each rep first queues a spin kernel
    so the host has enqueued fn's launches before the start event runs:
    the event pair then brackets device time, not host overhead."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_host(fn, reps=REPS):
    """Median wall time of fn() ending in a synchronize, ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def time_select_step(ops, cfg):
    """K1 on one step's operands and its plain version (CUDA events), the
    bytes the step must move and its byte bound, the max difference."""
    from tapnet_torch.ops import policy_step as PS
    ms = time_gpu(lambda: PS.select_step(*ops, cfg=cfg))
    plain = time_gpu(lambda: PS.select_place_ref(cfg, *ops),
                     sleep_cycles=50_000_000)
    out = PS.select_step(*ops, cfg=cfg)
    err = max((g - w).abs().max().item()
              for g, w in zip(out, PS.select_place_ref(cfg, *ops)))
    moved = nbytes(ops) + nbytes(out)
    return {"ms": ms, "plain_ms": plain, "bytes": moved,
            "bound": 1e3 * moved / HBM_BYTES_S, "err": err}


def log_select_times(tag, name, B, k):
    log(f"{tag} select_step {name} B={B}: {k['ms']:.4f} ms/launch (plain "
        f"{k['plain_ms']:.4f}), {k['bytes']} B moved, bound "
        f"{k['bound']:.5f} ms (bytes)")


def actor_ops_split(cfg, B, h, tokens=None):
    """(products, elementwise): the operations of one actor_select_step on
    B instances, 2 per multiply-add of every matrix-vector product, and the
    tanh, the +v and the score adds of the attention (4 per (token,
    container, unit)). `tokens`: the (instance, token) columns to count for
    the token work instead of B * T (the live columns of the main path's
    mode). Above hidden 128 a step's query multiplies only Wq's enc and
    dsum columns (K = h + 8): the rest is `query_parts`' once a rollout."""
    N, R, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    WD, T = cfg.target_width * cfg.target_depth, N * R
    tokens = B * T if tokens is None else tokens
    fq = h + 8 if h > 128 else 3 * h + 8
    enc = C * (h * (WD + 2) + h * h + h * fq)
    return (2 * B * enc + tokens * 2 * (32 * 8 + 32 * h),
            tokens * C * h * 4)


def actor_ops_count(cfg, B, h, tokens=None):
    """f32 operations of one actor_select_step (`actor_ops_split`)."""
    return sum(actor_ops_split(cfg, B, h, tokens))


def actor_tf32x3_ops_ms(cfg, B, h, tokens=None):
    """The least time of a float32 actor_select_step's operations above
    hidden 128 (`actor_ops_split`), where W2 e1 and Wq' [enc, dsum] run as
    3xTF32 at TF32X3_OPS_S and W1 feats, the token work and the
    elementwise at F32_OPS_S."""
    gemm, elem = actor_ops_split(cfg, B, h, tokens)
    tc = 2 * B * cfg.num_containers * (h * h + h * (h + 8))
    return 1e3 * (tc / TF32X3_OPS_S + (gemm - tc + elem) / F32_OPS_S)


def ops_ms(split, dtype):
    """The least time of (products, elementwise) operations on the card:
    in float32 all at F32_OPS_S; in bfloat16 the products at the dense
    bf16 tensor-core peak (BF16_TC_OPS_S) and the rest at F32_OPS_S."""
    gemm, elem = split
    if dtype == torch.bfloat16:
        return 1e3 * (gemm / BF16_TC_OPS_S + elem / F32_OPS_S)
    return 1e3 * (gemm + elem) / F32_OPS_S


def time_actor_step(ops, cfg, h, plain_reps=REPS, plain_sleep=100_000_000):
    """Both modes of K2 on one step's operands (CUDA events) and the full
    plain version; the bound of the main path's mode counted over its
    acting instances and live columns (bytes: every operand but the keys
    and the gumbel rows, the keys of the live columns, the gumbel of the
    valid actions, the outputs), the all-token bound beside it. Returns a
    dict."""
    from tapnet_torch.ops import actor_step as AS

    # as the decode loop: once per rollout
    pt = AS.transposed(ops[16])
    wide = AS.wide_operands(ops[16], ops[13], cfg)
    ms = time_gpu(lambda: AS.actor_select_step(*ops, cfg, logits=False,
                                               params_t=pt, wide=wide))
    full = time_gpu(lambda: AS.actor_select_step(*ops, cfg, params_t=pt,
                                                 wide=wide))
    plain = time_gpu(lambda: AS.actor_select_step_ref(*ops, cfg),
                     reps=plain_reps, sleep_cycles=plain_sleep)
    out = AS.actor_select_step(*ops, cfg, logits=False, params_t=pt,
                               wide=wide)
    out_full = AS.actor_select_step(*ops, cfg, params_t=pt, wide=wide)
    B = ops[1].shape[1]
    b, _ = AS.live_columns(out[5], cfg)
    cols = int(b.numel())
    acting = int((out[3] >= 0).sum())
    valid = int((out[5] == 1).sum())
    se, g = ops[12], ops[11]
    dt = se.dtype
    # above hidden 128 the step reads the query's parts in place of ctx,
    # E and Wq, and the ring's slabs in place of W1, W2
    skip = (11, 12) if wide is None else (11, 12, 13)
    rest = nbytes([x for i, x in enumerate(ops[:16]) if i not in skip])
    outs = nbytes([x for x in out if x is not None])
    # (wide's scratch is the kernel's own, not an operand it reads)
    weights = (nbytes(ops[16]) if wide is None else nbytes(wide[:3])
               + nbytes([p for i, p in enumerate(ops[16])
                         if i not in (3, 5, 7, 8)]))
    live_b = (rest + weights + cols * h * se.element_size()
              + valid * 4 + outs)
    all_b = (nbytes([x for i, x in enumerate(ops[:16])
                     if wide is None or i != 13])
             + weights + nbytes(out_full))
    live_s = actor_ops_split(cfg, acting, h, cols)
    live_o = sum(live_s)
    all_s = actor_ops_split(cfg, B, h)
    live_ops_ms, all_ops_ms = ops_ms(live_s, dt), ops_ms(all_s, dt)
    res = {}
    if dt == torch.float32 and wide is not None:
        # W2 and Wq' run as 3xTF32: the lower of the two operation bounds
        tf3 = actor_tf32x3_ops_ms(cfg, acting, h, cols)
        res = {"f32_rate_bound": max(1e3 * live_b / HBM_BYTES_S,
                                     live_ops_ms),
               "bound_3xtf32": max(1e3 * live_b / HBM_BYTES_S, tf3)}
        live_ops_ms = min(live_ops_ms, tf3)
        all_ops_ms = min(all_ops_ms, actor_tf32x3_ops_ms(cfg, B, h))
    bound = max(1e3 * live_b / HBM_BYTES_S, live_ops_ms)
    return {"ms": ms, "full_ms": full, "plain_ms": plain, "cols": cols,
            "acting": acting, "pairs": B * cfg.num_blocks * cfg.num_rot,
            "bytes": live_b, "ops": live_o, "bound": bound,
            "bound_by": ("operations" if live_ops_ms
                         >= 1e3 * live_b / HBM_BYTES_S else "bytes"),
            "all_bound": max(1e3 * all_b / HBM_BYTES_S, all_ops_ms),
            "all_ops": sum(all_s), "se_bytes": nbytes([se]), "g_bytes":
            nbytes([g]), **res}


def log_actor_times(tag, cfg, k):
    log(f"{tag} actor_select_step {cfg.num_blocks}-block step "
        f"{cfg.num_blocks // 2}: main-path mode (live columns) "
        f"{k['ms']:.4f} ms/launch, full mode {k['full_ms']:.4f} ms/launch "
        f"(plain {k['plain_ms']:.4f}); {k['acting']} instances act, "
        f"{k['cols']} of {k['pairs']} (instance, token) columns live; "
        f"{k['bytes']} B, {k['ops']} f32 ops over the live columns, bound "
        f"{k['bound']:.5f} ms ({k['bound_by']}); all tokens {k['all_ops']} "
        f"f32 ops, bound {k['all_bound']:.5f} ms"
        + (f"; with W2 and Wq' as 3xTF32 (taken) {k['bound_3xtf32']:.5f} ms, "
           f"all at the f32 rate {k['f32_rate_bound']:.5f} ms"
           if "bound_3xtf32" in k else ""))


# ------------------------------------------------------------------ #
# phase 6: heightmap_reductions (K3) vs its plain version

def check_reward(cfg, B, actor, dev, p2d=0.0):
    """K3 on the final heightmaps of a sampled rollout: bit-equal to the
    plain version. Returns the heightmaps."""
    from tapnet_torch import random as R
    from tapnet_torch.ops import reward as RW
    from tapnet_torch.train import rollout as RO

    inst = _instances(cfg, B, dev, SEED + 8, p2d)
    states, _, _ = RO.rollout_batch_record(actor, inst,
                                           R.split(R.key(SEED + 9, dev), B),
                                           cfg)
    for hm in (states.heightmap, torch.zeros_like(states.heightmap)):
        got = RW.heightmap_reductions(hm)
        want = RW.heightmap_reductions_ref(hm)
        _equal("heightmap_reductions max", got[0], want[0])
        _equal("heightmap_reductions sum", got[1], want[1])
    return states.heightmap


# ------------------------------------------------------------------ #
# phase 7: replay_logp forward / backward (K5) vs their plain versions

GRAD_TOL = 5e-5       # K5b vs plain, of the plain result's max magnitude


def replay_operands(actor, cfg, B, dev, seed, temperature, p2d=0.0,
                    dtype=torch.float32, also=None):
    """Replay operands in `replay_logp_fwd` order from a sampled rollout on
    the card at `temperature` in the compute dtype `dtype`, and the
    rollout's own logp [B]. `also`: another dtype whose operands of the
    same record are returned third. At a hidden width the kernels do not
    take, se, ctx and the head operands padded with zeros to
    `kernel_width`, as `ReplayLogp` pads them."""
    from tapnet_torch import random as R
    from tapnet_torch.ops import replay as RP
    from tapnet_torch.train import rollout as RO

    inst = _instances(cfg, B, dev, seed, p2d)

    def ops_in(dt):
        (flags, hms, masks, acts, statp, statm), se, ctx, params = \
            RO.replay_operands(actor, inst, rec, cfg, grad=False, dtype=dt)
        se, ctx, params = RP._padded(se, ctx, params)
        return (flags, hms, masks, acts, se, ctx, statp, statm, params)

    with torch.no_grad():
        _, rec, lp0 = RO.rollout_batch_record(
            actor, inst, R.split(R.key(seed + 1, dev), B), cfg,
            temperature=temperature, dtype=dtype)
        if also is not None:
            return ops_in(dtype), lp0, ops_in(also)
        return ops_in(dtype), lp0


def replay_fns(ops, cfg, temperature, steps):
    """(fwd, fwd plain, bwd(dlp), bwd plain(dlp)) of one schedule on the
    operands of `replay_operands`."""
    from tapnet_torch.ops import replay as RP

    if not steps:
        return (lambda: RP.replay_logp_fwd(*ops, cfg, temperature),
                lambda: RP.replay_logp_fwd_ref(*ops, cfg, temperature),
                lambda d: RP.replay_logp_bwd(d, *ops, cfg, temperature),
                lambda d: RP.replay_logp_bwd_ref(d, *ops, cfg, temperature))
    so = ops[:4] + (RP._prev_rows(ops[3]),) + ops[4:]
    return (lambda: RP.replay_logp_fwd_steps(*so, cfg, temperature),
            lambda: RP.replay_logp_fwd_steps_ref(*so, cfg, temperature),
            lambda d: RP.replay_logp_bwd_steps(d, *so, cfg, temperature),
            lambda d: RP.replay_logp_bwd_steps_ref(d, *so, cfg, temperature))


def _flat_grads(g):
    return [g[0], g[1], *g[2]]


GRAD_NAMES = ["d_se", "d_ctx"] + [f"d_params[{i}]" for i in range(11)]


def check_replay(cfg, B, actor, dev, temperature=1.0, repeat=False,
                 steps=False, p2d=0.0):
    """K5f values within 1e-5 relative and K5b outputs within GRAD_TOL of
    the plain results' max magnitude (`steps`: the step-grid kernels and
    their plain versions); with `repeat`, two K5b launches bit-identical;
    K5f also agrees with the rollout's own logp. Returns (operands, dlp,
    fwd max abs err, (bwd max scaled err, bwd max abs err), max abs diff of
    K5f and the rollout's logp)."""
    ops, lp0 = replay_operands(actor, cfg, B, dev, SEED + 10, temperature,
                               p2d)
    fwd, fwd_ref, bwd, bwd_ref = replay_fns(ops, cfg, temperature, steps)
    what = "replay_logp_fwd_steps" if steps else "replay_logp_fwd"
    dlp = torch.linspace(-1.0, 1.0, B, device=dev)
    with torch.no_grad():
        got = fwd()
        f_err = _hold_values(what, got, fwd_ref(), TOL, 1e-6)
        # the train step's value is the rollout's logp (the primal): the
        # rollout head and the replay head must agree on it
        e0 = _hold_values(f"{what} vs the rollout's logp", got, lp0, TOL,
                          1e-5)
        g1 = bwd(dlp)
        b_errs = _hold_grads(what, g1, bwd_ref(dlp), GRAD_TOL)
        if repeat:
            g2 = bwd(dlp)
            for name, a, b in zip(GRAD_NAMES, _flat_grads(g1),
                                  _flat_grads(g2)):
                _equal(f"{what} backward repeat {name}", a, b)
    return ops, dlp, f_err, b_errs, e0


def _hold_values(what, got, want, rel, atol):
    """|got - want| <= rel |want| + atol everywhere; the max abs error."""
    d = (got - want).abs()
    if not bool((d <= rel * want.abs() + atol).all()):
        raise AssertionError(f"{what}: max err {d.max().item()}")
    return d.max().item()


def _hold_grads(what, got, want, tol):
    """Every gradient of `got` within `tol` of the plain result `want`'s
    max magnitude: (max scaled err, max abs err)."""
    b_err = b_abs = 0.0
    for name, a, w in zip(GRAD_NAMES, _flat_grads(got), _flat_grads(want)):
        e = ((a - w).abs().max() / (w.abs().max() + 1e-12)).item()
        if not e <= tol:
            raise AssertionError(f"{what} backward {name}: scaled err {e}")
        b_err = max(b_err, e)
        b_abs = max(b_abs, (a - w).abs().max().item())
    return b_err, b_abs


def hold_replay(ops, dlp, cfg, steps, dtype):
    """K5f and K5b (`steps`: their step-grid schedule) on one record's
    operands in `dtype` against their plain versions, at `check_replay`'s
    tolerances in float32 and `check_replay_bf16`'s in bfloat16. Returns
    (fwd max abs err, bwd max abs err)."""
    fwd, fwd_ref, bwd, bwd_ref = replay_fns(ops, cfg, 1.0, steps)
    f32 = dtype == torch.float32
    what = (("replay_logp_fwd_steps" if steps else "replay_logp_fwd")
            + ("" if f32 else " bf16"))
    with torch.no_grad():
        fe = _hold_values(what, fwd(), fwd_ref(),
                          TOL if f32 else BF16_VALUE_TOL,
                          1e-6 if f32 else 1e-3)
        _, ba = _hold_grads(what, bwd(dlp), bwd_ref(dlp),
                            GRAD_TOL if f32 else BF16_GRAD_TOL)
    return fe, ba


def check_steps_against_monolithic(ops, dlp, cfg):
    """The step-grid kernels forced onto a config the monolithic ones cover:
    the same value within TOL and the same gradients within GRAD_TOL."""
    fwd, _, bwd, _ = replay_fns(ops, cfg, 1.0, False)
    fwd_s, _, bwd_s, _ = replay_fns(ops, cfg, 1.0, True)
    with torch.no_grad():
        a, b = fwd(), fwd_s()
        d = (a - b).abs()
        if not bool((d <= TOL * a.abs() + 1e-6).all()):
            raise AssertionError("replay_logp_fwd_steps vs monolithic: max "
                                 f"err {d.max().item()}")
        worst = 0.0
        for name, x, y in zip(GRAD_NAMES, _flat_grads(bwd(dlp)),
                              _flat_grads(bwd_s(dlp))):
            e = ((x - y).abs().max() / (x.abs().max() + 1e-12)).item()
            if not e <= GRAD_TOL:
                raise AssertionError("replay_logp_bwd_steps vs monolithic "
                                     f"{name}: scaled err {e}")
            worst = max(worst, e)
    return d.max().item(), worst


def replay_ops_split(cfg, B, h, bwd, pairs=None, tokens=None):
    """f32 operations of the replay over B instances and N steps: per
    (instance, step) pair the encoder and the query, per token the dyn MLP
    and the attention (4 per (container, unit)), 2 per multiply-add; the
    backward adds the weight gradients, the input gradients of Wq (3h of
    its columns), W2 and Wp, and ~6 elementwise per (token, container,
    unit). `pairs`: the (instance, step) pairs to count instead of all
    B * N (a step without an action adds nothing); `tokens`: the
    (instance, step, token) triples to count for the token work instead of
    pairs * T (a token the mask rules out adds exact zeros). Returns
    (products, elementwise)."""
    N, R_, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    WD, T = cfg.target_width * cfg.target_depth, N * R_
    FQ = 3 * h + 8
    pairs = B * N if pairs is None else pairs
    tokens = pairs * T if tokens is None else tokens
    enc = C * (h * (WD + 2) + h * h + h * FQ)
    gemm = pairs * 2 * enc + tokens * 2 * (32 * 8 + 32 * h)
    elem = tokens * C * h * 4
    if not bwd:
        return gemm, elem
    enc_grad = C * (h * FQ + h * h + h * (WD + 2)) + C * (h * 3 * h + h * h)
    tok_grad = (h * 32 + 32 * 8) + 32 * h
    return (gemm + pairs * 2 * enc_grad + tokens * 2 * tok_grad,
            elem + tokens * C * h * 6)


def tf32x3_ops_ms(cfg, B, h, bwd, pairs=None, tokens=None):
    """The least time of the float32 replay's operations above hidden 128
    (`replay_ops_split`), where its encoder/query products, their
    backward and the weight-gradient contractions (the terms counted per
    pair) run as 3xTF32 at TF32X3_OPS_S and the token work and the
    elementwise at F32_OPS_S."""
    gemm, elem = replay_ops_split(cfg, B, h, bwd, pairs, tokens)
    enc, _ = replay_ops_split(cfg, B, h, bwd, pairs, 0)
    return 1e3 * (enc / TF32X3_OPS_S + (gemm - enc + elem) / F32_OPS_S)


def replay_ops_count(cfg, B, h, bwd, pairs=None, tokens=None):
    """f32 operations of the replay (`replay_ops_split`)."""
    return sum(replay_ops_split(cfg, B, h, bwd, pairs, tokens))


def live_counts(cfg, masks, acts):
    """(pairs, triples): the (instance, step) pairs with an action and the
    (instance, step, token) triples among them whose mask allows the token
    in some container: the live columns of the replay kernels."""
    T, C = cfg.num_blocks * cfg.num_rot, cfg.num_containers
    live = ((masks.reshape(masks.shape[0], T, C, -1) == 1).any(2)
            & (acts >= 0)[:, None])
    return int((acts >= 0).sum()), int(live.sum())


# ------------------------------------------------------------------ #
# phase 8: the train path

def _state_dicts(ts):
    return {**{f"actor.{k}": v for k, v in ts.actor.state_dict().items()},
            **{f"critic.{k}": v for k, v in ts.critic.state_dict().items()}}


def train_counters():
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import policy_step as PS
    from tapnet_torch.ops import replay as RP
    from tapnet_torch.ops import reward as RW
    return {"select_step": PS.select_step,
            "actor_select_step": AS.actor_select_step,
            "query_parts": AS.query_parts,
            "replay_logp_bwd": RP.replay_logp_bwd,
            "replay_logp_fwd": RP.replay_logp_fwd,
            "replay_logp_bwd_steps": RP.replay_logp_bwd_steps,
            "replay_logp_fwd_steps": RP.replay_logp_fwd_steps,
            "heightmap_reductions": RW.heightmap_reductions}


def train_main_path(cfg, dev, per_step=None, n_steps=5, batch=B_MAIN,
                    hidden=HIDDEN, p2d=0.0, compute_dtype=None):
    """init_train_state + `n_steps` steps of make_train_step(batch) on the
    card with the launch counts of every step held to `per_step` (default:
    the monolithic-replay route, actor_select_step N, replay_logp_bwd 1,
    heightmap_reductions 1, nothing else). Returns the counts, the state
    and the step."""
    from tapnet_torch import init_train_state, make_train_step

    ts = init_train_state(SEED, cfg, hidden=hidden, device=dev)
    step = make_train_step(cfg, batch=batch, hidden=hidden, mixed_p2d=p2d,
                           compute_dtype=compute_dtype, device=dev)
    counters = train_counters()
    for f in counters.values():
        f.launches = 0
    want = dict.fromkeys(counters, 0)
    want.update(per_step or {"actor_select_step": cfg.num_blocks,
                             "replay_logp_bwd": 1,
                             "heightmap_reductions": 1})
    for i in range(n_steps):
        before = {k: f.launches for k, f in counters.items()}
        ts, m = step(ts)
        got = {k: f.launches - before[k] for k, f in counters.items()}
        if got != want:
            raise AssertionError(f"train step {i} launches {got}, expected "
                                 f"{want}")
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"train step {i}: metrics {vals}")
        log(f"  train step {i}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in vals.items()))
    return {k: f.launches for k, f in counters.items()}, ts, step


def check_train_against_cpu(cfg, ts, dev, B=256, hidden=HIDDEN, p2d=0.0):
    """One step at batch B on the card and on the CPU reference path from
    the same state: instances equal, >= 95% of the trajectories equal,
    R/C/P/S exactly equal on those; then the whole step on both, the losses
    within 1e-4 relative when every trajectory agrees."""
    import copy

    from tapnet_torch import make_train_step
    from tapnet_torch import random as R
    from tapnet_torch.env.sampler import sample_batch, sample_batch_mixed
    from tapnet_torch.ops.reward import batched_reward_terms
    from tapnet_torch.train import reinforce as TR
    from tapnet_torch.train import rollout as RO

    gpu = copy.deepcopy(ts)
    cpu = TR.train_state(copy.deepcopy(ts.actor).cpu(),
                         copy.deepcopy(ts.critic).cpu(), ts.key.cpu())
    side = {}
    for name, st in (("card", gpu), ("cpu", cpu)):
        ks = R.split(st.key, 3)
        inst = (sample_batch_mixed(ks[1], B, cfg, p2d) if p2d > 0
                else sample_batch(ks[1], B, cfg))
        states, rec, _ = RO.rollout_batch_record(st.actor, inst,
                                                 R.split(ks[2], B), cfg)
        terms = batched_reward_terms(states.heightmap, states.placements,
                                     inst.dims)
        side[name] = (inst, rec.action.T, terms)
    for a, b in zip(side["card"][0], side["cpu"][0]):
        _equal("train instances card vs CPU", a.cpu(), b)
    same = (side["card"][1].cpu() == side["cpu"][1]).all(1)
    frac = same.float().mean().item()
    if frac < 0.95:
        raise AssertionError(f"train rollout card vs CPU: only {frac} of the "
                             "trajectories agree")
    for a, b in zip(side["card"][2], side["cpu"][2]):
        _equal("train R/C/P/S terms card vs CPU", a.cpu()[same], b[same])
    _, m_g = make_train_step(cfg, batch=B, hidden=hidden, mixed_p2d=p2d,
                             device=dev)(gpu)
    _, m_c = make_train_step(cfg, batch=B, hidden=hidden, mixed_p2d=p2d,
                             device="cpu")(cpu)
    diffs = {k: abs(float(m_g[k]) - float(m_c[k])) for k in m_g}
    if frac == 1.0:
        for k in ("loss_actor", "loss_critic"):
            if diffs[k] > 1e-4 * max(1.0, abs(float(m_c[k]))):
                raise AssertionError(f"train step card vs CPU: {k} differs "
                                     f"by {diffs[k]}")
    log(f"  train step B={B} card vs CPU: {frac:.4f} of trajectories equal, "
        f"their reward terms equal; |metric diff| {diffs}")
    return frac


def jax_loop_steps(epochs, spe, spc, traced=False):
    """The step numbers of the JAX trainer's epoch lines
    (tapnet_tpu/train/trainer.py: one untimed call of spc steps, then
    (n - 1) // spc calls; with a trace, min(3, max(n - 1, 1)) traced calls
    after the first call of the run, and n counted again after them)."""
    step, out = 0, []
    while step < epochs * spe:
        n = spe - step % spe
        step += spc
        if traced and not out:
            step += spc * min(3, max(n - 1, 1))
            n = spe - step % spe
        step += spc * max(0, (n - 1) // spc)
        out.append(step)
    return out


def check_trainer(cfg, dev, tmp, spe=5, spc=1, batch=B_MAIN):
    """train() for 2 epochs x `spe` steps (`spc` steps a call) writes
    metrics and checkpoints at the JAX trainer's step numbers; a resume
    from the epoch-1 checkpoint ends on the same params."""
    import json
    import os
    import shutil

    from tapnet_torch import TrainLoopConfig, train
    from tapnet_torch.train import checkpoints as ckpt

    loop = TrainLoopConfig(epochs=2, steps_per_epoch=spe, batch=batch,
                           hidden=HIDDEN, valid_batch=batch,
                           steps_per_call=spc,
                           ckpt_dir=os.path.join(tmp, "a"),
                           metrics_path=os.path.join(tmp, "a.jsonl"))
    full = train(cfg, loop, device=dev)
    lines = [json.loads(x) for x in open(loop.metrics_path)]
    epochs = [r for r in lines if "epoch" in r]
    steps = [r["step"] for r in epochs]
    if (steps != jax_loop_steps(2, spe, spc)
            or not all(np.isfinite(r["loss_actor"]) for r in epochs)):
        raise AssertionError(f"train() metrics: {lines}")
    name = f"ckpt_{steps[0]:08d}.pt"
    first = os.path.join(loop.ckpt_dir, name)
    resumed_dir = os.path.join(tmp, "b")
    os.makedirs(resumed_dir)
    shutil.copy(first, resumed_dir)
    with open(os.path.join(resumed_dir, "latest.json"), "w") as f:
        json.dump({"step": steps[0],
                   "path": os.path.join(resumed_dir, name)}, f)
    loop_b = TrainLoopConfig(epochs=2, steps_per_epoch=spe, batch=batch,
                             hidden=HIDDEN, valid_batch=batch,
                             steps_per_call=spc, ckpt_dir=resumed_dir)
    resumed = train(cfg, loop_b, device=dev)
    a, b = _state_dicts(full), _state_dicts(resumed)
    for k in a:
        _equal(f"resumed params {k}", b[k], a[k])
    if not ckpt.latest_checkpoint(resumed_dir).endswith(
            f"ckpt_{steps[-1]:08d}.pt"):
        raise AssertionError(f"resumed run wrote no step-{steps[-1]} "
                             "checkpoint")
    rewards = [(r["step"], round(r["reward"], 6)) for r in epochs]
    log(f"  train(): epoch lines (step, reward) {rewards}, "
        f"valid_reward {epochs[-1]['valid_reward']:.6f}, "
        f"{epochs[-1]['env_steps_per_s']:.0f} env-steps/s; resume from "
        f"step {steps[0]} ends on bit-identical params")


# ------------------------------------------------------------------ #
# phases 10-13: the heuristic whole-rollout kernel (K4) and the mcs rule

def heuristic_cases():
    """Configs beyond CONFIGS, one per branch of the rollout kernel."""
    from tapnet_torch import TAPConfig as T
    cube6 = dict(dim=3, container_width=6, container_depth=6,
                 container_height=6, target_width=6, target_depth=6)
    cube8 = dict(dim=3, container_width=8, container_depth=8,
                 container_height=8, target_width=8, target_depth=8)
    return {
        "2d-rot-lb-hard": T(allow_rot=True, reward_type="C+P+S-lb-hard"),
        "2d-two-containers": T(num_containers=2, container_height=20,
                               allow_rot=True),
        "2d-capped-tight": T(target_height=3, reward_type="C+P-lb-soft"),
        "2d-capped-mc": T(container_height=20, target_height=7,
                          num_containers=2, allow_rot=True),
        "2d-capped-3c": T(container_height=24, target_height=5,
                          num_containers=3, allow_rot=True),
        "3d-capped": T(**cube8, target_height=5, allow_rot=True),
        "3d-window": T(**cube6, num_blocks=16, min_blocks=8, window=4,
                       allow_rot=True),
        "2d-mcs-soft": T(reward_type="C+P+S-mcs-soft"),
        "2d-mcs-hard": T(allow_rot=True, reward_type="C+P-mcs-hard"),
        "3d-mcs-soft": T(**cube6, allow_rot=True,
                         reward_type="C+S-mcs-soft"),
        "3d-mcs-hard-multicont": T(**cube6, num_blocks=8, min_blocks=8,
                                   num_containers=2,
                                   reward_type="C+P+S-mcs-hard"),
        "3d-capped-mc-mcs": T(**cube6, target_height=4, num_containers=2,
                              allow_rot=True,
                              reward_type="C+P+S-mcs-hard"),
        # a target deeper than 16 cells: K4's min-landing table from shared
        # memory rather than register rows
        "3d-deep-capped": T(dim=3, container_width=4, container_depth=20,
                            container_height=4, target_width=4,
                            target_depth=20, target_height=3, allow_rot=True),
    }


def check_fused_rollout(cfg, B, dev, policy, repeat=False, p2d=0.0):
    """K4 against its plain version on the same instances and keys: every
    state field, the actions and the rewards bit-equal; with `repeat`, a
    second launch on the same operands bit-identical to the first. Returns
    the number of no-op steps (blocks a cap stranded, and padding steps)."""
    from tapnet_torch import random as R
    from tapnet_torch.env import core as E
    from tapnet_torch.ops import env as OE

    inst = _instances(cfg, B, dev, SEED + 20, p2d)
    keys = R.split(R.key(SEED + 21, dev), B)
    s_k, a_k, r_k = OE.fused_rollout_batch(inst, keys, cfg, policy)
    s_p, a_p, r_p = OE.fused_rollout_batch_ref(inst, keys, cfg, policy)
    for f in s_k._fields:
        _equal(f"fused_rollout_batch {policy} {f}", getattr(s_k, f),
               getattr(s_p, f))
    _equal(f"fused_rollout_batch {policy} actions", a_k, a_p)
    _equal(f"fused_rollout_batch {policy} rewards", r_k, r_p)
    if repeat:
        ops = OE.rollout_operands(inst, E.policy_bits(keys, cfg, policy),
                                  cfg)
        for name, a, b in zip(("hm", "packed", "actions", "plc"),
                              OE.rollout_kernel(ops, cfg),
                              OE.rollout_kernel(ops, cfg)):
            _equal(f"fused_rollout_batch {policy} {name} repeated", a, b)
    return int((a_k < 0).sum())


def check_heuristic_plan(plan, inst, cfg, name):
    """A heuristic plan: complete without a cap; under a cap every block
    left unpacked is a no-op step. Heightmaps replayed from the placements,
    rewards in (0, 3]."""
    B = len(plan)
    stranded = int((~plan.states.packed).sum())
    if cfg.target_height == 0 and stranded:
        raise AssertionError(f"{name}: incomplete plans")
    real = inst.n_total.cpu().numpy()
    noop = (plan.actions < 0).sum(1) - (cfg.num_blocks - real)
    if not np.array_equal(noop, (~plan.states.packed).sum(1)):
        raise AssertionError(f"{name}: no-op steps and unpacked blocks "
                             "disagree")
    r = plan.rewards
    placed_any = (plan.actions >= 0).any(1)
    if not (np.isfinite(r).all() and (r[placed_any] > 0).all()
            and (r[~placed_any] == 0).all() and (r <= 3).all()):
        raise AssertionError(f"{name}: rewards outside (0, 3]")
    replay_heightmaps(plan, inst.dims.cpu().numpy(), cfg)
    log(f"  {name}: B={B}, {stranded} blocks stranded, heightmaps replayed, "
        f"reward mean {r.mean():.6f} min {r.min():.6f} max {r.max():.6f}")


def _plans_equal(name, a, b):
    for f in a.states._fields:
        if not np.array_equal(getattr(a.states, f), getattr(b.states, f)):
            raise AssertionError(f"{name}: {f} differs")
    if not (np.array_equal(a.actions, b.actions)
            and np.array_equal(a.rewards, b.rewards)):
        raise AssertionError(f"{name}: actions or rewards differ")


def heuristic_main_path(configs, dev):
    """pack(first) and pack(random) on every config at B_MAIN: one K4 and
    one K3 launch per call. Returns the launch counts of the run, the plans
    and the instances."""
    from tapnet_torch import pack
    from tapnet_torch.ops import env as OE
    from tapnet_torch.ops import reward as RW

    insts = {n: _instances(cfg, B_MAIN, dev, SEED + 22)
             for n, cfg in configs.items()}
    OE.fused_rollout_batch.launches = 0
    RW.heightmap_reductions.launches = 0
    plans = {}
    for name, cfg in configs.items():
        for policy in ("first", "random"):
            k4, k3 = (OE.fused_rollout_batch.launches,
                      RW.heightmap_reductions.launches)
            plans[name, policy] = pack(insts[name], cfg, policy=policy,
                                       key=SEED + 23)
            got = (OE.fused_rollout_batch.launches - k4,
                   RW.heightmap_reductions.launches - k3)
            if got != (1, 1):
                raise AssertionError(
                    f"pack({policy}) on {name}: launches (fused_rollout_batch"
                    f", heightmap_reductions) = {got}, expected (1, 1)")
    launches = {"fused_rollout_batch": OE.fused_rollout_batch.launches,
                "heightmap_reductions": RW.heightmap_reductions.launches}
    return launches, plans, insts


def check_heuristic_against_cpu(configs, insts, actor, dev):
    """Two card calls bit-identical; the card against the CPU path on every
    field at B=256; evaluate(baselines=True) on the card against the CPU."""
    from tapnet_torch import TrainLoopConfig, pack
    from tapnet_torch.train.trainer import evaluate

    for name, cfg in configs.items():
        small = insts[name].index(slice(0, 256))
        for policy in ("first", "random"):
            a = pack(small, cfg, policy=policy, key=SEED + 24)
            _plans_equal(f"pack({policy}) {name} repeated", a,
                         pack(small, cfg, policy=policy, key=SEED + 24))
            _plans_equal(f"pack({policy}) {name} card vs CPU", a,
                         pack(small.to("cpu"), cfg, policy=policy,
                              key=SEED + 24, device="cpu"))
        log(f"  pack(first/random) {name} B=256: two calls bit-identical, "
            "card == CPU path on every field")
    cfg = configs["2d-basic"]
    loop = TrainLoopConfig(valid_batch=256, hidden=HIDDEN)
    on_card = evaluate(actor, cfg, loop, baselines=True, device=dev)
    actor_cpu = type(actor)(cfg, actor.hidden)
    actor_cpu.load_state_dict({k: v.cpu() for k, v in
                               actor.state_dict().items()})
    on_cpu = evaluate(actor_cpu, cfg, loop, baselines=True, device="cpu")
    for k in ("random_reward", "first_reward"):
        a, b = float(on_card[k]), float(on_cpu[k])
        if not (np.isfinite(a) and abs(a - b) <= 1e-6):
            raise AssertionError(f"evaluate(baselines=True) {k}: card {a}, "
                                 f"CPU {b}")
    log("  evaluate(baselines=True) 2d-basic B=256: random_reward "
        f"{float(on_card['random_reward']):.6f}, first_reward "
        f"{float(on_card['first_reward']):.6f}, equal to the CPU path's "
        "within 1e-6")


def rollout_int_ops(cfg, ops, actions, plc):
    """int32 operations this run's rollouts need, counted from their own
    actions and placements: per step with an action, 2 per (block, graph) for
    accessibility, 1 per (block, rot) for the fit, 1 per block for the rank,
    and per offset the block may take a max and a compare per footprint cell
    plus 4 for the key and the running best (mcs: a sum per cell and ~24 for
    the fraction and its comparison). The placeability scans a finite cap
    adds to the mask are not counted."""
    N, R_, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    W, D = cfg.target_width, cfg.target_depth
    dw, dd, dh = (o.long() for o in ops[:3])                 # [N, B]
    live = actions >= 0
    blk = (actions.clamp(min=0) // (R_ * C)).long()          # [N, B]
    rot = plc.reshape(N, 6, -1)[:, 1].long().gather(0, blk)
    w0, d0, h0 = (x.gather(0, blk) for x in (dw, dd, dh))
    if cfg.dim == 2:
        w, d = torch.where(rot == 1, h0, w0), d0
    else:
        w, d = torch.where(rot == 1, d0, w0), torch.where(rot == 1, w0, d0)
    offsets = (W - w + 1) * (D - d + 1)
    per_offset = 2 * w * d + 4
    if cfg.placement_rule == "mcs":
        per_offset = per_offset + w * d + 24
    per_step = 2 * N * R_ + N * R_ + N + offsets * per_offset
    return int(torch.where(live, per_step, 0).sum())


def time_fused_rollout(cfg, B, dev, p2d=0.0):
    """K4 on prebuilt operands (`random` draws) and the plain loop on the
    same draws. Returns (ms, plain ms, bytes moved, int32 operations,
    max |kernel - plain| over the outputs)."""
    from tapnet_torch import random as R
    from tapnet_torch.env import core as E
    from tapnet_torch.ops import env as OE

    inst = _instances(cfg, B, dev, SEED + 25, p2d)
    rbits = E.policy_bits(R.split(R.key(SEED + 26, dev), B), cfg, "random")
    ops = OE.rollout_operands(inst, rbits, cfg)
    ms = time_gpu(lambda: OE.rollout_kernel(ops, cfg))
    plain = time_gpu(lambda: E.rollout_bits(inst, rbits, cfg), reps=3,
                     sleep_cycles=200_000_000)
    hm, packed, actions, plc = OE.rollout_kernel(ops, cfg)
    state, a_p = E.rollout_bits(inst, rbits, cfg)
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    err = max((actions.T - a_p).abs().max().item(),
              (hm.reshape(C, W, D, B).permute(3, 0, 1, 2)
               - state.heightmap).abs().max().item(),
              (plc.reshape(N, 6, B).permute(2, 0, 1)
               - state.placements).abs().max().item(),
              (packed.T - state.packed.int()).abs().max().item())
    moved = nbytes(ops) + nbytes((hm, packed, actions, plc))
    return ms, plain, moved, rollout_int_ops(cfg, ops, actions, plc), err


def rolling_cases():
    """Configs that need K2's window or its second precedence limb, and the
    step-grid replay."""
    from tapnet_torch import CONFIGS
    from tapnet_torch import TAPConfig as T
    return {
        "2d-rolling": CONFIGS["2d-rolling"],
        "rolling-small": T(num_blocks=12, min_blocks=6, container_width=8,
                           container_height=12, target_width=8, window=4,
                           allow_rot=True),
        "two-limb": T(num_blocks=34, min_blocks=20, container_width=8,
                      container_height=40, target_width=8, window=6),
        "3d-window": heuristic_cases()["3d-window"],
    }


# ------------------------------------------------------------------ #
# phase 18: configs past a kernel's coverage take the fallbacks

def check_fallback_routes(dev):
    """On the card, configs a kernel does not cover run through the path
    `routes` picks instead, with the CPU path's results: a train step and
    sampled pack() at hidden 544 (past the widest width of K2 and the
    replay kernels, 512: K1 and the general replay), pack(first/random) on
    a 17 x 16 target (past K4, K1 and K2: the env's own rollout). The
    wrappers called directly outside their coverage still raise. Returns
    the launch counts of the run."""
    from tapnet_torch import CONFIGS, TAPConfig, pack
    from tapnet_torch import random as R
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import env as OE
    from tapnet_torch.ops import policy_step as PS
    from tapnet_torch.ops import replay as RP
    from tapnet_torch.train import rollout as RO

    cfg, h = CONFIGS["2d-basic"], 544
    want = RO.Routes("step", False, True)
    if RO.routes(cfg, True, h) != want:
        raise AssertionError(f"routes at hidden {h}: "
                             f"{RO.routes(cfg, True, h)}")
    per_step = {"select_step": cfg.num_blocks, "heightmap_reductions": 1}
    counts, ts, _ = train_main_path(cfg, dev, per_step, n_steps=2, batch=256,
                                    hidden=h)
    log(f"phase 18 train step 2d-basic hidden {h} batch 256 (no K2, no K5): "
        f"launches (2 steps) {counts}")
    check_train_against_cpu(cfg, ts, dev, B=256, hidden=h)

    actor = init_params(SEED, cfg, h, dev)
    actor_cpu = type(actor)(cfg, h)
    actor_cpu.load_state_dict({k: v.cpu() for k, v in
                               actor.state_dict().items()})
    inst = _instances(cfg, 256, dev, SEED + 30)
    k1, k2 = PS.select_step.launches, AS.actor_select_step.launches
    a = pack(inst, cfg, actor, policy="sample", key=SEED + 31)
    got = (PS.select_step.launches - k1, AS.actor_select_step.launches - k2)
    if got != (cfg.num_blocks, 0):
        raise AssertionError(f"pack(sample) hidden {h}: launches "
                             f"(select_step, actor_select_step) = {got}")
    b = pack(inst.to("cpu"), cfg, actor_cpu, policy="sample", key=SEED + 31,
             device="cpu")
    same = (a.actions == b.actions).all(axis=1)
    if same.mean() < 0.95 or not np.allclose(a.rewards[same],
                                             b.rewards[same], atol=1e-6):
        raise AssertionError(f"pack(sample) hidden {h} card vs CPU: "
                             f"{same.mean()} of the trajectories agree")
    log(f"phase 18 pack(sample) 2d-basic hidden {h} B=256: select_step x"
        f"{got[0]}, actor_select_step x0; {same.mean():.4f} of the "
        "trajectories equal to the CPU path's, their rewards within 1e-6")

    wide = TAPConfig(dim=3, container_width=17, container_depth=16,
                     container_height=8, target_width=17, target_depth=16,
                     allow_rot=True)
    if RO.routes(wide, True, HIDDEN) != RO.Routes("general", True, False):
        raise AssertionError(f"routes on 17 x 16: {RO.routes(wide, True)}")
    inst_w = _instances(wide, 256, dev, SEED + 32)
    k4 = OE.fused_rollout_batch.launches
    for policy in ("first", "random"):
        plan = pack(inst_w, wide, policy=policy, key=SEED + 33)
        check_heuristic_plan(plan, inst_w, wide, f"phase 18 pack({policy}) "
                             "17 x 16 target (no K4)")
        _plans_equal(f"pack({policy}) 17 x 16 card vs CPU", plan,
                     pack(inst_w.to("cpu"), wide, policy=policy,
                          key=SEED + 33, device="cpu"))
    if OE.fused_rollout_batch.launches != k4:
        raise AssertionError("pack(first/random) on a 17 x 16 target "
                             "launched fused_rollout_batch")
    log("phase 18 pack(first/random) 17 x 16 target B=256: no K4 launch, "
        "plans equal to the CPU path's on every field")

    # the wrappers outside their coverage: NotImplementedError, no fallback
    keys = R.split(R.key(SEED + 34, dev), 256)
    o = actor_operands(actor, inst, cfg, keys)
    (dw, dd, dh), packed, hm, plc = RO._batch_last(inst, cfg)
    tf = torch.zeros((1, 1), device=dev)
    prev = torch.full((1, 256), -1, dtype=torch.int32, device=dev)
    ops_r, _ = replay_operands(actor, cfg, 256, dev, SEED + 35, 1.0)
    score = torch.zeros((wide.num_actions, 256), device=dev)
    _, packed_w, hm_w, plc_w = RO._batch_last(inst_w, wide)
    (dw_w, dd_w, dh_w), _, _, _ = RO._batch_last(inst_w, wide)
    refusals = {
        f"actor_select_step hidden {h}": lambda: AS.actor_select_step(
            tf, packed, hm, plc, prev, dw, dd, dh, o["upm"], o["rotm"],
            o["fits"], o["g_all"][0], o["se"], o["ctx"], o["statp"],
            o["statm"], o["params"], cfg, logits=False),
        f"replay_logp_bwd hidden {h}": lambda: RP.replay_logp_bwd(
            torch.zeros(256, device=dev), *ops_r, cfg),
        "select_step 17 x 16": lambda: PS.select_step(
            score, score.int(), packed_w, hm_w, plc_w, dw_w, dd_w, dh_w,
            wide),
        "fused_rollout_batch 17 x 16": lambda: OE.fused_rollout_batch(
            inst_w, keys, wide, "first"),
    }
    for name, call in refusals.items():
        try:
            call()
        except NotImplementedError:
            continue
        raise AssertionError(f"{name} did not raise")
    log("phase 18 called directly outside their coverage, "
        f"{', '.join(refusals)} raise NotImplementedError")
    return counts


# ------------------------------------------------------------------ #
# phase 19: K1 and K4 where a split-and-join placement can go wrong

def edge_cases():
    """The configs of tests/test_torch_place_edges.py, where the plain
    versions are held to the JAX package: duplicate score rows and equal lb
    keys (2d-basic from the empty state), lb-hard, mcs ties, a 16 x 16
    target with 8 containers (K4 keeps its heightmaps out of shared memory
    there), 62 blocks under a window, 16 (rotation, container) pairs under a
    cap, a tight cap that strands blocks."""
    from tapnet_torch import TAPConfig as T
    return {
        "2d-basic": T(),
        "2d-lb-hard": T(allow_rot=True, reward_type="C+P+S-lb-hard"),
        "2d-mcs-soft": T(reward_type="C+P+S-mcs-soft"),
        "3d-mcs-hard": T(dim=3, container_width=6, container_depth=6,
                         container_height=6, target_width=6, target_depth=6,
                         num_containers=2, reward_type="C+P+S-mcs-hard"),
        "3d-16x16": T(dim=3, container_width=16, container_depth=16,
                      container_height=16, target_width=16, target_depth=16,
                      num_containers=8, allow_rot=True),
        "2d-62-window": T(num_blocks=62, min_blocks=40, container_width=16,
                          container_height=40, target_width=16, window=6,
                          allow_rot=True),
        "2d-rc16-capped": T(num_containers=8, container_height=30,
                            allow_rot=True, target_height=9),
        "2d-capped-tight": T(target_height=3, reward_type="C+P-lb-soft"),
    }


def select_operands(cfg, inst, state, score):
    """select_step's operands at `state`, batch-last, the scores masked as
    the decode loop masks them."""
    from tapnet_torch.env import core as E
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    mask = E.action_mask(state, inst, cfg).T.int().contiguous()
    score = torch.where(mask == 1, score, torch.full_like(score, -1e9))
    return (score.contiguous(), mask, state.packed.T.int().contiguous(),
            state.heightmap.permute(1, 2, 3, 0).reshape(C * W, D, -1)
            .contiguous(),
            state.placements.permute(1, 2, 0).reshape(N * 6, -1).contiguous(),
            *(inst.dims[:, :, k].T.int().contiguous() for k in range(3)))


def check_select_edges(name, ops, cfg):
    """K1 against its plain version on `ops`, and a second launch
    bit-identical to the first. Returns the number of acting instances."""
    from tapnet_torch.ops import policy_step as PS
    got = PS.select_step(*ops, cfg=cfg)
    again = PS.select_step(*ops, cfg=cfg)
    for field, g, a, w in zip(("packed", "hm", "plc", "act"), got, again,
                              PS.select_place_ref(cfg, *ops)):
        _equal(f"select_step {name} {field}", g, w)
        _equal(f"select_step {name} {field} repeated", a, g)
    return int((got[3] >= 0).sum())


def k1_edges(name, cfg, B, dev):
    """Two steps as in the CPU test: from the empty state with every score
    row duplicated from its neighbour, then after N/2 random steps."""
    from tapnet_torch.env import core as E
    inst = _instances(cfg, B, dev, SEED + 40)
    state = E.reset(inst, cfg)
    g = torch.Generator().manual_seed(SEED + 41)
    A = cfg.num_actions
    score = torch.randn((A, B), generator=g)
    score[1::2] = score[0::2][:A // 2]
    acts = [check_select_edges(f"{name} B={B} empty", select_operands(
        cfg, inst, state, score.to(dev)), cfg)]
    for _ in range(cfg.num_blocks // 2):
        mask = E.action_mask(state, inst, cfg)
        u = torch.rand(mask.shape, generator=g).to(dev) * mask
        a = torch.where(mask.any(1), u.argmax(1), -1).int()
        state = E.step(state, a, inst, cfg)
    score = torch.randn((A, B), generator=g).to(dev)
    acts.append(check_select_edges(f"{name} B={B} mid", select_operands(
        cfg, inst, state, score), cfg))
    return acts


def k1_hard_without_stable(dev, B=37):
    """lb-hard where no offset is stable (heights alternate 5, 0 under a
    2-wide block) for half the batch and a flat top makes one stable for
    the other half, as in the CPU test."""
    from tapnet_torch.env import core as E
    cfg = edge_cases()["2d-lb-hard"]
    inst = _instances(cfg, B, dev, SEED + 42)
    dims = inst.dims.clone()
    dims[:, :, 0], dims[:, :, 2] = 2, 3
    inst = inst._replace(dims=dims)
    hm = torch.zeros((B, 1, cfg.target_width, 1), dtype=torch.int32,
                     device=dev)
    hm[:, 0, 0::2, 0] = 5
    hm[B // 2:, 0, 4:7, 0] = 5
    state = E.reset(inst, cfg)._replace(heightmap=hm)
    score = torch.full((cfg.num_actions, B), -5.0, device=dev)
    score[0] = 1.0
    ops = list(select_operands(cfg, inst, state, score))
    ops[0], ops[1] = score, torch.ones_like(ops[1])
    check_select_edges("2d-lb-hard without a stable offset", ops, cfg)
    from tapnet_torch.ops import policy_step as PS
    stable = PS.select_step(*ops, cfg=cfg)[2][5]
    if not (bool((stable[:B // 2] == 0).all())
            and bool((stable[B // 2:] == 1).all())):
        raise AssertionError("lb-hard: the stable flags of the chosen "
                             "offsets are not the expected ones")


def check_edges(dev):
    """Phase 19: K1 and K4 bit-equal to their plain versions on the edge
    cases, at a batch of 37 and 512, and two launches bit-identical."""
    from tapnet_torch.ops import env as OE
    plans = {}
    for name, cfg in edge_cases().items():
        acts = []
        for B in (37, 512):
            acts += k1_edges(name, cfg, B, dev)
            noops = [check_fused_rollout(cfg, B, dev, p, repeat=True)
                     for p in ("first", "random")]
        plans[name] = "shared" if OE.onchip(cfg) else "global"
        log(f"phase 19 {name}: select_step == plain, bit-equal and "
            f"repeated bit-identical, from the empty state and mid-rollout "
            f"at B=37 and 512 ({acts} instances act); fused_rollout_batch "
            f"== plain and repeated bit-identical at B=37 and 512, first and "
            f"random ({noops} no-op steps at 512), heightmaps in "
            f"{plans[name]} memory")
    k1_hard_without_stable(dev)
    log("phase 19 2d-lb-hard without a stable offset: select_step == plain, "
        "the soft winner where no offset is stable, the stable one where "
        "one is")
    if "global" not in plans.values():
        raise AssertionError("no edge case ran K4's second storage plan")


# ------------------------------------------------------------------ #
# phase 20: the whole reward in one launch (reward_kernel)

def _plan_tensors(plan, inst, dev):
    """(heightmaps, placements, dims) of a PackingPlan on the card."""
    st = plan.states
    return (torch.from_numpy(st.heightmap).to(dev),
            torch.from_numpy(st.placements).to(dev), inst.dims)


def check_fused_reward_case(name, hm, plc, dims, terms_cfg):
    """fused_reward (one launch) == its plain version on the same CUDA
    tensors: maxh, under, the five terms and the reward, bit for bit."""
    from tapnet_torch.ops import reward as RW
    got = RW.fused_reward(hm, plc, dims, terms_cfg)
    want = RW.fused_reward_ref(hm, plc, dims, terms_cfg)
    _equal(f"fused reward {name} maxh", got[0], want[0])
    _equal(f"fused reward {name} under", got[1], want[1])
    for t, a, b in zip(("vol", "denom_c", "denom_p", "s_num", "s_den"),
                       got[2], want[2]):
        _equal(f"fused reward {name} {t}", a, b)
    _equal(f"fused reward {name} reward bits",
           got[3].view(torch.int32), want[3].view(torch.int32))


def check_fused_reward(plans, insts, dev):
    """The final plans of pack(first/random) on the six CONFIGS at B_MAIN
    (phase 12), zero heightmaps and a capped plan that strands blocks (-1
    rows below n_total). Returns the number of stranded blocks."""
    from tapnet_torch import CONFIGS, TAPConfig, pack

    for (name, policy), plan in plans.items():
        check_fused_reward_case(f"{name} {policy}",
                                *_plan_tensors(plan, insts[name], dev),
                                CONFIGS[name].reward_terms)
    hm, plc, dims = _plan_tensors(plans["2d-basic", "first"],
                                  insts["2d-basic"], dev)
    check_fused_reward_case("zero heightmaps", torch.zeros_like(hm),
                            torch.full_like(plc, -1), dims, ("C", "P", "S"))
    tight = TAPConfig(num_containers=2, container_width=6,
                      container_height=8, target_width=6, target_height=3,
                      allow_rot=True)
    inst = _instances(tight, B_MAIN, dev, SEED + 40)
    hm, plc, dims = _plan_tensors(pack(inst, tight, policy="first",
                                       key=SEED + 41, device=dev), inst, dev)
    real = (torch.arange(tight.num_blocks, device=dev)[None]
            < inst.n_total[:, None])
    stranded = int(((plc[:, :, 0] < 0) & real).sum())
    if stranded == 0:
        raise AssertionError("the capped plan strands no block")
    check_fused_reward_case("capped partial plan", hm, plc, dims,
                            tight.reward_terms)
    return stranded


def _launches_per_call(label, fn, calls=5):
    """(kernel launches, device busy ms) per call of fn (torch.profiler)."""
    from tapnet_torch.profile_pack import profile_calls
    res = profile_calls(label, fn, calls)
    return sum(k["launches"] for k in res["kernels"]), res["device_busy_ms"]


def time_fused_reward(hm, plc, dims, cfg):
    """The fused launch, its plain version, the path it replaced (the
    reductions alone, then the composition as PyTorch ops), amax + sum;
    the launches and device time per call of the fused and the replaced
    path (profiler); the bound over this run's bytes and int32 operations.
    """
    from tapnet_torch.env.core import reward_from_terms
    from tapnet_torch.ops import reward as RW

    terms_cfg = cfg.reward_terms
    B, C, W, D = hm.shape
    N = plc.shape[1]

    def fused():
        return RW.fused_reward(hm, plc, dims, terms_cfg)

    def replaced():
        maxh, under = RW.heightmap_reductions(hm)
        return reward_from_terms(RW.terms_from_reductions(
            maxh, under, plc, dims, W * D), terms_cfg)

    ms = time_gpu(fused)
    plain = time_gpu(lambda: RW.fused_reward_ref(hm, plc, dims, terms_cfg))
    old_ms = time_gpu(replaced)
    lib = time_gpu(lambda: (hm.amax((2, 3)), hm.sum((2, 3))))
    new_n, new_busy = _launches_per_call("fused reward", fused)
    old_n, old_busy = _launches_per_call("replaced reward", replaced)
    # each input read once (placements: the two columns read), each output
    # written once; int32 operations: a max and an add per cell, the C/P
    # sums per container, five per block (compare, 2 multiplies, 2 adds)
    moved = (nbytes([hm, dims]) + 2 * 4 * B * N
             + 4 * (2 * B * C + 5 * B) + 4 * B)
    iops = 2 * B * C * W * D + 4 * B * C + 5 * B * N
    bound = max(1e3 * moved / HBM_BYTES_S, 1e3 * iops / I32_OPS_S)
    by = "operations" if iops / I32_OPS_S >= moved / HBM_BYTES_S else "bytes"
    return {"ms": ms, "plain_ms": plain, "old_ms": old_ms, "lib_ms": lib,
            "launches": new_n, "busy": new_busy, "old_launches": old_n,
            "old_busy": old_busy, "bytes": moved, "iops": iops,
            "bound": bound, "bound_by": by}


# ------------------------------------------------------------------ #
# phase 21: steps_per_call as a CUDA graph over the train step

def check_graph_steps(name, cfg, dev, per_step, k, batch, hidden=HIDDEN,
                      p2d=0.0, compute_dtype=None, tag="phase 21",
                      profile=True):
    """make_train_step(steps_per_call=k) on the card: the launches counted
    by its eager warm-up step (on a copy of the state) and by the capture
    of one step, each `per_step`; none counted by a call (k replays); one
    call bit-identical to k single steps (params, Adam state, key,
    metrics); assert_deterministic; wall ms per step and the device's idle
    share at k and at 1 (profiler; `profile` False: the device ms per
    step by events only)."""
    import copy

    from tapnet_torch import init_train_state, make_train_step
    from tapnet_torch.profile_pack import profile_calls
    from tapnet_torch.train.trainer import _state_tensors, assert_deterministic

    ts0 = init_train_state(SEED, cfg, hidden=hidden, device=dev)
    single = make_train_step(cfg, batch=batch, hidden=hidden,
                             mixed_p2d=p2d, compute_dtype=compute_dtype,
                             device=dev)
    multi = make_train_step(cfg, batch=batch, hidden=hidden, mixed_p2d=p2d,
                            steps_per_call=k, compute_dtype=compute_dtype,
                            device=dev)
    a = copy.deepcopy(ts0)
    for _ in range(k):
        a, m_a = single(a)
    b = copy.deepcopy(ts0)
    counters = train_counters()
    want = dict.fromkeys(counters, 0)
    want.update(per_step)
    for stage, run in (("warm-up", multi.graphed.warm_up),
                       ("capture", multi.graphed.capture)):
        for f in counters.values():
            f.launches = 0
        run(b)
        got = {n: f.launches for n, f in counters.items()}
        if got != want:
            raise AssertionError(f"{name} {stage} launches {got}, expected "
                                 f"{want}")
    b, m_b = multi(b)
    replay = {n: f.launches - got[n] for n, f in counters.items()}
    if any(replay.values()) or b.step != k:
        raise AssertionError(f"{name}: a call counted launches {replay} "
                             f"or left step {b.step} (expected {k})")
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        _equal(f"{name} k={k} call vs {k} single steps (state)", y, x)
    sa, sb = _state_dicts(a), _state_dicts(b)
    for n in sa:
        _equal(f"{name} params {n}", sb[n], sa[n])
    for n in m_a:
        _equal(f"{name} metric {n}", m_b[n], m_a[n])
    assert_deterministic(multi, b)
    rows = {}
    for label, run, steps in ((f"k={k}", lambda: multi(b), k),
                              ("k=1", lambda: single(a), 1)):
        if not profile:
            break
        res = profile_calls(label, run, 3)
        rows[label] = (res["wall_ms"] / steps, res["idle_share"],
                       res["device_busy_ms"] / steps)
    dev_ms = time_gpu(lambda: multi(b), reps=3, warm=1,
                      sleep_cycles=20_000_000) / k
    counted = {n: v for n, v in got.items() if v}
    log(f"{tag} {name} batch {batch} hidden {hidden}, steps_per_call "
        f"{k}: one step captured and replayed k times; the capture counts "
        f"{counted} (1 x the per-step launches; the eager warm-up the "
        f"same), a call counts none; one call == "
        f"{k} single steps bit for bit (params, Adam state, key, metrics); "
        f"deterministic")
    if not profile:
        log(f"{tag} {name}: device ms/step by events {dev_ms:.3f} at k={k}")
        return {f"k={k}": (None, None, dev_ms)}
    log(f"{tag} {name}: wall ms/step {rows[f'k={k}'][0]:.3f} at k={k} "
        f"(idle share {rows[f'k={k}'][1]:.3f}, busy ms/step "
        f"{rows[f'k={k}'][2]:.3f}; device ms/step by events {dev_ms:.3f}) "
        f"vs {rows['k=1'][0]:.3f} at k=1 (idle {rows['k=1'][1]:.3f}, busy "
        f"{rows['k=1'][2]:.3f})")
    return rows


# ------------------------------------------------------------------ #
# phase 22: driver config 5 (mixed 2D/3D batches) and the command line

P2D = 0.5             # the mixed configs' share of flat instances


def mixed_cases():
    """Configs run on mixed batches: multi-container (driver config 5) at
    p2d 0.5 and 1.0 (all flat), and a two-container mcs config."""
    from tapnet_torch import CONFIGS
    mc = CONFIGS["multi-container"]
    mcs = heuristic_cases()["3d-mcs-hard-multicont"]
    return [("multi-container", mc, P2D, 512),
            ("multi-container", mc, P2D, 100),
            ("multi-container", mc, 1.0, 512),
            ("multi-container", mc, 1.0, 100),
            ("3d-mcs-hard-multicont", mcs, P2D, 512)]


def check_mixed_sampler(cfg, dev, B=B_MAIN):
    """sample_batch_mixed on the card == on the CPU, every field; a flat
    instance's real blocks are one cell deep at y = 0; every instance's
    volume is its initial container's. Returns the share of flat ones."""
    from tapnet_torch import random as R
    from tapnet_torch.env.sampler import mix_flat, sample_batch_mixed

    got = sample_batch_mixed(R.key(SEED + 50, dev), B, cfg, P2D)
    want = sample_batch_mixed(R.key(SEED + 50), B, cfg, P2D)
    for f, a, b in zip(got._fields, got, want):
        _equal(f"sample_batch_mixed {f} card vs CPU", a.cpu(), b)
    flat = mix_flat(R.split(R.key(SEED + 50, dev), B), P2D)
    real = (torch.arange(cfg.num_blocks, device=dev)[None]
            < got.n_total[:, None])
    thin = ((got.dims[..., 1] == 1) & (got.pos0[..., 1] == 0)) | ~real
    if not bool(thin[flat].all()):
        raise AssertionError("a flat instance has a block deeper than one "
                             "cell or off y = 0")
    vol = torch.where(real, got.dims.long().prod(2), 0).sum(1)
    depth = torch.where(flat, 1, cfg.container_depth)
    if not torch.equal(vol, cfg.container_width * depth
                       * cfg.container_height):
        raise AssertionError("an instance's volume is not its container's")
    return flat.float().mean().item()


def check_mixed_kernels(dev):
    """K1, K2 (both modes), K5f/K5b, K4 (first, random) and the one-launch
    reward against their plain versions on mixed batches, as phases 2, 3,
    7, 10 and 20 do on 3D ones. Returns the max K2 and K5 errors."""
    from tapnet_torch import pack
    from tapnet_torch.models.tapnet import init_params

    k2_err = k5f_err = k5b_err = 0.0
    for name, cfg, p2d, B in mixed_cases():
        actor = init_params(SEED, cfg, HIDDEN, dev)
        check_select_step(cfg, B, actor, dev, p2d=p2d)
        _, e2 = check_actor_step(cfg, B, actor, dev, p2d=p2d)
        _, _, fe, (be, ba), e0 = check_replay(cfg, B, actor, dev, p2d=p2d,
                                              repeat=True)
        noops = [check_fused_rollout(cfg, B, dev, policy, repeat=True,
                                     p2d=p2d)
                 for policy in ("first", "random")]
        check_reward(cfg, B, actor, dev, p2d=p2d)
        inst = _instances(cfg, B, dev, SEED + 51, p2d)
        for policy in ("first", "random"):
            plan = pack(inst, cfg, policy=policy, key=SEED + 52, device=dev)
            check_fused_reward_case(f"{name} p2d {p2d} {policy}",
                                    *_plan_tensors(plan, inst, dev),
                                    cfg.reward_terms)
        k2_err, k5f_err, k5b_err = (max(k2_err, e2), max(k5f_err, fe),
                                    max(k5b_err, ba))
        log(f"phase 22 kernels == plain on mixed batches: {name} p2d {p2d} "
            f"B={B}: select_step and fused_rollout_batch bit-equal "
            f"({noops[0]} / {noops[1]} no-op steps), actor_select_step max "
            f"err {e2:.3e}, replay fwd {fe:.3e} bwd {ba:.3e} (scaled "
            f"{be:.3e}, two launches bit-identical), fwd vs the rollout's "
            f"logp {e0:.3e}, heightmap_reductions and the one-launch "
            "reward bit-equal")
    return k2_err, k5f_err, k5b_err


def check_mixed_rewards(cfg, actor, dev):
    """K3 at B_MAIN on a mixed batch (p2d P2D): the reductions on a sampled
    rollout's final heightmaps (check_reward), and the one-launch reward on
    that rollout's final state (what the train step hands it) and on
    pack(first/random)'s plans, bit-equal to their plain versions."""
    from tapnet_torch import pack
    from tapnet_torch import random as R
    from tapnet_torch.train import rollout as RO

    check_reward(cfg, B_MAIN, actor, dev, p2d=P2D)
    inst = _instances(cfg, B_MAIN, dev, SEED + 53, P2D)
    with torch.no_grad():
        states, _, _ = RO.rollout_batch_record(
            actor, inst, R.split(R.key(SEED + 54, dev), B_MAIN), cfg)
    check_fused_reward_case(f"p2d {P2D} B={B_MAIN} sampled rollout",
                            states.heightmap, states.placements, inst.dims,
                            cfg.reward_terms)
    for policy in ("first", "random"):
        plan = pack(inst, cfg, policy=policy, key=SEED + 52, device=dev)
        check_fused_reward_case(f"p2d {P2D} B={B_MAIN} {policy}",
                                *_plan_tensors(plan, inst, dev),
                                cfg.reward_terms)


def time_mixed_kernels(cfg, dev):
    """K1, K2 (main mode), K4 (random) and K5b per launch at B_MAIN on the
    same config's 3D-only and mixed batches (CUDA events), each with its
    plain version and its bound, as phases 5, 9 and 13 count them. Each is
    held against its plain version at that size on those operands: K1 and
    K2 as check_select_step / check_actor_step do, K4 bit-equal on every
    output, K5b within GRAD_TOL of the plain result's max magnitude (as
    check_replay). Returns ({"3d" | "mixed": {kernel: (ms, plain ms,
    bound ms)}}, (K5b's max scaled err, its max abs err))."""
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import replay as RP

    actor = init_params(SEED, cfg, HIDDEN, dev)
    out, k5b_err, k5b_abs = {}, 0.0, 0.0
    for tag, p2d in (("3d", 0.0), ("mixed", P2D)):
        k1 = time_select_step(check_select_step(
            cfg, B_MAIN, actor, dev, keep=True, p2d=p2d), cfg)
        kept, _ = check_actor_step(cfg, B_MAIN, actor, dev, keep=True,
                                   p2d=p2d)
        k2 = time_actor_step(kept, cfg, HIDDEN, plain_reps=5)
        k4 = time_fused_rollout(cfg, B_MAIN, dev, p2d)
        if k4[4] != 0:
            raise AssertionError(f"fused_rollout_batch {tag} p2d {p2d} "
                                 f"B={B_MAIN}: max |kernel - plain| {k4[4]}")
        ops, _ = replay_operands(actor, cfg, B_MAIN, dev, SEED + 10, 1.0,
                                 p2d)
        dlp = torch.linspace(-1.0, 1.0, B_MAIN, device=dev)
        k5 = time_gpu(lambda: RP.replay_logp_bwd(dlp, *ops, cfg))
        k5_plain = time_gpu(lambda: RP.replay_logp_bwd_ref(dlp, *ops, cfg),
                            reps=5, sleep_cycles=200_000_000)
        with torch.no_grad():
            got = RP.replay_logp_bwd(dlp, *ops, cfg)
            want = RP.replay_logp_bwd_ref(dlp, *ops, cfg)
        for name, a, w in zip(GRAD_NAMES, _flat_grads(got),
                              _flat_grads(want)):
            e = ((a - w).abs().max() / (w.abs().max() + 1e-12)).item()
            if not e <= GRAD_TOL:
                raise AssertionError(f"replay_logp_bwd {tag} p2d {p2d} "
                                     f"B={B_MAIN} {name}: scaled err {e}")
            k5b_err = max(k5b_err, e)
            k5b_abs = max(k5b_abs, (a - w).abs().max().item())
        d_se, d_ctx, d_par = got
        moved = (nbytes(ops[:8]) + nbytes(ops[8])
                 + nbytes([dlp, d_se, d_ctx]) + nbytes(d_par))
        pairs, triples = live_counts(cfg, ops[2], ops[3])
        flops = replay_ops_count(cfg, B_MAIN, HIDDEN, True, pairs, triples)
        out[tag] = {
            "K1": (k1["ms"], k1["plain_ms"], k1["bound"]),
            "K2": (k2["ms"], k2["plain_ms"], k2["bound"]),
            "K4": (k4[0], k4[1], 1e3 * max(k4[2] / HBM_BYTES_S,
                                           k4[3] / I32_OPS_S)),
            "K5b": (k5, k5_plain, 1e3 * max(moved / HBM_BYTES_S,
                                            flops / F32_OPS_S)),
        }
    check_mixed_rewards(cfg, actor, dev)
    return out, (k5b_err, k5b_abs)


def check_mixed_evaluate(cfg, dev, actor):
    """evaluate(mixed_p2d, baselines=True) at valid_batch B_MAIN with the
    launches the routes imply (greedy K1 x N, K4 x 2 for the baselines, and
    K3 x 2: each heuristic rollout's reward); the dict at 256 on the card
    against the CPU path: the share and count terms equal, the rest within
    1e-5. Returns (launches, dict, wall ms of a call)."""
    from tapnet_torch import TrainLoopConfig
    from tapnet_torch.ops import env as OE
    from tapnet_torch.ops import reward as RW
    from tapnet_torch.train import rollout as RO
    from tapnet_torch.train.trainer import evaluate

    counters = {"select_step": train_counters()["select_step"],
                "actor_select_step": train_counters()["actor_select_step"],
                "fused_rollout_batch": OE.fused_rollout_batch,
                "heightmap_reductions": RW.heightmap_reductions}
    r = RO.routes(cfg, True, HIDDEN, greedy=True)
    want = {"select_step": cfg.num_blocks if r.decode == "step" else 0,
            "actor_select_step": 0,
            "fused_rollout_batch": 2 if r.rollout else 0,
            "heightmap_reductions": 2 if r.rollout else 0}
    loop = TrainLoopConfig(valid_batch=B_MAIN, hidden=HIDDEN, mixed_p2d=P2D)
    for f in counters.values():
        f.launches = 0
    out = evaluate(actor, cfg, loop, baselines=True, device=dev)
    got = {k: f.launches for k, f in counters.items()}
    if got != want:
        raise AssertionError(f"evaluate launches {got}, the routes imply "
                             f"{want}")
    if not all(np.isfinite(float(v)) for v in out.values()):
        raise AssertionError(f"evaluate: {out}")
    ms = time_host(lambda: evaluate(actor, cfg, loop, baselines=True,
                                    device=dev), reps=5)
    small = TrainLoopConfig(valid_batch=256, hidden=HIDDEN, mixed_p2d=P2D)
    on_card = evaluate(actor, cfg, small, baselines=True, device=dev)
    actor_cpu = type(actor)(cfg, actor.hidden)
    actor_cpu.load_state_dict({k: v.cpu() for k, v in
                               actor.state_dict().items()})
    on_cpu = evaluate(actor_cpu, cfg, small, baselines=True, device="cpu")
    if set(on_card) != set(on_cpu):
        raise AssertionError("evaluate card vs CPU: keys differ")
    for k in on_cpu:
        a, b = float(on_card[k]), float(on_cpu[k])
        exact = k.endswith("_frac")
        if (a != b) if exact else not abs(a - b) <= 1e-5:
            raise AssertionError(f"evaluate card vs CPU {k}: {a} vs {b}")
    return got, {k: float(v) for k, v in out.items()}, ms


def _cli_process(args):
    """`python -m tapnet_torch.cli ARGS` from the repository root, run to
    its end: the CompletedProcess, output captured."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.run([sys.executable, "-m", "tapnet_torch.cli", *args],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)


def _run_cli(args, tmp):
    """`python -m tapnet_torch.cli ARGS` on the card; returns its standard
    output."""
    t0 = time.perf_counter()
    res = _cli_process(args)
    if res.returncode != 0:
        raise AssertionError(f"cli {args[0]} exited {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    log(f"  cli {' '.join(a.replace(tmp, 'D') for a in args)}: "
        f"{time.perf_counter() - t0:.1f} s")
    return res.stdout


def _json_lines(text):
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            out.append(json.loads(line))
    return out


def check_cli(cfg, dev, tmp):
    """train (with steps_per_call, a trace and nan checks), eval and
    generate through `python -m tapnet_torch.cli` on the card; the dataset
    equal to sample_batch on the CPU chunk by chunk; its instances per
    second in this process; then a from_dataset train step at B_MAIN fed
    by PackDataset over it. Returns (the train step's launches, the
    generate rate)."""
    import glob
    import os

    from tapnet_torch import init_train_state, make_train_step
    from tapnet_torch import random as R
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.train import checkpoints as ckpt
    from tapnet_torch.utils.data import PackDataset, generate_dataset

    d = os.path.join(tmp, "cli")
    spe, spc = 3, 2
    _run_cli(["train", "--config", "multi-container", "--mixed-p2d",
              str(P2D), "--epochs", "2", "--steps-per-epoch", str(spe),
              "--batch", "256", "--valid-batch", "256", "--steps-per-call",
              str(spc), "--ckpt-dir", d, "--metrics",
              os.path.join(d, "m.jsonl"), "--trace-dir",
              os.path.join(d, "trace"), "--nan-checks"], tmp)
    lines = [json.loads(x) for x in open(os.path.join(d, "m.jsonl"))]
    keys = {"step", "wall", "loss_actor", "loss_critic", "reward", "C", "P",
            "S", "grad_norm", "epoch", "env_steps_per_s",
            "env_steps_per_s_per_chip", "valid_reward", "valid_C",
            "valid_P", "valid_S", "valid_container0_frac",
            "valid_container1_frac", "valid_2d_frac"}
    steps = jax_loop_steps(2, spe, spc, traced=True)
    if ([x["step"] for x in lines] != steps
            or any(set(x) != keys for x in lines)
            or not all(np.isfinite(x["loss_actor"]) for x in lines)):
        raise AssertionError(f"cli train metrics lines: {lines}")
    traces = glob.glob(os.path.join(d, "trace", "*.json"))
    if len(traces) != 1 or '"train_step"' not in open(traces[0]).read():
        raise AssertionError(f"cli train trace: {traces}")
    path = ckpt.latest_checkpoint(d)
    if not path or not path.endswith(f"ckpt_{steps[-1]:08d}.pt"):
        raise AssertionError(f"cli train checkpoint: {path}")
    log(f"  cli train: epoch lines at steps {steps} (the JAX trainer's, "
        f"with its trace), the JAX trainer's keys; reward "
        f"{lines[-1]['reward']:.6f}, valid_2d_frac "
        f"{lines[-1]['valid_2d_frac']:.4f}, "
        f"{lines[-1]['env_steps_per_s']:.0f} env-steps/s; the trace names "
        "train_step; the checkpoint is there")
    out = _json_lines(_run_cli(["eval", "--config", "multi-container",
                                "--ckpt-dir", d, "--baselines",
                                "--mixed-p2d", str(P2D)], tmp))
    if (len(out) != 1 or out[0]["step"] != steps[-1]
            or not {"valid_2d_frac", "random_reward",
                    "first_reward"} <= set(out[0])):
        raise AssertionError(f"cli eval: {out}")
    log(f"  cli eval: {json.dumps(out[0]).replace(tmp, 'D')}")
    ds = os.path.join(d, "ds.npz")
    num, seed = 5000, 3
    out = _json_lines(_run_cli(["generate", "--config", "multi-container",
                                "--num", str(num), "--seed", str(seed),
                                "--out", ds], tmp))
    if out != [{"path": ds, "num": num}]:
        raise AssertionError(f"cli generate: {out}")
    z = np.load(ds)
    for i in range(0, num, 512):
        want = sample_batch(R.fold_in(R.key(seed), i // 512),
                            min(512, num - i), cfg)
        for f, w in zip(want._fields, want):
            if not np.array_equal(z[f][i:i + 512], w.numpy()):
                raise AssertionError(f"cli generate {f}: chunk {i // 512} "
                                     "differs from sample_batch on the CPU")
    generate_dataset(os.path.join(d, "warm.npz"), cfg, 512, device=dev)
    t0 = time.perf_counter()
    generate_dataset(os.path.join(d, "timed.npz"), cfg, num, seed,
                     device=dev)
    rate = num / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for i in range(0, num, 512):
        sample_batch(R.fold_in(R.key(seed, dev), i // 512),
                     min(512, num - i), cfg)
    torch.cuda.synchronize(dev)
    sampled = num / (time.perf_counter() - t0)
    log(f"  cli generate: {num} instances equal to sample_batch on the CPU "
        f"chunk by chunk; generate_dataset on the card {rate:.0f} "
        f"instances/s (sampling, the copy to the host, the .npz write), "
        f"the sampling of the same chunks alone {sampled:.0f}")
    inst = next(iter(PackDataset(ds, B_MAIN, shuffle_seed=0))).to(dev)
    ts = init_train_state(SEED, cfg, HIDDEN, device=dev)
    step = make_train_step(cfg, B_MAIN, HIDDEN, from_dataset=True,
                           device=dev)
    counters = train_counters()
    for f in counters.values():
        f.launches = 0
    ts, m = step(ts, inst)
    got = {k: f.launches for k, f in counters.items() if f.launches}
    want = {"actor_select_step": cfg.num_blocks, "replay_logp_bwd": 1,
            "heightmap_reductions": 1}
    if got != want or not all(np.isfinite(float(v)) for v in m.values()):
        raise AssertionError(f"from_dataset step: launches {got}, metrics "
                             f"{m}")
    log(f"  make_train_step(from_dataset=True) batch {B_MAIN} fed by "
        f"PackDataset over the generated file: launches {got}, reward "
        f"{float(m['reward']):.6f}")
    return got, rate


def check_nan_checks(cfg, dev, tmp):
    """train(nan_checks=True) from a checkpoint with one NaN parameter
    raises FloatingPointError naming it."""
    import os

    from tapnet_torch import TrainLoopConfig, init_train_state, train
    from tapnet_torch.train import checkpoints as ckpt

    d = os.path.join(tmp, "nan")
    ts = init_train_state(SEED, cfg, HIDDEN, device=dev)
    with torch.no_grad():
        ts.actor.query.weight[5, 2] = float("nan")
    ckpt.save_checkpoint(d, ts)
    loop = TrainLoopConfig(epochs=1, steps_per_epoch=2, batch=256,
                           valid_batch=256, hidden=HIDDEN, ckpt_dir=d,
                           mixed_p2d=P2D, nan_checks=True)
    try:
        train(cfg, loop, device=dev)
    except FloatingPointError as e:
        if "actor.query.weight" not in str(e):
            raise AssertionError(f"nan_checks named another tensor: {e}")
        return str(e)
    raise AssertionError("train(nan_checks=True) ran on a NaN parameter")


def phase_22(dev):
    """Phase 22 (module docstring). Returns the max K2 / K5f / K5b errors
    and the launches of its main paths: the mixed train steps, evaluate
    and the from_dataset step."""
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.train.trainer import assert_deterministic

    mcfg = CONFIGS["multi-container"]
    share = check_mixed_sampler(mcfg, dev)
    log(f"phase 22 sample_batch_mixed multi-container p2d {P2D} "
        f"B={B_MAIN}: card == CPU on every field, {share:.4f} flat; flat "
        "instances' blocks one cell deep at y = 0; every volume its "
        "initial container's")
    e2, e5f, e5b = check_mixed_kernels(dev)
    mixed_step = {"actor_select_step": mcfg.num_blocks,
                  "replay_logp_bwd": 1, "heightmap_reductions": 1}
    mixed_train, mts, mstep = train_main_path(mcfg, dev, mixed_step,
                                              n_steps=3, p2d=P2D)
    log(f"phase 22 mixed train path launches (3 steps, multi-container "
        f"p2d {P2D}, batch {B_MAIN}): {mixed_train}")
    assert_deterministic(mstep, mts)
    check_train_against_cpu(mcfg, mts, dev, p2d=P2D)
    log("phase 22 one mixed train step run twice from a copy of one state: "
        "bit-identical; a step at batch 256 against the CPU path")
    mrows = check_graph_steps(f"multi-container mixed p2d {P2D}", mcfg, dev,
                              mixed_step, 4, B_MAIN, p2d=P2D)
    eval_launches, valid, eval_ms = check_mixed_evaluate(
        mcfg, dev, init_params(SEED, mcfg, HIDDEN, dev))
    log(f"phase 22 evaluate(mixed_p2d={P2D}, baselines=True) valid_batch "
        f"{B_MAIN}: launches {eval_launches} (the routes' count), "
        f"{eval_ms:.3f} ms a call (host clock, median of 5), valid_2d_frac "
        f"{valid['valid_2d_frac']:.4f}, valid_reward "
        f"{valid['valid_reward']:.6f}, random_reward "
        f"{valid['random_reward']:.6f}, first_reward "
        f"{valid['first_reward']:.6f}; at 256 equal to the CPU path (the "
        "shares exactly, the rest within 1e-5)")
    with tempfile.TemporaryDirectory() as tmp:
        ds_launches, gen_rate = check_cli(mcfg, dev, tmp)
        nan_msg = check_nan_checks(mcfg, dev, tmp)
    log(f"phase 22 train(nan_checks=True) on a NaN parameter: "
        f"FloatingPointError({nan_msg!r})")
    mixed_ms, (s5b_main, e5b_main) = time_mixed_kernels(mcfg, dev)
    e5b = max(e5b, e5b_main)
    log(f"phase 22 kernels == plain at B={B_MAIN} on multi-container, 3D-only "
        f"and mixed (p2d {P2D}): select_step, fused_rollout_batch (random) "
        f"bit-equal, actor_select_step within TOL, replay_logp_bwd max err "
        f"{e5b_main:.3e} (scaled {s5b_main:.3e}, GRAD_TOL {GRAD_TOL}); on "
        "the mixed batch heightmap_reductions and the one-launch reward "
        "(sampled rollout, pack first/random) bit-equal")
    for k in ("K1", "K2", "K4", "K5b"):
        (ms, plain, bnd), (ms3, plain3, bnd3) = (mixed_ms["mixed"][k],
                                                mixed_ms["3d"][k])
        log(f"phase 22 {k} multi-container B={B_MAIN}: {ms:.4f} ms/launch "
            f"on mixed batches (p2d {P2D}; plain {plain:.4f}, bound "
            f"{bnd:.5f}) vs {ms3:.4f} on 3D-only ones (plain {plain3:.4f}, "
            f"bound {bnd3:.5f})")
    log(f"phase 22 mixed train step: wall ms/step "
        f"{mrows['k=4'][0]:.3f} at k=4 (idle {mrows['k=4'][1]:.3f}) vs "
        f"{mrows['k=1'][0]:.3f} at k=1 (idle {mrows['k=1'][1]:.3f}); "
        f"evaluate {eval_ms:.3f} ms; generate {gen_rate:.0f} instances/s")
    return {"k2_err": e2, "k5f_err": e5f, "k5b_err": e5b,
            "train": mixed_train, "evaluate": eval_launches,
            "from_dataset": ds_launches}


# ------------------------------------------------------------------ #
# phase 23: the benchmark entry point and data parallelism (world 1)

def bench_counters():
    from tapnet_torch.ops import env as OE
    return dict(train_counters(), fused_rollout_batch=OE.fused_rollout_batch)


def _count(run):
    """The launches of every kernel during run(), counts set to 0 first."""
    counters = bench_counters()
    for f in counters.values():
        f.launches = 0
    out = run()
    return {k: f.launches for k, f in counters.items()}, out


def check_headline():
    """`python -m tapnet_torch.benchmarks` (main()) at 2d-basic, batch 4096:
    the headline record with its device anchors, the oracle and native
    baselines and vs_baseline; returns (record, launches, seconds)."""
    import contextlib
    import io

    from tapnet_torch import benchmarks as BM
    from tapnet_torch import native

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        launches, rc = _count(lambda: BM.main([]))
    secs = time.perf_counter() - t0
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or not native.is_available():
        raise AssertionError(f"benchmarks.main rc {rc}, native "
                             f"{native.is_available()}")
    for k in ("device_ms", "device_env_steps_per_s",
              "train_device_ms_per_step", "train_device_env_steps_per_s",
              "host_oracle_steps_per_s", "host_native_1t_steps_per_s"):
        if not (rec.get(k) or 0) > 0:
            raise AssertionError(f"headline {k} = {rec.get(k)!r}: {rec}")
    # a call's device time is at most its wall time: the anchor against the
    # unprofiled wall of the timed windows (their median)
    ratios = {}
    for row, wall, dev_rate in (
            ("env", "wall_env_steps_per_s", "device_env_steps_per_s"),
            ("train", "train_env_steps_per_s",
             "train_device_env_steps_per_s")):
        ratios[row] = rec[wall] / rec[dev_rate]   # device ms / wall ms
        if ratios[row] > ANCHOR_OVER_WALL:
            raise AssertionError(
                f"{row} device anchor {ratios[row]:.4f}x the unprofiled wall "
                f"time per call (at most {ANCHOR_OVER_WALL}): {rec}")
    if not (np.isfinite(rec["vs_baseline"]) and rec["vs_baseline"] > 0):
        raise AssertionError(f"vs_baseline {rec['vs_baseline']!r}")
    for k in ("fused_rollout_batch", "actor_select_step", "replay_logp_bwd",
              "heightmap_reductions"):
        if launches[k] == 0:
            raise AssertionError(f"benchmarks.main launched no {k}: "
                                 f"{launches}")
    return rec, launches, secs, ratios


def check_env_graph(cfg, dev, group=16):
    """The benchmark's grouped call, one CUDA graph of `group` K4 rollouts,
    against the same rollouts run eagerly with the same keys: checksums
    bit-equal over two calls; times of both per rollout."""
    from tapnet_torch import benchmarks as BM
    from tapnet_torch import random as R
    from tapnet_torch.env.sampler import sample_batch

    inst = sample_batch(R.key(SEED + 23, dev), B_MAIN, cfg)
    keys = BM._key_groups(2, group, B_MAIN, dev)
    graphed = BM._env_call(cfg, inst, group, True, dev)
    eager = BM._env_call(cfg, inst, group, True, dev, graph=False)
    if not isinstance(graphed, BM._GraphedRollouts):
        raise AssertionError("the fused grouped call is not a graph")
    sums = []
    for i in range(2):
        got = [t.clone() for t in graphed(keys[i])]
        want = eager(keys[i])
        _equal(f"grouped graph call {i} checksums", torch.stack(
            [got[0].double(), got[1].double()]),
            torch.stack([want[0].double(), want[1].double()]))
        sums.append((float(got[0]), int(got[1])))
    g_ms = time_host(lambda: graphed(keys[0]), reps=5) / group
    e_ms = time_host(lambda: eager(keys[0]), reps=5) / group
    return sums, g_ms, e_ms


def _rank_steps(mesh, name, batch, hidden, n_steps):
    """Two-rank check (run_ranks): n_steps sharded steps from
    init_train_state(SEED); the metrics and the parameters, on the CPU."""
    from tapnet_torch import CONFIGS, init_train_state, make_train_step
    ts = init_train_state(SEED, CONFIGS[name], hidden, device=mesh.device)
    step = make_train_step(CONFIGS[name], batch, hidden, mesh=mesh)
    ms = []
    for _ in range(n_steps):
        ts, m = step(ts)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, {k: v.cpu() for k, v in _state_dicts(ts).items()}


def _state_equal(name, a, b):
    """Params, Adam buffers, key and step of two TrainStates bit-equal."""
    for k, v in _state_dicts(a).items():
        _equal(f"{name} {k}", v, _state_dicts(b)[k])
    for k in ("_mu", "_nu", "_count"):
        _equal(f"{name} adam {k}", getattr(a.opt, k), getattr(b.opt, k))
    _equal(f"{name} key", a.key, b.key)
    if a.step != b.step:
        raise AssertionError(f"{name}: step {a.step} != {b.step}")


def check_mesh_steps(cfg, dev):
    """A world-1 NCCL mesh (`parallel.data_mesh`) step at batch 4096 against
    the unsharded step from the same state: 3 steps, then one call at
    steps_per_call=4 (the all-reduces captured in the graph), states and
    metrics bit-equal; launches of the mesh's 3 steps; wall ms per step of
    both at k = 1 and k = 4. Where two cards are visible, two NCCL ranks
    against one process within the tier-2 tolerances."""
    import copy

    import torch.distributed as dist

    from tapnet_torch import init_train_state, make_train_step
    from tapnet_torch.parallel import data_mesh

    mesh = data_mesh(dev)
    if mesh.world_size != 1 or "nccl" not in str(dist.get_backend()):
        raise AssertionError(f"data_mesh: {mesh}, {dist.get_backend()}")
    ts0 = init_train_state(SEED, cfg, HIDDEN, device=dev)
    per_step = {"actor_select_step": cfg.num_blocks, "replay_logp_bwd": 1,
                "heightmap_reductions": 1}
    states, metrics, launches, ms = {}, {}, {}, {}
    for k in (1, 4):
        for label, m_ in (("unsharded", None), ("mesh", mesh)):
            ts = copy.deepcopy(ts0)
            step = make_train_step(cfg, B_MAIN, HIDDEN, mesh=m_,
                                   steps_per_call=k, device=dev)
            calls = 3 if k == 1 else 1

            def run():
                out = []
                for _ in range(calls):
                    out.append(step(ts)[1])
                return out

            counts, out = _count(run)
            states[label, k] = ts
            metrics[label, k] = out
            if label == "mesh" and k == 1:
                want = {n: 3 * per_step.get(n, 0) for n in counts}
                if counts != want:
                    raise AssertionError(f"mesh steps launches {counts}, "
                                         f"expected {want}")
                launches = counts
            tt = copy.deepcopy(ts)
            ms[label, k] = time_host(lambda: step(tt), reps=5) / k
        _state_equal(f"world-1 mesh vs unsharded k={k}",
                     states["mesh", k], states["unsharded", k])
        for a, b in zip(metrics["mesh", k], metrics["unsharded", k]):
            for name in a:
                _equal(f"mesh k={k} metric {name}", a[name], b[name])
    two = None
    if torch.cuda.device_count() >= 2:
        from tapnet_torch.parallel.scaling import run_ranks
        ranks = run_ranks(_rank_steps, 2, ("2d-basic", B_MAIN, HIDDEN, 3),
                          device="cuda", timeout_s=300)
        ref = metrics["unsharded", 1]
        for (m0, _), (m1, _) in zip(ranks, ranks[1:]):
            if m0 != m1:
                raise AssertionError("two ranks' metrics differ")
        rtol = {"loss_actor": 1e-4, "grad_norm": 1e-4}
        two = 0.0
        for got, want in zip(ranks[0][0], ref):
            for name, v in want.items():
                err = abs(got[name] - float(v)) / max(abs(float(v)), 1e-12)
                two = max(two, err)
                if err > rtol.get(name, 1e-5):
                    raise AssertionError(f"two ranks vs one: {name} "
                                         f"{got[name]} vs {float(v)}")
        for k, v in ranks[0][1].items():
            if not torch.equal(v, ranks[1][1][k]):
                raise AssertionError(f"two ranks' {k} differ")
    dist.destroy_process_group()
    return launches, ms, two


def phase_23(dev):
    """Phase 23 (module docstring). Returns the launches of its main paths:
    benchmarks.main()'s headline and the world-1 mesh steps."""
    from tapnet_torch import CONFIGS

    cfg = CONFIGS["2d-basic"]
    rec, bench_launches, secs, ratios = check_headline()
    log(f"phase 23 benchmarks.main() 2d-basic B={B_MAIN} in {secs:.1f} s: "
        + json.dumps(rec))
    log("phase 23 device anchor / unprofiled wall per call (1 - it is the "
        "idle share): " + ", ".join(f"{k} {v!r}" for k, v in ratios.items()))
    log(f"phase 23 benchmarks.main() launches: {bench_launches}")
    sums, g_ms, e_ms = check_env_graph(cfg, dev)
    log(f"phase 23 grouped call, one CUDA graph of 16 K4 rollouts B="
        f"{B_MAIN} == the same 16 rollouts eagerly, checksums bit-equal "
        f"over 2 calls {sums}; {g_ms:.4f} ms/rollout as a graph, "
        f"{e_ms:.4f} eagerly (host clock, median of 5 calls)")
    with tempfile.TemporaryDirectory() as tmp:
        out = _json_lines(_run_cli(["bench", "--config", "2d-basic",
                                    "--batch", str(B_MAIN), "--iters",
                                    "128"], tmp))[-1]
    if set(out) != {"env_steps_per_s", "batch"} or not (
            out["env_steps_per_s"] > 0 and out["batch"] == B_MAIN):
        raise AssertionError(f"cli bench printed {out}")
    log(f"phase 23 python -m tapnet_torch.cli bench: {json.dumps(out)}")
    mesh_launches, ms, two = check_mesh_steps(cfg, dev)
    log(f"phase 23 world-1 NCCL mesh step 2d-basic B={B_MAIN} == unsharded, "
        f"bit-equal: 3 steps (launches {mesh_launches}) and one call at "
        f"steps_per_call=4 (all-reduces in the graph)")
    log(f"phase 23 wall ms/step (host clock, median of 5 calls): mesh "
        f"{ms['mesh', 1]:.3f} vs unsharded {ms['unsharded', 1]:.3f} at k=1; "
        f"mesh {ms['mesh', 4]:.3f} vs unsharded {ms['unsharded', 4]:.3f} at "
        f"k=4")
    if two is None:
        log(f"phase 23 {torch.cuda.device_count()} card visible: no "
            "two-rank check, no scaling number")
    else:
        log(f"phase 23 two NCCL ranks vs one process, 3 steps: metrics "
            f"within {two:.3e} relative, ranks' parameters bit-identical")
    return bench_launches, mesh_launches



# ------------------------------------------------------------------ #
# phase 24: the bf16 compute dtype on the card

BF16 = torch.bfloat16
# bf16 logits / logp, kernel vs plain: 1e-2 absolute (SPEC.md §12) plus one
# bf16 ulp of the value (the scores are rounded to bf16 before they become
# float32 logits; an accumulation order that moves a sum across a rounding
# boundary moves it by one ulp, which is 2^-7 of |m| at most for a score of
# magnitude m: 2^-7 |m| at the bottom of a binade, 2^-8 |m| at its top)
BF16_ATOL, BF16_RTOL = 1e-2, 2.0 ** -7
BF16_AGREE = 0.99      # K2 bf16 vs plain: action agreement per config
BF16_VALUE_TOL = 1e-2  # K5f bf16 vs plain (and the rollout's logp), relative
# K5b bf16 vs plain, of the plain result's max magnitude: ~4x the largest
# reading of the first run (1.27e-3 at 2d-basic, batch 4096; PERF.md §6),
# as GRAD_TOL is to the f32 readings
BF16_GRAD_TOL = 5e-3
PARITY_AGREE, PARITY_REWARD = 0.9, 0.02  # scripts/tpu_parity.py's bf16 gate


def _bf16_close(what, got, want):
    d = (got - want).abs()
    if not bool((d <= BF16_ATOL + BF16_RTOL * want.abs()).all()):
        raise AssertionError(f"{what}: max err {d.max().item()}")
    return d.max().item() if d.numel() else 0.0


def check_actor_step_bf16(cfg, B, actor, dev, keep=False, temperature=1.0):
    """Sampled lockstep rollout in bf16 at `temperature`: at every step
    both modes of K2's bf16 instantiation and the full plain bf16 version
    on the same inputs. Logits within BF16_ATOL + BF16_RTOL |logit|; flags
    and mask equal; the actions of the main path's mode agree with the
    plain version's on more than BF16_AGREE of the (instance, step) pairs,
    and where they agree the new state rows are equal and logp is within
    the logit tolerance. The two modes give every output but the logits
    bit for bit alike (the same products for every live column), and a
    second launch of each mode repeats its outputs bit for bit. The rollout
    advances on the main-path mode's outputs. Returns (the middle step's
    bf16 and float32 operands when `keep`, max logit/logp err, the
    agreement)."""
    from tapnet_torch import random as R
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.train import rollout as RO

    N = cfg.num_blocks
    inst = _instances(cfg, B, dev, SEED + 2)
    keys = R.split(R.key(SEED + 3, dev), B)
    kept, err, agree, pairs = None, 0.0, 0, 0
    names = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    with torch.no_grad():
        o = actor_operands(actor, inst, cfg, keys, BF16)
        (dw, dd, dh), packed, hm, plc = RO._batch_last(inst, cfg)
        prev = torch.full((1, B), -1, dtype=torch.int32, device=dev)
        for t in range(N):
            tf = torch.full((1, 1), t, dtype=torch.float32, device=dev) / N
            ops = (tf, packed, hm, plc, prev, dw, dd, dh, o["upm"],
                   o["rotm"], o["fits"], o["g_all"][t], o["se"], o["ctx"],
                   o["statp"], o["statm"], o["params"])
            if keep and t == N // 2:
                f = actor_operands(actor, inst, cfg, keys)
                kept = (ops, ops[:12] + (f["se"], f["ctx"], f["statp"],
                                         f["statm"], f["params"]))
            want = AS.actor_select_step_ref(*ops, cfg, temperature)
            outs = {}
            for logits in (True, False):
                got = AS.actor_select_step(*ops, cfg, temperature,
                                           logits=logits)
                again = AS.actor_select_step(*ops, cfg, temperature,
                                             logits=logits)
                what = f"actor_select_step bf16 (logits={logits})"
                for name, g, a in zip(names, got, again):
                    if g is not None:
                        _equal(f"{what} repeat {name} step {t}", g, a)
                outs[logits] = got
                same = got[3] == want[3]
                for name, g, w in zip(names, got, want):
                    if name == "logits":
                        if not logits:
                            if g is not None:
                                raise AssertionError(
                                    f"{what} returned logits")
                            continue
                        err = max(err, _bf16_close(
                            f"{what} logits step {t}", g, w))
                    elif name == "logp":
                        err = max(err, _bf16_close(
                            f"{what} logp step {t}", g[same], w[same]))
                    elif name in ("flags", "mask"):
                        _equal(f"{what} {name} step {t}", g, w)
                    else:
                        _equal(f"{what} {name} step {t}", g[..., same],
                               w[..., same])
            for name, f, m in zip(names, outs[True], outs[False]):
                if name != "logits":
                    _equal(f"actor_select_step bf16 modes {name} step {t}",
                           f, m)
            acting = want[3] >= 0
            agree += int((same & acting).sum())
            pairs += int(acting.sum())
            packed, hm, plc, prev = got[0], got[1], got[2], got[3][None]
    rate = agree / max(pairs, 1)
    if not rate > BF16_AGREE:
        raise AssertionError(f"actor_select_step bf16 {cfg} B={B}: action "
                             f"agreement {rate} <= {BF16_AGREE}")
    return kept, err, rate


def actor_bf16_shapes():
    """(config, batch, hidden, temperature) where the tensor-core tiling of
    K2's bf16 body can break: hidden widths below 128 (fewer row tiles
    than warps), a ragged batch, and a tempered multi-container rollout
    (C = 2, W*D + 2 = 66: W1 staged by element loads)."""
    return ([("2d-basic", 256, h, 1.0) for h in (32, 64, 96)]
            + [("2d-basic", 100, HIDDEN, 1.0),
               ("multi-container", 256, HIDDEN, 0.7)])


def check_actor_bf16_shapes(dev, log_fn):
    """`check_actor_step_bf16` (both modes against the plain bf16 version,
    the modes alike, launches repeated bit for bit) on each case of
    `actor_bf16_shapes`. Returns the largest logit/logp error."""
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params

    worst = 0.0
    for name, B, h, temp in actor_bf16_shapes():
        cfg = CONFIGS[name]
        actor = init_params(SEED, cfg, h, dev)
        _, err, rate = check_actor_step_bf16(cfg, B, actor, dev,
                                             temperature=temp)
        worst = max(worst, err)
        log_fn(f"actor_select_step bf16 == plain bf16: {name} B={B} hidden "
               f"{h} temperature {temp}: max logit/logp err {err:.3e}, "
               f"action agreement {rate:.6f}; the two modes alike and two "
               "launches of each bit-identical")
    return worst


def check_actor_smem_mirror():
    """ops.actor_step.smem_bytes against the kernel's own plan
    (`tapnet_actor_smem_bytes`) for the six CONFIGS, every multiple of 32
    up to MAX_H (512; the kernel takes those of 64 above 256), both
    dtypes. Returns the cases."""
    import ctypes

    from tapnet_torch import CONFIGS
    from tapnet_torch.ops import _build
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops.policy_step import env_ints

    fn = _build.load("actor_step").tapnet_actor_smem_bytes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    n = 0
    for cfg in CONFIGS.values():
        for h in range(32, AS.MAX_H + 1, 32):
            for dt in (torch.float32, BF16):
                bf = int(dt == BF16)
                ints = _build.int_array([1] + env_ints(cfg)
                                        + [h, cfg.window, 0, bf])
                want = fn(ctypes.cast(ints, ctypes.c_void_p), bf)
                got = AS.smem_bytes(cfg, h, dt)
                if got != want:
                    raise AssertionError(
                        f"actor_step smem_bytes {cfg} h={h} {dt}: mirror "
                        f"{got}, kernel {want}")
                n += 1
    return n


def check_replay_bf16(cfg, B, actor, dev, steps, repeat=False,
                      temperature=1.0, p2d=0.0, record=None):
    """K5f and K5b (`steps`: their step-grid schedule) in bf16 against
    their plain bf16 versions on a bf16 rollout record of the card at
    `temperature` (`p2d`: a mixed batch; `record`: the (bf16 operands,
    logp, float32 operands) of `replay_operands` to reuse): values within
    BF16_VALUE_TOL relative (+1e-3), and K5f against the rollout's own logp
    (the train step's primal, from K2 bf16 or the route the config takes)
    as closely; every gradient within BF16_GRAD_TOL of the plain result's
    max magnitude; with `repeat`, two backward launches bit-identical.
    Returns (bf16 operands, float32 operands of the same record, dlp, fwd
    err, (bwd scaled err, bwd abs err), err against the rollout's logp)."""
    ops, lp0, ops32 = record or replay_operands(
        actor, cfg, B, dev, SEED + 10, temperature, p2d, dtype=BF16,
        also=torch.float32)
    fwd, fwd_ref, bwd, bwd_ref = replay_fns(ops, cfg, temperature, steps)
    what = "replay_logp_fwd_steps bf16" if steps else "replay_logp_fwd bf16"
    dlp = torch.linspace(-1.0, 1.0, B, device=dev)
    with torch.no_grad():
        got = fwd()
        errs = [_hold_values(f"{what} vs {label}", got, ref, BF16_VALUE_TOL,
                             1e-3)
                for label, ref in (("plain", fwd_ref()),
                                   ("the rollout's logp", lp0))]
        g1 = bwd(dlp)
        b_errs = _hold_grads(what, g1, bwd_ref(dlp), BF16_GRAD_TOL)
        if repeat:
            for name, a, b in zip(GRAD_NAMES, _flat_grads(g1),
                                  _flat_grads(bwd(dlp))):
                _equal(f"{what} backward repeat {name}", a, b)
    return ops, ops32, dlp, errs[0], b_errs, errs[1]


def replay_bf16_shapes():
    """(config, batch, hidden, temperature, p2d) where a tensor-core tiling
    of the bf16 replay can break: hidden widths below 128 (fewer row tiles
    than warps), a ragged batch, a tempered and a mixed multi-container
    record (C = 2, 3D heightmaps, W*D + 2 = 66), and a capped record from
    its own route (K1)."""
    return ([("2d-basic", 256, h, 1.0, 0.0) for h in (32, 64, 96)]
            + [("2d-basic", 100, HIDDEN, 1.0, 0.0),
               ("multi-container", 256, HIDDEN, 0.7, 0.0),
               ("multi-container", 512, HIDDEN, 1.0, 0.5),
               ("multi-container-capped", 256, HIDDEN, 1.0, 0.0)])


def check_replay_bf16_shapes(dev, log_fn):
    """K5f / K5b bf16 and their step-grid schedule (forced onto these
    monolithic configs) against their plain bf16 versions on each case of
    `replay_bf16_shapes`, one record each, with a bit-identical backward
    repeat. Returns the largest scaled gradient error."""
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params

    worst = 0.0
    for name, B, h, temp, p2d in replay_bf16_shapes():
        cfg = CONFIGS[name]
        actor = init_params(SEED, cfg, h, dev)
        rec = replay_operands(actor, cfg, B, dev, SEED + 10, temp, p2d,
                              dtype=BF16, also=torch.float32)
        for steps in (False, True):
            _, _, _, fe, (be, ba), e0 = check_replay_bf16(
                cfg, B, actor, dev, steps, repeat=True, temperature=temp,
                record=rec)
            worst = max(worst, be)
            key = "steps" if steps else "mono"
            log_fn(f"replay bf16 == plain bf16 ({key}): {name} B={B} "
                   f"hidden {h} temperature {temp}"
                   f"{f' p2d {p2d}' if p2d else ''}: fwd max err {fe:.3e}, "
                   f"bwd max scaled err {be:.3e} (abs {ba:.3e}); fwd vs the "
                   f"rollout's logp {e0:.3e}; two bwd launches "
                   "bit-identical")
    return worst


def check_replay_smem_mirror():
    """ops.replay.smem_bytes against the kernel's own plan
    (`tapnet_replay_smem_bytes`) for the six CONFIGS, every multiple of 32
    up to MAX_H (512), both schedules, forward and backward, both dtypes.
    Returns the cases."""
    import ctypes

    from tapnet_torch import CONFIGS
    from tapnet_torch.ops import _build
    from tapnet_torch.ops import replay as RP

    lib = _build.load("replay")
    fn = lib.tapnet_replay_smem_bytes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int]
    fn.restype = ctypes.c_longlong
    n = 0
    for cfg in CONFIGS.values():
        for h in range(32, RP.MAX_H + 1, 32):
            ints = _build.int_array(RP._ints(cfg, 1, h))
            for bwd in (False, True):
                for steps in (False, True):
                    for dt in (torch.float32, BF16):
                        want = fn(ctypes.cast(ints, ctypes.c_void_p),
                                  int(bwd), int(steps), int(dt == BF16))
                        got = RP.smem_bytes(cfg, h, bwd, steps, dt)
                        if got != want:
                            raise AssertionError(
                                f"replay smem_bytes {cfg} h={h} bwd={bwd} "
                                f"steps={steps} {dt}: mirror {got}, kernel "
                                f"{want}")
                        n += 1
    return n


def check_replay_record_mirror():
    """ops.replay.record_floats against the kernel's own record layout
    (`tapnet_replay_record_floats`) for the six CONFIGS, every hidden width
    the kernels cover and both dtypes (0 for float32 at h <= 128, which
    keeps no records). Returns the cases."""
    from tapnet_torch import CONFIGS
    from tapnet_torch.ops import replay as RP

    n = 0
    for cfg in CONFIGS.values():
        for h in range(32, RP.MAX_H + 1, 32):
            for dt in (torch.float32, BF16):
                got = RP.record_floats(cfg, h, dt)
                want = RP._record_floats(cfg, h, dt)
                if got != want:
                    raise AssertionError(
                        f"replay record_floats {cfg} h={h} {dt}: mirror "
                        f"{got}, kernel {want}")
                n += 1
    return n


def check_train_bf16_against_cpu(cfg, ts, dev, B=256):
    """One bf16 step at batch B from one state on the card (K2, K5b) and on
    the CPU (the general route: the flax head): the instances equal; the
    rollouts pass scripts/tpu_parity.py's bf16 gate (actions agree on more
    than PARITY_AGREE of the record, the mean rewards within
    PARITY_REWARD); then the whole step on both: reward, C, P and S within
    PARITY_REWARD, loss_critic within 10% relative, every metric finite.
    Returns (agreement, reward diff, metric diffs)."""
    import copy

    from tapnet_torch import make_train_step
    from tapnet_torch import random as R
    from tapnet_torch.env import core as E
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.train import reinforce as TR
    from tapnet_torch.train import rollout as RO

    gpu = copy.deepcopy(ts)
    cpu = TR.train_state(copy.deepcopy(ts.actor).cpu(),
                         copy.deepcopy(ts.critic).cpu(), ts.key.cpu())
    side = {}
    with torch.no_grad():
        for name, st in (("card", gpu), ("cpu", cpu)):
            ks = R.split(st.key, 3)
            inst = sample_batch(ks[1], B, cfg)
            states, rec, _ = RO.rollout_batch_record(
                st.actor, inst, R.split(ks[2], B), cfg, dtype=BF16)
            side[name] = (inst, rec.action, E.reward(states, inst, cfg))
    for a, b in zip(side["card"][0], side["cpu"][0]):
        _equal("bf16 train instances card vs CPU", a.cpu(), b)
    agree = (side["card"][1].cpu() == side["cpu"][1]).float().mean().item()
    drew = abs(side["card"][2].mean().item() - side["cpu"][2].mean().item())
    if not (agree > PARITY_AGREE and drew < PARITY_REWARD):
        raise AssertionError(f"bf16 rollouts card vs CPU: agreement {agree}, "
                             f"mean reward diff {drew}")
    h = ts.actor.hidden
    _, m_g = make_train_step(cfg, batch=B, hidden=h, compute_dtype=BF16,
                             device=dev)(gpu)
    _, m_c = make_train_step(cfg, batch=B, hidden=h, compute_dtype=BF16,
                             device="cpu")(cpu)
    diffs = {k: abs(float(m_g[k]) - float(m_c[k])) for k in m_g}
    if not all(np.isfinite(float(v)) for m in (m_g, m_c) for v in m.values()):
        raise AssertionError(f"bf16 step metrics {m_g} / {m_c}")
    for k in ("reward", "C", "P", "S"):
        if not diffs[k] < PARITY_REWARD:
            raise AssertionError(f"bf16 step card vs CPU: {k} differs by "
                                 f"{diffs[k]}")
    if not diffs["loss_critic"] <= 0.1 * abs(float(m_c["loss_critic"])):
        raise AssertionError(f"bf16 step card vs CPU: loss_critic "
                             f"{float(m_g['loss_critic'])} vs "
                             f"{float(m_c['loss_critic'])}")
    return agree, drew, diffs


def time_actor_dtypes(kept, cfg, hidden=HIDDEN):
    """K2's main-path mode on one step's operands in float32 and bf16, in
    turns (f32, bf16, bf16, f32; CUDA events), and the bf16 instantiation's
    full `time_actor_step` record (plain version, bound)."""
    from tapnet_torch.ops import actor_step as AS

    ops_b, ops_f = kept
    run = {}
    for tag, ops in (("bf16", ops_b), ("f32", ops_f)):
        pt = AS.transposed(ops[16])
        wide = AS.wide_operands(ops[16], ops[13], cfg)
        run[tag] = (lambda ops=ops, pt=pt, wide=wide: AS.actor_select_step(
            *ops, cfg, logits=False, params_t=pt, wide=wide))
    turns = [time_gpu(run[t]) for t in ("f32", "bf16", "bf16", "f32")]
    k = time_actor_step(ops_b, cfg, hidden, plain_reps=5,
                        plain_sleep=200_000_000)
    k.update(f32_turns=(turns[0], turns[3]), bf16_turns=(turns[1], turns[2]))
    return k


def time_replay_dtypes(ops, ops32, dlp, cfg, steps, hidden=HIDDEN,
                       f32=False):
    """K5f and K5b (`steps`: their step-grid schedule) on one record's bf16
    and float32 operands in turns (f32, bf16, bf16, f32; CUDA events), their
    plain bf16 versions, and the bf16 bounds: the bytes at each operand's
    width (the prev rows too on the step grid), the products at the bf16
    tensor-core peak, the rest at the f32 rate, over the live columns.
    With `f32`, also the plain float32 versions' times and the float32
    bounds (every operation at the f32 rate; above hidden 128 also with the
    products that run as 3xTF32 at that rate, `tf32x3_ops_ms`). Returns
    {"fwd": {...}, "bwd": {...}}."""
    fwd, fwd_ref, bwd, bwd_ref = replay_fns(ops, cfg, 1.0, steps)
    fwd32, fwd32_ref, bwd32, bwd32_ref = replay_fns(ops32, cfg, 1.0, steps)
    reps = 10 if steps else REPS
    B = dlp.shape[0]
    pairs, triples = live_counts(cfg, ops[2], ops[3])
    moved = (nbytes(ops[:8]) + nbytes(ops[8])
             + (nbytes([ops[3]]) if steps else 0))
    d_se, d_ctx, d_par = bwd(dlp)
    out_b = nbytes([dlp, d_se, d_ctx]) + nbytes(d_par)
    del d_se, d_ctx, d_par
    moved32 = (nbytes(ops32[:8]) + nbytes(ops32[8])
               + (nbytes([ops32[3]]) if steps else 0))
    res = {}
    for label, kern, kern32, ref, ref32, extra, bwd_ in (
            ("fwd", fwd, fwd32, fwd_ref, fwd32_ref, 4 * B, False),
            ("bwd", lambda: bwd(dlp), lambda: bwd32(dlp),
             lambda: bwd_ref(dlp), lambda: bwd32_ref(dlp), out_b, True)):
        turns = [time_gpu(f, reps=reps)
                 for f in (kern32, kern, kern, kern32)]
        plain = time_gpu(ref, reps=2 if steps else 5,
                         sleep_cycles=400_000_000, warm=1)
        split = replay_ops_split(cfg, B, hidden, bwd_, pairs, triples)
        t_ops = ops_ms(split, BF16)
        b = moved + extra
        res[label] = {
            "ms": statistics.median(turns[1:3]),
            "f32_ms": statistics.median((turns[0], turns[3])),
            "turns": turns, "plain_ms": plain, "bytes": b,
            "products": split[0], "elementwise": split[1],
            "bound": max(1e3 * b / HBM_BYTES_S, t_ops),
            "bound_by": ("operations" if t_ops >= 1e3 * b / HBM_BYTES_S
                         else "bytes")}
        if f32:
            b32 = moved32 + extra
            o32 = ops_ms(split, torch.float32)
            res[label].update(
                f32_plain_ms=time_gpu(ref32, reps=2 if steps else 5,
                                      sleep_cycles=400_000_000, warm=1),
                f32_bytes=b32,
                f32_bound=max(1e3 * b32 / HBM_BYTES_S, o32),
                f32_bound_by=("operations" if o32 >= 1e3 * b32 / HBM_BYTES_S
                              else "bytes"))
            if hidden > 128:
                res[label]["f32_bound_3xtf32"] = max(
                    1e3 * b32 / HBM_BYTES_S,
                    tf32x3_ops_ms(cfg, B, hidden, bwd_, pairs, triples))
    return res


def time_train_dtypes(cfg, dev, k, batch=B_MAIN):
    """The train step at steps_per_call k in float32 and bf16 from one
    seeded state each, in turns (f32, bf16, bf16, f32): the host clock's
    ms/step (median of 3 calls) and utils.profiling.device_time_ms's device
    ms/step (2 profiled calls)."""
    from tapnet_torch import init_train_state, make_train_step
    from tapnet_torch.utils.profiling import device_time_ms

    runs = {}
    for tag, dt in (("f32", None), ("bf16", BF16)):
        ts = init_train_state(SEED, cfg, hidden=HIDDEN, device=dev)
        step = make_train_step(cfg, batch=batch, hidden=HIDDEN,
                               steps_per_call=k, compute_dtype=dt,
                               device=dev)
        runs[tag] = (lambda step=step, ts=ts: step(ts))
    out = {"f32": [], "bf16": []}
    for tag in ("f32", "bf16", "bf16", "f32"):
        host = time_host(runs[tag], reps=3) / k
        out[tag].append((host, device_time_ms(runs[tag], iters=2) / k))
    return out


def phase_24(dev):
    """Phase 24 (module docstring): the bf16 compute dtype on the card.
    Returns the kernels-line entries of the bf16 instantiations."""
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.train.trainer import assert_deterministic

    t0 = time.perf_counter()
    stamp = lambda: f"phase 24 [{time.perf_counter() - t0:.0f} s]"
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg, rcfg = CONFIGS["2d-basic"], CONFIGS["2d-rolling"]
    mcfg = CONFIGS["multi-container"]
    actors = {n: init_params(SEED, CONFIGS[n], HIDDEN, dev)
              for n in ("2d-basic", "2d-rolling", "multi-container")}
    # 1. K2 bf16 (both modes) against its plain bf16 version, lockstep
    k2_err, kept = 0.0, {}
    for name, B in (("2d-basic", B_MAIN), ("2d-rolling", 512),
                    ("2d-rolling", B_MAIN), ("multi-container", 512)):
        k, err, rate = check_actor_step_bf16(
            CONFIGS[name], B, actors[name], dev, keep=B == B_MAIN)
        if k is not None:
            kept[name] = k
        k2_err = max(k2_err, err)
        log(f"{stamp()} actor_select_step bf16 == plain bf16: {name} B={B}, "
            f"max logit/logp err {err:.3e}, action agreement {rate:.6f}; "
            "the two modes alike and two launches of each bit-identical")
    # 1b. the tensor-core body at the shapes a tiling can break, and the
    # shared-memory plan's mirror
    k2_err = max(k2_err, check_actor_bf16_shapes(
        dev, lambda m: log(f"{stamp()} {m}")))
    log(f"{stamp()} actor_step smem_bytes mirror == the kernel's on "
        f"{check_actor_smem_mirror()} cases")
    # 2. K5 bf16 against its plain bf16 versions on the card's bf16 records
    k5 = {}
    for name, B, steps in (("2d-basic", B_MAIN, False),
                           ("multi-container", 512, False),
                           ("2d-rolling", B_MAIN, True)):
        main_shape = B == B_MAIN
        ops, ops32, dlp, fe, (be, ba), e0 = check_replay_bf16(
            CONFIGS[name], B, actors[name], dev, steps, repeat=main_shape)
        key = "steps" if steps else "mono"
        prev = k5.get(key, {"fwd_err": 0.0, "bwd_err": 0.0, "bwd_abs": 0.0})
        k5[key] = {"fwd_err": max(prev["fwd_err"], fe),
                   "bwd_err": max(prev["bwd_err"], be),
                   "bwd_abs": max(prev["bwd_abs"], ba),
                   **({"ops": (ops, ops32, dlp)} if main_shape
                      else {"ops": prev.get("ops")})}
        log(f"{stamp()} replay bf16 == plain bf16 ({key}): {name} B={B}: fwd "
            f"max err {fe:.3e}, bwd max scaled err {be:.3e} (abs {ba:.3e}); "
            f"fwd vs the rollout's logp {e0:.3e}"
            + ("; two bwd launches bit-identical" if main_shape else ""))
    # 2b. the tensor-core body at the shapes a tiling can break, and the
    # shared-memory plan's mirror
    worst = check_replay_bf16_shapes(dev, lambda m: log(f"{stamp()} {m}"))
    worst = max([worst] + [k5[key]["bwd_err"] for key in k5])
    log(f"{stamp()} replay bf16 backward: largest scaled gradient error "
        f"{worst:.3e} over every case above (the bound BF16_GRAD_TOL "
        f"{BF16_GRAD_TOL})")
    log(f"{stamp()} replay smem_bytes mirror == the "
        f"kernel's on {check_replay_smem_mirror()} cases")
    # 2c. the backward's deferred contractions alone (grad_outer_bf16,
    # wgmma) on the records of real bf16 backwards
    go_err = check_grad_outer(dev, lambda m: log(f"{stamp()} {m}"),
                              GO_BF16_WIDTHS, BF16)
    torch.cuda.synchronize()
    # 3. the bf16 train step at full width
    from tapnet_torch.ops import replay as RP
    per_step = {"actor_select_step": cfg.num_blocks, "replay_logp_bwd": 1,
                "heightmap_reductions": 1}
    go_n = RP.grad_outer_bf16.launches
    train_l, ts, step = train_main_path(cfg, dev, n_steps=5,
                                        compute_dtype=BF16)
    go_n = RP.grad_outer_bf16.launches - go_n
    log(f"{stamp()} bf16 train path launches (5 steps): {train_l}")
    assert_deterministic(step, ts)
    log(f"{stamp()} one bf16 train step run twice from a copy of one state: "
        "params, optimizer state, key and metrics bit-identical")
    agree, drew, diffs = check_train_bf16_against_cpu(cfg, ts, dev)
    log(f"{stamp()} bf16 train step B=256 card vs CPU: action agreement "
        f"{agree:.4f}, mean reward diff {drew:.4f}; |metric diff| {diffs}")
    rows = check_graph_steps("2d-basic bf16", cfg, dev, per_step, 8, B_MAIN,
                             compute_dtype=BF16, tag="phase 24")
    roll_step = {"actor_select_step": rcfg.num_blocks,
                 "replay_logp_bwd_steps": 1, "heightmap_reductions": 1}
    go_r = RP.grad_outer_bf16.launches
    roll_l, _, _ = train_main_path(rcfg, dev, roll_step, n_steps=3,
                                   compute_dtype=BF16)
    go_r = RP.grad_outer_bf16.launches - go_r
    log(f"{stamp()} bf16 rolling train path launches (3 steps): {roll_l}")
    # one contraction launch a bf16 step, counted where it launches
    if (go_n, go_r) != (5, 3):
        raise AssertionError(f"grad_outer_bf16 launches on the bf16 train "
                             f"paths: {go_n} in 5 steps, {go_r} in 3 "
                             "rolling steps")
    log(f"{stamp()} grad_outer_bf16 launches: {go_n} in the 5 steps, {go_r} "
        "in the 3 rolling steps")
    # 4. times
    for name, c in (("2d-rolling", rcfg), ("2d-basic", cfg)):
        k2 = time_actor_dtypes(kept[name], c)
        log_actor_times("phase 24 bf16", c, k2)
        log(f"{stamp()} actor_select_step "
            f"main-path mode {name} B={B_MAIN} in turns: f32 "
            f"{k2['f32_turns']}, bf16 {k2['bf16_turns']} ms/launch; the "
            f"bf16 bound counts the products at {BF16_TC_OPS_S:.3g} op/s "
            f"(H100 SXM dense bf16 tensor cores, data sheet), the rest at "
            f"{F32_OPS_S:.3g}")
    kb, gt = {}, {}
    for key, c in (("mono", cfg), ("steps", rcfg)):
        ops, ops32, dlp = k5[key]["ops"]
        what = (f"grad_outer_bf16 h={HIDDEN} "
                f"{'2d-rolling' if key == 'steps' else '2d-basic'} "
                f"B={B_MAIN}")
        _, kg = kept_backward(replay_fns(ops, c, 1.0, key == "steps")[2],
                              dlp)
        go_err = max(go_err, _hold_grad_outer(kg, c, HIDDEN, what))
        gt[key] = time_grad_outer(kg, c, HIDDEN)
        del kg
        r = gt[key]
        log(f"{stamp()} {what} (held to its plain version, a repeat and the "
            f"backward's own launch): {r['ms']:.4f} ms/launch (plain "
            f"{r['plain_ms']:.4f}, bound {r['bound']:.4f} ms, "
            f"{r['bound_by']})")
        kb[key] = time_replay_dtypes(ops, ops32, dlp, c, key == "steps")
        for d in ("fwd", "bwd"):
            r = kb[key][d]
            log(f"{stamp()} replay_logp_{d}"
                f"{'_steps' if key == 'steps' else ''} "
                f"{'2d-rolling' if key == 'steps' else '2d-basic'} "
                f"B={B_MAIN}: bf16 {r['ms']:.4f} ms/call, f32 "
                f"{r['f32_ms']:.4f} (turns f32, bf16, bf16, f32: "
                f"{r['turns']}), plain bf16 {r['plain_ms']:.3f}; "
                f"{r['bytes']} B, {r['products']} product and "
                f"{r['elementwise']} elementwise ops over the live columns, "
                f"bound {r['bound']:.4f} ms ({r['bound_by']})")
    for name, c, k in (("2d-basic", cfg, 8), ("2d-rolling", rcfg, 4)):
        t = time_train_dtypes(c, dev, k)
        log(f"{stamp()} train step {name} B={B_MAIN} steps_per_call {k}, "
            f"(host ms/step, device ms/step) in turns f32, bf16, bf16, f32: "
            f"f32 {t['f32']}, bf16 {t['bf16']}")
    log(f"{stamp()} done in {time.perf_counter() - t0:.1f} s")
    def entry(name, src, replaces, launches, err, r):
        return {"name": name, "route": "cuda",
                "source": f"tapnet_torch/csrc/{src}",
                "replaces": f"tapnet_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"],
                "bound_by": r["bound_by"], "library_ms": None,
                "dtype": "bfloat16"}

    kernels = [entry("actor_select_step", "actor_step.cu",
                     "pallas_actor_step.py:316",
                     train_l["actor_select_step"]
                     + roll_l["actor_select_step"], k2_err, k2)]
    for key, suffix in (("mono", ""), ("steps", "_steps")):
        lines = {"mono": ("562", "610"), "steps": ("582", "635")}[key]
        for d, line in zip(("fwd", "bwd"), lines):
            name = f"replay_logp_{d}{suffix}"
            kernels.append(entry(
                name, "replay.cu", f"pallas_replay.py:{line}",
                train_l[name] + roll_l[name],
                k5[key]["fwd_err" if d == "fwd" else "bwd_abs"],
                kb[key][d]))
    # the backward's deferred contractions: 2d-basic's figures,
    # 2d-rolling's beside them
    r, rr = gt["mono"], gt["steps"]
    kernels.append(entry("grad_outer", "replay.cu", "pallas_replay.py:610",
                         go_n + go_r, go_err, r))
    kernels[-1]["2d-rolling"] = {"ms": rr["ms"], "plain_ms": rr["plain_ms"],
                                 "bound_ms": rr["bound"],
                                 "bound_by": rr["bound_by"],
                                 "library_ms": None}
    return kernels, rows


def _rollout_parts(state, actions, reward):
    return {**{f"state {f}": getattr(state, f) for f in state._fields},
            "actions": actions, "reward": reward}


def check_rollouts(dev, seeds=(0, 1, 2)):
    """`env.core.rollout` on the card for the six CONFIGS x {first,
    random}, `seeds` each: bit-equal to the same call on the CPU and to the
    seed's row of `rollout_batch` over all the seeds' instances (actions,
    state, reward). Returns the number of rollouts checked."""
    from tapnet_torch import CONFIGS
    from tapnet_torch import random as R
    from tapnet_torch.env import core as E
    from tapnet_torch.env.sampler import sample_instance
    from tapnet_torch.types import Instance

    n = 0
    for name, cfg in CONFIGS.items():
        keys = torch.stack([R.key(s, dev) for s in seeds])
        batch = sample_instance(keys, cfg)
        for policy in ("first", "random"):
            state, actions, rewards = E.rollout_batch(batch, keys, cfg,
                                                      policy)
            for i, seed in enumerate(seeds):
                inst = Instance(*(x[i] for x in batch))
                got = _rollout_parts(*E.rollout(inst, keys[i], cfg, policy))
                cpu = _rollout_parts(*E.rollout(inst.to("cpu"), keys[i].cpu(),
                                                cfg, policy))
                row = _rollout_parts(type(state)(*(x[i] for x in state)),
                                     actions[i], rewards[i])
                for k, v in got.items():
                    label = f"rollout {name} {policy} seed {seed} {k}"
                    _equal(f"{label}: card vs CPU", v.cpu(), cpu[k])
                    _equal(f"{label}: vs its rollout_batch row", v, row[k])
                n += 1
    return n


def check_render(tmp):
    """`python -m tapnet_torch.cli render` on the card: 2d-rot to a PNG and
    3d-basic with --sequence to a GIF. Where matplotlib imports, the files'
    magic bytes and sizes (the JAX tests' limits); where it does not, the
    JAX package's own failure, matplotlib's ModuleNotFoundError. Returns
    which case held."""
    import importlib.util
    import os

    have = importlib.util.find_spec("matplotlib") is not None
    cases = (("2d-rot", "x.png", [], (b"\x89PNG",), 1000),
             ("3d-basic", "seq.gif", ["--sequence"], (b"GIF87a", b"GIF89a"),
              10_000))
    runs = [["render", "--config", name, "--seed", str(SEED), "--out",
             os.path.join(tmp, out), *extra]
            for name, out, extra, _, _ in cases]
    with ThreadPoolExecutor(len(runs)) as ex:  # the two processes at once
        done = list(ex.map(_cli_process, runs))
    for (name, out, extra, magic, size), res in zip(cases, done):
        path = os.path.join(tmp, out)
        if have:
            rec = _json_lines(res.stdout)
            if res.returncode != 0 or not rec or rec[-1]["path"] != path:
                raise AssertionError(f"cli render {name}: rc "
                                     f"{res.returncode}\n{res.stderr[-3000:]}")
            with open(path, "rb") as f:
                head = f.read(8)
            if (not any(head.startswith(m) for m in magic)
                    or os.path.getsize(path) <= size):
                raise AssertionError(f"cli render {name}: {head!r}, "
                                     f"{os.path.getsize(path)} B")
        elif (res.returncode == 0 or "ModuleNotFoundError: No module named "
              "'matplotlib'" not in res.stderr):
            raise AssertionError(f"cli render {name} without matplotlib: rc "
                                 f"{res.returncode}\n{res.stderr[-3000:]}")
    return ("matplotlib imports: a PNG and a GIF of the JAX tests' sizes"
            if have else "no matplotlib: both renders failed with "
            "ModuleNotFoundError: No module named 'matplotlib', the JAX "
            "package's behaviour")


def check_tb(cfg, dev, tmp):
    """train() on the card (batch 256, 2 epochs x 2 steps) with tb_dir and
    metrics_path: the events file reads back (both CRCs checked) to
    exactly the (tag, step, value as float32) triples of the JSONL
    records. Returns the number of scalars."""
    import glob
    import os

    from tapnet_torch.train.metrics import read_scalars
    from tapnet_torch.train.trainer import TrainLoopConfig, train

    loop = TrainLoopConfig(epochs=2, steps_per_epoch=2, batch=256,
                           valid_batch=256, hidden=HIDDEN, seed=SEED,
                           metrics_path=os.path.join(tmp, "m.jsonl"),
                           tb_dir=os.path.join(tmp, "tb"))
    train(cfg, loop, device=dev)
    (path,) = glob.glob(os.path.join(tmp, "tb", "events.out.tfevents.*"))
    want = []
    for rec in _json_lines(open(loop.metrics_path).read()):
        want += [(k, rec["step"], float(np.float32(v)))
                 for k, v in rec.items()
                 if k != "step" and isinstance(v, (int, float))]
    got = read_scalars(path)
    if not want or got != want:
        raise AssertionError(f"events file {got[:6]} != JSONL {want[:6]}")
    return len(got)


def check_tp(cfg, dev, B=B_MAIN):
    """A world-1 NCCL group: `data_model_mesh(1, 1)`, `shard_params_tp` on
    a hidden-128 actor, its forward on B reset states bit-equal to the
    replicated actor's. Returns the spec tree."""
    import copy

    import torch.distributed as dist

    from tapnet_torch.env import core as E
    from tapnet_torch.models.features import build_tokens
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.parallel import (data_model_mesh, shard_params_tp,
                                       tp_sharding_tree)

    mesh = data_model_mesh(1, 1, device=dev)
    if dev.type == "cuda" and ("nccl" not in str(dist.get_backend())
                               or mesh.device_type != "cuda"):
        raise AssertionError(f"data_model_mesh(1, 1): {mesh}, "
                             f"{dist.get_backend()}")
    actor = init_params(SEED, cfg, HIDDEN, dev)
    inst = _instances(cfg, B, dev, SEED + 25)
    tokens = build_tokens(inst, E.reset(inst, cfg), cfg)
    tree = tp_sharding_tree(actor, mesh)
    with torch.no_grad():
        want = actor(*tokens)
        tp = shard_params_tp(copy.deepcopy(actor), mesh)
        got = tp(*tokens)
    if type(got) is not torch.Tensor:
        raise AssertionError(f"TP forward returned {type(got)}")
    _equal(f"TP forward 1 x 1 vs replicated, B={B}", got, want)
    dist.destroy_process_group()
    return {k: [str(p) for p in v] for k, v in tree.items()}


def phase_25(dev):
    """Phase 25 (module docstring): the JAX package's last modules on the
    card."""
    import importlib.metadata

    from tapnet_torch import CONFIGS

    t0 = time.perf_counter()
    versions = {}
    for pkg in ("matplotlib", "tensorboard"):
        try:
            versions[pkg] = importlib.metadata.version(pkg)
        except importlib.metadata.PackageNotFoundError:
            versions[pkg] = "absent"
    log(f"phase 25 packages: {versions}")
    n = check_rollouts(dev)
    log(f"phase 25 rollout: {n} rollouts (six CONFIGS x first/random x 3 "
        f"seeds) on the card == on the CPU == their rollout_batch rows, bit "
        f"for bit (actions, state, reward) "
        f"[{time.perf_counter() - t0:.1f} s]")
    with tempfile.TemporaryDirectory() as tmp:
        log(f"phase 25 cli render: {check_render(tmp)} "
            f"[{time.perf_counter() - t0:.1f} s]")
    with tempfile.TemporaryDirectory() as tmp:
        n = check_tb(CONFIGS["2d-basic"], dev, tmp)
    log(f"phase 25 train(tb_dir) 2d-basic batch 256, 2 epochs x 2 steps: "
        f"the events file reads back to the JSONL's {n} (tag, step, value) "
        f"triples [{time.perf_counter() - t0:.1f} s]")
    tree = check_tp(CONFIGS["2d-basic"], dev)
    log(f"phase 25 TP: world-1 NCCL data_model_mesh(1, 1), hidden {HIDDEN}, "
        f"B={B_MAIN}: the sharded forward == the replicated one, bit for "
        f"bit; spec tree {json.dumps(tree)}")
    log(f"phase 25 done in {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ #
# phase 26: K2 and K5 at hidden widths above 128

WIDE = (160, 192, 224, 256)  # the hidden widths of the WH instantiations
WIDE_H = 256                 # the widest, at full batch


def wide_shapes(h):
    """(config, batch, temperature) where the wide bodies can break at
    hidden h (K5's two head passes of 16 instances, K2's ring products):
    2d-basic at 512, a ragged batch of 100 (the last tile's second pass
    empty, a tile of 4 instances), multi-container at temperature 0.7 (C =
    2, W*D + 2 = 66: three W1 slabs) and, at 160 (odd row counts: 5, 10 a
    thread) and 256, 2d-rolling (window 10, 50 blocks: K2's 64-bit words,
    K5's step grid)."""
    return ([("2d-basic", 512, 1.0), ("2d-basic", 100, 1.0),
             ("multi-container", 512, 0.7)]
            + ([("2d-rolling", 512, 1.0)] if h in (160, WIDE_H) else []))


def check_wide_kernels(dev, log_fn, widths=WIDE, shapes=wide_shapes):
    """K2 (both modes, both dtypes) and K5 (K5f/K5b monolithic where the
    config allows it, K5f-steps/K5b-steps always, both dtypes) against
    their plain versions at every width of `widths` on each case of
    `shapes(h)`, at the tolerances of phases 3, 7, 15 and 24, with two
    backward launches (and two K2 bf16 launches) bit-identical (a width the
    kernels do not take on operands padded to `kernel_width`). Returns the
    largest errors per kernel and dtype."""
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import replay as RP

    errs = {}
    bump = lambda k, v: errs.__setitem__(k, max(errs.get(k, 0.0), v))
    for h in widths:
        for name, B, temp in shapes(h):
            cfg = CONFIGS[name]
            actor = init_params(SEED, cfg, h, dev)
            _, e2 = check_actor_step(cfg, B, actor, dev, temperature=temp)
            _, e2b, rate = check_actor_step_bf16(cfg, B, actor, dev,
                                                 temperature=temp)
            bump("K2 f32", e2)
            bump("K2 bf16", e2b)
            rec = replay_operands(actor, cfg, B, dev, SEED + 10, temp,
                                  dtype=BF16, also=torch.float32)
            parts = []
            for steps in sorted({RP._steps_grid(cfg), True}):
                key = "steps" if steps else "mono"
                _, _, fe, (be, ba), _ = check_replay(
                    cfg, B, actor, dev, temp, repeat=True, steps=steps)
                _, _, _, fb, (bb, bba), _ = check_replay_bf16(
                    cfg, B, actor, dev, steps, repeat=True,
                    temperature=temp, record=rec)
                bump(f"K5f {key} f32", fe)
                bump(f"K5b {key} f32", ba)
                bump(f"K5f {key} bf16", fb)
                bump(f"K5b {key} bf16", bba)
                parts.append(f"K5 {key}: fwd err {fe:.2e} / bf16 {fb:.2e}, "
                             f"bwd scaled err {be:.2e} / bf16 {bb:.2e}")
            log_fn(f"hidden {h} {name} B={B} temperature {temp}: K2 f32 "
                   f"max logit/logp err {e2:.2e}, bf16 {e2b:.2e} (action "
                   f"agreement {rate:.6f}); " + "; ".join(parts)
                   + "; bwd and K2 bf16 repeats bit-identical")
    return errs


def time_fallback_replay(actor, cfg, B, dev, seed, dtype=torch.float32):
    """The replay that the routers fall back on, `replay_logp_sum(kernel=
    False)` (the general autograd replay; the windowed one on a rolling
    config) in the compute dtype `dtype`, on the record that
    `replay_operands(actor, cfg, B, dev, seed, 1.0)` replays: its value and
    every actor parameter's gradient under a ramp dlp, forward and backward
    as the fallback train step runs them. ms per call (CUDA events, median
    of 3): the comparator of K5b, which the kernel route runs alone (its
    value is the rollout's logp)."""
    from tapnet_torch import random as R
    from tapnet_torch.train import rollout as RO

    inst = _instances(cfg, B, dev, seed)
    with torch.no_grad():
        _, rec, _ = RO.rollout_batch_record(
            actor, inst, R.split(R.key(seed + 1, dev), B), cfg,
            temperature=1.0)
    dlp = torch.linspace(-1.0, 1.0, B, device=dev)

    def run():
        actor.zero_grad(set_to_none=True)
        lp = RO.replay_logp_sum(actor, inst, rec, cfg, 1.0, kernel=False,
                                dtype=dtype)
        (lp * dlp).sum().backward()

    ms = time_gpu(run, reps=3, sleep_cycles=100_000_000, warm=1)
    actor.zero_grad(set_to_none=True)
    return ms


def check_witness(dev):
    """The record on which a ReLU gate that rounding decides was found
    (2d-rolling, hidden 160, batch 256, seed 10; `grad_witness`): K5b-steps
    f32 against its plain version, the gates within their rounding bound
    of 0 counted, and every gradient's scaled error with the rows those
    gates feed left out within GRAD_TOL. Returns `grad_witness.witness`'s
    record."""
    from tapnet_torch import CONFIGS
    from tapnet_torch import grad_witness as GW

    res = GW.witness(CONFIGS["2d-rolling"], 160, 256, 10, dev)
    without = max(res["scaled_errors_without_them"].values())
    if not without <= GRAD_TOL:
        raise AssertionError(
            "replay_logp_bwd_steps f32 on the witness record: scaled err "
            f"{without} with the {res['near_zero_pairs']} gates within "
            f"their rounding bound ({res['near_zero_rows']}) left out")
    return res


# (config, batch, p2d) on which `check_query_parts` holds query_parts:
# 2d-basic (A + 1 = 11) and 2d-rolling (101) at batch 512, a ragged batch
# of 100 (rows of ctx that are not whole 16-byte chunks: element loads, a
# last column tile of 100) and BASELINE.json config 5, multi-container
# mixed p2d 0.5 (A + 1 = 41)
QP_CASES = (("2d-basic", 512, 0.0), ("2d-rolling", 512, 0.0),
            ("2d-basic", 100, 0.0), ("multi-container", 512, 0.5))


def check_query_parts(dev, widths=WIDE):
    """K2's once-per-rollout query parts (`ops.actor_step.query_parts`, its
    own launch) against the plain version on the card, both dtypes, every
    width of `widths`, on the rollouts' operands of `QP_CASES`: within
    TOL of the plain float32 products (TF32 off), two launches
    bit-identical. Returns the largest error per dtype, and under "f64"
    each width's largest float32 errors, scaled by the output's max
    magnitude, of the kernel and of the plain version from the products
    in float64 (the tensor cores' sums against f32 fused multiply-adds)."""
    from tapnet_torch import CONFIGS
    from tapnet_torch import random as R
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import actor_step as AS

    errs = {"f32": 0.0, "bf16": 0.0, "f64": {}}
    for h in widths:
        for name, B, p2d in QP_CASES:
            cfg = CONFIGS[name]
            actor = init_params(SEED, cfg, h, dev)
            inst = _instances(cfg, B, dev, SEED + 2, p2d)
            case = f"h={h} {name} B={B}" + (f" p2d {p2d}" if p2d else "")
            for dt, tag in ((torch.float32, "f32"), (BF16, "bf16")):
                with torch.no_grad():
                    o = actor_operands(actor, inst, cfg,
                                       R.split(R.key(SEED + 3, dev), B), dt)
                    got = AS.query_parts(o["params"], o["ctx"])
                    again = AS.query_parts(o["params"], o["ctx"])
                    want = AS.query_parts_ref(o["params"], o["ctx"])
                    wq, hh = o["params"][8].double(), o["ctx"].shape[0]
                    exact = ((wq[:, hh:2 * hh] @ o["ctx"].double(),
                              wq[:, 2 * hh:3 * hh]
                              @ o["params"][7].double())
                             if tag == "f32" else None)
                for i, (part, g, a, w) in enumerate(zip(("ctx", "emb"), got,
                                                        again, want)):
                    _equal(f"query_parts {tag} {case} {part} repeat", g, a)
                    d = (g - w).abs()
                    if not bool((d <= TOL + TOL * w.abs()).all()):
                        raise AssertionError(
                            f"query_parts {tag} {case} {part}: max "
                            f"err {d.max().item()}")
                    errs[tag] = max(errs[tag], d.max().item())
                    if exact is not None:
                        x = exact[i]
                        sc = x.abs().max().item() + 1e-30
                        f = errs["f64"].setdefault(h, [0.0, 0.0])
                        f[0] = max(f[0], (g - x).abs().max().item() / sc)
                        f[1] = max(f[1], (w - x).abs().max().item() / sc)
    return errs


def time_query_parts(actor, cfg, dev, dtype):
    """query_parts at batch B_MAIN on one rollout's operands: ms per launch,
    the plain version's (two torch.mm), the bound (bytes: Wq's ctx and
    embedding columns, ctx and E read once, the f32 outputs written once;
    operations: 2 per multiply-add at the dtype's peak, `ops_ms`; in
    float32 also at 3xTF32's rate, the products as the kernel runs them,
    "bound_3xtf32", and the bound the lower of the two)."""
    from tapnet_torch import random as R
    from tapnet_torch.ops import actor_step as AS

    inst = _instances(cfg, B_MAIN, dev, SEED + 4)
    with torch.no_grad():
        o = actor_operands(actor, inst, cfg,
                           R.split(R.key(SEED + 5, dev), B_MAIN), dtype)
    p, ctx = o["params"], o["ctx"]
    h, B, A1 = ctx.shape[0], ctx.shape[1], p[7].shape[1]
    ms = time_gpu(lambda: AS.query_parts(p, ctx))
    plain = time_gpu(lambda: AS.query_parts_ref(p, ctx))
    # the library: one torch.mm an output, on float32 operands (a bfloat16
    # torch.mm rounds its result to bfloat16, another function), the
    # casts made before the timing
    wq, c32, et = p[8].float(), ctx.float(), p[7].float()
    wc, we = wq[:, h:2 * h], wq[:, 2 * h:3 * h]
    lib = time_gpu(lambda: (torch.mm(wc, c32), torch.mm(we, et)))
    size = ctx.element_size()
    nb = size * (h * 2 * h + h * B + h * A1) + 4 * h * (B + A1)
    gemm = 2 * h * h * (B + A1)
    ops = ops_ms((gemm, 0), dtype)
    by_bytes = 1e3 * nb / HBM_BYTES_S
    res = {"ms": ms, "plain_ms": plain, "library_ms": lib}
    if dtype == torch.float32:
        tf3 = 1e3 * gemm / TF32X3_OPS_S
        res["f32_rate_bound"] = max(by_bytes, ops)
        res["bound_3xtf32"] = max(by_bytes, tf3)
        ops = min(ops, tf3)
    return {**res, "bound": max(by_bytes, ops),
            "bound_by": "operations" if ops >= by_bytes else "bytes"}


def check_k2_repeat(kept, cfg):
    """Two launches of K2 in float32, each mode, on one step's operands:
    every output bit-identical."""
    from tapnet_torch.ops import actor_step as AS

    ops = kept[1]
    pt = AS.transposed(ops[16])
    for logits in (True, False):
        a = AS.actor_select_step(*ops, cfg, logits=logits, params_t=pt)
        b = AS.actor_select_step(*ops, cfg, logits=logits, params_t=pt)
        for i, (x, y) in enumerate(zip(a, b)):
            if x is not None:
                _equal(f"actor_select_step f32 repeat (logits={logits}) "
                       f"output {i}", x, y)


# (config, batch, p2d) on which `check_grad_outer` holds grad_outer_tf32
# and grad_outer_bf16 to their plain versions: those of `query_parts`
# (2d-basic's monolithic rows, 2d-rolling's step-grid rows, a ragged
# batch of 100, config 5 with C = 2)
GO_CASES = QP_CASES
GO_WIDTHS = (160, WIDE_H)
GO_BF16_WIDTHS = (32, 96, HIDDEN)  # phase 24's; phase 26 adds GO_WIDTHS


def kept_backward(bwd, dlp):
    """bwd(dlp) with `ops.replay.kept` on: (its gradients, the operands
    and outputs of its helper kernels)."""
    from tapnet_torch.ops import replay as RP

    RP.kept = []
    try:
        with torch.no_grad():
            got = bwd(dlp)
        return got, RP.kept[-1]
    finally:
        RP.kept = None


def _go_fns(k):
    """(the helper kernel, its plain version) of the records in `k` (a
    `kept_backward` entry) by the dtype of the backward that wrote them."""
    from tapnet_torch.ops import replay as RP

    if k["dtype"] == BF16:
        return RP.grad_outer_bf16, lambda *a: RP.grad_outer_ref(*a, BF16)
    return RP.grad_outer_tf32, RP.grad_outer_ref


def _hold_grad_outer(k, cfg, h, what):
    """grad_outer_tf32 or grad_outer_bf16 alone on the records of one
    backward (`k`, `kept_backward`'s) against its plain version within
    GRAD_TOL of the plain result's max magnitude, two launches
    bit-identical and equal to the columns the backward's own launch
    wrote. The max scaled error."""
    from tapnet_torch.ops import replay as RP

    fn, ref = _go_fns(k)
    args = (k["rec"], k["sflag"], cfg, h, k["length"])
    got, again = fn(*args), fn(*args)
    want = ref(*args)
    rows, worst = k["part"].shape[0], 0.0
    for (i, cols, off), g, a, w in zip(RP._grad_blocks(cfg, h), got, again,
                                       want):
        _equal(f"{what} params[{i}] repeat", g, a)
        _equal(f"{what} params[{i}] against the backward's own launch", g,
               k["part"][:, off:off + h * cols].view(rows, h, cols))
        e = ((g - w).abs().max() / (w.abs().max() + 1e-12)).item()
        if not e <= GRAD_TOL:
            raise AssertionError(f"{what} params[{i}]: scaled err {e}")
        worst = max(worst, e)
    return worst


def check_grad_outer(dev, log_fn, widths=GO_WIDTHS, dtype=torch.float32):
    """grad_outer_tf32 (float32) or grad_outer_bf16 (bfloat16) held alone
    on the records of that dtype's backward (K5b, or K5b-steps where the
    config takes the step grid) at hidden `widths` on GO_CASES
    (`_hold_grad_outer`). Returns the largest scaled error."""
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import replay as RP

    name_of = "grad_outer_bf16" if dtype == BF16 else "grad_outer_tf32"
    worst = 0.0
    for h in widths:
        for name, B, p2d in GO_CASES:
            cfg = CONFIGS[name]
            ops, _ = replay_operands(init_params(SEED, cfg, h, dev), cfg, B,
                                     dev, SEED + 10, 1.0, p2d, dtype=dtype)
            bwd = replay_fns(ops, cfg, 1.0, RP._steps_grid(cfg))[2]
            _, k = kept_backward(bwd, torch.linspace(-1.0, 1.0, B,
                                                     device=dev))
            case = f"h={h} {name} B={B}" + (f" p2d {p2d}" if p2d else "")
            e = _hold_grad_outer(k, cfg, h, f"{name_of} {case}")
            log_fn(f"{name_of} {case} ({k['part'].shape[0]} rows of "
                   f"{k['length']} steps, {int((k['sflag'] != 0).sum())} "
                   f"acting): max scaled err {e:.2e}; repeat and the "
                   "backward's own launch bit-identical")
            worst = max(worst, e)
    return worst


def _held_reduce_tiles(x):
    """reduce_tiles alone on x: (its sum, its plain version's, the load
    width the library launched it with)."""
    from tapnet_torch.ops import replay as RP

    before = dict(RP.reduce_tiles.widths)
    got = RP.reduce_tiles(x)
    v = [w for w, n in RP.reduce_tiles.widths.items() if n != before[w]]
    if len(v) != 1:
        raise AssertionError(f"reduce_tiles {tuple(x.shape)}: launches by "
                             f"width {RP.reduce_tiles.widths}, before "
                             f"{before}")
    return got, RP.reduce_tiles_ref(x), v[0]


def _hold_reduce_tiles(k, what):
    """reduce_tiles alone on one backward's partial rows (and d_ctx chunk
    partials, where there are several chunks) bit for bit against its
    plain version and the backward's own sums. {what held: (shape, load
    width, held against the backward's own sum, max abs err against the
    plain version)}."""
    pairs = [(k["part"], k["grads"], "partial rows")]
    if k["dctx_part"].numel():
        nc = k["dctx_part"].shape[0]
        pairs.append((k["dctx_part"].view(nc, -1), k["dctx"].view(-1),
                      "d_ctx partials"))
    held = {}
    for x, own, part in pairs:
        got, want, v = _held_reduce_tiles(x)
        _equal(f"{what} {part} against the plain version", got, want)
        _equal(f"{what} {part} against the backward's own", got, own)
        held[f"{what} {part}"] = (list(x.shape), v, True,
                                  (got - want).abs().max().item())
    return held


def check_reduce_tiles(dev, log_fn):
    """reduce_tiles held bit for bit (`_hold_reduce_tiles`) on the partial
    rows of K5b (2d-basic) and K5b-steps (2d-rolling, also its d_ctx chunk
    partials) at the main paths' batch, hidden 128 and 256, float32 and
    bfloat16, and on the logp chunk partials' shape of a ragged batch
    (100: P not a multiple of 4, the scalar instantiation); fails unless
    each load width (`ops.replay.RT_WIDTHS`) was held. Returns (the cases
    held, the largest abs error against the plain version)."""
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import replay as RP

    held = {}
    for h in (HIDDEN, WIDE_H):
        for name in ("2d-basic", "2d-rolling"):
            cfg = CONFIGS[name]
            ops, _, ops_b = replay_operands(
                init_params(SEED, cfg, h, dev), cfg, B_MAIN, dev, SEED + 10,
                1.0, also=BF16)
            dlp = torch.linspace(-1.0, 1.0, B_MAIN, device=dev)
            for dt, o in (("f32", ops), ("bf16", ops_b)):
                bwd = replay_fns(o, cfg, 1.0, RP._steps_grid(cfg))[2]
                held.update(_hold_reduce_tiles(
                    kept_backward(bwd, dlp)[1],
                    f"reduce_tiles {dt} h={h} {name} B={B_MAIN}"))
            del ops, ops_b
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    x = torch.randn(RP.step_chunks(CONFIGS["2d-rolling"], 100), 100,
                    generator=g, device=dev)
    got, want, v = _held_reduce_tiles(x)
    _equal("reduce_tiles [chunks, 100]", got, want)
    held["reduce_tiles [chunks, 100]"] = (list(x.shape), v, False,
                                          (got - want).abs().max().item())
    taken = {w for _, w, _, _ in held.values()}
    if taken != set(RP.RT_WIDTHS):
        raise AssertionError(f"reduce_tiles held at load widths {taken}, "
                             f"not every one of {RP.RT_WIDTHS}: {held}")
    for what, (shape, w, own, _) in held.items():
        log_fn(f"{what} {shape}: bit for bit against its plain version"
               + (" and the backward's own sum" if own else "")
               + f", {w}-float loads")
    return len(held), max(e for _, _, _, e in held.values())


def time_grad_outer(k, cfg, h):
    """grad_outer_tf32 or grad_outer_bf16 (by the dtype of `k`) alone on
    one backward's records at hidden h (`kept_backward`'s `k`): ms per
    launch (the kernel writing into a kept buffer), its plain version's,
    and its bound: the records read once (the G and X sections of the
    acting (row, step) pairs' 32 lanes, X bfloat16 or f32) and its
    gradients written once, against its products at the rate of its
    passes (bf16 hi and lo at the dense bf16 peak, 3xTF32 at 495/3
    TFLOP/s)."""
    fn, ref = _go_fns(k)
    rec, sflag, length, part = k["rec"], k["sflag"], k["length"], k["part"]
    args = (rec, sflag, cfg, h, length)
    buf = torch.zeros_like(part)
    go = {"ms": time_gpu(lambda: fn(*args, part=buf)),
          "plain_ms": time_gpu(lambda: ref(*args), reps=5)}
    bf = k["dtype"] == BF16
    lanes = int((sflag != 0).sum()) * cfg.num_containers * 32
    cols = 4 * h + 8 + cfg.target_width * cfg.target_depth + 2
    nb = (lanes * (4 * 3 * h + (2 if bf else 4) * cols)
          + 4 * part.shape[0] * h * cols)
    by_b = 1e3 * nb / HBM_BYTES_S
    by_o = (1e3 * 2 * 2 * lanes * h * cols / BF16_TC_OPS_S if bf
            else 1e3 * 2 * lanes * h * cols / TF32X3_OPS_S)
    go.update(bound=max(by_b, by_o),
              bound_by="bytes" if by_b >= by_o else "operations",
              library_ms=None)
    return go


def time_helpers(k, cfg, h):
    """grad_outer_tf32 (`time_grad_outer`) and reduce_tiles alone on one
    float32 backward's operands at hidden h (`kept_backward`'s `k`):
    reduce_tiles' ms per launch, its plain version's, the library's
    `torch.sum(part, 0)`, and its bound: the partial rows read and the
    sum written once, against an add each at the f32 rate."""
    from tapnet_torch.ops import replay as RP

    part = k["part"]
    out = torch.empty(part.shape[1], device=part.device)
    rt = {"ms": time_gpu(lambda: RP.reduce_tiles(part, out=out)),
          "plain_ms": time_gpu(lambda: RP.reduce_tiles_ref(part), reps=5),
          "library_ms": time_gpu(lambda: torch.sum(part, 0))}
    by_b = 1e3 * 4 * (part.numel() + part.shape[1]) / HBM_BYTES_S
    by_o = 1e3 * part.numel() / F32_OPS_S
    rt.update(bound=max(by_b, by_o),
              bound_by="bytes" if by_b >= by_o else "operations",
              shape=list(part.shape))
    return {"grad_outer_tf32": time_grad_outer(k, cfg, h),
            "reduce_tiles": rt}


def phase_26(dev):
    """Phase 26 (module docstring): K2 and K5 at hidden widths above 128.
    Returns the kernels-line entries of the hidden-256 instantiations."""
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.train import rollout as RO
    from tapnet_torch.train.trainer import assert_deterministic

    t0 = time.perf_counter()
    stamp = lambda: f"phase 26 [{time.perf_counter() - t0:.0f} s]"
    h = WIDE_H
    cfg, rcfg = CONFIGS["2d-basic"], CONFIGS["2d-rolling"]
    for c in (cfg, rcfg):
        if RO.routes(c, True, h) != RO.Routes("actor", True, True):
            raise AssertionError(f"routes {c} hidden {h}: "
                                 f"{RO.routes(c, True, h)}")
    # 1. every wide width against the plain versions; the plan and record
    # mirrors; the witness record
    errs = check_wide_kernels(dev, lambda m: log(f"{stamp()} {m}"))
    qp_err = check_query_parts(dev)
    log(f"{stamp()} query_parts (once per rollout) at hidden {WIDE} on "
        f"2d-basic and 2d-rolling B=512, 2d-basic B=100 and multi-container "
        f"mixed p2d 0.5 B=512 against the plain version: max abs err f32 "
        f"{qp_err['f32']:.2e}, bf16 {qp_err['bf16']:.2e}; repeats "
        "bit-identical; f32 from float64 products, scaled (kernel, plain): "
        + ", ".join(f"h={h} {k:.2e}, {p:.2e}"
                    for h, (k, p) in qp_err["f64"].items()))
    go_err = check_grad_outer(dev, lambda m: log(f"{stamp()} {m}"))
    gb_err = check_grad_outer(dev, lambda m: log(f"{stamp()} {m}"),
                              GO_WIDTHS, BF16)
    _, rt_err = check_reduce_tiles(dev, lambda m: log(f"{stamp()} {m}"))
    log(f"{stamp()} replay plan and record mirrors equal to the kernel's "
        f"on {check_replay_smem_mirror()} and {check_replay_record_mirror()} "
        "cases")
    wit = check_witness(dev)
    full = max(wit["scaled_errors"].values())
    log(f"{stamp()} witness record (2d-rolling hidden 160 B=256 seed 10): "
        f"K5b-steps f32 max scaled err {full:.3e} over every pair; "
        f"{wit['near_zero_pairs']} gates within their "
        f"rounding bound of 0 (rows {wit['near_zero_rows']}); without their "
        f"rows {max(wit['scaled_errors_without_them'].values()):.3e} "
        f"(GRAD_TOL {GRAD_TOL}); gates past GRAD_TOL: {wit['gates']}")
    # 2. the main path at hidden 256: pack() (K2 for sample and best), the
    # train steps in both dtypes with their launches
    actor = init_params(SEED, cfg, h, dev)
    launches, inst = main_path(cfg, actor, dev)
    log(f"{stamp()} pack() 2d-basic hidden {h}: launches {launches} (greedy "
        "K1 x10; sample and best-of-16 K2 x10 each, no select_step)")
    check_against_cpu(cfg, actor, inst, dev)
    per_step = {"actor_select_step": cfg.num_blocks, "query_parts": 1,
                "replay_logp_bwd": 1, "heightmap_reductions": 1}
    from tapnet_torch.ops import replay as RP
    helpers = {"grad_outer_tf32": RP.grad_outer_tf32,
               "grad_outer_bf16": RP.grad_outer_bf16,
               "reduce_tiles": RP.reduce_tiles}
    helper_n = dict.fromkeys(helpers, 0)

    def counted(run):  # the helper kernels' launches on a main-path run
        for f in helpers.values():
            f.launches = 0
        res = run()
        for k, f in helpers.items():
            helper_n[k] += f.launches
        return res

    train_f, ts, step = counted(lambda: train_main_path(
        cfg, dev, per_step, n_steps=3, hidden=h))
    log(f"{stamp()} train path 2d-basic hidden {h} batch {B_MAIN} "
        f"launches (3 steps): {train_f}")
    assert_deterministic(step, ts)
    check_train_against_cpu(cfg, ts, dev, B=256, hidden=h)
    log(f"{stamp()} f32 train step hidden {h}: a repeat bit-identical, a "
        "step at batch 256 against the CPU path")
    train_b, ts_b, step_b = counted(lambda: train_main_path(
        cfg, dev, per_step, n_steps=3, hidden=h, compute_dtype=BF16))
    log(f"{stamp()} bf16 train path 2d-basic hidden {h} batch {B_MAIN} "
        f"launches (3 steps): {train_b}")
    assert_deterministic(step_b, ts_b)
    agree, drew, diffs = check_train_bf16_against_cpu(cfg, ts_b, dev)
    log(f"{stamp()} bf16 train step hidden {h} B=256 card vs CPU: action "
        f"agreement {agree:.4f}, mean reward diff {drew:.4f}; |metric "
        f"diff| {diffs}")
    rows = {}
    for name, c, ps, k, dt in (
            ("2d-basic", cfg, per_step, 8, None),
            ("2d-basic bf16", cfg, per_step, 8, BF16),
            ("2d-rolling", rcfg, {"actor_select_step": rcfg.num_blocks,
                                  "query_parts": 1,
                                  "replay_logp_bwd_steps": 1,
                                  "heightmap_reductions": 1}, 4, None)):
        rows[name] = check_graph_steps(f"{name} hidden {h}", c, dev, ps, k,
                                       B_MAIN, hidden=h, compute_dtype=dt,
                                       tag="phase 26")
    roll_step = {"actor_select_step": rcfg.num_blocks, "query_parts": 1,
                 "replay_logp_bwd_steps": 1, "heightmap_reductions": 1}
    roll_f, _, _ = counted(lambda: train_main_path(
        rcfg, dev, roll_step, n_steps=1, hidden=h))
    roll_b, _, _ = counted(lambda: train_main_path(
        rcfg, dev, roll_step, n_steps=1, hidden=h, compute_dtype=BF16))
    log(f"{stamp()} rolling train step hidden {h} batch {B_MAIN} launches: "
        f"f32 {roll_f}, bf16 {roll_b}")
    # a step: one contraction launch of its dtype; every step: the partial
    # rows' sum, and on the step grid d_ctx's
    want = {"grad_outer_tf32": 3 + 1, "grad_outer_bf16": 3 + 1,
            "reduce_tiles": 3 + 3 + 2 + 2}
    if helper_n != want:
        raise AssertionError(f"helper launches on the hidden-{h} main "
                             f"paths: {helper_n}, expected {want}")
    log(f"{stamp()} helper kernels on those main paths (f32 and bf16, "
        f"2d-basic x3 and 2d-rolling x1): {helper_n}")
    # 3. the main paths' shapes at hidden 256, batch 4096: every kernel
    # against its plain version on the operands it is timed on, then times
    bump = lambda k, v: errs.__setitem__(k, max(errs[k], v))
    k2 = {}
    for name, c in (("2d-basic", cfg), ("2d-rolling", rcfg)):
        a = actor if c is cfg else init_params(SEED, c, h, dev)
        kept, err, rate = check_actor_step_bf16(c, B_MAIN, a, dev, keep=True)
        bump("K2 bf16", err)
        with torch.no_grad():
            _, err32 = hold_k2(kept[1], c, 1.0, AS.transposed(kept[1][16]),
                               f"hidden {h} {name} B={B_MAIN}")
        bump("K2 f32", err32)
        log(f"{stamp()} actor_select_step hidden {h} {name} B={B_MAIN}: bf16 "
            f"rollout against the plain bf16 version, max logit/logp err "
            f"{err:.2e} (action agreement {rate:.6f}); f32 both modes at its "
            f"middle step against the plain version, max err {err32:.2e}")
        if c is cfg:
            check_k2_repeat(kept, c)
        k2[name] = {"bf16": time_actor_dtypes(kept, c, h),
                    "f32": time_actor_step(kept[1], c, h, plain_reps=5,
                                           plain_sleep=200_000_000)}
        for dt in ("f32", "bf16"):
            log_actor_times(f"{stamp()} hidden {h} {dt}", c, k2[name][dt])
        log(f"{stamp()} actor_select_step hidden {h} main-path mode {name} "
            f"B={B_MAIN} in turns: f32 {k2[name]['bf16']['f32_turns']}, "
            f"bf16 {k2[name]['bf16']['bf16_turns']} ms/launch")
    qp = {dt: time_query_parts(actor, cfg, dev, d)
          for dt, d in (("float32", torch.float32), ("bfloat16", BF16))}
    for dt, r in qp.items():
        log(f"{stamp()} query_parts hidden {h} 2d-basic B={B_MAIN} {dt}: "
            f"{r['ms']:.4f} ms/launch (plain {r['plain_ms']:.4f}; two "
            f"torch.mm on f32 operands {r['library_ms']:.4f}; bound "
            f"{r['bound']:.5f} ms, "
            f"{r['bound_by']}"
            + (f"; at the f32 rate {r['f32_rate_bound']:.5f}"
               if "f32_rate_bound" in r else "") + "), once per rollout")
    kb, ht = {}, {}
    for key, c in (("mono", cfg), ("steps", rcfg)):
        a = actor if c is cfg else init_params(SEED, c, h, dev)
        ops, _, ops32 = replay_operands(a, c, B_MAIN, dev, SEED + 10, 1.0,
                                        dtype=BF16, also=torch.float32)
        dlp = torch.linspace(-1.0, 1.0, B_MAIN, device=dev)
        held = {}
        for dt, o in (("f32", ops32), ("bf16", ops)):
            held[dt] = hold_replay(o, dlp, c, key == "steps",
                                   torch.float32 if dt == "f32" else BF16)
            bump(f"K5f {key} {dt}", held[dt][0])
            bump(f"K5b {key} {dt}", held[dt][1])
        _, kf = kept_backward(replay_fns(ops32, c, 1.0, key == "steps")[2],
                              dlp)
        go_err = max(go_err, _hold_grad_outer(
            kf, c, h, f"grad_outer_tf32 h={h} {key} B={B_MAIN}"))
        ht[key] = time_helpers(kf, c, h)
        del kf
        _, kg = kept_backward(replay_fns(ops, c, 1.0, key == "steps")[2],
                              dlp)
        gb_err = max(gb_err, _hold_grad_outer(
            kg, c, h, f"grad_outer_bf16 h={h} {key} B={B_MAIN}"))
        ht[key]["grad_outer_bf16"] = time_grad_outer(kg, c, h)
        del kg
        for kn, r in ht[key].items():
            log(f"{stamp()} {kn} hidden {h} "
                f"{'2d-rolling' if key == 'steps' else '2d-basic'} "
                f"B={B_MAIN} {'bf16' if kn.endswith('bf16') else 'f32'} "
                "(held to its plain version): "
                f"{r['ms']:.4f} ms/launch (plain {r['plain_ms']:.4f}, "
                f"library {r['library_ms']}, bound {r['bound']:.4f} ms, "
                f"{r['bound_by']})")
        bwd_b = replay_fns(ops, c, 1.0, key == "steps")[2]
        with torch.no_grad():  # the bf16 backward on the ring, twice
            for gn, x, y in zip(GRAD_NAMES, _flat_grads(bwd_b(dlp)),
                                _flat_grads(bwd_b(dlp))):
                _equal(f"K5b {key} bf16 hidden {h} B={B_MAIN} repeat {gn}",
                       x, y)
        log(f"{stamp()} K5 {key} hidden {h} "
            f"{'2d-rolling' if key == 'steps' else '2d-basic'} B={B_MAIN} "
            f"against the plain versions, max abs err (fwd, bwd): f32 "
            f"{held['f32'][0]:.2e}, {held['f32'][1]:.2e}; bf16 "
            f"{held['bf16'][0]:.2e}, {held['bf16'][1]:.2e}; two bf16 "
            "backward launches bit-identical")
        kb[key] = time_replay_dtypes(ops, ops32, dlp, c, key == "steps",
                                     hidden=h, f32=True)
        kb[key]["bwd"]["fallback_ms"] = time_fallback_replay(
            a, c, B_MAIN, dev, SEED + 10)
        for d in ("fwd", "bwd"):
            r = kb[key][d]
            log(f"{stamp()} replay_logp_{d}"
                f"{'_steps' if key == 'steps' else ''} hidden {h} "
                f"{'2d-rolling' if key == 'steps' else '2d-basic'} "
                f"B={B_MAIN}: f32 {r['f32_ms']:.4f} ms/call (plain "
                f"{r['f32_plain_ms']:.3f}, bound {r['f32_bound']:.4f} ms, "
                f"{r['f32_bound_by']}), bf16 {r['ms']:.4f} (plain "
                f"{r['plain_ms']:.3f}, bound {r['bound']:.4f} ms, "
                f"{r['bound_by']}); turns f32, bf16, bf16, f32: "
                f"{r['turns']}"
                + (f"; f32 bound with 3xTF32 products "
                   f"{r['f32_bound_3xtf32']:.4f} ms" if d == "bwd" else "")
                + (f"; the fallback replay (forward and backward) "
                   f"{r['fallback_ms']:.3f} ms" if d == "bwd" else ""))
    log(f"{stamp()} done in {time.perf_counter() - t0:.1f} s")

    def entry(name, replaces, dt, launches, err, ms, plain, bound, by):
        src = "replay.cu" if name.startswith("replay") else "actor_step.cu"
        return {"name": name, "route": "cuda",
                "source": f"tapnet_torch/csrc/{src}",
                "replaces": f"tapnet_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "library_ms": None, "dtype": dt, "hidden": h}

    kernels = []
    k2f, k2b = k2["2d-basic"]["f32"], k2["2d-basic"]["bf16"]
    kernels.append(entry(
        "actor_select_step", "pallas_actor_step.py:316", "float32",
        launches["actor_select_step"] + train_f["actor_select_step"]
        + roll_f["actor_select_step"], errs["K2 f32"], k2f["ms"],
        k2f["plain_ms"], k2f["bound"], k2f["bound_by"]))
    kernels.append(entry(
        "actor_select_step", "pallas_actor_step.py:316", "bfloat16",
        train_b["actor_select_step"] + roll_b["actor_select_step"],
        errs["K2 bf16"], k2b["ms"], k2b["plain_ms"], k2b["bound"],
        k2b["bound_by"]))
    # both modes at both shapes beside the 2d-basic main-path figures
    for e, dt in zip(kernels[-2:], ("f32", "bf16")):
        e["full_ms"] = k2["2d-basic"][dt]["full_ms"]
        r = k2["2d-rolling"][dt]
        e["2d-rolling"] = {"ms": r["ms"], "full_ms": r["full_ms"],
                           "plain_ms": r["plain_ms"], "bound_ms": r["bound"],
                           "bound_by": r["bound_by"]}
        if "bound_3xtf32" in r:  # bound_ms is the lower one, 3xTF32's
            e["bound_3xtf32_ms"] = k2["2d-basic"][dt]["bound_3xtf32"]
            e["2d-rolling"]["bound_3xtf32_ms"] = r["bound_3xtf32"]
    for dt, tr in (("float32", (launches, train_f, roll_f)),
                   ("bfloat16", (train_b, roll_b))):
        r = qp[dt]
        kernels.append(entry(
            "query_parts", "pallas_actor_step.py:243", dt,
            sum(t["query_parts"] for t in tr), qp_err["f32" if dt ==
                                                     "float32" else "bf16"],
            r["ms"], r["plain_ms"], r["bound"], r["bound_by"]))
        kernels[-1]["library_ms"] = r["library_ms"]
        if "bound_3xtf32" in r:  # bound_ms is the lower one, 3xTF32's
            kernels[-1]["bound_3xtf32_ms"] = r["bound_3xtf32"]
    # the backward's helper kernels: 2d-basic's figures, 2d-rolling's
    # beside them
    for kn, err, dt in (("grad_outer_tf32", go_err, "float32"),
                        ("grad_outer_bf16", gb_err, "bfloat16"),
                        ("reduce_tiles", rt_err, "float32")):
        r, rr = ht["mono"][kn], ht["steps"][kn]
        kernels.append(entry(kn, "pallas_replay.py:610", dt,
                             helper_n[kn], err, r["ms"], r["plain_ms"],
                             r["bound"], r["bound_by"]))
        kernels[-1].update(
            name="grad_outer" if kn == "grad_outer_bf16" else kn,
            source="tapnet_torch/csrc/replay.cu",
            library_ms=r["library_ms"],
            **{"2d-rolling": {"ms": rr["ms"], "plain_ms": rr["plain_ms"],
                              "bound_ms": rr["bound"],
                              "bound_by": rr["bound_by"],
                              "library_ms": rr["library_ms"]}})
    for key, suffix in (("mono", ""), ("steps", "_steps")):
        lines = {"mono": ("596", "652"), "steps": ("582", "635")}[key]
        for d, line in zip(("fwd", "bwd"), lines):
            name = f"replay_logp_{d}{suffix}"
            r = kb[key][d]
            err_key = f"K5{'f' if d == 'fwd' else 'b'} {key}"
            for dt, tr in (("float32", (train_f, roll_f)),
                           ("bfloat16", (train_b, roll_b))):
                f32 = dt == "float32"
                kernels.append(entry(
                    name, f"pallas_replay.py:{line}", dt,
                    tr[0][name] + tr[1][name],
                    errs[f"{err_key} {'f32' if f32 else 'bf16'}"],
                    r["f32_ms"] if f32 else r["ms"],
                    r["f32_plain_ms"] if f32 else r["plain_ms"],
                    r["f32_bound"] if f32 else r["bound"],
                    r["f32_bound_by"] if f32 else r["bound_by"]))
                if f32:  # 3xTF32 products; the fallback's replay
                    kernels[-1]["bound_3xtf32_ms"] = r["f32_bound_3xtf32"]
                    if d == "bwd":
                        kernels[-1]["fallback_ms"] = r["fallback_ms"]
                if f32 and name == "replay_logp_bwd_steps":
                    kernels[-1]["witness"] = {
                        "config": "2d-rolling", "hidden": 160, "batch": 256,
                        "seed": 10, "near_zero_pairs": wit["near_zero_pairs"],
                        "max_scaled_err": max(wit["scaled_errors"].values()),
                        "max_scaled_err_without_them": max(
                            wit["scaled_errors_without_them"].values())}
    return kernels, rows


# ------------------------------------------------------------------ #
# phase 27: K2 and K5 at every hidden width up to 512

WX_WIDTHS = (48, 288, 384, 512)  # 48 runs at 64 and 288 at 320 (padded)
WX_H, WX_OFF = 512, 48           # at full batch: the widest and an off-32


def wx_shapes(h):
    """(config, batch, temperature) where phase 27 holds K2 and K5 at
    hidden h: 2d-basic at 512 and multi-container at temperature 0.7 (C =
    2) at every width; at 288 and 512 also 2d-rolling (K2's 64-bit words,
    K5's step grid: the WX form in both of its widths' cases) and a ragged
    batch of 100."""
    return ([("2d-basic", 512, 1.0), ("multi-container", 512, 0.7)]
            + ([("2d-rolling", 512, 1.0), ("2d-basic", 100, 1.0)]
               if h in (288, WX_H) else []))


def check_wx_scratch_mirror():
    """The per-block device scratch above hidden 256, ops.actor_step and
    ops.replay `wx_scratch`, against the kernels' own (`tapnet_actor_scratch`,
    `tapnet_replay_scratch`) for the six CONFIGS at every multiple of 32 up
    to 512 (0 up to 256), K2's in both dtypes. Returns the cases."""
    import ctypes

    from tapnet_torch import CONFIGS
    from tapnet_torch.ops import _build
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import replay as RP
    from tapnet_torch.ops.policy_step import env_ints

    fa = _build.load("actor_step").tapnet_actor_scratch
    fr = _build.load("replay").tapnet_replay_scratch
    for fn in (fa, fr):
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_longlong
    n = 0
    for cfg in CONFIGS.values():
        for h in range(32, AS.MAX_H + 1, 32):
            ia = [_build.int_array([1] + env_ints(cfg)
                                   + [h, cfg.window, 0, bf]) for bf in (0, 1)]
            ir = _build.int_array(RP._ints(cfg, 1, h))
            got = (AS.wx_scratch(cfg, h), AS.wx_scratch(cfg, h, BF16),
                   RP.wx_scratch(cfg, h))
            want = (*(fa(ctypes.cast(i, ctypes.c_void_p)) for i in ia),
                    fr(ctypes.cast(ir, ctypes.c_void_p)))
            if got != want:
                raise AssertionError(f"wx_scratch {cfg} h={h}: mirrors "
                                     f"{got}, kernels {want}")
            n += 3
    return n


def wx_per_step(cfg, h, steps):
    """The kernel launches of a train step at hidden h: K2 a decode step,
    `query_parts` once a rollout above 128 (at the kernels' width), the
    replay backward of the config's schedule once, the reward once."""
    from tapnet_torch.ops import actor_step as AS

    return {"actor_select_step": cfg.num_blocks,
            "query_parts": int(AS.kernel_width(h) > 128),
            "replay_logp_bwd_steps" if steps else "replay_logp_bwd": 1,
            "heightmap_reductions": 1}


def time_fallback_decode(actor, cfg, B, dev, seed, dtype=torch.float32):
    """ms per decode step of a sampled rollout at batch B in the compute
    dtype `dtype` on the route the decoder falls back on past K2 (the head
    as PyTorch ops, K1 a step) and on K2's route, whole rollouts (the
    once-a-rollout operands included) over N steps (CUDA events, median of
    3)."""
    from tapnet_torch import random as R
    from tapnet_torch.train import rollout as RO

    inst = _instances(cfg, B, dev, seed)
    keys = R.split(R.key(seed + 1, dev), B)
    N = cfg.num_blocks
    out = {}
    with torch.no_grad():
        for name, fn in (("fallback", RO._rollout_record_stepfused),
                         ("kernel", RO._rollout_record_actorfused)):
            out[name] = time_gpu(lambda: fn(actor, inst, keys, cfg, False,
                                            1.0, True, dtype),
                                 reps=3, sleep_cycles=50_000_000,
                                 warm=1) / N
    return out


def phase_27(dev):
    """Phase 27 (module docstring): K2 and K5 at every hidden width up to
    512. Returns the kernels-line entries of hidden 512 and 48."""
    from tapnet_torch import CONFIGS, pack
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import policy_step as PS
    from tapnet_torch.ops import replay as RP
    from tapnet_torch.train import rollout as RO

    t0 = time.perf_counter()
    stamp = lambda: f"phase 27 [{time.perf_counter() - t0:.0f} s]"
    cfg, rcfg = CONFIGS["2d-basic"], CONFIGS["2d-rolling"]
    for h in WX_WIDTHS + (100,):
        for c in (cfg, rcfg):
            if RO.routes(c, True, h) != RO.Routes("actor", True, True):
                raise AssertionError(f"routes {c} hidden {h}: "
                                     f"{RO.routes(c, True, h)}")
    # 1. every width against the plain versions; the helpers alone at 512
    errs = check_wide_kernels(dev, lambda m: log(f"{stamp()} {m}"),
                              WX_WIDTHS, wx_shapes)
    go_err = check_grad_outer(dev, lambda m: log(f"{stamp()} {m}"),
                              (WX_H,))
    gb_err = check_grad_outer(dev, lambda m: log(f"{stamp()} {m}"),
                              (WX_H,), BF16)
    log(f"{stamp()} the WX scratch mirrors equal to the kernels' on "
        f"{check_wx_scratch_mirror()} cases, the plan mirrors on "
        f"{check_actor_smem_mirror()} (K2) and {check_replay_smem_mirror()} "
        f"(K5) cases at every multiple of 32 up to 512")
    qp_err = check_query_parts(dev, (384, WX_H))
    log(f"{stamp()} query_parts at hidden 384 and {WX_H} on QP_CASES "
        f"against the plain version: max abs err f32 "
        f"{qp_err['f32']:.2e}, bf16 {qp_err['bf16']:.2e}; repeats "
        "bit-identical; f32 from float64 products, scaled (kernel, plain): "
        + ", ".join(f"h={h} {k:.2e}, {p:.2e}"
                    for h, (k, p) in qp_err["f64"].items()))
    # 2. the main path at hidden 512 and 48: sampled pack(), then the
    # train steps, every launch counted
    helpers = {"grad_outer_tf32": RP.grad_outer_tf32,
               "grad_outer_bf16": RP.grad_outer_bf16,
               "reduce_tiles": RP.reduce_tiles}
    counters = {**train_counters(), **helpers}
    path = dict.fromkeys(counters, 0)  # every launch of phase 27's path
    for h in (WX_H, WX_OFF):
        actor = init_params(SEED, cfg, h, dev)
        inst = _instances(cfg, B_MAIN, dev, SEED + 4)
        before = {k: f.launches for k, f in counters.items()}
        plan = pack(inst, cfg, actor, policy="sample", key=SEED + 5)
        got = {k: f.launches - before[k] for k, f in counters.items()
               if f.launches - before[k]}
        for k, n in got.items():
            path[k] += n
        want = {"actor_select_step": cfg.num_blocks}
        if AS.kernel_width(h) > 128:
            want["query_parts"] = 1
        if got != want:
            raise AssertionError(f"pack(sample) hidden {h}: launches {got}, "
                                 f"expected {want}")
        check_plan(plan, inst, cfg, f"phase 27 pack(sample) hidden {h}")
        log(f"{stamp()} pack(sample) 2d-basic hidden {h} B={B_MAIN}: "
            f"launches {got} (no select_step)")
    trains = {}
    for name, c, h, dt in (("2d-basic", cfg, WX_H, None),
                           ("2d-basic bf16", cfg, WX_H, BF16),
                           ("2d-rolling", rcfg, WX_H, None),
                           ("2d-rolling bf16", rcfg, WX_H, BF16),
                           ("2d-basic", cfg, WX_OFF, None)):
        steps = c is rcfg
        before = {k: f.launches for k, f in helpers.items()}
        trains[(name, h)], _, _ = train_main_path(
            c, dev, wx_per_step(c, h, steps), n_steps=1, hidden=h,
            compute_dtype=dt)
        hl = {k: f.launches - before[k] for k, f in helpers.items()}
        for k, n in {**trains[(name, h)], **hl}.items():
            path[k] += n
        want = {"grad_outer_tf32": int(dt is None and h > 128),
                "grad_outer_bf16": int(dt is not None),
                "reduce_tiles": 2 if steps else 1}
        if hl != want:
            raise AssertionError(f"train step {name} hidden {h}: helper "
                                 f"launches {hl}, expected {want}")
    for k, n in path.items():
        if k not in ("select_step", "replay_logp_fwd",
                     "replay_logp_fwd_steps") and n == 0:
            raise AssertionError(f"phase 27's main path launched {k} no "
                                 f"time: {path}")
    if path["select_step"]:
        raise AssertionError(f"phase 27's main path launched select_step")
    log(f"{stamp()} train steps (2d-basic and 2d-rolling hidden {WX_H} f32 "
        f"and bf16, 2d-basic hidden {WX_OFF}; batch {B_MAIN}; no "
        f"select_step, no general replay): launches of the main path "
        f"{path}")
    # the command line at hidden 512: its traced calls name K2's and K5's
    # kernels and not K1's
    import glob
    import os
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "cli")
        _run_cli(["train", "--config", "2d-basic", "--hidden", str(WX_H),
                  "--epochs", "1", "--steps-per-epoch", "4", "--batch",
                  str(B_MAIN), "--valid-batch", "256", "--ckpt-dir", d,
                  "--metrics", os.path.join(d, "m.jsonl"), "--trace-dir",
                  os.path.join(d, "trace")], tmp)
        lines = [json.loads(x) for x in open(os.path.join(d, "m.jsonl"))]
        traces = glob.glob(os.path.join(d, "trace", "*.json"))
        text = open(traces[0]).read() if len(traces) == 1 else ""
        names = {k: k in text for k in ("actor_step_kernel", "replay_kernel",
                                        "query_parts", "select_step_kernel")}
        if (not lines or not np.isfinite(lines[-1]["loss_actor"])
                or names != {"actor_step_kernel": True, "replay_kernel": True,
                             "query_parts": True,
                             "select_step_kernel": False}):
            raise AssertionError(f"cli train --hidden {WX_H}: {lines}, "
                                 f"kernels in its trace {names}")
    log(f"{stamp()} cli train --hidden {WX_H} (2d-basic, batch {B_MAIN}, 4 "
        f"steps): reward {lines[-1]['reward']:.6f}; its trace names "
        "actor_step_kernel, query_parts and replay_kernel, not "
        "select_step_kernel")
    # (2d-rolling's graphs at batch 1024, for time: its steps at 4096 ran
    # above, and `profile_pack --train --config 2d-rolling --hidden 512
    # --steps-per-call 4` times them)
    rows = {}
    for name, c, h, k, dt in (("2d-basic", cfg, WX_H, 8, None),
                              ("2d-basic bf16", cfg, WX_H, 8, BF16),
                              ("2d-rolling", rcfg, WX_H, 4, None),
                              ("2d-rolling bf16", rcfg, WX_H, 4, BF16)):
        rows[(name, h)] = check_graph_steps(
            f"{name} hidden {h}", c, dev, wx_per_step(c, h, c is rcfg), k,
            1024 if c is rcfg else B_MAIN, hidden=h, compute_dtype=dt,
            tag="phase 27", profile=False)
    # 3. the main paths' shapes at batch 4096: each kernel against its
    # plain version on the operands it is then timed on, beside the
    # fallback it replaces
    bump = lambda k, v: errs.__setitem__(k, max(errs[k], v))
    k2 = {}
    for h in (WX_H, WX_OFF):
        a = init_params(SEED, cfg, h, dev)
        kept, err, rate = check_actor_step_bf16(cfg, B_MAIN, a, dev,
                                                keep=True)
        bump("K2 bf16", err)
        with torch.no_grad():
            _, err32 = hold_k2(kept[1], cfg, 1.0, AS.transposed(kept[1][16]),
                               f"hidden {h} 2d-basic B={B_MAIN}")
        bump("K2 f32", err32)
        k2[h] = {"f32": time_actor_step(kept[1], cfg, h, plain_reps=5,
                                        plain_sleep=200_000_000),
                 "turns": time_actor_dtypes(kept, cfg, h),
                 "fallback": time_fallback_decode(a, cfg, B_MAIN, dev,
                                                  SEED + 6),
                 "fallback_bf16": time_fallback_decode(a, cfg, B_MAIN, dev,
                                                       SEED + 6, BF16)}
        k2[h]["bf16"] = k2[h]["turns"]
        log_actor_times(f"{stamp()} hidden {h} f32", cfg, k2[h]["f32"])
        log_actor_times(f"{stamp()} hidden {h} bf16", cfg, k2[h]["bf16"])
        fb, fbb = k2[h]["fallback"], k2[h]["fallback_bf16"]
        log(f"{stamp()} actor_select_step hidden {h} 2d-basic B={B_MAIN}: "
            f"bf16 rollout against the plain bf16 version, max err "
            f"{err:.2e} (action agreement {rate:.6f}); f32 at its middle "
            f"step, max err {err32:.2e}; in turns f32 "
            f"{k2[h]['turns']['f32_turns']}, bf16 "
            f"{k2[h]['turns']['bf16_turns']} ms/launch; a sampled decode "
            f"step, whole rollouts: {fb['kernel']:.4f} ms on K2's route, "
            f"{fb['fallback']:.4f} on the fallback (K1 and the head as "
            f"PyTorch ops); bf16 {fbb['kernel']:.4f} and "
            f"{fbb['fallback']:.4f}")
    qp = {}
    a512 = init_params(SEED, cfg, WX_H, dev)
    for dt, d in (("float32", torch.float32), ("bfloat16", BF16)):
        qp[dt] = time_query_parts(a512, cfg, dev, d)
        r = qp[dt]
        log(f"{stamp()} query_parts hidden {WX_H} 2d-basic B={B_MAIN} {dt}: "
            f"{r['ms']:.4f} ms/launch (plain {r['plain_ms']:.4f}; two "
            f"torch.mm {r['library_ms']:.4f}; bound {r['bound']:.5f} ms, "
            f"{r['bound_by']})")
    kb, ht, rt_err = {}, {}, 0.0
    for key, c, h in (("mono", cfg, WX_H), ("steps", rcfg, WX_H),
                      ("mono", cfg, WX_OFF)):
        a = init_params(SEED, c, h, dev)
        steps = key == "steps"
        ops, _, ops32 = replay_operands(a, c, B_MAIN, dev, SEED + 10, 1.0,
                                        dtype=BF16, also=torch.float32)
        dlp = torch.linspace(-1.0, 1.0, B_MAIN, device=dev)
        held = {}
        for dt, o in (("f32", ops32), ("bf16", ops)):
            held[dt] = hold_replay(o, dlp, c, steps,
                                   torch.float32 if dt == "f32" else BF16)
            bump(f"K5f {key} {dt}", held[dt][0])
            bump(f"K5b {key} {dt}", held[dt][1])
        if h == WX_H:
            _, kf = kept_backward(replay_fns(ops32, c, 1.0, steps)[2], dlp)
            go_err = max(go_err, _hold_grad_outer(
                kf, c, h, f"grad_outer_tf32 h={h} {key} B={B_MAIN}"))
            for what, (shape, w, _, e) in _hold_reduce_tiles(
                    kf, f"reduce_tiles f32 h={h} {key} B={B_MAIN}").items():
                rt_err = max(rt_err, e)
                log(f"{stamp()} {what} {shape}: bit for bit against its "
                    f"plain version and the backward's own sum, {w}-float "
                    "loads")
            ht[key] = time_helpers(kf, c, h)
            del kf
            _, kg = kept_backward(replay_fns(ops, c, 1.0, steps)[2], dlp)
            gb_err = max(gb_err, _hold_grad_outer(
                kg, c, h, f"grad_outer_bf16 h={h} {key} B={B_MAIN}"))
            ht[key]["grad_outer_bf16"] = time_grad_outer(kg, c, h)
            del kg
        r = kb[(key, h)] = time_replay_dtypes(ops, ops32, dlp, c, steps,
                                              hidden=h, f32=True)
        r["bwd"]["fallback_ms"] = time_fallback_replay(a, c, B_MAIN, dev,
                                                       SEED + 10)
        if h == WX_H:
            r["bwd"]["fallback_bf16_ms"] = time_fallback_replay(
                a, c, B_MAIN, dev, SEED + 10, BF16)
        for d in ("fwd", "bwd"):
            x = r[d]
            log(f"{stamp()} replay_logp_{d}{'_steps' if steps else ''} "
                f"hidden {h} {c is rcfg and '2d-rolling' or '2d-basic'} "
                f"B={B_MAIN} (max abs err f32 {held['f32'][d == 'bwd']:.2e}"
                f", bf16 {held['bf16'][d == 'bwd']:.2e}): f32 "
                f"{x['f32_ms']:.4f} ms/call (plain {x['f32_plain_ms']:.3f}, "
                f"bound {x['f32_bound']:.4f} ms, {x['f32_bound_by']}), bf16 "
                f"{x['ms']:.4f} (plain {x['plain_ms']:.3f}, bound "
                f"{x['bound']:.4f} ms, {x['bound_by']}); turns f32, bf16, "
                f"bf16, f32: {x['turns']}"
                + (f"; the fallback replay (forward and backward) f32 "
                   f"{x['fallback_ms']:.3f} ms" if d == "bwd" else "")
                + (f", bf16 {x['fallback_bf16_ms']:.3f} ms"
                   if "fallback_bf16_ms" in x and d == "bwd" else ""))
    for key, t in ht.items():
        for kn, x in t.items():
            log(f"{stamp()} {kn} hidden {WX_H} "
                f"{'2d-rolling' if key == 'steps' else '2d-basic'} "
                f"B={B_MAIN}: {x['ms']:.4f} ms/launch (plain "
                f"{x['plain_ms']:.4f}, library {x['library_ms']}, bound "
                f"{x['bound']:.4f} ms, {x['bound_by']})")
    log(f"{stamp()} done in {time.perf_counter() - t0:.1f} s")

    def entry(name, replaces, dt, h, launches, err, r, src="actor_step.cu"):
        return {"name": name, "route": "cuda",
                "source": f"tapnet_torch/csrc/{src}",
                "replaces": f"tapnet_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"],
                "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms"), "dtype": dt, "hidden": h,
                # float32: bound_ms is the lower of 3xTF32's and the f32
                # rate's, both kept
                **{f"{k}_ms": r[k] for k in ("bound_3xtf32",
                                             "f32_rate_bound") if k in r}}

    t = lambda *keys: sum(trains[k][n] for k in keys
                          for n in ("actor_select_step",))
    k2_launch = {
        (WX_H, "float32"): cfg.num_blocks + t(("2d-basic", WX_H),
                                              ("2d-rolling", WX_H)),
        (WX_H, "bfloat16"): t(("2d-basic bf16", WX_H),
                              ("2d-rolling bf16", WX_H)),
        (WX_OFF, "float32"): cfg.num_blocks + t(("2d-basic", WX_OFF))}
    kernels = []
    for (h, dt), n in k2_launch.items():
        r = k2[h]["f32" if dt == "float32" else "bf16"]
        kernels.append(entry("actor_select_step", "pallas_actor_step.py:316",
                             dt, h, n, errs["K2 f32" if dt == "float32"
                                            else "K2 bf16"], r))
        fb = k2[h]["fallback" if dt == "float32" else "fallback_bf16"]
        kernels[-1]["fallback_ms"] = fb["fallback"]
        kernels[-1]["kernel_route_ms"] = fb["kernel"]
        if h != AS.kernel_width(h):
            kernels[-1]["kernel_width"] = AS.kernel_width(h)
    for dt in ("float32", "bfloat16"):  # pack(sample) f32, then the steps
        bf = dt == "bfloat16"
        n = int(not bf) + sum(trains[k]["query_parts"] for k in trains
                              if k[1] == WX_H and k[0].endswith("bf16") == bf)
        kernels.append(entry("query_parts", "pallas_actor_step.py:243", dt,
                             WX_H, n, qp_err["bf16" if bf else "f32"],
                             qp[dt]))
    for kn, err, dt in (("grad_outer_tf32", go_err, "float32"),
                        ("grad_outer_bf16", gb_err, "bfloat16"),
                        ("reduce_tiles", rt_err, "float32")):
        r, rr = ht["mono"][kn], ht["steps"][kn]
        kernels.append(entry("grad_outer" if kn == "grad_outer_bf16" else kn,
                             "pallas_replay.py:610", dt, WX_H, path[kn],
                             err, r, "replay.cu"))
        kernels[-1]["2d-rolling"] = {
            "ms": rr["ms"], "plain_ms": rr["plain_ms"],
            "bound_ms": rr["bound"], "bound_by": rr["bound_by"],
            "library_ms": rr["library_ms"]}
    lines = {"replay_logp_fwd": "596", "replay_logp_bwd": "652",
             "replay_logp_fwd_steps": "582", "replay_logp_bwd_steps": "635"}
    for (key, h), r in kb.items():
        for d in ("fwd", "bwd"):
            name = f"replay_logp_{d}{'_steps' if key == 'steps' else ''}"
            for dt in ("float32", "bfloat16"):
                f32 = dt == "float32"
                if h != WX_H and not f32:
                    continue
                x = r[d]
                n = sum(trains[k][name] for k in trains if k[1] == h
                        and k[0].endswith("bf16") != f32)
                kernels.append(entry(
                    name, f"pallas_replay.py:{lines[name]}", dt, h, n,
                    errs[f"K5{d[0]} {key} {'f32' if f32 else 'bf16'}"],
                    {"ms": x["f32_ms" if f32 else "ms"],
                     "plain_ms": x["f32_plain_ms" if f32 else "plain_ms"],
                     "bound": x["f32_bound" if f32 else "bound"],
                     "bound_by": x["f32_bound_by" if f32 else "bound_by"]},
                    "replay.cu"))
                if d == "bwd":
                    kernels[-1]["fallback_ms"] = x.get(
                        "fallback_ms" if f32 else "fallback_bf16_ms")
                if h != AS.kernel_width(h):
                    kernels[-1]["kernel_width"] = AS.kernel_width(h)
    return kernels, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tapnet_torch import CONFIGS, TAPConfig
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import _build
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import policy_step as PS

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    # phase 5's ptxas report of K1, K2 and K4 compiles beside the build
    pool = ThreadPoolExecutor(1)
    ptxas = pool.submit(_build.ptxas_report,
                        names=("actor_step", "policy_step", "env"))
    pool.shutdown(wait=False)
    libs = _build.build_all()
    log(f"phase 0 build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # the four serving configs, plus a ragged batch (not a multiple of the
    # kernels' tiles) and, for select_step, a capped lb-hard config
    configs = dict(CONFIGS)
    configs["2d-capped-hard"] = TAPConfig(allow_rot=True, target_height=12,
                                          reward_type="C+P+S-lb-hard")
    cases = [("2d-basic", 4096), ("2d-rot", 512), ("3d-basic", 512),
             ("multi-container", 512), ("2d-basic", 100)]
    actors = {n: init_params(SEED, configs[n], HIDDEN, dev)
              for n in ("2d-basic", "2d-rot", "3d-basic", "multi-container",
                        "2d-capped-hard")}
    kept_k1 = kept_k2 = None
    for name, B in cases + [("2d-capped-hard", 512)]:
        k = check_select_step(configs[name], B, actors[name], dev,
                              keep=(name, B) == ("2d-basic", 4096))
        kept_k1 = kept_k1 or k
        log(f"phase 2 select_step == plain: {name} B={B}, "
            f"{configs[name].num_blocks} steps")
    k2_err = 0.0
    for name, B in cases:
        k, err = check_actor_step(configs[name], B, actors[name], dev,
                                  keep=(name, B) == ("2d-basic", 4096))
        kept_k2 = kept_k2 or k
        k2_err = max(k2_err, err)
        log(f"phase 3 actor_select_step == plain: {name} B={B}, max "
            f"logit/logp err {err:.3e}")
    torch.cuda.synchronize()

    cfg = CONFIGS["2d-basic"]
    actor = actors["2d-basic"]
    launches, inst = main_path(cfg, actor, dev)
    log(f"phase 4 main path launches: {launches}")
    check_against_cpu(cfg, actor, inst, dev)

    # ---- phase 5: times at the main path's shapes (2d-basic, B=4096)
    k1 = time_select_step(kept_k1, cfg)
    log_select_times("phase 5", "2d-basic", B_MAIN, k1)
    k2 = time_actor_step(kept_k2, cfg, HIDDEN)
    log_actor_times("phase 5", cfg, k2)
    for line in ptxas.result().splitlines():
        log(f"phase 5 ptxas {line}")

    from tapnet_torch import pack
    best_inst = inst.index(slice(0, 256))
    for policy, x in (("greedy", inst), ("sample", inst),
                      ("best", best_inst)):
        ms = time_host(lambda: pack(x, cfg, actor, policy=policy,
                                    key=SEED + 7, n_samples=16), reps=20)
        rows = x.dims.shape[0] * (16 if policy == "best" else 1)
        log(f"phase 5 pack({policy}): {ms:.3f} ms for {rows} rollouts x "
            f"{cfg.num_blocks} steps = {rows * cfg.num_blocks / ms * 1e3:.0f}"
            " env-steps/s")

    # ---- phase 6: K3 on final heightmaps of sampled rollouts
    from tapnet_torch.ops import reward as RW
    hm_main = check_reward(cfg, 4096, actor, dev)
    for name in ("3d-basic", "multi-container"):
        check_reward(configs[name], 512, actors[name], dev)
    log("phase 6 heightmap_reductions == plain, bit-equal: 2d-basic "
        "B=4096, 3d-basic and multi-container B=512, all-zero heightmaps")

    # ---- phase 7: K5 forward and backward on the card's own records
    from tapnet_torch.ops import replay as RP
    configs["padded"] = TAPConfig(num_blocks=8, min_blocks=4,
                                  container_width=8, container_height=8,
                                  target_width=8, allow_rot=True)
    configs["4-container"] = TAPConfig(
        dim=3, container_width=8, container_depth=8, container_height=8,
        target_width=8, target_depth=8, num_containers=4, allow_rot=True)
    configs["2d-4-container"] = TAPConfig(num_containers=4,
                                          container_height=20,
                                          allow_rot=True)
    for name in ("multi-container-capped", "padded", "4-container",
                 "2d-4-container"):
        actors[name] = init_params(SEED, configs[name], HIDDEN, dev)
    k5f_err = k5b_err = 0.0
    kept_k5 = None
    for name, B, temp in (("2d-basic", 4096, 1.0), ("2d-rot", 512, 1.0),
                          ("3d-basic", 512, 1.0),
                          ("multi-container", 512, 1.0),
                          ("multi-container-capped", 512, 1.0),
                          ("2d-basic", 100, 1.0), ("padded", 512, 0.7),
                          ("4-container", 512, 1.0),
                          ("2d-4-container", 512, 1.0)):
        main_shape = (name, B) == ("2d-basic", 4096)
        ops, dlp, fe, (be, ba), e0 = check_replay(
            configs[name], B, actors[name], dev, temp, repeat=main_shape)
        if main_shape:
            kept_k5 = (ops, dlp)
        k5f_err, k5b_err = max(k5f_err, fe), max(k5b_err, ba)
        log(f"phase 7 replay_logp == plain: {name} B={B} temperature "
            f"{temp}: fwd max err {fe:.3e}, bwd max err {ba:.3e} (scaled "
            f"{be:.3e}); fwd vs the rollout's logp {e0:.3e}"
            + ("; two bwd launches bit-identical" if main_shape else ""))
    torch.cuda.synchronize()

    # ---- phase 8: the train path
    from tapnet_torch.train.trainer import assert_deterministic
    train_launches, ts, step = train_main_path(cfg, dev)
    log(f"phase 8 train path launches (5 steps): {train_launches}")
    assert_deterministic(step, ts)
    log("phase 8 one train step run twice from a copy of one state: params, "
        "optimizer state, key and metrics bit-identical")
    check_train_against_cpu(cfg, ts, dev)
    with tempfile.TemporaryDirectory() as tmp:
        check_trainer(cfg, dev, tmp)

    # ---- phase 9: times of K3, K5 and the train step (2d-basic, B=4096)
    C = cfg.num_containers
    k3_ms = time_gpu(lambda: RW.heightmap_reductions(hm_main))
    k3_plain = time_gpu(lambda: RW.heightmap_reductions_ref(hm_main))
    k3_lib = time_gpu(lambda: (hm_main.amax((2, 3)), hm_main.sum((2, 3))))
    k3_bytes = nbytes([hm_main]) + 2 * 4 * B_MAIN * C
    k3_bound = 1e3 * k3_bytes / HBM_BYTES_S
    ops, dlp = kept_k5
    k5f_ms = time_gpu(lambda: RP.replay_logp_fwd(*ops, cfg))
    k5f_plain = time_gpu(lambda: RP.replay_logp_fwd_ref(*ops, cfg),
                         sleep_cycles=100_000_000)
    k5b_ms = time_gpu(lambda: RP.replay_logp_bwd(dlp, *ops, cfg))
    k5b_plain = time_gpu(lambda: RP.replay_logp_bwd_ref(dlp, *ops, cfg),
                         sleep_cycles=200_000_000)
    in_bytes = nbytes(ops[:8]) + nbytes(ops[8])
    d_se, d_ctx, d_par = RP.replay_logp_bwd(dlp, *ops, cfg)
    k5f_b = in_bytes + 4 * B_MAIN
    k5b_b = in_bytes + nbytes([dlp, d_se, d_ctx]) + nbytes(d_par)
    pairs, triples = live_counts(cfg, ops[2], ops[3])
    k5f_o = replay_ops_count(cfg, B_MAIN, HIDDEN, False, pairs, triples)
    k5b_o = replay_ops_count(cfg, B_MAIN, HIDDEN, True, pairs, triples)
    k5f_all = replay_ops_count(cfg, B_MAIN, HIDDEN, False)
    k5b_all = replay_ops_count(cfg, B_MAIN, HIDDEN, True)
    bound = lambda b, o, rate=F32_OPS_S: (
        max(1e3 * b / HBM_BYTES_S, 1e3 * o / rate),
        "operations" if o / rate >= b / HBM_BYTES_S else "bytes")
    k5f_bound, k5f_by = bound(k5f_b, k5f_o)
    k5b_bound, k5b_by = bound(k5b_b, k5b_o)
    log(f"phase 9 heightmap_reductions (the reductions alone): "
        f"{k3_ms:.4f} ms/launch (plain "
        f"{k3_plain:.4f}, library amax+sum {k3_lib:.4f}), {k3_bytes} B, "
        f"bound {k3_bound:.5f} ms")
    log(f"phase 9 replay live columns 2d-basic B={B_MAIN}: {pairs} "
        f"(instance, step) pairs with an action, {triples} of "
        f"{B_MAIN * cfg.num_blocks * cfg.num_blocks * cfg.num_rot} "
        "(instance, step, token) triples live")
    log(f"phase 9 replay_logp_fwd: {k5f_ms:.4f} ms/launch (plain "
        f"{k5f_plain:.4f}), {k5f_b} B, {k5f_o} f32 ops over live columns "
        f"({k5f_all} over all tokens), bound {k5f_bound:.4f} ms ({k5f_by}; "
        f"all tokens {bound(k5f_b, k5f_all)[0]:.4f})")
    log(f"phase 9 replay_logp_bwd: {k5b_ms:.4f} ms/launch (plain "
        f"{k5b_plain:.4f}), {k5b_b} B, {k5b_o} f32 ops over live columns "
        f"({k5b_all} over all tokens), bound {k5b_bound:.4f} ms ({k5b_by}; "
        f"all tokens {bound(k5b_b, k5b_all)[0]:.4f})")
    step_ms = time_host(lambda: step(ts), reps=10)
    log(f"phase 9 train step 2d-basic hidden {HIDDEN} batch {B_MAIN}: "
        f"{step_ms:.3f} ms/step = "
        f"{B_MAIN * cfg.num_blocks / step_ms * 1e3:.0f} env-steps/s")

    # ---- phase 10: K4 vs its plain version, bit-equal
    from tapnet_torch.ops import env as OE
    extra = heuristic_cases()
    k4_cases = ([(n, CONFIGS[n], 512) for n in CONFIGS]
                + [(n, c, 512) for n, c in extra.items()]
                + [("2d-basic", cfg, 100), ("2d-basic", cfg, B_MAIN)])
    for name, c4, B4 in k4_cases:
        noops = [check_fused_rollout(c4, B4, dev, policy)
                 for policy in ("first", "random")]
        log(f"phase 10 fused_rollout_batch == plain, bit-equal: {name} "
            f"B={B4}, first and random ({noops[0]} and {noops[1]} no-op "
            "steps)")
    torch.cuda.synchronize()

    # ---- phase 11: K1 and K2 under the mcs rule
    mcs_cases = {
        "2d-mcs-soft": extra["2d-mcs-soft"],
        "3d-mcs-hard-2c": TAPConfig(
            dim=3, container_width=6, container_depth=6, container_height=6,
            target_width=6, target_depth=6, num_containers=2, allow_rot=True,
            reward_type="C+P+S-mcs-hard")}
    for name, cm in mcs_cases.items():
        actor_m = init_params(SEED, cm, HIDDEN, dev)
        check_select_step(cm, 512, actor_m, dev)
        _, err = check_actor_step(cm, 512, actor_m, dev)
        k2_err = max(k2_err, err)
        log(f"phase 11 select_step and actor_select_step == plain under "
            f"mcs: {name} B=512, max logit/logp err {err:.3e}")
    torch.cuda.synchronize()

    # ---- phase 12: the heuristic main path
    heur_launches, plans, insts = heuristic_main_path(CONFIGS, dev)
    log(f"phase 12 heuristic main path launches (12 pack calls): "
        f"{heur_launches}")
    for (name, policy), plan in plans.items():
        check_heuristic_plan(plan, insts[name], CONFIGS[name],
                             f"pack({policy}) {name}")
    check_heuristic_against_cpu(CONFIGS, insts, actor, dev)

    # ---- phase 13: times of K4 and of pack(first/random)
    k4 = {}
    for name, c4 in CONFIGS.items():
        k4[name] = time_fused_rollout(c4, B_MAIN, dev)
        ms, plain, moved, iops, _ = k4[name]
        log(f"phase 13 fused_rollout_batch {name} B={B_MAIN} random: "
            f"{ms:.4f} ms/launch (plain {plain:.3f}), {moved} B, {iops} "
            f"int32 ops, bound "
            f"{1e3 * max(moved / HBM_BYTES_S, iops / I32_OPS_S):.5f} ms = "
            f"{B_MAIN * c4.num_blocks / ms * 1e3:.0f} env-steps/s")
    k4_ms, k4_plain, k4_bytes, k4_iops, k4_err = k4["2d-basic"]
    k4_bound, k4_by = bound(k4_bytes, k4_iops, I32_OPS_S)
    for policy in ("first", "random"):
        ms = time_host(lambda: pack(insts["2d-basic"], cfg, policy=policy,
                                    key=SEED + 7), reps=20)
        log(f"phase 13 pack({policy}): {ms:.3f} ms for {B_MAIN} rollouts x "
            f"{cfg.num_blocks} steps = "
            f"{B_MAIN * cfg.num_blocks / ms * 1e3:.0f} env-steps/s")

    # ---- phase 14: K2 with a rolling window / two precedence limbs
    roll = rolling_cases()
    roll_actors = {n: init_params(SEED, c, HIDDEN, dev)
                   for n, c in roll.items()}
    rcfg, ractor = roll["2d-rolling"], roll_actors["2d-rolling"]
    kept_k2r = None
    for name, Br in ([(n, b) for n in roll for b in (512, 100)]
                     + [("2d-rolling", B_MAIN)]):
        k, err = check_actor_step(roll[name], Br, roll_actors[name], dev,
                                  keep=(name, Br) == ("2d-rolling", B_MAIN))
        kept_k2r = kept_k2r or k
        k2_err = max(k2_err, err)
        log(f"phase 14 actor_select_step == plain (window {roll[name].window}"
            f", {AS._num_limbs(roll[name].num_blocks)} limb(s)): {name} "
            f"B={Br}, {roll[name].num_blocks} steps, max logit/logp err "
            f"{err:.3e}")
    torch.cuda.synchronize()

    # ---- phase 15: the step-grid replay on the card's own records
    k5fs_err = k5bs_err = 0.0
    kept_k5s = None
    # plus four containers under a rolling window
    roll_k5 = dict(roll, **{"rolling-4c": TAPConfig(
        num_blocks=12, min_blocks=6, container_width=8, container_height=12,
        target_width=8, window=4, num_containers=4, allow_rot=True)})
    k5_actors = dict(roll_actors, **{"rolling-4c": init_params(
        SEED, roll_k5["rolling-4c"], HIDDEN, dev)})
    for name, Br in ([(n, b) for n in roll_k5 for b in (512, 100)]
                     + [("2d-rolling", B_MAIN)]):
        main_shape = (name, Br) == ("2d-rolling", B_MAIN)
        ops_s, dlp_s, fe, (be, ba), e0 = check_replay(
            roll_k5[name], Br, k5_actors[name], dev, repeat=main_shape,
            steps=True)
        if main_shape:
            kept_k5s = (ops_s, dlp_s)
        k5fs_err, k5bs_err = max(k5fs_err, fe), max(k5bs_err, ba)
        log(f"phase 15 step-grid replay == plain: {name} B={Br} "
            f"({RP.step_chunks(roll_k5[name], Br)} step chunks): fwd max err "
            f"{fe:.3e}, bwd max err {ba:.3e} (scaled {be:.3e}); fwd vs the "
            f"rollout's logp {e0:.3e}"
            + ("; two bwd launches bit-identical" if main_shape else ""))
    fe, be = check_steps_against_monolithic(*kept_k5, cfg)
    log(f"phase 15 step-grid replay forced onto 2d-basic B={B_MAIN} == "
        f"monolithic kernels: fwd max err {fe:.3e}, bwd max scaled err "
        f"{be:.3e}")
    torch.cuda.synchronize()

    # ---- phase 16: the rolling main path (2d-rolling, hidden 128)
    roll_launches, rinst = main_path(rcfg, ractor, dev)
    log(f"phase 16 rolling main path launches: {roll_launches}")
    check_against_cpu(rcfg, ractor, rinst, dev)
    roll_step = {"actor_select_step": rcfg.num_blocks,
                 "replay_logp_bwd_steps": 1, "heightmap_reductions": 1}
    roll_train, rts, rstep = train_main_path(rcfg, dev, roll_step, n_steps=3)
    log(f"phase 16 rolling train path launches (3 steps): {roll_train}")
    assert_deterministic(rstep, rts)
    log("phase 16 one rolling train step run twice from a copy of one "
        "state: params, optimizer state, key and metrics bit-identical")
    check_train_against_cpu(rcfg, rts, dev, B=64)
    with tempfile.TemporaryDirectory() as tmp:
        check_trainer(rcfg, dev, tmp, spe=2)
    ccfg = CONFIGS["multi-container-capped"]
    capped_step = {"select_step": ccfg.num_blocks, "replay_logp_bwd": 1,
                   "heightmap_reductions": 1}
    capped_train, cts, _ = train_main_path(ccfg, dev, capped_step, n_steps=1,
                                           batch=256)
    log(f"phase 16 capped train step (multi-container-capped, batch 256) "
        f"launches: {capped_train}")
    check_train_against_cpu(ccfg, cts, dev)

    # ---- phase 17: times at 2d-rolling, batch 4096 (K1 also on the
    # capped train step's shape)
    k2r = time_actor_step(kept_k2r, rcfg, HIDDEN, plain_reps=5,
                          plain_sleep=200_000_000)
    log_actor_times("phase 17", rcfg, k2r)
    for name, c1, B1 in (("2d-rolling", rcfg, B_MAIN),
                         ("multi-container-capped", ccfg, 256)):
        kept = check_select_step(c1, B1, init_params(SEED, c1, HIDDEN, dev),
                                 dev, keep=True)
        log(f"phase 17 select_step == plain: {name} B={B1}, "
            f"{c1.num_blocks} steps")
        log_select_times("phase 17", name, B1, time_select_step(kept, c1))
    ops_s, dlp_s = kept_k5s
    fwd_s, fwd_s_ref, bwd_s, bwd_s_ref = replay_fns(ops_s, rcfg, 1.0, True)
    k5fs_ms = time_gpu(fwd_s, reps=10)
    k5fs_plain = time_gpu(fwd_s_ref, reps=2, sleep_cycles=400_000_000,
                          warm=1)
    k5bs_ms = time_gpu(lambda: bwd_s(dlp_s), reps=10)
    k5bs_plain = time_gpu(lambda: bwd_s_ref(dlp_s), reps=2,
                          sleep_cycles=400_000_000, warm=1)
    pairs, triples = live_counts(rcfg, ops_s[2], ops_s[3])
    T_r = rcfg.num_blocks * rcfg.num_rot
    log(f"phase 17 replay live columns 2d-rolling B={B_MAIN}: {pairs} of "
        f"{B_MAIN * rcfg.num_blocks} (instance, step) pairs with an action, "
        f"{triples} of {B_MAIN * rcfg.num_blocks * T_r} (instance, step, "
        f"token) triples live = "
        f"{triples / (B_MAIN * rcfg.num_blocks * T_r):.6f}")
    in_bytes_s = nbytes(ops_s[:8]) + nbytes(ops_s[8]) + nbytes([ops_s[3]])
    d_se, d_ctx, d_par = bwd_s(dlp_s)
    k5fs_b = in_bytes_s + 4 * B_MAIN
    k5bs_b = in_bytes_s + nbytes([dlp_s, d_se, d_ctx]) + nbytes(d_par)
    del d_se, d_ctx, d_par
    k5fs_o = replay_ops_count(rcfg, B_MAIN, HIDDEN, False, pairs, triples)
    k5bs_o = replay_ops_count(rcfg, B_MAIN, HIDDEN, True, pairs, triples)
    k5fs_all = replay_ops_count(rcfg, B_MAIN, HIDDEN, False)
    k5bs_all = replay_ops_count(rcfg, B_MAIN, HIDDEN, True)
    k5fs_bound, k5fs_by = bound(k5fs_b, k5fs_o)
    k5bs_bound, k5bs_by = bound(k5bs_b, k5bs_o)
    scratch = RP.scratch_bytes(rcfg, B_MAIN, HIDDEN)
    log(f"phase 17 replay_logp_fwd_steps 2d-rolling B={B_MAIN}: "
        f"{k5fs_ms:.4f} ms/call (plain {k5fs_plain:.3f}), {k5fs_b} B, "
        f"{k5fs_o} f32 ops over the live columns ({k5fs_all} over all "
        f"pairs and tokens), bound {k5fs_bound:.4f} ms ({k5fs_by}; all "
        f"tokens {bound(k5fs_b, k5fs_all)[0]:.4f})")
    log(f"phase 17 replay_logp_bwd_steps 2d-rolling B={B_MAIN}: "
        f"{k5bs_ms:.4f} ms/call (plain {k5bs_plain:.3f}), {k5bs_b} B, "
        f"{k5bs_o} f32 ops over the live columns ({k5bs_all} over all "
        f"pairs and tokens), bound {k5bs_bound:.4f} ms ({k5bs_by}; all "
        f"tokens {bound(k5bs_b, k5bs_all)[0]:.4f}); scratch {scratch}")
    rbest = rinst.index(slice(0, 256))
    for policy, x in (("greedy", rinst), ("sample", rinst),
                      ("best", rbest)):
        ms = time_host(lambda: pack(x, rcfg, ractor, policy=policy,
                                    key=SEED + 7, n_samples=16), reps=5)
        rows = x.dims.shape[0] * (16 if policy == "best" else 1)
        log(f"phase 17 pack({policy}) 2d-rolling: {ms:.3f} ms for {rows} "
            f"rollouts x {rcfg.num_blocks} steps = "
            f"{rows * rcfg.num_blocks / ms * 1e3:.0f} env-steps/s")
    rstep_ms = time_host(lambda: rstep(rts), reps=5)
    log(f"phase 17 train step 2d-rolling hidden {HIDDEN} batch {B_MAIN}: "
        f"{rstep_ms:.3f} ms/step = "
        f"{B_MAIN * rcfg.num_blocks / rstep_ms * 1e3:.0f} env-steps/s")

    # ---- phase 18: past a kernel's coverage, the fallbacks on the card
    fallback = check_fallback_routes(dev)

    # ---- phase 19: K1 and K4 on the edge cases of the split placement
    check_edges(dev)

    # ---- phase 20: the whole reward in one launch (K3 redesigned)
    stranded = check_fused_reward(plans, insts, dev)
    log(f"phase 20 fused reward == plain, bit-equal (maxh, under, the five "
        f"terms, the reward bits): pack(first/random) plans of the six "
        f"CONFIGS at B={B_MAIN}, zero heightmaps, a capped plan with "
        f"{stranded} stranded blocks")
    k3 = time_fused_reward(*_plan_tensors(plans["2d-basic", "first"],
                                          insts["2d-basic"], dev), cfg)
    log(f"phase 20 reward_kernel 2d-basic B={B_MAIN}: {k3['ms']:.4f} "
        f"ms/launch (plain {k3['plain_ms']:.4f}, library amax+sum "
        f"{k3['lib_ms']:.4f}), {k3['bytes']} B, {k3['iops']} int32 ops, "
        f"bound {k3['bound']:.5f} ms ({k3['bound_by']}); per call "
        f"{k3['launches']} launch(es), device {k3['busy']:.4f} ms; the "
        f"replaced path (reductions, then the composition) "
        f"{k3['old_ms']:.4f} ms, {k3['old_launches']} launches, device "
        f"{k3['old_busy']:.4f} ms")

    # ---- phase 21: steps_per_call as a CUDA graph over the train step
    for name, c, per_step, k, Bg, h in (
            ("2d-basic", cfg, {"actor_select_step": cfg.num_blocks,
                               "replay_logp_bwd": 1,
                               "heightmap_reductions": 1}, 8, B_MAIN, HIDDEN),
            ("2d-rolling", rcfg, roll_step, 4, B_MAIN, HIDDEN),
            ("multi-container-capped", ccfg, capped_step, 4, 256, HIDDEN),
            ("2d-basic hidden 544", cfg, {"select_step": cfg.num_blocks,
                                          "heightmap_reductions": 1},
             2, 256, 544)):
        check_graph_steps(name, c, dev, per_step, k, Bg, h)
    with tempfile.TemporaryDirectory() as tmp:
        check_trainer(cfg, dev, tmp, spe=3, spc=2, batch=256)
    log(f"phase 21 train() 2d-basic batch 256, steps_per_call 2, 3 steps an "
        f"epoch: epoch lines at steps {jax_loop_steps(2, 3, 2)}, the JAX "
        f"trainer's; a resume from the first checkpoint ends on the same "
        f"params")

    # ---- phase 22: driver config 5 (mixed 2D/3D batches) and the CLI
    p22 = phase_22(dev)
    k2_err, k5f_err, k5b_err = (max(k2_err, p22["k2_err"]),
                                max(k5f_err, p22["k5f_err"]),
                                max(k5b_err, p22["k5b_err"]))
    mixed_train, eval_launches, ds_launches = (
        p22["train"], p22["evaluate"], p22["from_dataset"])

    # ---- phase 23: the benchmark entry point and the world-1 data mesh
    bench, mesh_l = phase_23(dev)

    # ---- phase 24: the bf16 compute dtype on the card
    bf16_kernels, _ = phase_24(dev)

    # ---- phase 25: rollout, render, TensorBoard scalars, TP
    phase_25(dev)

    # ---- phase 26: K2 and K5 at hidden widths above 128
    wide_kernels, _ = phase_26(dev)

    # ---- phase 27: K2 and K5 at every hidden width up to 512
    wx_kernels, _ = phase_27(dev)

    kernels = [
        {"name": "select_step", "route": "cuda",
         "source": "tapnet_torch/csrc/policy_step.cu",
         "replaces": "tapnet_tpu/ops/pallas_policy_step.py:298",
         "launches": (launches["select_step"] + roll_launches["select_step"]
                      + capped_train["select_step"]
                      + eval_launches["select_step"]),
         "max_abs_err": k1["err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "actor_select_step", "route": "cuda",
         "source": "tapnet_torch/csrc/actor_step.cu",
         "replaces": "tapnet_tpu/ops/pallas_actor_step.py:316",
         "launches": (launches["actor_select_step"]
                      + train_launches["actor_select_step"]
                      + roll_launches["actor_select_step"]
                      + roll_train["actor_select_step"]
                      + mixed_train["actor_select_step"]
                      + ds_launches["actor_select_step"]
                      + bench["actor_select_step"]
                      + mesh_l["actor_select_step"]),
         "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "reward_reductions", "route": "cuda",
         "source": "tapnet_torch/csrc/reward.cu",
         "replaces": "tapnet_tpu/ops/pallas_reward.py:39",
         "launches": (train_launches["heightmap_reductions"]
                      + heur_launches["heightmap_reductions"]
                      + roll_train["heightmap_reductions"]
                      + capped_train["heightmap_reductions"]
                      + mixed_train["heightmap_reductions"]
                      + eval_launches["heightmap_reductions"]
                      + ds_launches["heightmap_reductions"]
                      + bench["heightmap_reductions"]
                      + mesh_l["heightmap_reductions"]),
         "max_abs_err": 0.0, "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound"], "bound_by": k3["bound_by"],
         "library_ms": k3["lib_ms"]},
        {"name": "fused_rollout_batch", "route": "cuda",
         "source": "tapnet_torch/csrc/env.cu",
         "replaces": "tapnet_tpu/ops/pallas_env.py:669",
         "launches": (heur_launches["fused_rollout_batch"]
                      + eval_launches["fused_rollout_batch"]
                      + bench["fused_rollout_batch"]),
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None},
        {"name": "replay_logp_fwd", "route": "cuda",
         "source": "tapnet_torch/csrc/replay.cu",
         "replaces": "tapnet_tpu/ops/pallas_replay.py:562",
         "launches": train_launches["replay_logp_fwd"],
         "max_abs_err": k5f_err, "ms": k5f_ms, "plain_ms": k5f_plain,
         "bound_ms": k5f_bound, "bound_by": k5f_by, "library_ms": None},
        {"name": "replay_logp_bwd", "route": "cuda",
         "source": "tapnet_torch/csrc/replay.cu",
         "replaces": "tapnet_tpu/ops/pallas_replay.py:610",
         "launches": (train_launches["replay_logp_bwd"]
                      + capped_train["replay_logp_bwd"]
                      + mixed_train["replay_logp_bwd"]
                      + ds_launches["replay_logp_bwd"]
                      + bench["replay_logp_bwd"]
                      + mesh_l["replay_logp_bwd"]),
         "max_abs_err": k5b_err, "ms": k5b_ms, "plain_ms": k5b_plain,
         "bound_ms": k5b_bound, "bound_by": k5b_by, "library_ms": None},
        {"name": "replay_logp_fwd_steps", "route": "cuda",
         "source": "tapnet_torch/csrc/replay.cu",
         "replaces": "tapnet_tpu/ops/pallas_replay.py:582",
         "launches": roll_train["replay_logp_fwd_steps"],
         "max_abs_err": k5fs_err, "ms": k5fs_ms, "plain_ms": k5fs_plain,
         "bound_ms": k5fs_bound, "bound_by": k5fs_by, "library_ms": None},
        {"name": "replay_logp_bwd_steps", "route": "cuda",
         "source": "tapnet_torch/csrc/replay.cu",
         "replaces": "tapnet_tpu/ops/pallas_replay.py:635",
         "launches": roll_train["replay_logp_bwd_steps"],
         "max_abs_err": k5bs_err, "ms": k5bs_ms, "plain_ms": k5bs_plain,
         "bound_ms": k5bs_bound, "bound_by": k5bs_by, "library_ms": None},
    ]
    for k in kernels:
        k["dtype"] = "float32"
    kernels += bf16_kernels + wide_kernels + wx_kernels
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s"
        " (build included)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
