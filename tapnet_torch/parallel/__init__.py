"""Data parallelism over torch.distributed, the port of
`tapnet_tpu/parallel/` (mesh, distributed runtime, scaling harness).

Env batches are sharded over a data axis of ranks, one process per device,
feeding a sharded learner: each rank samples and rolls out its rows of the
global batch, and one all-reduce of the flat gradient buffer a step keeps
the ranks' parameters identical (`train/reinforce.py`). Tensor parallelism
(`tapnet_tpu/parallel/tp.py`) is not ported yet.
"""

from tapnet_torch.parallel.mesh import (DataMesh, cpu_mesh,  # noqa: F401
                                        data_mesh, replicate,
                                        shard_leading_axis)
from tapnet_torch.parallel.distributed import (  # noqa: F401
    broadcast_from_main, initialize_distributed)
