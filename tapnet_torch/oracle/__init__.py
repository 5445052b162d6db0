"""CPU oracle: the executable specification of SPEC.md, the port's copy of
`tapnet_tpu/oracle/`.

Per-instance numpy loops — deliberately the reference's own mechanism
("per-instance Python step loop", BASELINE.json) — serving two roles:
1. the bit-exactness parity target for the batched env (`env/core.py`), and
2. the measured baseline that `benchmarks.py` reports speedups against.
"""

from tapnet_torch.oracle.generator import generate_instance  # noqa: F401
from tapnet_torch.oracle.env import OracleEnv  # noqa: F401
from tapnet_torch.oracle.rollout import oracle_rollout  # noqa: F401
