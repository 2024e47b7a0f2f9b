"""The bytes a full-object PUT writes, frozen from the gateway's rule.

The gateway makes each full overwrite's payload itself, from the
object id and the request's simulated arrival time: a NumPy
``default_rng`` seeded with (oid * 1_000_003 + int(time * 1e6)) mod 2^63,
drawing k x q uint8 values in [0, 256). The benchmark only chooses the
object and the time, so the reference works the written bytes out again
from those two numbers by this copy of the rule.
"""

from __future__ import annotations

import numpy as np


def put_payload(object_id: int, sim_time: float, k: int, block_bytes: int) -> np.ndarray:
    rng = np.random.default_rng((object_id * 1_000_003 + int(sim_time * 1e6)) % (2**63))
    return rng.integers(0, 256, (k, block_bytes), dtype=np.uint8)
