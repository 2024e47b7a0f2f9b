# The paper's primary contribution: the (n, k, t) CORE product code and
# its failure-handling algorithms (clustering, recoverability, repair
# scheduling).
from repro_torch.core.product_code import CoreCode, CoreCodec
from repro_torch.core.failure_matrix import (
    independent_clusters,
    num_clusters,
    plus_pattern,
    random_failure_matrix,
    step_pattern,
)
from repro_torch.core.recoverability import (
    fast_classify,
    irrecoverability_lower_bound,
    is_recoverable,
    recoverability_upper_bound,
)
from repro_torch.core.scheduling import (
    SCHEDULERS,
    RepairStep,
    Schedule,
    schedule_column_first,
    schedule_rgs,
    schedule_row_first,
)

__all__ = [
    "CoreCode",
    "CoreCodec",
    "independent_clusters",
    "num_clusters",
    "plus_pattern",
    "random_failure_matrix",
    "step_pattern",
    "fast_classify",
    "irrecoverability_lower_bound",
    "is_recoverable",
    "recoverability_upper_bound",
    "SCHEDULERS",
    "RepairStep",
    "Schedule",
    "schedule_column_first",
    "schedule_rgs",
    "schedule_row_first",
]
