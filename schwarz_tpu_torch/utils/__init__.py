"""Utilities: timing/metrics instruments, CSV writers, validation helpers
(the port's copy of ``schwarz_tpu/utils``, with its own executor selection
in :mod:`~schwarz_tpu_torch.utils.backend`).

Reference C28/C29 (include/utils.hpp, benchmarking/bench_base.hpp:178-273,
source/schwarz_base.cpp:50-70).
"""

from schwarz_tpu_torch.utils.timing import StageTimer, STAGES
from schwarz_tpu_torch.utils.io_csv import (
    write_timings,
    write_comm_data,
    write_iters_and_residuals,
)
from schwarz_tpu_torch.utils.validation import (
    validate_permutation,
    find_duplicates,
)

__all__ = [
    "StageTimer",
    "STAGES",
    "write_timings",
    "write_comm_data",
    "write_iters_and_residuals",
    "validate_permutation",
    "find_duplicates",
]
