"""adlb_tpu_torch — the PyTorch / CUDA port of adlb_tpu.

The same typed, prioritized, globally load-balanced work pool (ADLB's
``Put / Reserve / Get_reserved`` API, run as ranks in one process through
:func:`run_world`), with the planned balancer's device solve running on an
NVIDIA H100: the greedy assignment sweep is a hand-written CUDA kernel
(``csrc/greedy_sweep.cu``) with a plain PyTorch version for CPU tensors.

The port keeps ``adlb_tpu``'s layout and module names, imports ``torch`` and
never ``jax``, and imports nothing from ``adlb_tpu``. Device work runs on
``Config.device`` ("cuda" by default; "cpu" on request).
"""

from adlb_tpu_torch.types import (  # noqa: F401
    ADLB_SUCCESS,
    ADLB_ERROR,
    ADLB_NO_MORE_WORK,
    ADLB_DONE_BY_EXHAUSTION,
    ADLB_NO_CURRENT_WORK,
    ADLB_PUT_REJECTED,
    ADLB_LOWEST_PRIO,
    ADLB_RESERVE_REQUEST_ANY,
    ADLB_HANDLE_SIZE,
    InfoKey,
    WorkHandle,
)
from adlb_tpu_torch.api import (  # noqa: F401
    AdlbContext,
    run_world,
)

__version__ = "0.1.0"
