"""A staged upload in one call into ``csrc/staged_copy.cu``: an
asynchronous host-to-device copy from a pinned buffer and the event that
marks it landed, without torch's per-copy bookkeeping. The sharded
planner's staging buffers (``distributed._Staged``) ship the changed task
and requester rows of each ingest through it. Built with ``nvcc`` into
``adlb_tpu_torch/_build/`` at first use and loaded with ``ctypes``; there
is no CPU version (a CPU buffer copies with ``Tensor.copy_``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

from adlb_tpu_torch.balancer import cuda_build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "staged_copy.cu"

_lib = None
_lib_lock = threading.Lock()


def build():
    """Compile the source (once per revision) and load it; returns the
    library. Raises with the compiler's output when the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.PyDLL(str(cuda_build.build_all([SOURCE])[0]))
            lib.adlb_staged_copy.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                + [ctypes.c_void_p] * 2)
            lib.adlb_staged_copy.restype = ctypes.c_int
            lib.adlb_staged_copy_error_string.argtypes = [ctypes.c_int]
            lib.adlb_staged_copy_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def upload(dst, src, nbytes: int, event) -> None:
    """Copies the first ``nbytes`` of the pinned host tensor ``src`` into
    the card tensor ``dst`` on the current stream of ``dst``'s card (current
    when called), then records ``event`` (a created ``torch.cuda.Event``)
    there."""
    import torch

    lib = build()
    err = lib.adlb_staged_copy(
        dst.data_ptr(), src.data_ptr(), nbytes,
        torch.cuda.current_stream(dst.device).cuda_stream, event.cuda_event)
    if err != 0:
        text = lib.adlb_staged_copy_error_string(err).decode()
        raise RuntimeError(f"staged upload failed: CUDA error {err} ({text})")
