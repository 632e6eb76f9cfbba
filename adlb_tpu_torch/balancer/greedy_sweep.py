"""The greedy assignment sweep: a hand-written CUDA kernel and its plain
PyTorch version.

:func:`greedy_assign` is the device solve of the planned balancer
(:class:`adlb_tpu_torch.balancer.solve.AssignmentSolver`). Tasks are taken in
stable descending-priority order (FIFO on ties); each live task takes the
lowest-index open requester that is valid and whose type mask accepts it, and
that requester closes. It returns ``assign[NR]`` int32: the task index each
requester got, or -1.

* On CUDA tensors it runs ``csrc/greedy_sweep.cu`` (the Hopper port of the
  Pallas sweep in the JAX package's ``balancer/pallas_solve.py``), built with
  ``nvcc`` into ``adlb_tpu_torch/_build/`` at first use and loaded with
  ``ctypes``. A few torch ops on the device prepare its inputs: the stable
  priority order and one requester bitmask per type.
* On CPU tensors it runs :func:`greedy_assign_torch`, the plain version,
  which repeats the JAX package's ``_greedy_assign`` scan step by step.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_NEG = -(2**31) + 1  # padding priority, as balancer/solve.py

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "greedy_sweep.cu"
BUILD_DIR = _PKG / "_build"
# the block's shared-memory ceiling on Hopper (227 KB)
_MAX_SMEM = 232448

#: kernel launches so far; chip_smoke.py zeroes it around the main path
launches = 0

_lib = None
_lib_lock = threading.Lock()
#: the compiler's output (-Xptxas -v) of the build this process loaded
build_log = ""


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the greedy-sweep kernel cannot "
                           "be built (CUDA toolkit missing)")
    return nvcc


def build() -> Path:
    """Compile the kernel (once per source revision) and load it; returns
    the shared library's path. Raises with the compiler's output when the
    build fails."""
    global _lib, build_log
    with _lib_lock:
        src = SOURCE.read_bytes()
        out = BUILD_DIR / f"greedy_sweep-{hashlib.sha1(src).hexdigest()[:12]}.so"
        if _lib is not None:
            return out
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
                    f"{build_log}")
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        lib = ctypes.CDLL(str(out))
        lib.adlb_greedy_sweep.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.adlb_greedy_sweep.restype = ctypes.c_int
        lib.adlb_greedy_sweep_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.adlb_greedy_sweep_smem.restype = ctypes.c_longlong
        lib.adlb_cuda_error_string.argtypes = [ctypes.c_int]
        lib.adlb_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return out


def _check(task_prio, task_type, req_mask, req_valid) -> None:
    dev = task_prio.device
    for name, x, dtype, ndim in (("task_prio", task_prio, torch.int32, 1),
                                 ("task_type", task_type, torch.int32, 1),
                                 ("req_mask", req_mask, torch.bool, 2),
                                 ("req_valid", req_valid, torch.bool, 1)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, task_prio on {dev}")
        if x.dtype != dtype or x.dim() != ndim:
            raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, "
                             f"got {x.dim()}-d {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if task_type.shape != task_prio.shape:
        raise ValueError("task_prio and task_type differ in length")
    if req_valid.shape[0] != req_mask.shape[0]:
        raise ValueError("req_mask and req_valid differ in length")


def type_bitmasks(req_mask: torch.Tensor, req_valid: torch.Tensor):
    """[T, ceil(NR/32)] int32 words: bit r of row t is set when requester r
    is valid and accepts type t (the kernel reads them as uint32)."""
    nr, ntypes = req_mask.shape
    nwords = (nr + 31) // 32
    bits = torch.zeros((ntypes, nwords * 32), dtype=torch.int64,
                       device=req_mask.device)
    bits[:, :nr] = (req_mask & req_valid[:, None]).T
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    words = (bits.view(ntypes, nwords, 32) * weights).sum(-1)
    # map [0, 2^32) onto the int32 bit patterns explicitly
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).contiguous()


def prepare_sweep(task_prio, task_type, req_mask, req_valid) -> tuple:
    """The torch pre-pass on the device (the JAX package runs it as XLA
    around its Pallas call): the stable descending-priority order, each
    ordered task's type (-1 when not live) and the per-type requester
    bitmasks. Returns the kernel's inputs (s_type, order, typebits)."""
    ntypes = req_mask.shape[1]
    order = torch.sort(-task_prio, stable=True).indices
    s_prio = task_prio[order]
    s_type = task_type[order]
    live = (s_prio > _NEG) & (s_type >= 0) & (s_type < ntypes)
    s_type = torch.where(live, s_type, -1).contiguous()
    return (s_type, order.to(torch.int32).contiguous(),
            type_bitmasks(req_mask, req_valid))


def launch_sweep(s_type, order, typebits, nr: int):
    """Launch the sweep kernel on the current stream; returns assign[nr]."""
    global launches
    for name, x in (("s_type", s_type), ("order", order),
                    ("typebits", typebits)):
        if (x.device.type != "cuda" or x.dtype != torch.int32
                or not x.is_contiguous() or x.device != s_type.device):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"the CUDA device of s_type")
    if order.shape != s_type.shape or s_type.dim() != 1 \
            or typebits.dim() != 2 or typebits.shape[1] != (nr + 31) // 32:
        raise ValueError("launch_sweep: inconsistent input shapes")
    build()
    ntypes = typebits.shape[0]
    smem = _lib.adlb_greedy_sweep_smem(nr, ntypes)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"greedy sweep needs {smem} bytes of shared memory for "
            f"{nr} requesters x {ntypes} types; the block limit is "
            f"{_MAX_SMEM}")
    dev = s_type.device
    assign = torch.empty((nr,), dtype=torch.int32, device=dev)
    err = _lib.adlb_greedy_sweep(
        s_type.data_ptr(), order.data_ptr(), typebits.data_ptr(),
        assign.data_ptr(), s_type.shape[0], nr, ntypes,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"greedy sweep launch failed: CUDA error {err} "
            f"({_lib.adlb_cuda_error_string(err).decode()})")
    launches += 1
    return assign


def greedy_assign_cuda(task_prio, task_type, req_mask, req_valid):
    """The kernel route (CUDA tensors only). See :func:`greedy_assign`."""
    _check(task_prio, task_type, req_mask, req_valid)
    if task_prio.device.type != "cuda":
        raise ValueError("greedy_assign_cuda takes CUDA tensors")
    nr = req_mask.shape[0]
    if nr == 0:
        return torch.empty((0,), dtype=torch.int32, device=task_prio.device)
    with torch.cuda.device(task_prio.device):
        return launch_sweep(
            *prepare_sweep(task_prio, task_type, req_mask, req_valid), nr)


def greedy_assign_torch(task_prio, task_type, req_mask, req_valid):
    """The plain version: ``_greedy_assign``'s scan, one task per step.

    The steps of tasks that are not live (padding) and the steps after every
    matchable requester has closed cannot match, so they are skipped; the
    result is the same."""
    _check(task_prio, task_type, req_mask, req_valid)
    nr, ntypes = req_mask.shape
    dev = task_prio.device
    assign = torch.full((nr,), -1, dtype=torch.int32, device=dev)
    order = torch.sort(-task_prio, stable=True).indices
    s_prio = task_prio[order]
    s_type = task_type[order]
    live = (s_prio > _NEG) & (s_type >= 0) & (s_type < ntypes)
    compat_by_type = (req_mask & req_valid[:, None]).T.contiguous()  # [T, NR]
    open_req = torch.ones((nr,), dtype=torch.bool, device=dev)
    n_open = int(compat_by_type.any(0).sum())
    types = s_type.tolist()
    for k in torch.nonzero(live).flatten().tolist():
        if n_open == 0:
            break
        compat = open_req & compat_by_type[types[k]]
        r = int(torch.argmax(compat.to(torch.uint8)))  # first open compatible
        if not bool(compat[r]):
            continue
        assign[r] = order[k]
        open_req[r] = False
        n_open -= 1
    return assign


def greedy_assign(task_prio, task_type, req_mask, req_valid):
    """assign[NR] int32 for (task_prio [NT] int32 with _NEG = padding,
    task_type [NT] int32 type index with -1 = padding, req_mask [NR, T]
    bool, req_valid [NR] bool). The kernel for CUDA tensors, the plain
    version for CPU tensors; any other device raises."""
    if task_prio.device.type == "cuda":
        return greedy_assign_cuda(task_prio, task_type, req_mask, req_valid)
    if task_prio.device.type == "cpu":
        return greedy_assign_torch(task_prio, task_type, req_mask, req_valid)
    raise ValueError(f"no greedy sweep for device {task_prio.device}")
