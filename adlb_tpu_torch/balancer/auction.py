"""The sharded planner's auction rounds: a hand-written CUDA kernel and its
plain PyTorch version.

:func:`auction` computes what the ``lax.while_loop`` of the JAX package's
fused planning program computes (``adlb_tpu/balancer/distributed.py``,
``_build_plan_fn``, ``body`` / ``cond``): from the merged per-type candidate
lists ``gp, gg [T, L]`` (prio desc, gid asc, ``_NEG`` / ``_I32MAX`` padded),
the slot table over host-compacted requester ids ``rwc [T, C]`` (``U = T *
C`` marks an empty slot), the slots per type ``lens [T]`` and the open
requesters ``open0 [U + 1]`` bool, it runs at most ``rounds`` auction rounds
of ``m`` ranks per type and returns ``assigned [T, C + 1]`` int32: the gid
committed to each slot, or -1 (column C is the program's scatter dump).

* On CUDA tensors it is one launch of ``csrc/auction.cu``, the whole loop
  inside one thread block, built with ``nvcc`` into ``adlb_tpu_torch/_build/``
  at first use and loaded with ``ctypes``. :class:`Workspace` keeps the
  output and, where the working set does not fit in shared memory, the
  kernel's scratch buffer, from launch to launch.
* On CPU tensors it runs :func:`auction_torch`, a line-for-line transcription
  of ``body`` and ``cond`` with a Python loop.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from adlb_tpu_torch.balancer import cuda_build

_NEG = -(2**31) + 1  # padding priority, as balancer/solve.py
_I32MAX = 2**31 - 1

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "auction.cu"

#: kernel launches so far, counted on the host at each launch;
#: chip_smoke.py zeroes it around the main path
launches = 0

_lib = None
_lib_path = None
_lib_lock = threading.Lock()
#: the compiler's output (-Xptxas -v) of the build this process loaded
build_log = ""


def _raise_on(err: int, what: str, lib=None) -> None:
    if err != 0:
        text = (lib or _lib).adlb_auction_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({text})")


def build() -> Path:
    """Compile the kernel (once per source revision), load it and set its
    shared-memory limit; returns the shared library's path. Raises with the
    compiler's output when the build fails."""
    global _lib, _lib_path, build_log
    if _lib is not None:
        return _lib_path
    with _lib_lock:
        if _lib is not None:
            return _lib_path
        out = cuda_build.build_all([SOURCE])[0]
        build_log = cuda_build.logs.get(out, "")
        lib = ctypes.PyDLL(str(out))  # keeps the interpreter lock
        sigs = {
            "adlb_auction_init": ([], ctypes.c_int),
            "adlb_auction_scratch_bytes": ([ctypes.c_int] * 3,
                                           ctypes.c_longlong),
            "adlb_auction": ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p] * 3, ctypes.c_int),
            "adlb_auction_error_string": ([ctypes.c_int], ctypes.c_char_p),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _raise_on(lib.adlb_auction_init(), "auction init", lib)
        _lib, _lib_path = lib, out
        return out


def _check(gp, gg, rwc, lens, open0, m: int) -> None:
    dev = gp.device
    for name, x, dtype, ndim in (("gp", gp, torch.int32, 2),
                                 ("gg", gg, torch.int32, 2),
                                 ("rwc", rwc, torch.int32, 2),
                                 ("lens", lens, torch.int32, 1),
                                 ("open0", open0, torch.bool, 1)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, gp on {dev}")
        if x.dtype != dtype or x.dim() != ndim:
            raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, "
                             f"got {x.dim()}-d {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    T, C = rwc.shape
    if gp.shape != gg.shape or gp.shape[0] != T or gp.shape[1] < 1:
        raise ValueError(f"gp {tuple(gp.shape)} and gg {tuple(gg.shape)} must "
                         f"both be [T={T}, L >= 1]")
    if lens.shape != (T,) or open0.shape != (T * C + 1,) or C < 1:
        raise ValueError("lens must be [T] and open0 [T * C + 1], C >= 1")
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")


class Workspace:
    """The kernel's card buffers at one (T, C, m) shape, reused from launch
    to launch: ``out`` (assigned ``[T, C + 1]``, then the rounds run) and,
    where the working set (about 13 T C + 21 T m bytes) does not fit in
    shared memory, the kernel's scratch buffer. Building the kernel comes
    first."""

    def __init__(self, T: int, C: int, m: int, device) -> None:
        build()
        self.shape = (T, C, m)
        self.out = torch.empty((T * (C + 1) + 1,), dtype=torch.int32,
                               device=device)
        nbytes = _lib.adlb_auction_scratch_bytes(T, C, m)
        self.scratch = (torch.empty((nbytes,), dtype=torch.uint8,
                                    device=device) if nbytes else None)
        #: assigned [T, C + 1] and the rounds the last launch ran, as views
        self.assigned = self.out[:T * (C + 1)].view(T, C + 1)
        self.rounds_run = self.out[T * (C + 1)]

    def launch(self, gp, gg, rwc, lens, open0, rounds: int) -> torch.Tensor:
        """One launch on the current stream; returns :attr:`assigned`."""
        global launches
        T, C, m = self.shape
        _check(gp, gg, rwc, lens, open0, m)
        if rwc.shape != (T, C) or gp.device != self.out.device:
            raise ValueError(f"workspace for T={T}, C={C} on "
                             f"{self.out.device}, got rwc "
                             f"{tuple(rwc.shape)} on {gp.device}")
        _raise_on(_lib.adlb_auction(
            gp.data_ptr(), gg.data_ptr(), gp.shape[1], rwc.data_ptr(),
            lens.data_ptr(), open0.data_ptr(), T, C, m, rounds,
            self.out.data_ptr(),
            self.scratch.data_ptr() if self.scratch is not None else None,
            torch.cuda.current_stream(gp.device).cuda_stream),
            "auction launch")
        launches += 1
        return self.assigned


def auction_torch(gp, gg, rwc, lens, open0, rounds: int, m: int):
    """The plain version: ``body`` and ``cond`` of the JAX program, one
    torch op for each of its ops, the ``while_loop`` as a Python loop. JAX
    drops out-of-range scatter indices (``mode="drop"``); here they go to a
    dump column that is cut off, as the program does for its other
    scatters."""
    _check(gp, gg, rwc, lens, open0, m)
    dev = gp.device
    T, L = gp.shape
    C = rwc.shape[1]
    U = T * C
    i32 = torch.int32
    nlive = (gp > _NEG).sum(dim=1).to(i32)
    slot_valid = torch.arange(C, dtype=i32, device=dev)[None, :] < lens[:, None]
    trange = torch.arange(T, dtype=torch.int64, device=dev)
    cols_c = torch.arange(C, dtype=i32, device=dev).expand(T, C)
    rows_m = trange[:, None].expand(T, m)
    arange_m1 = torch.arange(m + 1, dtype=i32, device=dev)
    rwc64 = rwc.long()

    head = torch.zeros((T,), dtype=i32, device=dev)
    open_ = open0.clone()
    assigned = torch.full((T, C + 1), -1, dtype=i32, device=dev)
    rnd, last = 0, 1
    while rnd < rounds and last > 0:
        # next m+1 untaken candidates per type (head slice)
        cidx = head[:, None] + arange_m1[None, :]
        okc = cidx < nlive[:, None]
        cl = torch.clamp(cidx, max=L - 1).long()
        mp_full = torch.where(okc, gp[trange[:, None], cl], _NEG)
        mg_full = torch.where(okc, gg[trange[:, None], cl], _I32MAX)
        mp, mg = mp_full[:, :m], mg_full[:, :m]
        trunc_p, trunc_g = mp_full[:, m], mg_full[:, m]
        # first m open slots per type: scatter-min each open slot's column
        # at its open-rank; ranks >= m and closed slots land in column m
        slot_open = slot_valid & open_[rwc64]
        sr = torch.cumsum(slot_open, dim=1, dtype=i32)
        nopen = sr[:, -1]
        jrank = torch.where(slot_open, sr - 1, m).clamp(max=m).long()
        pair_slot = torch.full((T, m + 1), C, dtype=i32, device=dev).scatter_reduce(
            1, jrank, cols_c, "amin")[:, :m]
        valid = (mp > _NEG) & (pair_slot < C)
        psc = torch.clamp(pair_slot, 0, C - 1).long()
        rid = torch.where(valid, rwc64[trange[:, None], psc], U)
        # cross-type conflicts: winner per requester by (prio, -gid)
        flat = rid.reshape(-1)
        bp = torch.full((U + 1,), _NEG, dtype=i32, device=dev).scatter_reduce(
            0, flat, torch.where(valid, mp, _NEG).reshape(-1), "amax")
        is_pmax = valid & (mp == bp[rid])
        bg = torch.full((U + 1,), _I32MAX, dtype=i32, device=dev).scatter_reduce(
            0, flat, torch.where(is_pmax, mg, _I32MAX).reshape(-1), "amin")
        win = is_pmax & (mg == bg[rid])
        lose = valid & ~win
        # global commit threshold: best key among losers and each type's
        # truncation sentinel (only while it has an open slot)
        sent = (nopen > 0) & (trunc_p > _NEG)
        neg = torch.tensor(_NEG, dtype=i32, device=dev)
        imax = torch.tensor(_I32MAX, dtype=i32, device=dev)
        lp = torch.maximum(torch.where(lose, mp, neg).max(),
                           torch.where(sent, trunc_p, neg).max())
        lg = torch.minimum(
            torch.where(lose & (mp == lp), mg, imax).min(),
            torch.where(sent & (trunc_p == lp), trunc_g, imax).min())
        keygt = (mp > lp) | ((mp == lp) & (mg < lg))
        lose_i = lose.to(i32)
        lose_before = (torch.cumsum(lose_i, dim=1, dtype=i32) - lose_i) > 0
        commit = win & keygt & ~lose_before
        col = torch.where(commit, psc, C)
        assigned = assigned.reshape(-1).scatter_reduce(
            0, (rows_m * (C + 1) + col).reshape(-1),
            torch.where(commit, mg, -1).reshape(-1), "amax").view(T, C + 1)
        open_[torch.where(commit, rid, U).reshape(-1)] = False
        head = head + commit.sum(dim=1, dtype=i32)
        rnd += 1
        last = int(commit.sum())
    return assigned


def auction(gp, gg, rwc, lens, open0, rounds: int, m: int,
            work: Workspace | None = None):
    """assigned [T, C + 1] int32 (see the module docstring). On CUDA
    tensors one launch of the kernel into ``work`` (a :class:`Workspace` at
    ``(T, C, m)``; a new one when None), on CPU tensors the plain version;
    any other device raises."""
    if gp.device.type == "cuda":
        if work is None:
            with torch.cuda.device(gp.device):
                work = Workspace(rwc.shape[0], rwc.shape[1], m, gp.device)
        elif work.shape[2] != m:
            raise ValueError(f"workspace for m={work.shape[2]}, got m={m}")
        return work.launch(gp, gg, rwc, lens, open0, rounds)
    if gp.device.type == "cpu":
        return auction_torch(gp, gg, rwc, lens, open0, rounds, m)
    raise ValueError(f"no auction for device {gp.device}")
