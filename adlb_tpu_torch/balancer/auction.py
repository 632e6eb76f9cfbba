"""The sharded planner's auction: a hand-written CUDA kernel and its plain
PyTorch version.

:func:`auction_windows` is the sharded planner's device plan after the
merge. From the requester table resident on the card it builds the
requester windows (the host's ``_reqwin`` and ``_compact_reqwin``) of the
live types, those whose candidate list starts with a real candidate (a
type with none can commit nothing, so its window stays empty and the scan
stops once every live window holds C rows): the slot table over dense
requester ids ``rwc [T, C]`` (``U = T * C`` marks an empty slot), the slots
per type ``lens [T]`` and the open requesters ``open0 [U + 1]``. Then it
computes what the ``lax.while_loop`` of the JAX package's fused planning
program computes (``adlb_tpu/balancer/distributed.py``,
``_build_plan_fn``, ``body`` / ``cond``): from the merged
per-type candidate lists ``gp, gg [T, L]`` (prio desc, gid asc, ``_NEG`` /
``_I32MAX`` padded; the device plan hands over the first ``D = C + m + 1``
columns of the merge,
:func:`adlb_tpu_torch.balancer.candidates.merged_candidates`, and no round
reads past index ``C + m``) it runs at most ``rounds`` auction rounds of
``m`` ranks per type, giving ``assigned [T, C + 1]`` int32: the gid
committed to each slot, or -1 (column C is the program's scatter dump).

* On CUDA tensors it is one launch of ``csrc/auction.cu``: the windows
  built in the kernel's prologue, then the whole loop inside one thread
  block sized to a round's work (the lists staged into shared memory,
  :data:`BARRIERS_PER_ROUND` block barriers a round), built with ``nvcc``
  into ``adlb_tpu_torch/_build/`` at first use and loaded with ``ctypes``.
  :class:`Workspace` keeps the output and, where the working set does not
  fit in shared memory, the kernel's scratch buffer, from launch to
  launch.
* On CPU tensors it runs :func:`windows_torch`, then :func:`auction_torch`,
  a line-for-line transcription of ``body`` and ``cond`` with a Python
  loop, over the tables it built (the rounds' plain version takes the
  tables as given, so the tests also run it over the host's).

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

#: the block barriers each round of ``csrc/auction.cu`` waits at: its chain
#: bound is the rounds run times this times one barrier's latency at the
#: launch's block size (:attr:`Workspace.threads`)
BARRIERS_PER_ROUND = 3

#: kernel launches so far, counted on the host at each launch;
#: chip_smoke.py zeroes it around the main path
launches = 0

_lib = None
_lib_path = None
_lib_lock = threading.Lock()
#: the cards whose shared-memory limits this process has set
_ready_on: set = set()
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
            "adlb_auction_windows": ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                                     + [ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 7
                                     + [ctypes.c_void_p] * 3, ctypes.c_int),
            "adlb_auction_windows_stages_lists": ([ctypes.c_int] * 3,
                                                  ctypes.c_int),
            "adlb_auction_windows_scratch_bytes": ([ctypes.c_int] * 3,
                                                   ctypes.c_longlong),
            "adlb_auction_windows_threads": ([ctypes.c_int] * 2,
                                             ctypes.c_int),
            "adlb_auction_error_string": ([ctypes.c_int], ctypes.c_char_p),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _raise_on(lib.adlb_auction_init(), "auction init", lib)
        _ready_on.add(torch.cuda.current_device())
        _lib, _lib_path = lib, out
        return out


def _ready(device) -> None:
    """Build the kernel, and set its shared-memory limit on ``device`` once
    (:func:`build` sets it on the current card)."""
    build()
    cuda_build.once_per_card(
        device, _ready_on, _lib_lock,
        lambda: _raise_on(_lib.adlb_auction_init(), "auction init"))


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


def delta_ints(n: int, R: int, T: int) -> int:
    """Int32 words of the staged rows of ``n`` server slots: the slots,
    then each of their ``n * R`` rows' T type-flag bytes (one byte a flag,
    as the host's mirror holds them; all 0 on a row that is not valid),
    padded to a word."""
    return n + -(-n * R * T // 4)


def _check_windows(gp, gg, table, order, delta, n_delta: int, C: int,
                   m: int) -> int:
    """Checks :func:`auction_windows`'s inputs; returns R, the rows a
    slot."""
    dev = gp.device
    for name, x, ndim in (("gp", gp, 2), ("gg", gg, 2), ("table", table, 2),
                          ("order", order, 1), ("delta", delta, 1)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, gp on {dev}")
        if x.dtype != torch.int32 or x.dim() != ndim:
            raise ValueError(f"{name} must be a {ndim}-d int32 tensor, got "
                             f"{x.dim()}-d {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    T = gp.shape[0]
    NR, W = table.shape
    S = order.shape[0] - 1
    if gp.shape != gg.shape or gp.shape[1] < 1 or C < 1 or m < 1:
        raise ValueError(f"gp {tuple(gp.shape)} and gg {tuple(gg.shape)} must "
                         f"both be [T, L >= 1], C and m >= 1")
    if S < 1 or NR % S or NR == 0 or 32 * W < T:
        raise ValueError(f"table [{NR}, {W}] must hold R rows for each of the "
                         f"{S} slots of the order and a bit per type (T={T})")
    R = NR // S
    need = delta_ints(n_delta, R, T)
    if n_delta < 0 or delta.shape[0] < need:
        raise ValueError(f"delta holds {delta.shape[0]} ints, {n_delta} "
                         f"slots' rows need {need}")
    return R


class Workspace:
    """The kernel's card buffers at one (T, C, m) shape, reused from launch
    to launch: ``out`` (assigned ``[T, C + 1]``, the rows ``[T, C + 1]``,
    the rounds run, ``scanned`` and ``lost``) and, where the working set
    (about 13 T C + 21 T m bytes and the scan's counts) does not fit in
    shared memory, the kernel's scratch buffer. ``lists_staged``: the lists'
    first C + m + 1 columns (8 T (C + m + 1) bytes) fit beside the working
    set in shared memory, and each launch stages them there. ``threads``:
    the launch's block size. Building the kernel comes first."""

    def __init__(self, T: int, C: int, m: int, device) -> None:
        _ready(device)
        self.shape = (T, C, m)
        self.lists_staged = bool(
            _lib.adlb_auction_windows_stages_lists(T, C, m))
        self.threads = _lib.adlb_auction_windows_threads(T, m)
        n = T * (C + 1)
        with torch.cuda.device(device):
            self.out = torch.empty((2 * n + 3,), dtype=torch.int32,
                                   device=device)
            nbytes = _lib.adlb_auction_windows_scratch_bytes(T, C, m)
            self.scratch = (torch.empty((nbytes,), dtype=torch.uint8,
                                        device=device) if nbytes else None)
        #: assigned [T, C + 1], as a view
        self.assigned = self.out[:n].view(T, C + 1)

    @property
    def rounds_run(self) -> torch.Tensor:
        """The rounds the last launch ran (a one-element view)."""
        T, C, _ = self.shape
        return self.out[2 * T * (C + 1)]

    def launch_windows(self, gp, gg, table, order, delta, n_delta: int,
                       rounds: int) -> torch.Tensor:
        """One launch on the tensors' card and its current stream; returns
        :attr:`out` (:func:`auction_windows`)."""
        global launches
        T, C, m = self.shape
        R = _check_windows(gp, gg, table, order, delta, n_delta, C, m)
        if gp.shape[0] != T or gp.device != self.out.device:
            raise ValueError(f"workspace for T={T} on {self.out.device}, got "
                             f"gp {tuple(gp.shape)} on {gp.device}")
        with torch.cuda.device(gp.device):
            _raise_on(_lib.adlb_auction_windows(
                gp.data_ptr(), gg.data_ptr(), gp.shape[1], table.data_ptr(),
                order.data_ptr(), delta.data_ptr(), n_delta, R,
                table.shape[1], T, C, m, rounds, self.out.data_ptr(),
                self.scratch.data_ptr() if self.scratch is not None else None,
                torch.cuda.current_stream(gp.device).cuda_stream),
                "auction launch")
        launches += 1
        return self.out


def windows_torch(table, order, delta, n_delta: int, T: int, C: int, live):
    """The windows prologue's plain version: packs the first ``n_delta``
    slots' rows of ``delta`` (:func:`delta_ints`) into ``table`` (in place,
    as the kernel does), then scans the rows of the slots in use in rank
    order (``order``) into each live type's window (``live`` [T] bool) of
    the first C accepting rows, until every one holds C; the other windows
    stay empty. Returns (rwc [T, C] int32 of dense ids in scan order, ``U
    = T * C`` past a window; lens [T] int32; open0 [U + 1] bool; rows [T, C
    + 1] int32: the physical row of each slot, -1 past the window, its
    length in column C; scanned: the rows the windows took in, up to the
    row that filled the last live window, 0 when no type is live, or every
    row in use when a live window stays short)."""
    dev = table.device
    NR, W = table.shape
    R = NR // (order.shape[0] - 1)
    U = T * C
    if n_delta:
        n = n_delta * R
        raw = delta[n_delta:delta_ints(n_delta, R, T)].view(torch.uint8)
        vm = raw[:n * T].view(n, T).bool().to(torch.int64)
        bits = torch.zeros((n, 32 * W), dtype=torch.int64, device=dev)
        bits[:, :T] = vm << (torch.arange(T, device=dev) % 32)
        words = bits.view(n, W, 32).sum(dim=2)
        slots = delta[:n_delta].long()
        rows = (slots[:, None] * R + torch.arange(R, device=dev)).reshape(-1)
        table[rows] = (words - (words >= 2**31) * 2**32).to(torch.int32)
    seq = order[1:1 + int(order[0])].long()
    rows_all = (seq[:, None] * R
                + torch.arange(R, dtype=torch.int64, device=dev)).reshape(-1)
    widx = torch.arange(T, device=dev) // 32
    shift = (torch.arange(T, device=dev) % 32).to(torch.int32)
    lens = torch.zeros((T,), dtype=torch.int64, device=dev)
    rwc = torch.full((T, C), U, dtype=torch.int32, device=dev)
    rows = torch.full((T, C + 1), -1, dtype=torch.int32, device=dev)
    fill = torch.zeros((T,), dtype=torch.int64, device=dev)
    nuniq = 0
    CHUNK = 16384
    live = live.to(device=dev, dtype=torch.bool)
    for a in range(0, rows_all.shape[0], CHUNK):
        if bool(((lens >= C) | ~live).all()):
            break
        rr = rows_all[a:a + CHUNK]
        bits = ((table[rr][:, widx] >> shift) & 1).bool() & live  # [n, T]
        rank = lens[None, :] + torch.cumsum(bits, 0) - 1
        take = bits & (rank < C)
        taken = take.any(dim=1)
        ids = nuniq + torch.cumsum(taken, 0) - 1
        i, t = take.nonzero(as_tuple=True)
        k = rank[i, t]
        rwc[t, k] = ids[i].to(torch.int32)
        rows[t, k] = rr[i].to(torch.int32)
        last = k == C - 1
        fill[t[last]] = a + i[last] + 1
        nuniq += int(taken.sum())
        lens = torch.clamp(lens + bits.sum(dim=0), max=C)
    rows[:, C] = lens.to(torch.int32)
    # fill is set for the live windows alone
    full = bool(((lens >= C) | ~live).all())
    scanned = int(fill.max()) if full else rows_all.shape[0]
    open0 = torch.arange(U + 1, device=dev) < nuniq
    return rwc, lens.to(torch.int32), open0, rows, scanned


def auction_torch(gp, gg, rwc, lens, open0, rounds: int, m: int):
    """The plain version: ``body`` and ``cond`` of the JAX program, one
    torch op for each of its ops, the ``while_loop`` as a Python loop. JAX
    drops out-of-range scatter indices (``mode="drop"``); here they go to a
    dump column that is cut off, as the program does for its other
    scatters."""
    return _rounds_torch(gp, gg, rwc, lens, open0, rounds, m)[0]


def _rounds_torch(gp, gg, rwc, lens, open0, rounds: int, m: int):
    """:func:`auction_torch`'s rounds: (assigned, the rounds run, the
    entries that lost their requester to another type's candidate, summed
    over the rounds)."""
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
    rnd, last, lost = 0, 1, 0
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
        lost += int(lose.sum())
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
    return assigned, rnd, lost


def auction_windows(gp, gg, table, order, delta, n_delta: int, rounds: int,
                    m: int, C: int, work: Workspace | None = None):
    """The sharded planner's device plan after the merge: the live types'
    windows built from the resident requester table (``table`` [S * R, W]
    int32, updated in place by the first ``n_delta`` slots' rows of
    ``delta``; ``order`` [1 + S] int32: the slots in use, then the slots in
    rank order), then the rounds over them. Returns one int32 tensor of
    ``2 * T * (C + 1) + 3``: assigned [T, C + 1] (the module docstring),
    the rows [T, C + 1] (:func:`windows_torch`), the rounds run,
    ``scanned`` and ``lost`` (:func:`_rounds_torch`). On CUDA
    tensors one launch of the kernel into ``work`` (a :class:`Workspace` at
    ``(T, C, m)``; a new one when None), on CPU tensors the plain versions;
    any other device raises."""
    if gp.device.type == "cuda":
        if work is None:
            work = Workspace(gp.shape[0], C, m, gp.device)
        elif work.shape[1:] != (C, m):
            raise ValueError(f"workspace for C, m = {work.shape[1:]}, got "
                             f"{(C, m)}")
        return work.launch_windows(gp, gg, table, order, delta, n_delta,
                                   rounds)
    if gp.device.type == "cpu":
        _check_windows(gp, gg, table, order, delta, n_delta, C, m)
        T = gp.shape[0]
        rwc, lens, open0, rows, scanned = windows_torch(
            table, order, delta, n_delta, T, C, gp[:, 0] > _NEG)
        assigned, rnd, lost = _rounds_torch(gp, gg, rwc, lens, open0, rounds,
                                            m)
        return torch.cat((assigned.reshape(-1), rows.reshape(-1),
                          torch.tensor([rnd, scanned, lost],
                                       dtype=torch.int32)))
    raise ValueError(f"no auction for device {gp.device}")
