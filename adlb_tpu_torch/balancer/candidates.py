"""The sharded planner's candidates and cross-shard merge: a hand-written
CUDA kernel and its plain PyTorch version.

From the task table cut into shards — ``tp``, ``tt`` [nshards, Sl, K] int32
(priority, type index) and ``rk`` [nshards, Sl] int32 (the rank behind each
row) — the candidates are, per shard and per type, the top ``D`` live slots
by (prio desc, gid asc), gid = rank * K + ki, prio clamped to
``+-_PRIO_CLIP``, padded with (``_NEG``, ``_I32MAX``): what the JAX
package's ``_shard_candidates`` computes (``adlb_tpu/balancer/distributed.py``,
with its stable three-key sort ``_stable_argsort3``). The merged candidates
are the first ``D`` entries of each type's merge of the shards' lists in
(prio desc, gid asc) order: the first ``D`` columns of the merge in the
JAX package's ``_build_plan_fn``, all the auction reads (it never reads past
index C + m < D).

* :func:`shard_candidates` returns the per-shard lists ``cp, cg`` [nshards, T,
  D] (the host tier merges them on the host, and with the table split across
  cards each card's list is a run of the merge below);
  :func:`merged_candidates` returns ``gp, gg`` [T, D] (the device tier hands
  them to the auction); :func:`merge_runs` merges n runs, a list of [2, T,
  D] (prio, gid) tensors that may lie on several cards, into ``gp, gg`` [T,
  D] (the merge alone), reading each run where it lies.
* On CUDA tensors each is one launch of ``csrc/candidates.cu``, built with
  ``nvcc`` into ``adlb_tpu_torch/_build/`` at first use and loaded with
  ``ctypes``, on the tensors' card (the merge alone: the planning card) and
  its current stream; :class:`Workspace` keeps the outputs, the merge's runs
  and tickets and, where the keys do not fit in shared memory, the kernel's
  scratch buffer, from launch to launch, and :class:`MergeWorkspace` the
  merge alone's outputs and the pointer table of its runs (peer access to
  the runs' cards enabled when it is built).
* On CPU tensors they run the plain version, :func:`_shard_candidates` (all
  shards in one batch of torch ops) and :func:`_merge_candidates` (one
  stable sort of a packed key), whose first ``D`` columns are the merged
  candidates (:func:`merge_runs_torch` for the merge alone).
* :func:`gather_runs` copies runs into one buffer on the planning device:
  the merge's other route, for a placement whose planning card cannot read
  every card's memory (no peer access); ``gather_copies`` counts its copies.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from adlb_tpu_torch.balancer import cuda_build
from adlb_tpu_torch.balancer.solve import (
    _I32MAX, _NEG, _PRIO_CLIP, _stable_argsort2, _stable_argsort3)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "candidates.cu"

#: kernel launches so far, counted on the host at each launch;
#: chip_smoke.py zeroes it around the main path
launches = 0
#: launches of the merge alone (:class:`MergeWorkspace`), counted the same way
merge_launches = 0
#: runs copied into a gathered buffer (:func:`gather_runs`), one per run: 0
#: on the route that reads the runs in place
gather_copies = 0

#: the merge alone's kernel variants (``adlb_candidates_merge_variant``)
MERGE_VARIANTS = ("cluster", "staged", "device_memory")

_lib = None
_lib_path = None
_lib_lock = threading.Lock()
#: the cards whose shared-memory limits this process has set
_ready_on: set = set()
#: the compiler's output (-Xptxas -v) of the build this process loaded
build_log = ""


def _shard_candidates(tp, tt, rk, T: int, D: int):
    """Candidate generation of every shard at once: presort each shard's
    [Sl, K] task block by (type, prio desc, gid) and slice each type's
    top-D window. gid = rank * K + ki — rank-keyed, NOT row-keyed, so the
    candidate identity (and hence the greedy tie-break) survives elastic
    slot reuse.

    tp, tt: [nshards, Sl, K] int32; rk: [nshards, Sl] int32. Returns
    (cand_prio, cand_gid) [nshards, T, D] int32."""
    ns, Sl, K = tp.shape
    Kl = Sl * K
    dev = tp.device
    tp, tt = tp.reshape(ns, Kl), tt.reshape(ns, Kl)
    gids = (rk.reshape(ns, Sl, 1).to(torch.int32) * K
            + torch.arange(K, dtype=torch.int32, device=dev)).reshape(ns, Kl)
    live = (tp > _NEG) & (tt >= 0)
    prio = torch.clamp(tp, -_PRIO_CLIP, _PRIO_CLIP)
    sort_t = torch.where(live, tt, T)
    order = _stable_argsort3(sort_t, -prio, gids)
    s_prio = prio.gather(1, order)
    s_gid = gids.gather(1, order)
    # per-type segment sizes; types past T cannot start a segment below T
    scount = torch.zeros((ns, T + 1), dtype=torch.int32, device=dev)
    scount.scatter_add_(1, sort_t.clamp(max=T).long(),
                        torch.ones_like(sort_t))
    seg_off = torch.cat(
        [torch.zeros((ns, 1), dtype=torch.int32, device=dev),
         torch.cumsum(scount[:, :T], dim=1, dtype=torch.int32)], dim=1)
    idx = seg_off[:, :T, None] + torch.arange(D, dtype=torch.int32,
                                              device=dev)
    ok = idx < seg_off[:, 1:, None]
    idc = torch.clamp(idx, 0, Kl - 1).reshape(ns, T * D).long()
    cp = torch.where(ok, s_prio.gather(1, idc).view(ns, T, D), _NEG)
    cg = torch.where(ok, s_gid.gather(1, idc).view(ns, T, D), _I32MAX)
    return cp, cg


def _merge_candidates(cp, cg):
    """The cross-shard merge: [nshards, T, D] per-shard candidates into
    global (prio desc, gid asc) lists [T, nshards*D] — the order of
    ``_merge_shard_major``'s two stable sorts, from one sort."""
    T = cp.shape[1]
    ap = cp.permute(1, 0, 2).reshape(T, -1)
    ag = cg.permute(1, 0, 2).reshape(T, -1)
    o = _stable_argsort2(-ap, ag)
    return ap.gather(1, o), ag.gather(1, o)


def merge_runs_torch(runs, D: int):
    """The plain version of the merge alone: the first D entries of each
    type's merge of ``runs`` (n [2, T, D] tensors on one device), ``gp, gg``
    [T, D]."""
    _check_runs(runs, D)
    if len({r.device for r in runs}) != 1:
        raise ValueError(f"the plain merge takes runs on one device, got "
                         f"{sorted({str(r.device) for r in runs})}")
    both = torch.stack(list(runs))
    gp, gg = _merge_candidates(both[:, 0], both[:, 1])
    return gp[:, :D].contiguous(), gg[:, :D].contiguous()


def candidates_torch(tp, tt, rk, T: int, D: int, merge: bool):
    """The plain version: the per-shard lists ``cp, cg`` [nshards, T, D], or
    with ``merge`` the first D columns of their merge, ``gp, gg`` [T, D]."""
    _check(tp, tt, rk)
    cp, cg = _shard_candidates(tp, tt, rk, T, D)
    if not merge:
        return cp, cg
    gp, gg = _merge_candidates(cp, cg)
    return gp[:, :D].contiguous(), gg[:, :D].contiguous()


def _raise_on(err: int, what: str, lib=None) -> None:
    if err != 0:
        text = (lib or _lib).adlb_candidates_error_string(err).decode()
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
            "adlb_candidates_init": ([], ctypes.c_int),
            "adlb_candidates_enable_peer": ([ctypes.c_int], ctypes.c_int),
            "adlb_candidates_merge_variant": ([ctypes.c_int] * 2,
                                              ctypes.c_int),
            "adlb_candidates_merge": ([ctypes.c_void_p]
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p] * 3, ctypes.c_int),
            "adlb_candidates_scratch_bytes": ([ctypes.c_int] * 5,
                                              ctypes.c_longlong),
            "adlb_candidates_max_d": ([], ctypes.c_int),
            "adlb_candidates": ([ctypes.c_void_p] * 3
                                + [ctypes.c_longlong] * 3
                                + [ctypes.c_int] * 6
                                + [ctypes.c_void_p] * 8, ctypes.c_int),
            "adlb_candidates_error_string": ([ctypes.c_int],
                                             ctypes.c_char_p),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _raise_on(lib.adlb_candidates_init(), "candidates init", lib)
        _ready_on.add(torch.cuda.current_device())
        _lib, _lib_path = lib, out
        return out


def _ready(device) -> None:
    """Build the kernel, and set its shared-memory limits on ``device`` once
    (:func:`build` sets them on the current card)."""
    build()
    cuda_build.once_per_card(
        device, _ready_on, _lib_lock,
        lambda: _raise_on(_lib.adlb_candidates_init(), "candidates init"))


def _check(tp, tt, rk) -> None:
    """The kernel's input contract (the plain version holds to it too):
    int32 blocks on one device, each row's K slots contiguous, the shards
    evenly strided (views of the solver's resident table pass)."""
    dev = tp.device
    for name, x, ndim in (("tp", tp, 3), ("tt", tt, 3), ("rk", rk, 2)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, tp on {dev}")
        if x.dtype != torch.int32 or x.dim() != ndim:
            raise ValueError(f"{name} must be a {ndim}-d int32 tensor, got "
                             f"{x.dim()}-d {x.dtype}")
    ns, Sl, K = tp.shape
    if tt.shape != tp.shape or rk.shape != (ns, Sl):
        raise ValueError(f"tp {tuple(tp.shape)}, tt {tuple(tt.shape)} and "
                         f"rk {tuple(rk.shape)} must be [ns, Sl, K] and "
                         f"[ns, Sl]")
    for name, x in (("tp", tp), ("tt", tt), ("rk", rk)):
        if (x.dim() == 3 and K > 1 and x.stride(2) != 1) \
                or x.stride(0) != Sl * _row_stride(x):
            raise ValueError(f"{name} must hold each row's slots contiguous "
                             f"and its shards evenly strided, got strides "
                             f"{x.stride()}")


def _check_runs(runs, D: int) -> None:
    """The merge alone's input contract: a non-empty list of int32 runs
    [2, T, D] (prio, gid), all of one device type and one T, each of the
    2T lists contiguous (the prio and gid halves anywhere)."""
    runs = list(runs)
    if not runs:
        raise ValueError("the merge needs at least one run")
    T = runs[0].shape[1] if runs[0].dim() == 3 else -1
    for i, r in enumerate(runs):
        if r.dtype != torch.int32 or r.dim() != 3:
            raise ValueError(f"run {i} must be a 3-d int32 tensor, got "
                             f"{r.dim()}-d {r.dtype}")
        if tuple(r.shape) != (2, T, D):
            raise ValueError(f"run {i} is {tuple(r.shape)}, want [2, T={T}, "
                             f"D={D}]")
        if r.device.type != runs[0].device.type:
            raise ValueError(f"run {i} is on {r.device}, run 0 on "
                             f"{runs[0].device}")
        if r.stride(2) != 1 or (T > 1 and r.stride(1) != D):
            raise ValueError(f"run {i} must hold each type's list "
                             f"contiguous, got strides {r.stride()}")


def _row_stride(x) -> int:
    """Elements from one server row to the next (a size-1 row axis may
    carry any stride: the shard stride is then the row stride)."""
    return x.stride(1) if x.shape[1] > 1 else x.stride(0)


class Workspace:
    """The kernel's card buffers at one (nshards, Sl, K, T, D) shape, reused
    from launch to launch: the per-shard lists ``cands`` [2, nshards, T, D]
    (prio, gid), the merged lists ``gp``, ``gg`` [T, D], the merge's runs
    and per-type tickets and, where the keys do not fit in shared memory,
    the kernel's scratch buffer. Building the kernel comes first."""

    def __init__(self, ns: int, Sl: int, K: int, T: int, D: int,
                 device) -> None:
        _ready(device)
        if D > _lib.adlb_candidates_max_d():
            raise ValueError(f"D={D} is past the kernel's "
                             f"{_lib.adlb_candidates_max_d()}")
        self.shape = (ns, Sl, K, T, D)
        i32 = dict(dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            self.cands = torch.empty((2, ns, T, D), **i32)
            self.gp = torch.empty((T, D), **i32)
            self.gg = torch.empty((T, D), **i32)
            self.runs = torch.empty((T * ns * D,), dtype=torch.int64,
                                    device=device)
            self.tickets = torch.zeros((T,), **i32)  # the kernel keeps them 0
            nbytes = _lib.adlb_candidates_scratch_bytes(ns, Sl, K, T, D)
            self.scratch = (torch.empty((nbytes,), dtype=torch.uint8,
                                        device=device) if nbytes else None)

    def launch(self, tp, tt, rk, merge: bool):
        """One launch on the tensors' card and its current stream; returns
        ``(gp, gg)`` with ``merge``, else the per-shard ``(cp, cg)``."""
        global launches
        _check(tp, tt, rk)
        ns, Sl, K, T, D = self.shape
        if tuple(tp.shape) != (ns, Sl, K) or tp.device != self.gp.device:
            raise ValueError(f"workspace for [{ns}, {Sl}, {K}] on "
                             f"{self.gp.device}, got {tuple(tp.shape)} on "
                             f"{tp.device}")
        cp, cg = self.cands[0], self.cands[1]
        with torch.cuda.device(tp.device):
            _raise_on(_lib.adlb_candidates(
                tp.data_ptr(), tt.data_ptr(), rk.data_ptr(), _row_stride(tp),
                _row_stride(tt), _row_stride(rk), ns, Sl, K, T, D,
                int(merge), cp.data_ptr(), cg.data_ptr(), self.gp.data_ptr(),
                self.gg.data_ptr(), self.runs.data_ptr(),
                self.tickets.data_ptr(),
                self.scratch.data_ptr() if self.scratch is not None else None,
                torch.cuda.current_stream(tp.device).cuda_stream),
                "candidates launch")
        launches += 1
        return (self.gp, self.gg) if merge else (cp, cg)


def enable_peer(device, peer) -> None:
    """Let kernels on ``device`` read ``peer``'s memory (peer access from
    ``device`` to ``peer``); harmless when already enabled, by an earlier
    call or by PyTorch. Raises when the CUDA runtime refuses."""
    device, peer = torch.device(device), torch.device(peer)
    _ready(device)
    with torch.cuda.device(device):
        _raise_on(_lib.adlb_candidates_enable_peer(peer.index),
                  f"peer access from {device} to {peer}")


class MergeWorkspace:
    """The merge alone on the planning card ``device``, over a fixed list of
    ``runs`` (n [2, T, D] int32 tensors on cards, each read where it lies):
    the merged lists ``gp``, ``gg`` [T, D] and the runs' pointer table
    (prio and gid base of each run, uploaded once), reused from launch to
    launch. Building it builds the kernel and enables peer access from
    ``device`` to every other card that holds a run. ``variant``: the
    kernel's variant at (n, D), one of :data:`MERGE_VARIANTS`."""

    def __init__(self, runs, D: int, device) -> None:
        runs = list(runs)
        _check_runs(runs, D)
        device = torch.device(device)
        if device.type != "cuda" or runs[0].device.type != "cuda":
            raise ValueError(f"the merge kernel runs on a card, got runs on "
                             f"{runs[0].device} planned on {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        _ready(device)
        if D > _lib.adlb_candidates_max_d():
            raise ValueError(f"D={D} is past the kernel's "
                             f"{_lib.adlb_candidates_max_d()}")
        for peer in sorted({r.device.index for r in runs} - {device.index}):
            enable_peer(device, torch.device("cuda", peer))
        n, T = len(runs), runs[0].shape[1]
        self.shape, self.device = (n, T, D), device
        self.variant = MERGE_VARIANTS[
            _lib.adlb_candidates_merge_variant(n, D)]
        self.runs = runs  # held: the table points into them
        self.ptrs = _run_ptrs(runs)
        with torch.cuda.device(device):
            self.table = torch.tensor(self.ptrs, dtype=torch.int64,
                                      device=device)
            self.gp = torch.empty((T, D), dtype=torch.int32, device=device)
            self.gg = torch.empty((T, D), dtype=torch.int32, device=device)

    def launch(self, runs=None):
        """One launch on the planning card's current stream; returns ``(gp,
        gg)``. ``runs``, when given, must be the runs the workspace was
        built over (the same memory). The caller orders the launch after
        the writes of every run (its card's stream, on another card) and
        every later write of a run after it."""
        global merge_launches
        n, T, D = self.shape
        if runs is not None and _run_ptrs(runs) != self.ptrs:
            raise ValueError(f"workspace for {n} runs at fixed addresses, "
                             f"got other runs")
        with torch.cuda.device(self.device):
            _raise_on(_lib.adlb_candidates_merge(
                self.table.data_ptr(), n, T, D, self.gp.data_ptr(),
                self.gg.data_ptr(),
                torch.cuda.current_stream(self.device).cuda_stream),
                "merge launch")
        merge_launches += 1
        return self.gp, self.gg


def _run_ptrs(runs) -> list:
    """The prio and gid base address of each [2, T, D] int32 run."""
    return [a for r in runs
            for a in (r.data_ptr(), r.data_ptr() + 4 * r.stride(0))]


def gather_runs(runs, into):
    """Copy each run into ``into`` [n, 2, T, D] on the planning device (a
    peer or same-card ``copy_`` on a card, ordered after the source card's
    stream by PyTorch); returns the gathered runs ``into[i]``. The merge's
    route for a placement without peer access."""
    global gather_copies
    for i, r in enumerate(runs):
        into[i].copy_(r, non_blocking=True)
    gather_copies += len(runs)
    return [into[i] for i in range(len(runs))]


def _run(tp, tt, rk, T: int, D: int, merge: bool, work):
    if tp.device.type == "cuda":
        if work is None:
            work = Workspace(*tp.shape, T, D, tp.device)
        elif work.shape[3:] != (T, D):
            raise ValueError(f"workspace for (T, D) = {work.shape[3:]}, got "
                             f"{(T, D)}")
        return work.launch(tp, tt, rk, merge)
    if tp.device.type == "cpu":
        return candidates_torch(tp, tt, rk, T, D, merge)
    raise ValueError(f"no candidates for device {tp.device}")


def shard_candidates(tp, tt, rk, T: int, D: int,
                     work: Workspace | None = None):
    """Per-shard candidates ``cp, cg`` [nshards, T, D] int32: on CUDA tensors
    one launch into ``work`` (a new :class:`Workspace` when None), on CPU
    tensors the plain version; any other device raises."""
    return _run(tp, tt, rk, T, D, False, work)


def merged_candidates(tp, tt, rk, T: int, D: int,
                      work: Workspace | None = None):
    """Merged candidates ``gp, gg`` [T, D] int32: the first D entries of each
    type's cross-shard merge, as :func:`shard_candidates` dispatches."""
    return _run(tp, tt, rk, T, D, True, work)


def merge_runs(runs, D: int, work: MergeWorkspace | None = None):
    """The merge alone: ``gp, gg`` [T, D] int32, the first D entries of each
    type's merge of ``runs`` (n [2, T, D] (prio, gid) tensors, each list
    sorted by (prio desc, gid asc) and padded, as :func:`shard_candidates`
    gives them). On CUDA tensors one launch into ``work`` (built over these
    runs; a new :class:`MergeWorkspace` on run 0's card when None), reading
    each run where it lies; on CPU tensors :func:`merge_runs_torch`; any
    other device raises."""
    runs = list(runs)
    kind = runs[0].device.type if runs else None
    if kind == "cuda":
        if work is None:
            work = MergeWorkspace(runs, D, runs[0].device)
        elif work.shape[2] != D:
            raise ValueError(f"workspace for D={work.shape[2]}, got D={D}")
        return work.launch(runs)
    if kind == "cpu":
        return merge_runs_torch(runs, D)
    raise ValueError(f"no merge for device {runs[0].device if runs else None}")
