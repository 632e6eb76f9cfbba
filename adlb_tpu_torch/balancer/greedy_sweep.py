"""The greedy assignment solve: a hand-written CUDA kernel and its plain
PyTorch versions.

:func:`greedy_assign` is the device solve of the planned balancer
(:class:`adlb_tpu_torch.balancer.solve.AssignmentSolver`). Tasks are taken in
stable descending-priority order (FIFO on ties); each live task takes the
lowest-index open requester that is valid and whose type mask accepts it, and
that requester closes. It returns ``assign[NR]`` int32: the task index each
requester got, or -1.

* On CUDA tensors it is one ``torch.sort`` and one launch of
  ``csrc/greedy_sweep.cu`` (the Hopper redesign of the Pallas sweep in the
  JAX package's ``balancer/pallas_solve.py``), built with ``nvcc`` into
  ``adlb_tpu_torch/_build/`` at first use and loaded with ``ctypes``. The
  kernel groups the requesters into classes (same valid, non-empty type
  mask) and takes one of three exact routes, named in :data:`ROUTES`:
  ``"partition"`` when every type lies in at most one class (a prefix
  count), ``"classes"`` when T <= 10 and at most 32 classes exist (a chain
  with one warp lane per class), and ``"sweep"`` otherwise (per-type
  requester bitmasks). :func:`requester_classes` states the rule. Every
  launch goes through :meth:`Workspace.run` (the card buffers of one
  shape): :func:`solve_cuda` and the solver's hand-off alike.
* On CPU tensors it runs :func:`greedy_assign_torch`, the plain version,
  which repeats the JAX package's ``_greedy_assign`` scan step by step.
  :func:`greedy_assign_partition_torch` and :func:`greedy_assign_classes_torch`
  are plain versions of the first two routes; only tests and
  ``chip_smoke.py`` call them.

There is no fallback between the kernel and a plain version: a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, NamedTuple

import torch

from adlb_tpu_torch.balancer import cuda_build

_NEG = -(2**31) + 1  # padding priority, as balancer/solve.py

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "greedy_sweep.cu"

#: the kernel's routes; the kernel writes route code i + 1 for ROUTES[i]
ROUTES = ("partition", "classes", "sweep")

#: kernel launches so far, counted on the host at each launch, under
#: ``_count_lock`` (two planner threads may launch at once);
#: chip_smoke.py zeroes it (with :func:`reset_counts`) around the main path
launches = 0
_count_lock = threading.Lock()

_lib = None
_lib_path = None
_lib_lock = threading.Lock()
#: the compiler's output (-Xptxas -v) of the build this process loaded
build_log = ""


def _raise_on(err: int, what: str, lib=None) -> None:
    if err != 0:
        text = (lib or _lib).adlb_cuda_error_string(err).decode()
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
        # PyDLL keeps the interpreter lock across the microsecond-long
        # launch call instead of giving it up and winning it back
        lib = ctypes.PyDLL(str(out))
        sigs = {
            "adlb_greedy_sweep_init": ([], ctypes.c_int),
            "adlb_greedy_sweep": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p], ctypes.c_int),
            "adlb_greedy_sweep_scratch_bytes": ([ctypes.c_int] * 2,
                                                ctypes.c_longlong),
            "adlb_greedy_sweep_route_counts": (
                [ctypes.POINTER(ctypes.c_ulonglong)], ctypes.c_int),
            "adlb_greedy_sweep_reset_route_counts": ([], ctypes.c_int),
            "adlb_copy_async": ([ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p],
                                ctypes.c_int),
            "adlb_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _raise_on(lib.adlb_greedy_sweep_init(), "greedy sweep init", lib)
        _lib, _lib_path = lib, out
        return out


def route_launches() -> dict:
    """Launches per route on the current card, as the kernel tallies them
    itself (each launch adds one under the route it took); all zero before
    the kernel is loaded."""
    if _lib is None:
        return dict.fromkeys(ROUTES, 0)
    counts = (ctypes.c_ulonglong * len(ROUTES))()
    torch.cuda.synchronize()
    _raise_on(_lib.adlb_greedy_sweep_route_counts(counts),
              "reading the route counts")
    return dict(zip(ROUTES, counts))


def reset_counts() -> None:
    """Zero :data:`launches` and the kernel's per-route tally."""
    global launches
    with _count_lock:
        launches = 0
    if _lib is not None:
        torch.cuda.synchronize()
        _raise_on(_lib.adlb_greedy_sweep_reset_route_counts(),
                  "resetting the route counts")


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


def sort_tasks(task_prio, out=None):
    """The stable descending-priority order (FIFO on ties): (sorted
    priorities, original indices int64). Padding (``_NEG``) sorts last. The
    JAX package computes it in XLA outside its Pallas call."""
    return torch.sort(task_prio, descending=True, stable=True, out=out)


def copy_raw(dst: int, src: int, nbytes: int, stream: int) -> None:
    """One asynchronous copy of ``nbytes`` between pinned host memory and
    the card (pointers as ints) on the CUDA stream whose handle is
    ``stream``. Unlike a torch copy it keeps the interpreter lock."""
    _raise_on(_lib.adlb_copy_async(dst, src, nbytes, stream),
              f"copy of {nbytes} bytes")


class Workspace:
    """The card buffers of the solve at one (NT, NR, T) shape, reused from
    solve to solve: the sort's outputs, the kernel's output (``out[:NR]``
    assign, ``out[NR]`` the route code) and, where a route's working set
    does not fit in shared memory (past about 47,000 requesters, or about
    23,000 at T = 64, on an H100), the kernel's scratch buffer. :meth:`run`
    is the one sort and the one launch of every device solve; building the
    kernel comes first."""

    def __init__(self, nt: int, nr: int, ntypes: int, device) -> None:
        build()
        self.shape = (nt, nr, ntypes)
        self.sorted = (torch.empty((nt,), dtype=torch.int32, device=device),
                       torch.empty((nt,), dtype=torch.int64, device=device))
        self.out = torch.empty((nr + 1,), dtype=torch.int32, device=device)
        nbytes = _lib.adlb_greedy_sweep_scratch_bytes(nr, ntypes)
        self.scratch = (torch.empty((nbytes,), dtype=torch.uint8,
                                    device=device) if nbytes else None)
        self._sorted_ptrs = tuple(x.data_ptr() for x in self.sorted)
        self._out_ptrs = (self.out.data_ptr(),
                          self.scratch.data_ptr() if nbytes else None)
        #: launches from this workspace (its solver's share of
        #: :data:`launches`)
        self.launches = 0

    def launch(self, task_type: int, req_mask: int, req_valid: int,
               stream: int) -> None:
        """One launch on the sorted tasks, from the device pointers (ints)
        of the task types [NT] int32, the masks [NR, T] bool and the
        validity [NR] bool, on the CUDA stream whose handle is ``stream``."""
        global launches
        _raise_on(_lib.adlb_greedy_sweep(
            *self._sorted_ptrs, task_type, req_mask, req_valid,
            *self._out_ptrs, *self.shape, stream), "greedy sweep launch")
        with _count_lock:
            launches += 1
            self.launches += 1

    def run(self, task_prio, task_type: int, req_mask: int, req_valid: int,
            stream: int) -> None:
        """Sort ``task_prio`` (a card tensor) and launch: see :meth:`launch`."""
        sort_tasks(task_prio, out=self.sorted)
        self.launch(task_type, req_mask, req_valid, stream)


def solve_cuda(task_prio, task_type, req_mask, req_valid):
    """The kernel route (CUDA tensors only): one sort and one launch.
    Returns (assign [NR] int32, route code [] int32), both on the card;
    ``ROUTES[code - 1]`` names the route."""
    _check(task_prio, task_type, req_mask, req_valid)
    dev = task_prio.device
    if dev.type != "cuda":
        raise ValueError("solve_cuda takes CUDA tensors")
    nr, ntypes = req_mask.shape
    with torch.cuda.device(dev):
        work = Workspace(task_prio.shape[0], nr, ntypes, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        work.run(task_prio, task_type.data_ptr(), req_mask.data_ptr(),
                 req_valid.data_ptr(), stream)
    return work.out[:nr], work.out[nr]


def greedy_assign_cuda(task_prio, task_type, req_mask, req_valid):
    """The kernel route (CUDA tensors only). See :func:`greedy_assign`."""
    if task_prio.device.type != "cuda":
        raise ValueError("greedy_assign_cuda takes CUDA tensors")
    return solve_cuda(task_prio, task_type, req_mask, req_valid)[0]


class RequesterClasses(NamedTuple):
    """Requesters grouped by their valid, non-empty type mask."""

    #: [NR] int64: each requester's class, -1 for none (invalid or empty)
    class_id: torch.Tensor
    #: [C, T] bool: the types each class accepts
    types: torch.Tensor
    #: C int64 tensors: each class's requesters in index order
    members: List[torch.Tensor]
    #: the kernel's route for these requesters, one of ROUTES
    route: str


def requester_classes(req_mask, req_valid) -> RequesterClasses:
    """The plain version of the kernel's class building and route rule:
    ``"partition"`` when T <= 64 and every type lies in at most one class,
    else ``"classes"`` when T <= 10 and at most 32 classes exist, else
    ``"sweep"``."""
    nr, ntypes = req_mask.shape
    rows = req_mask & req_valid[:, None]
    held = rows.any(1)
    class_id = torch.full((nr,), -1, dtype=torch.int64, device=rows.device)
    types, inverse = torch.unique(rows[held].to(torch.uint8), dim=0,
                                  return_inverse=True)
    types = types.bool()
    class_id[held] = inverse
    nclasses = types.shape[0]
    by_class = torch.sort(class_id, stable=True).indices[nr - int(held.sum()):]
    counts = torch.bincount(inverse, minlength=nclasses)
    members = list(torch.split(by_class, counts.tolist()))
    if ntypes <= 64 and bool((types.sum(0) <= 1).all()):
        route = "partition"
    elif ntypes <= 10 and nclasses <= 32:
        route = "classes"
    else:
        route = "sweep"
    return RequesterClasses(class_id, types, members, route)


def _live_order(task_prio, task_type, ntypes):
    """(order int64, ordered types, live mask) of the stable
    descending-priority order."""
    s_prio, order = sort_tasks(task_prio)
    s_type = task_type[order]
    live = (s_prio > _NEG) & (s_type >= 0) & (s_type < ntypes)
    return order, s_type, live


def greedy_assign_partition_torch(task_prio, task_type, req_mask, req_valid):
    """The plain version of route ``"partition"``: the n-th live task whose
    type lies in class c takes c's n-th member. Raises ValueError when the
    classes do not partition the types."""
    _check(task_prio, task_type, req_mask, req_valid)
    nr, ntypes = req_mask.shape
    classes = requester_classes(req_mask, req_valid)
    if not bool((classes.types.sum(0) <= 1).all()):
        raise ValueError("the requester classes do not partition the types")
    assign = torch.full((nr,), -1, dtype=torch.int32, device=req_mask.device)
    if not classes.members:
        return assign
    order, s_type, live = _live_order(task_prio, task_type, ntypes)
    held = torch.nonzero(classes.types)  # (class, type) pairs
    type_class = torch.full((ntypes,), -1, dtype=torch.int64,
                            device=req_mask.device)
    type_class[held[:, 1]] = held[:, 0]
    task_class = torch.where(live, type_class[s_type.clamp(0, ntypes - 1)],
                             -1)
    for c, members in enumerate(classes.members):
        k = torch.nonzero(task_class == c).flatten()[:members.numel()]
        assign[members[:k.numel()]] = order[k].to(torch.int32)
    return assign


def greedy_assign_classes_torch(task_prio, task_type, req_mask, req_valid):
    """The plain version of route ``"classes"``: a live task takes the
    lowest next member over the classes that hold its type, and that class
    advances. Exact for any requesters (the kernel takes it only under the
    rule of :func:`requester_classes`)."""
    _check(task_prio, task_type, req_mask, req_valid)
    nr, ntypes = req_mask.shape
    classes = requester_classes(req_mask, req_valid)
    members = [m.tolist() for m in classes.members]
    holders = [torch.nonzero(col).flatten().tolist()
               for col in classes.types.T]
    nxt = [0] * len(members)
    n_open = sum(len(m) for m in members)
    out = [-1] * nr
    order, s_type, live = _live_order(task_prio, task_type, ntypes)
    orders, types = order.tolist(), s_type.tolist()
    for k in torch.nonzero(live).flatten().tolist():
        if n_open == 0:
            break
        best = None
        for c in holders[types[k]]:
            if nxt[c] < len(members[c]) and (
                    best is None or members[c][nxt[c]] < members[best][nxt[best]]):
                best = c
        if best is None:
            continue
        out[members[best][nxt[best]]] = orders[k]
        nxt[best] += 1
        n_open -= 1
    return torch.tensor(out, dtype=torch.int32, device=req_mask.device)


def greedy_assign_torch(task_prio, task_type, req_mask, req_valid):
    """The plain version: ``_greedy_assign``'s scan, one task per step.

    The steps of tasks that are not live (padding) and the steps after every
    matchable requester has closed cannot match, so they are skipped; the
    result is the same."""
    _check(task_prio, task_type, req_mask, req_valid)
    nr, ntypes = req_mask.shape
    dev = task_prio.device
    assign = torch.full((nr,), -1, dtype=torch.int32, device=dev)
    order, s_type, live = _live_order(task_prio, task_type, ntypes)
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
