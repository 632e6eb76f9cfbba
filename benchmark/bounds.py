"""The yardstick of the kernels: the card's peaks and each kernel's bytes,
worked out from the shapes of its call.

Each input is counted read once and each output written once, whatever the
kernel reads again; the kernels' operations (a few integer compares per
byte) take far less time than their bytes, so the bytes bound them. The
formulas follow ``PERF.md``'s kernel table and are kept here so that a
change to a kernel cannot move them.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, NVIDIA's data sheet: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12


def k1_bytes(nt: int, nr: int, ntypes: int) -> int:
    """The greedy solve (K1, ``greedy_sweep_kernel``) at NT tasks x NR
    requesters x T types: task priorities and types read (int32 each), the
    requester mask [NR, T] and validity [NR] read (one byte each), the
    assignment [NR] and the route word written (int32)."""
    return 4 * nt * 2 + nr * ntypes + nr + 4 * (nr + 1)


def k4_bytes(rows: int, K: int, T: int, D: int) -> int:
    """Every shard's candidates and their merge (K4, ``candidates_kernel``)
    over the resident table of ``rows`` server rows: each row's K
    priorities, K types and its rank read (int32), the merged [2, T, D]
    (priority, gid) lists written (int32)."""
    return 4 * rows * (2 * K + 1) + 4 * 2 * T * D


def k5_bytes(commits, lens, m: int, D: int, C: int) -> int:
    """The auction (K5, ``auction_kernel``) of one plan, from what that plan
    needs: ``commits[t]`` tasks of type t committed and ``lens[t]`` slots in
    its requester table. A type's rounds read its candidate list up to m + 1
    entries past its last head (priority and gid, int32, at most D) and its
    slot table up to m open slots past its commits (requester id int32 and
    open flag, at most its length); the lengths are read and the [T, C + 1]
    assignment and the round count written (int32)."""
    T = len(commits)
    read = 0
    for n, ln in zip(commits, lens):
        read += 8 * min(n + m + 1, D) + 5 * min(n + m, ln)
    return read + 4 * T + 4 * (T * (C + 1) + 1)


def k5_pack_bytes(staged_rows: int, R: int, T: int) -> int:
    """The first step of the auction kernel's prologue (``auction_kernel``
    before its rounds, ``csrc/auction.cu``): the rows the last ingest
    staged, of n = staged_rows / R server slots, packed into the resident
    requester table. It reads the staged buffer (``delta``: the n slots,
    int32, then each row's T type-flag bytes, padded to a word; what
    ``planner:ingest.reqrows`` counts as ``bytes``) and writes W = ceil(T /
    32) mask words (int32) a staged row into the table."""
    W = -(-T // 32)
    n = -(-staged_rows // R)
    return 4 * (n + -(-staged_rows * T // 4)) + 4 * W * staged_rows


def k5_window_bytes(scanned: int, R: int, T: int, C: int) -> int:
    """The rest of the auction kernel's prologue (``build_windows``): the
    requester table scanned in rank order into the per-type windows of C.
    It reads the order's count and the slots of the ``scanned`` rows (int32,
    one a slot of R rows) and each scanned row's W = ceil(T / 32) mask words
    (``scanned``: the rows up to the one that filled the last window, as the
    readback reports it; the block's overrun of at most one span past it is
    not the work's), and writes the rows part [T, C + 1] of the output (each
    slot's physical row, column C the window's length) and the ``scanned``
    word (int32). The windows' dense ids, lengths and open flags stay in
    shared memory at the benchmark's sizes: no device-memory bytes."""
    W = -(-T // 32)
    return 4 * (1 + -(-scanned // R)) + 4 * W * scanned + 4 * T * (C + 1) + 4


def roofline_pct(nbytes: float, seconds: float):
    """Share of the bytes bound: the least time for ``nbytes`` over the
    measured device seconds, in %. None where nothing ran."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / seconds
