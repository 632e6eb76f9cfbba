"""The kernels' bytes from their shapes, on hand-computed cases."""

import pytest

from benchmark import bounds


def test_k1_bytes_hand_case():
    # 65536 tasks x 8192 requesters x 1 type: prio + type 4 B each per
    # task, mask 1 B per (requester, type), valid 1 B, assign and route
    # word 4 B each
    nt, nr, t = 65536, 8192, 1
    want = 65536 * 8 + 8192 * 1 + 8192 + 4 * 8193
    assert bounds.k1_bytes(nt, nr, t) == want == 573_444


def test_k1_bytes_types_add_mask_bytes():
    assert bounds.k1_bytes(10, 4, 5) - bounds.k1_bytes(10, 4, 1) == 16


def test_k4_bytes_hand_case():
    # the 10k row: 10,000 rows x (16 prios + 16 types + rank) int32, then
    # [2, 8, 545] int32 written
    assert bounds.k4_bytes(10000, 16, 8, 545) == 4 * 10000 * 33 + 4 * 2 * 8 * 545
    assert bounds.k4_bytes(10000, 16, 8, 545) == 1_354_880


def test_k5_bytes_hand_case():
    # two types: 3 and 0 commits, m = 2, D = 10, C = 4, tables of 4 and 1
    # slots: list reads 8 * min(3+3, 10) + 8 * min(0+3, 10) = 48 + 24,
    # slot reads 5 * min(3+2, 4) + 5 * min(0+2, 1) = 20 + 5, lengths 8,
    # assignment 4 * (2 * 5 + 1) = 44
    assert bounds.k5_bytes([3, 0], [4, 1], 2, 10, 4) == 48 + 24 + 20 + 5 + 8 + 44


def test_k5_list_reads_stop_at_depth():
    a = bounds.k5_bytes([600], [512], 32, 545, 512)
    assert a == 8 * 545 + 5 * 512 + 4 + 4 * (513 + 1)


def test_roofline_share():
    # 3.35e6 bytes take 1 us at 3.35 TB/s: in 2 us that is 50%
    assert bounds.roofline_pct(3.35e6, 2e-6) == pytest.approx(50.0)
    assert bounds.roofline_pct(1.0, 0.0) is None
