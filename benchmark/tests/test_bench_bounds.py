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


def test_k5_pack_bytes_hand_case():
    # 3 server slots of R = 100 rows staged at T = 4: the slots 4 B each,
    # the 300 rows' 4 flag bytes each (1,200, a whole number of words),
    # then one mask word written a row
    assert bounds.k5_pack_bytes(300, 100, 4) == 12 + 1200 + 4 * 300 == 2412
    # T = 3 pads the flags to a word; T = 40 writes two mask words a row
    assert bounds.k5_pack_bytes(5, 5, 3) == 4 + 4 * 4 + 4 * 5
    assert bounds.k5_pack_bytes(100, 100, 40) == 4 + 4000 + 8 * 100
    assert bounds.k5_pack_bytes(0, 100, 4) == 0


def test_k5_window_bytes_hand_case():
    # the cell's shape: 3,812 rows scanned of R = 100 a slot at T = 4,
    # C = 512: the order's count and 39 slots, one mask word a row, the
    # rows part [4, 513] and the scanned word written
    want = 4 * (1 + 39) + 4 * 3812 + 4 * 4 * 513 + 4
    assert bounds.k5_window_bytes(3812, 100, 4, 512) == want == 23_620
    # a row more reaches a 40th slot; T = 33 reads two words a row
    assert bounds.k5_window_bytes(3901, 100, 4, 512) - want == 4 + 4 * 89
    assert (bounds.k5_window_bytes(10, 10, 33, 1)
            == 4 * 2 + 8 * 10 + 4 * 33 * 2 + 4)


def test_k5_pack_bytes_match_what_the_planner_stages():
    """The staged buffer the kernel reads is the one the program's span
    counts: the planner's CPU tier records each ingest's ``rows`` and
    ``bytes`` (no rank order uploaded)."""
    from adlb_tpu_torch.runtime.trace import Tracer

    from benchmark import planner_cell
    from benchmark.tests.test_bench_digest import SEED, small_cell

    conf, traffic = small_cell()
    gen = planner_cell.generator(traffic)(
        traffic, conf["servers"], conf["max_tasks"], conf["max_requesters"],
        conf["types"], SEED)
    solver = planner_cell.build_solver(conf, "cpu")
    solver.ingest(gen.snaps)
    solver.plan()
    solver.tracer = tracer = Tracer(0)
    for _ in range(6):
        gen.bursts()
        solver.ingest(gen.snaps)
        gen.consume(solver.plan())
    staged = [ev["args"] for ev in tracer.events
              if ev["name"] == "planner:ingest.reqrows"]
    assert len(staged) >= 4 and all(a["rows"] for a in staged)
    R, T = conf["max_requesters"], len(conf["types"])
    for a in staged:
        assert not a["order_uploaded"]
        assert (bounds.k5_pack_bytes(a["rows"], R, T)
                == a["bytes"] + 4 * a["rows"])


def test_roofline_share():
    # 3.35e6 bytes take 1 us at 3.35 TB/s: in 2 us that is 50%
    assert bounds.roofline_pct(3.35e6, 2e-6) == pytest.approx(50.0)
    assert bounds.roofline_pct(1.0, 0.0) is None
