"""The port's durability layers against the JAX package: checkpoint shards
(``runtime/checkpoint.py``), the write-ahead log (``runtime/wal.py``), the
replication log (``runtime/replica.py``) and the spill store
(``runtime/spill.py``).

* **Byte formats** — one pool, made from a numpy seed, written by both
  packages gives byte-equal ACK2 shards, WAL segments, replication-log
  frames and spill files, and each package reads the other's bytes back
  to the same state. Nothing written depends on the clock except the
  journey spans a unit carries into the replication log and the WAL
  (``OP_TRACE``) and the WAL's group-commit timing: both packages are
  handed the same span tuples, and the WAL is written with
  ``fsync_ms=0`` and closed before its bytes are read, so the fsync
  timing cannot change what lies on disk.
* **State carried across** — a checkpoint or a WAL written by a world of
  one package restores in a world of the other, which drains the same
  unit set.
* **Contracts** — ``tests/test_checkpoint.py``'s round trip, batch-common
  prefix and checkpoint-under-planner-churn worlds, ``tests/test_spill.py``
  and ``tests/test_native_checkpoint.py``'s round trips run against the
  port (planned worlds on ``device="cpu"``, the port's C++ daemons).
"""

import os
import shutil
import struct
import time
import types

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

import adlb_tpu
import adlb_tpu_torch
from adlb_tpu.runtime import checkpoint as ref_ckpt
from adlb_tpu.runtime import replica as ref_replica
from adlb_tpu.runtime import spill as ref_spill
from adlb_tpu.runtime import wal as ref_wal
from adlb_tpu.runtime.world import Config as RefConfig
from adlb_tpu.runtime.world import WorldSpec as RefWorldSpec
from adlb_tpu_torch.runtime import checkpoint, replica, spill, wal
from adlb_tpu_torch.runtime.world import Config, WorldSpec
from adlb_tpu_torch.types import ADLB_SUCCESS

T1, T2, T_NEVER = 1, 2, 3


# ------------------------------------------------------------ byte formats


def _pool(seed, n=24):
    """Units (with journey spans on some) and batch-common entries from a
    numpy seed; plain namespaces, so both packages read the same objects."""
    rng = np.random.default_rng(seed)
    units = []
    for i in range(n):
        plen = int(rng.integers(0, 300))
        spans = ([("put", int(rng.integers(0, 8)), float(rng.random())),
                  ("queued", 4, float(rng.random()))]
                 if i % 3 == 0 else None)
        units.append(types.SimpleNamespace(
            seqno=int(1000 + 7 * i), work_type=int(rng.integers(1, 4)),
            prio=int(rng.integers(-2**31 + 1, 2**31 - 1)),
            target_rank=int(rng.integers(-1, 6)),
            answer_rank=int(rng.integers(-1, 6)),
            payload=rng.bytes(plen), common_len=int(rng.integers(0, 9)),
            common_server_rank=int(rng.integers(-1, 3)),
            common_seqno=int(rng.integers(-1, 50)),
            pinned=bool(i % 4 == 1), pin_rank=int(rng.integers(0, 6)),
            attempts=int(rng.integers(0, 3)), job=int(rng.integers(0, 3)),
            trace_id=int(rng.integers(1, 2**40)) if spans else 0,
            spans=spans))
    commons = [types.SimpleNamespace(seqno=int(s), refcnt=int(rng.integers(1, 9)),
                                     ngets=int(rng.integers(0, 5)),
                                     buf=rng.bytes(int(rng.integers(1, 40))))
               for s in rng.choice(500, size=4, replace=False)]
    cq = types.SimpleNamespace(entries=lambda: list(commons))
    return units, cq


def _drive(log, units, cq):
    """Every append of the replication-log surface, in one fixed order."""
    for k, u in enumerate(units):
        log.log_put(u, src=k % 4, put_id=None if k % 5 == 0 else 100 + k)
    for u in units[::3]:
        log.log_pin(u.seqno, 2)
    for u in units[1::5]:
        log.log_unpin(u.seqno)
    for u in units[2::4]:
        log.log_consume(u.seqno)
    log.log_remove(units[-1].seqno)
    for e in cq.entries():
        log.log_common_put(e.seqno, e.buf)
        log.log_common_refcnt(e.seqno, e.refcnt)
        log.log_common_op(e.seqno, "get", src=1, op_id=e.ngets)
    log.log_common_op(-1, "forfeit", src=2, op_id=9)
    log.log_common_op(cq.entries()[0].seqno, "credit")
    log.log_common_op(cq.entries()[1].seqno, "gc")
    log.log_common_state(cq.entries()[2].seqno, 3, 1, 0)
    log.log_attempts(units[4].seqno, 2)
    log.log_fence(units[5].seqno, 3, origin=-1)
    log.log_quarantine(units[7].seqno)
    log.log_hedge(units[8].seqno, units[9].seqno)
    log.log_job(2, 0, 4096, "tenant-b")
    log.log_app_done(1)
    log.log_rank_dead(3)
    log.log_member({"master": 4, "epoch": 2, "next_rank": 9,
                    "member": {"epoch": 2}, "live": [4, 5], "dead": []})
    log.log_slo({"name": "o1", "p99_ms": 50.0, "window_s": 60})
    log.log_control({"cooldown_s": 9.0, "dry_run": True})
    log.log_scale({"reason": "pressure"})
    log.log_job_weight(2, 3.5)
    log.log_seen_puts(0, [101, 102, 103])


@pytest.mark.parametrize("seed", [0, 1])
def test_checkpoint_shards_byte_equal_and_cross_read(seed, tmp_path):
    units, cq = _pool(seed)
    world = WorldSpec(nranks=6, nservers=2, types=(T1, T2))
    ref_world = RefWorldSpec(nranks=6, nservers=2, types=(T1, T2))
    port_prefix, ref_prefix = str(tmp_path / "port"), str(tmp_path / "ref")
    assert checkpoint.save_shard(port_prefix, 4, units, cq, world) == \
        ref_ckpt.save_shard(ref_prefix, 4, units, cq, ref_world) == len(units)
    with open(checkpoint.shard_path(port_prefix, 4), "rb") as f:
        port_bytes = f.read()
    with open(ref_ckpt.shard_path(ref_prefix, 4), "rb") as f:
        assert f.read() == port_bytes
    assert port_bytes[:4] == b"ACK2"
    # each package reads the other's shard to the same units and commons
    assert checkpoint.load_shard(ref_prefix, 4, world) == \
        ref_ckpt.load_shard(port_prefix, 4, ref_world)
    with pytest.raises(checkpoint.ShardShapeError):
        checkpoint.load_shard(ref_prefix, 4,
                              WorldSpec(nranks=7, nservers=2, types=(T1,)))
    assert checkpoint.existing_shard_ranks(ref_prefix) == [4]


def test_checkpoint_ack1_shard_gated_in_both_packages(tmp_path):
    """An ACK1 shard (no shape header) reads only with allow_legacy, in
    both packages, to the same units."""
    units, cq = _pool(2, n=5)
    prefix = str(tmp_path / "legacy")
    checkpoint.save_shard(prefix, 3, units, cq)
    path = checkpoint.shard_path(prefix, 3)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:  # ACK1: magic, then the body, no header
        f.write(b"ACK1" + data[4 + struct.calcsize("<III"):])
    for mod in (checkpoint, ref_ckpt):
        with pytest.raises(mod.ShardShapeError, match="legacy"):
            mod.load_shard(prefix, 3)
    assert checkpoint.load_shard(prefix, 3, allow_legacy=True) == \
        ref_ckpt.load_shard(prefix, 3, allow_legacy=True)


@pytest.mark.parametrize("seed", [0, 3])
def test_replication_log_frames_byte_equal_and_mirrors_agree(seed):
    units, cq = _pool(seed)
    port_log, ref_log = replica.ReplicationLog(5), ref_replica.ReplicationLog(5)
    _drive(port_log, units, cq)
    _drive(ref_log, units, cq)
    assert port_log.entries_total == ref_log.entries_total
    blob = port_log.take()
    assert blob == ref_log.take() and blob
    # the JAX package's frame in a port mirror, and the reverse
    port_m, ref_m = replica.ReplicaMirror(4), ref_replica.ReplicaMirror(4)
    port_m.apply(blob)
    ref_m.apply(blob)
    assert vars(port_m) == vars(ref_m)
    assert port_m.units and port_m.tombstones and port_m.brain["master"] == 4
    assert port_m.job_weights == {2: 3.5}


@pytest.mark.parametrize("seed", [0, 4])
def test_wal_segments_byte_equal_and_recover_across(seed, tmp_path):
    units, cq = _pool(seed)
    world = WorldSpec(nranks=6, nservers=2, types=(T1, T2))
    ref_world = RefWorldSpec(nranks=6, nservers=2, types=(T1, T2))
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    for mod, d, w in ((wal, port_dir, world), (ref_wal, ref_dir, ref_world)):
        log = mod.WriteAheadLog(d, 4, w, fsync_ms=0.0)
        _drive(log, units, cq)
        log.tick(time.monotonic(), force=True)
        log.close()
    with open(wal.log_path(port_dir, 4), "rb") as f:
        port_bytes = f.read()
    with open(ref_wal.log_path(ref_dir, 4), "rb") as f:
        assert f.read() == port_bytes
    port_recs = wal.scan_records(wal.log_path(ref_dir, 4))
    assert port_recs == ref_wal.scan_records(wal.log_path(port_dir, 4))
    assert len(port_recs[0]) > len(units) and not port_recs[1]
    # each package recovers the other's log to the same mirror
    port_m = wal.WriteAheadLog(ref_dir, 4, world, fsync_ms=0.0).recover()
    ref_m = ref_wal.WriteAheadLog(port_dir, 4, ref_world,
                                  fsync_ms=0.0).recover()
    assert vars(port_m) == vars(ref_m)
    assert port_m.units


def test_spill_files_byte_equal_and_cross_read(tmp_path):
    rng = np.random.default_rng(7)
    blobs = {int(s): rng.bytes(int(rng.integers(1, 5000)))
             for s in rng.choice(10_000, size=40, replace=False)}
    stores = [mod.SpillStore(str(tmp_path / name), 2)
              for mod, name in ((spill, "port"), (ref_spill, "ref"))]
    for st in stores:
        for s, b in blobs.items():
            st.put(s, b)
        for s in list(blobs)[::4]:
            assert st.take(s) == blobs[s]
        for s in list(blobs)[1::6]:
            st.discard(s)
        st._f.flush()
    port, ref = stores
    with open(port.path, "rb") as f:
        port_bytes = f.read()
    with open(ref.path, "rb") as f:
        assert f.read() == port_bytes
    assert port._index == ref._index and port.live_bytes == ref.live_bytes
    # the port's reader on the JAX package's file, record by record
    port._f, ref._f = ref._f, port._f
    for s in list(port._index):
        assert port.take(s) == blobs[s]
    port._f, ref._f = ref._f, port._f
    for st in stores:
        st.close()


# ------------------------------------------------------------ state carried


def _writer(prefix):
    def app(ctx):
        """Put 30 units over two types and a never-consumed type, consume
        none, checkpoint, stop."""
        if ctx.rank == 0:
            for i in range(30):
                ctx.put(struct.pack("<q", i), T1 if i % 2 else T2,
                        work_prio=i % 7,
                        target_rank=1 if i % 5 == 0 else -1)
            rc, n = ctx.checkpoint(prefix)
            assert rc == 1 and n == 30
            ctx.set_problem_done()
            return n
        return None

    return app


def _drainer(ctx):
    got = []
    while True:
        rc, r = ctx.reserve()
        if rc != 1:  # ADLB_SUCCESS in both packages
            return got
        rc, buf = ctx.get_reserved(r.handle)
        got.append((struct.unpack("<q", buf)[0], r.work_type))


def _drained(res):
    return sorted(x for v in res.app_results.values() for x in (v or []))


EXPECTED_30 = sorted((i, T1 if i % 2 else T2) for i in range(30))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_packages(direction, tmp_path):
    prefix = str(tmp_path / "pool")
    pkgs = [(adlb_tpu, RefConfig), (adlb_tpu_torch,
                                    lambda **kw: Config(device="cpu", **kw))]
    if direction == "port_to_jax":
        pkgs.reverse()
    (wpkg, wcfg), (rpkg, rcfg) = pkgs
    wpkg.run_world(3, 2, [T1, T2, T_NEVER], _writer(prefix),
                   cfg=wcfg(exhaust_check_interval=10.0), timeout=60)
    res = rpkg.run_world(3, 2, [T1, T2, T_NEVER], _drainer,
                         cfg=rcfg(restore_path=prefix,
                                  exhaust_check_interval=0.2), timeout=60)
    assert _drained(res) == EXPECTED_30
    # targeted units went to their target
    assert {i for i in range(0, 30, 5)} <= {i for i, _ in res.app_results[1]}


def _put_then_abort(ctx):
    if ctx.rank == 0:
        for i in range(10):
            assert ctx.put(struct.pack("<q", i), T1) == 1
        ctx.abort(7)
    return None


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wal_cold_restart_across_packages(direction, tmp_path):
    """World 1 (one package) puts 10 acked units and aborts; world 2 (the
    other package) on the same wal_dir recovers every one."""
    pkgs = [(adlb_tpu, RefConfig), (adlb_tpu_torch,
                                    lambda **kw: Config(device="cpu", **kw))]
    if direction == "port_to_jax":
        pkgs.reverse()
    kw = dict(wal_dir=str(tmp_path), wal_fsync_ms=2.0,
              exhaust_check_interval=0.2)
    (wpkg, wcfg), (rpkg, rcfg) = pkgs
    assert wpkg.run_world(2, 2, [T1], _put_then_abort, cfg=wcfg(**kw),
                          timeout=60).aborted
    res = rpkg.run_world(2, 2, [T1], _drainer, cfg=rcfg(**kw), timeout=60)
    assert _drained(res) == [(i, T1) for i in range(10)]


# --------------------------------------------- tests/test_checkpoint.py


def test_checkpoint_and_resume_roundtrip(tmp_path):
    prefix = str(tmp_path / "pool")

    def phase1(ctx):
        """Put 30 units, consume 10, checkpoint the remainder, stop."""
        if ctx.rank == 0:
            for i in range(30):
                ctx.put(struct.pack("<q", i), T1 if i % 2 else T2,
                        work_prio=i % 7,
                        target_rank=1 if i % 5 == 0 else -1)
            got = []
            for _ in range(10):
                rc, r = ctx.reserve()
                assert rc == ADLB_SUCCESS
                rc, buf = ctx.get_reserved(r.handle)
                got.append(struct.unpack("<q", buf)[0])
            rc, n = ctx.checkpoint(prefix)
            assert rc == ADLB_SUCCESS
            ctx.set_problem_done()
            return got, n
        rc, _ = ctx.reserve([T_NEVER])
        assert rc != ADLB_SUCCESS
        return None

    res1 = adlb_tpu_torch.run_world(
        3, 2, [T1, T2, T_NEVER], phase1,
        cfg=Config(device="cpu", exhaust_check_interval=10.0))
    got1, n_captured = res1.app_results[0]
    assert len(got1) == 10 and n_captured == 20
    res2 = adlb_tpu_torch.run_world(
        3, 2, [T1, T2, T_NEVER], _drainer,
        cfg=Config(device="cpu", restore_path=prefix,
                   exhaust_check_interval=0.2))
    assert _drained(res2) == sorted(
        (i, T1 if i % 2 else T2) for i in range(30) if i not in got1)
    targeted = [i for i in range(30) if i % 5 == 0 and i not in got1]
    assert set(targeted) <= {i for i, _ in (res2.app_results[1] or [])}


def test_checkpoint_preserves_batch_common_prefix(tmp_path):
    prefix = str(tmp_path / "pool2")
    common = b"SHAREDHDR:"

    def phase1(ctx):
        if ctx.rank == 0:
            ctx.begin_batch_put(common)
            for i in range(6):
                ctx.put(struct.pack("<q", i), T1)
            ctx.end_batch_put()
            rc, n = ctx.checkpoint(prefix)
            assert rc == ADLB_SUCCESS and n == 6
            ctx.set_problem_done()
        else:
            rc, _ = ctx.reserve([T_NEVER])
            assert rc != ADLB_SUCCESS
        return None

    adlb_tpu_torch.run_world(2, 2, [T1, T2, T_NEVER], phase1,
                             cfg=Config(device="cpu",
                                        exhaust_check_interval=10.0))

    def phase2(ctx):
        got = []
        while True:
            rc, r = ctx.reserve([T1])
            if rc != ADLB_SUCCESS:
                return got
            rc, buf = ctx.get_reserved(r.handle)
            assert buf.startswith(common), buf
            got.append(struct.unpack("<q", buf[len(common):])[0])

    res = adlb_tpu_torch.run_world(
        2, 2, [T1, T2, T_NEVER], phase2,
        cfg=Config(device="cpu", restore_path=prefix,
                   exhaust_check_interval=0.2))
    assert sorted(x for v in res.app_results.values() for x in (v or [])) \
        == list(range(6))


def test_checkpoint_under_balancer_churn(tmp_path):
    """A checkpoint taken while the planner (on the device path) migrates a
    hot server's inventory: consumed before the flush and drained after
    cover every unit put."""
    from adlb_tpu_torch.balancer import solve

    prefix = str(tmp_path / "pool3")

    def phase1(ctx):
        if ctx.rank == 0:
            for i in range(80):
                ctx.put(struct.pack("<q", i), T1, work_prio=i % 5)
            time.sleep(0.08)  # migrations in flight
            rc, n = ctx.checkpoint(prefix)
            assert rc == ADLB_SUCCESS
            ctx.set_problem_done()
            return ("ckpt", n)
        got = []
        while True:
            rc, r = ctx.reserve([T1])
            if rc != ADLB_SUCCESS:
                return ("got", got)
            rc, buf = ctx.get_reserved(r.handle)
            got.append(struct.unpack("<q", buf)[0])
            time.sleep(0.004)

    before = solve.solve_counts["device"]
    res1 = adlb_tpu_torch.run_world(
        4, 3, [T1, T2, T_NEVER], phase1,
        cfg=Config(balancer="tpu", device="cpu", solver_host_threshold=0,
                   put_routing="home", exhaust_check_interval=10.0,
                   balancer_max_tasks=64, balancer_max_requesters=16))
    assert solve.solve_counts["device"] > before
    consumed1 = {x for v in res1.app_results.values() if v[0] == "got"
                 for x in v[1]}

    def phase2(ctx):
        got = []
        while True:
            rc, r = ctx.reserve([T1])
            if rc != ADLB_SUCCESS:
                return got
            rc, buf = ctx.get_reserved(r.handle)
            got.append(struct.unpack("<q", buf)[0])

    res2 = adlb_tpu_torch.run_world(
        4, 3, [T1, T2, T_NEVER], phase2,
        cfg=Config(balancer="tpu", device="cpu", solver_host_threshold=0,
                   restore_path=prefix, exhaust_check_interval=0.2))
    drained = {x for v in res2.app_results.values() for x in (v or [])}
    assert consumed1 | drained == set(range(80)), \
        sorted(set(range(80)) - (consumed1 | drained))


# --------------------------------------------------- tests/test_spill.py


def test_spill_store_roundtrip_corruption_and_compaction(tmp_path):
    s = spill.SpillStore(str(tmp_path / "a"), 2)
    blobs = {i: bytes([i]) * (100 + i) for i in range(8)}
    for i, b in blobs.items():
        s.put(i, b)
    assert len(s) == 8 and s.live_bytes == sum(map(len, blobs.values()))
    assert s.take(3) == blobs[3] and 3 not in s
    assert s.discard(5) == len(blobs[5]) and s.discard(5) == 0
    for i in (0, 1, 2, 4, 6, 7):
        assert s.take(i) == blobs[i]
    assert s.live_bytes == 0
    s.close()
    s = spill.SpillStore(str(tmp_path / "b"), 0)
    s.put(7, b"payload-bytes" * 10)
    with open(s.path, "r+b") as f:  # flip one byte of the record body
        f.seek(20)
        c = f.read(1)
        f.seek(20)
        f.write(bytes([c[0] ^ 0xFF]))
    with pytest.raises(spill.SpillCorruption):
        s.take(7)
    s.close()
    s = spill.SpillStore(str(tmp_path / "c"), 0)
    blob = b"z" * (1 << 20)
    for i in range(12):
        s.put(i, blob)
    for i in range(10):
        s.take(i)  # 10 MiB dead against 2 MiB live: compaction
    assert s.compactions >= 1 and os.path.getsize(s.path) < 4 * len(blob)
    assert s.take(10) == blob and s.take(11) == blob
    s.close()


def _spill_server(tmp_path, cap=4096, **cfg_kw):
    from adlb_tpu_torch.runtime.server import Server
    from adlb_tpu_torch.runtime.transport import InProcFabric

    world = WorldSpec(nranks=4, nservers=2, types=(T1,))
    fabric = InProcFabric(4)
    cfg = Config(device="cpu", max_malloc_per_server=cap, mem_soft_frac=0.5,
                 spill_dir=str(tmp_path), **cfg_kw)
    return Server(world, cfg, fabric.endpoint(2)), fabric


def _put(srv, payload, src=0, target=-1):
    from adlb_tpu_torch.runtime.messages import Tag, msg

    srv._handle(msg(Tag.FA_PUT, src, payload=payload, work_type=T1, prio=0,
                    target_rank=target, answer_rank=-1, common_len=0,
                    common_server=-1, common_seqno=-1))


def _drain(fabric, rank):
    out = []
    while (m := fabric.endpoints[rank].recv(timeout=0.0)) is not None:
        out.append(m)
    return out


def test_spill_residency_fault_in_and_checkpoint(tmp_path):
    """A handler-driven port server over a tiny cap: puts over the
    watermark spill the cold payloads, delivery faults them back in
    byte-identical, and a checkpoint faults every one in first."""
    from adlb_tpu_torch.runtime.messages import Tag, msg

    srv, fabric = _spill_server(tmp_path)
    payloads = [bytes([65 + i]) * 1500 for i in range(3)]
    for p in payloads:
        _put(srv, p)
        time.sleep(0.005)
    assert srv.mem.spilled > 0
    assert srv.mem.curr + srv.mem.spilled == 4500
    spilled = [u for u in srv.wq.units() if u.spilled]
    assert spilled and all(u.payload == b"" and u.spill_len == 1500
                           for u in spilled)
    resp = [m for m in _drain(fabric, 0) if m.tag is Tag.TA_PUT_RESP]
    assert [m.rc for m in resp] == [ADLB_SUCCESS] * 3
    assert srv._write_checkpoint_shard(str(tmp_path / "ck")) == 3
    assert srv.mem.spilled == 0  # everything resident again
    units, _ = checkpoint.load_shard(str(tmp_path / "ck"), 2, srv.world)
    assert sorted(u["payload"] for u in units) == payloads
    srv2, fabric2 = _spill_server(tmp_path / "second")
    for p in payloads:
        _put(srv2, p)
        time.sleep(0.005)
    got = []
    for rq in range(3):
        srv2._handle(msg(Tag.FA_RESERVE, 1, req_types=[T1], hang=True,
                         rqseqno=rq, fetch=1))
        got += [bytes(m.payload) for m in _drain(fabric2, 1)
                if m.tag is Tag.TA_RESERVE_RESP and m.rc == ADLB_SUCCESS]
    assert sorted(got) == payloads, "fault-in not byte-identical"
    assert srv2.mem.spilled == 0 and len(srv2.spill) == 0
    assert srv2.metrics.value("spill_faultins") >= 1


def test_dead_target_releases_spilled_entry(tmp_path):
    from adlb_tpu_torch.runtime.messages import Msg, Tag

    srv, fabric = _spill_server(tmp_path, on_worker_failure="reclaim")
    _put(srv, b"t" * 1500, target=1)
    time.sleep(0.005)
    _put(srv, b"u" * 1500)
    _put(srv, b"v" * 1500)
    assert srv.mem.spilled > 0
    spilled_total = srv.mem.spilled
    srv._handle(Msg(tag=Tag.PEER_EOF, src=1))  # rank 1 dies
    assert srv.mem.spilled <= spilled_total
    assert srv.mem.curr + srv.mem.spilled == sum(
        u.payload_len for u in srv.wq.units())


_N_STORM = 60
_PAY = 4096


def _storm_app(ctx):
    import hashlib

    if ctx.rank == 0:
        sent = {}
        for i in range(_N_STORM):
            p = struct.pack("<q", i) + hashlib.sha256(
                str(i).encode()).digest() * (_PAY // 32)
            assert ctx.put(p, T1) == ADLB_SUCCESS
            sent[i] = hashlib.sha256(p).hexdigest()
        return {"sent": sent,
                "backoffs": ctx._c.metrics.value("put_backoffs"),
                "retries": ctx._c.metrics.value("put_retries")}
    got = {}
    while True:
        rc, w = ctx.get_work([T1])
        if rc != ADLB_SUCCESS:
            return got
        got[struct.unpack("<q", w.payload[:8])[0]] = \
            hashlib.sha256(w.payload).hexdigest()
        time.sleep(0.002)


def test_put_storm_over_watermark_zero_backoffs(tmp_path):
    """About 240 KiB of puts through a 64 KiB hard-watermarked cap in a
    port process world: with spill_dir set, no ADLB_BACKOFF and every
    spilled payload fetched back byte-identical."""
    from adlb_tpu_torch.runtime.transport_tcp import spawn_world

    res = spawn_world(
        3, 2, [T1], _storm_app,
        cfg=Config(device="cpu", max_malloc_per_server=64 << 10,
                   mem_soft_frac=0.7, mem_hard_frac=0.8,
                   spill_dir=str(tmp_path), exhaust_check_interval=0.25),
        timeout=120.0)
    prod = res.app_results[0]
    got = {}
    for r, v in res.app_results.items():
        if r != 0:
            got.update(v)
    assert len(got) == _N_STORM
    assert prod["backoffs"] == 0 and prod["retries"] == 0
    assert all(got[i] == h for i, h in prod["sent"].items())


# ------------------------------------- tests/test_native_checkpoint.py


PREFIX = b"COMMONPREFIX"
N_PLAIN, N_COMMON, TARGETED = 18, 5, 1000
EXPECTED_NATIVE = sorted(list(range(N_PLAIN)) + [TARGETED]
                         + [100 + i for i in range(N_COMMON)])


def _native_writer(prefix):
    def app(ctx):
        if ctx.rank != 0:
            return None
        for i in range(N_PLAIN):
            assert ctx.put(struct.pack("<q", i), T1, work_prio=i % 5) == 1
        assert ctx.put(struct.pack("<q", TARGETED), T1, target_rank=1) == 1
        ctx.begin_batch_put(PREFIX)
        for i in range(N_COMMON):
            assert ctx.put(struct.pack("<q", 100 + i), T1) == 1
        ctx.end_batch_put()
        rc, count = ctx.checkpoint(prefix)
        assert rc == 1
        return count

    return app


def _native_consumer(ctx):
    got = []
    while True:
        rc, r = ctx.reserve([T1])
        if rc != 1:
            return sorted(got)
        rc, buf = ctx.get_reserved(r.handle)
        got.append(struct.unpack("<q", buf.removeprefix(PREFIX))[0])


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
@pytest.mark.parametrize("writer,reader", [
    ("native", "native"), ("native", "python"), ("python", "native"),
    ("jax_python", "native")])
def test_native_checkpoint_roundtrips(writer, reader, tmp_path):
    """Shards between the port's C++ daemons and Python servers, and from
    a JAX-package world into the port's daemons: the restored world
    drains every unit, the targeted one at its target."""
    from adlb_tpu_torch.runtime.transport_tcp import spawn_world

    prefix = str(tmp_path / "pool")
    native = dict(server_impl="native", device="cpu")
    if writer == "native":
        res = spawn_world(3, 2, [T1], _native_writer(prefix),
                          cfg=Config(**native), timeout=60.0)
    elif writer == "python":
        res = adlb_tpu_torch.run_world(3, 2, [T1], _native_writer(prefix),
                                       cfg=Config(device="cpu"), timeout=60)
    else:
        res = adlb_tpu.run_world(3, 2, [T1], _native_writer(prefix),
                                 cfg=RefConfig(), timeout=60)
    assert res.app_results[0] == N_PLAIN + 1 + N_COMMON
    kw = dict(restore_path=prefix, exhaust_check_interval=0.15)
    if reader == "native":
        res2 = spawn_world(3, 2, [T1], _native_consumer,
                           cfg=Config(**native, **kw), timeout=60.0)
    else:
        res2 = adlb_tpu_torch.run_world(3, 2, [T1], _native_consumer,
                                        cfg=Config(device="cpu", **kw),
                                        timeout=60)
    assert sorted(x for v in res2.app_results.values() if v for x in v) \
        == EXPECTED_NATIVE
    assert TARGETED in (res2.app_results.get(1) or [])
