"""The port's native plane against the JAX package's.

* The C++ work-queue core: the same seeded operation sequence on the
  port's ``NativeWorkQueue`` and the JAX package's gives equal results.
* The server daemon and the C client library are built from the port's
  copies into ``adlb_tpu_torch/_build/native/``; a C example links against
  the port's library (its rpath points there), and a world of port daemons
  and C clients gives the answer a JAX-package world gives.
"""

import os
import random
import shutil
import struct
import subprocess

import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu.native.wq import NativeWorkQueue as RefNativeWorkQueue
from adlb_tpu.runtime.queues import WorkUnit as RefWorkUnit
from adlb_tpu_torch.native import build as port_build
from adlb_tpu_torch.native import capi
from adlb_tpu_torch.native.wq import NativeWorkQueue
from adlb_tpu_torch.runtime.queues import WorkQueue, WorkUnit
from adlb_tpu_torch.runtime.world import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "adlb_tpu_torch", "_build", "native")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")


def _unit(cls, seqno, wtype, prio, target, payload):
    return cls(seqno=seqno, work_type=wtype, prio=prio, target_rank=target,
               answer_rank=-1, payload=payload)


def _view(u):
    return None if u is None else (u.seqno, u.work_type, u.prio,
                                   u.target_rank, u.pinned, u.pin_rank)


@pytest.mark.parametrize("seed", [3, 99, 2024])
def test_work_queue_matches_reference_native_queue(seed):
    """Adds, matches (any type, type sets, targeted and untargeted),
    pins, unpins and removes, with every query answered alike by the
    port's C++ core, the JAX package's and the port's Python queue."""
    rng = random.Random(seed)
    ref, port, py = RefNativeWorkQueue(), NativeWorkQueue(), WorkQueue()
    alive = {}
    seqno = 0
    for step in range(3000):
        op = rng.random()
        if op < 0.45 or not alive:
            seqno += 1
            args = (seqno, rng.randint(1, 4), rng.randint(-9, 9),
                    rng.choice([-1, -1, -1, 0, 1, 2]),
                    b"p" * rng.randint(0, 32))
            ref.add(_unit(RefWorkUnit, *args))
            port.add(_unit(WorkUnit, *args))
            py.add(_unit(WorkUnit, *args))
            alive[seqno] = False
        elif op < 0.75:
            rank = rng.randint(0, 2)
            req = rng.choice([None, frozenset([1]), frozenset([2, 3]),
                              frozenset([4, 1])])
            for q in ("find_match", "find_targeted", "find_untargeted"):
                args = (req,) if q == "find_untargeted" else (rank, req)
                want = _view(getattr(ref, q)(*args))
                assert _view(getattr(port, q)(*args)) == want, (step, q)
                assert _view(getattr(py, q)(*args)) == want, (step, q)
        elif op < 0.88:
            s = rng.choice(list(alive))
            for q in (ref, port, py):
                q.unpin(s) if alive[s] else q.pin(s, 1)
            alive[s] = not alive[s]
        else:
            s = rng.choice(list(alive))
            for q in (ref, port, py):
                q.remove(s)
            del alive[s]
        if step % 250 == 0:
            assert port.count == ref.count == py.count == len(alive)
            assert port.total_bytes == ref.total_bytes
            assert port.max_count == ref.max_count
            assert port.depth_sample() == ref.depth_sample()
            assert port.num_unpinned() == ref.num_unpinned()
            assert port.num_unpinned_untargeted() \
                == ref.num_unpinned_untargeted()
            for t in range(1, 5):
                assert port.hi_prio_of_type(t) == ref.hi_prio_of_type(t)
                assert port.count_of_type(t) == ref.count_of_type(t)
            assert port.snapshot_untargeted(64) == ref.snapshot_untargeted(64)
            assert _view(port.find_unpinned()) == _view(ref.find_unpinned())


def test_native_binaries_build_from_the_port_copies():
    lib = port_build.ensure_built()
    assert lib is not None and lib._name.startswith(BUILD)
    assert port_build.ensure_serverd() == os.path.join(BUILD, "adlb_serverd")
    assert capi.build_libadlb() == os.path.join(BUILD, "libadlb.so")
    for src in ("wqcore.cpp", "wqcore.hpp", "codec.cpp", "serverd.cpp",
                "libadlb.cpp", "adlbf.c"):
        path = os.path.join(ROOT, "adlb_tpu_torch", "native", src)
        with open(path) as f:
            text = f.read()
        assert "adlb_tpu/" not in text.replace("adlb_tpu_torch/", ""), src


def test_c_example_links_the_port_library():
    if shutil.which("gcc") is None:
        pytest.skip("no C toolchain")
    exe = capi.build_example(os.path.join(ROOT, "examples", "capi_smoke.c"))
    assert exe.startswith(BUILD)
    ldd = subprocess.run(["ldd", exe], capture_output=True, text=True)
    line = next(ln for ln in ldd.stdout.splitlines() if "libadlb.so" in ln)
    assert os.path.join(BUILD, "libadlb.so") in line, ldd.stdout


def _answer_economy(ctx, success):
    if ctx.rank == 0:
        for i in range(24):
            ctx.put(struct.pack("<qq", i, i * 3), 1, answer_rank=0)
        total = 0
        for _ in range(24):
            rc, r = ctx.reserve([2])
            assert rc == success
            rc, buf = ctx.get_reserved(r.handle)
            total += struct.unpack("<q", buf)[0]
        ctx.set_problem_done()
        return total
    n = 0
    while True:
        rc, r = ctx.reserve([1])
        if rc != success:
            return n
        rc, buf = ctx.get_reserved(r.handle)
        a, b = struct.unpack("<qq", buf)
        ctx.put(struct.pack("<q", a + b), 2, target_rank=r.answer_rank)
        n += 1


def _port_app(ctx):
    from adlb_tpu_torch.types import ADLB_SUCCESS

    return _answer_economy(ctx, ADLB_SUCCESS)


def _ref_app(ctx):
    from adlb_tpu.types import ADLB_SUCCESS

    return _answer_economy(ctx, ADLB_SUCCESS)


def test_daemon_world_matches_reference():
    """Python clients over the port's C++ daemons (two servers) against the
    same world over the JAX package's daemons."""
    from adlb_tpu.runtime.transport_tcp import spawn_world as ref_spawn
    from adlb_tpu.runtime.world import Config as RefConfig
    from adlb_tpu_torch.runtime.transport_tcp import spawn_world

    ref = ref_spawn(3, 2, [1, 2], _ref_app,
                    cfg=RefConfig(server_impl="native"), timeout=60.0)
    port = spawn_world(3, 2, [1, 2], _port_app,
                       cfg=Config(server_impl="native"), timeout=60.0)
    want = sum(i + i * 3 for i in range(24))
    assert port.app_results[0] == ref.app_results[0] == want
    assert sum(v for k, v in port.app_results.items() if k) == 24
    assert sorted(port.server_stats) == sorted(ref.server_stats) == [3, 4]
    assert port.planner == {}  # steal mode: nothing plans


def test_c_clients_on_port_daemons_match_reference(monkeypatch):
    """C clients (the port's libadlb) against the port's daemons give the
    JAX-package world's answer."""
    if shutil.which("gcc") is None:
        pytest.skip("no C toolchain")
    from adlb_tpu.native import capi as ref_capi
    from adlb_tpu.runtime.world import Config as RefConfig
    from adlb_tpu_torch.balancer import sidecar

    sidecars = []
    monkeypatch.setattr(sidecar, "start_sidecar",
                        lambda *a, **kw: sidecars.append(a))

    def processed(results):
        for rc, out, err in results:
            assert rc == 0, f"exit {rc}\n{out}\n{err}"
        return sum(int(out.split("processed=")[1].split()[0])
                   for _, out, _ in results)

    src = os.path.join(ROOT, "examples", "capi_smoke.c")
    port_res, stats = capi.run_native_world(
        n_clients=3, nservers=2, types=[1, 2], exe=capi.build_example(src),
        cfg=Config(server_impl="native", exhaust_check_interval=0.2),
        timeout=90.0)
    ref_res, _ = ref_capi.run_native_world(
        n_clients=3, nservers=2, types=[1, 2],
        exe=ref_capi.build_example(src),
        cfg=RefConfig(server_impl="native", exhaust_check_interval=0.2),
        timeout=90.0)
    assert processed(port_res) == processed(ref_res) == 24
    assert len(stats) == 2
    assert sidecars == []  # steal mode: no sidecar


def test_example_rpath_is_the_build_directorys_real_path():
    """A C example finds the port's libadlb through the build directory's
    real path: a binary built by a process that imported the package
    through a link (the reference-suite runner's staged root) still loads
    after that link is gone."""
    if shutil.which("gcc") is None or shutil.which("readelf") is None:
        pytest.skip("no C toolchain")
    exe = capi.build_example(os.path.join(ROOT, "examples", "capi_smoke.c"))
    dyn = subprocess.run(["readelf", "-d", exe], check=True,
                         capture_output=True, text=True).stdout
    assert f"[{os.path.realpath(BUILD)}]" in dyn, dyn


@pytest.mark.parametrize("mode,impl", [("steal", "python"),
                                       ("tpu", "python"), ("tpu", "native")],
                         ids=["steal", "tpu", "tpu-sidecar"])
def test_run_native_world_returns_the_reference_pair(mode, impl):
    """``run_native_world`` called as the JAX package's callers call it
    (``tests/test_capi.py::test_capi_smoke``) returns the same pair,
    ``(results, server_stats)``, also when a sidecar plans for native
    servers."""
    if shutil.which("gcc") is None:
        pytest.skip("no C toolchain")
    exe = capi.build_example(os.path.join(ROOT, "examples", "capi_smoke.c"))
    results, stats = capi.run_native_world(
        n_clients=3,
        nservers=2,
        types=[1, 2],
        exe=exe,
        cfg=Config(balancer=mode, server_impl=impl,
                   exhaust_check_interval=0.2, device="cpu"),
        timeout=90.0,
    )
    for rc, out, err in results:
        assert rc == 0, f"exit {rc}\nstdout:{out}\nstderr:{err}"
        assert "OK" in out
    assert len(stats) == 2
    assert sum(int(out.split("processed=")[1].split()[0])
               for _, out, _ in results) == 24


@pytest.mark.parametrize("name", ["coinop_native", "trickle_native"])
def test_native_probe_runs_on_the_port_binaries(name):
    """The two native probes of this slice: C clients built from
    ``examples/coinop_c.c`` / ``examples/trickle_c.c`` against the port's
    libadlb, on the port's daemons, planned by the sidecar on the CPU;
    every token reaches a worker, as in the JAX package's own run."""
    if shutil.which("gcc") is None:
        pytest.skip("no C toolchain")
    import importlib

    from adlb_tpu_torch.balancer import solve

    mod = importlib.import_module(f"adlb_tpu_torch.workloads.{name}")
    ref = importlib.import_module(f"adlb_tpu.workloads.{name}")
    cfg = Config(balancer="tpu", device="cpu", solver_host_threshold=0,
                 exhaust_check_interval=0.2)
    host = solve.solve_counts["host"]
    if name == "coinop_native":
        args = dict(n_tokens=150, num_app_ranks=4, nservers=2)
        r = mod.run(cfg=cfg, timeout=120.0, **args)
        want = ref.run(timeout=120.0, **args)
        assert r.pops == want.pops == 150
        assert r.latency_p95_ms >= r.latency_p50_ms > 0 and r.per_worker
    else:
        args = dict(n_tasks=60, interval_us=5000, group=2, work_us=1000,
                    num_app_ranks=6, nservers=3)
        r = mod.run(cfg=cfg, timeout=120.0, **args)
        want = ref.run(timeout=120.0, **args)
        assert r.tasks == want.tasks == 60
        assert r.dispatch_p90_ms >= r.dispatch_p50_ms > 0
    assert solve.solve_counts["host"] == host  # no numpy fallback
    exe = os.path.join(port_build.BUILD_DIR,
                       "adlb_" + name.replace("_native", "_c"))
    assert os.path.exists(exe)  # built into the port's build directory
