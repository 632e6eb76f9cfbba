"""The port's chaos soak (``scripts/chaos_soak_torch.py``) on the CPU.

A fixed handful of seeds whose draws cover every adversity family: the
answer economy with spray and abort, a worker killed under both worker
policies, a server killed under ``failover``, the master killed ``idle``
and ``mid_plan`` (planned, on the spawn plane), a gray stall, membership
churn and nq. Each seed's iteration must pass and draw the family named
here.

Each seed must also draw the same world as the JAX package's
``scripts/chaos_soak.py``. Both soaks run in interpreters of their own
(the reference's without the port's alias) with their world harnesses
(``spawn_world``, ``nq.run``, ``ElasticWorld``) replaced by a stub that
records what the iteration hands its first world: the shape, the
``Config`` (the port's ``device`` aside), the other arguments and the
iteration's drawn variables, the world's description among them where it
is drawn before the world runs. The reference's worlds are not run: the
JAX package still has the failover faults the port fixed, and its
master-kill worlds wait out their timeout on some seeds (1137's, 150 s).
Free ports, temporary directories and clocks are left out.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")

#: seed -> the adversity family it draws
SEEDS = {
    1002: "economy spray abort",
    1062: "worker kill abort",
    1060: "worker kill reclaim",
    1025: "server kill failover",
    1172: "master_kill idle",
    1166: "master_kill mid_plan",
    1044: "gray stall",
    1086: "churn",
    1005: "nq",
}

#: prints, per seed, what the soak ``module`` hands its first world
DRAWS = """
import dataclasses, importlib, json, sys
sys.path.insert(0, {scripts!r})
soak = importlib.import_module({module!r})
package = {package!r}
SIMPLE = (int, float, str, bool, type(None))
SKIP = ("t0", "device", "solver_host_threshold")


class Drawn(Exception):
    pass


def plain(x):
    if isinstance(x, SIMPLE):
        return x
    if isinstance(x, (list, tuple, set)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {{str(k): plain(v) for k, v in x.items() if keep(str(k))}}
    if dataclasses.is_dataclass(x):
        return {{f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x) if keep(f.name)}}
    return None


def keep(name):
    return not (name in SKIP or "port" in name or "dir" in name)


def stub(harness):
    def record(*args, **kw):
        caller = sys._getframe(1).f_locals
        raise Drawn({{
            "harness": harness,
            "args": plain([a for a in args if not callable(a)]),
            "kw": plain({{k: v for k, v in kw.items() if not callable(v)}}),
            "locals": {{k: plain(v) for k, v in caller.items()
                       if keep(k) and not callable(v)}}}})
    return record


soak.spawn_world = stub("spawn_world")
soak.nq.run = stub("nq.run")
importlib.import_module(package + ".runtime.membership").ElasticWorld = \
    stub("ElasticWorld")
for seed in {seeds!r}:
    try:
        soak.one_iter(seed, **{kwargs!r})
    except Drawn as e:
        print("DRAWN " + json.dumps([seed, e.args[0]]), flush=True)
"""


def draws(module: str, package: str, **kwargs) -> dict:
    """seed -> what ``scripts/<module>.py``'s ``one_iter(seed, **kwargs)``
    hands its first world."""
    code = DRAWS.format(scripts=SCRIPTS, module=module, package=package,
                        seeds=list(SEEDS), kwargs=kwargs)
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return {s: d for s, d in (json.loads(ln[6:]) for ln in
                              out.stdout.splitlines()
                              if ln.startswith("DRAWN "))}


def family(desc: dict) -> str:
    w = desc["workload"]
    if w == "economy":
        if desc["kill"]:
            return f"worker kill {desc['policy']}"
        return " ".join(["economy"] + [k for k in ("spray", "abort")
                                       if desc[k]])
    if w == "coverage":
        return f"server kill {desc['s_policy']}"
    if w == "master_kill":
        return f"master_kill {desc['draw']}"
    if w == "gray":
        return "gray stall" if desc["stall"] else "gray poison"
    return w


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    sys.path.insert(0, SCRIPTS)
    os.environ.setdefault("ADLB_FLIGHT_DIR",
                          str(tmp_path_factory.mktemp("flight")))
    import chaos_soak_torch

    yield chaos_soak_torch
    sys.path.remove(SCRIPTS)


def test_the_seeds_cover_every_family():
    assert set(SEEDS.values()) >= {
        "worker kill abort", "worker kill reclaim", "server kill failover",
        "master_kill idle", "master_kill mid_plan", "gray stall", "churn",
        "nq"}
    assert any(f.startswith("economy ") for f in SEEDS.values())


def test_each_seed_draws_the_reference_world():
    port = draws("chaos_soak_torch", "adlb_tpu_torch", device="cpu")
    ref = draws("chaos_soak", "adlb_tpu")
    assert sorted(port) == sorted(ref) == sorted(SEEDS)
    for seed in SEEDS:
        assert port[seed] == ref[seed], seed


@pytest.mark.parametrize("seed", list(SEEDS))
def test_soak_iteration_passes(seed, soak):
    soak.PLANNERS.clear()
    desc = soak.one_iter(seed, device="cpu")
    assert family(desc) == SEEDS[seed], desc
    # a planned spawn-plane world solves on the device path (the plain
    # version on the CPU) and never on the host: the soak's host
    # threshold is 0
    counts = [c for p in soak.PLANNERS for c in p.values()]
    assert all(c["host_solves"] == 0 for c in counts), counts


@pytest.mark.parametrize("parent", [False, True])
def test_the_soak_reads_its_killed_planners_from_the_fault_logs(
        parent, soak, tmp_path, monkeypatch):
    """The soak's ``spawn_world`` gives each world a fault-log directory of
    its own (under ``ADLB_FAULT_LOG_DIR`` when it is set, else a temporary
    one, removed after) and records the planner counts that its killed
    servers' kills wrote there, beside ``WorldResult.planner``."""
    from types import SimpleNamespace

    if parent:
        monkeypatch.setenv("ADLB_FAULT_LOG_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("ADLB_FAULT_LOG_DIR", raising=False)
    seen = []

    def world(*args, **kw):
        d = os.environ["ADLB_FAULT_LOG_DIR"]
        seen.append(d)
        for rank, state in ((5, {"planner": {"device_solves": 2}}),
                            (6, {"planner": None}), (0, None)):
            doc = {"rank": rank, "seed": 1, "events": []}
            if state is not None:
                doc["state"] = state
            with open(os.path.join(d, f"faults-rank{rank}.json"), "w") as f:
                json.dump(doc, f)
        return SimpleNamespace(planner={6: {"device_solves": 1}})

    monkeypatch.setattr(soak, "_spawn_world", world)
    monkeypatch.setattr(soak, "PLANNERS", [])
    monkeypatch.setattr(soak, "KILLED_PLANNERS", [])
    soak.spawn_world(3, 4, [1])
    assert soak.PLANNERS == [{6: {"device_solves": 1}}]
    assert soak.KILLED_PLANNERS == [{5: {"device_solves": 2}}]
    assert os.environ.get("ADLB_FAULT_LOG_DIR") == (
        str(tmp_path) if parent else None)
    assert os.path.dirname(seen[0]) == str(tmp_path) if parent \
        else not os.path.exists(seen[0])
