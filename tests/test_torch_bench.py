"""The port's benchmark (``bench_torch.py``) and scaling curve
(``scripts/scaling_curve_torch.py``) on the CPU.

* A process that imports ``bench_torch`` and runs rows with ``--device
  cpu`` loads no ``jax`` and nothing of ``adlb_tpu``; its rows record
  their planner counts.
* The compact line carries every key of ``bench.py``'s compact record
  (read from ``bench.py``'s source with ``ast``; it is not imported) and
  stays within 1,900 characters.
* Rows 3-5 at small shapes equal the JAX package on the same
  numpy-seeded inputs: ``solve_scale``'s pairs against
  ``AssignmentSolver.solve``, ``solve_onchip``'s assignment and
  ``solve_chained``'s chained outputs against ``pallas_greedy_assign`` in
  interpret mode (inside a ``lax.scan`` chain, as ``bench.py`` runs it);
  exact equality, integer task indices.
* ``scripts/bench_guard.py``, unchanged, reads a record of the port's
  coinop rows: it passes against itself and fails when a guarded row is
  20% worse.
* ``--device cuda`` without a card raises; ``scaling_curve_torch.py
  --plan-sweep`` forwards to the port's ``plan_bench``.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import bench_torch  # noqa: E402

_RUN = """
import json, sys
sys.path.insert(0, {root!r})
import bench_torch
rc = bench_torch.main(["--device", "cpu", "--rows", {rows!r}])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "adlb_tpu"))
print(json.dumps({{"rc": rc, "leaked": leaked}}))
"""


@pytest.fixture(scope="module")
def cpu_record(tmp_path_factory):
    """``bench_torch.main`` in a fresh process: the coinop rows and the
    device trickle (which plans every solve on the device path) on the
    CPU. Returns (record lines, the process's rc and leaked modules)."""
    proc = subprocess.run(
        [sys.executable, "-c", _RUN.format(root=str(ROOT),
                                           rows="coin_one,device_trickle")],
        capture_output=True, text=True, timeout=240, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    return lines[:-1], json.loads(lines[-1])


def test_a_run_loads_no_jax_and_no_reference(cpu_record):
    lines, tail = cpu_record
    assert tail == {"rc": 0, "leaked": []}
    full = json.loads(lines[-2])["detail"]
    planner = full["planner"]
    assert set(planner) == {"coin_one", "device_trickle"}
    trickle = planner["device_trickle"]
    assert trickle["device_solves"] > 0 and trickle["host_solves"] == 0
    assert trickle["greedy_sweep_launches"] == 0  # the plain version
    assert trickle["solves_checked"] >= trickle["device_solves"] // 8
    assert trickle["solves_wrong"] == 0
    assert full["platform"] == "cpu"
    assert full["trickle_dispatch_p50_ms_tpu_device_solve"] > 0


def _bench_py_compact_keys():
    """Keys of ``bench.py``'s ``compact`` dict literal, its ``detail`` and
    ``reps`` dicts."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "compact"
                for t in node.targets):
            top = node.value
            break
    else:
        raise AssertionError("no compact dict in bench.py")

    def keys(d):
        return {k.value: v for k, v in zip(d.keys, d.values)}

    top_keys = keys(top)
    detail = keys(top_keys["detail"])
    return set(top_keys), set(detail), set(keys(detail["reps"]))


def test_compact_line_has_every_key_of_bench_py(cpu_record):
    top, detail, reps = _bench_py_compact_keys()
    assert len(detail) > 60
    empty = bench_torch.compact_record({})
    assert top <= set(empty)
    assert detail <= set(empty["detail"])
    assert reps <= set(empty["detail"]["reps"])
    lines, _ = cpu_record
    line = lines[-1]
    assert len(line) <= 1900
    compact = json.loads(line)
    assert top <= set(compact) and detail - {"reps"} <= set(compact["detail"])
    assert compact["detail"]["pop_p50"][0] > 0


class _EveryKey(dict):
    """A record in which every key the compact line reads holds a float of
    five characters once rounded (the card's label for ``card``)."""

    def get(self, key, default=None):
        return "NVIDIA H100 80GB HBM3, 700.00 W" if key == "card" \
            else 12.3456789


def test_a_full_compact_line_stays_within_the_cap():
    line = bench_torch.compact_line(_EveryKey())
    assert len(line) <= 1900
    detail = json.loads(line)["detail"]
    assert detail["plan_round_1k_ms"] == 12.35
    assert "reps" not in detail and "card" not in detail


def test_solve_scale_equals_the_jax_solver():
    from adlb_tpu.balancer.solve import AssignmentSolver

    S, K, R = 2, 64, 16
    ref = AssignmentSolver(types=(1, 2, 3, 4), max_tasks=K, max_requesters=R,
                           backend="auto", host_threshold_reqs=0)
    want = ref.solve(bench_torch.scale_snapshots(S, K, R), None)
    got = bench_torch.solve_scale(S, K, R, reps=1, device="cpu")["pairs"]
    assert len(got) == S * R
    assert sorted(got) == sorted(want)


def test_solve_onchip_equals_the_pallas_kernel():
    import jax.numpy as jnp

    from adlb_tpu.balancer.pallas_solve import pallas_greedy_assign

    S, K, R = 2, 64, 16
    arrs = bench_torch.onchip_instance(S, K, R)
    want = np.asarray(pallas_greedy_assign(
        *(jnp.asarray(a) for a in arrs), interpret=True))
    r = bench_torch.solve_onchip(S, K, R, None, device="cpu")
    assert r["ms"] is None and r["checked"] == 2
    assert np.array_equal(r["assign"], want)
    assert (want >= 0).sum() > 0


def test_solve_chained_equals_the_pallas_chain():
    import jax
    import jax.numpy as jnp

    from adlb_tpu.balancer.pallas_solve import pallas_greedy_assign

    nt, nr, k = 256, 64, 3
    prio, ttype, mask, valid = (jnp.asarray(a) for a in
                                bench_torch.chain_instance(nt, nr))

    @jax.jit
    def chained(p):
        def step(p, _):
            out = pallas_greedy_assign(p, ttype, mask, valid, interpret=True)
            return p + (out[0] & 1).astype(p.dtype), out[0]
        _c, outs = jax.lax.scan(step, p, None, length=k)
        return outs

    want = [int(x) for x in np.asarray(chained(prio))]
    r = bench_torch.solve_chained(nt, nr, k1=2, k2=k, device="cpu")
    assert r["ms"] is None and r["checked"] == 4 and r["calls"] == 2 + k
    assert r["outs"] == want


def test_bench_guard_reads_a_port_record(cpu_record, tmp_path):
    lines, _ = cpu_record
    record = tmp_path / "record.json"
    record.write_text("\n".join(lines) + "\n")
    guard = [sys.executable, str(ROOT / "scripts" / "bench_guard.py")]
    ok = subprocess.run(guard + [str(record), "--baseline", str(record)],
                        capture_output=True, text=True, timeout=60)
    assert ok.returncode == 0, ok.stdout
    assert "pop_p50[steal]" in ok.stdout and "PASS" in ok.stdout
    compact = json.loads(lines[-1])
    compact["detail"]["pop_p50"] = [1.2 * x for x in
                                    compact["detail"]["pop_p50"]]
    worse = tmp_path / "worse.json"
    worse.write_text(json.dumps(compact))
    bad = subprocess.run(guard + [str(worse), "--baseline", str(record)],
                         capture_output=True, text=True, timeout=60)
    assert bad.returncode == 1, bad.stdout
    assert "REGRESSION" in bad.stdout


def test_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="needs a card"):
        bench_torch.main(["--device", "cuda", "--rows", "codec_bench"])


def test_unknown_rows_are_refused():
    with pytest.raises(SystemExit):
        bench_torch.main(["--device", "cpu", "--rows", "no_such_row"])


def test_plan_sweep_forwards_to_the_ports_plan_bench(monkeypatch):
    import scaling_curve_torch

    from adlb_tpu_torch.balancer import plan_bench

    seen = []
    monkeypatch.setattr(plan_bench, "main", lambda argv: seen.append(argv)
                        or 0)
    assert scaling_curve_torch.main(["--plan-sweep", "--quick",
                                     "--device", "cpu"]) == 0
    assert seen == [["--quick", "--device", "cpu"]]
