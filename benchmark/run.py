"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell, its configuration and its traffic are found by name through
``BENCHMARK.json``. The configuration file's ``"kind": K`` names the module
that runs the cell, ``benchmark/<K>_cell.py``, which provides
``run(conf, traffic, seed, seconds, trace, t_process, device=, log=,
**hooks)`` (the run's record), ``compared(run)`` (the numbers that decide
``correct``: name -> (value, limit, rule)), ``end_to_end(run)``,
``counts(run)`` ((attempted, failed)), ``summary(run)`` (a line for the
log) and ``control(shift)`` (the hooks that put the control in the
program's place, for ``control.py``); so a new kind of cell is a new file
and its entries, with no edit here.

Set-up builds everything from the seed and warms the cell's own shapes;
the window then runs for ``--seconds``; once it has closed, what the
program produced is held against the plain reference (``reference.py``).
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a device trace of the
window and the run's records by ``metrics/<name>.py``. The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common  # noqa: E402


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def cell_module(kind: str):
    """The module that runs a configuration of ``kind``:
    ``benchmark/<kind>_cell.py``."""
    return common.harness_module(f"{kind}_cell")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float = None,
             manifest: dict = None, conf_patch: dict = None,
             traffic_patch: dict = None, **hooks) -> dict:
    """Run the cell and assemble its result (the line's object, plus the
    run's record under ``"run"`` and its log line under ``"summary"``).
    ``device="cpu"``, the patches (sizes for a test) and ``hooks`` serve the
    tests: the command line always runs the files as they are, on the
    card."""
    manifest = manifest or common.load_manifest()
    cell, entry = common.find_cell(manifest, workload)
    conf = {**common.config_file(entry), **(conf_patch or {})}
    traffic = {**common.traffic_file(cell["traffic"]),
               **(traffic_patch or {})}
    if conf["kind"] != traffic["kind"]:
        raise ValueError(f"{workload}: a {traffic['kind']} traffic on a "
                         f"{conf['kind']} configuration")
    mod = cell_module(conf["kind"])
    run = mod.run(conf, traffic, seed, seconds, trace,
                  T_PROCESS if t_process is None else t_process,
                  device=device, log=log, **hooks)
    ok, compared = common.compare(mod.compared(run))
    if trace:
        metrics = {}
        for m in common.cell_metrics(manifest, workload, "per_layer"):
            v = common.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = mod.end_to_end(run)
        e2e["setup_s"] = run["setup_s"]
        metrics = {}
        for m in common.cell_metrics(manifest, workload, "end_to_end"):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": device_name(device), "count": int(cell["chips"]),
           "memory_peak_bytes": int(run["memory_peak_bytes"])}
    breakdown = None
    if trace and run["trace"] is not None:
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
        breakdown = {"device_ops": run["trace"]["device_ops"],
                     "idle_gaps": run["trace"]["idle_gaps"]}
    attempted, failed = mod.counts(run)
    return {"correct": ok, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev, "breakdown": breakdown,
            "compared": compared, "run": run, "summary": mod.summary(run)}


def device_name(device: str) -> str:
    if device != "cuda":
        return device
    import torch

    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.use_checkout_caches()
    manifest = common.load_manifest()
    cell, _ = common.find_cell(manifest, args.workload)
    import torch

    log(f"set-up: torch imported at {time.perf_counter() - T_PROCESS:.3f} s")
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   manifest=manifest)
    bad = common.forbidden_loaded()
    if bad:
        log(f"modules that may not be loaded: {', '.join(bad)}")
        return 3
    run = out.pop("run")
    log(f"{args.workload} seed {args.seed}: setup {run['setup_s']:.3f} s, "
        f"window {run['window_s']:.3f} s, reference "
        f"{run['reference_s']:.3f} s; {out['summary']}")
    common.report_compared(out["compared"])
    print(common.result_line(out["correct"], out["attempted"], out["failed"],
                             out["metrics"], out["device"],
                             out["compared"], out["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
