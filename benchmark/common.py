"""What every cell shares: the manifest and the files it names, the host's
spans, the reduction of a device trace, the per-layer readers and the
result line.

Imports neither JAX nor the JAX package nor the program: the cell modules import
the program (``adlb_tpu_torch``) inside their functions.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: modules that may not be loaded in a measured process, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "adlb_tpu")
#: the name of a module of the harness that a JSON file names
MODULE_NAME = re.compile(r"[a-z0-9_]+")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(manifest: dict, workload: str) -> tuple:
    """(cell, configuration entry) of ``workload``; KeyError if absent."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config_file(entry: dict, root: Path = ROOT) -> dict:
    return read_json(root / entry["file"])


def traffic_file(traffic: str) -> dict:
    """A traffic mix is ``traffic/<name>.json``."""
    return read_json(HERE / "traffic" / f"{traffic}.json")


def harness_module(name: str):
    """The harness's module ``benchmark/<name>.py``, imported, where
    ``name`` was read from a file: a cell's runner (``<kind>_cell``) or a
    traffic generator. Only ``[a-z0-9_]+`` is taken, so no name leads out
    of ``benchmark/``; a name refused or a file missing raises an error
    that names the file."""
    path = f"{HERE.name}/{name}.py"
    if not isinstance(name, str) or not MODULE_NAME.fullmatch(name):
        raise ValueError(f"{path}: {name!r} is not a name of the harness's "
                         f"modules ([a-z0-9_]+)")
    if not (HERE / f"{name}.py").is_file():
        raise FileNotFoundError(f"{path}: no such file in the harness")
    return importlib.import_module(f"{HERE.name}.{name}")


def metric_reader(name: str):
    """A per-layer metric is ``metrics/<name>.py`` with ``read(run)``: the
    metric's value from the run's records, or None where it finds nothing
    to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    out = []
    for m in manifest[kind]:
        if "workloads" not in m or workload in m["workloads"]:
            out.append(m)
    return out


def use_checkout_caches() -> None:
    """Build and kernel caches inside the checkout, at fixed paths, so only
    the first run of a checkout builds. The program's own kernels build
    into ``adlb_tpu_torch/_build/``, inside the checkout too."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


class Spans:
    """Host spans the harness records around its calls into the program:
    (label, start, end) on ``time.perf_counter``, from any thread. Off
    unless the run is traced."""

    def __init__(self, on: bool) -> None:
        self.on = on
        self.items: list = []

    def span(self, label: str, t0: float, t1: float) -> None:
        if self.on:
            self.items.append((label, t0, t1))


class DeviceTrace:
    """``torch.profiler`` over the window: CUDA activity, and with ``host``
    the host thread that starts it too, which records one marker that ties
    the trace's clock to ``time.perf_counter``. Started and stopped on one
    thread, before and after the window. :meth:`reduce` reads the window
    alone and names its idle gaps (``host``); :meth:`busy` reads the card's
    busy time over all of the trace, which holds the window alone: the
    profiler starts once the warm-up has landed and stops once the
    window's last round has."""

    def __init__(self, tmpdir: str, host: bool = True) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.host = host
        self.path = os.path.join(tmpdir, f"bench_trace_{os.getpid()}.json")
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA] if host
                            else [ProfilerActivity.CUDA])
        self.t_mark = None

    def start(self) -> None:
        self.prof.start()
        if self.host:
            with self.torch.profiler.record_function("bench_clock_mark"):
                self.t_mark = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.stop()

    def _events(self) -> list:
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(self.path)

    def busy(self) -> dict:
        """The card's busy seconds over the trace (the union of its
        kernels', copies' and sets' intervals) and its operations."""
        dev = device_events(self._events())
        return {"busy_s": union_seconds(
            (float(e["ts"]) * 1e-6,
             (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6) for e in dev),
            "ops": len(dev)}

    def reduce(self, spans: list, lo: float, hi: float) -> dict:
        """busy_s and window_s of the window [lo, hi] (perf_counter), its
        per-kernel device seconds and launches, and its longest idle gaps
        named by the innermost host span over them."""
        events = self._events()
        mark = [e for e in events if e.get("name") == "bench_clock_mark"
                and e.get("ph") == "X"]
        dev = device_events(events)
        window_s = hi - lo
        if not mark:
            raise RuntimeError("the profiler's trace lacks the clock mark")
        # trace microseconds -> perf_counter seconds
        off = self.t_mark - float(mark[0]["ts"]) * 1e-6
        ivs = sorted(((float(e["ts"]) * 1e-6 + off,
                       (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6
                       + off, e) for e in dev), key=lambda x: x[:2])
        busy, cur_s, cur_e = 0.0, None, None
        gaps = []
        prev_end = lo
        by_name: dict = {}
        for s, e, ev in ivs:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            name = ev.get("name", "?")
            tot, cnt = by_name.get(name, (0.0, 0))
            by_name[name] = (tot + (e - s), cnt + 1)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                if s > prev_end:
                    gaps.append((prev_end, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            prev_end = max(prev_end, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        if hi > prev_end:
            gaps.append((prev_end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[gap_label(spans, g0, g1), g1 - g0] for g0, g1 in gaps[:10]]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        return {"busy_s": busy, "window_s": window_s, "kernels": by_name,
                "device_ops": [[short(n), v[0]] for n, v in ops[:10]],
                "idle_gaps": named}


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def device_events(events: list) -> list:
    """The card's operations among a Chrome trace's events."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in
            ("kernel", "gpu_memcpy", "gpu_memset")]


def gap_label(spans: list, g0: float, g1: float) -> str:
    """The innermost host span over the gap's middle, else what was left."""
    mid = 0.5 * (g0 + g1)
    best = None
    for label, s, e in spans:
        if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, label)
    return best[2] if best else "host (no span)"


def short(name: str) -> str:
    out = "".join(c if c.isalnum() or c in "_.-" else "_" for c in name)
    return out[:64]


def kernel_seconds(trace: dict, needle: str) -> tuple:
    """(device seconds, launches) of the kernels whose name holds
    ``needle``."""
    sec, n = 0.0, 0
    for name, (tot, cnt) in trace["kernels"].items():
        if needle in name:
            sec += tot
            n += cnt
    return sec, n


def program_spans(run: dict, name: str):
    """The program's spans called ``name`` in the window, as (seconds,
    args); None where the run kept no program spans or none of that
    name."""
    found = [(t1 - t0, args) for n, t0, t1, args in
             run.get("program_spans") or () if n == name]
    return found or None


def span_ms(run: dict, name: str):
    """Milliseconds a round in the program's spans called ``name``: their
    sum over the window's rounds (a phase that a round skips counts 0
    there); None where there is no such span."""
    found = program_spans(run, name)
    if found is None or not run.get("rounds"):
        return None
    return 1e3 * sum(sec for sec, _ in found) / len(run["rounds"])


def percentile(values, q: float) -> float:
    """The q-th percentile by the nearest rank: the smallest value with at
    least q% of the values at or below it."""
    v = sorted(values)
    k = max(int(math.ceil(q / 100.0 * len(v))) - 1, 0)
    return v[min(k, len(v) - 1)]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, compared: dict, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return json.dumps(out)


def report_compared(compared: dict) -> None:
    """Each number compared beside its limit: the last lines on stderr."""
    for name, c in compared.items():
        print(f"compared {name} {c['value']} limit {c['limit']} "
              f"({c['rule']})", file=sys.stderr, flush=True)


def compare(values: dict) -> tuple:
    """{name: (value, limit, rule)} -> (all within, the result's key).
    ``rule`` is "<=" (at most the limit) or ">=" (at least)."""
    out, ok = {}, True
    for name, (value, limit, rule) in values.items():
        good = value <= limit if rule == "<=" else value >= limit
        ok &= bool(good)
        out[name] = {"value": value, "limit": limit, "rule": rule}
    return ok, out
