#!/usr/bin/env python3
"""Offline decoder for STAT_APS periodic-stats log lines of the PyTorch
port (``adlb_tpu_torch``): ``scripts/get_stats.py`` with its import
rewritten to the port. It reads logs and runs no world.

The rebuild's equivalent of the reference's ``scripts/get_stats.py:1-117``:
reads one or more log files (or stdin), reassembles the chunked ``STAT_APS:``
lines the master server prints every ``periodic_log_interval`` seconds, and
prints a per-period activity table (queue depths by type, waiting requesters,
put/resolved-reserve rates).

Usage:  python scripts/get_stats_torch.py [logfile ...]   (no args = stdin)
        python scripts/get_stats_torch.py --json logfile  (raw records as JSON)
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from adlb_tpu_torch.runtime.stats import parse_stat_lines, summarize  # noqa: E402


def main(argv: list[str]) -> int:
    as_json = "--json" in argv
    paths = [a for a in argv if not a.startswith("-")]
    # parse and summarize each file independently: seq numbers and cumulative
    # counters restart per run, so records must never mix across files
    groups: list[list[dict]] = []
    if paths:
        for p in paths:
            groups.append(parse_stat_lines(Path(p).read_text().splitlines()))
    else:
        groups.append(parse_stat_lines(sys.stdin.read().splitlines()))
    if not any(groups):
        print("no STAT_APS records found", file=sys.stderr)
        return 1
    if as_json:
        for records in groups:
            for r in records:
                print(json.dumps(r))
        return 0

    rows: list[dict] = []
    for records in groups:
        rows.extend(summarize(records))
    hdr = f"{'seq':>5} {'wq':>7} {'rq':>5} {'KB':>8} {'puts/s':>9} {'res/s':>9} {'trip_ms':>8}  by_type"
    print(hdr)
    print("-" * len(hdr))
    for row in rows:
        by_type = " ".join(
            f"t{t}:{c['untargeted']}u/{c['targeted']}t"
            for t, c in row["by_type"].items()
        )
        print(
            f"{row['seq']:>5} {row['wq_total']:>7} {row['rq_total']:>5} "
            f"{row['nbytes'] / 1024:>8.1f} "
            f"{row.get('puts_per_s', float('nan')):>9.1f} "
            f"{row.get('resolved_per_s', float('nan')):>9.1f} "
            f"{row['trip_s'] * 1e3:>8.2f}  {by_type}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
