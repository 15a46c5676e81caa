"""Merge N per-rank chrome traces into ONE clock-aligned Perfetto file
(ref: the JAX package's ``tools/fleet_trace.py``; the port keeps its own
copy, which the supervisor's forensic bundle uses).

Each rank of a fleet dumps its own chrome trace (``MXTPU_PROFILE=on,
file=...`` or the kvstore remote profiler channel). Those files share no
clock: every tracer's ``ts`` counts microseconds from ITS OWN birth, on
ITS OWN host clock. The exporter therefore ships a ``clock_sync``
process-metadata event per trace — ``epoch_t0_s`` (the wall-clock second
at trace ts 0) and ``clock_offset_ms`` (this rank's wall clock minus
rank 0's, from the median-of-K round-trip handshake in
``telemetry.collective.sync_clocks``). This tool uses that pair to shift
every rank's events onto one shared timeline::

    python -m mxnet_tpu_torch.parallel.fleet_trace rank0.json rank1.json \
        -o merged.json [--report]

The merged file is ordinary chrome-trace JSON (validator-clean, loadable
in Perfetto — one process track per rank). ``--report`` prints the operator-facing skew tables:
per-rank step-entry skew (from the ``step:N`` markers) and
per-collective entry skew (matched kvstore ``comm`` spans), naming the
straggler rank — the same entry-time-minus-earliest attribution
``FitResult.comm_health`` reports live.

Pure stdlib on purpose — it must run on a laptop with nothing installed.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple


def load_trace(path: str) -> List[dict]:
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        events = payload.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError(f"{path}: no traceEvents array")
        return events
    if isinstance(payload, list):
        return payload
    raise ValueError(f"{path}: neither a trace object nor an event array")


def clock_anchor(events: List[dict]) -> Tuple[float, float]:
    """(epoch_t0_s, clock_offset_ms) from the trace's ``clock_sync``
    metadata; (0.0, 0.0) when absent (pre-anchor traces merge with no
    shift — same behavior as concatenation, nothing fabricated)."""
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "clock_sync":
            args = e.get("args") or {}
            return (float(args.get("epoch_t0_s", 0.0)),
                    float(args.get("clock_offset_ms", 0.0)))
    return 0.0, 0.0


def trace_pid(events: List[dict]) -> Optional[int]:
    for e in events:
        if "pid" in e:
            return int(e["pid"])
    return None


def merge(traces: List[List[dict]]) -> List[dict]:
    """Shift each trace onto the earliest rank's aligned clock and
    concatenate. The aligned birth of trace i is ``epoch_t0_s −
    clock_offset_s`` (its anchor expressed on rank 0's clock); the
    earliest aligned birth becomes merged ts 0, so every shifted ``ts``
    stays non-negative (the validator rejects negative 'X' starts).
    Colliding pids (two ranks launched without MXTPU_WORKER_ID) are
    re-numbered so Perfetto keeps one track per rank."""
    anchors = []
    for evs in traces:
        epoch0, off_ms = clock_anchor(evs)
        anchors.append(epoch0 - off_ms / 1e3)
    have_anchor = [a for a in anchors if a > 0]
    ref = min(have_anchor) if have_anchor else 0.0
    seen_pids: set = set()
    merged: List[dict] = []
    for evs, aligned in zip(traces, anchors):
        shift_us = (aligned - ref) * 1e6 if aligned > 0 else 0.0
        pid = trace_pid(evs)
        remap = None
        if pid is not None:
            if pid in seen_pids:
                remap = pid + 1
                while remap in seen_pids:
                    remap += 1
                seen_pids.add(remap)
            else:
                seen_pids.add(pid)
        for e in evs:
            out = dict(e)
            if remap is not None and "pid" in out:
                out["pid"] = remap
            # metadata events stay at ts 0 (per-process labels, not
            # timeline samples); everything else shifts onto the shared
            # clock
            if out.get("ph") != "M":
                out["ts"] = float(out.get("ts", 0.0)) + shift_us
            merged.append(out)
    return merged


# ---------------------------------------------------------------------------
# --report: per-rank step / collective skew
# ---------------------------------------------------------------------------

def _skew_rows(per_pid: Dict[int, Dict[Any, float]]) -> Dict[int, dict]:
    """Per-pid {mean_ms, max_ms, n} of entry-time lag behind the earliest
    pid, over the identities every pid saw — the same attribution
    ``telemetry.collective.compare_digests`` makes from the ledger."""
    pids = sorted(per_pid)
    common = None
    for p in pids:
        ks = set(per_pid[p])
        common = ks if common is None else common & ks
    common = common or set()
    lags: Dict[int, List[float]] = {p: [] for p in pids}
    for ident in common:
        ts = {p: per_pid[p][ident] for p in pids}
        mn = min(ts.values())
        for p, t in ts.items():
            lags[p].append((t - mn) / 1e3)  # µs -> ms
    return {p: {"mean_ms": round(sum(ls) / len(ls), 3) if ls else 0.0,
                "max_ms": round(max(ls), 3) if ls else 0.0,
                "n": len(ls)}
            for p, ls in lags.items()}


def report(merged: List[dict]) -> Dict[str, Any]:
    """The skew tables: per-rank step-marker entry skew and kvstore
    collective entry skew (+ the straggler rank by mean collective
    lag)."""
    steps: Dict[int, Dict[Any, float]] = defaultdict(dict)
    colls: Dict[int, Dict[Any, float]] = defaultdict(dict)
    occurrence: Dict[Tuple[int, str], int] = defaultdict(int)
    for e in merged:
        pid = e.get("pid")
        if pid is None or e.get("ph") == "M":
            continue
        if e.get("ph") == "i" and e.get("cat") == "step":
            steps[int(pid)].setdefault(e.get("name", ""), float(e["ts"]))
        elif e.get("ph", "X") == "X" and e.get("cat") == "comm":
            name = e.get("name", "")
            k = occurrence[(int(pid), name)]
            occurrence[(int(pid), name)] += 1
            # identity = (span name, k-th occurrence on that rank): the
            # per-key kv spans repeat every step, and both ranks issue
            # them in the same order unless desynced
            colls[int(pid)][(name, k)] = float(e["ts"])
    step_skew = _skew_rows(steps) if len(steps) > 1 else {}
    coll_skew = _skew_rows(colls) if len(colls) > 1 else {}
    straggler = None
    if coll_skew:
        worst = max(coll_skew, key=lambda p: coll_skew[p]["mean_ms"])
        if coll_skew[worst]["max_ms"] > 0:
            straggler = worst
    return {"ranks": sorted({int(e["pid"]) for e in merged
                             if "pid" in e and e.get("ph") != "M"}),
            "step_skew_ms": step_skew,
            "collective_skew_ms": coll_skew,
            "straggler_rank": straggler}


def _print_report(rep: Dict[str, Any]) -> None:
    print(f"== fleet: ranks {rep['ranks']} ==")
    for title, key in (("step entry skew", "step_skew_ms"),
                       ("collective entry skew", "collective_skew_ms")):
        rows = rep[key]
        if not rows:
            print(f"\n{title}: (needs >= 2 ranks with matching events)")
            continue
        print(f"\n{title} (lag behind earliest rank):")
        print(f"{'rank':>6} {'matched':>8} {'mean_ms':>9} {'max_ms':>9}")
        for pid in sorted(rows):
            r = rows[pid]
            print(f"{pid:>6} {r['n']:>8} {r['mean_ms']:>9.3f} "
                  f"{r['max_ms']:>9.3f}")
    if rep["straggler_rank"] is not None:
        print(f"\nstraggler: rank {rep['straggler_rank']} "
              "(largest mean collective entry lag)")
    else:
        print("\nno straggler detected")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Merge per-rank chrome traces into one clock-aligned "
                    "Perfetto file, with a per-rank skew report.")
    ap.add_argument("traces", nargs="+", help="per-rank chrome-trace files")
    ap.add_argument("-o", "--out", help="write the merged trace here")
    ap.add_argument("--report", action="store_true",
                    help="print per-rank step/collective skew tables")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON object")
    args = ap.parse_args(argv)
    try:
        traces = [load_trace(p) for p in args.traces]
    except (OSError, ValueError) as e:
        print(f"fleet_trace: {e}", file=sys.stderr)
        return 2
    merged = merge(traces)
    if args.out:
        payload = {"traceEvents": merged, "displayTimeUnit": "ms"}
        with open(args.out, "w") as f:
            json.dump(payload, f)
        if not (args.report or args.json):
            print(f"merged {len(args.traces)} trace(s), "
                  f"{len(merged)} events -> {args.out}")
    if args.report or args.json:
        rep = report(merged)
        if args.json:
            print(json.dumps(rep, indent=1, sort_keys=True))
        else:
            _print_report(rep)
    elif not args.out:
        print("fleet_trace: nothing to do (pass -o and/or --report)",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
