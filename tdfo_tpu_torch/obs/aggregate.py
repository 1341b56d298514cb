"""Offline assembler over the trace sinks — port of
``tdfo_tpu/obs/aggregate.py`` (pure Python, the reference's logic).

* ``load_spans(dir)`` reads every ``trace-*.jsonl`` sink (the rotated
  ``.1`` generation first), skipping a torn tail a live writer may leave;
* ``assemble(spans)`` folds them into per-cycle records and fleet-wide
  latency aggregates (p50/p99 per cohort and per replica);
* ``chrome_trace(spans)`` exports Chrome-trace / Perfetto JSON;
* ``percentile(samples, q)`` is the nearest-rank percentile the load
  generator and the fleet reports share;
* ``format_report(report)`` renders a report as text.

``launch obs`` (``launch.py``) prints the report and writes the Chrome
trace beside the sinks.
"""

from __future__ import annotations

import json
import math
from pathlib import Path


def load_spans(trace_dir: str | Path) -> list[dict]:
    """Read every ``trace-*.jsonl`` sink (rotated ``.1`` generation first,
    the ``utils/logrotate`` naming) and return spans sorted by wall ``ts``
    then span id.  Unparseable tails (a live writer mid-append) are
    skipped, never guessed at."""
    root = Path(trace_dir)
    spans: list[dict] = []
    for path in sorted(root.glob("trace-*.jsonl.1")) + \
            sorted(root.glob("trace-*.jsonl")):
        for line in path.read_text().splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail of a live sink
            if isinstance(rec, dict):
                spans.append(rec)
    spans.sort(key=lambda r: (r.get("ts", 0.0), r.get("span", 0)))
    return spans


def percentile(samples, q: float) -> float | None:
    """Nearest-rank percentile (``q`` in [0, 100]); ``None`` when empty.

    The single definition shared by the offline histograms and the online
    ``max_p99_regression_ms`` canary verdict."""
    if not samples:
        return None
    s = sorted(float(v) for v in samples)
    k = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
    return s[k]


def _consumed_keys(consumed) -> list[tuple[int, int]]:
    """Normalise consumed span tuples to ``(replica, seq)`` join keys.

    Merged (fleet) consumers record 4-tuples ``(replica, seq, lo, hi)``;
    the flat single-log consumer records 3-tuples ``(seq, lo, hi)`` and
    maps to replica 0 (the only writer in that layout)."""
    keys = []
    for entry in consumed or []:
        e = list(entry)
        keys.append((int(e[0]), int(e[1])) if len(e) == 4 else (0, int(e[0])))
    return keys


def assemble(spans: list[dict]) -> dict:
    """Join the component sinks into per-cycle timelines + fleet stats."""
    cycle_spans: dict[int, dict] = {}
    stage_spans: dict[tuple[int, str], dict] = {}
    requests: dict[tuple[int, int], dict] = {}
    flips: list[dict] = []
    syncs: list[dict] = []
    heartbeats: list[dict] = []
    replays: list[dict] = []
    ingress_reqs: list[dict] = []
    loadgen_steps: list[dict] = []
    for s in spans:
        kind = s.get("kind")
        if kind == "online_cycle":
            # last durable emission wins: an interrupted cycle never emitted
            # a span, so the redo after restart is the one-and-only record
            cycle_spans[int(s["cycle"])] = s
        elif kind == "stage":
            stage_spans[(int(s["cycle"]), str(s["stage"]))] = s
        elif kind == "serve_request":
            requests[(int(s["replica"]), int(s["seq"]))] = s
        elif kind == "pointer_flip":
            flips.append(s)
        elif kind == "replica_sync":
            syncs.append(s)
        elif kind == "heartbeat":
            heartbeats.append(s)
        elif kind == "replay_batch":
            replays.append(s)
        elif kind == "ingress_request":
            # process-fleet path: latencies measured at the socket ingress
            # (submit stamp -> reply receipt), shed replies carry no latency
            ingress_reqs.append(s)
        elif kind == "loadgen_step":
            loadgen_steps.append(s)

    cycles = []
    seen_keys: dict[tuple[int, int], int] = {}
    for cyc in sorted(cycle_spans):
        s = cycle_spans[cyc]
        # distinct join keys: one request may contribute several row
        # ranges to a cycle (the consumer drains it in pieces)
        keys = sorted(set(_consumed_keys(s.get("consumed"))))
        for k in keys:
            seen_keys.setdefault(k, cyc)
        stages = {st: round(float(sp.get("dur_ms", 0.0)), 3)
                  for (c, st), sp in sorted(stage_spans.items()) if c == cyc}
        # freshness lag: oldest contributing request logged -> the produced
        # version first live on a replica (promote flip, else first sync)
        lag_s = None
        req_ts = [requests[k]["ts"] for k in keys if k in requests]
        if req_ts and s.get("verdict") == "promote":
            ver = s.get("version")
            live = [f["ts"] for f in flips
                    if f.get("op") == "promote" and f.get("version") == ver]
            live += [y["ts"] for y in syncs if y.get("version") == ver]
            if live:
                lag_s = round(min(live) - min(req_ts), 3)
        cycles.append({
            "cycle": cyc,
            "verdict": s.get("verdict"),
            "reason": s.get("reason"),
            "version": s.get("version"),
            "digest": s.get("digest"),
            "steps": [s.get("step_begin"), s.get("step_end")],
            "dur_ms": s.get("dur_ms"),
            "stages": stages,
            "consumed_keys": keys,
            "n_consumed_requests": len(keys),
            "n_traced_requests": sum(1 for k in keys if k in requests),
            "freshness_lag_s": lag_s,
        })

    def _lat(samples):
        return {"n": len(samples),
                "p50_ms": percentile(samples, 50),
                "p99_ms": percentile(samples, 99)}

    req_ms = [s["latency_ms"] for s in requests.values()
              if s.get("latency_ms") is not None]
    hb_ms = [s["ms"] for s in heartbeats if s.get("ms") is not None]
    per_replica = {}
    for s in heartbeats:
        per_replica.setdefault(int(s["replica"]), []).append(s)
    fleet = {
        "requests": _lat(req_ms),
        "heartbeats": _lat(hb_ms),
        "canary_heartbeats": _lat([s["ms"] for s in heartbeats
                                   if s.get("canary")]),
        "stable_heartbeats": _lat([s["ms"] for s in heartbeats
                                   if not s.get("canary")]),
        "per_replica": {
            rid: {**_lat([s["ms"] for s in ss]),
                  "last_queue_depth": ss[-1].get("queue_depth"),
                  "last_batch_fill": ss[-1].get("batch_fill")}
            for rid, ss in sorted(per_replica.items())
        },
    }
    if ingress_reqs:
        fleet["ingress"] = {
            **_lat([s["latency_ms"] for s in ingress_reqs
                    if not s.get("shed")]),
            "shed": sum(1 for s in ingress_reqs if s.get("shed")),
        }
    out_loadgen = [{k: s.get(k) for k in
                    ("mode", "offered", "concurrency", "offered_qps",
                     "completed", "achieved_qps", "p50_ms", "p99_ms",
                     "shed", "failed", "slo_ok")}
                   for s in loadgen_steps]
    return {
        "cycles": cycles,
        "fleet": fleet,
        "pointer_flips": [{k: f.get(k) for k in
                           ("ts", "op", "pointer", "version", "digest")}
                          for f in flips],
        "n_spans": len(spans),
        "n_requests": len(requests),
        "n_replay_batches": len(replays),
        "loadgen": out_loadgen,
    }


_PH_INSTANT = "i"


def chrome_trace(spans: list[dict]) -> dict:
    """Spans as a Chrome-trace JSON object (``chrome://tracing`` /
    Perfetto).  Components map to pids, replicas (where present) to tids;
    timed spans (``dur_ms``) become complete ``X`` events anchored at
    their start, the rest become instants."""
    components = sorted({s.get("component", "?") for s in spans})
    pid = {c: i + 1 for i, c in enumerate(components)}
    events = [{"name": "process_name", "ph": "M", "pid": pid[c], "tid": 0,
               "args": {"name": c}} for c in components]
    t0 = min((s.get("ts", 0.0) for s in spans), default=0.0)
    for s in spans:
        comp = s.get("component", "?")
        dur_ms = s.get("dur_ms")
        ts_us = (s.get("ts", t0) - t0) * 1e6
        name = s.get("kind", "span")
        if name == "stage":
            name = f"stage:{s.get('stage')}"
        elif "cycle" in s:
            name = f"{name}:c{s.get('cycle')}"
        args = {k: v for k, v in s.items()
                if k not in ("ts", "component", "span") and v is not None
                and isinstance(v, (int, float, str, bool))}
        ev = {"name": name, "cat": comp, "pid": pid[comp],
              "tid": int(s.get("replica", 0) or 0), "args": args}
        if dur_ms is not None:
            ev.update(ph="X", ts=ts_us - dur_ms * 1e3, dur=dur_ms * 1e3)
        else:
            ev.update(ph=_PH_INSTANT, ts=ts_us, s="p")
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def format_report(report: dict) -> str:
    """Human-readable timeline summary for the ``launch.py obs`` console."""
    lines = [f"spans: {report['n_spans']}  requests: {report['n_requests']}"
             f"  replay batches: {report['n_replay_batches']}"]
    for c in report["cycles"]:
        stages = "  ".join(f"{k}={v:.1f}ms" for k, v in c["stages"].items())
        lag = (f"  freshness_lag={c['freshness_lag_s']:.3f}s"
               if c["freshness_lag_s"] is not None else "")
        lines.append(
            f"cycle {c['cycle']}: verdict={c['verdict']} "
            f"version={c['version']} steps={c['steps'][0]}->{c['steps'][1]} "
            f"consumed={c['n_consumed_requests']} requests{lag}")
        if stages:
            lines.append(f"  {stages}")
    fl = report["fleet"]
    for label in ("requests", "heartbeats", "canary_heartbeats",
                  "stable_heartbeats"):
        d = fl[label]
        if d["n"]:
            lines.append(f"{label}: n={d['n']} p50={d['p50_ms']:.2f}ms "
                         f"p99={d['p99_ms']:.2f}ms")
    for rid, d in fl["per_replica"].items():
        lines.append(f"replica {rid}: n={d['n']} p50={d['p50_ms']:.2f}ms "
                     f"p99={d['p99_ms']:.2f}ms "
                     f"queue_depth={d['last_queue_depth']} "
                     f"batch_fill={d['last_batch_fill']}")
    ing = fl.get("ingress")
    if ing and ing["n"]:
        lines.append(f"ingress: n={ing['n']} p50={ing['p50_ms']:.2f}ms "
                     f"p99={ing['p99_ms']:.2f}ms shed={ing['shed']}")
    for s in report.get("loadgen", ()):
        axis = (f"conc={s['concurrency']}" if s["mode"] == "closed"
                else f"rate={s['offered_qps']:.1f}qps")
        p99 = "-" if s["p99_ms"] is None else f"{s['p99_ms']:.2f}ms"
        lines.append(
            f"loadgen {s['mode']} {axis}: qps={s['achieved_qps']:.1f} "
            f"p99={p99} shed={s['shed']} failed={s['failed']} "
            f"slo_ok={s['slo_ok']}")
    return "\n".join(lines)
