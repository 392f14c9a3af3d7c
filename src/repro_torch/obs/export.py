"""Chrome / Perfetto ``trace_event`` JSON export for decoded traces.

Port of ``repro.obs.export`` (``src/repro/obs/export.py``), copied as it
is: json only, reading the port's
:class:`~repro_torch.obs.trace.TraceRecords`.

Renders :class:`~repro_torch.obs.trace.TraceRecords` as complete-duration
(``ph="X"``) slices — one per station visit, plus one ``mshr_park``
slice per delayed hit — in the JSON object format Perfetto and
``chrome://tracing`` both accept.  Timestamps are microseconds, matching
the simulators' absolute ``elapsed_us`` clock, so slice positions are
the simulation timeline verbatim.

Stations map to Perfetto "threads" (one lane per station) inside a
single "process" (one simulated node/lane); request id, branch and
sojourn class ride along in ``args`` for querying.
"""

from __future__ import annotations

import json

from repro_torch.obs.trace import CLASS_NAMES, TraceRecords


def to_perfetto(
    trace: TraceRecords,
    station_names=None,
    pid: int = 0,
    process_name: str = "repro-sim",
) -> dict:
    """Render a trace as a ``{"traceEvents": [...]}`` Perfetto object."""
    events: list[dict] = []
    events.append(
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": process_name},
        }
    )
    seen_tids = set()

    def thread_meta(tid: int, name: str) -> None:
        if tid in seen_tids:
            return
        seen_tids.add(tid)
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
        )

    n = len(trace)
    for i in range(n):
        nvis = int(trace.nvis[i])
        cls = int(trace.cls[i])
        args = {
            "req": int(trace.req[i]),
            "branch": int(trace.branch[i]),
            "cls": CLASS_NAMES.get(cls, str(cls)),
        }
        for v in range(nvis):
            st = int(trace.station[i, v])
            tid = st if st >= 0 else 10_000 + v
            if station_names is not None and 0 <= st < len(station_names):
                thread_meta(tid, str(station_names[st]))
            else:
                thread_meta(tid, f"station-{tid}")
            ts = float(trace.enter_us[i, v])
            dur = float(trace.leave_us[i, v]) - ts
            events.append(
                {
                    "name": (
                        str(station_names[st])
                        if station_names is not None
                        and 0 <= st < len(station_names)
                        else f"visit-{v}"
                    ),
                    "cat": "visit",
                    "ph": "X",
                    "pid": pid,
                    "tid": tid,
                    "ts": ts,
                    "dur": max(dur, 0.0),
                    "args": args,
                }
            )
        parked_us = float(trace.parked_us[i])
        if parked_us > 0.0 and nvis > 0:
            # The park interval is the tail of the last (park) visit.
            st = int(trace.station[i, nvis - 1])
            tid = st if st >= 0 else 10_000 + nvis - 1
            end = float(trace.leave_us[i, nvis - 1])
            events.append(
                {
                    "name": "mshr_park",
                    "cat": "mshr",
                    "ph": "X",
                    "pid": pid,
                    "tid": tid,
                    "ts": end - parked_us,
                    "dur": parked_us,
                    "args": args,
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(path, trace: TraceRecords, station_names=None, **kw) -> dict:
    obj = to_perfetto(trace, station_names=station_names, **kw)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return obj


def read_perfetto(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def summarize_events(obj: dict) -> dict:
    """Round-trip check summary: slice counts/durations by category & class."""
    slices = [e for e in obj.get("traceEvents", []) if e.get("ph") == "X"]
    by_cat: dict[str, int] = {}
    by_cls: dict[str, int] = {}
    total_dur_us = 0.0
    reqs = set()
    for e in slices:
        by_cat[e.get("cat", "?")] = by_cat.get(e.get("cat", "?"), 0) + 1
        total_dur_us += float(e.get("dur", 0.0))
        args = e.get("args", {})
        if "req" in args:
            reqs.add(int(args["req"]))
        if e.get("cat") == "visit" and "cls" in args:
            by_cls[args["cls"]] = by_cls.get(args["cls"], 0)
    # Count classes once per request, not per slice.
    cls_per_req: dict[int, str] = {}
    for e in slices:
        args = e.get("args", {})
        if e.get("cat") == "visit" and "req" in args and "cls" in args:
            cls_per_req[int(args["req"])] = args["cls"]
    for c in by_cls:
        by_cls[c] = sum(1 for v in cls_per_req.values() if v == c)
    return {
        "slices_count": len(slices),
        "requests_count": len(reqs),
        "total_dur_us": total_dur_us,
        "by_cat_count": by_cat,
        "by_cls_count": by_cls,
    }
