"""Exporters: JSONL event logs and Chrome/Perfetto ``trace_event`` traces
(a copy of ``repro/obs/export.py``; the schema tag is the reference's, so
one log reads in either package).

JSONL is the durable format (one flat JSON object per line, ``seq``/
``t``/``type`` envelope + event fields, closed by one ``metrics.summary``
record) -- ``python -m repro_torch.obs.report`` replays it into a decision
trace, and ``perfetto_trace`` converts it into a JSON trace that loads
in https://ui.perfetto.dev:

  * pid 1, "tuner + tiering (step domain)": one thread per tuner whose
    PROFILE/TRIAL/HOLD phases render as named spans (ts = step, 1 step
    = 1 us), one thread per tiering manager whose inter-tier windows
    render as ``window(p=N)`` spans, plus a ``period`` counter track.
  * pid 2, "serving (wall clock)": macro-step launches and admission
    batches as duration spans at their measured wall times, plus a
    ``queue_depth`` counter track.

Guard trips / window extensions / retirements are instant events on
their thread, so a poisoned sweep is visible as markers inside the TRIAL
span that aborts it.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.obs.telemetry import Recorder

__all__ = ["write_jsonl", "read_jsonl", "perfetto_trace", "write_perfetto"]

SCHEMA = "repro-obs/v1"


def write_jsonl(path, recorder: Recorder) -> pathlib.Path:
    """Dump the recorder's event ring (oldest surviving event first) plus
    a closing ``metrics.summary`` record to ``path``."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        for ev in recorder.events():
            f.write(json.dumps(ev, default=float) + "\n")
        f.write(json.dumps({"type": "metrics.summary", "schema": SCHEMA,
                            **recorder.summary()}, default=float) + "\n")
    return path


def read_jsonl(path) -> List[Dict[str, Any]]:
    out = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# Perfetto / chrome://tracing trace_event export
# ---------------------------------------------------------------------------

_STEP_PID, _WALL_PID = 1, 2


def _meta(pid: int, tid: Optional[int], name: str) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "ph": "M", "pid": pid,
        "name": "thread_name" if tid is not None else "process_name",
        "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _tids(events: Sequence[dict], key: str) -> Dict[str, int]:
    """Stable small thread ids for each distinct emitter (tuner/manager)."""
    ids: Dict[str, int] = {}
    for ev in events:
        who = str(ev.get(key, "?"))
        if who not in ids:
            ids[who] = len(ids) + 1
    return ids


def perfetto_trace(events: Iterable[dict]) -> Dict[str, Any]:
    """Convert a JSONL event stream (``read_jsonl`` output or
    ``Recorder.events()``) into a ``trace_event`` JSON dict."""
    events = [e for e in events if e.get("type") != "metrics.summary"]
    te: List[Dict[str, Any]] = [
        _meta(_STEP_PID, None, "tuner + tiering (step domain)"),
        _meta(_WALL_PID, None, "serving (wall clock)"),
    ]

    tuner_tids = _tids([e for e in events
                        if e["type"].startswith("tuner.")], "tuner")
    mgr_tids = {m: 100 + i for m, i in _tids(
        [e for e in events if e["type"] == "tier.move"], "manager").items()}
    for who, tid in tuner_tids.items():
        te.append(_meta(_STEP_PID, tid, f"tuner {who}"))
    for who, tid in mgr_tids.items():
        te.append(_meta(_STEP_PID, tid, f"tiering {who}"))
    te.append(_meta(_WALL_PID, 1, "scheduler"))

    # -- tuner phase spans: each transition closes the previous phase -------
    open_phase: Dict[str, tuple] = {}        # tuner -> (state, since_step)
    last_step: Dict[str, int] = {}
    for ev in events:
        typ = ev["type"]
        if not typ.startswith("tuner."):
            continue
        who = str(ev.get("tuner", "?"))
        tid = tuner_tids[who]
        step = int(ev.get("step", last_step.get(who, 0)))
        last_step[who] = step
        if typ == "tuner.transition":
            frm, to = ev.get("frm", "?"), ev.get("to", "?")
            if who in open_phase:
                state, since = open_phase[who]
                te.append({"name": state.upper(), "ph": "X", "ts": since,
                           "dur": max(1, step - since), "pid": _STEP_PID,
                           "tid": tid, "args": {"closed_by": ev["reason"]}})
            elif step > 0:
                # log started mid-run: render the unobserved prefix
                te.append({"name": frm.upper(), "ph": "X", "ts": 0,
                           "dur": step, "pid": _STEP_PID, "tid": tid,
                           "args": {"closed_by": ev["reason"]}})
            open_phase[who] = (to, step)
            args = {k: v for k, v in ev.items()
                    if k not in ("seq", "t", "type", "tuner")}
            te.append({"name": f"-> {to.upper()} [{ev['reason']}]",
                       "ph": "i", "ts": step, "pid": _STEP_PID, "tid": tid,
                       "s": "t", "args": args})
        elif typ == "tuner.period":
            te.append({"name": f"period[{who}]", "ph": "C", "ts": step,
                       "pid": _STEP_PID,
                       "args": {"period": ev.get("period", 0)}})
        elif typ in ("tuner.guard", "tuner.extend", "tuner.trial",
                     "tuner.baseline"):
            args = {k: v for k, v in ev.items()
                    if k not in ("seq", "t", "type", "tuner")}
            name = {"tuner.guard": "guard "
                    + str(ev.get("verdict", "trip")),
                    "tuner.extend": "window extend",
                    "tuner.trial": f"trial p={ev.get('period')}",
                    "tuner.baseline": "baseline"}[typ]
            te.append({"name": name, "ph": "i", "ts": step, "pid": _STEP_PID,
                       "tid": tid, "s": "t", "args": args})
    for who, (state, since) in open_phase.items():
        end = last_step.get(who, since) + 1
        te.append({"name": state.upper(), "ph": "X", "ts": since,
                   "dur": max(1, end - since), "pid": _STEP_PID,
                   "tid": tuner_tids[who], "args": {"closed_by": "eof"}})

    # -- tiering windows: a span between consecutive tier boundaries --------
    last_tier: Dict[str, int] = {}
    for ev in events:
        if ev["type"] != "tier.move":
            continue
        who = str(ev.get("manager", "?"))
        step = int(ev.get("step", 0))
        since = last_tier.get(who, max(0, step - int(ev.get("period", 1))))
        te.append({"name": f"window(p={ev.get('period')})", "ph": "X",
                   "ts": since, "dur": max(1, step - since),
                   "pid": _STEP_PID, "tid": mgr_tids[who],
                   "args": {"promoted": ev.get("promoted"),
                            "evicted": ev.get("evicted"),
                            "pages_moved": ev.get("pages_moved")}})
        last_tier[who] = step

    # -- serving spans (wall clock, us) --------------------------------------
    for ev in events:
        typ = ev["type"]
        ts = float(ev.get("t", 0.0)) * 1e6
        if typ in ("serve.macro", "serve.admit"):
            dur = max(1.0, float(ev.get("wall_ms", 0.0)) * 1e3)
            name = (f"macro x{ev.get('n_steps')}" if typ == "serve.macro"
                    else f"admit x{ev.get('joiners')}")
            args = {k: v for k, v in ev.items()
                    if k not in ("seq", "t", "type")}
            te.append({"name": name, "ph": "X", "ts": ts - dur, "dur": dur,
                       "pid": _WALL_PID, "tid": 1, "args": args})
        elif typ == "serve.retire":
            te.append({"name": f"retire rid={ev.get('rid')}", "ph": "i",
                       "ts": ts, "pid": _WALL_PID, "tid": 1, "s": "t",
                       "args": {"tokens": ev.get("tokens")}})
        elif typ == "ft.straggler":
            te.append({"name": f"straggler {ev.get('timer')}", "ph": "i",
                       "ts": ts, "pid": _WALL_PID, "tid": 1, "s": "p",
                       "args": {"dt_s": ev.get("dt_s"),
                                "ema_s": ev.get("ema_s")}})
        if typ == "serve.admit" and "queue_depth" in ev:
            te.append({"name": "queue_depth", "ph": "C", "ts": ts,
                       "pid": _WALL_PID,
                       "args": {"depth": ev["queue_depth"]}})
    return {"traceEvents": te, "displayTimeUnit": "ms",
            "otherData": {"schema": SCHEMA}}


def write_perfetto(path, events: Iterable[dict]) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(perfetto_trace(events)))
    return path
