"""Replay a flight-recorder JSONL log into a human-readable decision trace
(a copy of ``repro/obs/report.py``).

    PYTHONPATH=src python -m repro_torch.obs.report LOG.jsonl
        [--perfetto OUT.json] [--all] [--limit N]

Prints, from the event log alone (no live process needed):

  * the tuner decision trace -- every PROFILE/TRIAL/HOLD transition with
    its reason, every trial result, guard trip (burst vs regime verdict,
    CV, the attested reference it tripped against), window extension,
    baseline attestation and revert;
  * with ``--all``, the serving/tiering lines interleaved (admissions,
    macro launches, stragglers, tier boundaries);
  * the metrics summary table (counters, gauges, histogram quantiles)
    from the log's closing ``metrics.summary`` record.

``--perfetto OUT.json`` additionally converts the log into a Chrome/
Perfetto ``trace_event`` file (load it at https://ui.perfetto.dev).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.obs import export

__all__ = ["decision_trace", "metrics_table", "main"]


def _fmt(v, nd: int = 3) -> str:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, int):
        return str(v)
    if v != v:                     # NaN
        return "nan"
    if abs(v) >= 1e5 or (v != 0 and abs(v) < 1e-3):
        return f"{v:.2e}"
    return f"{v:.{nd}f}"


def _line_tuner(ev: dict) -> Optional[str]:
    typ, step = ev["type"], ev.get("step", "?")
    who = ev.get("tuner", "?")
    head = f"step {step:>7}  [{who}] "
    if typ == "tuner.transition":
        s = (head + f"{ev['frm'].upper()} -> {ev['to'].upper()} "
             f"[{ev['reason']}]  period={ev.get('period')}")
        if ev.get("detail"):
            s += f"  ({ev['detail']})"
        return s
    if typ == "tuner.trial":
        mark = "*" if ev.get("improved") else " "
        return (head + f"TRIAL p={ev['period']:<5} cost/step="
                f"{_fmt(ev['cost'])} {mark} best=(p={ev['best_period']}, "
                f"{_fmt(ev['best_cost'])}) stale={ev['stale']}")
    if typ == "tuner.guard":
        ratio = (ev["cost"] / ev["ref"] if ev.get("ref") else float("nan"))
        return (head + f"GUARD[{ev['where']}] {ratio:.1f}x attested "
                f"({_fmt(ev['cost'])} vs {_fmt(ev['ref'])}), bucket CV "
                f"{_fmt(ev.get('cv'), 2)} => {ev['verdict']}")
    if typ == "tuner.extend":
        return (head + f"TRIAL window extended -> {ev['win_target']} steps "
                f"(bucket CV {_fmt(ev.get('cv'), 2)})")
    if typ == "tuner.baseline":
        floor = " (floored by sweep winner)" if ev.get("floored") else ""
        return head + f"HOLD baseline attested: {_fmt(ev['cost'])}{floor}"
    if typ == "tuner.hold_window":
        if ev.get("kind") == "ok":
            return None            # the quiet steady state: keep the trace
        return (head + f"HOLD window: {ev['kind']} "          # readable
                f"(cost {_fmt(ev.get('cost'))}, baseline "
                f"{_fmt(ev.get('baseline'))}, strikes {ev.get('strikes')})")
    if typ == "tuner.period":
        return (head + f"period {ev.get('prev')} -> {ev['period']}")
    if typ == "tuner.profile_extend":
        return head + "PROFILE window empty: extending"
    return None


def _line_other(ev: dict) -> Optional[str]:
    typ = ev["type"]
    if typ == "tier.move":
        return (f"step {ev.get('step', '?'):>7}  [{ev.get('manager', '?')}] "
                f"tier: +{ev['promoted']} pages / -{ev['evicted']} evicted "
                f"(p={ev['period']}, {ev['pages_moved']} pages moved)")
    if typ == "serve.admit":
        return (f"t {ev['t']:10.3f}s  admit x{ev['joiners']} "
                f"({ev['pages']} pages, queue {ev['queue_depth']}, "
                f"{_fmt(ev.get('wall_ms'), 2)} ms)")
    if typ == "serve.macro":
        flag = "  ** straggler" if ev.get("straggler") else ""
        return (f"t {ev['t']:10.3f}s  macro x{ev['n_steps']}: "
                f"{ev['tokens']} tokens, active {_fmt(ev['active'], 1)}, "
                f"fetched {ev['fetched']}, {_fmt(ev['wall_ms'], 2)} ms{flag}")
    if typ == "serve.retire":
        return (f"t {ev['t']:10.3f}s  retire rid={ev['rid']} "
                f"({ev['tokens']} tokens)")
    if typ == "ft.straggler":
        return (f"t {ev['t']:10.3f}s  STRAGGLER [{ev['timer']}] step "
                f"{ev['step']}: {_fmt(ev['dt_s'])}s vs EMA "
                f"{_fmt(ev['ema_s'])}s")
    if typ == "serve.stream":
        return (f"t {ev['t']:10.3f}s  stream {ev['phase']} "
                f"({ev.get('tokens')} tokens)")
    return None


def decision_trace(events: List[dict], include_all: bool = False
                   ) -> List[str]:
    """Render the event stream as decision-trace lines (tuner-only by
    default; ``include_all`` interleaves serving/tiering lines)."""
    lines = []
    for ev in events:
        typ = ev.get("type", "")
        if typ == "metrics.summary":
            continue
        line = _line_tuner(ev) if typ.startswith("tuner.") else (
            _line_other(ev) if include_all else None)
        if line:
            lines.append(line)
    return lines


def metrics_table(summary: dict) -> List[str]:
    lines = ["", "== metrics =="]
    if summary.get("counters"):
        lines.append("counters:")
        for k, v in summary["counters"].items():
            lines.append(f"  {k:<34} {_fmt(v)}")
    if summary.get("gauges"):
        lines.append("gauges:")
        for k, v in summary["gauges"].items():
            lines.append(f"  {k:<34} {_fmt(v)}")
    if summary.get("hists"):
        lines.append(f"{'histogram':<34} {'count':>8} {'mean':>10} "
                     f"{'p50':>10} {'p95':>10} {'max':>10}")
        for k, h in summary["hists"].items():
            if not h.get("count"):
                continue
            lines.append(f"  {k:<32} {h['count']:>8} {_fmt(h['mean']):>10} "
                         f"{_fmt(h['p50']):>10} {_fmt(h['p95']):>10} "
                         f"{_fmt(h['max']):>10}")
    if "events_dropped" in summary and summary["events_dropped"]:
        lines.append(f"  (ring dropped {summary['events_dropped']} oldest "
                     "events)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="replay a flight-recorder JSONL log")
    ap.add_argument("log", help="JSONL event log (obs.export.write_jsonl)")
    ap.add_argument("--perfetto", metavar="OUT.json",
                    help="also write a Perfetto trace_event file")
    ap.add_argument("--all", action="store_true",
                    help="interleave serving/tiering lines with the tuner "
                         "decision trace")
    ap.add_argument("--limit", type=int, default=None,
                    help="print only the last N trace lines")
    args = ap.parse_args(argv)

    events = export.read_jsonl(args.log)
    lines = decision_trace(events, include_all=args.all)
    if args.limit is not None:
        lines = lines[-args.limit:]
    print(f"== decision trace ({len(lines)} lines) ==")
    for line in lines:
        print(line)

    summary: Dict = next((e for e in events
                          if e.get("type") == "metrics.summary"), {})
    for line in metrics_table(summary):
        print(line)

    if args.perfetto:
        p = export.write_perfetto(args.perfetto, events)
        print(f"\nperfetto trace -> {p} (open at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
