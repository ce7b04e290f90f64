"""Offline cost-model rendering of a telemetry sink (copy of ``deppy_tpu/profile/report.py:1-345``).

Reads a telemetry JSONL sink (``DEPPY_GPU_TELEMETRY_FILE``) and
reproduces, from ``profile`` events alone, the dispatch cost model:

  * **trip-overhead regression** — least-squares fit of dispatch wall
    clock against trip count across sampled device dispatches: the
    slope is µs per trip, the intercept the per-dispatch fixed cost
    (pad/pack, upload, launch), and slope × mean useful-work ratio
    estimates the useful µs bought per trip;
  * **useful-work ratio per size class** — how much of each class's
    trip-lane slots carried live work;
  * **straggler and pad waste breakdowns** per size class;
  * **per-backend µs/solve** — device / host / hostpool / warm cost
    attribution;
  * the ``race`` events' per-class portfolio table and the ``optimize``
    events' per-mode probe table.

The ``deppy profile`` CLI that prints :func:`render_text` comes with
ROADMAP A7.2; ``chip_smoke.py``'s ``optimize`` phase prints it on the
card.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def summarize(path) -> dict:
    """Aggregate a sink's ``profile`` events into the cost model, its
    ``race`` events into the per-class portfolio table (wins, cancels
    and win margin per backend, straggler resubmissions) and its
    ``optimize`` events into the per-mode probe table, from the sink
    alone.  ``path`` is one sink path, or a list of per-replica sinks
    to merge (flight-recorder dump copies dedupe by their per-process
    event seq)."""
    from ..telemetry import iter_merged_sink_events, iter_sink_events

    events = (iter_sink_events(path) if isinstance(path, str)
              else iter_merged_sink_events(path))
    device: List[dict] = []
    backends: Dict[str, dict] = {}
    races: Dict[str, dict] = {}
    optimize: Dict[str, dict] = {}
    n_events = 0
    for ev in events:
        if ev is None:
            continue
        if ev.get("kind") == "race":
            _take_race(races, ev)
            continue
        if ev.get("kind") == "optimize":
            _take_optimize(optimize, ev)
            continue
        if ev.get("kind") != "profile":
            continue
        n_events += 1
        backend = str(ev.get("backend", "?"))
        agg = backends.setdefault(
            backend, {"events": 0, "lanes": 0, "solve_s": 0.0})
        agg["events"] += 1
        agg["lanes"] += int(ev.get("live", ev.get("lanes", 0)) or 0)
        try:
            agg["solve_s"] += float(ev.get("solve_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            pass
        if "trips" in ev:
            device.append(ev)
    for agg in backends.values():
        agg["solve_s"] = round(agg["solve_s"], 6)
        agg["us_per_solve"] = (
            round(agg["solve_s"] * 1e6 / agg["lanes"], 2)
            if agg["lanes"] else 0.0)
    for agg in races.values():
        margins = agg.pop("_margins")
        agg["win_margin_s_mean"] = (
            round(sum(margins) / len(margins), 6) if margins else None)
        agg["win_margin_s_min"] = (round(min(margins), 6)
                                   if margins else None)
        # Censored-aware per-backend speed: only walls from
        # entrants that actually finished feed the estimate — a
        # cancelled loser's partial wall measures when the cancel
        # landed, not how fast the backend solves.
        lane_us = agg.pop("_lane_us")
        agg["backend_us_per_lane"] = {
            b: {"us_per_lane": round(sum(vals) / len(vals), 2),
                "samples": len(vals)}
            for b, vals in sorted(lane_us.items())}
    for agg in optimize.values():
        agg["probe_s"] = round(agg["probe_s"], 6)
        agg["improvement_mean"] = (
            round(agg["improvement_total"] / agg["improvements"], 2)
            if agg["improvements"] else None)
    return {
        "profile_events": n_events,
        "device_dispatches": len(device),
        "trip_overhead": _trip_regression(device),
        "size_classes": _size_classes(device),
        "backends": backends,
        "races": races,
        "optimize": optimize,
    }


def _take_race(races: Dict[str, dict], ev: dict) -> None:
    key = str(ev.get("size_class_name", "?"))
    agg = races.setdefault(key, {
        "races": 0, "starts": {}, "wins": {}, "cancels": {},
        "resubmitted": 0, "no_winner": 0, "checked": 0,
        "check_mismatches": 0, "censored": {}, "_margins": [],
        "_lane_us": {},
    })
    if ev.get("resubmitted") is not None:
        agg["resubmitted"] += int(ev.get("resubmitted") or 0)
        return
    agg["races"] += 1
    for name in ev.get("entrants") or []:
        agg["starts"][name] = agg["starts"].get(name, 0) + 1
    winner = ev.get("winner")
    if winner is None:
        agg["no_winner"] += 1
    else:
        agg["wins"][winner] = agg["wins"].get(winner, 0) + 1
    for name in ev.get("cancelled") or []:
        agg["cancels"][name] = agg["cancels"].get(name, 0) + 1
    if ev.get("checked") is not None:
        agg["checked"] += 1
        if ev.get("checked") == "mismatch":
            agg["check_mismatches"] += 1
    m = ev.get("win_margin_s")
    if isinstance(m, (int, float)):
        agg["_margins"].append(float(m))
    lanes = max(int(ev.get("lanes") or 1), 1)
    wall = ev.get("wall_s")
    if winner is not None and isinstance(wall, (int, float)):
        agg["_lane_us"].setdefault(str(winner), []).append(
            1e6 * float(wall) / lanes)
    for loser in ev.get("losers") or []:
        if not isinstance(loser, dict):
            continue
        b = loser.get("backend")
        lw = loser.get("wall_s")
        if not isinstance(b, str):
            continue
        if loser.get("censored") or not isinstance(lw, (int, float)):
            agg["censored"][b] = agg["censored"].get(b, 0) + 1
            continue
        agg["_lane_us"].setdefault(b, []).append(1e6 * float(lw) / lanes)


def _take_optimize(optimize: Dict[str, dict], ev: dict) -> None:
    """One bound-tightening probe, keyed by probe mode —
    the warm-vs-cold split is the table's point: per-iteration rate,
    hit ratio, and which backend wins the cold probes, from the sink's
    ``optimize`` events alone."""
    key = str(ev.get("mode", "?"))
    agg = optimize.setdefault(key, {
        "probes": 0, "improvements": 0, "proofs": 0, "misses": 0,
        "budget": 0, "improvement_total": 0, "probe_s": 0.0,
        "backend_wins": {},
    })
    agg["probes"] += 1
    try:
        agg["probe_s"] += float(ev.get("dur_s", 0.0) or 0.0)
    except (TypeError, ValueError):
        pass
    outcome = ev.get("outcome")
    if outcome == "improved":
        agg["improvements"] += 1
        try:
            agg["improvement_total"] += int(ev.get("improvement", 0) or 0)
        except (TypeError, ValueError):
            pass
        backend = str(ev.get("backend", "?"))
        agg["backend_wins"][backend] = \
            agg["backend_wins"].get(backend, 0) + 1
    elif outcome == "unsat":
        agg["proofs"] += 1
    elif outcome == "budget":
        agg["budget"] += 1
    else:
        agg["misses"] += 1


def _trip_regression(device: List[dict]) -> Optional[dict]:
    """solve_s ~ intercept + slope * trips over the sampled device
    dispatches.  None when the sink lacks two dispatches with distinct
    trip counts (a constant can't be regressed)."""
    import numpy as np

    pts = [(float(ev["trips"]), float(ev.get("solve_s", 0.0) or 0.0))
           for ev in device
           if ev.get("trips") is not None and ev.get("solve_s")]
    if len(pts) < 2:
        return None
    x = np.array([p[0] for p in pts])
    y = np.array([p[1] for p in pts])
    if float(x.max() - x.min()) <= 0:
        return None
    slope, intercept = np.polyfit(x, y, 1)
    pred = slope * x + intercept
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    ratios = [float(ev.get("useful_work_ratio", 0.0) or 0.0)
              for ev in device]
    mean_useful = sum(ratios) / len(ratios) if ratios else 0.0
    return {
        "points": len(pts),
        "us_per_trip": round(float(slope) * 1e6, 3),
        "intercept_ms": round(float(intercept) * 1e3, 3),
        "r2": round(1.0 - ss_res / ss_tot, 4) if ss_tot > 0 else 1.0,
        "mean_useful_work_ratio": round(mean_useful, 4),
        "useful_us_per_trip": round(float(slope) * 1e6 * mean_useful, 3),
    }


def _size_classes(device: List[dict]) -> Dict[str, dict]:
    classes: Dict[str, dict] = {}
    for ev in device:
        # Ladder-class name when the event carries one;
        # older sinks fall back to the raw bucketed-cost key.
        key = str(ev.get("size_class_name")
                  or ev.get("size_class", "?"))
        agg = classes.setdefault(key, {
            "dispatches": 0, "lanes": 0, "live": 0, "trips": 0,
            "lane_steps": 0, "solve_s": 0.0,
            "_useful": 0.0, "_straggler": 0.0, "_pad": 0.0,
        })
        agg["dispatches"] += 1
        agg["lanes"] += int(ev.get("lanes", 0) or 0)
        agg["live"] += int(ev.get("live", 0) or 0)
        agg["trips"] += int(ev.get("trips", 0) or 0)
        agg["lane_steps"] += int(ev.get("lane_steps", 0) or 0)
        agg["solve_s"] += float(ev.get("solve_s", 0.0) or 0.0)
        agg["_useful"] += float(ev.get("useful_work_ratio", 0.0) or 0.0)
        agg["_straggler"] += float(
            ev.get("straggler_p99_ratio", 0.0) or 0.0)
        agg["_pad"] += float(ev.get("pad_waste_ratio", 0.0) or 0.0)
    for agg in classes.values():
        n = agg["dispatches"]
        agg["useful_work_ratio"] = round(agg.pop("_useful") / n, 4)
        agg["straggler_p99_ratio"] = round(agg.pop("_straggler") / n, 4)
        agg["pad_waste_ratio"] = round(agg.pop("_pad") / n, 4)
        agg["us_per_solve"] = (round(agg["solve_s"] * 1e6 / agg["live"], 2)
                               if agg["live"] else 0.0)
        agg["solve_s"] = round(agg["solve_s"], 6)
    return classes


def render_text(summary: dict, path: str) -> str:
    lines = [f"profile: {summary['profile_events']} profile events from "
             f"{path} ({summary['device_dispatches']} device dispatches)"]
    reg = summary.get("trip_overhead")
    if reg is not None:
        lines += [
            "trip overhead (solve wall ~ trips, least squares):",
            f"  {reg['us_per_trip']:.1f} us/trip  "
            f"(+{reg['intercept_ms']:.2f} ms fixed/dispatch, "
            f"r2={reg['r2']}, {reg['points']} dispatches)",
            f"  useful work: {reg['mean_useful_work_ratio']:.3f} of "
            f"trip-lane slots -> ~{reg['useful_us_per_trip']:.1f} "
            f"useful us/trip",
        ]
    else:
        lines.append(
            "trip overhead: not enough device dispatches with distinct "
            "trip counts (need >= 2; arm DEPPY_GPU_PROFILE=on and vary "
            "the workload)")
    classes = summary.get("size_classes") or {}
    if classes:
        lines.append("size classes:")
        lines.append(f"  {'class':>10}  {'disp':>5}  {'live':>6}  "
                     f"{'trips':>8}  {'useful':>7}  {'p99/trip':>8}  "
                     f"{'padwaste':>8}  {'us/solve':>9}")
        for key in sorted(classes, key=lambda k: (len(k), k)):
            a = classes[key]
            lines.append(
                f"  {key:>10}  {a['dispatches']:>5}  {a['live']:>6}  "
                f"{a['trips']:>8}  {a['useful_work_ratio']:>7.3f}  "
                f"{a['straggler_p99_ratio']:>8.3f}  "
                f"{a['pad_waste_ratio']:>8.3f}  {a['us_per_solve']:>9.1f}")
    backends = summary.get("backends") or {}
    if backends:
        lines.append("backends:")
        lines.append(f"  {'backend':>10}  {'events':>6}  {'lanes':>7}  "
                     f"{'solve_s':>9}  {'us/solve':>9}")
        for name in sorted(backends):
            a = backends[name]
            lines.append(f"  {name:>10}  {a['events']:>6}  "
                         f"{a['lanes']:>7}  {a['solve_s']:>9.3f}  "
                         f"{a['us_per_solve']:>9.1f}")
    races = summary.get("races") or {}
    if races:
        lines.append("portfolio races (per size class):")
        lines.append(f"  {'class':>10}  {'races':>5}  "
                     f"{'wins':<28}  {'cancels':<24}  {'margin':>8}  "
                     f"{'resub':>5}")
        for key in sorted(races, key=lambda k: (len(k), k)):
            a = races[key]
            wins = " ".join(f"{n}={c}" for n, c in
                            sorted(a["wins"].items())) or "-"
            cancels = " ".join(f"{n}={c}" for n, c in
                               sorted(a["cancels"].items())) or "-"
            margin = (f"{a['win_margin_s_mean'] * 1e3:.1f}ms"
                      if a.get("win_margin_s_mean") is not None else "-")
            lines.append(
                f"  {key:>10}  {a['races']:>5}  {wins:<28}  "
                f"{cancels:<24}  {margin:>8}  {a['resubmitted']:>5}")
            # Censored-aware backend speed: µs/lane from
            # FINISHED entrants only, with the censored (cancelled)
            # observation count alongside so a backend that always
            # loses by cancellation reads "unmeasured", not "fast".
            speed = a.get("backend_us_per_lane") or {}
            if speed:
                cells = []
                for b in sorted(set(speed) | set(a.get("censored") or {})):
                    row = speed.get(b)
                    cen = (a.get("censored") or {}).get(b, 0)
                    cell = (f"{b}={row['us_per_lane']:.0f}us/{row['samples']}"
                            if row else f"{b}=?")
                    if cen:
                        cell += f" (cens {cen})"
                    cells.append(cell)
                lines.append(f"  {'':>10}  speed: " + "  ".join(cells))
            if a.get("check_mismatches"):
                lines.append(
                    f"  {'':>10}  !! {a['check_mismatches']} sampled "
                    f"cross-check mismatch(es) — served canonical")
    optimize = summary.get("optimize") or {}
    if optimize:
        lines.append("optimization probes (per mode):")
        lines.append(f"  {'mode':>10}  {'probes':>6}  {'improved':>8}  "
                     f"{'proofs':>6}  {'miss':>5}  {'budget':>6}  "
                     f"{'delta/imp':>9}  {'ms/probe':>8}  "
                     f"{'backend wins':<24}")
        for key in sorted(optimize):
            a = optimize[key]
            wins = " ".join(f"{n}={c}" for n, c in
                            sorted(a["backend_wins"].items())) or "-"
            mean = a.get("improvement_mean")
            per = (a["probe_s"] * 1e3 / a["probes"]
                   if a["probes"] else 0.0)
            lines.append(
                f"  {key:>10}  {a['probes']:>6}  {a['improvements']:>8}  "
                f"{a['proofs']:>6}  {a['misses']:>5}  {a['budget']:>6}  "
                f"{mean if mean is not None else '-':>9}  {per:>8.2f}  "
                f"{wins:<24}")
    return "\n".join(lines)
