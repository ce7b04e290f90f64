"""Offline route-health reconstruction (copy of
``deppy_tpu/routes/report.py:1-185``, the library under ``deppy
routes``, ``deppy_tpu_torch/cli.py``).

The live plane never needs to be scraped to audit routing: every input
it folds — ``race`` events with censored-aware ``losers``, shadow
``route`` probes, ``route_stale`` crossings, ``route_learned``
adoptions — is on the JSONL sink.  :func:`build_report` replays sink
events through the SAME :class:`~deppy_tpu_torch.routes.ledger.RegretLedger`
the live forwarder drives, then joins the defaults store's provenance
stamps, so the report is the live table recomputed from first
principles; :func:`render_text` prints it as a table.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from .ledger import RegretLedger


def build_report(events: Iterable[Optional[dict]],
                 rows_doc: Optional[dict] = None,
                 platform: Optional[str] = None,
                 decay: Optional[float] = None) -> dict:
    """Fold sink events into the route-health document.  ``rows_doc``
    (a defaults-store read) joins provenance; ``platform`` selects its
    backend section, defaulting to the platform the events themselves
    were stamped with."""
    ledger = RegretLedger(decay=decay)
    stale: Dict[str, dict] = {}
    learned: Dict[str, dict] = {}
    platforms: Dict[str, int] = {}
    n_events = 0
    for ev in events:
        if not isinstance(ev, dict):
            continue
        n_events += 1
        kind = ev.get("kind")
        if kind in ("race", "route"):
            ledger.fold(ev)
        elif kind == "route_stale":
            cls = ev.get("size_class_name")
            if cls:
                # Latest crossing wins — the sink is append-ordered, so
                # the last verdict per class is the current one.
                stale[str(cls)] = {
                    k: ev[k] for k in
                    ("reason", "key", "row", "age_s", "box", "replica")
                    if k in ev}
        elif kind == "route_learned":
            key = ev.get("key")
            if isinstance(key, str):
                learned[key] = {
                    k: ev[k] for k in
                    ("row", "source", "origin", "replica",
                     "est_us_per_lane", "size_class_name")
                    if k in ev}
                cls = ev.get("size_class_name")
                if cls:
                    # An adoption supersedes any earlier stale verdict
                    # for its class, exactly like the live watcher's
                    # mark_fresh().
                    stale.pop(str(cls), None)
        p = ev.get("platform")
        if isinstance(p, str) and p:
            platforms[p] = platforms.get(p, 0) + 1
    if platform is None and platforms:
        platform = max(sorted(platforms), key=platforms.get)

    snapshot = ledger.snapshot()
    estimates = ledger.estimates()
    provenance: Dict[str, dict] = {}
    if isinstance(rows_doc, dict) and platform:
        entry = rows_doc.get(platform)
        if isinstance(entry, dict):
            ev_map = entry.get("evidence")
            ev_map = ev_map if isinstance(ev_map, dict) else {}
            for key, row in entry.items():
                if key.startswith("portfolio") and isinstance(row, str):
                    provenance[key] = {"row": row,
                                       "evidence": ev_map.get(key)}

    classes: Dict[str, dict] = {}
    for cls in sorted(set(snapshot) | set(estimates) | set(stale)):
        doc = dict(snapshot.get(cls) or {})
        doc["estimates"] = estimates.get(cls, {})
        doc["stale"] = stale.get(cls)
        doc["learned"] = learned.get(f"portfolio.{cls}")
        prov = (provenance.get(f"portfolio.{cls}")
                or provenance.get("portfolio"))
        doc["registry"] = prov
        classes[cls] = doc

    total_regret = sum(
        s for c in classes.values()
        for s in (c.get("regret_s") or {}).values())
    return {
        "platform": platform,
        "events": n_events,
        "classes": classes,
        "shadow": ledger.shadow_counts(),
        "learned": learned,
        "totals": {
            "races": sum(c.get("races", 0) for c in classes.values()),
            "regret_s": round(total_regret, 6),
            "stale_classes": len(stale),
            "learned_rows": len(learned),
        },
    }


def render_text(report: dict) -> str:
    """The human table: one row per size class — races, default, win
    leader, regret charged to the default, staleness verdict, learned
    row."""
    lines: List[str] = []
    classes = report.get("classes") or {}
    totals = report.get("totals") or {}
    lines.append(
        f"route health — platform={report.get('platform') or '?'} "
        f"events={report.get('events', 0)} "
        f"races={totals.get('races', 0)} "
        f"regret={totals.get('regret_s', 0.0):.3f}s "
        f"stale={totals.get('stale_classes', 0)} "
        f"learned={totals.get('learned_rows', 0)}")
    if not classes:
        lines.append("  (no race/route events on the sink)")
        return "\n".join(lines)

    hdr = (f"  {'class':<10} {'races':>6} {'default':<10} "
           f"{'leader':<16} {'regret_s':>9} {'status':<22} learned")
    lines.append(hdr)
    lines.append("  " + "-" * (len(hdr) - 2))
    for cls, doc in classes.items():
        shares = doc.get("win_share") or {}
        if shares:
            top = max(sorted(shares), key=shares.get)
            leader = f"{top} {shares[top] * 100:.0f}%"
        else:
            leader = "-"
        regret = sum((doc.get("regret_s") or {}).values())
        stale = doc.get("stale")
        if stale:
            status = stale.get("reason", "?")
            if stale.get("age_s") is not None:
                status += f" ({stale['age_s'] / 86400.0:.1f}d)"
            elif stale.get("box"):
                status += f" ({stale['box']})"
        elif doc.get("learned"):
            status = "fresh (learned)"
        elif doc.get("registry"):
            status = "fresh"
        else:
            status = "-"
        learned = doc.get("learned") or {}
        lrow = learned.get("row", "-")
        if learned.get("source") == "gossip":
            lrow += f" (gossip:{learned.get('origin') or '?'})"
        lines.append(
            f"  {cls:<10} {doc.get('races', 0):>6} "
            f"{doc.get('default') or '-':<10} {leader:<16} "
            f"{regret:>9.3f} {status:<22} {lrow}")

    # Per-class backend estimates: the decayed µs-per-lane table the
    # online registry ranks by, censored counts alongside so a cancel-
    # heavy backend's missing estimate is explainable.
    lines.append("")
    lines.append(f"  {'class':<10} {'backend':<12} {'us/lane':>10} "
                 f"{'samples':>8} {'censored':>9}")
    for cls, doc in classes.items():
        for backend in sorted(doc.get("estimates") or {}):
            row = doc["estimates"][backend]
            us = row.get("us_per_lane")
            us_s = "-" if us is None else f"{us:.1f}"
            lines.append(
                f"  {cls:<10} {backend:<12} {us_s:>10} "
                f"{row.get('samples', 0):>8} {row.get('censored', 0):>9}")

    shadow = report.get("shadow") or {}
    if shadow:
        lines.append("")
        lines.append("  shadow probes: " + "  ".join(
            f"{b}={v['dispatches']}"
            + (f" (failed {v['failed']})" if v.get("failed") else "")
            for b, v in shadow.items()))
    return "\n".join(lines)
