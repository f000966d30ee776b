"""Offline run-log summarizer — the `stats` CLI subcommand's engine.

Every loop in the framework writes the same append-only jsonl record
shape (`observe.JsonlLogger`): train epochs, federated rounds and
round_health attempts, serve_* request events, timer records, span
exports, metrics snapshots. This module reads ANY of those files and
rolls it up offline: per-event counts, percentiles over every numeric
field, named timer/span timing tables, the last metrics snapshot, and
PER-REQUEST timelines (every serve_* event and every rid-stamped span
grouped by request id, time-ordered — the `stats --request RID` view)
— so "what did this run spend its time on" and "what happened to
request X" are one command against the artifact, no re-run needed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# fields that are identifiers/timestamps, not measurements
_SKIP_FIELDS = {"ts", "id", "round", "attempt", "epoch", "step", "seed",
                "parent", "tid", "wall", "t_ms"}


def _num_stats(values: list[float]) -> dict:
    a = np.asarray(values, np.float64)
    return {
        "count": int(a.size),
        "mean": round(float(a.mean()), 4),
        "p50": round(float(np.percentile(a, 50)), 4),
        "p95": round(float(np.percentile(a, 95)), 4),
        "min": round(float(a.min()), 4),
        "max": round(float(a.max()), 4),
    }


def summarize_jsonl(path) -> dict:
    """Parse a run jsonl into the summary dict `format_summary` prints.
    Accepts one path or a list of paths — the CLUSTER case: the router
    and each replica write their own files, and merging them here is
    what turns N per-process logs into one fleet view (`JsonlLogger`
    stamps epoch-seconds ``ts`` and span exports epoch ``wall``, so
    records from different processes share one time axis and the
    per-request timelines sort correctly across files). Unparseable
    lines are counted, never fatal (a crash mid-write can truncate the
    final line of an append-only log)."""
    paths = ([Path(p) for p in path]
             if isinstance(path, (list, tuple)) else [Path(path)])
    records, bad = [], 0
    # files concatenate in argument order (NOT globally re-sorted):
    # span self-time segmentation depends on each tracer's records
    # staying contiguous; the timelines sort by wall time themselves
    for p in paths:
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                bad += 1
    path = paths[0] if len(paths) == 1 else "+".join(map(str, paths))
    by_event: dict[str, dict] = {}
    timers: dict[str, list[float]] = {}
    spans: dict[str, list[float]] = {}
    programs: list[dict] = []
    profile_steps: list[dict] = []
    fed_cohorts: list[dict] = []
    tenants: dict[str, dict] = {}
    ckpt = {"saves": 0, "save_bytes": 0, "save_seconds": 0.0,
            "restores": 0, "restore_bytes": 0, "restore_seconds": 0.0,
            "restore_peak_host_bytes": 0}
    rollouts: list[dict] = []
    cc = {"hits": 0, "misses": 0, "stores": 0, "evicted_corrupt": 0,
          "deserialize_ms": 0.0, "compile_ms": 0.0}
    last_snapshot = None
    ts = [r["ts"] for r in records
          if isinstance(r.get("ts"), (int, float))]
    for r in records:
        event = str(r.get("event", r.get("kind", "<none>")))
        slot = by_event.setdefault(event, {"count": 0, "fields": {}})
        slot["count"] += 1
        for k, v in r.items():
            if (k in _SKIP_FIELDS or k == "event"
                    or isinstance(v, bool)
                    or not isinstance(v, (int, float))):
                continue
            slot["fields"].setdefault(k, []).append(float(v))
        if event == "timer" and isinstance(r.get("seconds"),
                                           (int, float)):
            timers.setdefault(str(r.get("name")), []).append(
                float(r["seconds"]))
        if event == "span" and isinstance(r.get("dur_ms"),
                                          (int, float)):
            spans.setdefault(str(r.get("name")), []).append(
                float(r["dur_ms"]))
        if event == "metrics_snapshot":
            last_snapshot = r.get("metrics")
        if event == "profile_program":
            programs.append({k: v for k, v in r.items()
                             if k not in ("ts", "event")})
        if event == "profile_step":
            profile_steps.append({k: v for k, v in r.items()
                                  if k not in ("ts", "event")})
        if event == "fed_cohort":
            fed_cohorts.append({k: v for k, v in r.items()
                                if k not in ("ts", "event")})
        if event == "serve_tenant_finish":
            slot_t = _tenant_slot(tenants, r)
            slot_t["requests"] += 1
            slot_t["tokens"] += int(r.get("tokens") or 0)
            reason = str(r.get("reason"))
            slot_t["by_reason"][reason] = (
                slot_t["by_reason"].get(reason, 0) + 1)
            if isinstance(r.get("ttft_ms"), (int, float)):
                slot_t["ttft_ms"].append(float(r["ttft_ms"]))
        if event == "serve_tenant_shed":
            _tenant_slot(tenants, r)["shed"] += 1
        if event == "serve_tenant_quota_reject":
            _tenant_slot(tenants, r)["quota_rejections"] += 1
        # sharded checkpoint + weight rollout : byte/second
        # totals for the transfer events, the raw transition list for
        # the rollout state machine (serve-level and cluster-level)
        if event == "ckpt_save":
            ckpt["saves"] += 1
            ckpt["save_bytes"] += int(r.get("bytes") or 0)
            ckpt["save_seconds"] += float(r.get("seconds") or 0.0)
        if event == "ckpt_restore":
            ckpt["restores"] += 1
            ckpt["restore_bytes"] += int(r.get("bytes_read") or 0)
            ckpt["restore_seconds"] += float(r.get("seconds") or 0.0)
            ckpt["restore_peak_host_bytes"] = max(
                ckpt["restore_peak_host_bytes"],
                int(r.get("peak_host_bytes") or 0))
        if event in ("serve_rollout", "cluster_rollout"):
            rollouts.append(
                {k: r.get(k) for k in
                 ("event", "stage", "outcome", "reason",
                  "canary_requests", "replica")
                 if r.get(k) is not None})
        # persistent compile cache (serve/compile_cache.py):
        # warm-vs-cold spin-up totals — an evict_corrupt already counts
        # itself as a miss at the source, mirrored here
        if event == "compile_cache":
            o = r.get("outcome")
            if o == "hit":
                cc["hits"] += 1
                cc["deserialize_ms"] += float(
                    r.get("deserialize_ms") or 0.0)
            elif o == "store":
                cc["stores"] += 1
                cc["compile_ms"] += float(r.get("compile_ms") or 0.0)
            elif o == "miss":
                cc["misses"] += 1
            elif o == "evict_corrupt":
                cc["evicted_corrupt"] += 1
                cc["misses"] += 1
    events = {
        ev: {"count": slot["count"],
             "fields": {k: _num_stats(vs)
                        for k, vs in sorted(slot["fields"].items())}}
        for ev, slot in sorted(by_event.items())}
    return {
        "path": str(path),
        "records": len(records),
        "unparseable_lines": bad,
        "wall_span_s": (round(max(ts) - min(ts), 3) if len(ts) >= 2
                        else None),
        "events": events,
        "timers": {n: _num_stats(vs) for n, vs in sorted(timers.items())},
        "spans": {n: {**_num_stats(vs),
                      "total_ms": round(float(np.sum(vs)), 3)}
                  for n, vs in sorted(spans.items())},
        "span_self": _span_self_times(records),
        "programs": programs,
        "profile_steps": profile_steps,
        "fed_cohorts": fed_cohorts,
        # per-tenant rollup from the serve_tenant_* events:
        # ttft_ms collapses to percentiles here, shed/quota counts ride
        # along — the offline twin of summary()["serve_tenants"]
        "tenants": {
            t: {"requests": v["requests"], "tokens": v["tokens"],
                "ttft_ms_p50": (round(float(np.percentile(
                    v["ttft_ms"], 50)), 2) if v["ttft_ms"] else None),
                "ttft_ms_p95": (round(float(np.percentile(
                    v["ttft_ms"], 95)), 2) if v["ttft_ms"] else None),
                "by_reason": v["by_reason"], "shed": v["shed"],
                "quota_rejections": v["quota_rejections"]}
            for t, v in sorted(tenants.items())},
        # checkpoint traffic totals (None when the run never saved or
        # restored — the key set stays stable either way) and the
        # rollout transition list, in file order
        "checkpoints": (
            {"saves": ckpt["saves"],
             "save_bytes": ckpt["save_bytes"],
             "save_mb_per_s": (
                 round(ckpt["save_bytes"] / 2**20
                       / ckpt["save_seconds"], 2)
                 if ckpt["save_seconds"] > 0 else None),
             "restores": ckpt["restores"],
             "restore_bytes": ckpt["restore_bytes"],
             "restore_mb_per_s": (
                 round(ckpt["restore_bytes"] / 2**20
                       / ckpt["restore_seconds"], 2)
                 if ckpt["restore_seconds"] > 0 else None),
             "restore_peak_host_bytes":
                 ckpt["restore_peak_host_bytes"]}
            if ckpt["saves"] or ckpt["restores"] else None),
        "rollouts": rollouts,
        # compile-cache totals (None when the run never touched one —
        # the key set stays stable either way)
        "compile_cache": (
            {**cc, "deserialize_ms": round(cc["deserialize_ms"], 3),
             "compile_ms": round(cc["compile_ms"], 3)}
            if cc["hits"] or cc["misses"] or cc["stores"] else None),
        "metrics": last_snapshot,
        "requests": _request_timelines(records),
    }


def _tenant_slot(tenants: dict, record: dict) -> dict:
    """Get-or-create one tenant's accumulator — the ONE definition of
    its field set, so the three serve_tenant_* event handlers cannot
    drift."""
    return tenants.setdefault(
        str(record.get("tenant")),
        {"requests": 0, "tokens": 0, "ttft_ms": [], "by_reason": {},
         "shed": 0, "quota_rejections": 0})


def _span_self_times(records: list[dict]) -> dict:
    """Per-span-name EXCLUSIVE time: each span's duration minus the
    durations of its direct children — the flame-graph "where does the
    time actually go" answer, computable from any span jsonl export
    (the `stats --top N` table). Inclusive totals double-count nested
    work (serve.tick contains admit+collect+window); self time sums to
    the traced wall instead."""
    spans = [r for r in records
             if r.get("event") == "span"
             and isinstance(r.get("dur_ms"), (int, float))
             and r.get("id") is not None]
    # span ids are unique within ONE tracer but restart per process, and
    # append-mode run logs can hold several runs — a repeated id marks a
    # new run SEGMENT, and parent links never cross segments, so child
    # sums are computed per segment (joining by raw id across the whole
    # file would subtract one run's children from another run's parents)
    segments: list[list[dict]] = []
    seen: set = set()
    for r in spans:
        if not segments or r["id"] in seen:
            segments.append([])
            seen = set()
        seen.add(r["id"])
        segments[-1].append(r)
    out: dict[str, dict] = {}
    for seg in segments:
        child_sum: dict[object, float] = {}
        for r in seg:
            p = r.get("parent")
            if p is not None:
                child_sum[p] = child_sum.get(p, 0.0) + r["dur_ms"]
        for r in seg:
            name = str(r.get("name"))
            self_ms = max(r["dur_ms"] - child_sum.get(r["id"], 0.0),
                          0.0)
            slot = out.setdefault(name, {"count": 0, "total_ms": 0.0,
                                         "self_ms": 0.0})
            slot["count"] += 1
            slot["total_ms"] += r["dur_ms"]
            slot["self_ms"] += self_ms
    grand = sum(s["self_ms"] for s in out.values())
    for slot in out.values():
        slot["total_ms"] = round(slot["total_ms"], 3)
        slot["self_ms"] = round(slot["self_ms"], 3)
        slot["self_pct"] = (round(100.0 * slot["self_ms"] / grand, 2)
                            if grand > 0 else 0.0)
    return out


def _request_timelines(records: list[dict]) -> dict:
    """rid -> time-ordered timeline entries, collected from BOTH record
    shapes a run can produce: the serve_* jsonl events (`id` field) and
    rid-stamped span records from a tracer's jsonl export. Each entry:
    {"t_s": seconds since the request's first record, "what": event or
    span name, "dur_ms": span duration (events: None), "detail": the
    record's other fields}. cluster_* hop events (router placement,
    handoff, hedge, migration) join the serve_* events, so
    a MERGED cluster log renders one end-to-end cross-replica
    timeline."""
    reqs: dict[str, list] = {}
    for r in records:
        ev = r.get("event")
        if (isinstance(ev, str)
                and (ev.startswith("serve_")
                     or ev.startswith("cluster_"))
                and "id" in r):
            reqs.setdefault(str(r["id"]), []).append({
                "_wall": r.get("ts"), "what": ev, "dur_ms": None,
                "detail": {k: v for k, v in r.items()
                           if k not in ("ts", "event", "id")}})
        elif ev == "span":
            attrs = r.get("attrs") or {}
            rid = attrs.get("rid")
            if rid is None:
                continue
            reqs.setdefault(str(rid), []).append({
                "_wall": r.get("wall"), "what": str(r.get("name")),
                "dur_ms": r.get("dur_ms"),
                "detail": {k: v for k, v in attrs.items()
                           if k != "rid"}})
    for rid, entries in reqs.items():
        entries.sort(key=lambda e: (e["_wall"] is None,
                                    e["_wall"] or 0.0))
        t0 = next((e["_wall"] for e in entries
                   if e["_wall"] is not None), None)
        for e in entries:
            wall = e.pop("_wall")
            e["t_s"] = (round(wall - t0, 6)
                        if wall is not None and t0 is not None else None)
    return reqs


def format_summary(s: dict, *, top: int = 15) -> str:
    """Human terminal rendering of `summarize_jsonl`'s dict. `top`
    bounds the span self-time table (stats --top N)."""
    out = [f"{s['path']}: {s['records']} records"
           + (f" ({s['unparseable_lines']} unparseable)"
              if s["unparseable_lines"] else "")
           + (f", {s['wall_span_s']}s wall span"
              if s["wall_span_s"] is not None else "")]
    out.append("")
    out.append("events:")
    for ev, slot in s["events"].items():
        out.append(f"  {ev:24s} x{slot['count']}")
        for k, st in slot["fields"].items():
            out.append(
                f"    {k:24s} mean={st['mean']} p50={st['p50']} "
                f"p95={st['p95']} min={st['min']} max={st['max']}")
    if s["timers"]:
        out.append("")
        out.append("timers (seconds):")
        for name, st in s["timers"].items():
            out.append(f"  {name:40s} x{st['count']} mean={st['mean']} "
                       f"p95={st['p95']}")
    if s["spans"]:
        out.append("")
        out.append("spans (ms):")
        for name, st in s["spans"].items():
            out.append(f"  {name:28s} x{st['count']} "
                       f"total={st['total_ms']} mean={st['mean']} "
                       f"p50={st['p50']} p95={st['p95']}")
    if s.get("span_self"):
        ranked = sorted(s["span_self"].items(),
                        key=lambda kv: kv[1]["self_ms"], reverse=True)
        shown = ranked[:max(int(top), 1)]
        out.append("")
        out.append(f"span self-time (exclusive, top {len(shown)} of "
                   f"{len(ranked)}):")
        for name, st in shown:
            out.append(f"  {name:28s} x{st['count']} "
                       f"self={st['self_ms']}ms ({st['self_pct']}%) "
                       f"total={st['total_ms']}ms")
    if s.get("programs"):
        from idc_models_tpu_torch.observe.profile import format_program

        out.append("")
        out.append("programs (performance attribution):")
        for rec in s["programs"]:
            out.append(format_program(rec))
    if s.get("profile_steps"):
        out.append("")
        out.append("step-time attribution:")
        for rec in s["profile_steps"]:
            out.append(
                f"  {rec['loop']:14s} {rec['steps']:>5} steps — device "
                f"{rec['device_busy_fraction']:.1%} / host-gap "
                f"{rec['host_gap_fraction']:.1%} "
                f"(mean {rec['step_ms_mean']} ms/step)")
    if s.get("fed_cohorts"):
        out.append("")
        out.append("fed cohorts (per round):")
        for rec in s["fed_cohorts"]:
            mode = rec.get("mode", "sync")
            line = (f"  round {rec.get('round'):>4} [{mode:5s}] "
                    f"cohort={rec.get('cohort')} of "
                    f"{rec.get('population')} "
                    f"participants={rec.get('participants')}")
            if mode == "async":
                hist = rec.get("staleness_hist") or []
                line += (f" buffer={rec.get('buffer')} "
                         f"updates={rec.get('updates')} staleness "
                         f"mean={rec.get('staleness_mean')} "
                         f"max={rec.get('staleness_max')} "
                         f"hist={hist}")
            else:
                line += (f" waves={rec.get('waves')}"
                         f"x{rec.get('wave_size')}")
            out.append(line)
    if s.get("tenants"):
        out.append("")
        out.append("tenants:")
        for name, st in s["tenants"].items():
            reasons = ",".join(f"{k}={v}" for k, v in
                               sorted(st["by_reason"].items()))
            out.append(
                f"  {name:16s} requests={st['requests']} "
                f"tokens={st['tokens']} ttft p50={st['ttft_ms_p50']} "
                f"p95={st['ttft_ms_p95']} shed={st['shed']} "
                f"quota_rej={st['quota_rejections']}"
                + (f" ({reasons})" if reasons else ""))
    if s.get("checkpoints"):
        ck = s["checkpoints"]
        out.append("")
        out.append(
            f"checkpoints: {ck['saves']} save(s) "
            f"({ck['save_bytes']} bytes"
            + (f", {ck['save_mb_per_s']} MB/s"
               if ck["save_mb_per_s"] is not None else "")
            + f"), {ck['restores']} restore(s) "
            f"({ck['restore_bytes']} bytes"
            + (f", {ck['restore_mb_per_s']} MB/s"
               if ck["restore_mb_per_s"] is not None else "")
            + f", peak host {ck['restore_peak_host_bytes']} bytes)")
    if s.get("compile_cache"):
        cc = s["compile_cache"]
        out.append("")
        out.append(
            f"compile cache: {cc['hits']} hit(s) "
            f"({cc['deserialize_ms']} ms deserializing), "
            f"{cc['misses']} miss(es) -> {cc['stores']} store(s) "
            f"({cc['compile_ms']} ms compiling), "
            f"{cc['evicted_corrupt']} corrupt eviction(s)")
    if s.get("rollouts"):
        out.append("")
        out.append("rollouts (state transitions, file order):")
        for rec in s["rollouts"]:
            line = f"  {rec.get('event'):16s} stage={rec.get('stage')}"
            for k in ("outcome", "replica", "canary_requests",
                      "reason"):
                if rec.get(k) is not None:
                    line += f" {k}={rec[k]}"
            out.append(line)
    if s.get("requests"):
        out.append("")
        out.append(f"requests: {len(s['requests'])} with per-request "
                   f"timelines (render one with --request RID)")
    if s["metrics"]:
        out.append("")
        out.append("last metrics snapshot:")
        for rec in s["metrics"]:
            lbl = ("{" + ",".join(f"{k}={v}" for k, v in
                                  sorted(rec["labels"].items())) + "}"
                   if rec.get("labels") else "")
            if rec["type"] == "histogram":
                out.append(f"  {rec['name']}{lbl} count={rec['count']} "
                           f"sum={rec['sum']} min={rec['min']} "
                           f"max={rec['max']}")
            else:
                out.append(f"  {rec['name']}{lbl} = {rec['value']}")
    return "\n".join(out)


def format_request_timeline(summary: dict, rid: str) -> str:
    """Human rendering of ONE request's timeline from a
    `summarize_jsonl` summary — submit through finish, every jsonl
    event and rid-stamped span in time order."""
    entries = summary.get("requests", {}).get(rid)
    if entries is None:
        known = sorted(summary.get("requests", {}))
        preview = ", ".join(known[:8]) + ("..." if len(known) > 8 else "")
        raise KeyError(f"no records for request id {rid!r} "
                       f"({len(known)} request ids in {summary['path']}"
                       f"{': ' + preview if known else ''})")
    out = [f"request {rid} — {len(entries)} records "
           f"({summary['path']}):"]
    prev = None
    for e in entries:
        t = ("t+?     " if e["t_s"] is None
             else f"t+{e['t_s'] * 1e3:9.3f}ms")
        # per-hop latency attribution: wall time since the PREVIOUS
        # timeline record, so "where did the request wait" reads
        # straight off the merged cluster view
        delta = ""
        if e["t_s"] is not None:
            if prev is not None:
                delta = f" (+{(e['t_s'] - prev) * 1e3:.3f}ms)"
            prev = e["t_s"]
        dur = (f" [{e['dur_ms']:.3f} ms]"
               if isinstance(e.get("dur_ms"), (int, float)) else "")
        detail = " ".join(
            f"{k}={v}" for k, v in sorted(e["detail"].items())
            if v is not None)
        out.append(f"  {t}  {e['what']:22s}{dur}"
                   + (f"  {detail}" if detail else "") + delta)
    return "\n".join(out)
