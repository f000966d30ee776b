"""Request journal: a jsonl write-ahead log of the server's accepted
work, from which a rebuilt server recovers the requests a crash left in
flight -- the counterpart of ``idc_models_tpu/serve/journal.py``, with
its event names, keys and file format (either package reads the other's
journal).

Records go through `observe.JsonlLogger`, in a file of their own:

- ``journal_submit``   at acceptance: id, prompt tokens, budget, eos,
  the integer seed (a `torch.Generator` is not journalable), the
  original relative deadline, the trace id and, when the request is
  tagged, its tenant;
- ``journal_progress`` one batched record of every emitting request's
  cumulative token count, written every `progress_every` calls (a cost
  knob: recovery reruns a request from its prompt, and the engine's
  serial-parity contract makes the rerun's tokens the uncrashed run's);
- ``journal_finish``   at any terminal state, with the status;
- ``journal_migrate``  a mid-decode slot migration (observability; the
  recovery semantics ride on the submit/finish pair).

Recovery is `pending_requests(path)`: every journaled submit without a
finish, in submit order, fed back through `LMServer.resubmit_pending`.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from idc_models_tpu_torch.observe import JsonlLogger
from idc_models_tpu_torch.serve.api import Request


class RequestJournal:
    """Append-only WAL the scheduler writes through. Opened line-buffered
    at `path`; `close()` fsyncs. Hand the same path to the rebuilt
    server, so its recovery records append after the crashed run's."""

    def __init__(self, path: str | os.PathLike, *,
                 progress_every: int = 8):
        if progress_every < 1:
            raise ValueError(f"need progress_every >= 1, got "
                             f"{progress_every}")
        self.path = Path(path)
        self.progress_every = int(progress_every)
        self._progress_skips = 0
        self._logger = JsonlLogger(self.path)

    def record_submit(self, entry, *, deadline_s: float | None) -> None:
        """One accepted request, with all `pending_requests` needs to
        rebuild it. `deadline_s` is the original relative deadline (the
        scheduler rewrites `entry.deadline` to its clock's time, which
        means nothing to a recovering process)."""
        seed = (int(entry.rng)
                if isinstance(entry.rng, (int, np.integer)) else None)
        # the tenant tag travels the WAL, so a recovered request bills
        # the same tenant; written only when tagged, so untenanted
        # journals keep their bytes
        tkw = ({"tenant": entry.tenant}
               if getattr(entry, "tenant", None) is not None else {})
        self._logger.log(
            event="journal_submit", id=entry.rid,
            prompt=[int(t) for t in np.asarray(entry.prompt).reshape(-1)],
            max_new_tokens=int(entry.budget), eos_id=entry.eos_id,
            seed=seed, deadline_s=deadline_s, trace_id=entry.trace_id,
            **tkw)

    def record_progress(self, tokens_by_rid: dict) -> None:
        """One batched record of every request that emitted this cycle
        ({rid: cumulative tokens}), written every `progress_every`
        calls."""
        if not tokens_by_rid:
            return
        self._progress_skips += 1
        if self._progress_skips < self.progress_every:
            return
        self._progress_skips = 0
        self._logger.log(event="journal_progress",
                         tokens={str(r): int(n)
                                 for r, n in tokens_by_rid.items()})

    def record_finish(self, rid, status: str,
                      reason: str | None = None) -> None:
        self._logger.log(event="journal_finish", id=rid, status=status,
                         reason=reason)

    def record_migrate(self, rid, direction: str, *, peer: str) -> None:
        """One mid-decode migration boundary: ``"out"`` (this server
        exported the slot) or ``"in"`` (it imported it), `peer` the
        other server."""
        if direction not in ("out", "in"):
            raise ValueError(f"migration direction must be 'out' or "
                             f"'in', got {direction!r}")
        self._logger.log(event="journal_migrate", id=rid,
                         direction=direction, peer=peer)

    def close(self) -> None:
        self._logger.close()

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_journal(path) -> dict:
    """Parse a journal file into ``{"pending": [Request, ...],
    "finished": {id: status}, "progress": {id: tokens}}``. A request
    re-submitted by an earlier recovery appears once (the last submit
    wins); a malformed line raises: a torn WAL is an error, not
    something to skip."""
    submits: dict = {}
    finished: dict = {}
    progress: dict = {}
    order: list = []
    for i, line in enumerate(Path(path).read_text().splitlines()):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            raise ValueError(f"journal {path}: line {i + 1} is not "
                             f"JSON: {e}") from None
        ev = rec.get("event")
        if ev == "journal_submit":
            rid = rec["id"]
            if rid not in submits:
                order.append(rid)
            submits[rid] = rec
            # a re-submit after recovery reopens the request
            finished.pop(rid, None)
        elif ev == "journal_finish":
            # an engine-failure death (status error, reason error: the
            # crash cleanup) is an in-flight loss to replay; every other
            # terminal state (ok, deadline, shed, an exhausted
            # slot_fault) is the request's final answer
            if (rec.get("status") == "error"
                    and rec.get("reason") == "error"):
                finished.pop(rec["id"], None)
            else:
                finished[rec["id"]] = rec.get("status")
        elif ev == "journal_progress":
            for rid, n in rec.get("tokens", {}).items():
                progress[rid] = int(n)
    pending = []
    for rid in order:
        if rid in finished:
            continue
        rec = submits[rid]
        pending.append(Request(
            id=str(rid), prompt=tuple(rec["prompt"]),
            max_new_tokens=int(rec["max_new_tokens"]),
            eos_id=rec.get("eos_id"), seed=rec.get("seed"),
            deadline_s=rec.get("deadline_s"),
            trace_id=rec.get("trace_id"), tenant=rec.get("tenant")))
    return {"pending": pending, "finished": finished,
            "progress": progress}


def pending_requests(path) -> list[Request]:
    """The requests a crashed run accepted but never finished, in submit
    order."""
    return load_journal(path)["pending"]
