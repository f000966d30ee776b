"""User-facing serving surface: `Request` / `Result`, the synchronous
`submit()` / `poll()` API and `run(trace)` trace replay -- the
counterpart of ``idc_models_tpu/serve/api.py``.

`LMServer` composes `SlotEngine` (the device state machine),
`Scheduler` (admission queue, deadlines, interleave, recycling) and
`ServingMetrics` (TTFT, throughput, occupancy):

    server = LMServer(params, embed_dim=..., num_heads=...,
                      num_blocks=..., t_max=..., n_slots=4, window=8)
    server.submit(Request(id="a", prompt=(1, 2, 3), max_new_tokens=16))
    while server.poll("a") is None:
        server.step()                  # one scheduler tick
    print(server.poll("a").tokens)

`poisson_trace` synthesizes open-loop Poisson arrivals, and
`save_trace` / `load_trace` move the same ``(arrival_s, Request)`` list
through a JSONL file (byte for byte the JAX package's format).
`run(trace)` replays either, by the wall clock (``realtime=True``) or
as a burst.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. `seed` derives the request's private
    sampling stream (``torch.Generator(device).manual_seed(seed)``, the
    stream a serial `Generator` call given that generator draws);
    `deadline_s` is seconds from submit after which the request is
    dropped (queued) or cancelled (running); `eos_id` overrides the
    server's stop token (-1: never stop early); `trace_id` labels the
    request's spans (None: assigned at submit); `tenant` is for
    multi-tenant servers (ROADMAP A9.4)."""
    id: str
    prompt: tuple
    max_new_tokens: int
    eos_id: int | None = None
    seed: int | None = None
    deadline_s: float | None = None
    trace_id: str | None = None
    tenant: str | None = None


@dataclasses.dataclass
class Result:
    """What came back: `tokens` are the generated ids only, cut at EOS
    (inclusive). `status` is "ok" (ran to EOS or budget), "timeout"
    (deadline hit, possibly with partial tokens), "rejected" (queue full
    with on_full="reject"), or "error" (the engine failed mid-flight, or
    a quarantined slot ran out of retries; `error` says which).
    `attempts` / `retried` show the retry policy's work."""
    id: str
    tokens: list
    status: str
    finish_reason: str | None = None
    ttft_ms: float | None = None
    latency_ms: float | None = None
    error: str | None = None
    trace_id: str | None = None
    attempts: int = 1
    retried: bool = False


class LMServer:
    """Continuous-batching server over one `attention_lm` parameter tree
    (JAX-shaped, or an `AttentionLM`), on `device` (CUDA unless "cpu").
    With `warmup` the engine runs each of its programs once before the
    first request."""

    def __init__(self, params, *, embed_dim: int, num_heads: int,
                 num_blocks: int, t_max: int, n_slots: int = 4,
                 window: int = 8, mesh=None, cache_dtype=None,
                 block_impl: str = "jnp", temperature: float = 0.0,
                 top_k: int | None = None, pad_id: int = 0,
                 eos_id: int | None = None, max_queue_depth: int = 64,
                 max_prefills_per_cycle: int = 1,
                 admit_after_collect: bool = True, logger=None,
                 warmup: bool = True, clock=time.monotonic,
                 prefill_chunk: int | None = None,
                 prefix_cache_mb: float = 0.0,
                 kv_dtype: str | None = None, slo=None, retry=None,
                 fault_plan=None, health_checks: bool | None = None,
                 journal=None, brownout=None, prefix_cache=None,
                 spec_decode: bool = False, draft_k: int = 8,
                 draft_order: int = 3, drafter=None,
                 kv_page_size: int | None = None,
                 kv_pages: int | None = None,
                 kv_decode_reserve: int | None = None, registry=None,
                 tenancy=None, partition_rules=None,
                 draft_partition_rules=None, compile_cache=None,
                 device=None):
        from idc_models_tpu_torch.serve.engine import SlotEngine, later
        from idc_models_tpu_torch.serve.metrics import ServingMetrics
        from idc_models_tpu_torch.serve.scheduler import Scheduler

        if prefix_cache_mb:
            raise later("A9.2", "the prefix cache (prefix_cache_mb)")
        if spec_decode or drafter is not None:
            raise later("A9.3", "speculative decoding (spec_decode)")
        if compile_cache is not None:
            raise later("A10", "the compile cache")
        self.engine = SlotEngine(
            params, embed_dim=embed_dim, num_heads=num_heads,
            num_blocks=num_blocks, t_max=t_max, n_slots=n_slots,
            mesh=mesh,
            cache_dtype=(torch.bfloat16 if cache_dtype is None
                         else cache_dtype),
            block_impl=block_impl, temperature=temperature, top_k=top_k,
            pad_id=pad_id, eos_id=eos_id, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, kv_dtype=kv_dtype,
            kv_page_size=kv_page_size, kv_pages=kv_pages,
            kv_decode_reserve=kv_decode_reserve,
            partition_rules=partition_rules,
            draft_partition_rules=draft_partition_rules, device=device)
        self.metrics = ServingMetrics(logger, registry=registry, slo=slo)
        self.scheduler = Scheduler(
            self.engine, window=window, max_queue_depth=max_queue_depth,
            max_prefills_per_cycle=max_prefills_per_cycle,
            admit_after_collect=admit_after_collect,
            metrics=self.metrics, clock=clock, retry=retry,
            fault_plan=fault_plan, health_checks=health_checks,
            journal=journal, brownout=brownout, tenancy=tenancy)
        self._results: dict[str, Result] = {}
        self._inflight: set[str] = set()
        if warmup:
            self.engine.warmup(window)

    # -- synchronous API -------------------------------------------------

    def submit(self, request: Request) -> bool:
        """Enqueue a request. False = backpressure (queue at max depth);
        raises ValueError for requests that could never be served."""
        from idc_models_tpu_torch.serve.engine import later
        from idc_models_tpu_torch.serve.scheduler import Entry

        if request.tenant is not None:
            raise later("A9.4", "tenant-tagged requests")
        if request.id in self._results or request.id in self._inflight:
            # a duplicate in flight would overwrite the other's Result
            raise ValueError(f"request id {request.id!r} already used")
        entry = Entry(
            rid=request.id,
            prompt=np.asarray(request.prompt, np.int64),
            budget=int(request.max_new_tokens),
            eos_id=request.eos_id, rng=request.seed,
            deadline=request.deadline_s, trace_id=request.trace_id)
        if not self.scheduler.submit(entry):
            # backpressure: no Result, the caller may retry the same id
            return False
        self._inflight.add(request.id)
        return True

    def close(self) -> None:
        """Shut the server down: submit() afterwards raises. Accepted
        work can still be drained first."""
        self.scheduler.close()

    def step(self) -> list[Result]:
        """One scheduler tick (admissions + one decode window); returns
        the requests that finished on it. If the ENGINE fails mid-tick
        the error propagates, but the in-flight requests are first
        recorded as status="error" Results (slots released, queue
        intact), so poll() answers for them and a caller can go on."""
        finished = []
        try:
            ticked = self.scheduler.tick()
        except Exception:
            for e in self.scheduler.pop_failed():
                r = _to_result(e)
                self._results[r.id] = r
                self._inflight.discard(r.id)
            raise
        for e in ticked:
            r = _to_result(e)
            self._results[r.id] = r
            self._inflight.discard(r.id)
            finished.append(r)
        return finished

    def poll(self, rid: str) -> Result | None:
        """The finished Result for `rid`, or None while it is queued or
        running."""
        return self._results.get(rid)

    def results(self) -> list[Result]:
        """Every finished Result so far (what a caller salvages when
        run() is interrupted by an engine failure)."""
        return list(self._results.values())

    def drain(self) -> list[Result]:
        """Tick until idle; returns everything that finished."""
        out = []
        while not self.scheduler.idle():
            out.extend(self.step())
        return out

    # -- trace replay ----------------------------------------------------

    def run(self, trace, *, realtime: bool = False,
            on_full: str = "block") -> list[Result]:
        """Replay ``[(arrival_s, Request), ...]`` and drain. With
        ``realtime=True`` requests are held until their arrival offset
        on the wall clock (the honest open-loop TTFT); with False the
        trace replays as fast as the engine drains it, arrival order
        kept. `on_full` is the client's backpressure policy: "block"
        re-offers the head request every tick until the queue takes it;
        "reject" records a rejected Result and moves on."""
        if on_full not in ("block", "reject"):
            raise ValueError(f"on_full must be 'block' or 'reject', "
                             f"got {on_full!r}")
        trace = sorted(trace, key=lambda tr: tr[0])
        clock = self.scheduler.clock
        t0 = clock()
        out, i = [], 0
        while i < len(trace) or not self.scheduler.idle():
            now = clock() - t0
            while i < len(trace) and (not realtime
                                      or trace[i][0] <= now):
                # in block mode, do not OFFER a request the queue cannot
                # take: each refused submit counts as a rejection
                if (on_full == "block" and len(self.scheduler.queue)
                        >= self.scheduler.queue.max_depth):
                    break
                if self.submit(trace[i][1]):
                    i += 1
                elif on_full == "reject":
                    r = Result(id=trace[i][1].id, tokens=[],
                               status="rejected")
                    self._results[r.id] = r
                    out.append(r)
                    i += 1
                else:
                    break
            if realtime and self.scheduler.idle() and i < len(trace):
                # nothing running and the next arrival is in the future
                time.sleep(min(max(trace[i][0] - (clock() - t0), 0.0),
                               0.005))
                continue
            out.extend(self.step())
        return out

    def summary(self) -> dict:
        return self.metrics.summary()


def _to_result(e) -> Result:
    return Result(
        id=e.rid, tokens=list(e.tokens), status=e.status,
        finish_reason=e.finish_reason, error=e.error,
        trace_id=e.trace_id, attempts=e.attempts, retried=e.retried,
        ttft_ms=(None if e.t_first is None
                 else (e.t_first - e.t_submit) * 1e3),
        latency_ms=(None if e.t_done is None
                    else (e.t_done - e.t_submit) * 1e3))


# -- traces ---------------------------------------------------------------


def poisson_trace(n_requests: int, *, rate_per_s: float, vocab: int,
                  t_max: int, prompt_lens=(4, 16), budgets=(4, 16),
                  eos_id: int | None = None,
                  deadline_s: float | None = None, seed: int = 0,
                  sampled: bool = False, tenants=None):
    """Synthetic open-loop arrivals: exponential inter-arrival times at
    `rate_per_s`, prompt lengths and budgets uniform over the inclusive
    ranges (clamped so prompt + budget <= t_max). With ``sampled=True``
    each request carries its own seed. `tenants` tags arrivals
    round-robin. The same draws as the JAX package's, so the same
    arguments give the same trace. Returns ``[(arrival_s, Request),
    ...]``."""
    rng = np.random.default_rng(seed)
    t, trace = 0.0, []
    lo_p, hi_p = prompt_lens
    lo_b, hi_b = budgets
    tenants = list(tenants) if tenants else None
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_per_s))
        p_len = int(rng.integers(lo_p, hi_p + 1))
        p_len = min(p_len, t_max - 1)
        budget = int(rng.integers(lo_b, hi_b + 1))
        budget = min(budget, t_max - p_len)
        prompt = tuple(int(x) for x in rng.integers(0, vocab, p_len))
        trace.append((t, Request(
            id=f"r{i}", prompt=prompt, max_new_tokens=budget,
            eos_id=eos_id, deadline_s=deadline_s,
            seed=(int(rng.integers(0, 2**31)) if sampled else None),
            tenant=(tenants[i % len(tenants)] if tenants else None))))
    return trace


def save_trace(path, trace) -> str:
    """Write ``[(arrival_s, Request), ...]`` as JSONL, one request per
    line -- the format `run` / `load_trace` and ``serve --trace``
    share."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for t, r in trace:
            rec = {
                "t": t, "id": r.id, "prompt": list(r.prompt),
                "max_new_tokens": r.max_new_tokens, "eos_id": r.eos_id,
                "seed": r.seed, "deadline_s": r.deadline_s}
            if r.tenant is not None:
                # written only when tagged: untagged traces keep the
                # format's original bytes
                rec["tenant"] = r.tenant
            f.write(json.dumps(rec) + "\n")
    return str(path)


def load_trace(path):
    """Read a `save_trace` JSONL file back into ``[(t, Request), ...]``."""
    trace = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        d = json.loads(line)
        trace.append((float(d.get("t", 0.0)), Request(
            id=str(d["id"]), prompt=tuple(d["prompt"]),
            max_new_tokens=int(d["max_new_tokens"]),
            eos_id=d.get("eos_id"), seed=d.get("seed"),
            deadline_s=d.get("deadline_s"), tenant=d.get("tenant"))))
    return trace
