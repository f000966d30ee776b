"""Fixed-slot continuous-batching decode engine, the counterpart of the
contiguous engine in ``idc_models_tpu/serve/engine.py``.

The serial `Generator` (``models/lm.py``) serves one request start to
finish. This engine decodes `n_slots` requests TOGETHER, one batch row
each, and whenever a row finishes (EOS, budget, deadline) the scheduler
(``serve/scheduler.py``) drops a freshly prefilled request into the
vacated row while the other rows keep decoding.

All per-slot state lives on the device: per-block caches [S, t_max, H,
D] (float in `cache_dtype`, or int8 with per-(slot, head) f32 scales),
last-token logits [S, V], positions, budgets and stop ids [S], and one
`torch.Generator` per sampled slot. The host keeps a SHADOW of positions
and budgets and updates it by arithmetic from the fetched tokens, so a
window costs one device-to-host copy: its tokens.

- **window** -- `begin_window` issues up to W steps for every slot and
  returns: per step each live slot picks its token with the serial
  `pick` (greedy over the [S, V] logits, or one draw from the slot's own
  generator on its [1, V] row), the shared per-token forward
  (``models/lm._token_forward``) runs every row through the batched fold
  (``ring_decode.make_batched_ring_decode``), and budgets count down and
  EOS zeroes them on the device, so rows retire mid-window with no host
  sync. Dead rows append nothing. The tokens go to pinned host memory by
  a non-blocking copy behind a CUDA event; `collect` waits on it. The
  scheduler does its host work between the two (a two-deep pipeline).
- **prefill** -- the serial `Generator`'s own bucketed ring prefill
  (with ``block_impl="pallas"`` the flash update kernel, once a block),
  or with `prefill_chunk` its chunk program, one chunk a
  `prefill_step`.
- **insert** -- the request's [1, t_max] caches (quantized per head for
  int8), logits, position, budget, stop id and generator written into
  its row.

Parity with the serial `Generator`: prefill, the per-token forward and
the pick are the serial definitions, but the engine's products are
[S, E] @ W where the serial ones are [1, E] @ W, and neither the CPU
nor cuBLAS promises the same rounding for both. A request's logits
through the engine stay within the cache dtype's rounding of the serial
run's, and its tokens equal the serial tokens up to the first step where
the serial run's top-2 margin falls inside that tolerance (ROADMAP,
"Differences by design").

Left for later items, each raising NotImplementedError with its label:
paged KV and the prefix cache (A9.2), speculative decoding (A9.3), the
adapter bank (A9.4), slot export/import and the compile cache (A10),
partition rules and meshes of several ranks (A9-dist).
"""

from __future__ import annotations

import numpy as np
import torch

from idc_models_tpu_torch import convert
from idc_models_tpu_torch.models.lm import (
    Generator, _pad_prompt, _prefill, _token_forward, prefill_bucket,
)
from idc_models_tpu_torch.observe import trace
from idc_models_tpu_torch.ring_decode import make_batched_ring_decode

# a last-token logit past this magnitude is corruption, not a model
# output: the finite-garbage fault class a pure isfinite check misses
_HEALTH_LOGIT_LIMIT = 1e30
HEALTH_KINDS = {1: "nonfinite_logits", 2: "logit_magnitude"}


def later(label: str, what: str) -> NotImplementedError:
    """The error of a knob or method a later ROADMAP item ports."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {label})")


def _quantize_row(x):
    """[1, t_max, H, D] float -> (int8 values, [H] per-head scale):
    absmax / 127 over every (position, dim) of the row, floored so an
    all-zero row divides safely."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=(0, 1, 3)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[None, None, :, None]), -127, 127)
    return q.to(torch.int8), s


class _PendingPrefill:
    """One chunked prefill in flight: the prompt, the single-request
    caches being extended chunk by chunk, and where the next chunk
    starts."""

    __slots__ = ("prompt", "budget", "rng", "eos_id", "caches", "logits",
                 "next_start", "tag")

    def __init__(self, *, prompt, budget, rng, eos_id, caches, tag):
        self.prompt = prompt
        self.budget = budget
        self.rng = rng
        self.eos_id = eos_id
        self.caches = caches
        self.logits = None
        self.next_start = 0
        self.tag = tag


class SlotEngine:
    """`n_slots` concurrent decode rows over one parameter tree (a JAX-
    shaped tree or an `AttentionLM`), on `device` (CUDA unless "cpu").

    The host-side contract: `free_slots()` lists vacant rows;
    `admit(slot, prompt, budget, ...)` prefills and writes a request into
    a row (or `start_prefill` / `prefill_step` chunk by chunk);
    `begin_window` / `collect` run the pipelined masked windows
    (`step_window` is the pair); `finished` / `release` recycle rows.
    Scheduling policy lives in ``serve/scheduler.py``."""

    def __init__(self, params, *, embed_dim: int, num_heads: int,
                 num_blocks: int, t_max: int, n_slots: int = 4,
                 mesh=None, cache_dtype=torch.bfloat16,
                 block_impl: str = "jnp", temperature: float = 0.0,
                 top_k: int | None = None, pad_id: int = 0,
                 eos_id: int | None = None,
                 prefill_chunk: int | None = None, prefix_cache=None,
                 kv_dtype: str | None = None, draft_k: int | None = None,
                 kv_page_size: int | None = None,
                 kv_pages: int | None = None,
                 kv_decode_reserve: int | None = None, adapter_bank=None,
                 partition_rules=None, draft_model=None,
                 draft_partition_rules=None, device=None):
        if n_slots < 1:
            raise ValueError(f"need n_slots >= 1, got {n_slots}")
        for label, what, value in (
                ("A9.2", "paged KV (kv_page_size, kv_pages, "
                 "kv_decode_reserve)",
                 (kv_page_size, kv_pages, kv_decode_reserve)),
                ("A9.2", "the prefix cache", (prefix_cache,)),
                ("A9.3", "speculative decoding (draft_k, draft_model)",
                 (draft_k, draft_model, draft_partition_rules)),
                ("A9.4", "the tenant adapter bank", (adapter_bank,)),
                ("A9-dist", "serving under partition rules",
                 (partition_rules,))):
            if any(v is not None for v in value):
                raise later(label, what)
        if mesh is not None and mesh.size > 1:
            raise later("A9-dist", f"serving over a mesh of {mesh.size} "
                                   f"ranks")
        if kv_dtype not in (None, "bf16", "int8"):
            raise ValueError(f"kv_dtype must be None, 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        self.kv_int8 = kv_dtype == "int8"
        # the serial Generator is the engine's prefill, pick and model
        self._gen = Generator(
            params, embed_dim=embed_dim, num_heads=num_heads,
            num_blocks=num_blocks, t_max=t_max, cache_dtype=cache_dtype,
            block_impl=block_impl, temperature=temperature, top_k=top_k,
            prefill_chunk=prefill_chunk, device=device)
        self._cfg, self._model = self._gen._cfg, self._gen._model
        self._pick = self._gen._pick
        self.device = self._gen.device
        self.prefill_chunk = self._gen.prefill_chunk
        self._fold = make_batched_ring_decode(quantized=self.kv_int8)
        self.t_max = t_max
        self.n_slots = n_slots
        self.pad_id = int(pad_id)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.vocab = int(self._model.embed.shape[0])
        # a pallas prefill needs a bucket of at least 128 (the flash
        # kernel's tile); warmup prefills at the smallest legal one
        self._min_bucket = 128 if block_impl == "pallas" else 1
        dev = self.device
        head_dim = embed_dim // num_heads

        def rows(dtype):
            return torch.zeros((n_slots, t_max, num_heads, head_dim),
                               dtype=dtype, device=dev)

        cdt = torch.int8 if self.kv_int8 else cache_dtype
        self._caches = tuple((rows(cdt), rows(cdt))
                             for _ in range(num_blocks))
        self._scales = tuple(
            tuple(torch.zeros((n_slots, num_heads), device=dev)
                  for _ in range(2))
            for _ in range(num_blocks)) if self.kv_int8 else ()
        self._logits = torch.zeros((n_slots, self.vocab),
                                   dtype=self._model.head.kernel.dtype,
                                   device=dev)
        self._pos = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self._rem = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self._eos = torch.full((n_slots,), -1, dtype=torch.long, device=dev)
        self._gens: list = [None] * n_slots
        # host shadows (never fetched back from the device)
        self._pos_h = np.zeros(n_slots, np.int64)
        self._rem_h = np.zeros(n_slots, np.int64)
        self._eos_h = np.full(n_slots, -1, np.int64)
        self._occupied = np.zeros(n_slots, bool)
        self._pending = None     # (host tokens, event, snapshot)
        # chunked prefills in progress: slot -> _PendingPrefill; these
        # slots are reserved until the final chunk's insert
        self._prefills: dict[int, _PendingPrefill] = {}

    # -- slot lifecycle -------------------------------------------------

    def free_slots(self) -> list[int]:
        """Slots safe to admit into NOW. A slot released after a window
        was issued stays excluded until that window is collected: its
        in-flight tokens would otherwise go to the new request."""
        in_flight = (self._pending[2][1] if self._pending is not None
                     else None)
        return [s for s in range(self.n_slots)
                if not self._occupied[s] and s not in self._prefills
                and (in_flight is None or not in_flight[s])]

    def occupancy(self) -> float:
        return float(self._occupied.sum()) / self.n_slots

    def finished(self, slot: int) -> bool:
        return bool(self._occupied[slot]) and self._rem_h[slot] == 0

    def release(self, slot: int) -> None:
        """Vacate a slot (done, or a deadline cancel). Its device row is
        left as is: a cancelled row at worst rides along with its
        bounded remaining budget (dead rows never append or touch live
        ones), and the next insert overwrites the whole row."""
        self._occupied[slot] = False
        self._rem_h[slot] = 0

    def export_slot(self, slot: int) -> dict:
        raise later("A10", "slot export for migration")

    def import_slot(self, slot: int, snap: dict) -> None:
        raise later("A10", "slot import for migration")

    # -- admission --------------------------------------------------------

    def _validate_admit(self, slot, prompt, max_new_tokens, rng):
        """The one admission contract of both paths: one non-empty
        [1, P] prompt, lengths within t_max, an rng when sampling, a
        free slot."""
        if self._occupied[slot]:
            raise ValueError(f"slot {slot} is occupied")
        if slot in self._prefills:
            raise ValueError(f"slot {slot} has a prefill in progress")
        prompt = np.asarray(prompt, np.int64)
        if prompt.ndim == 1:
            prompt = prompt[None]
        if prompt.ndim != 2 or prompt.shape[0] != 1 or prompt.shape[1] < 1:
            raise ValueError(f"admit takes ONE non-empty [1, P] prompt, "
                             f"got shape {prompt.shape}")
        p_len = prompt.shape[1]
        if p_len > self.t_max:
            raise ValueError(f"prompt length {p_len} exceeds t_max "
                             f"{self.t_max}")
        if max_new_tokens < 1:
            raise ValueError(f"need max_new_tokens >= 1, got "
                             f"{max_new_tokens}")
        if p_len + max_new_tokens > self.t_max:
            raise ValueError(
                f"prompt {p_len} + max_new_tokens {max_new_tokens} "
                f"exceeds t_max {self.t_max} — the cache cannot grow at "
                f"decode time")
        if self.temperature > 0.0 and rng is None:
            raise ValueError("sampling (temperature > 0) needs an rng "
                             "key (or integer seed) per request")
        return prompt

    def _generator(self, rng):
        """A request's sampling stream: an integer seed becomes
        ``torch.Generator(device).manual_seed(seed)``, the stream a
        serial `Generator` call given that generator draws from."""
        if rng is None or isinstance(rng, torch.Generator):
            return rng
        seed = int(rng)
        if seed < 0:
            raise ValueError(f"need a non-negative seed, got {seed}")
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def _insert(self, slot, caches1, logits1, p_len, max_new_tokens,
                eos_id, rng) -> None:
        """Write a fully prefilled request into its batch row -- the
        shared tail of both admission paths."""
        eos = self.eos_id if eos_id is None else eos_id
        eos = -1 if eos is None else int(eos)
        gen = self._generator(rng)
        for i, ((kc, vc), (nk, nv)) in enumerate(zip(self._caches,
                                                     caches1)):
            if self.kv_int8:
                nk, k_s = _quantize_row(nk)
                nv, v_s = _quantize_row(nv)
                self._scales[i][0][slot] = k_s
                self._scales[i][1][slot] = v_s
            kc[slot] = nk[0].to(kc.dtype)
            vc[slot] = nv[0].to(vc.dtype)
        self._logits[slot] = logits1[0].to(self._logits.dtype)
        self._pos[slot] = p_len
        self._rem[slot] = max_new_tokens
        self._eos[slot] = eos
        self._gens[slot] = gen
        self._pos_h[slot] = p_len
        self._rem_h[slot] = max_new_tokens
        self._eos_h[slot] = eos
        self._occupied[slot] = True

    @torch.no_grad()
    def admit(self, slot: int, prompt, max_new_tokens: int, *, rng=None,
              eos_id: int | None = None, tag=None) -> None:
        """Prefill `prompt` ([P] or [1, P]) and write it into `slot`,
        every other slot's state untouched. `rng` seeds this request's
        sampling stream: an integer seed or a ``torch.Generator`` on the
        engine's device. May be called with a window in flight: the
        writes land after it on the stream, and the slot (vacant in the
        flying window) decodes from the next one. With `prefill_chunk`
        the whole prompt still lands in this one call, chunk by chunk.
        `tag` (the scheduler passes the request id) labels the prefill
        spans."""
        if self.prefill_chunk is not None:
            self.start_prefill(slot, prompt, max_new_tokens, rng=rng,
                               eos_id=eos_id, tag=tag)
            while not self.prefill_step(slot):
                pass
            return
        prompt = self._validate_admit(slot, prompt, max_new_tokens, rng)
        p_len = prompt.shape[1]
        bucket = prefill_bucket(p_len, self.t_max, 1)
        with trace.span("serve.prefill", slot=slot, p_len=p_len,
                        bucket=bucket, rid=tag):
            padded, _ = _pad_prompt(torch.from_numpy(prompt), self.t_max, 1)
            logits1, caches1 = _prefill(self._cfg, self._model,
                                        self._gen._ring,
                                        padded.to(self.device), p_len)
            self._insert(slot, caches1, logits1, p_len, max_new_tokens,
                         eos_id, rng)

    # -- chunked prefill --------------------------------------------------

    def start_prefill(self, slot: int, prompt, max_new_tokens: int, *,
                      rng=None, eos_id: int | None = None,
                      tag=None) -> None:
        """Reserve `slot` for a chunked prefill of `prompt` without
        running anything: each later `prefill_step(slot)` runs one
        chunk, so a long prompt no longer stalls the in-flight decodes
        behind one monolithic prefill. The slot is out of `free_slots`
        until the final chunk's insert (or `cancel_prefill`)."""
        if self.prefill_chunk is None:
            raise RuntimeError("engine built without prefill_chunk")
        prompt = self._validate_admit(slot, prompt, max_new_tokens, rng)
        self._prefills[slot] = _PendingPrefill(
            prompt=prompt, budget=int(max_new_tokens), rng=rng,
            eos_id=eos_id, caches=self._gen.init_caches(1), tag=tag)

    @torch.no_grad()
    def prefill_step(self, slot: int) -> bool:
        """Advance `slot`'s pending prefill by ONE chunk; True once the
        request is admitted (the final chunk and the insert happen
        together)."""
        pend = self._prefills.get(slot)
        if pend is None:
            raise ValueError(f"slot {slot} has no prefill in progress")
        p_len = pend.prompt.shape[1]
        c = self.prefill_chunk
        start = pend.next_start
        end = min(start + c, p_len)
        with trace.span("serve.prefill_chunk", slot=slot, start=start,
                        end=end, p_len=p_len, rid=pend.tag):
            padded = torch.zeros((1, c), dtype=torch.long)
            padded[:, :end - start] = torch.from_numpy(
                pend.prompt[:, start:end])
            pend.logits, pend.caches = self._gen.prefill_chunk_step(
                pend.caches, padded, start, end)
            pend.next_start = end
        if end < p_len:
            return False
        del self._prefills[slot]
        self._insert(slot, pend.caches, pend.logits, p_len, pend.budget,
                     pend.eos_id, pend.rng)
        return True

    def cancel_prefill(self, slot: int) -> None:
        """Drop a pending prefill (deadline hit while still chunking):
        its partial caches are discarded and the slot is free at once --
        nothing reached the batch row."""
        self._prefills.pop(slot, None)

    def prefilling(self) -> list[int]:
        """Slots with a chunked prefill in progress, admission order."""
        return list(self._prefills)

    # -- decode ---------------------------------------------------------

    @torch.no_grad()
    def _window(self, n_steps: int, rem_before, occupied):
        """Issue `n_steps` masked steps over every row; [S, n_steps]
        tokens on the device (pad for dead steps). Nothing here waits on
        the device: liveness stays on the device, and the host knows
        only which rows may be live at step j (occupied, with budget
        left at the window's start) -- those draw from their generators,
        one draw a step, as the serial decode does; a row that hit EOS
        mid-window draws on into a stream its request no longer uses."""
        cfg, model, fold = self._cfg, self._model, self._fold
        scales = self._scales
        toks_out = []
        for j in range(n_steps):
            live = self._rem > 0
            if self.temperature == 0.0:
                toks = self._pick(self._logits)
            else:
                toks = torch.cat([
                    self._pick(self._logits[s:s + 1], self._gens[s])
                    if occupied[s] and j < rem_before[s]
                    else torch.zeros(1, dtype=torch.long,
                                     device=self.device)
                    for s in range(self.n_slots)])
            toks = torch.where(live, toks, self.pad_id)
            pos = self._pos

            def block_fold(i, kc, vc, q, k, v, pos=pos, live=live):
                return fold(kc, vc, q, k, v, pos, live,
                            *(scales[i] if scales else ()))

            logits, self._caches = _token_forward(
                cfg, model, self._caches, toks,
                pos.clamp(max=self.t_max - 1), block_fold)
            self._logits = torch.where(live[:, None], logits, self._logits)
            self._pos = torch.where(live, pos + 1, pos)
            rem = torch.where(live, self._rem - 1, self._rem)
            hit = live & (self._eos >= 0) & (toks == self._eos)
            self._rem = torch.where(hit, 0, rem)
            toks_out.append(toks)
        return torch.stack(toks_out, 1)

    def begin_window(self, n_steps: int) -> None:
        """Issue ONE masked window of up to `n_steps` tokens per slot and
        return without waiting; `collect` returns its tokens. At most
        one window may be in flight."""
        if self._pending is not None:
            raise RuntimeError("a window is already in flight — "
                               "collect() it first")
        if n_steps < 1:
            raise ValueError(f"need n_steps >= 1, got {n_steps}")
        snapshot = (self._rem_h.copy(), self._occupied.copy(),
                    self._eos_h.copy())
        toks = self._window(n_steps, snapshot[0], snapshot[1])
        event = None
        if toks.is_cuda:
            host = torch.empty(toks.shape, dtype=toks.dtype,
                               pin_memory=True)
            host.copy_(toks, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            toks = host
        self._pending = (toks, event, snapshot)

    def abort_window(self) -> None:
        """Discard an in-flight window without collecting it (the
        scheduler's failure cleanup): the host shadows keep their values
        from before it was issued."""
        self._pending = None

    def collect(self) -> dict[int, list[int]]:
        """Wait for the in-flight window's tokens ({} if none) and replay
        the device's retirement rule onto the host shadows: live steps
        are a prefix of the window, and an EOS zeroes the budget after
        it is emitted. Returns {slot: tokens emitted} for the slots
        occupied when the window was issued."""
        if self._pending is None:
            return {}
        toks, event, (rem_before, occupied, eos_h) = self._pending
        self._pending = None
        # the one host transfer, and where the serve loop waits on the
        # device: bracketed as device.sync for step-time attribution
        with trace.span("device.sync"):
            if event is not None:
                event.synchronize()
            toks = toks.numpy()
        out = {}
        for s in range(self.n_slots):
            if not occupied[s]:
                continue
            n = int(min(rem_before[s], toks.shape[1]))
            row = [int(t) for t in toks[s, :n]]
            if eos_h[s] >= 0 and eos_h[s] in row:
                row = row[:row.index(int(eos_h[s])) + 1]
                self._rem_h[s] = 0
            else:
                self._rem_h[s] = rem_before[s] - len(row)
            self._pos_h[s] += len(row)
            out[s] = row
        return out

    def step_window(self, n_steps: int) -> dict[int, list[int]]:
        """Synchronous window: begin + collect."""
        self.begin_window(n_steps)
        return self.collect()

    # -- health -----------------------------------------------------------

    @torch.no_grad()
    def slot_health(self) -> np.ndarray:
        """Per-slot fault codes ([n_slots] int32, see `HEALTH_KINDS`): 0
        healthy, 1 non-finite last-token logits, 2 finite but past the
        magnitude bound. One small reduction and one [S] fetch, run
        before the next window so a poisoned slot is quarantined before
        a token is sampled from it."""
        lf = self._logits.float()
        nonfinite = (~torch.isfinite(lf)).any(1)
        huge = (lf.abs() > _HEALTH_LOGIT_LIMIT).any(1)
        codes = torch.where(nonfinite, 1, torch.where(huge, 2, 0))
        return codes.to(torch.int32).cpu().numpy()

    def slot_invariants_ok(self, slot: int) -> bool:
        """Host-shadow sanity for one slot (no device traffic)."""
        return bool(0 <= self._pos_h[slot] <= self.t_max
                    and self._rem_h[slot] >= 0)

    def inject_slot_fault(self, slot: int, kind: str) -> None:
        """Fault-injection hook: corrupt `slot`'s last-token logits in
        place -- NaN for ``nan_logits``, 1e32 (past the health bound,
        inside every float range) for ``garbage_logits``."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.n_slots})")
        try:
            val = {"nan_logits": float("nan"),
                   "garbage_logits": 1e32}[kind]
        except KeyError:
            raise ValueError(
                f"inject_slot_fault kind must be 'nan_logits' or "
                f"'garbage_logits', got {kind!r}") from None
        self._logits[slot] = val

    def swap_params(self, params) -> None:
        """Hot-swap the serving weights. The candidate tree must match
        the live one leaf for leaf in name, shape and dtype. The weights
        are copied in place on the stream, so an in-flight window reads
        the old ones and the next the new; running slots keep their
        caches."""
        live = {n.replace(".", "/"): (tuple(p.shape),
                                      str(p.dtype).removeprefix("torch."))
                for n, p in self._model.named_parameters()}
        cand = {n: (tuple(np.shape(a)), str(np.asarray(a).dtype))
                for n, a in convert.flatten(params).items()}
        if live != cand:
            only_live = sorted(set(live) - set(cand))
            only_cand = sorted(set(cand) - set(live))
            diff = sorted(n for n in set(live) & set(cand)
                          if live[n] != cand[n])
            raise ValueError(
                f"swap_params candidate does not match the serving "
                f"tree: live-only leaves {only_live}, candidate-only "
                f"{only_cand}, shape/dtype mismatches "
                f"{[(n, live[n], cand[n]) for n in diff]} — a rollout "
                f"swaps WEIGHTS, not architectures; rebuild the server "
                f"for a different model")
        with torch.no_grad():
            convert.load_jax(self._model, params)

    # -- the rest -----------------------------------------------------------

    def warmup(self, n_steps: int, compile_cache=None) -> None:
        """Run every program the serve loop touches once on the empty
        state: a prefill (one chunk when chunked, else the smallest
        bucket the block impl takes), two insert -> window cycles into
        slot 0 with a zero budget (every row dead, so the windows are
        bit-level no-ops) and the health reduction. Eager PyTorch
        compiles nothing; this pays the first calls' one-time costs
        (library handles, the allocator) before traffic."""
        if compile_cache is not None:
            raise later("A10", "the compile cache")
        with torch.no_grad():
            if self.prefill_chunk is not None:
                caches1 = self._gen.init_caches(1)
                logits1, caches1 = self._gen.prefill_chunk_step(
                    caches1, torch.zeros((1, self.prefill_chunk),
                                         dtype=torch.long),
                    0, self.prefill_chunk)
            else:
                b = min(self._min_bucket, self.t_max)
                logits1, caches1 = _prefill(
                    self._cfg, self._model, self._gen._ring,
                    torch.zeros((1, b), dtype=torch.long,
                                device=self.device), b)
        occupied = self._occupied[0]
        for _ in range(2):
            self._insert(0, caches1, logits1, 1, 0, -1, None)
            self._occupied[0] = occupied
            self.step_window(n_steps)
        self.slot_health()

    def kv_bytes_per_slot(self) -> int:
        """Device bytes of cache state per slot (K + V rows of every
        block, plus the dequantization scales when int8) -- the
        denominator of the int8 capacity claim."""
        per = sum(kc.nbytes + vc.nbytes for kc, vc in self._caches)
        per += sum(s.nbytes for pair in self._scales for s in pair)
        return per // self.n_slots

    def kv_bytes_resident(self) -> int:
        """Device bytes of KV state reserved: every slot's full row."""
        return self.n_slots * self.kv_bytes_per_slot()

    def tokens_resident(self) -> int:
        """Tokens of KV held right now: decoded positions of occupied
        slots plus prefilled positions of pending chunked admissions."""
        toks = int(sum(int(self._pos_h[s]) for s in range(self.n_slots)
                       if self._occupied[s]))
        return toks + int(sum(p.next_start for p in self._prefills.values()))

    def cache_sizes(self) -> dict:
        """The JAX engine's per-program compile-cache counts. Eager
        PyTorch compiles no serving program: every count is 0."""
        out = {"window": 0, "insert": 0, "health": 0}
        out["prefill" if self.prefill_chunk is None
            else "prefill_chunk"] = 0
        return out
