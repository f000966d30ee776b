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
- **verify** (`draft_k=K`) -- `begin_verify` is the speculative
  alternative to a window: the K drafted tokens of every participating
  row go through the chunk forward (``models/lm._chunk_batch_forward``
  over the batched chunk fold), each row picks its K+1 candidates by its
  request's rule (``cand[:, 0]`` is the stored logits, so the first
  emitted token is the window's own), accepts the longest matching draft
  prefix m and the bonus pick at m, truncates by budget and EOS, and
  runs one masked token step for the bonus (its K/V lands at pos + m).
  All of it stays on the device; `collect` reads back (tokens, emitted,
  accepted) through the window's pinned copy and event. A sampled row
  draws its K+1 candidates in order from its generator, keeping the
  generator's state after each draw, and `collect` rewinds it to the
  state after the emitted count: the stream advances exactly as that
  many serial draws.
- **learned drafter** (`draft_model`, ``models/draft_lm.DraftLM``) --
  its own per-slot caches [S, t_max, H_d, D_d] at the draft model's
  dims; an admission prefills the prompt minus its last token through
  the drafter (that token stays pending), `collect` queues emitted
  tokens, and `propose_all` ingests each slot's backlog in chunks of
  C = K + 1 and rolls K greedy draft steps for every qualifying slot in
  one call.

**Paged KV** (`kv_page_size`, `kv_pages`): the per-slot rows give way to
one pool of fixed-size pages per block, [kv_pages + 1, page_size, H, D]
(or int8 with [kv_pages + 1, H] f32 scales; the last page is the folds'
sink, which the allocator never grants), shared by every slot, and one int32
page table [S, t_max/page_size] (-1 = unallocated); the host
`PageAllocator` (``serve/pages.py``) grants each admission the pages of
its prompt plus the decode reservation. Prompts stream chunk by chunk
straight into the slot's pages (the paged chunk fold), and the windows
run the paged batched fold; the window loop, pick, sampling, retirement
and pipeline are the contiguous engine's. A released slot is KILLED in
the same step its pages go back (table row cleared, device budget
zeroed): stream order then keeps a window still in flight from writing
into a page the allocator grants again.

**Prefix cache** (``serve/prefix_cache.py``, needs `prefill_chunk`):
every completed chunk boundary of a prefill is snapshotted, and an
admission resumes from the longest cached prefix -- on a contiguous
engine from clones of the snapshot's caches (stored cut to the prefix),
on a paged engine by sharing the snapshot's pages, refcounted, no copy.

Parity with the serial `Generator`: prefill, the per-token forward and
the pick are the serial definitions, but the engine's products are
[S, E] @ W where the serial ones are [1, E] @ W, and neither the CPU
nor cuBLAS promises the same rounding for both. A request's logits
through the engine stay within the cache dtype's rounding of the serial
run's, and its tokens equal the serial tokens up to the first step where
the serial run's top-2 margin falls inside that tolerance (ROADMAP,
"Differences by design"). A paged engine gives the contiguous engine's
result bit for bit (float caches): only the cache indirection differs.

**Tenancy** (``serve/tenancy.py``): with an `adapter_bank` the engine
keeps a device row ``_tslot [S]`` of each slot's tenant id (written at
admission, ``tid=``) and applies ``models/lm.make_adapter_head_hook`` to
the logits each pick reads -- every window step, the verify's candidate
distributions and, with per-tenant drafter heads, the learned drafter's
picks. The stored per-slot logits stay BASE logits, so prefill and the
prefix-cache snapshots are shared by every tenant, and a mix of tenants
is a value of ``_tslot``: no new program, no host sync.

**Rollout and migration**: `spot_check_params` runs candidate weights
through the live module's own prefill (``torch.func.functional_call``)
on scratch state, `swap_params` copies them in place, and `export_slot`
/ `import_slot` move a decoding slot (its caches up to its position, its
logits, its generator's state and the learned drafter's row) to another
engine through the normal insert, bit for bit.

**Over ranks** (`mesh`, built by every rank): the caches, pools and the
learned drafter's caches shard over the mesh's "seq" ring -- each rank
holds t_max/n positions of every row, or its kv_pages/n pages plus a
sink of its own -- while page tables, positions, budgets, logits and the
int8 scales replicate. Prefills run the ring over the group (each rank
its block of the bucket), and every fold merges over it
(``ring_decode``). `partition_rules` (and `draft_partition_rules`) shard
the parameters over a "model" axis (``models/lm.py``'s plan); the caches
never take that axis. A "data" axis is refused: requests prefill one at
a time. Every rank runs the same calls in the same order
(``serve/api.py`` makes the host decisions alike), and the merged logits
-- so the tokens -- are the same on every rank.

**Compile cache** (``serve/compile_cache.py``): `warmup(compile_cache=)`
loads each serving program's kernel libraries from the store, or builds
and stores them, before the warmup calls launch them (keyed by the
kernels' digests and the toolchain).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from idc_models_tpu_torch import collectives, convert
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch import partition
from idc_models_tpu_torch.models.lm import (
    Generator, _chunk_batch_forward, _chunk_forward, _pad_prompt, _prefill,
    _serve_config, _token_forward, make_adapter_head_hook, prefill_bucket,
    prefill_buckets, serving_model,
)
from idc_models_tpu_torch.observe import trace
from idc_models_tpu_torch.ring_attention import make_ring_attention
from idc_models_tpu_torch.ring_decode import (
    make_batched_chunk_ring_decode, make_batched_ring_decode,
    make_paged_batched_chunk_ring_decode, make_paged_batched_ring_decode,
    make_paged_chunk_ring_decode,
)
from idc_models_tpu_torch.serve.pages import PageAllocator, PageExhausted

# a last-token logit past this magnitude is corruption, not a model
# output: the finite-garbage fault class a pure isfinite check misses
_HEALTH_LOGIT_LIMIT = 1e30
HEALTH_KINDS = {1: "nonfinite_logits", 2: "logit_magnitude"}


def _quantize_row(x, group=None):
    """[1, t_max, H, D] float (this rank's shard over the "seq" `group`)
    -> (int8 values, [H] per-head scale): absmax / 127 over every
    (position, dim) of the whole row -- one scale across the shards --
    floored so an all-zero row divides safely."""
    xf = x.float()
    m = xf.abs().amax(dim=(0, 1, 3))
    if group is not None:
        m = collectives.pmax(m, group)
    s = torch.clamp(m, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[None, None, :, None]), -127, 127)
    return q.to(torch.int8), s


def _host_tensor(a) -> torch.Tensor:
    """A snapshot's array as a tensor: a tensor as it is, a numpy array
    copied (the JAX package's may be read-only)."""
    return a if torch.is_tensor(a) else torch.from_numpy(np.array(a))


def _cut_to_prefix(caches, n_tokens: int):
    """A contiguous engine's [1, t_max] caches cut to their first
    `n_tokens` positions (the rest are zeros by construction): what a
    `PrefixCache` snapshot stores. A cache shard over a ring keeps its
    first min(n_tokens, t_max/n) positions: what rank 0 needs, so every
    rank stores (and budgets) a snapshot of one size."""
    return tuple((k[:, :n_tokens], v[:, :n_tokens]) for k, v in caches)


class _PendingPrefill:
    """One chunked prefill in flight: the prompt, the single-request
    caches being extended chunk by chunk, and where the next chunk
    starts (past any prefix-cache hit). On a paged engine `caches` is
    None (chunks write the slot's granted pool pages) and `pages` holds
    the grant, of which the first `shared` ids are prefix-cache pages
    the request only references."""

    __slots__ = ("prompt", "budget", "rng", "eos_id", "caches", "logits",
                 "next_start", "tag", "pages", "shared", "tid")

    def __init__(self, *, prompt, budget, rng, eos_id, caches, tag,
                 logits=None, next_start=0, pages=None, shared=0, tid=0):
        self.prompt = prompt
        self.budget = budget
        self.rng = rng
        self.eos_id = eos_id
        self.caches = caches
        self.logits = logits
        self.next_start = next_start
        self.tag = tag
        self.pages = pages
        self.shared = shared
        self.tid = tid


class _Probe(nn.Module):
    """The live model as the one submodule of a wrapper whose forward
    runs a given function over it, so ``torch.func.functional_call`` can
    put candidate tensors in place of its parameters for one call."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn(self.model)


class SlotEngine:
    """`n_slots` concurrent decode rows over one parameter tree (a JAX-
    shaped tree or an `AttentionLM`), on `device` (CUDA unless "cpu").

    The host-side contract: `free_slots()` lists vacant rows;
    `admit(slot, prompt, budget, ...)` prefills and writes a request into
    a row (or `start_prefill` / `prefill_step` chunk by chunk);
    `begin_window` / `collect` run the pipelined masked windows
    (`step_window` is the pair); `finished` / `release` recycle rows.
    Scheduling policy lives in ``serve/scheduler.py``. On a `mesh`
    every rank builds the engine and makes the same calls in the same
    order (module docstring, "Over ranks")."""

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
        if draft_partition_rules is not None and draft_model is None:
            raise ValueError(
                "draft_partition_rules without draft_model: the rules "
                "shard the learned drafter's params — pass draft_model "
                "(models/draft_lm.DraftLM.learned) or drop the rules")
        if partition_rules is not None and mesh is None:
            mesh = meshlib.seq_mesh(1)
        if mesh is not None:
            # the "model" axis is legal WITH partition rules: weights
            # shard over it while the caches keep the ring's layout.
            # Batch-bearing axes stay banned: requests prefill one at a
            # time and [1, P] batches cannot shard
            non_seq = [a for a in mesh.axis_names
                       if a not in (meshlib.SEQ_AXIS, meshlib.MODEL_AXIS)
                       and mesh.shape[a] > 1]
            if non_seq:
                raise ValueError(
                    f"serving mesh must be seq-only (plus an optional "
                    f"'model' weight axis): requests prefill one at a "
                    f"time ([1, P] batches cannot shard over axes "
                    f"{non_seq}); build the engine on mesh.seq_mesh(n) "
                    f"or mesh.fsdp_tp_mesh(1, tp, seq)")
            if (mesh.axis_size(meshlib.MODEL_AXIS) > 1
                    and partition_rules is None):
                raise ValueError(
                    "a 'model' mesh axis without partition_rules would "
                    "idle every device past the first ring: pass the "
                    "model's rule set (models/registry.py "
                    "get_partition_rules) so the params actually shard "
                    "over it")
        self.mesh = mesh
        self._partition_rules = partition_rules
        self._draft_partition_rules = draft_partition_rules
        self._block_impl = block_impl
        n_ring = mesh.axis_size(meshlib.SEQ_AXIS) if mesh is not None else 1
        if (kv_page_size is not None and kv_pages is not None
                and int(kv_pages) % n_ring):
            raise ValueError(
                f"kv_pages {kv_pages} must divide by the ring size "
                f"{n_ring}: the pool shards over the page dim")
        # paged KV: a pool of kv_pages fixed-size pages and per-slot page
        # tables replace the per-slot [t_max] rows, so device memory
        # holds the tokens resident, not every slot's worst case.
        # kv_decode_reserve bounds the decode tokens reserved at
        # admission (default: the whole budget, never exhausting
        # mid-decode); a smaller reserve admits optimistically and grows
        # grants mid-decode, which can exhaust (a scheduler quarantine)
        if (kv_page_size is None) != (kv_pages is None):
            raise ValueError(
                "paged KV needs BOTH kv_page_size and kv_pages (or "
                "neither for the contiguous per-slot ring rows)")
        self.paged = kv_page_size is not None
        if self.paged:
            kv_page_size, kv_pages = int(kv_page_size), int(kv_pages)
            if prefill_chunk is None:
                raise ValueError(
                    "paged KV needs chunked prefill (prefill_chunk=C):"
                    " prompts stream straight into pool pages chunk by"
                    " chunk — there is no monolithic [1, t_max] cache "
                    "to insert from")
            if kv_page_size < 1 or t_max % kv_page_size:
                raise ValueError(
                    f"kv_page_size {kv_page_size} must be >= 1 and "
                    f"divide t_max {t_max} so logical pages tile the "
                    f"position space")
            if int(prefill_chunk) % kv_page_size:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} must be a multiple"
                    f" of kv_page_size {kv_page_size}: chunk "
                    f"boundaries must land on the page grid so "
                    f"completed pages are never rewritten (the prefix-"
                    f"cache sharing invariant)")
            if kv_pages * kv_page_size < t_max:
                raise ValueError(
                    f"kv_pages {kv_pages} x kv_page_size "
                    f"{kv_page_size} < t_max {t_max}: one full-length "
                    f"request could never be admitted")
            if kv_decode_reserve is not None and kv_decode_reserve < 1:
                raise ValueError(f"need kv_decode_reserve >= 1, got "
                                 f"{kv_decode_reserve}")
        elif kv_decode_reserve is not None:
            raise ValueError("kv_decode_reserve needs paged KV "
                             "(kv_page_size/kv_pages)")
        self.kv_page_size = kv_page_size
        self.kv_pages = kv_pages
        self.kv_decode_reserve = kv_decode_reserve
        # draft_k arms speculative decoding: begin_verify checks exactly
        # K drafts a slot; None leaves the engine as it was
        if draft_k is not None:
            draft_k = int(draft_k)
            if not 1 <= draft_k <= t_max - 2:
                raise ValueError(
                    f"draft_k {draft_k} outside [1, t_max - 2]: a "
                    f"verify needs room for K drafts + the bonus "
                    f"token inside the {t_max}-slot cache")
        self.draft_k = draft_k
        if kv_dtype not in (None, "bf16", "int8"):
            raise ValueError(f"kv_dtype must be None, 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        self.kv_int8 = kv_dtype == "int8"
        if prefix_cache is not None and prefill_chunk is None:
            raise ValueError(
                "a prefix cache needs chunked prefill (prefill_chunk=C):"
                " snapshots live on chunk boundaries and only the chunk "
                "program can extend a cached prefix")
        # the serial Generator is the engine's prefill, pick and model
        self._gen = Generator(
            params, embed_dim=embed_dim, num_heads=num_heads,
            num_blocks=num_blocks, t_max=t_max, mesh=mesh,
            cache_dtype=cache_dtype, block_impl=block_impl,
            temperature=temperature, top_k=top_k,
            prefill_chunk=prefill_chunk, partition_rules=partition_rules,
            device=device)
        self._cfg, self._model = self._gen._cfg, self._gen._model
        self._group, self._n_ring = self._cfg.group, self._cfg.n_ring
        self._pick = self._gen._pick
        self.device = self._gen.device
        self.prefill_chunk = self._gen.prefill_chunk
        self.prefix_cache = prefix_cache
        if (prefix_cache is not None
                and prefix_cache.chunk != self.prefill_chunk):
            raise ValueError(
                f"prefix cache chunk {prefix_cache.chunk} != engine "
                f"prefill_chunk {self.prefill_chunk}")
        cache_is_paged = bool(getattr(prefix_cache, "is_paged", False))
        if prefix_cache is not None and cache_is_paged != self.paged:
            raise ValueError(
                "prefix-cache flavor must match the engine: a paged "
                "engine shares pool pages with PagedPrefixCache "
                "snapshots; a contiguous engine stores array snapshots "
                "in PrefixCache")
        if prefix_cache is not None and not cache_is_paged:
            shard = t_max // self._n_ring
            prefix_cache.set_packer(
                lambda caches, n: _cut_to_prefix(caches, min(n, shard)),
                self._pad_to_t_max)
        group = self._group
        if self.paged:
            self._fold = make_paged_batched_ring_decode(
                page_size=kv_page_size, quantized=self.kv_int8, group=group)
            self._chunk_fold = make_paged_chunk_ring_decode(
                page_size=kv_page_size, quantized=self.kv_int8, group=group)
            self._vfold = make_paged_batched_chunk_ring_decode(
                page_size=kv_page_size, quantized=self.kv_int8, group=group)
        else:
            self._fold = make_batched_ring_decode(quantized=self.kv_int8,
                                                  group=group)
            self._vfold = make_batched_chunk_ring_decode(
                quantized=self.kv_int8, group=group)
        self.t_max = t_max
        self.n_slots = n_slots
        self.pad_id = int(pad_id)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.vocab = int(self._model.embed.shape[0])
        # a pallas prefill needs a bucket of at least 128 a rank (the
        # flash kernel's tile); warmup prefills at the smallest legal one
        self._min_bucket = ((128 if block_impl == "pallas" else 1)
                            * self._n_ring)
        dev = self.device
        head_dim = embed_dim // num_heads
        # per block: each slot's [t_max] rows (this rank's t_max/n of
        # them), or the pool of pages (the page count, not the slot
        # count, is what a memory budget buys: this rank's kv_pages/n)
        # and the folds' sink page
        rows, width = ((kv_pages // self._n_ring + 1, kv_page_size)
                       if self.paged else (n_slots, t_max // self._n_ring))

        def cache(dtype):
            return torch.zeros((rows, width, num_heads, head_dim),
                               dtype=dtype, device=dev)

        cdt = torch.int8 if self.kv_int8 else cache_dtype
        self._caches = tuple((cache(cdt), cache(cdt))
                             for _ in range(num_blocks))
        # int8 scales replicate: per (slot, head), or per (page, head)
        # of the global pool and its sink
        scale_rows = kv_pages + 1 if self.paged else n_slots
        self._scales = tuple(
            tuple(torch.zeros((scale_rows, num_heads), device=dev)
                  for _ in range(2))
            for _ in range(num_blocks)) if self.kv_int8 else ()
        self._logits = torch.zeros((n_slots, self.vocab),
                                   dtype=self._model.head.kernel.dtype,
                                   device=dev)
        self._pos = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self._rem = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self._eos = torch.full((n_slots,), -1, dtype=torch.long, device=dev)
        # each slot's tenant id (0: the default tenant); it steers the
        # adapter gather only when a bank is armed
        self._tslot = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self._adapters = ()
        self._dadapters = ()         # the learned drafter's heads, if any
        self.n_tenants = 0
        if adapter_bank is not None:
            self._adapters = self._place_bank(adapter_bank.u,
                                              adapter_bank.v)
            self.n_tenants = self._adapters[0].shape[0]
        self._gens: list = [None] * n_slots
        # host shadows (never fetched back from the device)
        self._pos_h = np.zeros(n_slots, np.int64)
        self._rem_h = np.zeros(n_slots, np.int64)
        self._eos_h = np.full(n_slots, -1, np.int64)
        self._occupied = np.zeros(n_slots, bool)
        # (host tokens, event, snapshot, verify record or None)
        self._pending = None
        # the rollup of the last COLLECTED verify ({drafted, accepted,
        # emitted, slots}); None after a window
        self.last_spec = None
        self._dmodel = None
        if draft_model is not None:
            self._init_drafter(draft_model, block_impl, cache_dtype)
        # chunked prefills in progress: slot -> _PendingPrefill; these
        # slots are reserved until the final chunk's insert
        self._prefills: dict[int, _PendingPrefill] = {}
        # paged state: the host allocator, the device page table and
        # per-slot grants (page ids, token capacity)
        self._alloc = None
        if self.paged:
            self._alloc = PageAllocator(kv_pages, kv_page_size)
            self._l_pages = t_max // kv_page_size
            self._pt = torch.full((n_slots, self._l_pages), -1,
                                  dtype=torch.int32, device=dev)
            self._slot_pages: dict[int, list[int]] = {}
            self._alloc_tokens = np.zeros(n_slots, np.int64)
            if prefix_cache is not None:
                prefix_cache.bind(self._alloc, self.kv_page_bytes())

    def _init_drafter(self, draft_model, block_impl, cache_dtype) -> None:
        """The learned drafter's device state: its model on the engine's
        device, its per-slot caches [S, t_max, H_d, D_d] (positions
        mirroring the target's) and its folds, after the checks that
        make its drafts comparable with the target's picks."""
        if self.draft_k is None:
            raise ValueError(
                "a draft_model needs draft_k: its proposals feed the "
                "speculative verify program, which only exists on a "
                "spec-armed engine — build with draft_k=K")
        dparams, dconfig = draft_model.params, draft_model.config
        dvocab = int(np.shape(dparams["embed"])[0])
        if dvocab != self.vocab:
            raise ValueError(
                f"draft model vocab {dvocab} != target vocab "
                f"{self.vocab}: speculation verifies draft token IDS "
                f"against the target's own picks, so the two models "
                f"must share one tokenizer/vocab — distill the drafter "
                f"from THIS target (models/draft_lm.distill_draft_lm)")
        d_seq = int(np.shape(dparams["pos"])[0])
        if d_seq < self.t_max:
            raise ValueError(
                f"draft model position table {d_seq} < engine t_max "
                f"{self.t_max}: the drafter's ring mirrors the target's "
                f"positions up to t_max — distill with "
                f"draft_config(seq_len >= t_max)")
        self._dcfg = _serve_config(
            dparams, embed_dim=dconfig["embed_dim"],
            num_heads=dconfig["num_heads"],
            num_blocks=dconfig["num_blocks"], t_max=self.t_max,
            cache_dtype=cache_dtype, mesh=self.mesh)
        self._dmodel = serving_model(
            dparams, num_heads=dconfig["num_heads"],
            num_blocks=dconfig["num_blocks"], device=self.device,
            mesh=self.mesh, rules=self._draft_partition_rules)
        group = self._group
        self._dring = make_ring_attention(causal=True,
                                          block_impl=block_impl,
                                          group=group)
        self._dfold = make_batched_ring_decode(group=group)
        self._dchunk = make_batched_chunk_ring_decode(group=group)
        head_dim = dconfig["embed_dim"] // dconfig["num_heads"]

        def cache():
            return torch.zeros((self.n_slots, self.t_max // self._n_ring,
                                dconfig["num_heads"], head_dim),
                               dtype=cache_dtype, device=self.device)

        self._dcaches = tuple((cache(), cache())
                              for _ in range(dconfig["num_blocks"]))
        # per-tenant drafter heads, gathered by the same _tslot
        dad = getattr(draft_model, "adapters", None)
        if dad is not None:
            du = torch.as_tensor(np.asarray(dad[0], np.float32))
            dv = torch.as_tensor(np.asarray(dad[1], np.float32))
            if self.n_tenants and du.shape[0] != self.n_tenants:
                raise ValueError(
                    f"drafter adapter bank has {du.shape[0]} tenant "
                    f"rows but the engine serves {self.n_tenants} "
                    f"tenants — the tenant-id gather indexes both banks "
                    f"by the same slot tenant ids")
            self._dadapters = (du.to(self.device), dv.to(self.device))
        # host stream bookkeeping: _dfront[s] tokens of slot s's stream
        # are in the drafter's caches, _dpend[s] are emitted but not yet
        # ingested (_dfront + len(_dpend) == the slot's position)
        self._dpend: list[list[int]] = [[] for _ in range(self.n_slots)]
        self._dfront = np.zeros(self.n_slots, np.int64)

    def _place_bank(self, u, v) -> tuple:
        """An adapter bank's factors on the engine's device, after the
        shape check: u [T, V, r] and v [T, r, V], V the model's vocab."""
        u = np.asarray(u, np.float32)
        v = np.asarray(v, np.float32)
        if (u.ndim != 3 or v.ndim != 3 or u.shape[1] != self.vocab
                or v.shape != (u.shape[0], u.shape[2], self.vocab)):
            raise ValueError(
                f"adapter bank shapes must be u [T, V, r] / v [T, r, V] "
                f"with V = the model vocab {self.vocab}, got {u.shape} "
                f"/ {v.shape} — a tenant adapter trained against a "
                f"different head cannot serve this model")
        return (torch.from_numpy(u).to(self.device),
                torch.from_numpy(v).to(self.device))

    def _head_hook(self):
        """The window's and verify's pick-time adapter hook, its tenant
        rows gathered once from the device `_tslot` (None: no bank)."""
        if not self._adapters:
            return None
        return make_adapter_head_hook(*self._adapters, self._tslot)

    def _check_tid(self, tid: int) -> None:
        """With a bank armed (the target's or the learned drafter's), an
        out-of-range tenant id would gather another tenant's adapter (or
        fault on the card): refused at admission. Without a bank the id
        steers nothing."""
        for what, bank in (("adapter", self._adapters),
                           ("drafter adapter", self._dadapters)):
            rows = bank[0].shape[0] if bank else None
            if rows is not None and not 0 <= tid < rows:
                raise ValueError(
                    f"tenant id {tid} out of range [0, {rows}): the "
                    f"{what} bank was built with {rows} tenants")

    def _upload(self, arr) -> torch.Tensor:
        """A host array (or host tensor) on the engine's device without a
        host sync: pinned, and copied non-blocking on the card."""
        t = (arr.contiguous() if torch.is_tensor(arr)
             else torch.from_numpy(np.ascontiguousarray(arr)))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _pad_to_t_max(self, caches):
        """A `PrefixCache` snapshot, stored cut to its prefix, as fresh
        [1, t_max] caches on the engine's device (zeros past the
        prefix, as a cold prefill leaves them)."""
        def grow(a):
            a = torch.as_tensor(a)
            out = torch.zeros((a.shape[0], self.t_max // self._n_ring)
                              + a.shape[2:], dtype=a.dtype,
                              device=self.device)
            out[:, :a.shape[1]] = a
            return out

        return tuple((grow(k), grow(v)) for k, v in caches)

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
        """Vacate a slot (done, or a deadline cancel). A contiguous row
        is left as is: a cancelled row at worst rides along with its
        bounded remaining budget (dead rows never append or touch live
        ones), and the next insert overwrites the whole row. A paged
        slot is first KILLED (its table row cleared and its device
        budget zeroed, in stream order after any window in flight) and
        only then are its pages returned: they may be granted again at
        once, and a row still live on the device would write through its
        old table into the new owner's pages. Pages a prefix-cache
        snapshot still holds survive through their refcounts."""
        self._occupied[slot] = False
        self._rem_h[slot] = 0
        if self._dmodel is not None:
            # the drafter row's K/V stays, like the target row's: the
            # next admission's _draft_admit overwrites it
            self._dpend[slot] = []
            self._dfront[slot] = 0
        if self.paged:
            if slot in self._slot_pages:
                self._set_page_row(slot, [], kill=True)
            self._alloc.release(self._slot_pages.pop(slot, []))
            self._alloc_tokens[slot] = 0

    # -- mid-decode slot migration -----------------------------------------

    @property
    def supports_slot_migration(self) -> bool:
        """True when a running slot can move to a peer engine bit for
        bit: contiguous float caches only. A paged slot's K/V lives in
        pages of a shared pool, and int8 rows would quantize again on
        import."""
        return not self.paged and not self.kv_int8

    def _whole_row(self, cache, slot: int, n: int) -> torch.Tensor:
        """Row `slot` of a [S, t_max/n_ring] cache shard as the whole
        [1, n] row on the host: gathered over the "seq" ring (every rank
        of it calls this, as the JAX package's sharded row is read
        whole), then cut to its first n positions."""
        row = cache[slot:slot + 1]
        if self._n_ring > 1:
            row = collectives.all_gather(row.contiguous(), self._group,
                                         axis=1, tiled=True)
        return row[:, :n].to("cpu", copy=True)

    def _ring_block(self, row) -> torch.Tensor:
        """A snapshot's [1, n] row (n <= t_max) as this rank's
        [1, t_max/n_ring] block of the whole [1, t_max] row, zeros past
        n: the block the engine's prefill insert places on this rank."""
        row = _host_tensor(row)
        shard = self.t_max // self._n_ring
        lo = self._cfg.ring_rank * shard
        out = torch.zeros((row.shape[0], shard) + tuple(row.shape[2:]),
                          dtype=row.dtype)
        part = row[:, lo:lo + shard]
        out[:, :part.shape[1]] = part
        return out

    def export_slot(self, slot: int) -> dict:
        """Snapshot a running slot on the host: its caches' rows cut to
        its position (`caches`, per block; the whole row, gathered over
        the engine's "seq" ring, so every rank of the ring calls this
        and gets the same snapshot), the last-token logits, its
        position, budget and stop id, the geometry, the sampling
        generator's state (`rng_state`, None when greedy) and, with a
        learned drafter, the drafter's rows cut to its frontier with its
        pending tokens (`draft`). A peer's `import_slot` resumes the
        request; the caller releases this slot. Needs the engine
        dispatch-idle (the scheduler's `quiesce`): with a window in
        flight the host shadows lag the device by one window."""
        if not self.supports_slot_migration:
            raise RuntimeError(
                "slot export needs a contiguous float-KV engine: paged "
                "pools have no slot-granular export program and int8 "
                "rows would re-quantize on import, breaking the "
                "bit-identity contract — drain this replica to "
                "completion instead of migrating")
        if self._pending is not None:
            raise RuntimeError(
                "export_slot with a window in flight would snapshot "
                "post-window caches against pre-window host shadows — "
                "quiesce() the scheduler first")
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.n_slots})")
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} is not occupied — only a "
                             f"running request has state to export")
        p = int(self._pos_h[slot])
        gen = self._gens[slot]

        def host(t):                 # a copy, also on a CPU engine
            return t.to("cpu", copy=True)

        snap = {
            "pos": p,
            "rem": int(self._rem_h[slot]),
            "eos": int(self._eos_h[slot]),
            "num_heads": self._cfg.num_heads,
            "head_dim": self._cfg.embed_dim // self._cfg.num_heads,
            "logits": host(self._logits[slot]),
            # cut to the written positions: the rest of the row is
            # masked out, and the import's pad writes zeros there
            "caches": tuple((self._whole_row(kc, slot, p),
                             self._whole_row(vc, slot, p))
                            for kc, vc in self._caches),
            "rng_state": None if gen is None else gen.get_state(),
        }
        if self._dmodel is not None:
            df = int(self._dfront[slot])
            snap["draft"] = {
                "front": df,
                "pend": [int(t) for t in self._dpend[slot]],
                "num_heads": self._dcfg.num_heads,
                "head_dim": self._dcfg.embed_dim // self._dcfg.num_heads,
                "caches": tuple((self._whole_row(kc, slot, df),
                                 self._whole_row(vc, slot, df))
                                for kc, vc in self._dcaches),
            }
        return snap

    @torch.no_grad()
    def import_slot(self, slot: int, snap: dict, *, tid: int = 0) -> None:
        """Adopt an exported snapshot into free `slot` through the normal
        admission insert: the rows padded back to t_max (zeros past the
        position, as the source row held) and cut to this rank's block of
        the engine's "seq" ring, whatever ring exported them (every rank
        of the ring calls this with the same snapshot), the snapshot's
        position in
        place of a prompt length and its remaining budget in place of
        max_new_tokens, its generator state resuming the sampling stream
        where the source left it. The resumed decode equals the
        unmigrated one bit for bit on an engine of the same `n_slots`.
        `tid` is the request's tenant id here. A snapshot without
        `rng_state` (the JAX package's, once its key data is dropped)
        imports into a greedy engine."""
        if not self.supports_slot_migration:
            raise RuntimeError(
                "slot import needs a contiguous float-KV engine (same "
                "restriction as export_slot) — this replica cannot "
                "adopt migrated slots")
        if self._pending is not None:
            raise RuntimeError(
                "import_slot with a window in flight — the window "
                "writes every row it was issued over; quiesce()/collect "
                "first")
        if self._occupied[slot] or slot in self._prefills:
            raise ValueError(f"slot {slot} is not free")
        pos, rem, eos = int(snap["pos"]), int(snap["rem"]), int(snap["eos"])
        if rem < 1:
            raise ValueError(
                "snapshot has no remaining budget — the request already "
                "finished; deliver its Result instead of migrating it")
        if pos < 1 or pos + rem > self.t_max:
            raise ValueError(
                f"snapshot position {pos} + remaining budget {rem} does "
                f"not fit this engine's t_max {self.t_max} — migrate to "
                f"a replica with a cache at least as long as the source")
        head_dim = self._cfg.embed_dim // self._cfg.num_heads
        if (len(snap["caches"]) != self._cfg.num_blocks
                or snap["num_heads"] != self._cfg.num_heads
                or snap["head_dim"] != head_dim):
            raise ValueError(
                f"snapshot geometry (blocks={len(snap['caches'])}, "
                f"heads={snap['num_heads']}, head_dim="
                f"{snap['head_dim']}) does not match this engine "
                f"(blocks={self._cfg.num_blocks}, "
                f"heads={self._cfg.num_heads}, head_dim={head_dim}) — "
                f"slots only migrate between config-identical replicas")
        dsnap = snap.get("draft")
        if dsnap is None and self._dmodel is not None:
            raise ValueError(
                "snapshot carries no learned-drafter state but this "
                "engine has a draft_model armed — resuming here would "
                "propose from an empty drafter cache and silently "
                "change acceptance; migrate between replicas with the "
                "same drafter configuration (or export from an engine "
                "with the drafter armed)")
        if dsnap is not None and self._dmodel is None:
            raise ValueError(
                "snapshot carries learned-drafter state but this "
                "engine has no draft_model — its frontier and ring "
                "rows would be dropped and the resumed request would "
                "stop speculating; migrate between replicas with the "
                "same drafter configuration")
        if dsnap is not None:
            dhd = self._dcfg.embed_dim // self._dcfg.num_heads
            if (len(dsnap["caches"]) != self._dcfg.num_blocks
                    or dsnap["num_heads"] != self._dcfg.num_heads
                    or dsnap["head_dim"] != dhd):
                raise ValueError(
                    f"snapshot drafter geometry (blocks="
                    f"{len(dsnap['caches'])}, heads="
                    f"{dsnap['num_heads']}, head_dim="
                    f"{dsnap['head_dim']}) does not match this "
                    f"engine's draft model (blocks="
                    f"{self._dcfg.num_blocks}, "
                    f"heads={self._dcfg.num_heads}, head_dim={dhd}) — "
                    f"slots only migrate between config-identical "
                    f"replicas, drafter included")
        self._check_tid(tid)
        state = snap.get("rng_state")
        if self.temperature > 0.0 and state is None:
            raise ValueError(
                "this engine samples (temperature > 0) but the snapshot "
                "carries no generator state — the resumed stream would "
                "not be the request's; export from a sampling engine")
        gen = None
        if state is not None:
            gen = torch.Generator(device=self.device)
            try:
                gen.set_state(_host_tensor(state))
            except RuntimeError as e:
                raise ValueError(
                    f"snapshot generator state does not fit a "
                    f"{self.device.type} generator ({e}) — a sampled "
                    f"slot migrates only between engines on the same "
                    f"kind of device") from e
        rows = int(np.shape(snap["caches"][0][0])[1])
        if rows != pos:
            raise ValueError(
                f"snapshot caches hold {rows} positions but its position "
                f"is {pos} — a snapshot carries the whole row up to its "
                f"position (export_slot gathers it over the source's "
                f"ring); this one is a fragment")
        caches1 = tuple((self._ring_block(k).to(self.device),
                         self._ring_block(v).to(self.device))
                        for k, v in snap["caches"])
        logits1 = _host_tensor(snap["logits"]).reshape(1, -1).to(
            self.device)
        self._insert(slot, caches1, logits1, pos, rem, eos, gen, tid)
        if dsnap is not None:
            df = int(dsnap["front"])
            for (dk, dv), (nk, nv) in zip(self._dcaches, dsnap["caches"]):
                dk[slot] = self._ring_block(nk)[0].to(dk)
                dv[slot] = self._ring_block(nv)[0].to(dv)
            self._dfront[slot] = df
            self._dpend[slot] = [int(t) for t in dsnap["pend"]]

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
                eos_id, rng, tid: int = 0, prompt=None) -> None:
        """Write a fully prefilled request into its batch row -- the
        shared tail of both admission paths. `tid` (the request's tenant
        id) goes into the slot's `_tslot` entry; `prompt` (the [P] token
        row) seeds the learned drafter's row when one is armed."""
        eos = self.eos_id if eos_id is None else eos_id
        eos = -1 if eos is None else int(eos)
        gen = self._generator(rng)
        # a paged request's K/V is already in its pages
        for i, ((kc, vc), (nk, nv)) in enumerate(zip(
                self._caches, () if self.paged else caches1)):
            if self.kv_int8:
                nk, k_s = _quantize_row(nk, self._group)
                nv, v_s = _quantize_row(nv, self._group)
                self._scales[i][0][slot] = k_s
                self._scales[i][1][slot] = v_s
            kc[slot] = nk[0].to(kc.dtype)
            vc[slot] = nv[0].to(vc.dtype)
        self._logits[slot] = torch.as_tensor(logits1)[0].to(
            self._logits.dtype)
        self._pos[slot] = p_len
        self._rem[slot] = max_new_tokens
        self._eos[slot] = eos
        self._tslot[slot] = int(tid)
        self._gens[slot] = gen
        self._pos_h[slot] = p_len
        self._rem_h[slot] = max_new_tokens
        self._eos_h[slot] = eos
        self._occupied[slot] = True
        if self._dmodel is not None and prompt is not None:
            self._draft_admit(slot, np.asarray(prompt, np.int64).ravel())

    @torch.no_grad()
    def _draft_admit(self, slot: int, prompt: np.ndarray) -> None:
        """Seed the learned drafter's row for a fresh admission: the
        prompt MINUS its last token through the drafter's own prefill
        (at least the smallest bucket the block impl takes), written into
        the row, and the last prompt token left PENDING -- so the propose
        program's chunk ingest always has a real token whose logits seed
        draft 0, and no per-slot drafter logits exist to carry."""
        p_len = prompt.shape[0]
        if p_len <= 1:
            row = None
            front = 0
        else:
            bucket = max(prefill_bucket(p_len - 1, self.t_max,
                                        self._n_ring),
                         min(self._min_bucket, self.t_max))
            padded = torch.zeros((1, bucket), dtype=torch.long)
            padded[0, :p_len - 1] = torch.from_numpy(prompt[:p_len - 1])
            _, row = _prefill(self._dcfg, self._dmodel, self._dring,
                              padded.to(self.device), p_len - 1)
            front = p_len - 1
        for i, (dk, dv) in enumerate(self._dcaches):
            if row is None:
                dk[slot] = 0
                dv[slot] = 0
            else:
                dk[slot] = row[i][0][0].to(dk.dtype)
                dv[slot] = row[i][1][0].to(dv.dtype)
        self._dfront[slot] = front
        self._dpend[slot] = [int(prompt[-1])]

    @torch.no_grad()
    def admit(self, slot: int, prompt, max_new_tokens: int, *, rng=None,
              eos_id: int | None = None, tag=None, tid: int = 0) -> None:
        """Prefill `prompt` ([P] or [1, P]) and write it into `slot`,
        every other slot's state untouched. `rng` seeds this request's
        sampling stream: an integer seed or a ``torch.Generator`` on the
        engine's device. May be called with a window in flight: the
        writes land after it on the stream, and the slot (vacant in the
        flying window) decodes from the next one. With `prefill_chunk`
        the whole prompt still lands in this one call, chunk by chunk.
        `tag` (the scheduler passes the request id) labels the prefill
        spans; `tid` is the request's tenant id (0: the default)."""
        if self.prefill_chunk is not None:
            self.start_prefill(slot, prompt, max_new_tokens, rng=rng,
                               eos_id=eos_id, tag=tag, tid=tid)
            while not self.prefill_step(slot):
                pass
            return
        prompt = self._validate_admit(slot, prompt, max_new_tokens, rng)
        self._check_tid(tid)
        p_len = prompt.shape[1]
        bucket = prefill_bucket(p_len, self.t_max, self._n_ring)
        with trace.span("serve.prefill", slot=slot, p_len=p_len,
                        bucket=bucket, rid=tag):
            padded, _ = _pad_prompt(torch.from_numpy(prompt), self.t_max,
                                    self._n_ring)
            logits1, caches1 = _prefill(self._cfg, self._model,
                                        self._gen._ring,
                                        padded.to(self.device), p_len)
            self._insert(slot, caches1, logits1, p_len, max_new_tokens,
                         eos_id, rng, tid, prompt=prompt[0])

    # -- chunked prefill --------------------------------------------------

    def start_prefill(self, slot: int, prompt, max_new_tokens: int, *,
                      rng=None, eos_id: int | None = None,
                      tag=None, tid: int = 0) -> None:
        """Reserve `slot` for a chunked prefill of `prompt` without
        running anything: each later `prefill_step(slot)` runs one
        chunk, so a long prompt no longer stalls the in-flight decodes
        behind one monolithic prefill. Consults the prefix cache for the
        longest cached prefix: only the suffix is prefilled. A paged
        engine grants the request's pages here. The slot is out of
        `free_slots` until the final chunk's insert (or
        `cancel_prefill`)."""
        if self.prefill_chunk is None:
            raise RuntimeError("engine built without prefill_chunk")
        prompt = self._validate_admit(slot, prompt, max_new_tokens, rng)
        self._check_tid(tid)
        if self.paged:
            self._start_prefill_paged(slot, prompt, max_new_tokens, rng,
                                      eos_id, tag, tid)
            return
        start, caches, logits = 0, None, None
        if self.prefix_cache is not None:
            start, caches, logits = self.prefix_cache.lookup(prompt[0])
            start = min(start, prompt.shape[1])
        if caches is None:
            caches = self._gen.init_caches(1)
        self._prefills[slot] = _PendingPrefill(
            prompt=prompt, budget=int(max_new_tokens), rng=rng,
            eos_id=eos_id, caches=caches, logits=logits, next_start=start,
            tag=tag, tid=tid)

    def _pages_for(self, p_len: int, budget: int) -> int:
        """Pages an admission reserves: the prompt plus the decode
        reservation (the whole budget unless kv_decode_reserve bounds
        it), on the page grid."""
        eff = (budget if self.kv_decode_reserve is None
               else min(budget, self.kv_decode_reserve))
        tokens = min(p_len + eff, self.t_max)
        return -(-tokens // self.kv_page_size)

    def pages_for_admission(self, p_len: int, budget: int) -> int:
        """Pages an admission of (p_len, budget) would reserve; 0 on a
        contiguous engine."""
        if not self.paged:
            return 0
        return self._pages_for(p_len, budget)

    def can_admit_pages(self, p_len: int, budget: int) -> bool:
        """The scheduler's page-aware admission gate: True when pages for
        `p_len` prompt tokens plus the decode reservation exist
        (reclaiming prefix-cache snapshots if the free list alone is
        short). Conservative -- a prefix hit can only lower the need --
        so True guarantees `start_prefill` succeeds. Always True on a
        contiguous engine. Snapshots are evicted only when that can make
        the head admissible: a blocked head asking every cycle must not
        grind the cache away for nothing."""
        if not self.paged:
            return True
        need = self._pages_for(p_len, budget)
        free = self._alloc.free_count()
        if free >= need:
            return True
        if (self.prefix_cache is None
                or free + self.prefix_cache.reclaimable_pages() < need):
            return False
        self.prefix_cache.reclaim(need - free)
        return self._alloc.free_count() >= need

    def _grant(self, n: int) -> list[int] | None:
        """`n` fresh pages, reclaiming prefix-cache snapshots when the
        free list alone is short and eviction can cover it; None when
        not even that suffices."""
        fresh = self._alloc.alloc(n)
        if (fresh is None and self.prefix_cache is not None
                and (self._alloc.free_count()
                     + self.prefix_cache.reclaimable_pages()) >= n):
            self.prefix_cache.reclaim(n - self._alloc.free_count())
            fresh = self._alloc.alloc(n)
        return fresh

    def _set_page_row(self, slot: int, pages: list[int], *,
                      kill: bool = False) -> None:
        """Rewrite `slot`'s page-table row (unallocated past `pages`);
        with `kill` also zero its device budget in the same step."""
        row = torch.full((self._l_pages,), -1, dtype=torch.int32)
        row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
        self._pt[slot] = row.to(self.device)
        if kill:
            self._rem[slot] = 0

    def _stamp_decode_scales(self, pages: list[int], src: int) -> None:
        """int8 pools: freshly granted decode pages take the slot's last
        content page's per-head scale -- a fresh page has no content to
        derive one from, and an append quantizes with its target page's
        scale."""
        if not self.kv_int8 or not pages:
            return
        dst = torch.tensor(pages, device=self.device)
        for pair in self._scales:
            for sc in pair:
                sc[dst] = sc[src].clone()

    def _start_prefill_paged(self, slot, prompt, max_new_tokens, rng,
                             eos_id, tag, tid=0) -> None:
        """Paged admission: grant pages for prompt + reservation (a
        prefix hit's pages SHARED -- retained, not copied), write the
        slot's page-table row and register the pending prefill; chunks
        then stream straight into the granted pages."""
        p_len = prompt.shape[1]
        start, shared, logits = 0, [], None
        if self.prefix_cache is not None:
            start, shared, logits = self.prefix_cache.lookup(prompt[0])
            shared = list(shared or [])
        if shared:
            # the slot's OWN reference on the snapshot's pages: release()
            # drops it whether or not the snapshot is evicted meanwhile
            self._alloc.retain(shared)
        fresh_n = self._pages_for(p_len, max_new_tokens) - len(shared)
        fresh = self._grant(fresh_n)
        if fresh is None:
            if shared:
                self._alloc.release(shared)
            raise PageExhausted(
                f"admission needs {fresh_n} fresh pages, only "
                f"{self._alloc.free_count()} free — gate admissions "
                f"on can_admit_pages()")
        pages = shared + fresh
        self._set_page_row(slot, pages)
        self._alloc_tokens[slot] = len(pages) * self.kv_page_size
        self._prefills[slot] = _PendingPrefill(
            prompt=prompt, budget=int(max_new_tokens), rng=rng,
            eos_id=eos_id, caches=None, logits=logits, next_start=start,
            tag=tag, pages=pages, shared=len(shared), tid=tid)

    def _paged_chunk(self, slot: int, tokens, start: int, p_end: int,
                     model=None):
        """One chunk through every block, written straight into the
        slot's pages: the logits of position p_end - 1. `model` defaults
        to the engine's own."""
        pt_row = self._pt[slot:slot + 1]

        def fold(i, kp, vp, q, k, v, start, p_end):
            return self._chunk_fold(kp, vp, pt_row, q, k, v, start, p_end,
                                    *(self._scales[i] if self.kv_int8
                                      else ()))[:3]

        logits, _ = _chunk_forward(self._cfg,
                                   self._model if model is None else model,
                                   self._caches, tokens.to(self.device),
                                   start, p_end, fold)
        return logits

    @torch.no_grad()
    def prefill_step(self, slot: int) -> bool:
        """Advance `slot`'s pending prefill by ONE chunk; True once the
        request is admitted (the final chunk and the insert happen
        together). Each completed full-chunk boundary is snapshotted
        into the prefix cache, so the next request sharing the prefix
        prefills only its suffix."""
        pend = self._prefills.get(slot)
        if pend is None:
            raise ValueError(f"slot {slot} has no prefill in progress")
        p_len = pend.prompt.shape[1]
        c = self.prefill_chunk
        start = pend.next_start
        # a prompt on a chunk boundary and wholly cached needs no chunk
        if start < p_len:
            end = min(start + c, p_len)
            with trace.span("serve.prefill_chunk", slot=slot, start=start,
                            end=end, p_len=p_len, rid=pend.tag):
                padded = torch.zeros((1, c), dtype=torch.long)
                padded[:, :end - start] = torch.from_numpy(
                    pend.prompt[:, start:end])
                if self.paged:
                    pend.logits = self._paged_chunk(slot, padded, start,
                                                    end)
                else:
                    pend.logits, pend.caches = self._gen.prefill_chunk_step(
                        pend.caches, padded, start, end)
                pend.next_start = end
                if self.prefix_cache is not None and end % c == 0:
                    # a paged snapshot IS the slot's pages [0, end):
                    # page-aligned, written, never written again
                    self.prefix_cache.insert(
                        pend.prompt[0, :end],
                        (pend.pages[:end // self.kv_page_size]
                         if self.paged else pend.caches), pend.logits)
            if end < p_len:
                return False
        del self._prefills[slot]
        if self.paged:
            self._slot_pages[slot] = pend.pages
            n_prompt = -(-p_len // self.kv_page_size)
            self._stamp_decode_scales(pend.pages[n_prompt:],
                                      pend.pages[n_prompt - 1])
        self._insert(slot, pend.caches, pend.logits, p_len, pend.budget,
                     pend.eos_id, pend.rng, pend.tid, prompt=pend.prompt[0])
        return True

    def cancel_prefill(self, slot: int) -> None:
        """Drop a pending prefill (deadline hit while still chunking):
        its partial caches are discarded and the slot is free at once --
        nothing reached the batch row. A paged engine clears the slot's
        table row and returns the grant (pages a snapshot shares
        survive through its references)."""
        pend = self._prefills.pop(slot, None)
        if pend is not None and self.paged and pend.pages:
            self._set_page_row(slot, [], kill=True)
            self._alloc.release(pend.pages)
            self._alloc_tokens[slot] = 0

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
        mid-window draws on into a stream its request no longer uses.
        With an adapter bank each step picks from the tenant-effective
        logits, while the stored logits stay base."""
        cfg, model, fold = self._cfg, self._model, self._fold
        scales = self._scales
        eff = self._head_hook()
        toks_out = []
        for j in range(n_steps):
            live = self._rem > 0
            pl = self._logits if eff is None else eff(self._logits)
            if self.temperature == 0.0:
                toks = self._pick(pl)
            else:
                toks = torch.cat([
                    self._pick(pl[s:s + 1], self._gens[s])
                    if occupied[s] and j < rem_before[s]
                    else torch.zeros(1, dtype=torch.long,
                                     device=self.device)
                    for s in range(self.n_slots)])
            toks = torch.where(live, toks, self.pad_id)
            pos = self._pos

            def block_fold(i, kc, vc, q, k, v, pos=pos, live=live):
                extra = scales[i] if scales else ()
                if self.paged:
                    return fold(kc, vc, self._pt, q, k, v, pos, live,
                                *extra)
                return fold(kc, vc, q, k, v, pos, live, *extra)

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

    @staticmethod
    def _fetch_async(t):
        """(host tensor, event): a non-blocking copy of `t` into pinned
        memory behind a CUDA event (`t` itself and None on the CPU)."""
        if not t.is_cuda:
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def begin_window(self, n_steps: int) -> None:
        """Issue ONE masked window of up to `n_steps` tokens per slot and
        return without waiting; `collect` returns its tokens. At most
        one window (or verify) may be in flight."""
        if self._pending is not None:
            raise RuntimeError("a window is already in flight — "
                               "collect() it first")
        if n_steps < 1:
            raise ValueError(f"need n_steps >= 1, got {n_steps}")
        snapshot = (self._rem_h.copy(), self._occupied.copy(),
                    self._eos_h.copy())
        toks = self._window(n_steps, snapshot[0], snapshot[1])
        self._pending = (*self._fetch_async(toks), snapshot, None)

    # -- speculative decoding ---------------------------------------------

    def spec_room(self, slot: int) -> bool:
        """True when `slot` has cache room for a full verify: K draft
        appends plus the bonus token's land inside t_max. A slot without
        room is within draft_k + 1 tokens of finishing and decodes
        through windows."""
        if self.draft_k is None:
            return False
        return bool(self._pos_h[slot] + self.draft_k + 1 <= self.t_max)

    @torch.no_grad()
    def _verify(self, drafts, vlive):
        """The verify program over every row: `drafts` [S, K] and host
        `vlive` [S] (rows that participate; a row also needs budget on
        the device). Returns the packed [S, K + 3] device result
        (tokens, emitted count, accepted count) and, when sampling, per
        row the generator's state before and after each draw."""
        cfg, model, k, s_rows = self._cfg, self._model, self.draft_k, \
            self.n_slots
        dev = self.device
        drafts = self._upload(np.asarray(drafts, np.int64))
        live = self._upload(np.asarray(vlive, bool)) & (self._rem > 0)
        pos, scales = self._pos, self._scales

        def chunk_fold(i, kc, vc, q, kt, vt):
            extra = scales[i] if scales else ()
            if self.paged:
                return self._vfold(kc, vc, self._pt, q, kt, vt, pos, live,
                                   *extra)
            return self._vfold(kc, vc, q, kt, vt, pos, live, *extra)

        lg, self._caches = _chunk_batch_forward(cfg, model, self._caches,
                                                drafts, pos, chunk_fold)
        # the K+1 candidate distributions along the accepted path:
        # cand[:, 0] is the stored logits, cand[:, j] those after
        # drafts[:, :j]
        cand = torch.cat([self._logits.to(lg.dtype)[:, None], lg], 1)
        # the picks read the tenant-effective candidates; the stored
        # state below (`after`, the bonus logits) stays base
        eff = self._head_hook()
        cand_p = cand if eff is None else eff(cand)
        states = None
        if self.temperature == 0.0:
            g = self._pick(cand_p.reshape(s_rows * (k + 1), -1)).reshape(
                s_rows, k + 1)
        else:
            # each row's draws in candidate order, on the window's [1, V]
            # call shape; the states let collect keep exactly n_f draws
            states = [[] for _ in range(s_rows)]
            rows = []
            for s in range(s_rows):
                if not vlive[s]:
                    rows.append(torch.zeros(k + 1, dtype=torch.long,
                                            device=dev))
                    continue
                gen = self._gens[s]
                states[s].append(gen.get_state())
                draws = []
                for j in range(k + 1):
                    draws.append(self._pick(cand_p[s:s + 1, j], gen))
                    states[s].append(gen.get_state())
                rows.append(torch.cat(draws))
            g = torch.stack(rows)
        # the accepted prefix m, the bonus pick g[m], and the emitted
        # count n_f after budget and EOS truncation
        m = torch.cumprod((drafts == g[:, :k]).long(), 1).sum(1)
        bonus = g.gather(1, m[:, None])[:, 0]
        cand_n = torch.where(live, torch.minimum(m + 1, self._rem), 0)
        ar = torch.arange(k + 1, device=dev)[None]
        emitted = torch.where(
            ar < m[:, None],
            torch.cat([drafts, torch.zeros_like(drafts[:, :1])], 1),
            torch.where(ar == m[:, None], bonus[:, None], self.pad_id))
        is_eos = ((self._eos[:, None] >= 0)
                  & (emitted == self._eos[:, None])
                  & (ar < cand_n[:, None]))
        any_eos = is_eos.any(1)
        n_f = torch.where(any_eos, is_eos.int().argmax(1) + 1, cand_n)
        n_acc = torch.minimum(m, n_f)
        toks = torch.where(ar < n_f[:, None], emitted, self.pad_id)
        # the bonus token's own masked step: its K/V lands at pos + m
        bonus_live = live & (n_f == m + 1)
        bpos = (pos + m).clamp(0, self.t_max - 1)

        def tok_fold(i, kc, vc, q, kt, vt):
            extra = scales[i] if scales else ()
            if self.paged:
                return self._fold(kc, vc, self._pt, q, kt, vt, bpos,
                                  bonus_live, *extra)
            return self._fold(kc, vc, q, kt, vt, bpos, bonus_live, *extra)

        b_logits, self._caches = _token_forward(
            cfg, model, self._caches, bonus, bpos, tok_fold)
        after = cand.gather(1, n_f.clamp(0, k)[:, None, None].expand(
            -1, 1, cand.shape[-1]))[:, 0]
        new = torch.where(bonus_live[:, None],
                          b_logits.to(self._logits.dtype),
                          after.to(self._logits.dtype))
        self._logits = torch.where(live[:, None], new, self._logits)
        self._pos = torch.where(live, pos + n_f, pos)
        self._rem = torch.where(
            live, torch.where(any_eos, 0, self._rem - n_f), self._rem)
        return torch.cat([toks, n_f[:, None], n_acc[:, None]], 1), states

    def begin_verify(self, drafts, vlive, proposed=None) -> None:
        """Start ONE speculative verify, collected like a window:
        `drafts` is int [n_slots, draft_k] and `vlive` bool [n_slots]
        marks the participating rows. Every vlive row must be occupied,
        have budget left and `spec_room`; the other rows ride along
        bit-untouched. Each vlive row emits between 1 and draft_k + 1
        tokens -- the accepted draft prefix plus the model's own pick at
        the first disagreement -- so a row whose drafts all miss still
        advances by the window's one token. Returns without waiting.

        `proposed` (bool [n_slots], default `vlive`, a subset of it)
        marks the rows whose drafts came from a real proposal: only
        those enter `last_spec`'s drafted/accepted ledger."""
        if self.draft_k is None:
            raise RuntimeError("engine built without draft_k — "
                               "speculative decoding is not armed")
        if self._pending is not None:
            raise RuntimeError("a window is already in flight — "
                               "collect() it first")
        drafts = np.asarray(drafts)
        vlive = np.asarray(vlive, bool)
        if drafts.shape != (self.n_slots, self.draft_k):
            raise ValueError(
                f"drafts must be [{self.n_slots}, {self.draft_k}], "
                f"got {drafts.shape}")
        if not np.issubdtype(drafts.dtype, np.integer) or (
                drafts.size and (drafts.min() < 0
                                 or drafts.max() >= self.vocab)):
            raise ValueError(f"drafts must be integer token ids in "
                             f"[0, {self.vocab})")
        if vlive.shape != (self.n_slots,):
            raise ValueError(f"vlive must be [{self.n_slots}], got "
                             f"{vlive.shape}")
        proposed = (vlive if proposed is None
                    else np.asarray(proposed, bool))
        if proposed.shape != vlive.shape or (proposed & ~vlive).any():
            raise ValueError("proposed must be a [n_slots] subset of "
                             "vlive")
        for s in np.flatnonzero(vlive):
            if not self._occupied[s] or self._rem_h[s] < 1:
                raise ValueError(f"verify slot {int(s)} is not occupied "
                                 f"with budget left")
            if not self.spec_room(int(s)):
                raise ValueError(
                    f"verify slot {int(s)} at pos {self._pos_h[s]} lacks "
                    f"room for {self.draft_k} drafts + the bonus before "
                    f"t_max {self.t_max}")
        snapshot = (self._rem_h.copy(), self._occupied.copy(),
                    self._eos_h.copy())
        packed, states = self._verify(drafts, vlive)
        self._pending = (*self._fetch_async(packed), snapshot,
                         (vlive.copy(), proposed.copy(), states))

    def abort_window(self) -> None:
        """Discard an in-flight window without collecting it (the
        scheduler's failure cleanup): the host shadows keep their values
        from before it was issued."""
        self._pending = None

    def collect(self) -> dict[int, list[int]]:
        """Wait for the in-flight window's (or verify's) tokens ({} if
        none) and replay the device's retirement rule onto the host
        shadows: live steps are a prefix of the window, and an EOS zeroes
        the budget after it is emitted; a verify's counts come back with
        its tokens. Returns {slot: tokens emitted} for the slots occupied
        when it was started (a verify's ride-along rows: [])."""
        # reset first: a window's collect must not leave the last
        # verify's rollup answering for it
        self.last_spec = None
        if self._pending is None:
            return {}
        toks, event, (rem_before, occupied, eos_h), spec = self._pending
        self._pending = None
        # the one host transfer, and where the serve loop waits on the
        # device: bracketed as device.sync for step-time attribution
        with trace.span("device.sync"):
            if event is not None:
                event.synchronize()
            toks = toks.numpy()
        out = {}
        if spec is not None:
            out = self._collect_verify(toks, rem_before, occupied, eos_h,
                                       *spec)
            self._note_emitted(out)
            return out
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
        self._note_emitted(out)
        return out

    def _collect_verify(self, packed, rem_before, occupied, eos_h, vlive,
                        proposed, states) -> dict[int, list[int]]:
        """A verify's host half: the device already truncated by budget
        and EOS, so the emitted count is exact; the shadows replay it,
        a sampled row's generator is rewound to the state after its
        emitted count of draws, and `last_spec` ledgers the PROPOSED
        rows only (ride-alongs would dilute the acceptance figures)."""
        k = self.draft_k
        toks, n_emit, n_acc = packed[:, :k + 1], packed[:, k + 1], \
            packed[:, k + 2]
        self.last_spec = {
            "drafted": int(proposed.sum()) * k,
            "accepted": int(n_acc[proposed].sum()),
            "emitted": int(n_emit[proposed].sum()),
            "slots": int(proposed.sum()),
        }
        out = {}
        for s in range(self.n_slots):
            if not occupied[s]:
                continue
            if not vlive[s]:
                out[s] = []                  # rode along bit-untouched
                continue
            n = int(n_emit[s])
            if states is not None:
                self._gens[s].set_state(states[s][n])
            row = [int(t) for t in toks[s, :n]]
            if eos_h[s] >= 0 and eos_h[s] in row:
                self._rem_h[s] = 0
            else:
                self._rem_h[s] = rem_before[s] - n
            self._pos_h[s] += n
            out[s] = row
        return out

    def _note_emitted(self, out: dict[int, list[int]]) -> None:
        """Queue the collected tokens for the learned drafter: its caches
        ingest them at the next `propose_all`, so collect never touches
        the device on the drafter's behalf."""
        if self._dmodel is None:
            return
        for s, row in out.items():
            if row:
                self._dpend[s].extend(row)

    @torch.no_grad()
    def _draft_chunk(self, toks, pos0, live):
        """One C-chunk per row through the drafter (the batched chunk
        fold appends the live rows' real tokens): its logits [S, C, V]."""
        lg, self._dcaches = _chunk_batch_forward(
            self._dcfg, self._dmodel, self._dcaches, toks, pos0,
            lambda i, kc, vc, q, kt, vt: self._dchunk(kc, vc, q, kt, vt,
                                                      pos0, live))
        return lg

    @torch.no_grad()
    def _draft_propose(self, toks, n_new, pos0, live):
        """The propose program: the final chunk of every row's pending
        tokens, then K - 1 greedy token steps from the logits of its last
        REAL token; [S, K] drafts on the device."""
        k, c = self.draft_k, self.draft_k + 1
        toks, n_new, pos0 = (self._upload(np.asarray(a, np.int64))
                             for a in (toks, n_new, pos0))
        live = self._upload(np.asarray(live, bool))
        # per-tenant drafter heads: the picks read the effective logits
        eff = (make_adapter_head_hook(*self._dadapters, self._tslot)
               if self._dadapters else None)

        def pick(row):
            return (row if eff is None else eff(row)).argmax(-1)

        lg = self._draft_chunk(toks, pos0, live)
        idx = (n_new - 1).clamp(0, c - 1)
        cur = pick(lg.gather(1, idx[:, None, None].expand(
            -1, 1, lg.shape[-1]))[:, 0])
        front = pos0 + n_new
        drafts = [cur]
        for j in range(k - 1):
            p = (front + j).clamp(0, self.t_max - 1)
            lg2, self._dcaches = _token_forward(
                self._dcfg, self._dmodel, self._dcaches, cur, p,
                lambda i, kc, vc, q, kt, vt, p=p: self._dfold(
                    kc, vc, q, kt, vt, p, live))
            cur = pick(lg2)
            drafts.append(cur)
        return torch.stack(drafts, 1)

    def propose_all(self):
        """LEARNED proposals for every speculating slot in one call:
        drain each slot's pending emitted tokens into the drafter's
        caches, then roll the drafter `draft_k` greedy steps for ALL
        qualifying slots together. Returns `(drafts, live)` -- int32
        [n_slots, draft_k] proposals and the bool mask of rows they are
        real for -- or None when no slot qualifies.

        The steady state (every slot emitted <= draft_k + 1 tokens since
        the last call, the verify's most) is one propose program; a
        deeper backlog (window cycles, a fresh admission's pending token)
        drains through fixed-width ingest rounds first, remainder first
        per slot, so every live slot's final chunk lands in the one
        shared final round with 1..C real tokens. Only slots with
        `spec_room` are proposed for, which also keeps every chunk
        inside t_max. The drafts are fetched to the host (one wait)."""
        if self._dmodel is None:
            raise RuntimeError(
                "propose_all() requires a learned drafter: build the "
                "engine with draft_model= (a models/draft_lm.DraftLM) "
                "— host-side drafters (NGramDrafter) propose via their "
                "own propose(history) instead")
        if self._pending is not None:
            raise RuntimeError("a window is already in flight — "
                               "collect() it first")
        c = self.draft_k + 1
        live = np.array([
            bool(self._occupied[s]) and self._rem_h[s] >= 1
            and len(self._dpend[s]) > 0 and self.spec_room(s)
            for s in range(self.n_slots)])
        if not live.any():
            return None
        pend = {int(s): np.asarray(self._dpend[s], np.int64)
                for s in np.flatnonzero(live)}
        offs = dict.fromkeys(pend, 0)
        rounds = max(-(-len(p) // c) for p in pend.values())
        with trace.span("serve.propose", slots=int(live.sum()),
                        rounds=rounds), torch.no_grad():
            for r in range(rounds - 1):
                left = rounds - r
                toks = np.zeros((self.n_slots, c), np.int64)
                pos0 = np.zeros(self.n_slots, np.int64)
                rlive = np.zeros(self.n_slots, bool)
                for s, p in pend.items():
                    remaining = len(p) - offs[s]
                    if remaining <= (left - 1) * c:
                        continue
                    n = remaining - (left - 1) * c
                    toks[s, :n] = p[offs[s]:offs[s] + n]
                    pos0[s] = self._dfront[s] + offs[s]
                    rlive[s] = True
                    offs[s] += n
                self._draft_chunk(self._upload(toks), self._upload(pos0),
                                  self._upload(rlive))
            toks = np.zeros((self.n_slots, c), np.int64)
            pos0 = np.zeros(self.n_slots, np.int64)
            n_new = np.zeros(self.n_slots, np.int64)
            for s, p in pend.items():
                n = len(p) - offs[s]
                toks[s, :n] = p[offs[s]:]
                pos0[s] = self._dfront[s] + offs[s]
                n_new[s] = n
            drafts = self._draft_propose(toks, n_new, pos0, live)
            drafts = drafts.cpu().numpy()
        for s in pend:
            self._dfront[s] += len(self._dpend[s])
            self._dpend[s] = []
        return drafts.astype(np.int32), live

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

    def _whole_shape(self, name: str, p) -> tuple:
        """A live parameter's whole shape (this rank may hold a block of
        it, split as its spec says)."""
        shape = list(p.shape)
        for dim, entry in enumerate(self._model.specs.get(name, ())):
            for a in meshlib.axes_of(entry):
                shape[dim] *= self.mesh.axis_size(a)
        return tuple(shape)

    def _local_leaves(self, params) -> dict:
        """A whole candidate tree's leaves by module name, each cut to
        this rank's block under the live parameter's spec; a
        ``partition.BlockTree``'s leaves are this rank's blocks already,
        each at the live parameter's shape."""
        blocks = isinstance(params, partition.BlockTree)
        out = {}
        for path, a in convert.flatten(params).items():
            name = path.replace("/", ".")
            spec = self._model.specs.get(name, meshlib.P())
            if blocks:
                live = tuple(self._model.get_parameter(name).shape)
                if tuple(np.shape(a)) != live:
                    raise ValueError(
                        f"candidate block of {name} is "
                        f"{tuple(np.shape(a))}, this rank serves "
                        f"{live} — restore the candidate by this "
                        f"engine's mesh and rules")
                out[name] = a
            else:
                out[name] = (meshlib.put_with_sharding(
                    a, meshlib.Sharding(self.mesh, spec))
                    if len(spec) else a)
        return out

    def _check_candidate(self, params) -> None:
        """Refuse a candidate tree that does not match the live one leaf
        for leaf in name, shape and dtype."""
        live = {n.replace(".", "/"): (self._whole_shape(n, p),
                                      str(p.dtype).removeprefix("torch."))
                for n, p in self._model.named_parameters()}
        cand = {n: (partition.whole_shape(params, n),
                    str(np.asarray(a).dtype))
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

    def swap_params(self, params) -> None:
        """Hot-swap the serving weights. The candidate tree must match
        the live one leaf for leaf in name, shape and dtype. Each weight
        is copied in place from pageable host memory on the current
        stream, so the copy lands after a window already in flight
        (which reads the old weights) and before the next (which reads
        the new); the call returns once the copies are done. Running
        slots keep their caches."""
        self._check_candidate(params)
        with torch.no_grad():
            for name, a in self._local_leaves(params).items():
                p = self._model.get_parameter(name)
                p.copy_(torch.as_tensor(np.asarray(a)).to(p.dtype))

    @torch.no_grad()
    def spot_check_params(self, params) -> dict:
        """Greedy spot-check of CANDIDATE weights through the live
        model's own prefill path, its parameters replaced for the one
        call by ``torch.func.functional_call`` (no second model is
        built), on scratch state: no live slot, cache row or logit
        changes. The contiguous engine prefills zeros at the smallest
        bucket (the flash kernel's, 128, with ``block_impl="pallas"``)
        or one chunk into a fresh one-row cache; the paged engine runs
        the warmup's no-op chunk (p_end 0) through slot 0's table row,
        every write landing in the sink page, so it needs the engine
        dispatch-idle (the scheduler's `quiesce`). Returns {"ok", "code",
        "max_abs"}, codes as `slot_health`'s: 0 healthy, 1 non-finite
        logits, 2 finite past the magnitude bound (1e30). The staging
        gate of a rollout: bad weights are caught before a request is
        routed onto them. On the card the candidate goes up through
        pinned memory and the verdict comes back behind an event, so a
        check on a dispatch-idle engine makes no other host sync."""
        if self.paged and self._pending is not None:
            raise RuntimeError(
                "spot_check_params on a paged engine needs the "
                "in-flight dispatch collected first (the pool "
                "caches were donated to it) — call the "
                "scheduler's quiesce() and retry")
        self._check_candidate(params)
        cand = {f"model.{name}": self._upload(np.asarray(a))
                for name, a in self._local_leaves(params).items()}
        c = self.prefill_chunk
        zeros = torch.zeros((1, c or 1), dtype=torch.long,
                            device=self.device)
        if self.paged:
            def run(model):
                return self._paged_chunk(0, zeros, 0, 0, model)
        elif c is not None:
            def run(model):
                return _chunk_forward(
                    self._cfg, model, self._gen.init_caches(1), zeros, 0,
                    c, lambda i, *a: self._gen._chunk_fold(*a))[0]
        else:
            b = max(prefill_buckets(self.t_max, self._n_ring)[0],
                    min(self._min_bucket, self.t_max))

            def run(model):
                return _prefill(self._cfg, model, self._gen._ring,
                                torch.zeros((1, b), dtype=torch.long,
                                            device=self.device), b)[0]
        logits = torch.func.functional_call(_Probe(self._model), cand,
                                            (run,))
        host, event = self._fetch_async(logits.double())
        if event is not None:
            event.synchronize()
        row = host.numpy()
        fin = np.isfinite(row)
        max_abs = float(np.max(np.abs(row[fin])) if fin.any() else np.inf)
        if not fin.all():
            return {"ok": False, "code": 1, "max_abs": max_abs}
        if max_abs > _HEALTH_LOGIT_LIMIT:
            return {"ok": False, "code": 2, "max_abs": max_abs}
        return {"ok": True, "code": 0, "max_abs": max_abs}

    def swap_adapters(self, u, v) -> None:
        """Hot-swap the per-tenant adapter bank: u [T, V, r] and v
        [T, r, V] of the armed bank's shapes (T the registered tenants,
        gathered by tenant id). The new factors are copied in place on
        the stream, so a window in flight reads the old bank and the
        next the new."""
        if self.n_tenants == 0:
            raise ValueError(
                "adapter hot-swap needs a multi-tenant server: this "
                "engine was built without an adapter bank (tenancy), "
                "so there are no adapter rows to replace — roll out "
                "full params instead (swap_params)")
        u = np.asarray(u, np.float32)
        v = np.asarray(v, np.float32)
        old_u, old_v = self._adapters
        if u.shape != tuple(old_u.shape) or v.shape != tuple(old_v.shape):
            raise ValueError(
                f"adapter swap shapes {u.shape} / {v.shape} must equal "
                f"the armed bank's {tuple(old_u.shape)} / "
                f"{tuple(old_v.shape)} (T = registered tenants, V = "
                f"model vocab, r = adapter rank) — retrain/re-export at "
                f"the serving shapes, or rebuild the server to change "
                f"them")
        old_u.copy_(torch.from_numpy(u))
        old_v.copy_(torch.from_numpy(v))

    # -- the rest -----------------------------------------------------------

    def ensure_decode_room(self, n_tokens: int) -> list[int]:
        """Paged engines (a contiguous room is sized at admission:
        returns []): grow every occupied slot's grant so the next window
        can emit min(n_tokens, remaining budget) tokens without writing
        an unallocated page. Returns the slots that could NOT be granted
        after the free list and the prefix cache's reclaimable snapshots
        -- the scheduler quarantines those before the window, so a
        starved slot never decodes blind past its last page. With the
        default whole-budget reservation this grants nothing."""
        if not self.paged:
            return []
        failed = []
        ps = self.kv_page_size
        for slot in range(self.n_slots):
            if not self._occupied[slot] or self._rem_h[slot] < 1:
                continue
            target = int(self._pos_h[slot]
                         + min(int(n_tokens), int(self._rem_h[slot])))
            if target <= self._alloc_tokens[slot]:
                continue
            fresh = self._grant(
                -(-(target - int(self._alloc_tokens[slot])) // ps))
            if fresh is None:
                failed.append(slot)
                continue
            pages = self._slot_pages[slot]
            self._stamp_decode_scales(fresh, pages[-1])
            pages.extend(fresh)
            self._set_page_row(slot, pages)
            self._alloc_tokens[slot] = len(pages) * ps
        return failed

    def cache_fingerprint(self) -> dict:
        """The engine's identity (the JAX engine's keys): every
        serving-config field, the engine knobs, the partition rules of
        the target and the drafter, the mesh axes, and the devices --
        this rank's card (``cuda:N``, or ``cpu``) with its rank in the
        world, the card's name and its compute capability. Two engines
        with equal fingerprints run the same programs. The compile cache
        keys a program by less: its kernels' libraries depend on none of
        this (``serve/compile_cache.py``)."""
        dev = self.device
        if dev.type == "cuda":
            index = (dev.index if dev.index is not None
                     else torch.cuda.current_device())
            label = f"cuda:{index}"
            name = torch.cuda.get_device_name(index)
            cap = "%d.%d" % torch.cuda.get_device_capability(index)
        else:
            label, name, cap = "cpu", "cpu", None
        dcfg = self._dcfg if self._dmodel is not None else None
        return {
            "embed_dim": self._cfg.embed_dim,
            "num_heads": self._cfg.num_heads,
            "num_blocks": self._cfg.num_blocks,
            "t_max": self.t_max,
            "n_slots": self.n_slots,
            "vocab": self.vocab,
            "cache_dtype": str(self._cfg.cache_dtype).removeprefix("torch."),
            "logits_dtype": str(self._logits.dtype).removeprefix("torch."),
            "block_impl": self._block_impl,
            "temperature": self._cfg.temperature,
            "top_k": self._cfg.top_k,
            "pad_id": self.pad_id,
            "kv_int8": self.kv_int8,
            "draft_k": self.draft_k,
            "prefill_chunk": self.prefill_chunk,
            "kv_page_size": self.kv_page_size,
            "kv_pages": self.kv_pages,
            "n_tenants": self.n_tenants,
            "adapter_rank": (int(self._adapters[0].shape[2])
                             if self._adapters else 0),
            "partition_rules": repr(self._partition_rules),
            "draft_model": (None if dcfg is None else {
                "embed_dim": dcfg.embed_dim,
                "num_heads": dcfg.num_heads,
                "num_blocks": dcfg.num_blocks,
                "cache_dtype": str(dcfg.cache_dtype).removeprefix("torch."),
                "partition_rules": repr(self._draft_partition_rules),
            }),
            "mesh_axes": ({str(k): int(v) for k, v in self.mesh.shape.items()}
                          if self.mesh is not None
                          else {meshlib.SEQ_AXIS: 1}),
            "devices": [f"{label}@{collectives.axis_index()}"],
            "device_name": name,
            "capability": cap,
        }

    def _cache_plan(self) -> list:
        """(program, hand kernels it launches) for each serving program
        the compile cache covers: JAX's plan -- the window; the insert
        and the prefill chunk when chunked or paged; the learned
        drafter's propose and ingest -- plus, where a card runs the
        flash kernel (``block_impl="pallas"``), the bucketed prefill
        that launches it (the target's unchunked admission, or the
        drafter's)."""
        plan = [("window", ())]
        if self.paged or self.prefill_chunk is not None:
            plan += [("prefill_chunk", ()), ("insert", ())]
        if self._dmodel is not None:
            plan += [("propose", ()), ("draft_ingest", ())]
        if (self._block_impl == "pallas" and self.device.type == "cuda"
                and (self.prefill_chunk is None
                     or self._dmodel is not None)):
            from idc_models_tpu_torch.ops import flash_block_kernel as fbk

            plan.append(("prefill", (fbk.FWD_KERNEL,)))
        return plan

    def _warm_cache(self, cache) -> None:
        """Load each program of `_cache_plan` from `cache` (its kernels'
        libraries placed and installed), or build and store it on a
        miss; the warmup calls then launch what was loaded. A program is
        keyed by its kernels' digests alone (with the toolchain the
        cache adds): the libraries depend on nothing of the engine."""
        from idc_models_tpu_torch.serve.compile_cache import kernel_library

        for name, kernels in self._cache_plan():
            key = cache.key(program=name, fingerprint={
                "kernels": [k.library_path().name for k in kernels]})
            program = cache.load(key)
            if program is None:
                cache.compile_and_store(
                    key, [kernel_library(k) for k in kernels], program=name)
                continue
            for k in kernels:
                k.install(program.handles[k.name])

    def warmup(self, n_steps: int, compile_cache=None) -> None:
        """Run every program the serve loop touches once on the empty
        state: a prefill (one chunk when chunked -- on a paged engine
        against an all-unallocated table with p_end 0, writing nothing
        -- else the smallest bucket the block impl takes), two insert ->
        window cycles into slot 0 with a zero budget (every row dead, so
        the windows are bit-level no-ops), each followed on a spec-armed
        engine by a verify with every row dead, a page-row kill, the
        health reduction and the learned drafter's chain (a prefill, an
        ingest and a propose with every row dead). Eager PyTorch
        compiles nothing; this pays the first calls' one-time costs
        (library handles, the allocator) before traffic. With
        `compile_cache` (``serve/compile_cache.py``) the programs' kernel
        libraries load from the store first, or are built and stored."""
        if compile_cache is not None:
            self._warm_cache(compile_cache)
        zeros = torch.zeros((1, self.prefill_chunk or 1), dtype=torch.long)
        with torch.no_grad():
            caches1 = None
            if self.paged:
                for _ in range(2):
                    logits1 = self._paged_chunk(0, zeros, 0, 0)
            elif self.prefill_chunk is not None:
                caches1 = self._gen.init_caches(1)
                logits1, caches1 = self._gen.prefill_chunk_step(
                    caches1, zeros, 0, self.prefill_chunk)
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
            if self.draft_k is not None:
                self.begin_verify(
                    np.zeros((self.n_slots, self.draft_k), np.int64),
                    np.zeros(self.n_slots, bool))
                self.collect()
        if self.paged:
            self._set_page_row(0, [], kill=True)
        self.slot_health()
        if self._dmodel is not None:
            dead = np.zeros(self.n_slots, bool)
            zc = np.zeros((self.n_slots, self.draft_k + 1), np.int64)
            zi = np.zeros(self.n_slots, np.int64)
            b = min(self._min_bucket, self.t_max)
            with torch.no_grad():
                _prefill(self._dcfg, self._dmodel, self._dring,
                         torch.zeros((1, b), dtype=torch.long,
                                     device=self.device), b)
                self._draft_chunk(self._upload(zc), self._upload(zi),
                                  self._upload(dead))
                self._draft_propose(zc, zi, zi, dead)
        self.last_spec = None

    def kv_bytes_per_slot(self) -> int:
        """Device bytes of cache state per slot (K + V rows of every
        block, plus the dequantization scales when int8) -- the
        denominator of the int8 capacity claim. On a paged engine the
        WORST case (a full-t_max request's pages); the live figure is
        `kv_bytes_resident`."""
        if self.paged:
            return self._l_pages * self.kv_page_bytes()
        per = sum(kc.nbytes + vc.nbytes for kc, vc in self._caches)
        per += sum(s.nbytes for pair in self._scales for s in pair)
        return per // self.n_slots

    def kv_page_bytes(self) -> int:
        """Device bytes ONE page costs across every block's K and V
        pools, plus its per-(page, head) scales when int8 -- the unit of
        the tokens-per-byte capacity figure."""
        cfg = self._cfg
        item = 1 if self.kv_int8 else cfg.cache_dtype.itemsize
        per = (cfg.num_blocks * 2 * self.kv_page_size * cfg.embed_dim
               * item)
        if self.kv_int8:
            per += cfg.num_blocks * 2 * cfg.num_heads * 4
        return per

    def kv_bytes_resident(self) -> int:
        """Device bytes of KV state reserved: every slot's full row on a
        contiguous engine, the pages in use on a paged one."""
        if self.paged:
            return self._alloc.used_count() * self.kv_page_bytes()
        return self.n_slots * self.kv_bytes_per_slot()

    def tokens_resident(self) -> int:
        """Tokens of KV held right now: decoded positions of occupied
        slots plus prefilled positions of pending chunked admissions."""
        toks = int(sum(int(self._pos_h[s]) for s in range(self.n_slots)
                       if self._occupied[s]))
        return toks + int(sum(p.next_start for p in self._prefills.values()))

    def page_stats(self) -> dict | None:
        """The per-cycle page rollup the scheduler feeds
        `ServingMetrics.on_pages` (None: a contiguous engine)."""
        if not self.paged:
            return None
        return {
            "pages_total": self.kv_pages,
            "pages_used": self._alloc.used_count(),
            "pages_cached": (self.prefix_cache.cached_pages()
                             if self.prefix_cache is not None else 0),
            "resident_tokens": self.tokens_resident(),
            "resident_bytes": self.kv_bytes_resident(),
        }

    def prefill_grant(self, slot: int) -> tuple[int, int] | None:
        """(fresh, shared): the pages granted to `slot`'s pending paged
        prefill, and how many of them it shares with a prefix-cache
        snapshot; None when `slot` has no paged prefill pending."""
        pend = self._prefills.get(slot)
        if pend is None or pend.pages is None:
            return None
        return len(pend.pages) - pend.shared, pend.shared

    def cache_sizes(self) -> dict:
        """The JAX engine's per-program jit-cache counts. Eager PyTorch
        compiles no serving program: every count is 0 (the kernels'
        libraries are `warmup`'s compile cache's business)."""
        out = {"window": 0, "insert": 0, "health": 0}
        if self.paged:
            out.update(prefill_chunk=0, page_row=0)
            if self.kv_int8:
                out["stamp_scales"] = 0
        else:
            out["prefill"] = 0
            if self.prefill_chunk is not None:
                out["prefill_chunk"] = 0
        if self.draft_k is not None:
            out["verify"] = 0
        if self._dmodel is not None:
            out.update(propose=0, draft_ingest=0, draft_insert=0,
                       draft_prefill=0)
        return out

    @torch.no_grad()
    def program_costs(self, window: int) -> dict:
        """Cost/memory accounts (``observe/profile.py`` ProgramCost) of
        the engine's programs, each from one counted real call filed
        through ``profile.register_program``: the window at `window`
        steps (``serve.window``, or ``serve.window_paged``), the verify
        (``lm.verify``) and the learned drafter's propose
        (``serve.propose``) when armed -- each run with every row dead,
        so no cache, logit, position, budget or generator changes (a
        paged engine's dead appends land in the sink page) -- and the
        admission prefill (``serve.prefill``, ``serve.prefill_chunk``,
        or ``serve.prefill_chunk_paged`` against an unallocated table
        row) on fresh state."""
        from idc_models_tpu_torch.observe import profile as prof

        out = {}
        s_rows, dead = self.n_slots, np.zeros(self.n_slots, bool)
        state = (self._model, self._caches)

        def register(name, fn, *args, arguments=state):
            out[name] = prof.register_program(name, fn, *args,
                                              arguments=arguments)[0]

        # dead rows change nothing, so a window in flight keeps its
        # results: these calls run after it in stream order
        rem = self._rem
        self._rem = torch.zeros_like(rem)
        try:
            register("serve.window_paged" if self.paged
                     else "serve.window", self._window, window,
                     np.zeros(s_rows, np.int64), dead)
            if self.draft_k is not None:
                register("lm.verify", self._verify,
                         np.zeros((s_rows, self.draft_k), np.int64), dead)
            if self._dmodel is not None:
                zi = np.zeros(s_rows, np.int64)
                register("serve.propose", self._draft_propose,
                         np.zeros((s_rows, self.draft_k + 1), np.int64),
                         zi, zi, dead,
                         arguments=(self._dmodel, self._dcaches))
        finally:
            self._rem = rem
        c = self.prefill_chunk
        if self.paged:
            none = torch.full((1, self._l_pages), -1, dtype=torch.int32,
                              device=self.device)

            def fold(i, kp, vp, q, kt, vt, start, p_end):
                return self._chunk_fold(
                    kp, vp, none, q, kt, vt, start, p_end,
                    *(self._scales[i] if self.kv_int8 else ()))[:3]

            register("serve.prefill_chunk_paged", _chunk_forward, self._cfg,
                     self._model, self._caches,
                     torch.zeros((1, c), dtype=torch.long,
                                 device=self.device), 0, 0, fold)
        elif c is not None:
            register("serve.prefill_chunk", self._gen.prefill_chunk_step,
                     self._gen.init_caches(1),
                     torch.zeros((1, c), dtype=torch.long), 0, c,
                     arguments=(self._model,))
        else:
            register("serve.prefill", _prefill, self._cfg, self._model,
                     self._gen._ring,
                     torch.zeros((1, self.t_max), dtype=torch.long,
                                 device=self.device), self.t_max,
                     arguments=(self._model,))
        return out
