"""One rank of the port's serving-over-ranks check (``ring_decode``'s
folds over a "seq" group, the engine and `LMServer` on a mesh and under
partition rules). It imports torch and the port only, never JAX.

    python tests/_torch_serve_dist_worker.py STORE WORLD RANK OUT
    python tests/_torch_serve_dist_worker.py --init OUT
    python tests/_torch_serve_dist_worker.py --pod WORLD OUT [--cpu]
    python tests/_torch_serve_dist_worker.py --compare WANT.npz GOT.npz

Every rank joins a world of WORLD (4) ranks through
`mesh.initialize_multihost`, the shared file STORE its rendezvous, reads
the LM's weights from OUT/inputs.npz (written by
`tests/test_torch_serve_dist.py`) and runs the same program:

- the seven folds on this rank's shard of seeded caches over rings of 2
  and 4 ranks, and over a ring of one rank against no ring at all (bit
  for bit); rank 0 writes the outputs and the gathered caches to
  OUT/results.npz;
- `LMServer` over ``seq_mesh(4)`` (greedy, sampled, paged, speculative
  with the n-gram and the learned drafter) and under the "lm" rules on
  ``fsdp_tp_mesh(1, 2, 1)`` and ``(1, 2, 2)`` (with the learned drafter
  under the "draft_lm" rules), and a run whose clock on rank 1 is
  skewed by an hour, with deadlines and a brownout. Each rank writes
  its tokens, statuses and the engine calls it made to
  OUT/rank{RANK}.json, and the layout figures of the sharded engines;
- a slot moved mid-decode between engines of ring widths 1 -> 2,
  2 -> 1 and 2 -> 4 (the snapshot holds the whole row, gathered over
  the source's ring), its greedy tokens against the unmoved runs';
- a weight rollout from a sharded checkpoint directory on the
  tp 2 x seq 2 server under the "lm" rules: each rank restores only
  its blocks, and the promoted weights equal the candidate's.

Where the ranks see cards, each takes one (NCCL, TF32 off) and the same
program runs there; `--compare` holds such a run's results.npz against
a gloo run's, every array within 1e-4 of its largest value (the greedy
tokens equal). `--pod` starts WORLD ranks of this script on OUT (on the
cards it sees, or with `--cpu` on the CPU) and waits for them. With
``IDC_SERVE_DIST_WIDTH=phase12`` the servers run at ``chip_smoke.py``
phase 12's LM widths and t_max (vocab 1,024, embed 512, 8 heads, MLP
2,048, 2 blocks, t_max 32,768; no distillation, whose corpus is
t_max-token streams), and `--init` writes OUT/inputs.npz from the
port's own seed-0 weights (head sharpened x8), for a machine without
JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from idc_models_tpu_torch import collectives, convert, mesh  # noqa: E402
from idc_models_tpu_torch import ring_decode as rd  # noqa: E402
from idc_models_tpu_torch.models import registry  # noqa: E402
from idc_models_tpu_torch.observe import MetricsRegistry  # noqa: E402
from idc_models_tpu_torch.serve import (  # noqa: E402
    BrownoutController, LMServer, Request, SlotEngine, poisson_trace,
)

WORLD = 4
DEVICE = torch.device("cpu")
# the run's directory (`main`)
OUT = Path(".")
COMPARE_TOL = 1e-4
# the LM every server case serves (its weights: OUT/inputs.npz)
VOCAB, E, HEADS, MLP, BLOCKS, T_MAX = 16, 32, 2, 64, 2, 64
DRAFT = dict(embed_dim=16, num_heads=2, mlp_dim=32, num_blocks=1)
# the paged servers: chunk, page size, pages
PAGED_KW = dict(prefill_chunk=8, kv_page_size=8, kv_pages=24)
WIDE = os.environ.get("IDC_SERVE_DIST_WIDTH") == "phase12"
if WIDE:
    VOCAB, E, HEADS, MLP, BLOCKS, T_MAX = 1024, 512, 8, 2048, 2, 32768
    DRAFT = dict(embed_dim=128, num_heads=2, mlp_dim=256, num_blocks=1)
    PAGED_KW = dict(prefill_chunk=512, kv_page_size=256, kv_pages=256)
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=T_MAX)
DRAFT_K = 4
# the folds' caches: rows, t_max, heads, head dim; pool pages and size
FB, FT, FH, FD = 3, 16, 2, 8
N_PAGES, PAGE = 8, 4
FOLD_RINGS = (2, 4)
# engine methods whose calls every rank must make alike
RECORDED = ("admit", "start_prefill", "prefill_step", "cancel_prefill",
            "begin_window", "begin_verify", "collect", "release",
            "propose_all", "ensure_decode_room")


# ---------------------------------------------------------------------------
# the folds
# ---------------------------------------------------------------------------


def fold_inputs() -> dict:
    """Seeded numpy inputs of every fold case: whole caches and pools,
    the new tokens' projections, positions, liveness, page tables."""
    rng = np.random.default_rng(0)

    def f(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)

    def i8(*shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    x = {
        "kc": f(FB, FT, FH, FD), "vc": f(FB, FT, FH, FD),
        "kc8": i8(FB, FT, FH, FD), "vc8": i8(FB, FT, FH, FD),
        "ks": rng.uniform(0.01, 0.05, (FB, FH)).astype(np.float32),
        "vs": rng.uniform(0.01, 0.05, (FB, FH)).astype(np.float32),
        "q6": f(FB, 6, FH, FD), "k6": f(FB, 6, FH, FD), "v6": f(FB, 6, FH, FD),
        "q1": f(FB, 1, FH, FD), "k1": f(FB, 1, FH, FD), "v1": f(FB, 1, FH, FD),
        "q3": f(FB, 3, FH, FD), "k3": f(FB, 3, FH, FD), "v3": f(FB, 3, FH, FD),
        "q8": f(1, 8, FH, FD), "k8": f(1, 8, FH, FD), "v8": f(1, 8, FH, FD),
        "pos": np.asarray([0, 9, 15]), "live": np.asarray([True, False, True]),
        "cpos": np.asarray([0, 6, 12]),
        "kp": f(N_PAGES + 1, PAGE, FH, FD), "vp": f(N_PAGES + 1, PAGE, FH, FD),
        "kp8": i8(N_PAGES + 1, PAGE, FH, FD),
        "vp8": i8(N_PAGES + 1, PAGE, FH, FD),
        "pks": rng.uniform(0.01, 0.05, (N_PAGES + 1, FH)).astype(np.float32),
        "pvs": rng.uniform(0.01, 0.05, (N_PAGES + 1, FH)).astype(np.float32),
        "pt": np.asarray([[0, 5, -1, -1], [1, 2, 4, 7], [6, -1, -1, -1]],
                         np.int32),
        "ppos": np.asarray([5, 13, 2]), "plive": np.asarray([True, True,
                                                               False]),
    }
    return x


def _sharded(fn, x, n, i):
    """Run `fn(shard, pshard)` on rank i's shard of a contiguous cache
    (`shard`) and of a pool (`pshard`: its pages and a sink)."""
    ts, pl = FT // n, N_PAGES // n

    def shard(a):
        return torch.from_numpy(np.ascontiguousarray(
            a[:, i * ts:(i + 1) * ts])).to(DEVICE)

    def pshard(a):
        return torch.from_numpy(np.concatenate(
            [a[i * pl:(i + 1) * pl], a[N_PAGES:]])).to(DEVICE)

    return fn(shard, pshard)


def fold_cases(x) -> dict:
    """name -> fn(shard, pshard, group) -> the fold's outputs: the
    output, then the caches (or pools) and any scales it updates."""
    t = {k: torch.from_numpy(np.asarray(v)).to(DEVICE) for k, v in x.items()}

    def decode(dtype):
        def run(shard, _, g):
            kc, vc = rd.init_cache(FB, FT, FH, FD, dtype=dtype,
                                   device=DEVICE, group=g)
            fold = rd.make_ring_decode(group=g)
            outs = []
            for p in range(6):
                o, kc, vc = fold(kc, vc, t["q6"][:, p:p + 1].to(dtype),
                                 t["k6"][:, p:p + 1].to(dtype),
                                 t["v6"][:, p:p + 1].to(dtype), p)
                outs.append(o)
            return torch.cat(outs, 1), kc, vc
        return run

    def batched(q8):
        def run(shard, _, g):
            kc, vc = (shard(x["kc8"]), shard(x["vc8"])) if q8 else (
                shard(x["kc"]), shard(x["vc"]))
            sc = (t["ks"], t["vs"]) if q8 else ()
            return rd.make_batched_ring_decode(quantized=q8, group=g)(
                kc, vc, t["q1"], t["k1"], t["v1"], t["pos"], t["live"], *sc)
        return run

    def batched_chunk(q8):
        def run(shard, _, g):
            kc, vc = (shard(x["kc8"]), shard(x["vc8"])) if q8 else (
                shard(x["kc"]), shard(x["vc"]))
            sc = (t["ks"], t["vs"]) if q8 else ()
            return rd.make_batched_chunk_ring_decode(quantized=q8, group=g)(
                kc, vc, t["q3"], t["k3"], t["v3"], t["cpos"], t["live"],
                *sc)
        return run

    def chunk(shard, _, g):
        return rd.make_chunk_ring_decode(group=g)(
            shard(x["kc"]), shard(x["vc"]), t["q8"].expand(FB, -1, -1, -1),
            t["k8"].expand(FB, -1, -1, -1), t["v8"].expand(FB, -1, -1, -1),
            4, 10)

    def paged_batched(q8):
        def run(_, pshard, g):
            kp, vp = (pshard(x["kp8"]), pshard(x["vp8"])) if q8 else (
                pshard(x["kp"]), pshard(x["vp"]))
            sc = (t["pks"], t["pvs"]) if q8 else ()
            return rd.make_paged_batched_ring_decode(
                page_size=PAGE, quantized=q8, group=g)(
                kp, vp, t["pt"], t["q1"], t["k1"], t["v1"], t["ppos"],
                t["plive"], *sc)
        return run

    def paged_chunk(q8):
        def run(_, pshard, g):
            kp, vp = (pshard(x["kp8"]), pshard(x["vp8"])) if q8 else (
                pshard(x["kp"]), pshard(x["vp"]))
            sc = (t["pks"].clone(), t["pvs"].clone()) if q8 else ()
            return rd.make_paged_chunk_ring_decode(
                page_size=PAGE, quantized=q8, group=g)(
                kp, vp, t["pt"][1:2], t["q8"], t["k8"], t["v8"], 0, 6, *sc)
        return run

    def paged_batched_chunk(shard, pshard, g):
        return rd.make_paged_batched_chunk_ring_decode(
            page_size=PAGE, group=g)(
            pshard(x["kp"]), pshard(x["vp"]), t["pt"], t["q3"][:, :2],
            t["k3"][:, :2], t["v3"][:, :2], t["ppos"], t["plive"])

    return {"decode": decode(torch.float32),
            "decode_bf16": decode(torch.bfloat16),
            "batched": batched(False), "batched_int8": batched(True),
            "batched_chunk": batched_chunk(False),
            "batched_chunk_int8": batched_chunk(True),
            "chunk": chunk,
            "paged_batched": paged_batched(False),
            "paged_batched_int8": paged_batched(True),
            "paged_chunk": paged_chunk(False),
            "paged_chunk_int8": paged_chunk(True),
            "paged_batched_chunk": paged_batched_chunk}


PAGED = ("paged_batched", "paged_batched_int8", "paged_chunk",
         "paged_chunk_int8", "paged_batched_chunk")


def _whole(name, outs, group, n):
    """A fold's outputs with the caches gathered whole over the ring
    (pools: every rank's pages, sinks dropped)."""
    out = [outs[0]]
    for j, c in enumerate(outs[1:]):
        if name in PAGED and j < 2:
            c = collectives.all_gather(c[:-1].contiguous(), group, axis=0,
                                       tiled=True)
        elif j < 2:
            c = collectives.all_gather(c.contiguous(), group, axis=1,
                                       tiled=True)
        out.append(c)
    return out


def run_folds(x) -> dict:
    """Every fold over rings of 2 and 4 ranks (rank 0's view of the
    outputs and the gathered caches) and, on rank 0, over a ring of one
    rank against no ring (1.0 where bit-equal)."""
    cases = fold_cases(x)
    me = collectives.axis_index()
    results = {}
    for n in FOLD_RINGS:
        m = mesh.seq_mesh(n)
        if me >= n:
            continue
        g = m.group(mesh.SEQ_AXIS)
        for name, fn in cases.items():
            outs = _whole(name, _sharded(lambda s, p: fn(s, p, g), x, n, me),
                          g, n)
            for j, a in enumerate(outs):
                results[f"fold{n}/{name}/{j}"] = a.float().cpu().numpy()
    one = mesh.seq_mesh(1)
    if me == 0:
        g = one.group(mesh.SEQ_AXIS)
        for name, fn in cases.items():
            a = _sharded(lambda s, p: fn(s, p, g), x, 1, 0)
            b = _sharded(lambda s, p: fn(s, p, None), x, 1, 0)
            results[f"ws1/{name}"] = np.float32(all(
                torch.equal(u, v) for u, v in zip(a, b)))
    return results


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------


def trace():
    return poisson_trace(6, rate_per_s=50.0, vocab=VOCAB, t_max=T_MAX,
                         prompt_lens=(2, 16), budgets=(2, 16), seed=3)


def sampled_requests():
    rng = np.random.default_rng(9)
    return [Request(id=f"s{i}",
                    prompt=tuple(int(v) for v in
                                 rng.integers(0, VOCAB, 4 + 3 * i)),
                    max_new_tokens=6, seed=100 + i) for i in range(4)]


def prefix_requests():
    """Six requests sharing a 16-token system prompt (two chunks of 8),
    each with its own 1-5 tokens."""
    rng = np.random.default_rng(11)
    system = tuple(int(v) for v in rng.integers(0, VOCAB, 16))
    return [Request(id=f"p{i}", prompt=system + tuple(
        int(v) for v in rng.integers(0, VOCAB, 1 + i % 5)),
        max_new_tokens=6) for i in range(6)]


def _record(engine, calls):
    """Log every `RECORDED` call the scheduler makes on `engine`."""
    def plain(a):
        if isinstance(a, np.ndarray):
            return a.tolist()
        if torch.is_tensor(a):
            return a.tolist()
        return a

    for name in RECORDED:
        fn = getattr(engine, name, None)
        if fn is None:
            continue

        def wrapped(*args, _fn=fn, _name=name, **kw):
            calls.append(repr((_name, [plain(a) for a in args],
                               {k: plain(v) for k, v in sorted(kw.items())})))
            return _fn(*args, **kw)

        setattr(engine, name, wrapped)


def _drafter(inputs):
    from idc_models_tpu_torch.models.draft_lm import DraftLM, draft_config

    cfg = draft_config(VOCAB, T_MAX, **DRAFT)
    return DraftLM(DRAFT_K, _tree(inputs, "draft"), cfg, device=DEVICE)


def _tree(inputs, prefix):
    return convert.unflatten({k[len(prefix) + 1:]: v for k, v in
                              inputs.items() if k.startswith(prefix + "/")})


def serve_cases(inputs):
    """name -> (mesh axes {fsdp, tp, seq}, LMServer kwargs, requests,
    realtime). The mesh is fsdp_tp_mesh when tp > 1, else seq_mesh."""
    lm = registry.get_partition_rules("lm")
    reqs = [r for _, r in trace()]
    paged = PAGED_KW
    return {
        "seq4": ((1, 1, 4), dict(n_slots=3, window=4), reqs),
        "seq4_sampled": ((1, 1, 4), dict(n_slots=2, window=4,
                                         temperature=1.3, top_k=4),
                         sampled_requests()),
        "seq4_paged": ((1, 1, 4), dict(n_slots=3, window=4, **paged), reqs),
        "seq4_int8": ((1, 1, 4), dict(n_slots=3, window=4,
                                      kv_dtype="int8"), reqs),
        "seq4_prefix": ((1, 1, 4), dict(
            n_slots=2, window=4, prefill_chunk=paged["prefill_chunk"],
            prefix_cache_mb=1.0), prefix_requests()),
        "seq4_spec": ((1, 1, 4), dict(n_slots=3, window=4, spec_decode=True,
                                      draft_k=DRAFT_K, **paged), reqs),
        "seq4_learned": ((1, 1, 4), dict(
            n_slots=3, window=4, spec_decode=True, draft_k=DRAFT_K,
            drafter=_drafter(inputs)), reqs),
        "tp2": ((1, 2, 1), dict(n_slots=3, window=4, partition_rules=lm),
                reqs),
        "tp2seq2": ((1, 2, 2), dict(n_slots=3, window=4,
                                    partition_rules=lm), reqs),
        "tp2seq2_paged": ((1, 2, 2), dict(n_slots=3, window=4,
                                          partition_rules=lm, **paged),
                          reqs),
        "tp2seq2_learned": ((1, 2, 2), dict(
            n_slots=3, window=4, partition_rules=lm, spec_decode=True,
            draft_k=DRAFT_K, drafter=_drafter(inputs),
            draft_partition_rules=registry.get_partition_rules("draft_lm")),
            reqs),
    }


def _serve(params, axes, kw, reqs, *, clock=time.monotonic, realtime=False,
           brownout=None):
    """One server case on this rank: (tokens, statuses, engine calls,
    layout figures), or None for a rank the mesh leaves out."""
    f, tp, seq = axes
    m = (mesh.fsdp_tp_mesh(f, tp, seq) if tp > 1 else mesh.seq_mesh(seq))
    m.host_group()
    if m.coords is None:
        return None
    calls = []
    server = LMServer(params, mesh=m, registry=MetricsRegistry(),
                      cache_dtype=torch.float32, device=DEVICE, clock=clock,
                      brownout=brownout, **KW, **kw)
    _record(server.engine, calls)
    entries = [(getattr(r, "_arrival", 0.0), r) for r in reqs]
    server.run(entries, realtime=realtime)
    eng = server.engine
    layout = {
        "kv_shape": list(eng._caches[0][0].shape),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in eng._model.parameters()),
        "whole_param_bytes": sum(
            int(np.prod(eng._whole_shape(n, p))) * p.element_size()
            for n, p in eng._model.named_parameters()),
    }
    # the rollout's hooks on this layout: a spot-check of the same weights
    # through the live (sharded) model, then a swap of them in place
    spot = eng.spot_check_params(params)["code"]
    eng.swap_params(params)
    summary = server.summary()
    out = {"tokens": {r.id: server.poll(r.id).tokens for r in reqs},
           "status": {r.id: server.poll(r.id).status for r in reqs},
           "calls": calls, "layout": layout, "spot_check": spot,
           "summary_requests": summary["serve_requests"],
           "prefix_hits": summary.get("serve_prefix_hits")}
    server.close()
    return out


def skew_case(params):
    """A realtime trace with deadlines and a brownout, rank 1's clock an
    hour ahead of the others': every rank must still decide alike."""
    me = collectives.axis_index()

    def clock():
        return time.monotonic() + (3600.0 if me == 1 else 0.0)

    rng = np.random.default_rng(4)
    reqs = []
    for i in range(10):
        r = Request(id=f"k{i}", prompt=tuple(int(v) for v in
                                             rng.integers(0, VOCAB, 5)),
                    max_new_tokens=12,
                    deadline_s=0.02 if i % 3 == 0 else None)
        reqs.append((0.002 * i, r))
    brownout = BrownoutController(queue_high=2, clamp_tokens=4,
                                  escalate_dwell_s=0.0, clear_after_s=0.01,
                                  clock=clock)
    m = mesh.seq_mesh(4)
    m.host_group()
    calls = []
    server = LMServer(params, mesh=m, registry=MetricsRegistry(),
                      cache_dtype=torch.float32, device=DEVICE, clock=clock,
                      brownout=brownout, n_slots=2, window=4,
                      max_queue_depth=4, **KW)
    _record(server.engine, calls)
    server.run(reqs, realtime=True)
    out = {"tokens": {r.id: server.poll(r.id).tokens for _, r in reqs},
           "status": {r.id: server.poll(r.id).status for _, r in reqs},
           "calls": calls, "brownout_max_stage": brownout.max_stage_seen}
    server.close()
    return out


def teaching_case(params) -> dict:
    """The messages an engine's mesh is refused with: a "model" axis
    without rules, a "data" axis, and a page pool the ring does not
    divide."""
    out = {}
    for name, axes, kw in (
            ("model", {"data": 1, "model": 2, "seq": 1}, {}),
            ("data", {"data": 2, "seq": 2}, {}),
            ("pages", {"seq": 4}, dict(prefill_chunk=8, kv_page_size=8,
                                       kv_pages=18))):
        m = mesh.make_mesh(axes)
        m.host_group()
        if m.coords is None:
            continue
        try:
            SlotEngine(params, mesh=m, device=DEVICE, **KW, **kw)
        except ValueError as e:
            out[name] = str(e)
    return out


def distill_case(inputs) -> dict:
    """The drafter distilled data-parallel over 4 ranks, with the
    "draft_lm" rules storing its parameters and moments by rule and
    without: the per-epoch losses of both, and the parameter bytes a
    rank's optimizer keeps under the rules against the whole tree's."""
    from idc_models_tpu_torch.models import draft_lm as dlm
    from idc_models_tpu_torch.models.lm import serving_model

    target = serving_model(_tree(inputs, "params"), num_heads=HEADS,
                           num_blocks=BLOCKS, device=DEVICE)
    cfg = dlm.draft_config(VOCAB, T_MAX, **DRAFT)
    prompts = np.random.default_rng(5).integers(0, VOCAB, (16, 3))
    streams = dlm.greedy_streams(target, prompts, T_MAX)
    m = mesh.data_mesh(4)
    out = {}
    for name, rules in (("rules", registry.get_partition_rules("draft_lm")),
                        ("plain", None)):
        _, state, hist = dlm.distill_draft_lm(
            target, streams, config=cfg, mesh=m, epochs=2, batch_size=8,
            rules=rules)
        blocks = getattr(state.optimizer, "blocks", None)
        out[name] = {"loss": [float(v) for v in hist["loss"]],
                     "param_bytes": sum(b.numel() * b.element_size()
                                        for b in blocks) if blocks else None,
                     "whole_param_bytes": sum(
                         p.numel() * p.element_size()
                         for p in state.model.parameters())}
    return out


# the moved slot: a prompt past a ring-of-4 shard (T_MAX/4), a budget
MOVE_PROMPT_LEN, MOVE_BUDGET = 36, 14


def _finish(eng, slot, logits=None) -> list:
    """Decode `slot` to its end by windows of 4; its tokens. `logits`
    (a list) gets the slot's last-token logits after each window."""
    out = []
    while eng._occupied[slot] and eng._rem_h[slot] > 0:
        out += eng.step_window(4).get(slot, [])
        if logits is not None:
            logits.append(eng._logits[slot].float().cpu())
    eng.release(slot)
    return out


def migration_case(params) -> dict:
    """A greedy request on engines over rings of 1, 2 and 4 ranks:
    unmoved, and moved after one window of 4 from ring 1 to 2, 2 to 1
    and 2 to 4 (the snapshot sent from rank 0 to every rank). Every rank
    reports the tokens it saw; ranks outside a ring see none of its, and
    the largest difference of a moved run's logits after each window
    from the unmoved run's on its source ring, over that run's largest
    |logit| (zeros in place of positions a snapshot lacked would move
    them far)."""
    me = collectives.axis_index()
    prompt = np.random.default_rng(10).integers(0, VOCAB, MOVE_PROMPT_LEN)
    meshes = {n: mesh.seq_mesh(n) for n in (1, 2, 4)}

    def engine(n):
        if meshes[n].coords is None:
            return None
        return SlotEngine(params, mesh=meshes[n], n_slots=2, device=DEVICE,
                          cache_dtype=torch.float32, **KW)

    def exported(n):
        """(tokens of the first window, snapshot on every rank)."""
        eng, mid, snap = engine(n), None, None
        if eng is not None:
            eng.admit(1, prompt, MOVE_BUDGET)
            mid = eng.step_window(4)[1]
            snap = eng.export_slot(1)
            eng.release(1)
        box = [(mid, snap)]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def moved(snap, n, logits):
        eng = engine(n)
        if eng is None:
            return None
        eng.import_slot(0, snap)
        return _finish(eng, 0, logits)

    out, unmoved = {}, {}
    for n in (1, 2, 4):
        eng = engine(n)
        if eng is not None:
            eng.admit(1, prompt, MOVE_BUDGET)
            unmoved[n] = []
            out[f"unmoved{n}"] = _finish(eng, 1, unmoved[n])
    snaps = {}
    for src, dsts in ((1, (2,)), (2, (1, 4))):
        mid, snap = exported(src)
        snaps[src] = snap
        out[f"snap{src}_pos"] = snap["pos"]
        out[f"snap{src}_rows"] = [list(k.shape) for k, _ in snap["caches"]]
        for dst in dsts:
            logits = []
            rest = moved(snap, dst, logits)
            if rest is not None:
                out[f"moved{src}to{dst}"] = mid + rest
                if src in unmoved:
                    want = torch.stack(unmoved[src][1:])
                    out[f"moved{src}to{dst}_logit_err"] = float(
                        (torch.stack(logits) - want).abs().max()
                        / want.abs().max())
    # the same positions from rings of one and two ranks
    out["snap_rows_max_diff"] = max(
        float((a - b).abs().max()) for (ka, va), (kb, vb) in zip(
            snaps[1]["caches"], snaps[2]["caches"])
        for a, b in ((ka, kb), (va, vb)))
    out["rank"] = me
    return out


def rollout_case(params, out_dir: Path) -> dict:
    """A rollout from a sharded checkpoint directory onto the tp 2 x
    seq 2 server under the "lm" rules (the candidate: every weight
    x 0.5, saved whole): the stage, the bytes of this rank's
    restored candidate against its live parameters' and the whole
    tree's, and, on rank 0, the largest difference between the promoted
    weights (gathered) and the candidate's."""
    from idc_models_tpu_torch import partition
    from idc_models_tpu_torch.checkpoint import save_sharded
    from idc_models_tpu_torch.checkpoint.rollout import run_with_rollout

    cand = {k: np.asarray(v) * np.float32(0.5)
            for k, v in convert.flatten(params).items()}
    path = out_dir / "rollout_candidate"
    # every rank takes part in the save; rank 0 writes the whole leaves
    save_sharded(path, convert.unflatten(cand)).wait()
    m = mesh.fsdp_tp_mesh(1, 2, 2)
    m.host_group()
    server = LMServer(params, mesh=m, registry=MetricsRegistry(),
                      cache_dtype=torch.float32, device=DEVICE, n_slots=3,
                      window=4,
                      partition_rules=registry.get_partition_rules("lm"),
                      **KW)
    results, ctl = run_with_rollout(
        server, list(trace()), path, start_after=0.0, canary_fraction=0.5,
        canary_requests=1, ttft_slack=float("inf"))
    held = ctl.candidate
    promoted = server.engine._model.gathered_params()
    diff = max(float(np.abs(np.asarray(v) - cand[k]).max())
               for k, v in convert.flatten(promoted).items())
    live_bytes = sum(p.numel() * p.element_size()
                     for p in server.engine._model.parameters())
    out = {"stage": ctl.stage, "reason": ctl.reason,
           "statuses": sorted({r.status for r in results}),
           "n_results": len(results),
           "block_tree": isinstance(held, partition.BlockTree),
           "candidate_bytes": sum(int(np.asarray(v).nbytes) for v in
                                  convert.flatten(held).values()),
           "live_bytes": live_bytes,
           "whole_bytes": sum(v.nbytes for v in cand.values()),
           "promoted_max_diff": diff}
    server.close()
    return out


def run_servers(inputs) -> dict:
    params = _tree(inputs, "params")
    out = {}
    for name, (axes, kw, reqs) in serve_cases(inputs).items():
        got = _serve(params, axes, kw, reqs)
        if got is not None:
            out[name] = got
    out["skew"] = skew_case(params)
    out["teaching"] = teaching_case(params)
    out["migration"] = migration_case(params)
    out["rollout"] = rollout_case(params, OUT)
    if not WIDE:
        # its corpus is the target's greedy streams of t_max tokens
        out["distill"] = distill_case(inputs)
    return out


# ---------------------------------------------------------------------------


def init_inputs(out: Path) -> None:
    """OUT/inputs.npz from the port's seed-0 LM and seed-1 drafter (the
    head sharpened x8, as the tests sharpen JAX's)."""
    from idc_models_tpu_torch.models.core import init_params
    from idc_models_tpu_torch.models.draft_lm import draft_config, draft_lm
    from idc_models_tpu_torch.models.lm import AttentionLM

    tree = convert.to_jax(init_params(AttentionLM(
        VOCAB, T_MAX, embed_dim=E, num_heads=HEADS, mlp_dim=MLP,
        num_blocks=BLOCKS), 0))[0]
    tree["head"]["kernel"] = tree["head"]["kernel"] * 8.0
    draft = convert.to_jax(init_params(draft_lm(draft_config(
        VOCAB, T_MAX, **DRAFT)), 1))[0]
    flat = {f"params/{k}": v for k, v in convert.flatten(tree).items()}
    flat.update({f"draft/{k}": v for k, v in convert.flatten(draft).items()})
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "inputs.npz", **flat)


def pod(world: int, out: Path, cpu: bool) -> int:
    """Start `world` ranks of this script on `out` and wait for them;
    the first nonzero exit code, or 0."""
    import subprocess

    out = out.resolve()
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get(
        "OMP_NUM_THREADS", "1"))
    if cpu:
        env["CUDA_VISIBLE_DEVICES"] = ""
    (out / "store").unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(out / "store"), str(world), str(r),
         str(out)], env=dict(env, LOCAL_RANK=str(r)),
        stdout=open(out / f"log.{r}", "w"), stderr=subprocess.STDOUT)
        for r in range(world)]
    codes = [p.wait() for p in procs]
    print(f"pod of {world} on {out}: exit codes {codes}")
    return next((c for c in codes if c), 0)


def compare(want_path: str, got_path: str) -> int:
    """Hold a run's results against another's (a card run against a gloo
    run): every shared array within COMPARE_TOL of the reference's
    largest value. Prints the worst relative error by case; returns 1
    past the bar."""
    want, got = dict(np.load(want_path)), dict(np.load(got_path))
    worst: dict[str, float] = {}
    for k in sorted(set(want) & set(got)):
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        err = float(np.abs(g - w).max()) / (1.0 + float(np.abs(w).max()))
        case = "/".join(k.split("/")[:2])
        worst[case] = max(worst.get(case, 0.0), err)
    missing = sorted(set(want) ^ set(got))
    for case, err in worst.items():
        print(f"{case}: {err!r}")
    bad = {c: e for c, e in worst.items() if not e <= COMPARE_TOL}
    print(f"{len(worst)} cases, worst {max(worst.values())!r}, bar "
          f"{COMPARE_TOL}; past it: {bad}; keys in one file only: {missing}")
    return 1 if bad or missing else 0


def main(store: str, world: int, rank: int, out: Path) -> None:
    global DEVICE
    torch.set_num_threads(1)
    mesh.PROCESS_GROUP_TIMEOUT_S = 120.0
    mesh.initialize_multihost(f"file://{store}", world, rank)
    if torch.cuda.is_available():
        DEVICE = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        global OUT
        OUT = out
        inputs = dict(np.load(out / "inputs.npz"))
        results = run_folds(fold_inputs())
        servers = run_servers(inputs)
        for name, case in servers.items():
            # the sampled draws are the device's generator's, and the
            # skewed run's statuses the wall clock's: neither compares
            # across devices
            if name not in ("skew", "seq4_sampled") and "tokens" in case:
                for rid, toks in case["tokens"].items():
                    results[f"serve/{name}/{rid}"] = np.asarray(toks,
                                                                np.float64)
        (out / f"rank{rank}.json").write_text(json.dumps(servers))
        dist.barrier()
        if rank == 0:
            np.savez(out / "results.npz", **results)
        (out / f"done.{rank}").write_text("ok")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    if sys.argv[1] == "--init":
        sys.exit(init_inputs(Path(sys.argv[2])))
    if sys.argv[1] == "--pod":
        sys.exit(pod(int(sys.argv[2]), Path(sys.argv[3]),
                     "--cpu" in sys.argv[4:]))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
