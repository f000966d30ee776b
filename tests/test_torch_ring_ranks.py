"""The port's ring over several ranks (ring_attention.py, collectives.py,
mesh.py) against numpy and the JAX package's ring on an n-device CPU
mesh: four gloo ranks on the CPU, started once for the module from
`tests/_torch_ring_worker.py` (torch and the port only), hold rings of
2, 3 and 4 ranks -- both layouts, both block engines, causal or not,
values and gradients -- and every collective. The JAX side runs here,
in the test process, on the conftest's virtual devices."""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import mesh as meshlib
from idc_models_tpu import ring_attention as jring

import _torch_ring_worker as worker

WORKER = Path(worker.__file__)
WORLD = 4
DEADLINE_S = 240.0


class _Ranks:
    """The worker processes of one module run; `results()` waits for
    them (killing them all past the deadline or when one fails) and
    loads rank 0's file."""

    def __init__(self, out: Path):
        self.out = out
        # no card: the ranks join over gloo
        env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        self.logs = [open(out / f"log.{r}", "w") for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(out / "store"), str(WORLD),
             str(r), str(out)], stdout=log, stderr=subprocess.STDOUT,
            env=env) for r, log in enumerate(self.logs)]
        self.started = time.monotonic()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=30)
        for log in self.logs:
            log.close()

    @functools.cached_property
    def results(self):
        while any(p.poll() is None for p in self.procs):
            failed = any(p.poll() not in (None, 0) for p in self.procs)
            if failed or time.monotonic() - self.started > DEADLINE_S:
                break
            time.sleep(0.1)
        self.kill()
        codes = [p.returncode for p in self.procs]
        if codes != [0] * WORLD:
            logs = "\n".join(f"--- rank {r}:\n"
                             + (self.out / f"log.{r}").read_text()[-3000:]
                             for r in range(WORLD))
            pytest.fail(f"ring ranks ended with {codes}\n{logs}")
        return dict(np.load(self.out / "results.npz"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = _Ranks(tmp_path_factory.mktemp("ring_ranks"))
    yield run
    run.kill()


@functools.cache
def _jax_ring(n: int, layout: str, causal: bool, impl: str):
    """Output and (dq, dk, dv) of the JAX package's ring on an n-device
    "seq" mesh (its pallas blocks interpret on the CPU), natural order."""
    ring = jring.make_ring_attention(meshlib.seq_mesh(n), causal=causal,
                                     layout=layout, block_impl=impl)

    def fn(q, k, v):
        if layout == "zigzag":
            zz = (jring.to_zigzag(x, n) for x in (q, k, v))
            return jring.from_zigzag(ring(*zz), n)
        return ring(q, k, v)

    q, k, v, g = (jnp.asarray(x) for x in worker.ring_inputs(n))
    out, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(x) for x in (out, *vjp(g))]


def _full_attention_f64(n: int, causal: bool):
    """Full attention and its gradients in float64 numpy."""
    q, k, v, g = (x.astype(np.float64) for x in worker.ring_inputs(n))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * worker.D ** -0.5
    if causal:
        t = q.shape[1]
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bkhd->bqhd", p, v)
    dp = np.einsum("bqhd,bkhd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True)) * worker.D ** -0.5
    return [out, np.einsum("bhqk,bkhd->bqhd", ds, k),
            np.einsum("bhqk,bqhd->bkhd", ds, q),
            np.einsum("bhqk,bqhd->bkhd", p, g)]


# the JAX package's own pallas ring runs where its schedule is the one
# in question (zigzag, causal) at 2 ranks; elsewhere its jnp ring,
# the same function
_JAX_PALLAS = {(2, "zigzag", True)}


@pytest.mark.parametrize(
    "n,layout,impl,causal", worker.CASES,
    ids=[worker.case_key(*c) for c in worker.CASES])
def test_ring_on_ranks_matches_jax_ring_and_full_attention(
        ranks, n, layout, impl, causal):
    """This rank count's ring, gathered and un-permuted, against the JAX
    ring on an n-device mesh and float64 full attention: values rtol and
    atol 1e-5, gradients rtol 2e-4 and atol 2e-5, as the one-card ring's
    tests."""
    jax_impl = impl if (n, layout, causal) in _JAX_PALLAS else "jnp"
    want = _jax_ring(n, layout, causal, jax_impl)
    full = _full_attention_f64(n, causal)
    key = worker.case_key(n, layout, impl, causal)
    got = [ranks.results[f"{key}_{name}"]
           for name in ("out", "dq", "dk", "dv")]
    for name, g, w, f in zip(("out", "dq", "dk", "dv"), got, want, full):
        tol = (dict(rtol=1e-5, atol=1e-5) if name == "out"
               else dict(rtol=2e-4, atol=2e-5))
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=f"{name} vs jax", **tol)
        np.testing.assert_allclose(g, f, err_msg=f"{name} vs f64", **tol)


@pytest.mark.parametrize("layout,impl", worker.BLOCK_CASES,
                         ids=[f"{l}_{i}" for l, i in worker.BLOCK_CASES])
def test_transformer_block_on_ranks_matches_a_ring_of_one(ranks, layout,
                                                          impl):
    """A causal TransformerBlock given the 4-rank ring's group, each
    rank holding its shard of the stream, against the same weights on a
    ring of one over the whole sequence: output and input gradient
    gathered and un-permuted, and the parameter gradients summed over
    the ranks, at the ring tests' tolerances."""
    key = f"block_{layout}_{impl}"
    for what in ("out", "dx", "dparams"):
        got = ranks.results[f"{key}_{what}_ring"]
        want = ranks.results[f"{key}_{what}_one"]
        tol = (dict(rtol=1e-5, atol=1e-5) if what == "out"
               else dict(rtol=2e-4, atol=2e-5))
        assert got.shape == want.shape and np.isfinite(got).all(), what
        np.testing.assert_allclose(got, want, err_msg=what, **tol)


def test_zigzag_flop_ratio_gate_at_four_ranks(ranks):
    """The load-balance claim of tests/test_zigzag.py's FLOP gate, per
    rank: each of 4 ranks' causal zigzag forward does (2n+1)/4n = 9/16
    of the contiguous forward's FLOPs (torch.utils.flop_counter on the
    plain engine, whose blocks it counts exactly), every rank the same."""
    n = worker.FLOP_RING
    ratios = ranks.results["flop_ratio"].ravel()
    assert len(ratios) == WORLD
    np.testing.assert_allclose(ratios, (2 * n + 1) / (4 * n), rtol=0,
                               atol=1e-12)


def test_a_sequence_the_ring_cannot_split_is_refused_as_in_jax(ranks):
    """T = 7 over a ring of 2: the JAX package's ValueError, word for
    word."""
    q = jnp.zeros((1, 7, 1, worker.D))
    with pytest.raises(ValueError) as want:
        jring.make_ring_attention(meshlib.seq_mesh(2))(q, q, q)
    assert str(ranks.results["shard_error"]) == str(want.value)


def test_one_rank_world_without_a_process_group(monkeypatch):
    """Without torch.distributed the world is this one rank: every
    collective returns its input's values, a mesh has axes of size 1
    and group None, a ring of one is the identity, and an init with no
    world size in the environment does nothing."""
    from idc_models_tpu_torch import collectives, mesh
    from idc_models_tpu_torch import ring_attention as tring

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh.initialize_multihost()
    assert not collectives.initialized()
    assert (collectives.axis_index(), collectives.axis_size()) == (0, 1)
    x = torch.arange(6.0).reshape(2, 3)
    for got in (collectives.psum({"a": x})["a"], collectives.pmean(x),
                collectives.weighted_pmean(x, 2.0),
                collectives.ring_psum(x), collectives.reduce_scatter(x),
                collectives.ppermute(x, None, collectives.ring_perm(1)),
                collectives.all_gather(x, tiled=True)):
        assert torch.equal(got, x)
    assert torch.equal(collectives.all_gather(x), x[None])
    assert torch.equal(collectives.weighted_pmean(x, 0.0),
                       torch.zeros_like(x))
    for m in (mesh.seq_mesh(), mesh.data_seq_mesh(1)):
        assert set(m.shape.values()) == {1}
        assert all(m.group(a) is None for a in m.axis_names)
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        mesh.seq_mesh(2)
    assert mesh.largest_dividing_mesh(6) == 1
    assert tring.local_shard(x[None], None).shape == (1, 2, 3)
    assert tring.make_ring(None).hop(x) == (x,)


def _coll(ranks, key):
    return ranks.results[f"coll_{key}"]


def _rows(x):
    """The same result on every rank."""
    return np.broadcast_to(x, (WORLD,) + np.shape(x))


def test_collectives_match_numpy(ranks):
    """Every collective of a 4-rank world against numpy, as
    tests/test_collectives.py holds the JAX package's: row r of each
    result is rank r's."""
    vals = worker.collective_values(WORLD)
    w = worker.COLLECTIVE_WEIGHTS
    np.testing.assert_array_equal(
        _coll(ranks, "axis"), [[r, WORLD] for r in range(WORLD)])
    np.testing.assert_allclose(
        _coll(ranks, "psum"),
        _rows(np.concatenate([vals.sum(0), 2 * vals.sum(0)])), rtol=1e-6)
    np.testing.assert_allclose(_coll(ranks, "pmean"), _rows(vals.mean(0)),
                               rtol=1e-6)
    mean = (vals * w[:, None]).sum(0) / w.sum()
    for key in ("weighted", "weighted_nan"):
        np.testing.assert_allclose(_coll(ranks, key), _rows(mean),
                                   rtol=1e-5, err_msg=key)
    local = ((vals * w[:, None]).sum(0) + (3 * vals).sum(0)) / (w.sum()
                                                                + WORLD)
    np.testing.assert_allclose(_coll(ranks, "weighted_local"), _rows(local),
                               rtol=1e-5)
    np.testing.assert_array_equal(_coll(ranks, "gather"), _rows(vals))
    np.testing.assert_array_equal(_coll(ranks, "gather_tiled"), _rows(vals))
    # ring shift by one: rank r receives rank r-1's row
    np.testing.assert_array_equal(_coll(ranks, "ppermute"),
                                  np.roll(vals, 1, axis=0))
    partial = np.roll(vals, 1, axis=0)
    partial[0] = 0.0
    np.testing.assert_array_equal(_coll(ranks, "ppermute_partial"), partial)
    np.testing.assert_allclose(_coll(ranks, "ppermute_ring_sum"),
                               _rows(vals.sum(0)), rtol=1e-6)
    # d/dy of sum(ppermute(y) * (r + 1)) at rank r is the weight of the
    # rank y went to, r + 1, so (r + 2)
    np.testing.assert_array_equal(
        _coll(ranks, "ppermute_grad"),
        np.repeat(((np.arange(WORLD) + 1) % WORLD + 1.0)[:, None],
                  vals.shape[1], axis=1))
    np.testing.assert_allclose(_coll(ranks, "ring_psum"), _rows(vals.sum(0)),
                               rtol=1e-6)
    # integer sums are exact, in any order
    np.testing.assert_array_equal(_coll(ranks, "ring_psum_int"),
                                  _coll(ranks, "psum_int"))
    ints = (vals * 1e8).astype(np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        _coll(ranks, "psum_int"),
        _rows(ints.sum(0, dtype=np.int64).astype(np.int32)))
    # every rank's input is its row tiled [WORLD, 6]: each row of the
    # sum is the column sum, and rank r keeps row r
    np.testing.assert_allclose(_coll(ranks, "reduce_scatter"),
                               _rows(vals.sum(0)[None]), rtol=1e-6)
    np.testing.assert_array_equal(_coll(ranks, "dividing"),
                                  _rows([1, 3, 1, 4, 4]))
    # the (data 2, seq 2) grid: seq groups are rows [0,1], [2,3], data
    # groups columns [0,2], [1,3]
    np.testing.assert_array_equal(_coll(ranks, "grid"),
                                  [[0, 0], [0, 1], [1, 0], [1, 1]])
    seq_sums = [vals[0] + vals[1]] * 2 + [vals[2] + vals[3]] * 2
    data_sums = [vals[0] + vals[2], vals[1] + vals[3]] * 2
    np.testing.assert_allclose(_coll(ranks, "grid_seq_sum"), seq_sums,
                               rtol=1e-6)
    np.testing.assert_allclose(_coll(ranks, "grid_data_sum"), data_sums,
                               rtol=1e-6)
