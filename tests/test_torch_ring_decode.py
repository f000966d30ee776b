"""The port's serving folds (idc_models_tpu_torch/ring_decode.py: the
batched float and int8 folds, the chunk fold, `prefill`) and chunked
prefill (models/lm.py: `check_prefill_chunk`, `chunked_prefill`,
`Generator(prefill_chunk=C)`) against the JAX package's on a one-device
"seq" mesh, on the CPU: the same numpy inputs through both, the JAX LM's
weights carried across by `convert.load_jax`."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import mesh as meshlib
from idc_models_tpu import ring_decode as jdecode
from idc_models_tpu.models import lm as jlm
from idc_models_tpu_torch import ring_decode as tdecode
from idc_models_tpu_torch.models import lm as tlm

B, T, H, D = 4, 32, 2, 8
TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB, E, HEADS, MLP, BLOCKS, T_MAX = 16, 32, 2, 64, 2, 64
KW = dict(embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS, t_max=T_MAX)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(rng, *shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def _mesh():
    return meshlib.seq_mesh(1)


@functools.lru_cache(maxsize=None)
def _jax_fold(kind: str):
    """The JAX fold, jitted once per module (eager shard_map takes
    seconds a call); positions are traced, so the cases share it."""
    if kind == "chunk":
        return jax.jit(jdecode.make_chunk_ring_decode(_mesh()))
    return jax.jit(jdecode.make_batched_ring_decode(
        _mesh(), quantized=kind == "int8"))


# live rows at the first slot, mid-cache and the last slot; dead rows
# mid-cache and one past the end (the finished frontier)
POS = np.array([0, 17, 12, 32])
LIVE = np.array([True, True, False, False])
POS_LIVE_END = np.array([31, 17, 12, 32])


@pytest.mark.parametrize("pos", [POS, POS_LIVE_END],
                         ids=["first_slot", "last_slot"])
def test_batched_fold_matches_jax_and_leaves_dead_rows(pos):
    """Outputs of the live rows and both caches against the JAX batched
    fold (f32, 1e-5); the dead rows' cache rows bit-untouched."""
    rng = np.random.default_rng(int(pos[0]))
    kc, vc = _normal(rng, B, T, H, D), _normal(rng, B, T, H, D)
    q, k, v = (_normal(rng, B, 1, H, D) for _ in range(3))
    want = _jax_fold("float")(*map(jnp.asarray, (kc, vc, q, k, v)), pos,
                              LIVE)
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tdecode.make_batched_ring_decode()(
        kt, vt, *map(torch.from_numpy, (q, k, v)), pos, LIVE)
    assert got[1] is kt and got[2] is vt         # appended in place
    np.testing.assert_allclose(got[0][LIVE], np.asarray(want[0])[LIVE],
                               **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    for g, before in zip(got[1:], (kc, vc)):
        assert np.array_equal(g.numpy()[~LIVE], before[~LIVE])


def test_int8_batched_fold_matches_jax_quantized_fold():
    """int8 caches with per-(row, head) scales: the appended int8 values
    bit for bit (the same f32 division, round half to even, clip at
    +-127), the live rows' outputs at 1e-5, dead rows untouched."""
    rng = np.random.default_rng(3)
    kc, vc = (rng.integers(-127, 128, (B, T, H, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, (B, H)).astype(np.float32)
              for _ in range(2))
    q = _normal(rng, B, 1, H, D)
    # token K/V past +-127 levels on purpose: the append clips
    k, v = (4.0 * _normal(rng, B, 1, H, D) for _ in range(2))
    k[0, 0, 0, :2] = [0.5 * 0.01, 1.5 * 0.01]    # exact half levels
    want = _jax_fold("int8")(*map(jnp.asarray, (kc, vc, q, k, v)), POS,
                             LIVE, jnp.asarray(ks), jnp.asarray(vs))
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tdecode.make_batched_ring_decode(quantized=True)(
        kt, vt, *map(torch.from_numpy, (q, k, v)), POS, LIVE,
        torch.from_numpy(ks), torch.from_numpy(vs))
    assert kt.dtype == torch.int8
    np.testing.assert_allclose(got[0][LIVE], np.asarray(want[0])[LIVE],
                               **TOL)
    for g, w, before in zip(got[1:], want[1:], (kc, vc)):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy()[~LIVE], before[~LIVE])


def test_rows_at_one_position_equal_the_one_token_fold_bit_for_bit():
    """The batched fold with every row at the same position is the
    one-token fold (the same attend, the same shapes)."""
    rng = np.random.default_rng(5)
    kc, vc = _normal(rng, B, T, H, D), _normal(rng, B, T, H, D)
    q, k, v = (torch.from_numpy(_normal(rng, B, 1, H, D)) for _ in range(3))
    one = tdecode.make_ring_decode()(torch.from_numpy(kc.copy()),
                                     torch.from_numpy(vc.copy()), q, k, v, 9)
    batched = tdecode.make_batched_ring_decode()(
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), q, k, v,
        [9] * B, [True] * B)
    for a, b in zip(one, batched):
        assert torch.equal(a, b)


@pytest.mark.parametrize("call,match", [
    (lambda f, fq, x, y: fq(*x, *y), "needs \\(k_scale, v_scale\\)"),
    (lambda f, fq, x, y: f(*x, torch.ones(B, H), torch.ones(B, H)),
     "scales passed to a non-quantized fold"),
    (lambda f, fq, x, y: f(x[0], x[1], *(torch.zeros(B, 2, H, D),) * 3,
                           *x[5:]), "ONE token per row"),
    (lambda f, fq, x, y: f(*x[:5], [0, 1], x[6]),
     "one position per row"),
    (lambda f, fq, x, y: f(*x[:5], [0, T, 3, 4], [True, True, False,
                                                  False]),
     "live pos \\[32\\] outside the cache"),
], ids=["no_scales", "stray_scales", "two_tokens", "pos_shape",
        "pos_range"])
def test_batched_fold_checks_carry_the_jax_messages(call, match):
    x = (torch.zeros(B, T, H, D), torch.zeros(B, T, H, D),
         *(torch.zeros(B, 1, H, D),) * 3, [0] * B, [True] * B)
    with pytest.raises(ValueError, match=match):
        call(tdecode.make_batched_ring_decode(),
             tdecode.make_batched_ring_decode(quantized=True), x, ())


@pytest.mark.parametrize("start,p_end", [(0, 8), (8, 13), (24, 32)])
def test_chunk_fold_matches_jax(start, p_end):
    """A chunk of 8 at `start` over a cache holding a real prefix below
    it (and garbage past it): the real queries' outputs and both caches
    against the JAX chunk fold."""
    rng = np.random.default_rng(start)
    c = 8
    kc, vc = _normal(rng, 2, T, H, D), _normal(rng, 2, T, H, D)
    q, k, v = (_normal(rng, 2, c, H, D) for _ in range(3))
    want = _jax_fold("chunk")(*map(jnp.asarray, (kc, vc, q, k, v)), start,
                              p_end)
    got = tdecode.make_chunk_ring_decode()(
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
        *map(torch.from_numpy, (q, k, v)), start, p_end)
    n = p_end - start
    np.testing.assert_allclose(got[0][:, :n], np.asarray(want[0])[:, :n],
                               **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert torch.isfinite(got[0]).all()


def test_chunk_fold_checks_and_prefill_match_jax():
    fold = tdecode.make_chunk_ring_decode()
    cache = torch.zeros(1, T, H, D)
    with pytest.raises(ValueError, match="expects \\[B, C, H, D\\]"):
        fold(cache, cache, *(torch.zeros(1, H, D),) * 3, 0, 1)
    with pytest.raises(ValueError, match="outside the cache"):
        fold(cache, cache, *(torch.zeros(1, 8, H, D),) * 3, T - 4, T)
    rng = np.random.default_rng(7)
    kp, vp = _normal(rng, 2, 5, H, D), _normal(rng, 2, 5, H, D)
    want = jdecode.prefill(_mesh(), kp, vp, T, dtype=jnp.float32)
    got = tdecode.prefill(torch.from_numpy(kp), torch.from_numpy(vp), T,
                          dtype=torch.float32)
    for g, w in zip(got, want):
        assert g.shape == (2, T, H, D)
        assert np.array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="exceeds t_max"):
        tdecode.prefill(torch.zeros(1, T + 1, H, D), torch.zeros(1, T + 1, H,
                                                               D), T)


@pytest.mark.parametrize("chunk", [0, 65, 24, 7])
def test_check_prefill_chunk_messages_match_jax(chunk):
    with pytest.raises(ValueError) as want:
        jlm.check_prefill_chunk(chunk, T_MAX)
    with pytest.raises(ValueError) as got:
        tlm.check_prefill_chunk(chunk, T_MAX)
    assert str(got.value) == str(want.value)
    assert tlm.check_prefill_chunk(16, T_MAX) == 16


def _jax_params(seed):
    model = jlm.attention_lm(VOCAB, T_MAX, embed_dim=E, num_heads=HEADS,
                             mlp_dim=MLP, num_blocks=BLOCKS)
    params = jax.device_get(model.init(jax.random.key(seed)).params)
    # a sharper head: the greedy picks along the paths below win by far
    # more than the two packages' rounding (the premise is checked)
    params = jax.tree.map(np.array, params)
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params


def test_chunked_prefill_matches_jax_from_fresh_and_on_resume():
    """`chunked_prefill` (chunk 8, a ragged last chunk) against the JAX
    function: the last real position's logits and every cache, from
    fresh caches and resumed at a chunk boundary."""
    params = _jax_params(11)
    tokens = np.random.default_rng(12).integers(0, VOCAB, (2, 21))
    jgen = jlm.Generator(params, cache_dtype=jnp.float32, prefill_chunk=8,
                         **KW)
    tgen = tlm.Generator(params, cache_dtype=torch.float32, prefill_chunk=8,
                         device="cpu", **KW)
    j_logits, j_caches = jlm.chunked_prefill(jgen._fns, jgen._params,
                                             tokens, 8)
    t_logits, t_caches = tlm.chunked_prefill(tgen, tokens, 8)
    np.testing.assert_allclose(t_logits, np.asarray(j_logits), rtol=1e-5,
                               atol=1e-5)
    for tc, jc in zip(t_caches, j_caches):
        for t, j in zip(tc, jc):
            np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5,
                                       atol=1e-5)
    # resume at 16 from the first two chunks' caches: the same answer
    _, head = tlm.chunked_prefill(tgen, tokens[:, :16], 8)
    r_logits, r_caches = tlm.chunked_prefill(tgen, tokens, 8, caches=head,
                                             start=16)
    assert torch.equal(r_logits, t_logits)
    for rc, tc in zip(r_caches, t_caches):
        for r, t in zip(rc, tc):
            assert torch.equal(r, t)
    for bad in (3, 24):
        with pytest.raises(ValueError, match="chunk resume start"):
            tlm.chunked_prefill(tgen, tokens, 8, start=bad)


def test_chunked_generator_matches_jax_generator():
    """`Generator(prefill_chunk=8)` greedy tokens against the JAX
    Generator's with the same chunk, prompts of 5 and 19 tokens; the
    chunked prefill's logits against the bucketed one's."""
    params = _jax_params(13)
    rng = np.random.default_rng(14)
    jgen = jlm.Generator(params, cache_dtype=jnp.float32, prefill_chunk=8,
                         **KW)
    tgen = tlm.Generator(params, cache_dtype=torch.float32, prefill_chunk=8,
                         device="cpu", **KW)
    whole = tlm.Generator(params, cache_dtype=torch.float32, device="cpu",
                          **KW)
    for p_len in (5, 19):
        prompt = rng.integers(0, VOCAB, (1, p_len))
        want = np.asarray(jgen(jnp.asarray(prompt, jnp.int32), 10))
        got = tgen(prompt, 10).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(tgen.prefill(prompt)[0],
                                   whole.prefill(prompt)[0], rtol=1e-5,
                                   atol=1e-5)
        # the premise: each pick won by far more than the rounding
        with torch.no_grad():
            seq = torch.from_numpy(np.pad(want, ((0, 0), (0, T_MAX - want.shape[1]))))
            lg = whole._model(seq)[:, p_len - 1:p_len + 9]
        top2 = lg.topk(2, dim=-1).values
        assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-3
