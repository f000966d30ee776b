"""The port's flash block update, blockwise backward and ring attention
(idc_models_tpu_torch/ops/flash_block_kernel.py, ring_attention.py)
against the JAX package's, on the CPU: the same numpy inputs through the
JAX function (its Pallas kernels in interpret mode, its ring on a
one-device mesh) and through the port (the kernels' plain versions, as
a CPU tensor takes them)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import mesh as meshlib
from idc_models_tpu import ring_attention as jring
from idc_models_tpu.ops import flash_block_kernel as jfbk
from idc_models_tpu_torch import ring_attention as tring
from idc_models_tpu_torch.ops import build
from idc_models_tpu_torch.ops import flash_block_kernel as tfbk

B, T, H, D = 2, 256, 2, 32
SCALE = D ** -0.5


def _inputs(seed=0, t_q=T, t_k=T):
    """q/k/v and a mid-stream carry (as if one block was already folded
    in), so the corr-rescale path is covered, not just a fresh start."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, t_q, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, t_k, H, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, t_k, H, D)).astype(np.float32)
    m = rng.normal(0, 1, (B, H, t_q)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (B, H, t_q)).astype(np.float32)
    acc = rng.normal(0, 1, (B, t_q, H, D)).astype(np.float32)
    return q, k, v, m, l, acc


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want, rtol, atol, names):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_fold_matches_jax_reference_and_interpret_kernel(causal):
    """`reference_impl` and `flash_block_update` (the plain fold on a CPU
    tensor) against the JAX reference and its interpret-mode kernel,
    offsets [128, 0], mid-stream carry; 1e-5 as tests/test_flash_block.py."""
    ins = _inputs()
    offs = np.array([128, 0], np.int32)
    want_ref = jfbk.reference_impl(*_j(*ins), jnp.asarray(offs),
                                   scale=SCALE, causal=causal)
    want_kernel = jfbk.make_flash_block_update(
        scale=SCALE, causal=causal, interpret=True)(*_j(*ins),
                                                    jnp.asarray(offs))
    got_ref = tfbk.reference_impl(*_t(*ins), torch.from_numpy(offs),
                                  scale=SCALE, causal=causal)
    got_upd = tfbk.flash_block_update(*_t(*ins), torch.from_numpy(offs),
                                      scale=SCALE, causal=causal)
    names = ("m", "l", "acc")
    for got in (got_ref, got_upd):
        _close(got, want_ref, 1e-5, 1e-5, names)
        _close(got, want_kernel, 1e-5, 1e-5, names)


def test_first_block_fully_masked_heals_as_in_jax():
    """A fresh carry folded with a fully masked block (offsets [0, 256]:
    every key after every query) then a visible one equals the JAX
    reference after both folds: the p = exp(0) garbage cancels."""
    q, k, v, *_ = _inputs(seed=3)
    m0 = np.full((B, H, T), -1e30, np.float32)
    l0 = np.zeros((B, H, T), np.float32)
    acc0 = np.zeros((B, T, H, D), np.float32)
    carry_t, carry_j = _t(m0, l0, acc0), _j(m0, l0, acc0)
    for offs in ([0, 256], [256, 0]):
        carry_t = tfbk.flash_block_update(*_t(q, k, v), *carry_t, offs,
                                          scale=SCALE, causal=True)
        carry_j = jfbk.reference_impl(*_j(q, k, v), *carry_j,
                                      jnp.asarray(offs, jnp.int32),
                                      scale=SCALE, causal=True)
    _close(carry_t, carry_j, 1e-5, 1e-5, ("m", "l", "acc"))
    out = tring.finalize(carry_t[1], carry_t[2], torch.float32)
    assert torch.isfinite(out).all()


def test_update_gradients_match_jax_custom_vjp():
    """Gradients through `flash_block_update` (autograd of the plain
    fold) against jax.grad through the interpret-mode kernel's
    custom_vjp; rtol 5e-4, atol 1e-4 as tests/test_flash_block.py."""
    q, k, v, m, l, acc = _inputs(seed=2)
    offs = np.array([0, 0], np.int32)
    upd = jfbk.make_flash_block_update(scale=SCALE, causal=True,
                                       interpret=True)

    def jloss(q_, k_, v_):
        m2, l2, a2 = upd(q_, k_, v_, *_j(m, l, acc), jnp.asarray(offs))
        return jnp.sum(a2 ** 2) + jnp.sum(l2 ** 2) + jnp.sum(m2)

    want = jax.grad(jloss, (0, 1, 2))(*_j(q, k, v))
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    m2, l2, a2 = tfbk.flash_block_update(qt, kt, vt, *_t(m, l, acc), offs,
                                         scale=SCALE, causal=True)
    (a2.square().sum() + l2.square().sum() + m2.sum()).backward()
    _close((qt.grad, kt.grad, vt.grad), want, 5e-4, 1e-4, ("dq", "dk", "dv"))


@pytest.mark.parametrize("causal", [False, True])
def test_block_grads_match_jax_reference_and_interpret_kernels(causal):
    """`block_grads_reference` and `flash_block_grads` (the dense formula
    on a CPU tensor) against the JAX mirror and its interpret-mode dq and
    dk/dv kernels; 1e-4 as tests/test_flash_block.py."""
    rng = np.random.default_rng(4)
    q, k, v, do = (rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
                   for _ in range(4))
    L = (rng.normal(0, 1, (B, H, T)) + 3.0).astype(np.float32)
    Dr = rng.normal(0, 1, (B, H, T)).astype(np.float32)
    offs = np.array([128, 0], np.int32)
    args = (q, k, v, do, L, Dr)
    want_ref = jfbk.block_grads_reference(*_j(*args), jnp.asarray(offs),
                                          scale=SCALE, causal=causal)
    want_kernel = jfbk.make_flash_block_grads(
        scale=SCALE, causal=causal, interpret=True)(*_j(*args),
                                                    jnp.asarray(offs))
    names = ("dq", "dk", "dv")
    for fn in (tfbk.block_grads_reference, tfbk.flash_block_grads):
        got = fn(*_t(*args), torch.from_numpy(offs), scale=SCALE,
                 causal=causal)
        assert all(g.dtype == torch.float32 for g in got)
        _close(got, want_ref, 1e-4, 1e-4, names)
        _close(got, want_kernel, 1e-4, 1e-4, names)


@pytest.mark.parametrize("block_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring_and_full_attention(block_impl, causal):
    """The port's ring against the JAX ring on a one-device "seq" mesh
    (same block impl; pallas interprets on the CPU) and against full
    attention; 1e-5."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(0, 1, (1, T, H, D)).astype(np.float32)
               for _ in range(3))
    jring_fn = jring.make_ring_attention(meshlib.seq_mesh(1), causal=causal,
                                         block_impl=block_impl)
    want = np.asarray(jring_fn(*_j(q, k, v)))
    want_full = np.asarray(jring.full_attention(*_j(q, k, v), causal=causal))
    ring = tring.make_ring_attention(causal=causal, block_impl=block_impl)
    got = ring(*_t(q, k, v))
    got_full = tring.full_attention(*_t(q, k, v), causal=causal)
    _close((got, got, got_full), (want, want_full, want_full), 1e-5, 1e-5,
           ("ring vs jax ring", "ring vs full", "full vs jax full"))


def test_pallas_ring_gradients_match_full_attention():
    """Gradients through the pallas ring's autograd.Function (the
    blockwise backward ring) against autograd of full attention, and
    against jax.grad of the JAX full attention; rtol 2e-4, atol 2e-5 as
    tests/test_flash_block.py."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(0, 1, (1, 512, H, D)).astype(np.float32)
               for _ in range(3))
    ring = tring.make_ring_attention(causal=True, block_impl="pallas")
    grads = []
    for fn in (ring, lambda a, b, c: tring.full_attention(a, b, c,
                                                          causal=True)):
        ins = [t.requires_grad_() for t in _t(q, k, v)]
        fn(*ins).square().sum().backward()
        grads.append([t.grad for t in ins])
    want_j = jax.grad(lambda a, b, c: jnp.sum(jring.full_attention(
        a, b, c, causal=True) ** 2), (0, 1, 2))(*_j(q, k, v))
    for g in grads[0]:
        assert torch.isfinite(g).all()
    _close(grads[0], grads[1], 2e-4, 2e-5, ("dq", "dk", "dv"))
    _close(grads[0], want_j, 2e-4, 2e-5, ("dq", "dk", "dv"))


def test_pallas_ring_saves_no_quadratic_tensor():
    """What the pallas ring keeps for its backward: no saved tensor has
    two axes of length T -- the port's form of the JAX package's
    test_pallas_backward_is_blockwise. The jnp ring is the positive
    control: autograd of its fold saves the [B, H, T, T] scores."""
    t = 512
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, t, H, D))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))

    def saved_shapes(block_impl):
        shapes = []

        def pack(x):
            shapes.append(tuple(x.shape))
            return x

        ring = tring.make_ring_attention(causal=True, block_impl=block_impl)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            out = ring(q, k, v)
        out.sum().backward()
        return [s for s in shapes if sum(d == t for d in s) >= 2]

    assert saved_shapes("pallas") == []
    assert saved_shapes("jnp"), "the detector failed its positive control"


def test_non_tile_multiple_rejected_as_in_jax():
    """T = 192 is refused with the JAX package's ValueError, by the block
    update, the backward, and the pallas ring -- on the CPU too."""
    q, k, v, m, l, acc = _inputs(t_q=192, t_k=192)
    offs = np.array([0, 0], np.int32)
    with pytest.raises(ValueError, match="multiples of 128") as want:
        jfbk.make_flash_block_update(scale=SCALE, causal=False,
                                     interpret=True)(*_j(q, k, v, m, l, acc),
                                                     jnp.asarray(offs))
    with pytest.raises(ValueError, match="multiples of 128") as got:
        tfbk.flash_block_update(*_t(q, k, v, m, l, acc), offs, scale=SCALE,
                                causal=False)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="multiples of 128"):
        tfbk.flash_block_grads(*_t(q, k, v, q, m, l), offs, scale=SCALE,
                               causal=False)
    with pytest.raises(ValueError, match="multiples of 128"):
        tring.make_ring_attention(causal=True, block_impl="pallas")(
            *_t(q, k, v))


def test_zigzag_helpers_match_jax_and_the_layout_is_not_ported():
    """The zigzag helpers equal the JAX package's, and the layout the
    port once refused now runs: the rings build, and refuse what the
    JAX rings refuse with the JAX package's ValueErrors (an odd local
    block; quarters off the kernels' 128 tile under pallas)."""
    x = np.arange(2 * 64 * 3, dtype=np.float32).reshape(2, 64, 3)
    for n in (1, 2, 4):
        assert np.array_equal(tring.zigzag_indices(64, n),
                              jring.zigzag_indices(64, n))
        zz = tring.to_zigzag(torch.from_numpy(x), n)
        np.testing.assert_array_equal(zz, jring.to_zigzag(jnp.asarray(x), n))
        np.testing.assert_array_equal(tring.from_zigzag(zz, n), x)
    mesh = meshlib.seq_mesh(1)
    for t, impl in ((5, "jnp"), (384, "pallas"), (129, "pallas")):
        q = np.zeros((1, t, 1, 16), np.float32)
        with pytest.raises(ValueError) as want:
            jring.make_ring_attention(mesh, causal=True, layout="zigzag",
                                      block_impl=impl)(*_j(q, q, q))
        with pytest.raises(ValueError) as got:
            tring.make_ring_attention(causal=True, layout="zigzag",
                                      block_impl=impl)(*_t(q, q, q))
        assert str(got.value) == str(want.value)
    # a non-causal zigzag ring is the contiguous walk: no even-block rule
    q = np.ones((1, 5, 1, 16), np.float32)
    np.testing.assert_allclose(
        tring.make_ring_attention(layout="zigzag")(*_t(q, q, q)), q)
    with pytest.raises(ValueError, match="unknown block_impl"):
        tring.make_ring_attention(block_impl="triton")
    with pytest.raises(ValueError, match="unknown layout"):
        tring.make_ring_attention(layout="striped")


@pytest.mark.parametrize("block_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
def test_zigzag_ring_of_one_matches_jax_and_full_attention(block_impl,
                                                           causal):
    """The zigzag ring at ring size 1 (three quarter folds when causal)
    against the JAX zigzag ring on seq_mesh(1), same block impl, and
    against full attention: values 1e-5, gradients rtol 2e-4 atol 2e-5
    (tests/test_zigzag.py:92-153)."""
    rng = np.random.default_rng(9)
    q, k, v, g = (rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    jfn = jring.make_ring_attention(meshlib.seq_mesh(1), causal=causal,
                                    layout="zigzag", block_impl=block_impl)
    want, jvjp = jax.vjp(jfn, *_j(q, k, v))
    want_grads = jvjp(jnp.asarray(g))
    ring = tring.make_ring_attention(causal=causal, layout="zigzag",
                                     block_impl=block_impl)
    outs, grads = [], []
    for fn in (ring, lambda a, b, c: tring.full_attention(a, b, c,
                                                          causal=causal)):
        ins = [t.requires_grad_() for t in _t(q, k, v)]
        out = fn(*ins)
        out.backward(torch.from_numpy(g))
        outs.append(out.detach())
        grads.append([t.grad for t in ins])
    _close((outs[0], outs[0]), (want, outs[1]), 1e-5, 1e-5,
           ("ring vs jax ring", "ring vs full"))
    # the one-shot wrapper builds (and caches) the same ring
    once = tring.ring_attention(*_t(q, k, v), causal=causal,
                                layout="zigzag", block_impl=block_impl)
    assert torch.equal(once, outs[0])
    _close(grads[0], want_grads, 2e-4, 2e-5, ("dq", "dk", "dv"))
    _close(grads[0], grads[1], 2e-4, 2e-5, ("dq", "dk", "dv"))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_zigzag_schedule_folds_each_visible_stripe_pair_once(n):
    """The quarter schedule both zigzag walks read: rank me folds 2n+1
    quarters, each (query stripe, key stripe) pair at or below the
    causal diagonal exactly once, causal exactly on the diagonal; its
    query stripes are its own (me, 2n-1-me), and at step s its key
    stripe is one of rank (me - s) mod n's."""
    th = 4
    for me in range(n):
        own = (me, 2 * n - 1 - me)
        seen = []
        for s, step in enumerate(tring.zigzag_schedule(me, n, th)):
            c = (me - s) % n
            for qi, ki, q_off, k_off, causal in step:
                qs, ks = q_off // th, k_off // th
                assert qs == own[qi]
                assert ks == (c, 2 * n - 1 - c)[ki]
                assert causal == (qs == ks)
                seen.append((qs, ks))
        assert len(seen) == 2 * n + 1
        assert sorted(seen) == sorted((a, b) for a in own
                                      for b in range(2 * n) if b <= a)


def test_kernels_refuse_cpu_tensors_and_count_no_cpu_calls():
    """A CPU tensor never reaches a kernel; a launch refuses one. The
    three kernels build as their own libraries, named by source hash."""
    q, k, v, m, l, acc = _t(*_inputs())
    offs = torch.tensor([0, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfbk._launch_update(q, k, v, m, l, acc, offs, SCALE, True)
    for launch in (tfbk.flash_block_dq, tfbk.flash_block_dkv):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch(q, k, v, q, m, l, offs, scale=SCALE, causal=True)
    before = [kern.launches for kern in tfbk.KERNELS]
    tfbk.flash_block_update(q, k, v, m, l, acc, offs, scale=SCALE,
                            causal=True)
    tfbk.flash_block_grads(q, k, v, q, m, l, offs, scale=SCALE, causal=True)
    assert [kern.launches for kern in tfbk.KERNELS] == before
    for kern, stem in zip(tfbk.KERNELS, ("flash_block_fwd", "flash_block_dq",
                                         "flash_block_dkv")):
        path = kern.library_path()
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{stem}-")


# ---------------------------------------------------------------------------
# causal tile skipping in the backward kernels: the span rule, and why
# leaving the pairs outside it out changes no bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_causal_chunk_span_covers_exactly_the_visible_chunks(seed):
    """Over random offsets, tile sizes and T: the dq view (chunks
    [0, n_chunks[i]) of tile i) and the dk/dv view (tiles from
    first_tile[j] of chunk j) both hold a (tile, chunk) pair iff
    `causal_block_mask` shows a visible pair in it."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        rows, cols = (int(x) for x in rng.choice([16, 32, 64, 128], 2))
        t_q = rows * int(rng.integers(1, 7))
        t_k = cols * int(rng.integers(1, 7))
        q_off, k_off = (int(x) for x in rng.integers(0, 700, 2))
        n_chunks, first_tile = tfbk.causal_chunk_span(t_q, t_k, rows, cols,
                                                      q_off, k_off)
        mask = tfbk.causal_block_mask(t_q, t_k, q_off, k_off)[0, 0]
        for i in range(t_q // rows):
            for j in range(t_k // cols):
                visible = bool(mask[i * rows:(i + 1) * rows,
                                    j * cols:(j + 1) * cols].any())
                assert (j < n_chunks[i]) == visible, (rows, cols, i, j)
                assert (i >= first_tile[j]) == visible, (rows, cols, i, j)


def _span_inputs(seed, t_q, t_k, q_off, k_off, true_lse):
    """q/k/v/dout blocks cut from one sequence of q_off + t_q queries and
    k_off + t_k keys, with L either drawn as chip_smoke.py draws it
    (N(0, 1) + 3 + log T_k) or the true causal logsumexp of each query
    over the whole sequence's keys; D = N(0, 1)."""
    rng = np.random.default_rng(seed)
    n = max(q_off + t_q, k_off + t_k)
    q_all, k_all, v, do = (rng.normal(0, 1, (B, n, H, D)).astype(np.float32)
                           for _ in range(4))
    q = q_all[:, q_off:q_off + t_q]
    k, v = k_all[:, k_off:k_off + t_k], v[:, k_off:k_off + t_k]
    do = do[:, q_off:q_off + t_q]
    if true_lse:
        s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                      k_all.astype(np.float64)) * SCALE
        pos = np.arange(n)
        s = np.where(q_off + np.arange(t_q)[:, None] >= pos[None, :], s,
                     -np.inf)
        top = s.max(-1, keepdims=True)
        L = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]
    else:
        L = rng.normal(0, 1, (B, H, t_q)) + 3.0 + np.log(t_k)
    Dr = rng.normal(0, 1, (B, H, t_q))
    return q, k, v, do, L.astype(np.float32), Dr.astype(np.float32)


@pytest.mark.parametrize("true_lse", [False, True])
def test_pairs_outside_the_span_add_exact_zeros(true_lse):
    """Every (tile, chunk) pair the span leaves out gives dq, dk and dv
    exactly 0 through `block_grads_reference` (at the kernels' tile sizes
    and at 128), and -- at the JAX kernels' 128 tile -- through the JAX
    mirror and its interpret-mode dq and dk/dv kernels too."""
    t_q, t_k, q_off, k_off = 256, 512, 128, 0
    q, k, v, do, L, Dr = _span_inputs(8, t_q, t_k, q_off, k_off, true_lse)
    kw = dict(scale=SCALE, causal=True)
    jgrads = jfbk.make_flash_block_grads(interpret=True, **kw)
    for rows, cols in ((64, 64), (64, 32), (32, 64), (128, 128)):
        n_chunks, _ = tfbk.causal_chunk_span(t_q, t_k, rows, cols, q_off,
                                             k_off)
        skipped = [(i, j) for i, n in enumerate(n_chunks)
                   for j in range(n, t_k // cols)]
        assert skipped
        for i, j in skipped:
            qs, ks = slice(i * rows, (i + 1) * rows), slice(j * cols,
                                                            (j + 1) * cols)
            args = (q[:, qs], k[:, ks], v[:, ks], do[:, qs], L[..., qs],
                    Dr[..., qs])
            offs = np.array([q_off + i * rows, k_off + j * cols], np.int32)
            got = tfbk.block_grads_reference(*_t(*args),
                                             torch.from_numpy(offs), **kw)
            outs = [got]
            if rows == cols == 128:
                outs.append(jfbk.block_grads_reference(
                    *_j(*args), jnp.asarray(offs), **kw))
                outs.append(jgrads(*_j(*args), jnp.asarray(offs)))
            for out in outs:
                for g, name in zip(out, ("dq", "dk", "dv")):
                    assert not np.asarray(g).any(), (rows, cols, i, j, name)


@pytest.mark.parametrize("offsets", [(0, 0), (128, 0), (96, 160)])
@pytest.mark.parametrize("d", [32, 128])
def test_plain_backward_summed_over_the_span_equals_the_full_one(d,
                                                                 offsets):
    """dq summed over each query tile's span of key chunks, and dk/dv
    summed over each key chunk's span of query tiles, at the kernels' own
    tile sizes for this D (`backward_tiles`), equal the full plain
    backward within f32 rounding (the sums run in another order)."""
    t_q, t_k = 256, 384
    q_off, k_off = offsets
    rng = np.random.default_rng(9)
    q, do = (rng.normal(0, 1, (1, t_q, 2, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(0, 1, (1, t_k, 2, d)).astype(np.float32)
            for _ in range(2))
    L = (rng.normal(0, 1, (1, 2, t_q)) + 3.0 + np.log(t_k)).astype(
        np.float32)
    Dr = rng.normal(0, 1, (1, 2, t_q)).astype(np.float32)
    kw = dict(scale=d ** -0.5, causal=True)
    full = tfbk.block_grads_reference(*_t(q, k, v, do, L, Dr),
                                      torch.tensor(offsets), **kw)
    tiles = tfbk.backward_tiles(d)

    def part(i, rows, j, cols):
        qs, ks = slice(i * rows, (i + 1) * rows), slice(j * cols,
                                                        (j + 1) * cols)
        return tfbk.block_grads_reference(
            *_t(q[:, qs], k[:, ks], v[:, ks], do[:, qs], L[..., qs],
                Dr[..., qs]),
            torch.tensor([q_off + i * rows, k_off + j * cols]), **kw)

    rows, cols = tiles["dq"]
    n_chunks, _ = tfbk.causal_chunk_span(t_q, t_k, rows, cols, q_off, k_off)
    dq = torch.zeros_like(full[0])
    for i, n in enumerate(n_chunks):
        for j in range(n):
            dq[:, i * rows:(i + 1) * rows] += part(i, rows, j, cols)[0]
    rows, cols = tiles["dkv"]
    _, first_tile = tfbk.causal_chunk_span(t_q, t_k, rows, cols, q_off,
                                           k_off)
    dk, dv = torch.zeros_like(full[1]), torch.zeros_like(full[2])
    for j, first in enumerate(first_tile):
        for i in range(first, t_q // rows):
            _, dkp, dvp = part(i, rows, j, cols)
            dk[:, j * cols:(j + 1) * cols] += dkp
            dv[:, j * cols:(j + 1) * cols] += dvp
    for got, want, name in zip((dq, dk, dv), full, ("dq", "dk", "dv")):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=name)


# ---------------------------------------------------------------------------
# causal chunk skipping in the update kernel: the span, the vote after it,
# and why a fully masked chunk may be left out only for rows past MASKED
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_update_chunk_span_covers_exactly_the_visible_chunks(seed):
    """Over random offsets, tile sizes, T and carries: a tile's span holds
    chunk j iff `causal_block_mask` shows a visible pair in it, and the
    tile walks past its span (every chunk) iff some row of it sees no key
    of the block and was not past MASKED in the carry."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        rows, cols = (int(x) for x in rng.choice([16, 32, 64, 128], 2))
        t_q = rows * int(rng.integers(1, 7))
        t_k = cols * int(rng.integers(1, 7))
        q_off, k_off = (int(x) for x in rng.integers(0, 700, 2))
        carried = (None if rng.random() < 0.5
                   else rng.random(t_q) < rng.choice([0.5, 0.99, 1.0]))
        span, walked = tfbk.update_chunk_span(t_q, t_k, rows, cols, q_off,
                                              k_off, carried=carried)
        mask = tfbk.causal_block_mask(t_q, t_k, q_off, k_off)[0, 0]
        for i in range(t_q // rows):
            tile = mask[i * rows:(i + 1) * rows]
            for j in range(t_k // cols):
                visible = bool(tile[:, j * cols:(j + 1) * cols].any())
                assert (j < span[i]) == visible, (rows, cols, i, j)
            seen = tile.any(1).numpy()
            if carried is not None:
                seen |= carried[i * rows:(i + 1) * rows]
            assert walked[i] == (span[i] if seen.all() else t_k // cols)


@pytest.mark.parametrize("d", tfbk.HEAD_DIMS)
def test_fully_masked_chunk_is_a_no_op_only_past_the_sentinel(d):
    """A chunk of `forward_tiles(d)` keys that every query precedes,
    folded through `block_attend`: rows whose m > MASKED get their carry
    back bit for bit; rows at MASKED do not -- m stays MASKED, l grows by
    the chunk width and acc by the column sum of v (the garbage that heals
    at the next visible block), which is why the kernel must not skip
    them."""
    rows, cols = tfbk.forward_tiles(d)
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.normal(0, 1, (1, rows, 2, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(0, 1, (1, cols, 2, d))
                             .astype(np.float32)) for _ in range(2))
    m = torch.from_numpy(rng.normal(0, 3, (1, 2, rows)).astype(np.float32))
    at_sentinel = torch.zeros(rows, dtype=torch.bool)
    at_sentinel[::3] = True
    m[..., at_sentinel] = tfbk.MASKED
    l = torch.from_numpy(rng.uniform(0.5, 2.0, (1, 2, rows))
                         .astype(np.float32))
    acc = torch.from_numpy(rng.normal(0, 1, (1, rows, 2, d))
                           .astype(np.float32))
    mask = tfbk.causal_block_mask(rows, cols, 0, rows)
    assert not mask.any()
    m2, l2, acc2 = tfbk.block_attend(q, k, v, m, l, acc, scale=d ** -0.5,
                                     mask=mask)
    past = ~at_sentinel
    assert torch.equal(m2[..., past], m[..., past])
    assert torch.equal(l2[..., past], l[..., past])
    assert torch.equal(acc2[:, past], acc[:, past])
    assert (m2[..., at_sentinel] == tfbk.MASKED).all()
    torch.testing.assert_close(l2[..., at_sentinel],
                               l[..., at_sentinel] + cols)
    colsum = v.sum(1)[:, None]                      # [1, 1, H, D]
    torch.testing.assert_close(acc2[:, at_sentinel],
                               (acc[:, at_sentinel] + colsum).expand(
                                   -1, int(at_sentinel.sum()), -1, -1))


def _skipping_fold(q, k, v, m, l, acc, offsets):
    """The update kernel's walk in plain PyTorch: each query tile of
    `forward_tiles(D)` folds its span chunk by chunk through
    `block_attend`, then votes on its rows' m and folds the chunks past
    the span only if some row is still at MASKED. Returns the carry and
    the chunks each tile walked."""
    rows, cols = tfbk.forward_tiles(q.shape[-1])
    t_q, t_k = q.shape[1], k.shape[1]
    span, _ = tfbk.update_chunk_span(t_q, t_k, rows, cols, *offsets)
    m, l, acc = m.clone(), l.clone(), acc.clone()
    walked = []

    def fold(i, j):
        qs, ks = slice(i * rows, (i + 1) * rows), slice(j * cols,
                                                        (j + 1) * cols)
        mask = tfbk.causal_block_mask(rows, cols, offsets[0] + i * rows,
                                      offsets[1] + j * cols)
        m[..., qs], l[..., qs], acc[:, qs] = tfbk.block_attend(
            q[:, qs], k[:, ks], v[:, ks], m[..., qs], l[..., qs],
            acc[:, qs], scale=SCALE, mask=mask)

    for i in range(t_q // rows):
        for j in range(span[i]):
            fold(i, j)
        n = span[i]
        if not (m[..., i * rows:(i + 1) * rows] > tfbk.MASKED).all():
            for j in range(span[i], t_k // cols):
                fold(i, j)
            n = t_k // cols
        walked.append(n)
    return (m, l, acc), walked


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("offsets", [(0, 0), (128, 0), (0, 32)])
def test_skipping_fold_matches_jax_block_attend_and_interpret_kernel(
        offsets, fresh):
    """The chunk-by-chunk fold that skips by the span and the vote equals
    the JAX package's `_block_attend` and its interpret-mode kernel on
    the whole block, fresh or mid-stream carry; 1e-5 as the file's other
    f32 folds. It walks what `update_chunk_span` says: at (0, 32) with a
    fresh carry rows 0-31 never see a key, so tile 0's vote fails and it
    walks every chunk, keeping the plain version's garbage in those
    rows."""
    q, k, v, m, l, acc = _inputs(seed=11)
    if fresh:
        m = np.full_like(m, tfbk.MASKED)
        l, acc = np.zeros_like(l), np.zeros_like(acc)
    offs = np.array(offsets, np.int32)
    got, walked = _skipping_fold(*_t(q, k, v, m, l, acc), offsets)
    mask = jring.causal_block_mask(T, T, *offsets)
    want_ref = jring._block_attend(*_j(q, k, v, m, l, acc), scale=SCALE,
                                   mask=mask)
    want_kernel = jfbk.make_flash_block_update(
        scale=SCALE, causal=True, interpret=True)(*_j(q, k, v, m, l, acc),
                                                  jnp.asarray(offs))
    names = ("m", "l", "acc")
    _close(got, want_ref, 1e-5, 1e-5, names)
    _close(got, want_kernel, 1e-5, 1e-5, names)
    rows, cols = tfbk.forward_tiles(D)
    span, want_walked = tfbk.update_chunk_span(
        T, T, rows, cols, *offsets,
        carried=None if fresh else m[0, 0] > tfbk.MASKED)
    assert walked == want_walked
    assert (walked != span) == (fresh and offsets == (0, 32))
