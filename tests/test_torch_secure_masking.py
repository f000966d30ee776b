"""The port's secure-masking primitives (idc_models_tpu_torch/secure/
masking.py and ops/secure_masking_kernel.py's plain version) against the
JAX package's, on the CPU.

Everything here is integer or exactly-rounded arithmetic, so the
tolerance is none: every comparison is bit for bit."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng

from idc_models_tpu.models import core as jcore
from idc_models_tpu.models import mobilenet as jmobilenet
from idc_models_tpu.models.small_cnn import small_cnn as jsmall_cnn
from idc_models_tpu.ops import secure_masking_kernel as jsmk
from idc_models_tpu.secure import masking as jm
from idc_models_tpu_torch import convert
from idc_models_tpu_torch.models import core as tcore
from idc_models_tpu_torch.models import mobilenet as tmobilenet
from idc_models_tpu_torch.models import small_cnn as tsmall
from idc_models_tpu_torch.ops import secure_masking_kernel as tsmk
from idc_models_tpu_torch.secure import masking as tm

SB, CLIP = 20, 64.0


def _edge_values(n: int, seed: int) -> np.ndarray:
    """Normal draws with clip edges and exact half-steps mixed in: ±clip,
    beyond it, and (k + 0.5) * 2^-sb, where round-half-to-even decides."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, n).astype(np.float32)
    k = rng.integers(-2**20, 2**20, n)
    half = ((k + 0.5) * 2.0 ** -SB).astype(np.float32)
    edges = np.array([CLIP, -CLIP, 64.5, -1e9, 1e9, 0.0, -0.0,
                      0.5 * 2.0 ** -SB, -0.5 * 2.0 ** -SB,
                      1.5 * 2.0 ** -SB, -2.5 * 2.0 ** -SB], np.float32)
    x[::3] = half[::3]
    x[:min(n, len(edges))] = edges[:n]
    return x


@pytest.mark.parametrize("n_clients", [1, 3, 8])
@pytest.mark.parametrize("round_index", [0, 5])
def test_pair_seeds_and_signs_match_jax(n_clients, round_index):
    for base in (0, 123, 0xFFFFFFFF):
        for me in range(n_clients):
            js, jg = jsmk.pair_seeds_and_signs(base, me, n_clients,
                                               round_index)
            ts, tg = tsmk.pair_seeds_and_signs(base, me, n_clients,
                                               round_index)
            np.testing.assert_array_equal(ts.numpy(),
                                          np.asarray(js).astype(np.int64))
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("size", [1, 127, 1920, 4099])
@pytest.mark.parametrize("n_clients", [1, 3, 8])
def test_masked_quantize_reference_matches_jax(size, n_clients):
    x = _edge_values(size, size)
    for me in range(n_clients):
        js, jg = jsmk.pair_seeds_and_signs(77, me, n_clients, 2)
        want = jsmk.masked_quantize_reference(jnp.asarray(x), js, jg,
                                              scale_bits=SB, clip_abs=CLIP)
        ts, tg = tsmk.pair_seeds_and_signs(77, me, n_clients, 2)
        got = tsmk.masked_quantize_reference(torch.from_numpy(x), ts, tg,
                                             scale_bits=SB, clip_abs=CLIP)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_version_matches_the_jax_kernel_in_interpret_mode():
    """Against the Pallas kernel itself (interpret mode), at a size that
    spans two of its 512 x 128 blocks and a ragged tail, in x's shape."""
    x = _edge_values(65_536 + 1_000 + 7, 1).reshape(-1, 1)
    js, jg = jsmk.pair_seeds_and_signs(0xFFFFFFFF, 2, 5, 1)
    want = jsmk.fused_masked_quantize(jnp.asarray(x), js, jg, scale_bits=18,
                                      clip_abs=CLIP, interpret=True)
    ts, tg = tsmk.pair_seeds_and_signs(0xFFFFFFFF, 2, 5, 1)
    got = tsmk.fused_masked_quantize(torch.from_numpy(x), ts, tg,
                                     scale_bits=18, clip_abs=CLIP)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensor_takes_the_plain_version_and_masks_cancel():
    """On a CPU tensor the wrapper is the plain version (no launch), and
    the clients' masked outputs sum to their quantized values."""
    n = 8
    xs = [_edge_values(333, i) for i in range(n)]
    before = tsmk.KERNEL.launches
    masked = plain = torch.zeros(333, dtype=torch.int64)
    for i, x in enumerate(xs):
        s, g = tsmk.pair_seeds_and_signs(42, i, n)
        m = tsmk.fused_masked_quantize(torch.from_numpy(x), s, g,
                                       scale_bits=SB, clip_abs=CLIP)
        q = tm.quantize(torch.from_numpy(x), SB, clip_abs=CLIP)
        assert not torch.equal(m, q)
        masked, plain = masked + m, plain + q
    assert tsmk.KERNEL.launches == before
    assert torch.equal(tsmk.wrap_int32(masked), tsmk.wrap_int32(plain))


def test_choose_scale_bits_matches_jax():
    for n in range(1, 65):
        for clip in (1.0, 64.0, 1000.0):
            assert tm.choose_scale_bits(n, clip) == jm.choose_scale_bits(
                n, clip)
    with pytest.raises(ValueError, match="headroom"):
        tm.choose_scale_bits(2**20, 2.0**12)


def test_quantize_and_dequantize_bit_identical():
    x = _edge_values(5000, 3)
    np.testing.assert_array_equal(
        tm.quantize(torch.from_numpy(x), SB, clip_abs=CLIP).numpy(),
        np.asarray(jm.quantize(jnp.asarray(x), SB, clip_abs=CLIP)))
    # sums past 2^24 must keep their low bits; counts that are and are
    # not powers of two
    q = np.asarray([2**24 + 1, -(2**24 + 1), 2**29 + 3, 2**31 - 1, -2**31,
                    12345, 0, -1, 1], np.int32)
    q = np.concatenate([q, np.random.default_rng(0).integers(
        -2**31, 2**31, 1000).astype(np.int32)])
    for sb in (12, 18, 20):
        for count in (1, 3, 8, 10):
            got = tm.dequantize(torch.from_numpy(q), sb, count=count)
            want = jm.dequantize(jnp.asarray(q), sb, count=count)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_threefry_block_is_jax_threefry_2x32():
    rng = np.random.default_rng(0)
    for _ in range(5):
        key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        count = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(prng.threefry_2x32(jnp.asarray(key),
                                             jnp.asarray(count)))
        w0, w1 = tm.threefry2x32(int(key[0]), int(key[1]),
                                 torch.from_numpy(count[:32].astype(np.int64)),
                                 torch.from_numpy(count[32:].astype(np.int64)))
        np.testing.assert_array_equal(
            np.concatenate([w0.numpy(), w1.numpy()]).astype(np.uint32), want)


def _data(key) -> tuple[int, int]:
    return tuple(int(v) for v in jax.random.key_data(key))


def test_key_operations_match_jax():
    for seed in (0, 7, -3, 2**31 - 1):
        key = jax.random.key(seed)
        kd = _data(key)
        assert tm.key_from_seed(seed) == kd
        for d in (0, 5, -1, 2**31 - 1):
            assert tm.fold_in(kd, d) == _data(jax.random.fold_in(
                key, jnp.int32(d) if d < 0 else d))
        assert tm.split(kd, 3) == [_data(k) for k in jax.random.split(key, 3)]
        assert tm.random_bits_scalar(kd) == int(jax.random.bits(
            key, (), jnp.uint32))
        np.testing.assert_array_equal(
            tm.random_bits(kd, 100).numpy(),
            np.asarray(jax.random.bits(key, (100,), jnp.uint32)))
        for lo, hi in ((3, 1000), (-(2**31), 2**31 - 1), (-5, 5)):
            got = tm._randint_words([kd], 50, lo, hi, None)[0]
            want = jax.random.randint(key, (50,), lo, hi, jnp.int32)
            np.testing.assert_array_equal(tsmk.wrap_int32(got).numpy(),
                                          np.asarray(want))


@pytest.mark.parametrize("n_clients", [1, 3, 8])
def test_pairwise_mask_identical_per_client(n_clients):
    """Per-client threefry masks equal the JAX package's, so port and JAX
    clients can join one aggregation; summed over clients they vanish."""
    key = jax.random.key(11)
    total = torch.zeros((33, 5), dtype=torch.int64)
    for me in range(n_clients):
        for r in (0, 3):
            want = jm.pairwise_mask(key, jnp.int32(me), n_clients, (33, 5),
                                    round_index=r)
            got = tm.pairwise_mask(_data(key), me, n_clients, (33, 5),
                                   round_index=r)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        total += got
    assert not tsmk.wrap_int32(total).any()


def _jax_small_cnn_vars():
    model = jsmall_cnn(10, 3, 1)
    return model, model.init(jax.random.key(0))


def _models():
    jmodel, v = _jax_small_cnn_vars()
    tmodel = convert.load_jax(tsmall.small_cnn(10, 3, 1), v.params, v.state)
    yield "small_cnn", jmodel, v, tmodel
    jmn = jmobilenet.mobilenet_v2(1)
    vmn = jmn.init(jax.random.key(0))
    tmn = convert.load_jax(tmobilenet.mobilenet_v2(1), vmn.params, vmn.state)
    yield "mobilenet_v2", jmn, vmn, tmn


def test_selection_flags_and_packed_buffer_match_jax():
    """For the small CNN and MobileNetV2 at percent 0.1 / 0.5 / 1.0: the
    same tensors are protected, and the packed protected buffer (params
    before state, each in JAX flatten order) is JAX's, element for
    element."""
    for name, jmodel, v, tmodel in _models():
        assert tuple(tmodel.layer_names) == tuple(jmodel.layer_names), name
        tp = dict(tmodel.named_parameters())
        ts = dict(tmodel.named_buffers())
        assert tm.leaf_paths(tp) == jm.leaf_paths(v.params), name
        assert tm.leaf_paths(ts) == jm.leaf_paths(v.state), name
        for percent in (0.1, 0.5, 1.0):
            jpf, jsf = jm.first_fraction_selection_weights(
                v.params, v.state, percent, jmodel.layer_names)
            tpf, tsf = tm.first_fraction_selection_weights(
                tp, ts, percent, tmodel.layer_names)
            assert [tpf[n] for n in tm.leaf_names(tp)] == jax.tree.leaves(jpf)
            assert [tsf[n] for n in tm.leaf_names(ts)] == jax.tree.leaves(jsf)
            jleaves = jax.tree.leaves(v.params) + jax.tree.leaves(v.state)
            jflags = jax.tree.leaves(jpf) + jax.tree.leaves(jsf)
            want, _ = jm.pack_leaves([x for x, f in zip(jleaves, jflags)
                                      if f])
            names = tm.leaf_names(tp) + tm.leaf_names(ts)
            tflags = {**tpf, **tsf}
            got, meta = tm.pack_leaves([{**tp, **ts}[n].detach()
                                        for n in names if tflags[n]])
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            back = tm.unpack_leaves(got, meta)
            assert [b.shape for b in back] == [
                tuple(x.shape) for x, f in zip(jleaves, jflags) if f]
    # MobileNetV2 at 0.5 protects 131 of its 262 tensors, 192,576 elements
    assert int(262 * 0.5) == 131 and got.numel() > 0


def test_mobilenet_protected_buffer_size():
    """The size chip_smoke.py drives the kernel at for MobileNetV2."""
    tmodel = tmobilenet.mobilenet_v2(1)
    tp, ts = dict(tmodel.named_parameters()), dict(tmodel.named_buffers())
    pf, sf = tm.first_fraction_selection_weights(tp, ts, 0.5,
                                                 tmodel.layer_names)
    assert len(tp) + len(ts) == 262
    assert sum(pf.values()) + sum(sf.values()) == 131
    assert (sum(tp[n].numel() for n, f in pf.items() if f)
            + sum(ts[n].numel() for n, f in sf.items() if f)) == 192_576


def test_selection_on_a_nested_sequential_follows_layer_order():
    """Dotted layer names rank backbone layers in creation order, not
    alphabetically, as the JAX classifier does."""
    bb = tcore.Sequential([tcore.Conv2d(3, 4, 3, name="z_first"),
                           tcore.Conv2d(4, 4, 3, name="a_second")], name="bb")
    model = tcore.Classifier(bb, 4, 1)
    assert model.layer_names == ("backbone.z_first", "backbone.a_second",
                                 "head")
    sel = tm.first_fraction_selection(dict(model.named_parameters()), 0.5,
                                      model.layer_names)
    assert {n for n, f in sel.items() if f} == {
        "backbone.z_first.kernel", "backbone.z_first.bias",
        "backbone.a_second.kernel"}
    jbb = jcore.sequential([jcore.conv2d(3, 4, 3, name="z_first"),
                            jcore.conv2d(4, 4, 3, name="a_second")],
                           name="bb")
    assert jcore.classifier(jbb, 4, 1).layer_names == model.layer_names
