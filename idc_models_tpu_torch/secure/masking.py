"""Pairwise one-time-mask secure aggregation primitives.

The counterpart of ``idc_models_tpu/secure/masking.py``. Every unordered
client pair {i, j} shares a PRG seed; client i adds ``+mask_ij`` for
j > i and ``-mask_ij`` for j < i to its int32-quantized update, so each
contribution looks random to the aggregator while the masks cancel
exactly in the sum (int32 addition wraps mod 2^32).

The round's default mask PRG is threefry-2x32, implemented here in plain
torch so that a mask is bit-identical to the JAX package's
``masking.pairwise_mask`` for the same key: ``fold_in``, ``split``,
``random_bits`` and ``randint`` follow ``jax._src.prng`` and
``jax._src.random`` (JAX 0.9, ``jax_threefry_partitionable`` on, its
default). A port client and a JAX client can therefore join one
aggregation. Keys are threefry keys as a pair of 32-bit words, the
``jax.random.key_data`` of a JAX key.

Integer arithmetic: torch has almost no uint32 arithmetic, so every
32-bit word lives in an int64 tensor (or a Python int) in [0, 2^32) and
is masked with ``& U32`` after each add and shift. Additions of two words
and shifts by at most 29 bits stay far below 2^63.

Selection (`first_fraction_selection_weights`) and packing work on the
port's flat ``{dotted name: tensor}`` dicts. Their leaf order is the JAX
tree flatten order -- dict keys sorted at every level, which is the order
of the name's path tuple -- so the packed buffer, and with it every
element's mask index, is the JAX package's.
"""

from __future__ import annotations

import math
from collections.abc import Mapping, Sequence

import torch

from idc_models_tpu_torch.ops.secure_masking_kernel import U32, wrap_int32

DEFAULT_SCALE_BITS = 20  # fixed-point fractional bits
DEFAULT_CLIP_ABS = 64.0  # quantization clipping range for weights

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1

# mask_impl="auto" picks the CUDA kernel at or above this many protected
# elements. The value is the JAX package's (its auto rule), kept so that
# "auto" selects the same impl in both packages; the crossover of the
# port's own kernel on the H100 is reported in PERF.md.
MASK_PALLAS_MIN_ELEMS = 4_194_304


def choose_scale_bits(n_clients: int,
                      clip_abs: float = DEFAULT_CLIP_ABS) -> int:
    """Largest scale_bits such that the un-masked sum over `n_clients`
    values of magnitude <= clip_abs cannot overflow int32: strictly
    ``2^scale * clip_abs * n_clients <= 2^31 - 1``. Capped at
    DEFAULT_SCALE_BITS."""
    n = max(n_clients, 1)
    bits = 31 - math.ceil(math.log2(n * clip_abs))
    while bits > 0 and (2.0 ** bits) * clip_abs * n > 2**31 - 1:
        bits -= 1
    if bits < 1:
        raise ValueError(
            f"no int32 headroom for {n_clients} clients at clip {clip_abs}")
    return min(bits, DEFAULT_SCALE_BITS)


def quantize(x: torch.Tensor, scale_bits: int = DEFAULT_SCALE_BITS, *,
             clip_abs: float | None = DEFAULT_CLIP_ABS) -> torch.Tensor:
    """f32 -> int32 fixed point, clipped to +-clip_abs and rounded half to
    even (as ``jnp.round``); the product by a power of two is exact."""
    x = x.to(torch.float32)
    if clip_abs is not None:
        x = torch.clamp(x, -clip_abs, clip_abs)
    return torch.round(x * float(2.0 ** scale_bits)).to(torch.int32)


def dequantize(q: torch.Tensor, scale_bits: int = DEFAULT_SCALE_BITS, *,
               count: int | float = 1) -> torch.Tensor:
    """int32 fixed point -> f32, divided by `count` (for the mean).

    Two exact pieces, as the JAX package computes them: the integer part
    (floor division) and the fractional part are each exact in f32, so
    rounding happens only in the final add and divide. Both divisions
    take a tensor divisor: on a CUDA tensor, division by a Python scalar
    is a multiply by its reciprocal, which would round differently from
    the CPU and from XLA for a count that is not a power of two."""
    scale = 1 << scale_bits
    hi = torch.div(q, scale, rounding_mode="floor")
    lo = q - hi * scale
    f32 = dict(dtype=torch.float32, device=q.device)
    frac = lo.to(torch.float32) / torch.tensor(float(scale), **f32)
    return (hi.to(torch.float32) + frac) / torch.tensor(float(count), **f32)


# ---------------------------------------------------------------------------
# threefry-2x32 and the JAX key operations built on it
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block, 20 rounds with the Random123 rotations,
    bit-identical to ``jax._src.prng.threefry_2x32``'s primitive. Keys and
    counts are 32-bit words as Python ints or int64 tensors (broadcast
    together); returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & U32
    x1 = (x1 + k1) & U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & U32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & U32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & U32
    return x0, x1


Key = tuple[int, int]


def key_from_seed(seed: int) -> Key:
    """``jax.random.key(seed)``'s data with JAX's default 32-bit types:
    a zero high word and the seed's low 32 bits."""
    return 0, seed & U32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the block at counter (0, data mod 2^32)."""
    return threefry2x32(key[0], key[1], 0, int(data) & U32)


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split`` (partitionable): key i is the block at
    counter (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` (partitionable): the xor of
    the two words of the block at the 64-bit counter i, as int64 words.
    `key` is a pair of ints or of int64 tensors shaped to broadcast
    against [n] (one key per row)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & U32)
    return b0 ^ b1


def random_bits_scalar(key: Key) -> int:
    """``jax.random.bits(key, (), uint32)``: the block at counter 0."""
    b0, b1 = threefry2x32(key[0], key[1], 0, 0)
    return b0 ^ b1


def _randint_words(keys: Sequence[Key], n: int, minval: int, maxval: int,
                   device) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval, int32)`` for each
    key, as uint32 words in int64 [len(keys), n]: two draws (from the two
    keys of a split), the modulus-based span reduction of
    ``jax._src.random._randint`` in uint32 arithmetic, plus minval."""
    span = (maxval - minval) & U32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & U32) % span
    pairs = [split(k) for k in keys]

    def col(i, w):
        return torch.tensor([p[i][w] for p in pairs], dtype=torch.int64,
                            device=device)[:, None]

    lower = random_bits((col(1, 0), col(1, 1)), n, device)
    offset = lower % span
    if mult:   # the higher draw enters only through the multiplier; for
        # the full int32 range the multiplier is 2^32 mod span = 0
        higher = random_bits((col(0, 0), col(0, 1)), n, device)
        offset = ((higher % span) * mult + offset) & U32
    offset = offset % span
    return (offset + minval) & U32


def pair_key(base: Key, i: int, j: int) -> Key:
    """The shared PRG key of the unordered pair {i, j}:
    ``fold_in(fold_in(base, min), max)``."""
    return fold_in(fold_in(base, min(i, j)), max(i, j))


def pairwise_mask(base: Key, my_id: int, n_clients: int, shape,
                  round_index: int = 0, *, device=None) -> torch.Tensor:
    """Client `my_id`'s total mask, int32 of `shape`: the sum over peers
    j of ``sign(j - my_id) * randint(pair_key(base', my_id, j))`` with
    ``base' = fold_in(base, round_index)``, wrapping mod 2^32. Summed over
    all clients the masks are exactly zero. Bit-identical to the JAX
    package's `pairwise_mask` for the same key data."""
    shape = tuple(shape)
    n = math.prod(shape)
    base = fold_in(base, round_index)
    peers = [j for j in range(n_clients) if j != my_id]
    total = torch.zeros(n, dtype=torch.int64, device=device)
    if peers:
        words = _randint_words([pair_key(base, my_id, j) for j in peers],
                               n, INT32_MIN, INT32_MAX, device)
        signs = torch.tensor([1 if j > my_id else -1 for j in peers],
                             dtype=torch.int64, device=device)[:, None]
        total = (signs * words).sum(0)
    return wrap_int32(total).reshape(shape)


# ---------------------------------------------------------------------------
# selection and packing over {dotted name: tensor} dicts
# ---------------------------------------------------------------------------

# Keras get_weights() enumerates each layer's variables in creation order:
# kernel before bias (Conv2D/Dense), gamma(scale) -> beta(bias) -> moving
# mean -> moving var (BatchNorm).
_WITHIN_LAYER_RANK = {"kernel": 0, "depthwise_kernel": 0, "scale": 0,
                      "bias": 1, "mean": 2, "var": 3}


def leaf_paths(tree: Mapping[str, object]) -> list[tuple[str, ...]]:
    """Path tuples of a flat ``{dotted name: leaf}`` dict in JAX flatten
    order (keys sorted at every level = path tuples sorted)."""
    return sorted(tuple(k.split(".")) for k in tree)


def leaf_names(tree: Mapping[str, object]) -> list[str]:
    """The dict's keys in JAX flatten order."""
    return [".".join(p) for p in leaf_paths(tree)]


def ranked_indices(paths: list[tuple[str, ...]],
                   layer_order: tuple[str, ...] | None) -> list[int]:
    """Permutation of range(len(paths)) ranking leaf paths in model layer
    order (Keras get_weights() enumeration); identity without an order.
    A leaf takes the longest prefix of its dotted path that names a
    layer in `layer_order`."""
    if not layer_order:
        return list(range(len(paths)))
    order_index = {name: i for i, name in enumerate(layer_order)}

    def rank(path):
        li = len(layer_order)
        for k in range(len(path), 0, -1):
            hit = order_index.get(".".join(path[:k]))
            if hit is not None:
                li = hit
                break
        return (li, _WITHIN_LAYER_RANK.get(path[-1], 1), path)

    return sorted(range(len(paths)), key=lambda i: rank(paths[i]))


def first_fraction_selection_weights(params, state, percent: float,
                                     layer_order: tuple[str, ...] | None
                                     = None) -> tuple[dict, dict]:
    """The reference's partial-encryption selection: True for the first
    ``int((P + S) * percent)`` tensors of the FULL get_weights()
    enumeration -- params and BN moving statistics interleaved in model
    layer order (secure_fed_model.py:115-121). Returns ``(params_flags,
    state_flags)`` as ``{name: bool}`` dicts."""
    p_names, s_names = leaf_names(params), leaf_names(state)
    names = p_names + s_names
    paths = [tuple(n.split(".")) for n in names]
    chosen = set(ranked_indices(paths, layer_order)[:int(len(names)
                                                          * percent)])
    flags = {n: i in chosen for i, n in enumerate(names)}
    return ({n: flags[n] for n in p_names}, {n: flags[n] for n in s_names})


def first_fraction_selection(tree, percent: float,
                             layer_order: tuple[str, ...] | None = None):
    """`first_fraction_selection_weights` over params alone."""
    return first_fraction_selection_weights(tree, {}, percent,
                                            layer_order)[0]


Meta = tuple[list[int], list[tuple[int, ...]], list[torch.dtype]]


def pack_leaves(leaves: Sequence[torch.Tensor], dtype=torch.float32, *,
                lead_axes: int = 0) -> tuple[torch.Tensor, Meta]:
    """Concatenate tensors into ONE flat vector [*lead, P] (the first
    `lead_axes` axes are batch axes, e.g. the stacked clients), plus the
    split metadata that `unpack_leaves` inverts."""
    shapes = [tuple(x.shape[lead_axes:]) for x in leaves]
    sizes = [math.prod(s) for s in shapes]
    dtypes = [x.dtype for x in leaves]
    if not leaves:
        return torch.zeros((0,), dtype=dtype), (sizes, shapes, dtypes)
    lead = tuple(leaves[0].shape[:lead_axes])
    flat = torch.cat([x.reshape(lead + (-1,)).to(dtype) for x in leaves],
                     dim=lead_axes)
    return flat, (sizes, shapes, dtypes)


def unpack_leaves(flat: torch.Tensor, meta: Meta) -> list[torch.Tensor]:
    sizes, shapes, dtypes = meta
    out, off = [], 0
    for size, shape, dt in zip(sizes, shapes, dtypes):
        out.append(flat[off:off + size].reshape(shape).to(dt))
        off += size
    return out
