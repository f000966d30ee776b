"""Fused clip + quantize + pairwise mask for secure aggregation: a
hand-written CUDA kernel (``csrc/secure_masking.cu``) and its plain
PyTorch version.

The counterpart of ``idc_models_tpu/ops/secure_masking_kernel.py``. The
hot op of a secure FedAvg round boundary is, for the packed protected
buffer of one client: clip to +-clip_abs -> fixed-point quantize to int32
-> add the client's pairwise mask streams. The kernel does the chain in
one pass: x is read once, every mask stream is generated in registers
from a counter-based hash PRG (two rounds of the murmur3 finalizer over
the global element index), and the masked int32 is written once.

The PRG is an explicit integer hash so that the stream is a pure
function of (pair seed, element index): both endpoints of a pair, and
any backend that joins the aggregation (the JAX package's Pallas kernel
and its jnp reference, this kernel, the plain version here), compute
bit-identical masks. Signs are antisymmetric per pair and addition
wraps mod 2^32, so the masks cancel exactly in the sum over clients.

Integer arithmetic: torch has almost no uint32 arithmetic, so the plain
version holds every 32-bit word in an int64 tensor in [0, 2^32) and
masks with ``& 0xFFFFFFFF`` after each add, xor-shift and multiply. A
multiply is split into 16-bit halves (``_mul32``), so no product
overflows int64 and the kept low 32 bits are exact. The same helpers
work on Python ints, which the scalar seed derivation uses.

Dispatch is by where the tensor lies: a CPU tensor runs the plain
version (``masked_quantize_reference``); a CUDA tensor launches the
kernel or raises. Each launch adds one to ``KERNEL.launches``.

The hash PRG is not cryptographic (see secure/fedavg.py's threat-model
note); the round's default mask PRG stays threefry.
"""

from __future__ import annotations

import ctypes

import torch

from idc_models_tpu_torch.ops.build import CudaKernel

U32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_float)
    lib.secure_masked_quantize.argtypes = [ptr, ptr, i64, ptr, ptr, i32,
                                           f32, f32, ptr]
    lib.secure_masked_quantize.restype = i32
    lib.secure_masked_quantize_error_string.argtypes = [i32]
    lib.secure_masked_quantize_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("secure_masking.cu", _declare)


def _mul32(a, c: int):
    """``a * c mod 2^32`` for a 32-bit word `a` (Python int or int64
    tensor in [0, 2^32)) and a 32-bit constant, with no intermediate
    above 2^49."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & U32


def fmix32(h):
    """murmur3 finalizer, a full-avalanche 32-bit mixer (public-domain
    constants), on 32-bit words held as Python ints or int64 tensors."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def mask_stream(seed, idx):
    """The pairwise PRG: ``fmix32(fmix32(seed ^ idx*GOLDEN))`` as 32-bit
    words."""
    return fmix32(fmix32(seed ^ _mul32(idx, GOLDEN)))


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2^32 to the int32 of the same bits
    (two's complement), without relying on an out-of-range cast."""
    v = v & U32
    return (v - ((v >> 31) << 32)).to(torch.int32)


def pair_seeds_and_signs(base_seed, my_id: int, n_clients: int,
                         round_index: int = 0, *, device=None):
    """Per-peer (seeds [n] int64 holding uint32 values, signs [n] int32)
    for client `my_id`, bit-identical to the JAX package's.

    seeds[j] is a pure function of (base_seed, round, {min(i,j),
    max(i,j)}), so both endpoints derive the same stream; signs[j] =
    sign(j - i) gives the antisymmetric cancellation."""
    js = torch.arange(n_clients, dtype=torch.int64)
    lo = torch.clamp(js, max=my_id)
    hi = torch.clamp(js, min=my_id)
    base = (int(base_seed) + _mul32(int(round_index) & U32, GOLDEN)) & U32
    seeds = fmix32(fmix32(base ^ _mul32(lo, GOLDEN))
                   ^ _mul32(hi, 0x85EBCA77))
    signs = torch.sign(js - my_id).to(torch.int32)
    return seeds.to(device), signs.to(device)


def quantize_f32(flat: torch.Tensor, scale_bits: int,
                 clip_abs: float) -> torch.Tensor:
    """``round(clip(x) * 2^scale_bits)`` to int32, half to even (as
    ``jnp.round``); the product by a power of two is exact in f32."""
    x = torch.clamp(flat.to(torch.float32), -clip_abs, clip_abs)
    return torch.round(x * float(2.0 ** scale_bits)).to(torch.int32)


def masked_quantize_reference(x: torch.Tensor, seeds: torch.Tensor,
                              signs: torch.Tensor, *, scale_bits: int,
                              clip_abs: float) -> torch.Tensor:
    """The plain version: bit-identical to the kernel and to the JAX
    package's ``masked_quantize_reference`` for finite inputs (the
    cross-backend contract: any participant computing this joins the
    same aggregation). int32, x's shape."""
    flat = x.reshape(-1)
    acc = quantize_f32(flat, scale_bits, clip_abs).to(torch.int64)
    h = _mul32(torch.arange(flat.numel(), dtype=torch.int64,
                            device=x.device) & U32, GOLDEN)
    for seed, sign in zip(seeds.tolist(), signs.tolist()):
        if sign:
            acc = acc + int(sign) * fmix32(fmix32((int(seed) & U32) ^ h))
    return wrap_int32(acc).reshape(x.shape)


def _launch(x, seeds, signs, scale_bits, clip_abs):
    """Run the kernel on a CUDA tensor. Checks what the kernel takes and
    raises on anything else; the output comes from torch.empty and the
    launch goes on the current stream."""
    if x.device.type != "cuda":
        raise ValueError(f"the secure masking kernel needs x on a CUDA "
                         f"device, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the secure masking kernel takes float32 x (the "
                        f"packed protected buffer), got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the secure masking kernel needs a contiguous x")
    if seeds.dim() != 1 or signs.shape != seeds.shape:
        raise ValueError(f"seeds and signs must be two [n] vectors, got "
                         f"{tuple(seeds.shape)} and {tuple(signs.shape)}")
    seeds_u32 = wrap_int32(seeds.to(x.device, torch.int64))
    signs_i32 = signs.to(x.device, torch.int32)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    lib = KERNEL.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.secure_masked_quantize(
            x.data_ptr(), out.data_ptr(), x.numel(), seeds_u32.data_ptr(),
            signs_i32.data_ptr(), seeds.numel(), float(2.0 ** scale_bits),
            float(clip_abs), stream)
    if err != 0:
        msg = lib.secure_masked_quantize_error_string(err).decode()
        raise RuntimeError(f"secure masking kernel launch failed: {msg}")
    KERNEL.launches += 1
    return out


def fused_masked_quantize(x: torch.Tensor, seeds: torch.Tensor,
                          signs: torch.Tensor, *, scale_bits: int,
                          clip_abs: float) -> torch.Tensor:
    """Quantize `x` (any shape, f32) to int32 fixed point and add this
    client's total pairwise mask, in one pass: the kernel for a CUDA
    tensor, the plain version for a CPU one.

    `seeds`/`signs` come from `pair_seeds_and_signs`. The mask index is
    the flat index of x, so every client must pack identical buffers (they
    do: model replicas). Parity with the JAX package holds for finite
    inputs; the round never quantizes a non-finite value
    (``recover_nonfinite``), and the kernel need not match XLA on NaN."""
    if x.device.type == "cpu":
        return masked_quantize_reference(x, seeds, signs,
                                         scale_bits=scale_bits,
                                         clip_abs=clip_abs)
    return _launch(x, seeds, signs, scale_bits, clip_abs)
