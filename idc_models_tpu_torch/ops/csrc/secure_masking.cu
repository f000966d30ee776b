// Fused clip + fixed-point quantize + pairwise mask, for secure aggregation.
//
// Replaces the TPU kernel idc_models_tpu/ops/secure_masking_kernel.py
// `_kernel` (`fused_masked_quantize`): for every element i of the flat
// protected buffer x (f32),
//
//   out[i] = round_half_even(clip(x[i], +-clip_abs) * 2^scale_bits)
//            + sum_j sign_j * bitcast_i32(fmix32(fmix32(seed_j ^ i*GOLDEN)))
//
// in int32, wrapping mod 2^32, where i is the unpadded global flat index
// as a uint32 and fmix32 is the murmur3 finalizer. seeds/signs come from
// ops/secure_masking_kernel.py::pair_seeds_and_signs; sign 0 (the client
// itself) adds nothing, so that peer is skipped.
//
// Bound on an H100: integer operations, not bytes. Each element moves 8
// bytes (f32 in, int32 out) but costs 18 operations per peer (the seed
// xor, two fmix32 of 3 shift/xor pairs and 2 multiplies each, the signed
// add as one multiply-add) plus 5 (the clip's min and max, the scale,
// one round-and-convert, the index product). At 8 clients (7 peers)
// that is 131 operations against 8 bytes, while the card issues at most
// 128 lanes of instructions per SM per clock (132 SMs, ~1.98 GHz:
// ~33 T/s) against 3.35 TB/s -- so at 14.7M elements the operation
// bound (~0.058 ms) is ~1.6x the byte bound (~0.035 ms).
//
// What the design does about the bound: x is read once and the int32 is
// written once (16-byte vector loads and stores where aligned), with
// every mask stream generated in registers -- no mask tensor ever
// reaches memory, where the plain threefry path writes one per peer.
// The per-element index product is computed once and reused by every
// peer; each thread carries 4 consecutive elements so 4 independent
// hash chains hide the multiply latency; the peer loop is uniform across
// the grid (same seed and sign for every thread), so it neither diverges
// nor needs shared memory; a grid-stride loop over one wave of resident
// blocks covers a 33.5M-element buffer without a huge grid. All
// arithmetic is uint32, which wraps by definition, so the result equals
// the plain PyTorch version (masked_quantize_reference) bit for bit.
// There is no tiling and no padding: the TPU kernel padded to (8, 128)
// blocks only for its layout, and its mask index was the unpadded flat
// index either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B1u;
constexpr int kPerThread = 4;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// clip, then round(x * 2^scale_bits) half to even, as jnp.round: the
// product by a power of two is exact, so the rounding alone decides
__device__ __forceinline__ uint32_t quantize(float v, float scale,
                                             float clip_abs) {
  v = v < -clip_abs ? -clip_abs : v;
  v = v > clip_abs ? clip_abs : v;
  return (uint32_t)__float2int_rn(__fmul_rn(v, scale));
}

__global__ void __launch_bounds__(kThreads)
secure_masked_quantize_kernel(const float* __restrict__ x,
                              int32_t* __restrict__ out, int64_t n,
                              const uint32_t* __restrict__ seeds,
                              const int32_t* __restrict__ signs,
                              int n_clients, float scale, float clip_abs,
                              int vectorized) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * kPerThread;
  for (int64_t base =
           ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kPerThread;
       base < n; base += stride) {
    const bool full = vectorized && base + kPerThread <= n;
    float v[kPerThread];
    if (full) {
      const float4 f = *reinterpret_cast<const float4*>(x + base);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        v[k] = base + k < n ? x[base + k] : 0.0f;
    }
    uint32_t acc[kPerThread], h[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      acc[k] = quantize(v[k], scale, clip_abs);
      h[k] = (uint32_t)(base + k) * kGolden;  // the index wraps as a uint32
    }
    for (int j = 0; j < n_clients; ++j) {
      const int32_t sign = signs[j];
      if (sign == 0) continue;
      const uint32_t seed = seeds[j];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        acc[k] += (uint32_t)sign * fmix32(fmix32(seed ^ h[k]));
    }
    if (full) {
      *reinterpret_cast<int4*>(out + base) =
          make_int4((int32_t)acc[0], (int32_t)acc[1], (int32_t)acc[2],
                    (int32_t)acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        if (base + k < n) out[base + k] = (int32_t)acc[k];
    }
  }
}

}  // namespace

extern "C" {

// x: n contiguous f32; out: n int32; seeds/signs: n_clients uint32 /
// int32, all on the current device. Launches on `stream` and returns
// cudaGetLastError().
int secure_masked_quantize(const void* x, void* out, int64_t n,
                           const void* seeds, const void* signs,
                           int n_clients, float scale, float clip_abs,
                           void* stream) {
  if (n <= 0) return 0;
  if (n_clients < 0) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // one wave of resident blocks (2048 threads per SM), then grid-stride
  const int64_t per_block = (int64_t)kThreads * kPerThread;
  int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t wave = (int64_t)sms * (2048 / kThreads);
  if (blocks > wave) blocks = wave;
  const int vectorized =
      (((uintptr_t)x | (uintptr_t)out) % sizeof(float4)) == 0;
  secure_masked_quantize_kernel<<<(unsigned)blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int32_t*>(out), n,
      static_cast<const uint32_t*>(seeds), static_cast<const int32_t*>(signs),
      n_clients, scale, clip_abs, vectorized);
  return (int)cudaGetLastError();
}

const char* secure_masked_quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
