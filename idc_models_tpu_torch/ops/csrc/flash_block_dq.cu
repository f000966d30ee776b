// Blockwise flash backward, dq half: one visiting K/V block's share of dq.
//
// Replaces the TPU kernel idc_models_tpu/ops/flash_block_kernel.py:182
// `_dq_kernel` (`make_flash_block_grads`): for each batch b, head h and
// query row r of q/dout [B,Tq,H,D] against k/v [B,Tk,H,D], given the
// whole sequence's per-row logsumexp L and D = rowsum(dout * out)
// ([B,H,Tq], f32),
//
//   s_c  = (q_r . k_c) * scale, or -1e30 where causal and
//          offsets[0] + r < offsets[1] + c
//   p_c  = e^(s_c - L_r)            (masked entries exactly 0)
//   ds_c = p_c * (dout_r . v_c - D_r) * scale
//   dq_r = sum_c ds_c k_c           (f32, written once)
//
// q/k/v/dout are f32 or bf16 in memory and f32 in all arithmetic.
//
// Bound on an H100: operations. The pass does three products per
// (query, key) pair -- s, dout.v and ds.k -- 6*D flops each, so at the
// main path's shape (B=1, T=16384, H=8, D=64) 8.2e11 flops on f32 FMA
// units (67 TFLOP/s: ~12 ms, half that counting only causally visible
// pairs) against ~40 MB of q/k/v/dout/dq.
//
// Design: one 256-thread block per (64-row query tile, head, batch).
// The q and dout tiles and the rows' L and D stay in shared memory and
// registers; a loop inside the block walks the keys in chunks of 64
// (the TPU kernel's innermost grid axis), staging K and V as f32 rows
// padded to D+4 floats. Each thread owns a 4x4 piece of the 64x64
// score tile, computes s and dout.v in one pass over D, forms ds in
// registers, and writes it transposed to shared memory so ds.k reads
// 16-byte vectors. dq stays in registers across all chunks and is
// written once. Nothing [Tq, Tk]-shaped reaches device memory.
//
// What this simple design leaves on the table, for a later PR: f32 FMA
// on the CUDA cores (no wgmma), synchronous chunk loads (no TMA or
// cp.async), no skipping of fully masked causal tiles, and s/p
// recomputed here and again in the dk/dv pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kCols = 64;      // keys per chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 4x4 scores each
constexpr int kLdP = kRows + 4;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 64 rows of D elements (global row r at src + r * stride) into
// dst[r * (D + 4) + d] as f32
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t stride) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < 64 * kVec; i += kThreads) {
    const int r = i / kVec, d = (i % kVec) * 4;
    *reinterpret_cast<float4*>(dst + r * (D + 4) + d) =
        load4(src + r * stride + d);
  }
}

// the output column of a thread's c-th accumulator entry: 16-byte groups
// for D >= 64, else D/16 consecutive columns
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D >= 64) return (c / 4) * 64 + tx * 4 + (c % 4);
  else return tx * (D / 16) + c;
}

// s[i][j] = sum_d a[(ty*4+i)][d] * b[(tx+16j)][d]
template <int D>
__device__ __forceinline__ void dot_tile(float s[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = load4(a + (ty * 4 + i) * (D + 4) + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = load4(b + (tx + 16 * j) * (D + 4) + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(x[i].x, y[j].x, t);
        t = fmaf(x[i].y, y[j].y, t);
        t = fmaf(x[i].z, y[j].z, t);
        t = fmaf(x[i].w, y[j].w, t);
        s[i][j] = t;
      }
  }
}

// out[i][c] += sum_r pt[r][ty*4+i] * v[r][out_col(c)], r over 64 rows
template <int D>
__device__ __forceinline__ void outer_acc(float out[4][D / 16],
                                          const float* pt, const float* v,
                                          int ty, int tx) {
  constexpr int kNc = D / 16;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const float4 p = load4(pt + r * kLdP + ty * 4);
    float w[kNc];
    if constexpr (D >= 64) {
#pragma unroll
      for (int g = 0; g < kNc / 4; ++g) {
        const float4 t = load4(v + r * (D + 4) + g * 64 + tx * 4);
        w[g * 4] = t.x; w[g * 4 + 1] = t.y; w[g * 4 + 2] = t.z; w[g * 4 + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kNc; ++c) w[c] = v[r * (D + 4) + out_col<D>(tx, c)];
    }
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kNc; ++c) out[i][c] = fmaf(pv[i], w[c], out[i][c]);
  }
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((2 * kRows + 2 * kCols) * (D + 4) + kCols * kLdP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_block_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ offsets, float* __restrict__ dq,
                      int t_q, int t_k, int heads, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kRows * (D + 4);
  float* ks = dos + kRows * (D + 4);
  float* vs = ks + kCols * (D + 4);
  float* dst = vs + kCols * (D + 4);
  constexpr int kNc = D / 16;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t stride = (int64_t)heads * D;
  const int64_t q_base = ((int64_t)b * t_q + q0) * stride + (int64_t)h * D;
  const int64_t kv_base = (int64_t)b * t_k * stride + (int64_t)h * D;
  const int64_t row_base = ((int64_t)b * heads + h) * t_q + q0;
  const int q_pos0 = offsets[0] + q0 + ty * 4;
  const int k_off = offsets[1];

  load_rows<T, D>(qs, q + q_base, stride);
  load_rows<T, D>(dos, dout + q_base, stride);
  float row_l[4], row_d[4], acc[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_l[i] = lse[row_base + ty * 4 + i];
    row_d[i] = delta[row_base + ty * 4 + i];
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < t_k; k0 += kCols) {
    __syncthreads();  // the previous chunk's readers are done
    load_rows<T, D>(ks, k + kv_base + k0 * stride, stride);
    load_rows<T, D>(vs, v + kv_base + k0 * stride, stride);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<D>(s, qs, ks, ty, tx);
    dot_tile<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (causal && q_pos0 + i < k_off + k0 + tx + 16 * j) x = kMasked;
        const float p = expf(x - row_l[i]);
        s[i][j] = p * (dp[i][j] - row_d[i]) * scale;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + (tx + 16 * j) * kLdP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    outer_acc<D>(acc, dst, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kNc; ++c)
      dq[q_base + (ty * 4 + i) * stride + out_col<D>(tx, c)] = acc[i][c];
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* offsets, float* dq, int batch, int t_q,
                   int t_k, int heads, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_block_dq_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(t_q / kRows, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      offsets, dq, t_q, t_k, heads, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* offsets, float* dq, int batch, int t_q,
                     int t_k, int heads, float scale, int causal,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, offsets, dq, batch, t_q, t_k, heads, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, offsets, dq, batch, t_q, t_k, heads, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, offsets, dq, batch, t_q, t_k, heads, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, offsets, dq, batch, t_q, t_k, heads, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32 q/k/v/dout, 1: bfloat16. Tq and Tk must be multiples
// of 64 (the wrapper asks for 128, as the TPU kernel does), D one of 16,
// 32, 64, 128, every tensor contiguous and 16-byte aligned. Returns the
// launch's cudaError_t.
int flash_block_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* offsets, float* dq, int dtype, int batch,
                   int t_q, int t_k, int heads, int d, float scale,
                   int causal, void* stream) {
  if (t_q % kRows || t_k % kCols) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(d, q, k, v, dout, lse, delta, offsets, dq, batch, t_q, t_k, heads, scale, causal, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, offsets, dq, batch, t_q, t_k, heads, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_block_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
