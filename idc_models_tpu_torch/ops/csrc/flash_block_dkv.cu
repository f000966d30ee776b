// Blockwise flash backward, dk/dv half: one visiting K/V block's dk, dv.
//
// Replaces the TPU kernel idc_models_tpu/ops/flash_block_kernel.py:216
// `_dkv_kernel` (`make_flash_block_grads`): for each batch b, head h and
// key row c of k/v [B,Tk,H,D] against q/dout [B,Tq,H,D], given the
// whole sequence's per-row logsumexp L and D = rowsum(dout * out)
// ([B,H,Tq], f32),
//
//   s_r  = (q_r . k_c) * scale, or -1e30 where causal and
//          offsets[0] + r < offsets[1] + c
//   p_r  = e^(s_r - L_r)            (masked entries exactly 0)
//   ds_r = p_r * (dout_r . v_c - D_r) * scale
//   dv_c = sum_r p_r dout_r,  dk_c = sum_r ds_r q_r   (f32, written once)
//
// q/k/v/dout are f32 or bf16 in memory and f32 in all arithmetic. Each
// block owns its key rows outright, so the sums need no atomics and the
// result does not depend on scheduling.
//
// Bound on an H100: operations. The pass does four products per
// (query, key) pair -- s, dout.v, p.dout and ds.q -- 8*D flops each, so
// at the main path's shape (B=1, T=16384, H=8, D=64) 1.1e12 flops on
// f32 FMA units (67 TFLOP/s: ~16 ms, half that counting only causally
// visible pairs) against ~48 MB of q/k/v/dout/dk/dv.
//
// Design: one 256-thread block per (64-key chunk, head, batch). The
// chunk's K and V stay in shared memory as f32 rows padded to D+4
// floats; a loop inside the block walks the queries in tiles of 64 (the
// TPU kernel's innermost grid axis), staging q, dout, L and D. Each
// thread owns a 4x4 piece of the transposed 64x64 score tile (keys
// ty*4+i, queries tx+16j), computes s and dout.v in one pass over D,
// forms p and ds in registers, and writes both to shared memory so the
// p.dout and ds.q products read 16-byte vectors. dk and dv stay in
// registers across all query tiles and are written once.
//
// What this simple design leaves on the table, for a later PR: f32 FMA
// on the CUDA cores (no wgmma), synchronous tile loads (no TMA or
// cp.async), no skipping of fully masked causal tiles, and s/p
// recomputed here and again in the dq pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows per tile
constexpr int kCols = 64;      // keys per block
constexpr int kThreads = 256;  // 16 x 16 threads, 4x4 scores each
constexpr int kLdP = kCols + 4;
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
  return sizeof(float) *
         ((2 * kRows + 2 * kCols) * (D + 4) + 2 * kRows * kLdP + 2 * kRows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_block_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ offsets,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int t_q, int t_k, int heads, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kCols * (D + 4);
  float* qs = vs + kCols * (D + 4);
  float* dos = qs + kRows * (D + 4);
  float* ps = dos + kRows * (D + 4);
  float* dss = ps + kRows * kLdP;
  float* ls = dss + kRows * kLdP;
  float* ds_row = ls + kRows;
  constexpr int kNc = D / 16;

  const int c0 = blockIdx.x * kCols, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t stride = (int64_t)heads * D;
  const int64_t k_base = ((int64_t)b * t_k + c0) * stride + (int64_t)h * D;
  const int64_t q_base = (int64_t)b * t_q * stride + (int64_t)h * D;
  const int64_t row_base = ((int64_t)b * heads + h) * t_q;
  const int k_pos0 = offsets[1] + c0 + ty * 4;
  const int q_off = offsets[0];

  load_rows<T, D>(ks, k + k_base, stride);
  load_rows<T, D>(vs, v + k_base, stride);
  float acc_k[4][kNc], acc_v[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < t_q; q0 += kRows) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(qs, q + q_base + q0 * stride, stride);
    load_rows<T, D>(dos, dout + q_base + q0 * stride, stride);
    if (threadIdx.x < kRows) {
      ls[threadIdx.x] = lse[row_base + q0 + threadIdx.x];
      ds_row[threadIdx.x] = delta[row_base + q0 + threadIdx.x];
    }
    __syncthreads();

    // transposed tiles: entry [i][j] is key ty*4+i against query tx+16j
    float s[4][4], dp[4][4];
    dot_tile<D>(s, ks, qs, ty, tx);
    dot_tile<D>(dp, vs, dos, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j;
      const float lr = ls[r], dr = ds_row[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[i][j] * scale;
        if (causal && q_off + q0 + r < k_pos0 + i) x = kMasked;
        const float p = expf(x - lr);
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dr) * scale;
      }
      *reinterpret_cast<float4*>(ps + r * kLdP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dss + r * kLdP + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();
    outer_acc<D>(acc_v, ps, dos, ty, tx);
    outer_acc<D>(acc_k, dss, qs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      const int64_t at = k_base + (ty * 4 + i) * stride + out_col<D>(tx, c);
      dk[at] = acc_k[i][c];
      dv[at] = acc_v[i][c];
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* offsets, float* dk, float* dv, int batch,
                   int t_q, int t_k, int heads, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_block_dkv_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(t_k / kCols, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      offsets, dk, dv, t_q, t_k, heads, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* offsets, float* dk, float* dv, int batch,
                     int t_q, int t_k, int heads, float scale, int causal,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, offsets, dk, dv, batch, t_q, t_k, heads, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, offsets, dk, dv, batch, t_q, t_k, heads, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, offsets, dk, dv, batch, t_q, t_k, heads, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, offsets, dk, dv, batch, t_q, t_k, heads, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32 q/k/v/dout, 1: bfloat16. Tq and Tk must be multiples
// of 64 (the wrapper asks for 128, as the TPU kernel does), D one of 16,
// 32, 64, 128, every tensor contiguous and 16-byte aligned. Returns the
// launch's cudaError_t.
int flash_block_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const int* offsets, float* dk, float* dv, int dtype,
                    int batch, int t_q, int t_k, int heads, int d,
                    float scale, int causal, void* stream) {
  if (t_q % kRows || t_k % kCols) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(d, q, k, v, dout, lse, delta, offsets, dk, dv, batch, t_q, t_k, heads, scale, causal, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, offsets, dk, dv, batch, t_q, t_k, heads, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_block_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
