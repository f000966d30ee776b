// One online-softmax fold of a visiting K/V block into a given carry.
//
// Replaces the TPU kernel idc_models_tpu/ops/flash_block_kernel.py:87
// `_kernel` (`_pallas_impl`, `make_flash_block_update`): for each batch
// b, head h and query row r of q [B,Tq,H,D] against k/v [B,Tk,H,D],
//
//   s_c   = (q_r . k_c) * scale, or _MASKED = -1e30 where causal and
//           offsets[0] + r < offsets[1] + c
//   m'    = max(m, max_c s_c)
//   l'    = l * e^(m - m') + sum_c e^(s_c - m')
//   acc'  = acc * e^(m - m') + sum_c e^(s_c - m') v_c
//
// from the carry (m, l [B,H,Tq], acc [B,Tq,H,D], all f32) that the ring
// passes in -- it is NOT zero after the first ring step. q/k/v are f32
// or bf16 in memory and f32 in all arithmetic. The sentinel is finite,
// not -inf: a row whose first folded block is fully masked gets
// p = e^0 = 1 "garbage" that the next visible block cancels exactly
// (its correction factor is e^(-1e30 - m') = 0), as in the TPU kernel.
// Masked tiles are computed, not skipped, so the raw (m, l) of fully
// masked rows equal the plain version's.
//
// Bound on an H100: operations. At the main path's shape (B=1,
// T=16384, H=8, D=64) one fold is 4*T^2*D*H = 5.5e11 flops on f32 FMA
// units (67 TFLOP/s: ~8.2 ms) against ~50 MB of q/k/v/carry (~0.015 ms
// at 3.35 TB/s); counting only the causally visible pairs halves the
// flops.
//
// Design: one 256-thread block per (64-row query tile, head, batch).
// The query tile is staged once in shared memory as f32; a loop inside
// the block walks the keys in chunks of 64, staging each K/V chunk as
// f32 rows padded to D+4 floats (16-byte loads, no bank conflicts).
// Each thread owns a 4x4 piece of the 64x64 score tile (rows ty*4+i,
// columns tx+16j), reduces row max and sum across the 16 threads of a
// row with warp shuffles, and writes e^(s-m') transposed to shared
// memory so the P.V product reads 16-byte vectors of P and V. The
// carry lives in registers from the first chunk to the last and is
// written once. expf, not __expf; no fast-math.
//
// What this simple design leaves on the table, for a later PR: the
// products run as f32 FMA on the CUDA cores (no wgmma on the tensor
// cores, even for bf16 inputs), chunks are loaded synchronously (no TMA,
// no cp.async double buffering), and fully masked causal tiles are
// computed rather than skipped.

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
  return sizeof(float) * ((kRows + 2 * kCols) * (D + 4) + kCols * kLdP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_block_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       const float* __restrict__ acc_in,
                       const int* __restrict__ offsets,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       float* __restrict__ acc_out, int t_q, int t_k, int heads,
                       float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kRows * (D + 4);
  float* vs = ks + kCols * (D + 4);
  float* pt = vs + kCols * (D + 4);
  constexpr int kNc = D / 16;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t stride = (int64_t)heads * D;
  const int64_t q_base = ((int64_t)b * t_q + q0) * stride + (int64_t)h * D;
  const int64_t kv_base = (int64_t)b * t_k * stride + (int64_t)h * D;
  const int64_t ml_base = ((int64_t)b * heads + h) * t_q + q0;
  const int q_pos0 = offsets[0] + q0 + ty * 4;
  const int k_off = offsets[1];

  load_rows<T, D>(qs, q + q_base, stride);

  float m[4], l[4], acc[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = m_in[ml_base + ty * 4 + i];
    l[i] = l_in[ml_base + ty * 4 + i];
#pragma unroll
    for (int c = 0; c < kNc; ++c)
      acc[i][c] = acc_in[q_base + (ty * 4 + i) * stride + out_col<D>(tx, c)];
  }

  for (int k0 = 0; k0 < t_k; k0 += kCols) {
    __syncthreads();  // the previous chunk's readers are done
    load_rows<T, D>(ks, k + kv_base + k0 * stride, stride);
    load_rows<T, D>(vs, v + kv_base + k0 * stride, stride);
    __syncthreads();

    float s[4][4];
    dot_tile<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (causal && q_pos0 + i < k_off + k0 + tx + 16 * j) x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNc; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * kLdP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    outer_acc<D>(acc, pt, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (tx == 0) {
      m_out[ml_base + ty * 4 + i] = m[i];
      l_out[ml_base + ty * 4 + i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < kNc; ++c)
      acc_out[q_base + (ty * 4 + i) * stride + out_col<D>(tx, c)] = acc[i][c];
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* m, const float* l, const float* acc,
                   const int* offsets, float* om, float* ol, float* oacc,
                   int batch, int t_q, int t_k, int heads, float scale,
                   int causal, cudaStream_t stream) {
  auto kernel = flash_block_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(t_q / kRows, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), m, l, acc, offsets, om, ol, oacc, t_q, t_k,
      heads, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     const float* m, const float* l, const float* acc,
                     const int* offsets, float* om, float* ol, float* oacc,
                     int batch, int t_q, int t_k, int heads, float scale,
                     int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, m, l, acc, offsets, om, ol, oacc, batch, t_q, t_k, heads, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, m, l, acc, offsets, om, ol, oacc, batch, t_q, t_k, heads, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, m, l, acc, offsets, om, ol, oacc, batch, t_q, t_k, heads, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, m, l, acc, offsets, om, ol, oacc, batch, t_q, t_k, heads, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32 q/k/v, 1: bfloat16. Tq and Tk must be multiples of 64
// (the wrapper asks for 128, as the TPU kernel does), D one of 16, 32,
// 64, 128, every tensor contiguous and 16-byte aligned. Returns the
// launch's cudaError_t.
int flash_block_fwd(const void* q, const void* k, const void* v,
                    const float* m, const float* l, const float* acc,
                    const int* offsets, float* om, float* ol, float* oacc,
                    int dtype, int batch, int t_q, int t_k, int heads, int d,
                    float scale, int causal, void* stream) {
  if (t_q % kRows || t_k % kCols) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(d, q, k, v, m, l, acc, offsets, om, ol, oacc, batch, t_q, t_k, heads, scale, causal, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, m, l, acc, offsets, om, ol, oacc, batch, t_q, t_k, heads, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_block_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
