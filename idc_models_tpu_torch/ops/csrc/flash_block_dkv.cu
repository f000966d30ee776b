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
// q/k/v/dout are f32 or bf16; p and ds are f32, as in the TPU kernel.
// Each block owns its key rows outright, so the sums need no atomics and
// the result does not depend on scheduling.
//
// Bound on an H100: operations. Four products per visible (query, key)
// pair -- s, dout.v, p.dout and ds.q -- 8*D flops, so at the main path's
// shape (B=1, T=16384, H=8, D=64, causal) 5.50e11 flops against ~48 MB
// of q/k/v/dout/L/D/dk/dv: 1.11 ms at the TF32 tensor-core peak (495
// TFLOP/s) for f32 inputs, 0.56 ms at the bf16 peak (989) for bf16. The
// design's own ceiling is higher: 3xTF32 runs 3 passes of every product
// (3.33 ms), bf16 runs s and dout.v once and p.dout and ds.q twice, hi
// and lo (0.83 ms); and `mma.sync` reaches only part of the peak that
// `wgmma` can.
//
// Design (flash_mma.cuh has the products):
// - Causal tile skipping. The block of key chunk [k0, k0+64) starts at
//   the first query tile that holds a visible pair: the rule of
//   ops/flash_block_kernel.py `causal_chunk_span` (flash_mma.cuh
//   `first_visible_tile`), from the offsets read on the device, so one
//   launch serves every ring step. Each warp walks a tile in steps of 32
//   queries (16 at D=128), skips a step wholly before its 16 keys, and
//   applies the element mask only to steps that start before its last
//   key. The first chunks see the most queries, and the grid runs them
//   first.
// - Tensor cores through mma.sync: one 128-thread block per (64-key
//   chunk, head, batch), a warp per 16 keys. The score tile is computed
//   transposed, s^T = k.q^T with keys as rows, so p^T and ds^T come out
//   as accumulator fragments and feed p^T.dout and ds^T.q as their A
//   fragments straight from registers. f32 runs 3xTF32, bf16 runs
//   m16n8k16 with p and ds split into bf16 hi + lo.
// - cp.async double buffering: the K and V chunk is staged once; q and
//   dout tiles (64 queries, 32 at D=128) with their L and D alternate
//   between two buffers, the next tile in flight while this one is
//   computed. bf16 stays bf16 in shared memory.
// - dk and dv stay in registers across all query tiles and are written
//   once.
// - Accuracy: each product's mma steps sum into zeroed fragments that f32
//   adds carry into s, dk and dv (flash_mma.cuh says why); the error
//   against the plain version is about 1e-6 of the largest gradient.
// - Registers: 128-thread blocks launched with a bound of two an SM, so
//   ptxas may use up to 255 a thread, and the tile is walked in steps
//   that keep the score fragments small: no spills at any D (at D=128 the
//   two 16x128 accumulators alone take 128 registers a thread).
//
// What it leaves, for a later PR: wgmma with TMA and warp specialisation,
// and dq fused into this pass (s/p are computed here and again there).

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

template <typename T, int D>
struct Tiles {
  static constexpr int kCols = 16 * kWarps;          // keys a block
  static constexpr int kRows = D <= 64 ? 64 : 32;    // queries a tile
  static constexpr int kStep = D <= 64 ? 32 : 16;    // queries a warp's step
  static constexpr int kLd = ld<T, D>();
  static constexpr size_t kSmem =
      sizeof(T) * kLd * (2 * kCols + 4 * kRows) + sizeof(float) * 4 * kRows;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_block_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ offsets,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int t_q, int t_k, int heads, float scale, int causal) {
  constexpr int R = Tiles<T, D>::kRows, C = Tiles<T, D>::kCols;
  constexpr int W = Tiles<T, D>::kStep, LD = Tiles<T, D>::kLd, NT = W / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + C * LD;
  T* qs = vs + C * LD;          // two buffers of R rows
  T* dos = qs + 2 * R * LD;     // two buffers of R rows
  float* ls = reinterpret_cast<float*>(dos + 2 * R * LD);  // two of R
  float* ds_row = ls + 2 * R;                              // two of R

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int k0 = blockIdx.y * C;  // chunk 0, which sees the most, first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t stride = (int64_t)heads * D;
  const int64_t k_base = ((int64_t)b * t_k + k0) * stride + (int64_t)h * D;
  const int64_t q_base = (int64_t)b * t_q * stride + (int64_t)h * D;
  const int64_t row_base = ((int64_t)b * heads + h) * t_q;
  const int q_pos = offsets[0], k_pos = offsets[1] + k0;
  const int n_tiles = t_q / R;
  const int first =
      causal ? first_visible_tile(q_pos, R, k_pos, n_tiles) : 0;
  const int c0 = warp * 16 + g;  // this lane's keys: c0 and c0 + 8

  float acc_k[D / 8][4] = {}, acc_v[D / 8][4] = {};
  // this (batch, head)'s query rows and per-row L and D
  const T* q_bh = q + q_base;
  const T* dout_bh = dout + q_base;
  const float* lse_bh = lse + row_base;
  const float* delta_bh = delta + row_base;
  auto load_tile = [=](int i, int buf) {
    const int64_t at = (int64_t)i * R * stride;
    load_rows_async<T, D>(qs + buf * R * LD, q_bh + at, stride, R);
    load_rows_async<T, D>(dos + buf * R * LD, dout_bh + at, stride, R);
    load_vec_async(ls + buf * R, lse_bh + i * R, R);
    load_vec_async(ds_row + buf * R, delta_bh + i * R, R);
  };
  if (first < n_tiles) {
    load_rows_async<T, D>(ks, k + k_base, stride, C);
    load_rows_async<T, D>(vs, v + k_base, stride, C);
    load_tile(first, 0);
    cp_async_commit();
    const float scale2 = scale * kLog2e;
    const T* kw = ks + warp * 16 * LD;
    const T* vw = vs + warp * 16 * LD;

    for (int i = first; i < n_tiles; ++i) {
      const int buf = (i - first) & 1;
      if (i + 1 < n_tiles) load_tile(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group has landed
      __syncthreads();

      // the tile in steps of W queries, a loop (not unrolled) that bounds
      // the score registers
#pragma unroll 1
      for (int w0 = 0; w0 < R; w0 += W) {
        const int q_first = q_pos + i * R + w0;
        // every query of the step lies before this warp's first key
        if (causal && q_first + W - 1 < k_pos + warp * 16) continue;
        const T* qb = qs + (buf * R + w0) * LD;
        const T* dob = dos + (buf * R + w0) * LD;
        const float* lb = ls + buf * R + w0;
        const float* db = ds_row + buf * R + w0;
        // transposed tiles: rows are this warp's keys, columns the queries
        float s[NT][4] = {}, dp[NT][4] = {};
        mma_abt<D, NT>(s, kw, qb);
        mma_abt<D, NT>(dp, vw, dob);
        const bool diag = causal && k_pos + warp * 16 + 15 > q_first;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = 8 * j + 2 * t;
          const float2 lv = *reinterpret_cast<const float2*>(lb + col);
          const float2 dv2 = *reinterpret_cast<const float2*>(db + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c0 + (e >> 1) * 8;
            const float lr = (e & 1) ? lv.y : lv.x;
            const float dr = (e & 1) ? dv2.y : dv2.x;
            const float x = diag && q_first + col + (e & 1) < k_pos + key
                                ? kMasked
                                : s[j][e] * scale2 - lr * kLog2e;
            const float p = exp2f(x);  // exactly 0 where masked
            dp[j][e] = p * (dp[j][e] - dr) * scale;
            s[j][e] = p;
          }
        }
        mma_pm<D, NT>(acc_v, s, dob);
        mma_pm<D, NT>(acc_k, dp, qb);
      }
      __syncthreads();  // every warp is done with this buffer
    }
  }

  const int64_t at = k_base + (int64_t)c0 * stride + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(dk + at + 8 * n) =
        make_float2(acc_k[n][0], acc_k[n][1]);
    *reinterpret_cast<float2*>(dk + at + 8 * stride + 8 * n) =
        make_float2(acc_k[n][2], acc_k[n][3]);
    *reinterpret_cast<float2*>(dv + at + 8 * n) =
        make_float2(acc_v[n][0], acc_v[n][1]);
    *reinterpret_cast<float2*>(dv + at + 8 * stride + 8 * n) =
        make_float2(acc_v[n][2], acc_v[n][3]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* offsets, float* dk, float* dv, int batch,
                   int t_q, int t_k, int heads, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_block_dkv_kernel<T, D>;
  const size_t smem = Tiles<T, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, t_k / Tiles<T, D>::kCols);
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
  if (t_q % 64 || t_k % 64) return (int)cudaErrorInvalidValue;
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
