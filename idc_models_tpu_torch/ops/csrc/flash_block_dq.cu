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
// q/k/v/dout are f32 or bf16; p and ds are f32, as in the TPU kernel.
//
// Bound on an H100: operations. Three products per visible (query, key)
// pair -- s, dout.v and ds.k -- 6*D flops, so at the main path's shape
// (B=1, T=16384, H=8, D=64, causal) 4.12e11 flops against ~40 MB of
// q/k/v/dout/L/D/dq: 0.83 ms at the TF32 tensor-core peak (495 TFLOP/s)
// for f32 inputs, 0.42 ms at the bf16 peak (989) for bf16. The design's
// own ceiling is higher: 3xTF32 runs 3 passes of every product (2.50 ms),
// bf16 runs s and dout.v once and ds.k twice, hi and lo (0.56 ms); and
// `mma.sync` reaches only part of the peak that `wgmma` can.
//
// Design (flash_mma.cuh has the products):
// - Causal tile skipping. The block of query tile [q0, q0+64) walks only
//   the key chunks that hold a visible pair: the rule of
//   ops/flash_block_kernel.py `causal_chunk_span` (flash_mma.cuh
//   `visible_chunks`), from the offsets read on the device, so one launch
//   serves every ring step. Each warp walks a chunk in steps of 32 keys
//   (16 at D=128), stops at the first step wholly after its 16 queries,
//   and applies the element mask only to steps that reach past its first
//   query. Work per block is uneven, so the grid runs the tiles heaviest
//   first (the last query tile first).
// - Tensor cores through mma.sync: one 128-thread block per (64-row
//   query tile, head, batch), a warp per 16 rows. s and dout.v come out
//   as accumulator fragments; ds is formed in those registers and feeds
//   ds.k as its A fragment without a trip through shared memory. f32
//   runs 3xTF32, bf16 runs m16n8k16 with ds split into bf16 hi + lo.
// - cp.async double buffering: the q and dout tiles are staged once;
//   K and V chunks (64 keys, 32 at D=128) alternate between two buffers,
//   the next chunk in flight while this one is computed. bf16 stays bf16
//   in shared memory.
// - dq stays in registers across all chunks and is written once, no
//   atomics. Nothing [Tq, Tk]-shaped reaches device memory.
// - Accuracy: each product's mma steps sum into zeroed fragments that f32
//   adds carry into s and dq (flash_mma.cuh says why); the error against
//   the plain version is about 1e-6 of the largest gradient at every T.
// - Registers: 128-thread blocks launched with a bound of two an SM, so
//   ptxas may use up to 255 a thread, and the chunk is walked in steps
//   that keep the score fragments small: no spills at any D.
//
// What it leaves, for a later PR: wgmma with TMA and warp specialisation,
// and s/p recomputed here and again in the dk/dv pass.

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

template <typename T, int D>
struct Tiles {
  static constexpr int kRows = 16 * kWarps;          // query rows a block
  static constexpr int kCols = D <= 64 ? 64 : 32;    // keys a chunk
  static constexpr int kStep = D <= 64 ? 32 : 16;    // keys a warp's step
  static constexpr int kLd = ld<T, D>();
  static constexpr size_t kSmem = sizeof(T) * kLd * (2 * kRows + 4 * kCols);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_block_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ offsets, float* __restrict__ dq,
                      int t_q, int t_k, int heads, float scale, int causal) {
  constexpr int R = Tiles<T, D>::kRows, C = Tiles<T, D>::kCols;
  constexpr int W = Tiles<T, D>::kStep, LD = Tiles<T, D>::kLd, NT = W / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + R * LD;
  T* ks = dos + R * LD;        // two buffers of C rows
  T* vs = ks + 2 * C * LD;     // two buffers of C rows

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;  // heaviest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t stride = (int64_t)heads * D;
  const int64_t q_base = ((int64_t)b * t_q + q0) * stride + (int64_t)h * D;
  const int64_t kv_base = (int64_t)b * t_k * stride + (int64_t)h * D;
  const int64_t row_base = ((int64_t)b * heads + h) * t_q + q0;
  const int q_pos = offsets[0] + q0, k_pos = offsets[1];
  const int n_chunks =
      causal ? visible_chunks(q_pos, R, k_pos, C, t_k / C) : t_k / C;
  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8

  float acc[D / 8][4] = {};
  if (n_chunks > 0) {
    load_rows_async<T, D>(qs, q + q_base, stride, R);
    load_rows_async<T, D>(dos, dout + q_base, stride, R);
    load_rows_async<T, D>(ks, k + kv_base, stride, C);
    load_rows_async<T, D>(vs, v + kv_base, stride, C);
    cp_async_commit();
    const float l0 = lse[row_base + r0] * kLog2e;
    const float l1 = lse[row_base + r0 + 8] * kLog2e;
    const float d0 = delta[row_base + r0], d1 = delta[row_base + r0 + 8];
    const float scale2 = scale * kLog2e;
    const T* qw = qs + warp * 16 * LD;
    const T* dow = dos + warp * 16 * LD;

    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < n_chunks) {  // the next chunk, into the other buffer
        const int64_t at = kv_base + (int64_t)(c + 1) * C * stride;
        load_rows_async<T, D>(ks + (buf ^ 1) * C * LD, k + at, stride, C);
        load_rows_async<T, D>(vs + (buf ^ 1) * C * LD, v + at, stride, C);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's group has landed
      __syncthreads();

      // the chunk in steps of W keys, a loop (not unrolled) that bounds
      // the score registers
#pragma unroll 1
      for (int w0 = 0; w0 < C; w0 += W) {
        const int k_first = k_pos + c * C + w0;
        // every key from here on lies after this warp's last query
        if (causal && k_first > q_pos + warp * 16 + 15) break;
        const T* kb = ks + (buf * C + w0) * LD;
        float s[NT][4] = {}, dp[NT][4] = {};
        mma_abt<D, NT>(s, qw, kb);
        mma_abt<D, NT>(dp, dow, vs + (buf * C + w0) * LD);
        const bool diag = causal && k_first + W - 1 > q_pos + warp * 16;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + (e >> 1) * 8;
            const float x =
                diag && q_pos + row < k_first + 8 * j + 2 * t + (e & 1)
                    ? kMasked
                    : s[j][e] * scale2 - (e < 2 ? l0 : l1);
            const float p = exp2f(x);  // exactly 0 where masked
            s[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1)) * scale;
          }
        mma_pm<D, NT>(acc, s, kb);
      }
      __syncthreads();  // every warp is done with this buffer
    }
  }

  float* out = dq + q_base + (int64_t)r0 * stride + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(out + 8 * n) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + 8 * stride + 8 * n) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* offsets, float* dq, int batch, int t_q,
                   int t_k, int heads, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_block_dq_kernel<T, D>;
  const size_t smem = Tiles<T, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, t_q / Tiles<T, D>::kRows);
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
  if (t_q % 64 || t_k % 64) return (int)cudaErrorInvalidValue;
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
