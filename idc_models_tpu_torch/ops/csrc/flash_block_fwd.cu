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
// or bf16 in memory; s, p and the carry are f32, as in the TPU kernel.
// The sentinel is finite, not -inf: a row whose first folded block is
// fully masked gets p = e^0 = 1 "garbage" that the next visible block
// cancels exactly (its correction factor is e^(-1e30 - m') = 0).
//
// Bound on an H100: operations. Two products per visible (query, key)
// pair -- s and p.v -- 4*D flops, so at the main path's shape (B=1,
// T=16384, H=8, D=64, causal) 2.75e11 flops against ~0.17 GB of
// q/k/v/carry: 0.555 ms at the TF32 tensor-core peak (495 TFLOP/s) for
// f32 inputs, 0.278 ms at the bf16 peak (989) for bf16. The design's own
// ceiling is higher: 3xTF32 runs 3 passes of both products (1.67 ms),
// bf16 runs s once and p.v twice, hi and lo (0.42 ms); and `mma.sync`
// reaches only part of the peak that `wgmma` can.
//
// Design (flash_mma.cuh has the products), FlashAttention-2's forward:
// - Tensor cores through mma.sync: one 128-thread block per (64-row
//   query tile, head, batch), a warp per 16 rows. s comes out as
//   accumulator fragments, the causal mask and the online softmax run on
//   them (row max and sum across the four lanes of a quad), and p feeds
//   p.v as its A fragment without a trip through shared memory. f32 runs
//   3xTF32, bf16 runs m16n8k16 with p split into bf16 hi + lo, so p keeps
//   f32 accuracy as the TPU kernel keeps it in f32. The mask runs only on
//   the chunks that reach past a warp's first query.
// - The carry (m, l of rows g and g+8, acc) lives in registers from the
//   first chunk to the last and is written once.
// - cp.async double buffering: the q tile is staged once; K and V chunks
//   (64 keys, 32 at D=128) alternate between two buffers in their own
//   dtype, the next chunk in flight while this one is computed.
// - Causal chunk skipping with an exact rule. A chunk past the tile's
//   span (flash_mma.cuh `visible_chunks`, from the offsets read on the
//   device) is fully masked. For a row whose m > -1e30 folding it is a
//   no-op bit for bit: m' = max(m, -1e30) = m, the correction e^(m - m')
//   is 1 and every p = e^(-1e30 - m) is 0. For a row still at the
//   sentinel it is not (p = e^0 = 1: l grows by the chunk width), and the
//   plain version keeps that garbage. So after the span the block votes
//   (__syncthreads_and) on "every row's m > -1e30": if it passes the
//   block stops, else it walks the remaining chunks as the plain version
//   does. On the main paths the vote always passes (every row sees a key
//   of its own block). The rule is ops/flash_block_kernel.py
//   `update_chunk_span`, in the same integer formulas. Work per block is
//   uneven, so the grid runs the tiles heaviest first.
// - Accuracy: each 3xTF32 k-step of s, and each chunk's p.v, sums into
//   zeroed fragments that f32 adds carry into s and acc (flash_mma.cuh
//   says why). e^x is 2^((x - m') * log2(e)) on the MUFU unit; the
//   difference is formed first, so the sentinel's e^0 is exactly 1.
// - Registers: a launch bound of two blocks an SM lets ptxas use up to
//   255 a thread, and the chunk at D=128 is 32 keys: no spills.
//
// What it leaves, for a later PR: wgmma with TMA and warp specialisation.

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

// 2^x, subnormal results flushed to 0 (a p under 1e-38 adds nothing that
// an f32 sum of terms up to 1 keeps)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D>
struct Tiles {
  static constexpr int kRows = 16 * kWarps;          // query rows a block
  static constexpr int kCols = D <= 64 ? 64 : 32;    // keys a chunk
  static constexpr int kLd = ld<T, D>();
  static constexpr size_t kSmem = sizeof(T) * kLd * (kRows + 4 * kCols);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_block_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       const float* __restrict__ acc_in,
                       const int* __restrict__ offsets,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       float* __restrict__ acc_out, int t_q, int t_k, int heads,
                       float scale, int causal) {
  constexpr int R = Tiles<T, D>::kRows, C = Tiles<T, D>::kCols;
  constexpr int LD = Tiles<T, D>::kLd, NT = C / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + R * LD;         // two buffers of C rows
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
  const int n_all = t_k / C;
  const int n_span = causal ? visible_chunks(q_pos, R, k_pos, C, n_all) : n_all;
  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  const T* qw = qs + warp * 16 * LD;

  // the carry: m, l of rows r0 and r0 + 8; acc in the accumulator
  // fragment layout (columns 8n + 2t, 8n + 2t + 1)
  float m[2] = {m_in[row_base + r0], m_in[row_base + r0 + 8]};
  float l[2] = {l_in[row_base + r0], l_in[row_base + r0 + 8]};
  float acc[D / 8][4];
  {
    const float* in = acc_in + q_base + (int64_t)r0 * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(in + 8 * n);
      const float2 y = *reinterpret_cast<const float2*>(in + 8 * stride + 8 * n);
      acc[n][0] = x.x; acc[n][1] = x.y; acc[n][2] = y.x; acc[n][3] = y.y;
    }
  }
  // two walks: the span, then -- only if the vote below fails -- the
  // chunks past it
  load_rows_async<T, D>(qs, q + q_base, stride, R);
  int c = 0, end = n_span;
  for (;;) {
    if (c < end) {  // the walk's first chunk (with the q tile, the first time)
      const int64_t at = kv_base + (int64_t)c * C * stride;
      load_rows_async<T, D>(ks + (c & 1) * C * LD, k + at, stride, C);
      load_rows_async<T, D>(vs + (c & 1) * C * LD, v + at, stride, C);
    }
    cp_async_commit();
    for (; c < end; ++c) {
      const int buf = c & 1;
      if (c + 1 < end) {  // the next chunk, into the other buffer
        const int64_t at = kv_base + (int64_t)(c + 1) * C * stride;
        load_rows_async<T, D>(ks + (buf ^ 1) * C * LD, k + at, stride, C);
        load_rows_async<T, D>(vs + (buf ^ 1) * C * LD, v + at, stride, C);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's group has landed
      __syncthreads();

      float s[NT][4] = {};
      mma_abt<D, NT>(s, qw, ks + buf * C * LD);
      const int k_first = k_pos + c * C;
      // some key of the chunk lies after this warp's first query
      const bool diag = causal && k_first + C - 1 > q_pos + warp * 16;
      float mx[2] = {kMasked, kMasked};
      if (diag) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q_pos + r0 + (e >> 1) * 8;
            s[j][e] = row < k_first + 8 * j + 2 * t + (e & 1) ? kMasked
                                                              : s[j][e] * scale;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= scale;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = ex2((m[i] - m_new) * kLog2e);
        m[i] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2((s[j][e] - m[e >> 1]) * kLog2e);
          s[j][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * corr[i] + rs[i];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
        acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
      }
      mma_pm<D, NT>(acc, s, vs + buf * C * LD);
      __syncthreads();  // every warp is done with this buffer
    }
    // past the span every chunk is fully masked: a no-op for a row whose
    // m > -1e30, so stop when every row of the tile has one; else walk
    // the rest as the plain version does
    if (end == n_all ||
        __syncthreads_and(m[0] > kMasked && m[1] > kMasked))
      break;
    end = n_all;
  }
  cp_async_wait<0>();

  if (t == 0) {
    m_out[row_base + r0] = m[0];
    m_out[row_base + r0 + 8] = m[1];
    l_out[row_base + r0] = l[0];
    l_out[row_base + r0 + 8] = l[1];
  }
  float* out = acc_out + q_base + (int64_t)r0 * stride + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(out + 8 * n) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + 8 * stride + 8 * n) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* m, const float* l, const float* acc,
                   const int* offsets, float* om, float* ol, float* oacc,
                   int batch, int t_q, int t_k, int heads, float scale,
                   int causal, cudaStream_t stream) {
  auto kernel = flash_block_fwd_kernel<T, D>;
  const size_t smem = Tiles<T, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, t_q / Tiles<T, D>::kRows);
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
  if (t_q % 64 || t_k % 64) return (int)cudaErrorInvalidValue;
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
