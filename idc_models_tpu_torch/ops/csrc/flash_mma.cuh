// Warp-level tensor-core products, asynchronous staging and the causal
// span rule shared by the flash kernels: the update (flash_block_fwd.cu)
// and the two backward kernels (flash_block_dq.cu, flash_block_dkv.cu).
//
// Every product is `mma.sync` (inline PTX, sm_90a) with f32 accumulators
// in registers, for a warp that owns 16 rows:
//
//   mma_abt  c[16 x 8NT] += A[16 x D] . B[8NT x D]^T   (s = q.k^T, dout.v^T;
//            A and B rows staged in shared memory)
//   mma_pm   acc[16 x D] += P[16 x 8KT] . M[8KT x D]   (p.v, ds.k, p^T.dout,
//            ds^T.q; P straight from the registers of an mma_abt result)
//
// f32 inputs go through 3xTF32 (m16n8k8): x = big + small, both tf32,
// and a.b ~ small_a.big_b + big_a.small_b + big_a.big_b, which keeps
// f32-level accuracy (plain TF32 keeps about three decimal digits).
// bf16 inputs go through m16n8k16: q.k^T and dout.v^T are exact bf16
// products summed in f32; in the second products the f32 p or ds is
// split into bf16 hi + lo, so p and ds keep f32 accuracy (each term is
// within 2^-18 of its f32 value) while k, q and dout enter as they are.
//
// Shared-memory rows are padded by 16 bytes (D + 4 floats, D + 8 bf16),
// which makes every fragment load free of bank conflicts: the scalar
// f32 loads at [g][t] and [2t][g] (g = lane / 4, t = lane % 4), and the
// eight 16-byte rows of each `ldmatrix`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// the kernels' launch bound: two blocks an SM, the most that f32 tiles
// leave room for in shared memory, so ptxas may use up to 255 registers a
// thread (left to itself it aims at more blocks and spills to get there)
constexpr int kMinBlocks = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;  // the plain version's sentinel (p = 0)

// row stride in shared memory, in elements: D plus 16 bytes
template <typename T, int D>
__host__ __device__ constexpr int ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// ---------------------------------------------------------------------------
// the causal span rule -- the same integer formulas as
// ops/flash_block_kernel.py `causal_chunk_span`: a tile of `rows` queries
// and a chunk of `cols` keys share a visible pair iff the chunk's first
// key is at or before the tile's last query (global positions); every
// other (tile, chunk) pair is fully masked. In the backward its
// p = exp(-1e30 - L) and ds are exactly 0, so leaving it out changes no
// bit. In the update it is a no-op, bit for bit, only for a row whose
// running max m is already above -1e30 (flash_block_fwd.cu says why and
// how the update kernel decides).
// ---------------------------------------------------------------------------

// how many chunks, counted from the key block's start k_block, the query
// tile at [q_start, q_start + rows) sees: chunks [0, n)
__device__ __forceinline__ int visible_chunks(int q_start, int rows,
                                              int k_block, int cols,
                                              int n_chunks) {
  const int last = q_start + rows - 1 - k_block;
  return last < 0 ? 0 : min(last / cols + 1, n_chunks);
}

// the first tile of `rows` queries, counted from the query block's start
// q_block, that sees the key chunk starting at k_start: tiles [first, n)
__device__ __forceinline__ int first_visible_tile(int q_block, int rows,
                                                  int k_start, int n_tiles) {
  const int need = k_start - q_block - rows + 1;
  return need <= 0 ? 0 : min((need + rows - 1) / rows, n_tiles);
}

// ---------------------------------------------------------------------------
// cp.async staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of D elements (row r at src + r * stride) into
// dst[r * ld + d], in their own type, 16 bytes a copy
template <typename T, int D>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src,
                                                int64_t stride, int rows) {
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  constexpr int kVec = D / kElems;
  constexpr int LD = ld<T, D>();
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * kElems;
    cp_async16(dst + r * LD + c, src + r * stride + c);
  }
}

// n f32 values (n a multiple of 4)
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               int n) {
  for (int i = threadIdx.x * 4; i < n; i += kThreads * 4)
    cp_async16(dst + i, src + i);
}

// ---------------------------------------------------------------------------
// the instructions
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a shared-memory address as the 32 bits that ldmatrix takes
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  unsigned s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s)
               : "memory");
}

// x rounded to tf32 (10 mantissa bits, to nearest, ties away), low bits 0
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

// (x0, x1) as bf16 pairs hi and lo with hi + lo ~ (x0, x1); x0 in the low half
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// the warp's products. Accumulator fragment of an m16n8 tile: c[0], c[1]
// at row g, columns 2t and 2t + 1; c[2], c[3] at row g + 8.
// ---------------------------------------------------------------------------

// c[j] += A[16 x D] . B[8j..8j+8 x D]^T, f32 through 3xTF32; a and b point
// at the warp's first rows in shared memory. The three passes of each
// k-step go into a zeroed fragment that an f32 add puts into c: p =
// exp(s - L) turns an error in s into a relative error in p, and s summed
// in c's own fragment over D/8 steps x 3 passes erred by a few 1e-6 of
// |s|, enough to move dq past the ring's tolerance on the card.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const float* a,
                                        const float* b) {
  constexpr int LD = ld<float, D>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    uint32_t ab[4], as[4];
    split_tf32(a[g * LD + k0 + t], ab[0], as[0]);
    split_tf32(a[(g + 8) * LD + k0 + t], ab[1], as[1]);
    split_tf32(a[g * LD + k0 + t + 4], ab[2], as[2]);
    split_tf32(a[(g + 8) * LD + k0 + t + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* bj = b + (8 * j + g) * LD + k0 + t;
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(bj[0], bb0, bs0);
      split_tf32(bj[4], bb1, bs1);
      float part[4] = {};
      mma_tf32(part, as, bb0, bb1);
      mma_tf32(part, ab, bs0, bs1);
      mma_tf32(part, ab, bb0, bb1);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += part[e];
    }
  }
}

// the same for bf16 A and B, through ldmatrix and m16n8k16
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b) {
  static_assert(NT % 2 == 0, "two n-tiles a B load");
  constexpr int LD = ld<__nv_bfloat16, D>();
  const int lane = threadIdx.x & 31;
  // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15); B: rows (keys) 0-7 of
  // tile j at k 0-7 | 8-15, then the same for tile j + 1
  const unsigned a_at = smem_addr(a + (lane & 15) * LD + (lane >> 4) * 8);
  const unsigned b_at = smem_addr(
      b + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, a_at + 2 * k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b_at + 2 * (8 * j * LD + k0));
      mma_bf16(c[j], af, bf[0], bf[1]);
      mma_bf16(c[j + 1], af, bf[2], bf[3]);
    }
  }
}

// The second products add a whole chunk or tile into a running sum that
// lives across the block's loop, thousands of mma steps at long T. An
// mma's accumulation rounds less well than an f32 add: summed in the
// mma's own fragment, the kernels' error grew with the number of steps.
// So each call sums its products into zeroed fragments and adds them to
// the running sum with f32 adds, group<D>() n-tiles (8 columns each) at a
// time to bound the registers this takes.
template <int D>
__host__ __device__ constexpr int group() {
  return D / 8 < 4 ? D / 8 : 4;
}

// acc[n] += P[16 x 8KT] . M[8KT x D][.., 8n..8n+8], f32 through 3xTF32.
// p[j] is an accumulator fragment (columns 8j..8j+8 of P); m points at
// M's first row in shared memory. Within each k-step of 8 the mma's k
// order is permuted -- its k = t holds column 2t, k = t + 4 column 2t + 1
// -- so the accumulator fragment is the A fragment as it stands, and B
// reads M's rows 2t and 2t + 1 to match.
template <int D, int KT>
__device__ __forceinline__ void mma_pm(float (&acc)[D / 8][4],
                                       const float (&p)[KT][4],
                                       const float* m) {
  constexpr int LD = ld<float, D>(), NG = group<D>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += NG) {
    float part[NG][4] = {};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      uint32_t ab[4], as[4];
      split_tf32(p[j][0], ab[0], as[0]);
      split_tf32(p[j][2], ab[1], as[1]);
      split_tf32(p[j][1], ab[2], as[2]);
      split_tf32(p[j][3], ab[3], as[3]);
      const float* mj = m + (8 * j + 2 * t) * LD + 8 * n0 + g;
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(mj[8 * n], bb0, bs0);
        split_tf32(mj[LD + 8 * n], bb1, bs1);
        mma_tf32(part[n], as, bb0, bb1);
        mma_tf32(part[n], ab, bs0, bs1);
        mma_tf32(part[n], ab, bb0, bb1);
      }
    }
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// the same for bf16 M: two adjacent accumulator fragments are the A
// fragment of one k16 step (as in FlashAttention-2), split into bf16 hi
// and lo; B through ldmatrix.trans of M's rows, one n-tile a load (two
// registers, not four: at D=128 the dk/dv kernel has no more to spare)
template <int D, int KT>
__device__ __forceinline__ void mma_pm(float (&acc)[D / 8][4],
                                       const float (&p)[KT][4],
                                       const __nv_bfloat16* m) {
  static_assert(KT % 2 == 0, "k16 steps");
  constexpr int LD = ld<__nv_bfloat16, D>(), NG = group<D>();
  const int lane = threadIdx.x & 31;
  // matrices: rows (keys) 0-7 | 8-15 of the step at columns 8n
  const unsigned m_at =
      smem_addr(m + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD);
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += NG) {
    float part[NG][4] = {};
#pragma unroll
    for (int j = 0; j < KT; j += 2) {
      uint32_t hi[4], lo[4];
      split_bf16(p[j][0], p[j][1], hi[0], lo[0]);
      split_bf16(p[j][2], p[j][3], hi[1], lo[1]);
      split_bf16(p[j + 1][0], p[j + 1][1], hi[2], lo[2]);
      split_bf16(p[j + 1][2], p[j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, m_at + 2 * (8 * j * LD + 8 * (n0 + n)));
        mma_bf16(part[n], lo, bf[0], bf[1]);
        mma_bf16(part[n], hi, bf[0], bf[1]);
      }
    }
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

}  // namespace flash_mma
