// Fused depthwise conv + batchnorm affine + optional ReLU6, NHWC.
//
// Replaces the TPU kernel idc_models_tpu/ops/fused_conv.py::_kernel
// (reached through _pallas_impl / fused_depthwise_affine): a TF-SAME
// kh x kw depthwise multiply-accumulate in f32 at stride sh x sw, then
// y * mul + add, then an optional clamp to [0, 6], stored in x's dtype.
// In batchnorm mode the kernel reads scale, bias, mean and var and folds
// them itself, in fold_bn's order of operations:
//     mul = scale * rsqrt(var + eps),  add = bias - mean * mul.
//
// Bound on an H100: bytes. A 3x3 depthwise output costs 9 multiplies, 9
// adds, the affine and the clamp (21 f32 operations) against 8 bytes of
// x and y in f32, far below the card's ridge. The 17 calls of one
// MobileNetV2 forward at batch 4096 on 50x50 patches move 6.01 GB, x
// read once and y written once: 1.79 ms at the data sheet's 3.35 TB/s
// (H100 SXM). They hold 599.4M outputs; at about 25 lane-instructions
// an output (below) the card's 132 x 128 lanes issue them in about
// 0.5 ms, so the design must keep enough bytes in flight and spend few
// instructions on anything but the taps. (Its times on the card: PERF.md.)
//
// What the design does about that bound:
//   - A block owns a slab of channels and walks one or more tiles, each
//     a tile of output rows x output columns of one image (blockIdx and
//     each tile's index decoded once). The slabs of a tile are
//     neighbouring blocks, so together they read whole pixels. The block
//     stages a tile's input window, halo included, in shared memory:
//     16-byte cp.async with zero-fill for every position outside the
//     image, so TF-SAME padding contributes 0 * w as in the references
//     and the tap loop has no bounds checks. bf16 stays bf16 in shared
//     memory. A block that walks several tiles double-buffers them: the
//     next tile's window is in flight while it computes this one. The
//     several blocks an SM holds overlap their loads with each other's
//     taps too.
//   - A thread owns one 16-byte channel vector (4 f32 or 8 bf16
//     channels) and a strip of at most kMaxStrip outputs along one
//     output row. Its kh*kw weights and its affine pair sit in registers
//     for every tile the block walks. In the 3x3 instantiations (stride 1
//     and 2) a kw-wide window of input columns slides along the strip in
//     registers: each new output reads only its sw new columns of kh
//     vectors from shared memory. The output goes out as one 16-byte
//     store; neighbouring threads hold neighbouring channels, so a
//     warp's stores coalesce.
//   - Threads index inside the tile by threadIdx (x: channel vector,
//     y: strip, z: output row); no output pays a division. The tile plan
//     (rows, columns, strip, channel vectors a slab, tiles a walk) comes
//     from the caller (ops/fused_conv.py::depthwise_tiles).
//   - Other kh x kw or strides run a general instantiation with runtime
//     tap loops and the slab's weights in shared memory. Channel counts
//     that are not a multiple of the vector width, and misaligned or
//     channel-strided x, run a scalar-channel instantiation (one channel
//     a thread, plain loads, one buffer).
//
// Exact arithmetic: every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn, no FMA contraction) and the taps are summed in
// the plain version's (i, j) order, starting from the first product, so
// the f32 result equals ops/fused_conv.py::reference_impl bit for bit.
// The clamp is two comparisons, so a NaN passes through as it does
// through torch.clamp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads a block; with a launch bound of one block an SM, ptxas keeps
// every instantiation free of spills
constexpr int kMaxThreads = 128;
constexpr int kMaxStrip = 8;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's limit on sm_90

// Mirrored by ops/fused_conv.py::_Geometry; shape-dependent only, so the
// wrapper builds one per call shape and passes it by pointer.
struct Geometry {
  int dtype;   // 0 = float32, 1 = bfloat16 (x and y)
  int path;    // 0 = 3x3 vector, 1 = general vector, 2 = scalar channels
  int bn;      // 1: a, b, mean, var are scale, bias, mean, var; 0: mul, add
  int clamp6;
  float eps;
  int H, W, C, Ho, Wo;
  int kh, kw, sh, sw, pad_top, pad_left;
  long long xs_n, xs_h, xs_w, xs_c;  // x's element strides
  int rows, cols, strip, cvec;       // tile: output rows, output columns,
                                     // outputs a strip, vectors a slab
  int row_tiles, col_tiles, slabs;
  int walk;                          // tiles a block walks, in turn
  long long n;
};

struct Params {
  Geometry g;
  const void* x;
  const float* w;
  const float* a;
  const float* b;
  const float* mean;
  const float* var;
  void* y;
};

template <typename T>
struct Vec;  // a thread's channel vector: V channels of T in 16 bytes
template <>
struct Vec<float> {
  static constexpr int V = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t r[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(r[k] << 16);  // element 2k: low half
    f[2 * k + 1] = __uint_as_float(r[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the affine pair of channel c: given, or folded from batchnorm
__device__ __forceinline__ void affine(const Params& p, int c, float& mul,
                                       float& add) {
  if (p.g.bn) {
    const float inv = rsqrtf(__fadd_rn(__ldg(p.var + c), p.g.eps));
    mul = __fmul_rn(__ldg(p.a + c), inv);
    add = __fsub_rn(__ldg(p.b + c), __fmul_rn(__ldg(p.mean + c), mul));
  } else {
    mul = __ldg(p.a + c);
    add = __ldg(p.b + c);
  }
}

__device__ __forceinline__ float epilogue(float acc, float mul, float add,
                                          int clamp6) {
  float v = __fadd_rn(__fmul_rn(acc, mul), add);
  if (clamp6) {
    // comparisons, not fminf/fmaxf: a NaN must pass through, as it
    // does through torch.clamp, so a diverged step stays visible
    v = v < 0.0f ? 0.0f : v;
    v = v > 6.0f ? 6.0f : v;
  }
  return v;
}

struct Tile {  // what a block decodes from a tile's index, once
  long long n;
  int ho0, wo0, rows, cols;  // first output row/column; valid counts
  int ih0, iw0;              // input row/column of the window's origin
};

__device__ __forceinline__ Tile decode(const Geometry& g, long long index) {
  Tile t;
  const int ct = static_cast<int>(index % g.col_tiles);
  const long long r = index / g.col_tiles;
  const int rt = static_cast<int>(r % g.row_tiles);
  t.n = r / g.row_tiles;
  t.ho0 = rt * g.rows;
  t.wo0 = ct * g.cols;
  t.rows = min(g.rows, g.Ho - t.ho0);
  t.cols = min(g.cols, g.Wo - t.wo0);
  t.ih0 = t.ho0 * g.sh - g.pad_top;
  t.iw0 = t.wo0 * g.sw - g.pad_left;
  return t;
}

// Vector paths (3x3 templated, or general when KH == 0). A block walks
// up to g.walk tiles of one slab: while it computes one tile, the next
// tile's window is in flight into the other of two buffers.
template <typename T, int KH, int KW, int SH, int SW>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fused_depthwise_vec_kernel(const Params p) {
  constexpr int V = Vec<T>::V;
  constexpr bool kFixed = KH > 0;
  const Geometry& g = p.g;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int cvec = blockDim.x;
  // the slabs of one tile are neighbouring blocks, so they read a
  // pixel's channels at about the same time
  const int c0 = (blockIdx.x % g.slabs) * cvec * V + tx * V;  // own channels
  const int kh = kFixed ? KH : g.kh, kw = kFixed ? KW : g.kw;
  const int sh = kFixed ? SH : g.sh, sw = kFixed ? SW : g.sw;
  const int rows_in = (g.rows - 1) * sh + kh;
  const int cols_in = (g.cols - 1) * sw + kw;
  const size_t window = static_cast<size_t>(rows_in) * cols_in * cvec * 16;
  const int buffers = g.walk > 1 ? 2 : 1;
  const long long tiles = g.n * g.row_tiles * g.col_tiles;
  const long long first =
      static_cast<long long>(blockIdx.x / g.slabs) * g.walk;
  const long long last = min(first + g.walk, tiles);

  // stage a tile's window: [rows_in][cols_in][cvec] 16-byte vectors
  const T* x = static_cast<const T*>(p.x);
  auto stage = [&](long long index, unsigned char* buf) {
    const Tile t = decode(g, index);
    const T* xn = x + t.n * g.xs_n + c0;
    for (int r = tz; r < rows_in; r += blockDim.z) {
      const int ih = t.ih0 + r;
      const bool row_in =
          static_cast<unsigned>(ih) < static_cast<unsigned>(g.H);
      for (int col = ty; col < cols_in; col += blockDim.y) {
        const int iw = t.iw0 + col;
        const bool in =
            row_in && static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
        const T* src = in ? xn + ih * g.xs_h + iw * g.xs_w : x;
        cp_async16(buf + (static_cast<size_t>(r * cols_in + col) * cvec + tx) * 16,
                   src, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  stage(first, smem);

  // while the first window lands: the slab's weights (registers for
  // 3x3; shared memory after the buffers otherwise) and this thread's
  // affine pairs, kept for every tile the block walks
  float* wsm = reinterpret_cast<float*>(smem + buffers * window);
  if (!kFixed) {
    const int nthreads_yz = blockDim.y * blockDim.z;
    for (int tap = tz * blockDim.y + ty; tap < kh * kw; tap += nthreads_yz) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        wsm[tap * cvec * V + tx * V + v] = __ldg(p.w + tap * g.C + c0 + v);
    }
  }
  float mul[V], add[V];
#pragma unroll
  for (int v = 0; v < V; ++v) affine(p, c0 + v, mul[v], add[v]);
  float wr[kFixed ? KH : 1][kFixed ? KW : 1][V];
  if (kFixed) {
#pragma unroll
    for (int i = 0; i < (kFixed ? KH : 1); ++i)
#pragma unroll
      for (int j = 0; j < (kFixed ? KW : 1); ++j)
#pragma unroll
        for (int v = 0; v < V; v += 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(
              p.w + (i * KW + j) * g.C + c0 + v));
          wr[i][j][v] = q.x;
          wr[i][j][v + 1] = q.y;
          wr[i][j][v + 2] = q.z;
          wr[i][j][v + 3] = q.w;
        }
  }

  T* y = static_cast<T*>(p.y);
  const int s0 = ty * g.strip;
  for (long long index = first; index < last; ++index) {
    unsigned char* buf = smem + ((index - first) & 1) * window;
    if (index + 1 < last) {
      stage(index + 1, smem + ((index + 1 - first) & 1) * window);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Tile t = decode(g, index);
    const int len = min(g.strip, t.cols - s0);
    auto vec_at = [&](int r, int col) -> uint4 {
      return *reinterpret_cast<const uint4*>(
          buf + (static_cast<size_t>(r * cols_in + col) * cvec + tx) * 16);
    };
    // each thread: its strip of (normally) one output row, kMaxStrip
    // outputs at most
    for (int r = tz; r < t.rows && len > 0; r += blockDim.z) {
      T* yrow = y + ((t.n * g.Ho + t.ho0 + r) * g.Wo + t.wo0 + s0) * g.C + c0;
      if constexpr (kFixed) {
        uint4 win[KH][KW];
#pragma unroll
        for (int o = 0; o < kMaxStrip; ++o) {
          if (o >= len) break;
#pragma unroll
          for (int j = 0; j < KW; ++j) {
#pragma unroll
            for (int i = 0; i < KH; ++i) {
              // slide: the columns the previous output read move by SW
              if (o > 0 && j + SW < KW)
                win[i][j] = win[i][j + SW];
              else
                win[i][j] = vec_at(r * SH + i, (s0 + o) * SW + j);
            }
          }
          float acc[V];
#pragma unroll
          for (int i = 0; i < KH; ++i)
#pragma unroll
            for (int j = 0; j < KW; ++j) {
              float xv[V];
              unpack(win[i][j], xv);
#pragma unroll
              for (int v = 0; v < V; ++v) {
                const float prod = __fmul_rn(xv[v], wr[i][j][v]);
                acc[v] = (i == 0 && j == 0) ? prod : __fadd_rn(acc[v], prod);
              }
            }
          float out[V];
#pragma unroll
          for (int v = 0; v < V; ++v)
            out[v] = epilogue(acc[v], mul[v], add[v], g.clamp6);
          *reinterpret_cast<uint4*>(yrow + static_cast<long long>(o) * g.C) =
              pack(out);
        }
      } else {
        for (int o = 0; o < len; ++o) {
          float acc[V];
          const float* wt = wsm + tx * V;
          for (int i = 0; i < kh; ++i) {
            for (int j = 0; j < kw; ++j, wt += cvec * V) {
              float xv[V];
              unpack(vec_at(r * sh + i, (s0 + o) * sw + j), xv);
#pragma unroll
              for (int v = 0; v < V; ++v) {
                const float prod = __fmul_rn(xv[v], wt[v]);
                acc[v] = (i == 0 && j == 0) ? prod : __fadd_rn(acc[v], prod);
              }
            }
          }
          float out[V];
#pragma unroll
          for (int v = 0; v < V; ++v)
            out[v] = epilogue(acc[v], mul[v], add[v], g.clamp6);
          *reinterpret_cast<uint4*>(yrow + static_cast<long long>(o) * g.C) =
              pack(out);
        }
      }
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }
}

// Scalar-channel path: one channel a thread, any strides, plain loads
// into one buffer, tile after tile.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fused_depthwise_scalar_kernel(const Params p) {
  const Geometry& g = p.g;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int cs = blockDim.x;
  const int c = (blockIdx.x % g.slabs) * cs + tx;
  const int rows_in = (g.rows - 1) * g.sh + g.kh;
  const int cols_in = (g.cols - 1) * g.sw + g.kw;
  T* tile = reinterpret_cast<T*>(smem);
  const size_t tile_bytes =
      (static_cast<size_t>(rows_in) * cols_in * cs * sizeof(T) + 15) / 16 *
      16;
  float* wsm = reinterpret_cast<float*>(smem + tile_bytes);
  const int nthreads_yz = blockDim.y * blockDim.z;
  for (int tap = tz * blockDim.y + ty; tap < g.kh * g.kw; tap += nthreads_yz)
    wsm[tap * cs + tx] = __ldg(p.w + tap * g.C + c);
  float mul, add;
  affine(p, c, mul, add);

  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  const int s0 = ty * g.strip;
  const long long tiles = g.n * g.row_tiles * g.col_tiles;
  const long long first =
      static_cast<long long>(blockIdx.x / g.slabs) * g.walk;
  const long long last = min(first + g.walk, tiles);
  for (long long index = first; index < last; ++index) {
    const Tile t = decode(g, index);
    const T* xn = x + t.n * g.xs_n + c * g.xs_c;
    for (int r = tz; r < rows_in; r += blockDim.z) {
      const int ih = t.ih0 + r;
      const bool row_in =
          static_cast<unsigned>(ih) < static_cast<unsigned>(g.H);
      for (int col = ty; col < cols_in; col += blockDim.y) {
        const int iw = t.iw0 + col;
        const bool in =
            row_in && static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
        T v;
        from_f32(0.0f, &v);
        if (in) v = xn[ih * g.xs_h + iw * g.xs_w];
        tile[(r * cols_in + col) * cs + tx] = v;
      }
    }
    __syncthreads();
    const int len = min(g.strip, t.cols - s0);
    for (int r = tz; r < t.rows && len > 0; r += blockDim.z) {
      T* yrow = y + ((t.n * g.Ho + t.ho0 + r) * g.Wo + t.wo0 + s0) * g.C + c;
      for (int o = 0; o < len; ++o) {
        float acc = 0.0f;
        const float* wt = wsm + tx;
        const T* xt = tile + ((r * g.sh) * cols_in + (s0 + o) * g.sw) * cs + tx;
        for (int i = 0; i < g.kh; ++i, xt += cols_in * cs) {
          for (int j = 0; j < g.kw; ++j, wt += cs) {
            const float prod = __fmul_rn(to_f32(xt[j * cs]), *wt);
            acc = (i == 0 && j == 0) ? prod : __fadd_rn(acc, prod);
          }
        }
        from_f32(epilogue(acc, mul, add, g.clamp6),
                 yrow + static_cast<long long>(o) * g.C);
      }
    }
    __syncthreads();  // the buffer is restaged for the next tile
  }
}

template <typename K>
cudaError_t launch(K kernel, const Params& p, dim3 grid, dim3 block,
                   size_t smem, cudaStream_t s) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, block, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t s) {
  const Geometry& g = p.g;
  const long long tiles = g.n * g.row_tiles * g.col_tiles;
  const dim3 grid(static_cast<unsigned>((tiles + g.walk - 1) / g.walk *
                                        g.slabs));
  const dim3 block(g.cvec, (g.cols + g.strip - 1) / g.strip, g.rows);
  const size_t window = static_cast<size_t>((g.rows - 1) * g.sh + g.kh) *
                        ((g.cols - 1) * g.sw + g.kw);
  if (g.path == 2) {
    const size_t smem = (window * g.cvec * sizeof(T) + 15) / 16 * 16 +
                        static_cast<size_t>(g.kh) * g.kw * g.cvec * 4;
    return launch(fused_depthwise_scalar_kernel<T>, p, grid, block, smem, s);
  }
  constexpr int V = Vec<T>::V;
  const size_t buffers = (g.walk > 1 ? 2 : 1) * window * g.cvec * 16;
  if (g.path == 1)
    return launch(fused_depthwise_vec_kernel<T, 0, 0, 0, 0>, p, grid, block,
                  buffers + static_cast<size_t>(g.kh) * g.kw * g.cvec * V * 4,
                  s);
  if (g.kh != 3 || g.kw != 3 || g.sh != g.sw || (g.sh != 1 && g.sh != 2))
    return cudaErrorInvalidValue;
  if (g.sh == 1)
    return launch(fused_depthwise_vec_kernel<T, 3, 3, 1, 1>, p, grid, block,
                  buffers, s);
  return launch(fused_depthwise_vec_kernel<T, 3, 3, 2, 2>, p, grid, block,
                buffers, s);
}

}  // namespace

extern "C" {

// x [n, H, W, C] at the strides in g; y [n, Ho, Wo, C] contiguous. w is
// [kh, kw, 1, C] f32 contiguous. a, b are mul, add (g->bn == 0) or
// scale, bias with mean, var (g->bn == 1), f32 [C]. Launches on `stream`
// and returns cudaGetLastError().
int fused_depthwise_forward(const void* g, const void* x, const void* w,
                            const void* a, const void* b, const void* mean,
                            const void* var, void* y, void* stream) {
  Params p;
  p.g = *static_cast<const Geometry*>(g);
  p.x = x;
  p.w = static_cast<const float*>(w);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.mean = static_cast<const float*>(mean);
  p.var = static_cast<const float*>(var);
  p.y = y;
  if (p.g.n * p.g.Ho * p.g.Wo * p.g.C == 0) return 0;
  if (p.g.rows > 64 || p.g.walk < 1 || p.g.strip > kMaxStrip ||
      p.g.cvec * ((p.g.cols + p.g.strip - 1) / p.g.strip) * p.g.rows >
          kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.g.dtype == 0) return static_cast<int>(dispatch<float>(p, s));
  if (p.g.dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_depthwise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
