// Fused depthwise conv + folded batchnorm affine + optional ReLU6, NHWC.
//
// Replaces the TPU kernel idc_models_tpu/ops/fused_conv.py::_kernel
// (reached through _pallas_impl / fused_depthwise_affine): a TF-SAME
// kh x kw depthwise multiply-accumulate in f32 at stride sh x sw, then
// y * mul + add (the batchnorm is folded into mul/add outside, by
// fold_bn), then an optional clamp to [0, 6], stored in x's dtype.
//
// Bound on an H100: memory. A depthwise conv does 2*kh*kw + 3 operations
// per output element and has no channel contraction, so at 9 taps the
// work is ~21 f32 operations per output against 4-8 bytes of x and y --
// far below the card's ridge point. The least traffic is x read once,
// y written once, plus (kh*kw*C + 2*C)*4 bytes of weights and affine.
// ops/fused_conv.py::depthwise_chain_cost counts 65.4 MB for the 17 calls
// of one MobileNetV2 forward at batch 32 and 50x50 patches (about 19.5 us
// at the data-sheet 3.35 TB/s of the H100 SXM), and 8.33 GB at batch
// 4096 (about 2.49 ms). At batch 32 each call moves only 0.1-2 MB, so
// the 17 launches are bound by launch latency, not bytes.
//
// What the design does about the bound: TF-SAME padding is a bounds
// check in the kernel, so no padded copy of x is ever written (the TPU
// kernel materialised one, because a BlockSpec cannot express a halo);
// the conv, the affine and the clamp happen in registers, so x is read
// from device memory once (neighbouring taps of one output hit L1/L2)
// and y is written once, with nothing in between.
//
// Layout: one thread per output element (n, ho, wo, c), with c fastest,
// so the 32 threads of a warp read 32 neighbouring channels of one
// pixel -- coalesced NHWC loads and stores. The taps are summed in the
// reference's (i, j) order with explicitly rounded multiply and add
// (no fused multiply-add), so the result equals the plain PyTorch taps
// version (ops/fused_conv.py::reference_impl) operation for operation.
// Index arithmetic is 32-bit whenever the output has fewer than ~2^30
// elements (every MobileNetV2 shape up to batch 4096 does); 64-bit
// division is a long instruction sequence on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename I>
__global__ void fused_depthwise_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ mul, const float* __restrict__ add,
    T* __restrict__ y, I total, int H, int W, int C, int Ho, int Wo,
    int kh, int kw, int sh, int sw, int pad_top, int pad_left, int clamp6) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += step) {
    const int c = (int)(idx % C);
    I r = idx / C;
    const int wo = (int)(r % Wo);
    r /= Wo;
    const int ho = (int)(r % Ho);
    const I n = r / Ho;
    const int h0 = ho * sh - pad_top;
    const int w0 = wo * sw - pad_left;
    const T* xn = x + n * ((I)H * W * C) + c;
    float acc = 0.0f;
    for (int i = 0; i < kh; ++i) {
      const int hi = h0 + i;
      if (hi < 0 || hi >= H) continue;
      for (int j = 0; j < kw; ++j) {
        const int wi = w0 + j;
        if (wi < 0 || wi >= W) continue;
        const float xv = load_f32(xn + ((I)hi * W + wi) * C);
        acc = __fadd_rn(acc, __fmul_rn(xv, w[(i * kw + j) * C + c]));
      }
    }
    float v = __fadd_rn(__fmul_rn(acc, mul[c]), add[c]);
    if (clamp6) {
      // comparisons, not fminf/fmaxf: a NaN must pass through, as it
      // does through torch.clamp, so a diverged step stays visible
      v = v < 0.0f ? 0.0f : v;
      v = v > 6.0f ? 6.0f : v;
    }
    store_f32(y + idx, v);
  }
}

template <typename T, typename I>
void launch(const void* x, const void* w, const void* mul, const void* add,
            void* y, int64_t total, int H, int W, int C, int Ho, int Wo,
            int kh, int kw, int sh, int sw, int pad_top, int pad_left,
            int clamp6, cudaStream_t s) {
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;  // grid-stride
  fused_depthwise_kernel<T, I><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<T*>(y), (I)total, H, W, C, Ho, Wo, kh, kw, sh, sw,
      pad_top, pad_left, clamp6);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y); w, mul, add are float32.
// w is [kh, kw, 1, C] flattened; x is [n, H, W, C] and y [n, Ho, Wo, C],
// both contiguous. Launches on `stream` and returns cudaGetLastError().
int fused_depthwise_forward(const void* x, const void* w, const void* mul,
                            const void* add, void* y, int dtype, int64_t n,
                            int H, int W, int C, int Ho, int Wo, int kh,
                            int kw, int sh, int sw, int pad_top,
                            int pad_left, int clamp6, void* stream) {
  const int64_t total = n * Ho * Wo * C;
  const int64_t in_total = n * H * W * C;
  if (total == 0) return 0;
  // 32-bit only where idx + grid stride cannot overflow (both stay
  // below total + 256, so 2 * total + 512 must fit) and every input
  // offset fits
  const bool narrow = total < ((int64_t)1 << 30) - 512 &&
                      in_total < ((int64_t)1 << 31) - 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && narrow) {
    launch<float, int32_t>(x, w, mul, add, y, total, H, W, C, Ho, Wo, kh, kw,
                           sh, sw, pad_top, pad_left, clamp6, s);
  } else if (dtype == 0) {
    launch<float, int64_t>(x, w, mul, add, y, total, H, W, C, Ho, Wo, kh, kw,
                           sh, sw, pad_top, pad_left, clamp6, s);
  } else if (dtype == 1 && narrow) {
    launch<__nv_bfloat16, int32_t>(x, w, mul, add, y, total, H, W, C, Ho, Wo,
                                   kh, kw, sh, sw, pad_top, pad_left, clamp6,
                                   s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, int64_t>(x, w, mul, add, y, total, H, W, C, Ho, Wo,
                                   kh, kw, sh, sw, pad_top, pad_left, clamp6,
                                   s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* fused_depthwise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
