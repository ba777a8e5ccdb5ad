// MaxPool2d(kernel 3, stride 2, padding 1) over channels-last (NHWC) memory, forward (K1)
// and backward (K2), for sm_90a.
//
// K1 replaces the forward of the TPU kernel r3m_tpu/ops/pallas_pool.py (_fwd_call /
// _fwd_kernel behind maxpool_3x3s2), which is the function that the ResNet stem computes
// at r3m_tpu/models/resnet.py:369 (max_pool_3x3s2, a lax.reduce_window). K2 replaces its
// backward (_bwd_call / _bwd_kernel).
//
// Semantics follow reduce_window and its gradient, the ops on the JAX path:
//   * odd H and W are accepted; the output is ((H-1)/2+1, (W-1)/2+1);
//   * padded positions read as -inf and are never chosen as the argmax;
//   * the argmax (0..8, window offset dh*3+dw) is the FIRST maximum in row-major window
//     order: a strict `>`, as the Pallas kernel compares (pallas_pool.py:70), which is
//     where select-and-scatter sends the gradient of reduce_window;
//   * a NaN in the window propagates to the output, and the first NaN is the argmax. The
//     Pallas kernel drops NaN; reduce_window's max keeps it, and these kernels do what
//     reduce_window does.
//
// Bound: memory. At the training shape [320,112,112,64] bf16, K1 reads 514 MB and writes
// 128 MB of output plus 64 MB of int8 argmax; K2 reads dy (128 MB) and the argmax (64 MB)
// and writes dx (514 MB). Each is 706 MB, about 0.21 ms at 3.35 TB/s; the comparisons and
// adds are far below the card's rate.
//
// K1 design: one thread per output element. Blocks walk output rows (blockIdx.x = n*OH +
// oy), and inside a row neighbouring threads take neighbouring channels, then neighbouring
// output columns, so each of the nine window loads is a contiguous, coalesced read of the
// channels_last row. The 2/3 overlap between neighbouring windows is served from L1/L2,
// so device memory sees each input byte about once. The argmax is written only when the
// caller passes a buffer for it (training).
//
// K2 design: the gather form, one thread per INPUT element (n, iy, ix, c), laid out as K1
// lays out its outputs. An input element lies in the windows of at most 2x2 outputs; the
// thread reads their argmax and dy, adds dy where the argmax names this element's offset
// in that window, and writes dx once. No atomics and no zero-fill pass; the f32 sum runs
// in window-offset order 0..8, so the plain version reproduces it bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// kArgmax is a template argument, so serving (no argmax) runs the plain max loop and
// pays for no index bookkeeping.
template <typename T, bool kArgmax>
__global__ void maxpool3x3s2_kernel(const T* __restrict__ x, T* __restrict__ y,
                                    int8_t* __restrict__ idx, int h, int w, int c, int oh,
                                    int ow) {
  const int row = blockIdx.x;  // n * oh + oy
  const int oy = row % oh;
  const int n = row / oh;
  const int per_row = ow * c;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= per_row) return;
  const int ch = i % c;
  const int ox = i / c;

  const T* xn = x + (int64_t)n * h * w * c + ch;
  float best = -INFINITY;
  int arg = -1;
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    const int iy = 2 * oy + dh - 1;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int ix = 2 * ox + dw - 1;
      if (ix < 0 || ix >= w) continue;
      const float v = load_f32(xn + ((int64_t)iy * w + ix) * c);
      if (kArgmax) {
        // The first valid position is always taken (so padding never is); after it a
        // strict `>` keeps the first maximum, and the first NaN replaces any number.
        // Once best is NaN nothing replaces it.
        if (arg < 0 || v > best || (v != v && best == best)) {
          best = v;
          arg = dh * 3 + dw;
        }
      } else if (v > best || v != v) {  // `v != v` keeps a NaN, as reduce_window does
        best = v;
      }
    }
  }
  const int64_t out = (int64_t)row * per_row + i;
  store(y + out, best);
  if (kArgmax) idx[out] = (int8_t)arg;
}

template <typename T>
__global__ void maxpool3x3s2_bwd_kernel(const int8_t* __restrict__ idx,
                                        const T* __restrict__ dy, T* __restrict__ dx, int h,
                                        int w, int c, int oh, int ow) {
  const int row = blockIdx.x;  // n * h + iy
  const int iy = row % h;
  const int n = row / h;
  const int per_row = w * c;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= per_row) return;
  const int ch = i % c;
  const int ix = i / c;

  float acc = 0.f;
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    const int ty = iy + 1 - dh;  // 2 * oy for the output whose window row dh is iy
    if (ty < 0 || (ty & 1)) continue;
    const int oy = ty >> 1;
    if (oy >= oh) continue;
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int tx = ix + 1 - dw;
      if (tx < 0 || (tx & 1)) continue;
      const int ox = tx >> 1;
      if (ox >= ow) continue;
      const int64_t o = (((int64_t)n * oh + oy) * ow + ox) * c + ch;
      if (idx[o] == dh * 3 + dw) acc += load_f32(dy + o);
    }
  }
  store(dx + (int64_t)row * per_row + i, acc);
}

constexpr int kThreads = 256;

template <typename T>
cudaError_t launch(const void* x, void* y, void* idx, int n, int h, int w, int c,
                   cudaStream_t stream) {
  const int oh = (h - 1) / 2 + 1;
  const int ow = (w - 1) / 2 + 1;
  const dim3 grid(n * oh, (ow * c + kThreads - 1) / kThreads);
  if (idx != nullptr) {
    maxpool3x3s2_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<int8_t*>(idx), h, w, c,
        oh, ow);
  } else {
    maxpool3x3s2_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), nullptr, h, w, c, oh, ow);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* idx, const void* dy, void* dx, int n, int h, int w, int c,
                       cudaStream_t stream) {
  const int oh = (h - 1) / 2 + 1;
  const int ow = (w - 1) / 2 + 1;
  const dim3 grid(n * h, (w * c + kThreads - 1) / kThreads);
  maxpool3x3s2_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(idx), static_cast<const T*>(dy), static_cast<T*>(dx), h, w,
      c, oh, ow);
  return cudaGetLastError();
}

}  // namespace

// x: [n, h, w, c]; y: [n, oh, ow, c]; idx: int8 [n, oh, ow, c] or null (no argmax).
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch (0 on success).
extern "C" int r3m_maxpool3x3s2(const void* x, void* y, void* idx, int n, int h, int w,
                                int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, idx, n, h, w, c, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, idx, n, h, w, c, s);
  return cudaErrorInvalidValue;
}

// idx: int8 [n, oh, ow, c] from r3m_maxpool3x3s2; dy: [n, oh, ow, c]; dx: [n, h, w, c],
// every element written. dtype as above, for dy and dx.
extern "C" int r3m_maxpool3x3s2_bwd(const void* idx, const void* dy, void* dx, int n, int h,
                                    int w, int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(idx, dy, dx, n, h, w, c, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(idx, dy, dx, n, h, w, c, s);
  return cudaErrorInvalidValue;
}
