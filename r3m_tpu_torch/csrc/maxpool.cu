// MaxPool2d(kernel 3, stride 2, padding 1) over channels-last (NHWC) memory, for sm_90a.
//
// Replaces the forward of the TPU kernel r3m_tpu/ops/pallas_pool.py (_fwd_call /
// _fwd_kernel behind maxpool_3x3s2), which is the function that the ResNet stem computes
// at r3m_tpu/models/resnet.py:639 (max_pool_3x3s2, a lax.reduce_window).
//
// Semantics follow reduce_window, the op on the JAX serving path:
//   * odd H and W are accepted; the output is ((H-1)/2+1, (W-1)/2+1);
//   * padded positions read as -inf;
//   * a NaN in the window propagates. The Pallas kernel compares with a strict `>` and so
//     drops NaN; reduce_window's max keeps it, and this kernel does what reduce_window does.
//   The maximum itself is exact, so ties cannot change the value written. The argmax that
//   the Pallas forward also emits feeds only its backward and is left for the backward's
//   port.
//
// Bound: memory. The stem at [256,112,112,64] bf16 reads 411 MB and writes 103 MB, about
// 0.15 ms at 3.35 TB/s; the nine comparisons per output are far below the card's rate.
//
// Design: one thread per output element. Blocks walk output rows (blockIdx.x = n*OH + oy),
// and inside a row neighbouring threads take neighbouring channels, then neighbouring
// output columns, so each of the nine window loads is a contiguous, coalesced read of the
// channels_last row. The 2/3 overlap between neighbouring windows is served from L1/L2,
// so device memory sees each input byte about once.

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
  *p = __float2bfloat16(v);  // exact: v is one of the inputs
}

template <typename T>
__global__ void maxpool3x3s2_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w,
                                    int c, int oh, int ow) {
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
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    const int iy = 2 * oy + dh - 1;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int ix = 2 * ox + dw - 1;
      if (ix < 0 || ix >= w) continue;
      const float v = load_f32(xn + ((int64_t)iy * w + ix) * c);
      // `v != v` keeps a NaN, as reduce_window's max does; once best is NaN no `>` holds.
      if (v > best || v != v) best = v;
    }
  }
  store(y + (int64_t)row * per_row + i, best);
}

template <typename T>
cudaError_t launch(const void* x, void* y, int n, int h, int w, int c, cudaStream_t stream) {
  const int oh = (h - 1) / 2 + 1;
  const int ow = (w - 1) / 2 + 1;
  const int threads = 256;
  const dim3 grid(n * oh, (ow * c + threads - 1) / threads);
  maxpool3x3s2_kernel<T><<<grid, threads, 0, stream>>>(static_cast<const T*>(x),
                                                       static_cast<T*>(y), h, w, c, oh, ow);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch (0 on success).
extern "C" int r3m_maxpool3x3s2(const void* x, void* y, int n, int h, int w, int c, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n, h, w, c, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, h, w, c, s);
  return cudaErrorInvalidValue;
}
