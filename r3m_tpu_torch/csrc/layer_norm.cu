// LayerNorm over the last axis of rows [R, D], forward and backward, for sm_90a: the
// port's `layer_norm` (r3m_tpu_torch/models/layers.py) on the card.
//
// It replaces no TPU kernel. The JAX LayerNorm (r3m_tpu/models/layers.py:17) is a
// composition that XLA fuses into one pass over the rows; the port's eager composition
// (`layer_norm_reference` in r3m_tpu_torch/ops/layer_norm.py) runs ~11 ATen kernels over
// f32 copies of the rows instead, and autograd keeps three of those copies for the
// backward. These kernels are its counterpart of XLA's fusion, with the same law:
//
//   * statistics in f32: the mean is the f32 sum of the row over D, the variance the
//     two-pass mean((x - mean)^2) over the values the thread holds (not E[x^2] - mean^2);
//   * y = (x - mean) * rstd * weight + bias in f32, each product and sum rounded as the
//     composition rounds it (__fmul_rn, __fadd_rn: no contraction into an FMA), and one
//     rounding to x's dtype at the store; weight and bias are f32 whatever x's dtype;
//   * dx = rstd * (g*w - mean(g*w) - xhat * mean(g*w*xhat)) in f32 from x, the saved mean
//     and rstd, rounded once; dw = sum over rows of g*xhat and db = sum of g, in f32.
//
// Bound: memory. The forward reads x and writes y (DINOv2-g/14's request of 256 frames,
// [66816, 1536] bf16: 411 MB, 0.123 ms at 3.35 TB/s); the backward reads x and g and writes
// dx (ViT-B/32's step, [16000, 768] bf16: 74 MB, 0.022 ms). What the design does about it:
//
//   * A row is read once, in 16-byte vectors (8 bf16 or 4 f32; one element a load where D,
//     the row stride or a pointer does not allow them), into registers, by a group of
//     threads: in the forward at most 4 vectors a thread, so one warp a row up to 128
//     vectors (ViT-B/32's D = 768 in bf16: 3 vectors, 24 values a lane), several warps a row
//     past that (DINOv2-g/14's 1536: two warps, 3 vectors a lane), several rows a warp for
//     narrow ones; in the backward, which also holds g, at most 2 vectors a thread. The
//     group is a power of two chosen from D (`row_group`), so one kernel
//     adapts to every width; the vectors a thread holds (CAP) are a template parameter, so
//     they stay in registers. Why 4: at 6 vectors a lane (one warp a row at D = 1536) the
//     forward took 104 registers, two blocks an SM, and DINOv2's request 0.223 ms a call,
//     against 0.185 ms at two warps a row; launch bounds that cap the registers spill.
//   * The row's sums go through warp shuffles, and between the warps of a wide row through
//     shared memory in warp order, so every thread of a row holds the same bits.
//   * The forward's grid covers the rows once. weight and bias are read through L1, from
//     L2 once a block.
//   * The backward's blocks are persistent (as many as the card holds at once) and walk the
//     rows; each thread keeps f32 partial sums of dw and db for its columns in registers.
//     A block adds its rows' partials in shared memory in row order and writes one row of
//     a [blocks, 2, D] f32 workspace; a second kernel (`layer_norm_colsum_kernel`) sums
//     that workspace's columns in a fixed order. No atomics: two runs are bit-equal.
//   * Nothing but the rows' mean and rstd ([R] f32 each) is kept for the backward: no f32
//     copy of x and no xhat.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;       // a block, but where one row of the backward takes more
constexpr int kBwdMaxThreads = 512; // threads of a backward row, at most
constexpr int kFwdCap = 4;          // vectors a thread of the forward holds, at most
constexpr int kBwdCap = 2;          // the same for the backward, which also holds g
constexpr int kMaxVectors = 1024;   // vectors (or elements) of a row, at most
constexpr int kColThreads = 1024;   // the column sum: 32 columns by 32 slices of rows

constexpr int kTooWide = -2;        // D is more than a row's vectors the kernels hold
constexpr int kNeedsWorkspace = -3; // the backward's workspace is too small: see `need`

// bfloat16 as its 16 bits, widened to f32 exactly by a shift. (As `__nv_bfloat16`, arrays
// of single elements took a stack frame in the backward's one-element path.)
struct bf16_t {
  unsigned short bits;
};

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_t v) {
  return __uint_as_float((uint32_t)v.bits << 16);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (kF32<T>) {
    return v;
  } else {
    return bf16_t{__bfloat16_as_ushort(__float2bfloat16_rn(v))};
  }
}

// V consecutive f32 values of weight or bias, as 16-byte loads where V allows.
template <int V>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&out)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + i));
      out[i] = f.x, out[i + 1] = f.y, out[i + 2] = f.z, out[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = __ldg(p + i);
  }
}

// The sums of v over the `group` threads of a row (a power of two, the same for the whole
// block): shuffles inside a warp, then, where a row takes several warps, through `red`
// (a float2 a warp of the block) in warp order. Every thread of the block calls it, and
// every thread of a row gets the same bits (each shuffle step adds the same two values in
// either order).
__device__ __forceinline__ float2 row_sum(float2 v, int group, float2* red) {
  const int width = group < 32 ? group : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < width) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
  }
  if (group <= 32) return v;
  const int warps = group / 32;
  const int warp = threadIdx.x / 32, first = warp & ~(warps - 1);
  __syncthreads();  // the previous call's reads of `red` are done
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float2 s = red[first];
  for (int i = 1; i < warps; ++i) s.x += red[first + i].x, s.y += red[first + i].y;
  return s;
}

// y = (x - mean) * rstd * weight + bias for rows [rows, d] of row stride ldx (y contiguous);
// each row's mean and rstd to `mean` and `rstd` where given. `group` threads a row, each
// holding vectors t, t + group, ... of it, at most CAP of them.
template <typename T, int V, int CAP>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, int64_t ldx, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd, int64_t rows,
                      int d, int group, float eps) {
  __shared__ float2 red[kThreads / 32];
  const int t = threadIdx.x % group;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  const bool live = row < rows;
  const int nvec = d / V;
  const T* xr = x + row * ldx;

  Vec<T, V> v[CAP];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    const int c = t + j * group;
    if (live && c < nvec) {
      v[j] = *reinterpret_cast<const Vec<T, V>*>(xr + c * V);
#pragma unroll
      for (int e = 0; e < V; ++e) s += to_f32(v[j].e[e]);
    }
  }
  const float mu = row_sum(make_float2(s, 0.f), group, red).x / d;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    if (live && t + j * group < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float dev = to_f32(v[j].e[e]) - mu;
        q += dev * dev;
      }
    }
  }
  const float var = row_sum(make_float2(q, 0.f), group, red).x / d;
  const float r = 1.f / sqrtf(var + eps);
  if (!live) return;
  T* yr = y + row * d;
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    const int c = t + j * group;
    if (c < nvec) {
      float wv[V], bv[V];
      load_f32<V>(w + c * V, wv);
      load_f32<V>(b + c * V, bv);
      Vec<T, V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = __fmul_rn(__fsub_rn(to_f32(v[j].e[e]), mu), r);
        out.e[e] = from_f32<T>(__fadd_rn(__fmul_rn(xhat, wv[e]), bv[e]));
      }
      *reinterpret_cast<Vec<T, V>*>(yr + c * V) = out;
    }
  }
  if (t == 0 && mean != nullptr) {
    mean[row] = mu;
    rstd[row] = r;
  }
}

// dx for rows [rows, d] (g and dx contiguous, x of row stride ldx), and each block's partial
// sums of dw and db, [gridDim.x, 2, d] in `partial`. The blocks (of kThreads threads, or of
// one row's `group` where that is more) walk the rows; the shared memory holds the block's
// rows' partials, [blockDim.x / group, 2, d], where a block holds more than one row.
template <typename T, int V, int CAP>
__global__ void __launch_bounds__(kBwdMaxThreads)
layer_norm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x, int64_t ldx,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ w, T* __restrict__ dx,
                      float* __restrict__ partial, int64_t rows, int d, int group) {
  extern __shared__ float rows_part[];
  __shared__ float2 red[kBwdMaxThreads / 32];
  const int t = threadIdx.x % group, slot = threadIdx.x / group;
  const int per_block = blockDim.x / group;
  const int nvec = d / V;
  const float inv_d = 1.f / d;

  float dw[CAP][V], db[CAP][V];
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
#pragma unroll
    for (int e = 0; e < V; ++e) dw[j][e] = 0.f, db[j][e] = 0.f;
  }

  // the loop's bounds are the block's, so every thread reaches `row_sum` as often
  for (int64_t base = (int64_t)blockIdx.x * per_block; base < rows;
       base += (int64_t)gridDim.x * per_block) {
    const int64_t row = base + slot;
    const bool live = row < rows;
    const float mu = live ? mean[row] : 0.f, r = live ? rstd[row] : 0.f;
    Vec<T, V> gv[CAP], xv[CAP];
    float a = 0.f, c = 0.f;  // the row's sums of g*w and g*w*xhat
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      const int cv = t + j * group;
      if (live && cv < nvec) {
        gv[j] = *reinterpret_cast<const Vec<T, V>*>(g + row * d + cv * V);
        xv[j] = *reinterpret_cast<const Vec<T, V>*>(x + row * ldx + cv * V);
        float wv[V];
        load_f32<V>(w + cv * V, wv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float gy = to_f32(gv[j].e[e]);
          const float xhat = (to_f32(xv[j].e[e]) - mu) * r;
          const float gw = gy * wv[e];
          a += gw;
          c += gw * xhat;
          dw[j][e] += gy * xhat;
          db[j][e] += gy;
        }
      }
    }
    const float2 sums = row_sum(make_float2(a, c), group, red);
    a = sums.x * inv_d;
    c = sums.y * inv_d;
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      const int cv = t + j * group;
      if (live && cv < nvec) {
        float wv[V];
        load_f32<V>(w + cv * V, wv);
        Vec<T, V> out;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = (to_f32(xv[j].e[e]) - mu) * r;
          const float gw = to_f32(gv[j].e[e]) * wv[e];
          out.e[e] = from_f32<T>(r * (gw - a - xhat * c));
        }
        *reinterpret_cast<Vec<T, V>*>(dx + row * d + cv * V) = out;
      }
    }
  }

  float* out = partial + (int64_t)blockIdx.x * 2 * d;
  float* mine = per_block == 1 ? out : rows_part + slot * 2 * d;
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    const int cv = t + j * group;
    if (cv < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        mine[cv * V + e] = dw[j][e];
        mine[d + cv * V + e] = db[j][e];
      }
    }
  }
  if (per_block == 1) return;
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * d; i += blockDim.x) {
    float s = rows_part[i];
    for (int k = 1; k < per_block; ++k) s += rows_part[k * 2 * d + i];
    out[i] = s;
  }
}

// dw and db from the backward's [blocks, 2, d] partial sums: each column summed over the
// blocks by 32 slices of rows in row order, then the slices in slice order.
__global__ void __launch_bounds__(kColThreads)
layer_norm_colsum_kernel(const float* __restrict__ partial, int blocks, int d,
                         float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float acc[kColThreads / 32][32];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int slices = kColThreads / 32;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < 2 * d) {
#pragma unroll 4
    for (int k = slice; k < blocks; k += slices) s += partial[(int64_t)k * 2 * d + col];
  }
  acc[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && col < 2 * d) {
    float total = acc[0][lane];
    for (int k = 1; k < slices; ++k) total += acc[k][lane];
    if (col < d) {
      dw[col] = total;
    } else {
      db[col - d] = total;
    }
  }
}

int ceil_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

int ceil_div(int64_t n, int64_t k) { return (int)((n + k - 1) / k); }

// The threads a row: the fewest that hold it in `cap` vectors a thread, but at least one
// warp while the row has 32 vectors (fewer, several rows a warp, for a narrower row).
int row_group(int nvec, int cap) {
  if (nvec <= 32 * cap) return nvec < 32 ? ceil_pow2(nvec) : 32;
  return ceil_pow2(ceil_div(nvec, cap));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Switches the calling thread to `device` for the launches, and back (PyTorch's autograd
// thread may run the backward with another device current).
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : device_(device) {
    cudaGetDevice(&previous_);
    if (previous_ != device) cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (previous_ != device_) cudaSetDevice(previous_);
  }

 private:
  int device_;
  int previous_ = 0;
};

template <typename T, int V>
int launch_fwd(const T* x, int64_t ldx, const float* w, const float* b, T* y, float* mean,
               float* rstd, int64_t rows, int d, float eps, cudaStream_t stream) {
  const int nvec = d / V;
  if (nvec > kMaxVectors) return kTooWide;
  const int group = row_group(nvec, kFwdCap);  // at most kThreads for kMaxVectors
  const int cap = ceil_pow2(ceil_div(nvec, group));
  const int grid = ceil_div(rows, kThreads / group);
  if (cap == 1) {
    layer_norm_fwd_kernel<T, V, 1><<<grid, kThreads, 0, stream>>>(
        x, ldx, w, b, y, mean, rstd, rows, d, group, eps);
  } else if (cap == 2) {
    layer_norm_fwd_kernel<T, V, 2><<<grid, kThreads, 0, stream>>>(
        x, ldx, w, b, y, mean, rstd, rows, d, group, eps);
  } else {
    layer_norm_fwd_kernel<T, V, kFwdCap><<<grid, kThreads, 0, stream>>>(
        x, ldx, w, b, y, mean, rstd, rows, d, group, eps);
  }
  return cudaGetLastError();
}

template <typename T, int V, int CAP>
int launch_bwd_cap(const T* g, const T* x, int64_t ldx, const float* mean, const float* rstd,
                   const float* w, T* dx, float* dw, float* db, float* work,
                   size_t work_bytes, size_t* need, int64_t rows, int d, int group,
                   int device, cudaStream_t stream) {
  const int threads = group > kThreads ? group : kThreads;
  const int per_block = threads / group;
  const size_t smem = per_block > 1 ? (size_t)per_block * 2 * d * sizeof(float) : 0;
  int sms = 0, resident = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, layer_norm_bwd_kernel<T, V, CAP>, threads, smem);
  int blocks = ceil_div(rows, per_block);
  const int held = sms * (resident > 0 ? resident : 1);
  if (blocks > held) blocks = held;
  *need = (size_t)blocks * 2 * d * sizeof(float);
  if (work_bytes < *need) return kNeedsWorkspace;
  layer_norm_bwd_kernel<T, V, CAP><<<blocks, threads, smem, stream>>>(
      g, x, ldx, mean, rstd, w, dx, work, rows, d, group);
  layer_norm_colsum_kernel<<<ceil_div(2 * d, 32), kColThreads, 0, stream>>>(
      work, blocks, d, dw, db);
  return cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const T* g, const T* x, int64_t ldx, const float* mean, const float* rstd,
               const float* w, T* dx, float* dw, float* db, float* work, size_t work_bytes,
               size_t* need, int64_t rows, int d, int device, cudaStream_t stream) {
  const int nvec = d / V;
  if (nvec > kMaxVectors) return kTooWide;
  const int group = row_group(nvec, kBwdCap);  // at most kBwdMaxThreads for kMaxVectors
  if (nvec <= group) {
    return launch_bwd_cap<T, V, 1>(g, x, ldx, mean, rstd, w, dx, dw, db, work, work_bytes,
                                   need, rows, d, group, device, stream);
  }
  return launch_bwd_cap<T, V, kBwdCap>(g, x, ldx, mean, rstd, w, dx, dw, db, work,
                                       work_bytes, need, rows, d, group, device, stream);
}

// 16-byte vectors where D, the row stride and every pointer allow them; one element a load
// otherwise.
template <typename T>
int fwd(const void* x, int64_t ldx, const float* w, const float* b, void* y, float* mean,
        float* rstd, int64_t rows, int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (d % V == 0 && ldx % V == 0 && aligned16(x) && aligned16(y) && aligned16(w) &&
      aligned16(b)) {
    return launch_fwd<T, V>(xt, ldx, w, b, yt, mean, rstd, rows, d, eps, stream);
  }
  return launch_fwd<T, 1>(xt, ldx, w, b, yt, mean, rstd, rows, d, eps, stream);
}

template <typename T>
int bwd(const void* g, const void* x, int64_t ldx, const float* mean, const float* rstd,
        const float* w, void* dx, float* dw, float* db, float* work, size_t work_bytes,
        size_t* need, int64_t rows, int d, int device, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  if (d % V == 0 && ldx % V == 0 && aligned16(g) && aligned16(x) && aligned16(dx) &&
      aligned16(w)) {
    return launch_bwd<T, V>(gt, xt, ldx, mean, rstd, w, dxt, dw, db, work, work_bytes, need,
                            rows, d, device, stream);
  }
  return launch_bwd<T, 1>(gt, xt, ldx, mean, rstd, w, dxt, dw, db, work, work_bytes, need,
                          rows, d, device, stream);
}

}  // namespace

// x: [rows, d] of row stride ldx (unit stride along a row); w, b: f32 [d]; y: [rows, d]
// contiguous; mean, rstd: f32 [rows], or null (not written). dtype: 0 = float32,
// 1 = bfloat16, of x and y. Returns 0, the cudaError_t of the launch, or -2 where a row is
// more than the kernel holds (1,024 16-byte vectors, or 1,024 elements off the vector path).
extern "C" int r3m_layer_norm_fwd(const void* x, int64_t ldx, const float* w, const float* b,
                                  void* y, float* mean, float* rstd, int64_t rows, int64_t d,
                                  float eps, int dtype, int device, void* stream) {
  if (d > kMaxVectors * 8) return kTooWide;
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, ldx, w, b, y, mean, rstd, rows, (int)d, eps, s);
  if (dtype == 1) {
    return fwd<bf16_t>(x, ldx, w, b, y, mean, rstd, rows, (int)d, eps, s);
  }
  return cudaErrorInvalidValue;
}

// g, dx: [rows, d] contiguous, x as the forward's, mean and rstd the forward's; w: f32 [d];
// dw, db: f32 [d]. `work` holds the backward's partial sums: where `work_bytes` is less
// than they need, nothing is launched, `*need` is set and -3 returned. Otherwise as
// `r3m_layer_norm_fwd`.
extern "C" int r3m_layer_norm_bwd(const void* g, const void* x, int64_t ldx,
                                  const float* mean, const float* rstd, const float* w,
                                  void* dx, float* dw, float* db, float* work,
                                  size_t work_bytes, size_t* need, int64_t rows, int64_t d,
                                  int dtype, int device, void* stream) {
  if (d > kMaxVectors * 8) return kTooWide;
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return bwd<float>(g, x, ldx, mean, rstd, w, dx, dw, db, work, work_bytes, need, rows,
                      (int)d, device, s);
  }
  if (dtype == 1) {
    return bwd<bf16_t>(g, x, ldx, mean, rstd, w, dx, dw, db, work, work_bytes, need,
                              rows, (int)d, device, s);
  }
  return cudaErrorInvalidValue;
}
