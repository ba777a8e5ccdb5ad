// MaxPool2d(kernel 3, stride 2, padding 1) over channels-last (NHWC) memory, forward (K1)
// and backward (K2), for sm_90a.
//
// K1 replaces the forward of the TPU kernel r3m_tpu/ops/pallas_pool.py:109 (_fwd_call /
// _fwd_kernel behind maxpool_3x3s2), which is the function that the ResNet stem computes
// at r3m_tpu/models/resnet.py:369 (max_pool_3x3s2, a lax.reduce_window). K2 replaces its
// backward, pallas_pool.py:130 (_bwd_call / _bwd_kernel).
//
// Semantics follow reduce_window and its gradient, the ops on the JAX path:
//   * odd H and W are accepted; the output is ((H-1)/2+1, (W-1)/2+1);
//   * padded positions read as -inf and are never chosen as the argmax;
//   * the argmax (0..8, window offset dh*3+dw, int8 [N,OH,OW,C]) is the FIRST maximum in
//     row-major window order: a strict `>`, as the Pallas kernel compares
//     (pallas_pool.py:70), which is where select-and-scatter sends the gradient of
//     reduce_window;
//   * a NaN in the window propagates to the output, and the first NaN is the argmax. The
//     Pallas kernel drops NaN; reduce_window's max keeps it, and these kernels do what
//     reduce_window does;
//   * K2 adds each input element's contributions in f32 in window-offset order 0..8 and
//     rounds once, so it matches its plain version bit for bit.
//
// Bound: memory. At the training shape [320,112,112,64] bf16, K1 reads 514 MB and writes
// 128 MB of output plus 64 MB of int8 argmax; K2 reads dy (128 MB) and the argmax (64 MB)
// and writes dx (514 MB). Each is 706 MB, 0.21 ms at 3.35 TB/s (f32: 1,349 MB, 0.40 ms).
// The comparisons and adds are far below the card's rate, so what the design has to do is
// keep enough bytes in flight with few instructions per byte:
//
//   * Channels are the vector axis. A thread moves 16 bytes of channels per access (8 bf16
//     or 4 f32) and their argmax as one 8- or 4-byte word. Where C * sizeof(T) is not a
//     multiple of 16, or a pointer is not 16-byte aligned (C = 3, a view with a storage
//     offset), the same template runs with one element per access (the narrow path).
//   * K1 as a strip: a thread computes two neighbouring outputs along W for one channel
//     vector. It issues all 15 loads of the 3 x 5 input window (the column 2ox+1 that the
//     two windows share is read once) before its first comparison. Serving (no argmax)
//     takes the NaN-propagating max.NaN of packed bf16x2 or f32 words; under grad the
//     comparisons run in f32 (exact for bf16) with the strict `>` that picks the argmax.
//   * K2 in the owner form, scatter-free: output pixel (oy, ox) owns input pixels
//     (2oy..2oy+1, 2ox..2ox+1), which tile the input exactly (cut at odd H or W). A thread
//     reads the argmax and dy of the four outputs whose windows reach its block, (oy, ox),
//     (oy, ox+1), (oy+1, ox) and (oy+1, ox+1), and writes its four dx vectors once: no
//     atomics, no zero fill, and device memory sees dy and the argmax about once (the
//     neighbours' re-reads hit L1/L2) and dx written once.
//   * Blocks walk output rows (blockIdx.y = n * OH + oy); inside a row, neighbouring threads
//     take neighbouring channel vectors, then neighbouring strips (K1) or owner blocks (K2),
//     so every warp access is whole 128-byte lines of the channels_last rows. Indices are
//     32-bit within a row (divisions by the magic-number FastDiv), 64-bit only for a row's
//     base.
//
// With 15 (K1) or 8 (K2) independent 16-byte loads a thread and 3 to 7 blocks an SM, far
// more bytes are in flight than the memory's latency needs, and L1/L2 serve the re-reads
// of shared window columns and rows. A persistent-block variant that brought each tile of
// output rows into a two-stage shared-memory ring by TMA bulk copies (cp.async.bulk with
// an mbarrier) was slower at every training and serving shape on the H100 (PERF.md),
// so these kernels read device memory directly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// bfloat16 as its 16 bits: the kernels never compute in bf16, they move its bits and widen
// them to f32 exactly.
struct bf16_t {
  unsigned short bits;
};

// n / d and n % d for 0 <= n < 2^31 with a multiply-high and a shift (the round-up method
// PyTorch's IntDivider uses); the magic numbers are found once on the host.
struct FastDiv {
  uint32_t d, m, s;
  FastDiv() = default;
  explicit FastDiv(uint32_t divisor) : d(divisor), s(0) {
    while ((1u << s) < d && s < 31) ++s;
    m = (uint32_t)((((uint64_t)1 << 32) * (((uint64_t)1 << s) - d)) / d + 1);
  }
  __device__ __forceinline__ void divmod(uint32_t n, int& q, int& r) const {
    const uint32_t t = __umulhi(n, m);
    q = (int)((t + n) >> s);
    r = (int)(n - (uint32_t)q * d);
  }
};

struct PoolShape {
  int h, w, c, oh, ow;
  int wc, owc;         // elements in an input row and in an output row
  FastDiv by_vecs;     // c / V: channel vectors per pixel
  FastDiv by_oh;
};

// V elements of T, moved as one access of V * sizeof(T) bytes (16 on the vector path),
// kept as 32-bit words: bf16 element e is the low (even e) or high half of word e / 2.
template <typename T, int V>
struct Pack {
  static constexpr int kBytes = V * (int)sizeof(T);
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  uint32_t w[kWords];
};

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  Pack<T, V> r;
  if constexpr (Pack<T, V>::kBytes == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = u.x, r.w[1] = u.y, r.w[2] = u.z, r.w[3] = u.w;
  } else if constexpr (Pack<T, V>::kBytes == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    static_assert(Pack<T, V>::kBytes == 2, "16-byte vectors or single elements");
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& r) {
  if constexpr (Pack<T, V>::kBytes == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else if constexpr (Pack<T, V>::kBytes == 4) {
    *reinterpret_cast<unsigned int*>(p) = r.w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)r.w[0];
  }
}

// Element e as f32 (exact for bf16).
template <typename T, int V>
__device__ __forceinline__ float elem(const Pack<T, V>& p, int e) {
  if constexpr (kF32<T>) {
    return __uint_as_float(p.w[e]);
  } else {
    const uint32_t w = p.w[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// The bf16 word of elements 2k and 2k+1 from their f32 values: the high halves, exact for
// values that came from bf16.
__device__ __forceinline__ uint32_t bf16_pair_bits(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Pack from V f32 values: kRound rounds to bf16 to nearest even, as torch's .to(bfloat16)
// does (K2's sums), else the high halves are kept (K1's maxima, bf16 values already).
template <typename T, int V, bool kRound>
__device__ __forceinline__ Pack<T, V> pack_from(const float* f) {
  Pack<T, V> r;
#pragma unroll
  for (int k = 0; k < Pack<T, V>::kWords; ++k) {
    if constexpr (kF32<T>) {
      r.w[k] = __float_as_uint(f[k]);
    } else {
      const float lo = f[2 * k], hi = 2 * k + 1 < V ? f[2 * k + 1] : 0.f;
      if constexpr (kRound) {
        asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r.w[k]) : "f"(hi), "f"(lo));
      } else {
        r.w[k] = bf16_pair_bits(lo, hi);
      }
    }
  }
  return r;
}

// The NaN-propagating max of two packs, word by word (max of bf16 values is exact).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> vmax(const Pack<T, V>& a, const Pack<T, V>& b) {
  Pack<T, V> r;
#pragma unroll
  for (int k = 0; k < Pack<T, V>::kWords; ++k) {
    if constexpr (kF32<T>) {
      asm("max.NaN.f32 %0, %1, %2;" : "=r"(r.w[k]) : "r"(a.w[k]), "r"(b.w[k]));
    } else {
      asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r.w[k]) : "r"(a.w[k]), "r"(b.w[k]));
    }
  }
  return r;
}

// V int8 argmax values as one access of V bytes.
template <int V>
struct IdxPack {
  static constexpr int kWords = V >= 4 ? V / 4 : 1;
  uint32_t w[kWords];
  __device__ __forceinline__ int get(int e) const { return (w[e >> 2] >> (8 * (e & 3))) & 0xff; }
};

template <int V>
__device__ __forceinline__ IdxPack<V> load_idx(const int8_t* p) {
  IdxPack<V> r;
  if constexpr (V == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = u.x, r.w[1] = u.y;
  } else if constexpr (V == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    static_assert(V == 1, "8 bf16, 4 f32 or one element");
    r.w[0] = (uint8_t)__ldg(reinterpret_cast<const char*>(p));
  }
  return r;
}

// An absent neighbour's argmax: 0xff names no window offset.
template <int V>
__device__ __forceinline__ IdxPack<V> no_idx() {
  IdxPack<V> r;
#pragma unroll
  for (int k = 0; k < IdxPack<V>::kWords; ++k) r.w[k] = 0xffffffffu;
  return r;
}

template <int V>
__device__ __forceinline__ void store_idx(int8_t* p, const int* a) {
  uint32_t w[IdxPack<V>::kWords];
#pragma unroll
  for (int k = 0; k < IdxPack<V>::kWords; ++k) {
    w[k] = 0;
#pragma unroll
    for (int b = 0; b < 4 && 4 * k + b < V; ++b) w[k] |= (uint32_t)a[4 * k + b] << (8 * b);
  }
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<unsigned int*>(p) = w[0];
  } else {
    *p = (int8_t)w[0];
  }
}

constexpr int kMaxThreads = 256;

// K1. Thread (row, strip, channel vector): outputs (oy, 2*strip) and (oy, 2*strip + 1).
// kArgmax is a template argument, so serving (no argmax) runs the packed max alone.
template <typename T, int V, bool kArgmax>
__global__ void __launch_bounds__(kMaxThreads)
    maxpool3x3s2_kernel(const T* __restrict__ x, T* __restrict__ y, int8_t* __restrict__ idx,
                        const PoolShape s, const int row0) {
  int strip, cv;
  s.by_vecs.divmod(blockIdx.x * blockDim.x + threadIdx.x, strip, cv);
  const int ox = 2 * strip;
  if (ox >= s.ow) return;
  const int row = row0 + blockIdx.y;  // n * oh + oy
  int n, oy;
  s.by_oh.divmod(row, n, oy);
  const int ch = cv * V;
  const bool second = ox + 1 < s.ow;

  // Input rows 2oy-1 .. 2oy+1 and columns 2ox-1 .. 2ox+3: the first output's window is
  // columns 0..2 of the strip, the second's 2..4.
  bool row_ok[3], col_ok[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int ix = 2 * ox - 1 + j;
    col_ok[j] = ix >= 0 && ix < s.w;  // false for columns 3, 4 where !second
  }
  Pack<T, V> v[3][5];
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    const int iy = 2 * oy - 1 + dh;
    row_ok[dh] = iy >= 0 && iy < s.h;
    if (!row_ok[dh]) continue;
    const T* r = x + ((int64_t)n * s.h + iy) * s.wc + (2 * ox - 1) * s.c + ch;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      if (col_ok[j]) v[dh][j] = load_pack<T, V>(r + j * s.c);
    }
  }

  const int64_t out = (int64_t)row * s.owc + ox * s.c + ch;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    if (o == 1 && !second) break;
    if constexpr (kArgmax) {
      // Start from -inf at the first valid offset (the centre row and column always are):
      // then a strict `>` keeps the first maximum and the first NaN replaces any number,
      // and an all -inf window keeps its first valid offset, as the plain version does.
      float best[V];
      int arg[V];
      const int first = (row_ok[0] ? 0 : 3) + (col_ok[2 * o] ? 0 : 1);
#pragma unroll
      for (int e = 0; e < V; ++e) best[e] = -INFINITY, arg[e] = first;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          if (!(row_ok[dh] && col_ok[2 * o + dw])) continue;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float f = elem(v[dh][2 * o + dw], e);
            if (best[e] == best[e] && !(f <= best[e])) best[e] = f, arg[e] = dh * 3 + dw;
          }
        }
      }
      store_pack<T, V>(y + out + o * s.c, pack_from<T, V, false>(best));
      store_idx<V>(idx + out + o * s.c, arg);
    } else {
      Pack<T, V> m = v[1][2 * o + 1];  // the centre is always inside the input
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          if ((dh != 1 || dw != 1) && row_ok[dh] && col_ok[2 * o + dw]) {
            m = vmax(m, v[dh][2 * o + dw]);
          }
        }
      }
      store_pack<T, V>(y + out + o * s.c, m);
    }
  }
}

// K2. Thread (row, ox, channel vector) owns input pixels (2oy..2oy+1, 2ox..2ox+1).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    maxpool3x3s2_bwd_kernel(const int8_t* __restrict__ idx, const T* __restrict__ dy,
                            T* __restrict__ dx, const PoolShape s, const int row0) {
  int ox, cv;
  s.by_vecs.divmod(blockIdx.x * blockDim.x + threadIdx.x, ox, cv);
  if (ox >= s.ow) return;
  const int row = row0 + blockIdx.y;  // n * oh + oy
  int n, oy;
  s.by_oh.divmod(row, n, oy);
  const int ch = cv * V;
  const bool right = ox + 1 < s.ow, down = oy + 1 < s.oh;

  // a = (oy, ox), b = (oy, ox+1), c = (oy+1, ox), d = (oy+1, ox+1); an absent neighbour
  // names no offset, so it adds nothing.
  const int64_t o = (int64_t)row * s.owc + ox * s.c + ch;
  Pack<T, V> ga = load_pack<T, V>(dy + o), gb = ga, gc = ga, gd = ga;
  IdxPack<V> ia = load_idx<V>(idx + o), ib = no_idx<V>(), ic = no_idx<V>(), id = no_idx<V>();
  if (right) gb = load_pack<T, V>(dy + o + s.c), ib = load_idx<V>(idx + o + s.c);
  if (down) gc = load_pack<T, V>(dy + o + s.owc), ic = load_idx<V>(idx + o + s.owc);
  if (right && down) {
    gd = load_pack<T, V>(dy + o + s.owc + s.c), id = load_idx<V>(idx + o + s.owc + s.c);
  }

  // Each sum in window-offset order, as the plain version adds: (2oy, 2ox) takes k4 of a;
  // (2oy, 2ox+1) k3 of b then k5 of a; (2oy+1, 2ox) k1 of c then k7 of a; (2oy+1, 2ox+1)
  // k0 of d, k2 of c, k6 of b, then k8 of a.
  float f00[V], f01[V], f10[V], f11[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int ka = ia.get(e), kb = ib.get(e), kc = ic.get(e), kd = id.get(e);
    const float a = elem(ga, e), b = elem(gb, e), c = elem(gc, e), d = elem(gd, e);
    f00[e] = 0.f, f01[e] = 0.f, f10[e] = 0.f, f11[e] = 0.f;
    if (ka == 4) f00[e] += a;
    if (kb == 3) f01[e] += b;
    if (ka == 5) f01[e] += a;
    if (kc == 1) f10[e] += c;
    if (ka == 7) f10[e] += a;
    if (kd == 0) f11[e] += d;
    if (kc == 2) f11[e] += c;
    if (kb == 6) f11[e] += b;
    if (ka == 8) f11[e] += a;
  }
  const bool wide = 2 * ox + 1 < s.w, tall = 2 * oy + 1 < s.h;
  T* r = dx + ((int64_t)n * s.h + 2 * oy) * s.wc + 2 * ox * s.c + ch;
  store_pack<T, V>(r, pack_from<T, V, true>(f00));
  if (wide) store_pack<T, V>(r + s.c, pack_from<T, V, true>(f01));
  if (tall) {
    store_pack<T, V>(r + s.wc, pack_from<T, V, true>(f10));
    if (wide) store_pack<T, V>(r + s.wc + s.c, pack_from<T, V, true>(f11));
  }
}

constexpr int64_t kMaxGridY = 65535;

PoolShape make_shape(int h, int w, int c, int v) {
  PoolShape s;
  s.h = h, s.w = w, s.c = c;
  s.oh = (h - 1) / 2 + 1, s.ow = (w - 1) / 2 + 1;
  s.wc = w * c, s.owc = s.ow * c;
  s.by_vecs = FastDiv((uint32_t)(c / v));
  s.by_oh = FastDiv((uint32_t)s.oh);
  return s;
}

// One launch per 65,535 rows of output (one for every shape the model gives), each row's
// `per_row` threads in ceil(per_row / 256) blocks of a multiple of 32 threads, sized so
// that few threads idle at the row's end. `kernel(grid, threads, row0)` launches.
template <typename F>
cudaError_t launch_rows(int per_row, int64_t rows, F kernel) {
  const int blocks = (per_row + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((per_row + blocks - 1) / blocks + 31) / 32 * 32;
  for (int64_t r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const int64_t here = rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY;
    kernel(dim3(blocks, (unsigned)here), threads, (int)r0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

template <typename T, int V>
cudaError_t launch_fwd(const T* x, T* y, int8_t* idx, int n, int h, int w, int c,
                       cudaStream_t stream) {
  const PoolShape s = make_shape(h, w, c, V);
  const int per_row = (s.ow + 1) / 2 * (c / V);
  return launch_rows(per_row, (int64_t)n * s.oh, [&](dim3 grid, int threads, int row0) {
    if (idx != nullptr) {
      maxpool3x3s2_kernel<T, V, true><<<grid, threads, 0, stream>>>(x, y, idx, s, row0);
    } else {
      maxpool3x3s2_kernel<T, V, false><<<grid, threads, 0, stream>>>(x, y, nullptr, s, row0);
    }
  });
}

template <typename T, int V>
cudaError_t launch_bwd(const int8_t* idx, const T* dy, T* dx, int n, int h, int w, int c,
                       cudaStream_t stream) {
  const PoolShape s = make_shape(h, w, c, V);
  const int per_row = s.ow * (c / V);
  return launch_rows(per_row, (int64_t)n * s.oh, [&](dim3 grid, int threads, int row0) {
    maxpool3x3s2_bwd_kernel<T, V><<<grid, threads, 0, stream>>>(idx, dy, dx, s, row0);
  });
}

// 16-byte vectors where every pointer allows them and a pixel's channels are whole
// vectors, one element per access otherwise.
template <typename T>
cudaError_t fwd(const void* x, void* y, void* idx, int n, int h, int w, int c,
                cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  if (c % V == 0 && aligned16(x) && aligned16(y) && aligned16(idx)) {
    return launch_fwd<T, V>(xt, static_cast<T*>(y), static_cast<int8_t*>(idx), n, h, w, c,
                            stream);
  }
  return launch_fwd<T, 1>(xt, static_cast<T*>(y), static_cast<int8_t*>(idx), n, h, w, c,
                          stream);
}

template <typename T>
cudaError_t bwd(const void* idx, const void* dy, void* dx, int n, int h, int w, int c,
                cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int8_t* it = static_cast<const int8_t*>(idx);
  if (c % V == 0 && aligned16(idx) && aligned16(dy) && aligned16(dx)) {
    return launch_bwd<T, V>(it, static_cast<const T*>(dy), static_cast<T*>(dx), n, h, w, c,
                            stream);
  }
  return launch_bwd<T, 1>(it, static_cast<const T*>(dy), static_cast<T*>(dx), n, h, w, c,
                          stream);
}

}  // namespace

// x: [n, h, w, c]; y: [n, oh, ow, c]; idx: int8 [n, oh, ow, c] or null (no argmax).
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch (0 on success).
extern "C" int r3m_maxpool3x3s2(const void* x, void* y, void* idx, int n, int h, int w,
                                int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, y, idx, n, h, w, c, s);
  if (dtype == 1) return fwd<bf16_t>(x, y, idx, n, h, w, c, s);
  return cudaErrorInvalidValue;
}

// idx: int8 [n, oh, ow, c] from r3m_maxpool3x3s2; dy: [n, oh, ow, c]; dx: [n, h, w, c],
// every element written. dtype as above, for dy and dx.
extern "C" int r3m_maxpool3x3s2_bwd(const void* idx, const void* dy, void* dx, int n, int h,
                                    int w, int c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(idx, dy, dx, n, h, w, c, s);
  if (dtype == 1) return bwd<bf16_t>(idx, dy, dx, n, h, w, c, s);
  return cudaErrorInvalidValue;
}
