// The bf16 products of `dense` (r3m_tpu_torch/models/layers.py) with their epilogue inside
// the GEMM, for sm_90a:
//
//   forward  out[M, N] = round_bf16(x[M, K] . w[N, K]^T + bias[N])   (bias f32)
//   dx       dx[M, K]  = round_bf16(g[M, N] . w[N, K])
//
// It replaces no TPU kernel: the JAX `dense` (r3m_tpu/models/layers.py) is a jnp.dot with an
// f32 result plus the f32 bias, then a cast, which XLA fuses into the product's epilogue.
// The port's unfused order makes the f32 [M, N] product, its f32 sum with the bias and its
// cast back three trips through device memory: 4 bytes an output element written by the
// GEMM, then 14 more read and written by the add and the cast. At DINOv2-g/14's widths
// (M = 66,816 rows, N = 1,536 to 8,192, K = 1,536 or 4,096) those 14 bytes outweigh the
// product's own time. Here the f32 accumulator gets the f32 bias added in registers and is
// rounded once to bf16 (round to nearest even): 2 bytes an output element leave the SM,
// the arithmetic of the unfused order but for the order of the GEMM's sums, which are all
// f32 (no split-K). Bound: FLOPs (2 M N K at 989 TFLOP/s) at these widths; the bytes
// (operands once, the output in bf16) take a fifth of that time or less.
//
// cuBLASLt, which the unfused order's product runs on, refuses an f32 bias vector with a
// bf16 D outside fp8 (its heuristic returns CUBLAS_STATUS_INVALID_VALUE; a bias of D's type
// it takes, but that rounds the bias first): r3m_dense_cublaslt_f32_bias asks it again on
// the card at hand. So the products are CUTLASS 3 kernels built here from its Hopper
// building blocks: TMA loads into a ring of shared-memory stages, warp-specialised
// (one producer warp, two consumer warpgroups issuing wgmma on 128 x 256 tiles),
// persistent blocks in clusters of two that share their x tiles by TMA multicast, and an
// epilogue that adds the bias and rounds in registers before a TMA store.
//
// Both run transposed, so that the bias runs along the product's rows and every output is
// column-major: row-major x[M, K] . w[N, K]^T is D[N, M] = w[N, K] . x^T, with A = w
// (K-major), B = x (K-major, leading dimension x's row stride), D column-major (ld N,
// which is `out` row-major) and a per-row bias; dx is D[K, M] = w^T[K, N] . g^T, with
// A = w read M-major, B = g (K-major), D column-major (ld K). Every pointer the wrapper
// passes is 16-byte aligned and every leading dimension a multiple of 8 elements, as TMA
// needs.

#include <cublasLt.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <functional>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "cute/tensor.hpp"
#include "cutlass/cutlass.h"
#include "cutlass/epilogue/collective/collective_builder.hpp"
#include "cutlass/epilogue/fusion/operations.hpp"
#include "cutlass/gemm/collective/collective_builder.hpp"
#include "cutlass/gemm/device/gemm_universal_adapter.h"
#include "cutlass/gemm/dispatch_policy.hpp"
#include "cutlass/gemm/kernel/gemm_universal.hpp"

namespace {

using namespace cute;

using Bf16 = cutlass::bfloat16_t;
using ColumnMajor = cutlass::layout::ColumnMajor;
using RowMajor = cutlass::layout::RowMajor;
constexpr int kAlign = 8;  // bf16 elements in 16 bytes

template <class LayoutA, class FusionOp>
struct Product {
  using TileShape = Shape<_128, _256, _64>;
  using ClusterShape = Shape<_2, _1, _1>;
  using Epilogue = typename cutlass::epilogue::collective::CollectiveBuilder<
      cutlass::arch::Sm90, cutlass::arch::OpClassTensorOp, TileShape, ClusterShape,
      cutlass::epilogue::collective::EpilogueTileAuto, float, float,
      void, ColumnMajor, kAlign,  // no source operand C
      Bf16, ColumnMajor, kAlign,
      cutlass::epilogue::TmaWarpSpecializedCooperative, FusionOp>::CollectiveOp;
  using Mainloop = typename cutlass::gemm::collective::CollectiveBuilder<
      cutlass::arch::Sm90, cutlass::arch::OpClassTensorOp,
      Bf16, LayoutA, kAlign, Bf16, ColumnMajor, kAlign, float, TileShape, ClusterShape,
      cutlass::gemm::collective::StageCountAutoCarveout<
          static_cast<int>(sizeof(typename Epilogue::SharedStorage))>,
      cutlass::gemm::KernelTmaWarpSpecializedCooperative>::CollectiveOp;
  using Kernel =
      cutlass::gemm::kernel::GemmUniversal<Shape<int, int, int, int>, Mainloop, Epilogue>;
  using Gemm = cutlass::gemm::device::GemmUniversalAdapter<Kernel>;
};

// round(A . B + bias) with the bias along D's rows, f32 throughout until the one rounding
using Forward = Product<RowMajor, cutlass::epilogue::fusion::LinCombPerRowBias<
                                      Bf16, float, float, Bf16, float>>::Gemm;
// round(A . B)
using Dx = Product<ColumnMajor,
                   cutlass::epilogue::fusion::LinearCombination<Bf16, float, Bf16, float>>::Gemm;

// The stride of an operand of logical shape (rows, cols) and one batch: the static unit
// stride stays, the other matrix mode gets `ld`, the batch mode the matrix's footprint.
template <class Stride>
Stride strided(int64_t ld, int64_t rows, int64_t cols) {
  Stride s{};
  if constexpr (is_static<std::decay_t<decltype(get<0>(s))>>::value) {
    get<1>(s) = ld;
    get<2>(s) = ld * cols;
  } else {
    get<0>(s) = ld;
    get<2>(s) = ld * rows;
  }
  return s;
}

constexpr int kMaxDevices = 64;

// The device's SM count, asked of the runtime once a device.
int sm_count(int device) {
  static std::atomic<int> sms[kMaxDevices];
  int n = sms[device].load(std::memory_order_relaxed);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    sms[device].store(n, std::memory_order_relaxed);
  }
  return n;
}

// `device` current on this thread for one launch, the thread's own device back after it.
// The first launch on a thread also makes the device's primary context current, which
// CUTLASS needs to encode the TMA descriptors (cuTensorMapEncodeTiled): PyTorch's autograd
// threads never do so for device 0, which the runtime reports as current all the same.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : device_(device) {
    thread_local int primed = -1;
    cudaGetDevice(&previous_);
    if (previous_ != device || primed != device) {
      cudaSetDevice(device);
      primed = device;
    }
  }
  ~DeviceGuard() {
    if (previous_ != device_) cudaSetDevice(previous_);
  }

 private:
  int device_;
  int previous_ = 0;
};

// D[m, n] = A[m, k] . B[n, k]^T, D column-major: the leading dimensions of A, B and D.
template <class Gemm>
typename Gemm::Arguments arguments(const void* a, int64_t lda, const void* b, int64_t ldb,
                                   void* d, int64_t ldd, int64_t m, int64_t n, int64_t k,
                                   int device) {
  using K = typename Gemm::GemmKernel;
  const auto dd = strided<typename K::StrideD>(ldd, m, n);
  typename Gemm::Arguments args{
      cutlass::gemm::GemmUniversalMode::kGemm,
      {int(m), int(n), int(k), 1},
      {static_cast<const Bf16*>(a), strided<typename K::StrideA>(lda, m, k),
       static_cast<const Bf16*>(b), strided<typename K::StrideB>(ldb, n, k)},
      {{}, nullptr, strided<typename K::StrideC>(ldd, m, n), static_cast<Bf16*>(d), dd},
      {device, sm_count(device)}};
  args.epilogue.thread.alpha = 1.0f;
  args.epilogue.thread.beta = 0.0f;
  return args;
}

constexpr int kNotTaken = -2, kNeedsWorkspace = -3, kInitFailed = -4, kLaunchFailed = -5;

// What a product keeps between calls: for each problem (M, N, K and the leading dimension
// of x or g) whether CUTLASS takes it and the workspace it needs, and the devices on which
// the kernel's shared-memory size has been set.
struct Problem {
  int64_t m, n, k, ld;
  bool operator==(const Problem& o) const {
    return m == o.m && n == o.n && k == o.k && ld == o.ld;
  }
};

struct ProblemHash {
  size_t operator()(const Problem& p) const {
    size_t h = std::hash<int64_t>()(p.m);
    for (int64_t v : {p.n, p.k, p.ld}) h = h * 1000003u ^ std::hash<int64_t>()(v);
    return h;
  }
};

struct Checked {
  bool taken;
  size_t workspace;
};

template <class Gemm>
struct Plan {
  std::mutex lock;
  std::unordered_map<Problem, Checked, ProblemHash> problems;
  bool ready[kMaxDevices] = {};
};

template <class Gemm>
Plan<Gemm>& plan() {
  static Plan<Gemm> p;
  return p;
}

// Launch one product on `stream`. A problem is checked once (can_implement, the workspace
// size), and `initialize`, which sets the kernel's shared-memory size, runs once a device;
// each call then encodes its own parameters (the TMA descriptors hold its pointers) and
// launches.
template <class Gemm>
int run(const typename Gemm::Arguments& args, const Problem& problem, int device,
        void* workspace, size_t workspace_bytes, cudaStream_t stream) {
  auto& p = plan<Gemm>();
  {
    std::lock_guard<std::mutex> hold(p.lock);
    auto it = p.problems.find(problem);
    if (it == p.problems.end()) {
      const Checked c{Gemm::can_implement(args) == cutlass::Status::kSuccess,
                      Gemm::get_workspace_size(args)};
      it = p.problems.emplace(problem, c).first;
    }
    if (!it->second.taken) return kNotTaken;
    if (it->second.workspace > workspace_bytes) return kNeedsWorkspace;
    if (!p.ready[device]) {
      Gemm gemm;
      if (gemm.initialize(args, workspace, stream) != cutlass::Status::kSuccess) {
        return kInitFailed;
      }
      p.ready[device] = true;
    }
  }
  auto params = Gemm::GemmKernel::to_underlying_arguments(args, workspace);
  if (Gemm::run(params, stream) != cutlass::Status::kSuccess) return kLaunchFailed;
  return int(cudaGetLastError());
}

typename Forward::Arguments forward_args(const void* x, int64_t ldx, const void* w,
                                         const float* bias, void* out, int64_t m, int64_t n,
                                         int64_t k, int device) {
  // D[N, M] = w[N, K] . x^T: A = w (ld K), B = x (ld ldx), D ld N
  auto args = arguments<Forward>(w, k, x, ldx, out, n, n, m, k, device);
  args.epilogue.thread.bias_ptr = bias;
  return args;
}

typename Dx::Arguments dx_args(const void* g, const void* w, void* dx, int64_t m, int64_t n,
                               int64_t k, int device) {
  // D[K, M] = w^T[K, N] . g^T: A = w read M-major (ld K), B = g (ld N), D ld K
  return arguments<Dx>(w, k, g, n, dx, k, k, m, n, device);
}

}  // namespace

// The workspace the product of `kind` (0: the forward, 1: dx) needs at these sizes: x (or
// g) of M rows, w [N, K].
extern "C" size_t r3m_dense_workspace_bytes(int kind, int64_t m, int64_t n, int64_t k,
                                            int device) {
  if (device < 0 || device >= kMaxDevices) return 0;
  DeviceGuard on(device);
  if (kind == 0) {
    return Forward::get_workspace_size(
        forward_args(nullptr, k, nullptr, nullptr, nullptr, m, n, k, device));
  }
  return Dx::get_workspace_size(dx_args(nullptr, nullptr, nullptr, m, n, k, device));
}

// out[M, N] = round_bf16(x[M, K] . w[N, K]^T + bias[N]) on `device`'s `stream`: x with row
// stride `ldx`, w and out contiguous, the bias f32. Returns 0, a cudaError_t, or -2 (shape
// not taken), -3 (workspace too small: r3m_dense_workspace_bytes says what it needs), -4
// (initialisation failed), -5 (launch failed).
extern "C" int r3m_dense_fwd(const void* x, int64_t ldx, const void* w, const float* bias,
                             void* out, int64_t m, int64_t n, int64_t k, void* workspace,
                             size_t workspace_bytes, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices) return kNotTaken;
  DeviceGuard on(device);
  return run<Forward>(forward_args(x, ldx, w, bias, out, m, n, k, device), {m, n, k, ldx},
                      device, workspace, workspace_bytes, static_cast<cudaStream_t>(stream));
}

// dx[M, K] = round_bf16(g[M, N] . w[N, K]), all contiguous. Returns as r3m_dense_fwd.
extern "C" int r3m_dense_dx(const void* g, const void* w, void* dx, int64_t m, int64_t n,
                            int64_t k, void* workspace, size_t workspace_bytes, int device,
                            void* stream) {
  if (device < 0 || device >= kMaxDevices) return kNotTaken;
  DeviceGuard on(device);
  return run<Dx>(dx_args(g, w, dx, m, n, k, device), {m, n, k, n}, device, workspace,
                 workspace_bytes, static_cast<cudaStream_t>(stream));
}

// Whether cuBLASLt's heuristic offers an algorithm for the forward with an f32 bias vector
// and a bf16 D (bf16 A and B, f32 compute, the bias epilogue) at ViT-B/32's MLP widths:
// returns the heuristic's cublasStatus_t (0 where it offers one), or -1 for none offered.
extern "C" int r3m_dense_cublaslt_f32_bias() {
  cublasLtHandle_t handle;
  if (cublasLtCreate(&handle) != CUBLAS_STATUS_SUCCESS) return -1;
  cublasLtMatmulDesc_t op;
  cublasLtMatrixLayout_t a, b, d;
  cublasLtMatmulPreference_t pref;
  const int64_t m = 12800, n = 3072, k = 768;
  const cublasOperation_t trans = CUBLAS_OP_T;
  const cublasLtEpilogue_t epilogue = CUBLASLT_EPILOGUE_BIAS;
  const cudaDataType_t bias_type = CUDA_R_32F;
  cublasLtMatmulDescCreate(&op, CUBLAS_COMPUTE_32F, CUDA_R_32F);
  cublasLtMatmulDescSetAttribute(op, CUBLASLT_MATMUL_DESC_TRANSA, &trans, sizeof(trans));
  cublasLtMatmulDescSetAttribute(op, CUBLASLT_MATMUL_DESC_EPILOGUE, &epilogue,
                                 sizeof(epilogue));
  cublasLtMatmulDescSetAttribute(op, CUBLASLT_MATMUL_DESC_BIAS_DATA_TYPE, &bias_type,
                                 sizeof(bias_type));
  cublasLtMatrixLayoutCreate(&a, CUDA_R_16BF, k, n, k);
  cublasLtMatrixLayoutCreate(&b, CUDA_R_16BF, k, m, k);
  cublasLtMatrixLayoutCreate(&d, CUDA_R_16BF, n, m, n);
  cublasLtMatmulPreferenceCreate(&pref);
  cublasLtMatmulHeuristicResult_t result = {};
  int found = 0;
  cublasStatus_t s = cublasLtMatmulAlgoGetHeuristic(handle, op, a, b, d, d, pref, 1, &result,
                                                    &found);
  cublasLtMatmulPreferenceDestroy(pref);
  cublasLtMatrixLayoutDestroy(d);
  cublasLtMatrixLayoutDestroy(b);
  cublasLtMatrixLayoutDestroy(a);
  cublasLtMatmulDescDestroy(op);
  cublasLtDestroy(handle);
  if (s != CUBLAS_STATUS_SUCCESS) return int(s);
  return found > 0 ? 0 : -1;
}
