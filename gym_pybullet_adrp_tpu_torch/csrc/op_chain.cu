// op_chain: the op-cost calibration chains (K6).
//
// Replaces scripts/vpu_calibrate.py::chain_time (:84, pallas_call :87,
// body _kernel :66). Wrapper, plain PyTorch version and the calibration
// loop: op_calibrate.py.
//
// Each thread takes one element x of the (rows, 128) input, starts
// N_IND = 8 independent chains y_j = x * (1 + 0.1 j) + 0.5, runs `iters`
// outer rounds of 16 inlined rounds of y_j = op(y_j, 0.7) on all eight,
// and writes their sum y_0 + ... + y_7 (in that order). Eight
// independent chains give each thread the instruction-level parallelism
// to keep its issue slot busy, so the time measures the op's throughput
// cost, not its latency.
//
// Build flags: like every kernel of the port, -fmad=false without fast
// math. The `fma` op (y * 0.9999 + 0.7) is therefore an unfused multiply
// and add, and every weight that op_calibrate prints is relative to that
// unfused pair, under the flags the port's kernels run with; `max` is
// emitted as PTX max.f32 through inline assembly, since max(max(y, c), c)
// would otherwise fold into a single max. sinf, cosf, expf, logf, tanhf
// are the toolkit's libdevice versions (no __sinf-style intrinsics);
// rsqrtf is the hardware approximation, as PyTorch's CUDA rsqrt.
//
// Bound: operations. Per element 16 * 8 * iters ops against 8 bytes of
// traffic; the calibration's rows fill the card (op_calibrate.ROWS).

#include <cuda_runtime.h>

namespace adrp {

constexpr int N_IND = 8;
constexpr int N_INLINE = 16;

enum Op {
  FMA, MUL, ADD, MAX, DIV, SQRT, RSQRT, SIN, COS, EXP, LOG, TANH, LOGISTIC,
  N_OPS
};

__device__ __forceinline__ float max_f32(float a, float b) {
  float r;
  asm volatile("max.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <int OP>
__device__ __forceinline__ float apply(float y, float c) {
  if (OP == FMA) return y * 0.9999f + c;
  if (OP == MUL) return y * 0.9999f;
  if (OP == ADD) return y + c;
  if (OP == MAX) return max_f32(y, c);
  if (OP == DIV) return c / y;
  if (OP == SQRT) return sqrtf(y) + c;
  if (OP == RSQRT) return rsqrtf(y) + c;
  if (OP == SIN) return sinf(y) + c;
  if (OP == COS) return cosf(y) + c;
  if (OP == EXP) return expf(y * 0.1f);
  if (OP == LOG) return logf(y) + c;
  if (OP == TANH) return tanhf(y) + c;
  return 1.0f / (1.0f + expf(-y)) + c;  // LOGISTIC
}

template <int OP>
__global__ void op_chain_kernel(const float* __restrict__ x,
                                float* __restrict__ out, long long n,
                                int iters) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float xv = x[e];
  const float c = 0.7f;
  float ys[N_IND];
#pragma unroll
  for (int j = 0; j < N_IND; ++j) ys[j] = xv * (float)(1.0 + 0.1 * j) + 0.5f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < N_INLINE; ++r) {
#pragma unroll
      for (int j = 0; j < N_IND; ++j) ys[j] = apply<OP>(ys[j], c);
    }
  }
  float acc = ys[0];
#pragma unroll
  for (int j = 1; j < N_IND; ++j) acc = acc + ys[j];
  out[e] = acc;
}

template <int OP>
void launch(const float* x, float* out, long long n, int iters,
            cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  op_chain_kernel<OP><<<(unsigned)blocks, threads, 0, stream>>>(x, out, n,
                                                                iters);
}

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). `op` indexes
// op_calibrate.OPS in order. The caller makes the stream's device current.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for an
// unknown op).
extern "C" int adrp_op_chain(int op, const float* x, float* out, long long n,
                             int iters, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case adrp::FMA: adrp::launch<adrp::FMA>(x, out, n, iters, s); break;
    case adrp::MUL: adrp::launch<adrp::MUL>(x, out, n, iters, s); break;
    case adrp::ADD: adrp::launch<adrp::ADD>(x, out, n, iters, s); break;
    case adrp::MAX: adrp::launch<adrp::MAX>(x, out, n, iters, s); break;
    case adrp::DIV: adrp::launch<adrp::DIV>(x, out, n, iters, s); break;
    case adrp::SQRT: adrp::launch<adrp::SQRT>(x, out, n, iters, s); break;
    case adrp::RSQRT: adrp::launch<adrp::RSQRT>(x, out, n, iters, s); break;
    case adrp::SIN: adrp::launch<adrp::SIN>(x, out, n, iters, s); break;
    case adrp::COS: adrp::launch<adrp::COS>(x, out, n, iters, s); break;
    case adrp::EXP: adrp::launch<adrp::EXP>(x, out, n, iters, s); break;
    case adrp::LOG: adrp::launch<adrp::LOG>(x, out, n, iters, s); break;
    case adrp::TANH: adrp::launch<adrp::TANH>(x, out, n, iters, s); break;
    case adrp::LOGISTIC:
      adrp::launch<adrp::LOGISTIC>(x, out, n, iters, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
