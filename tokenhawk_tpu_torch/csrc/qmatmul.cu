// Kernel 1: Q4_0 dequant-matmul with fused RMSNorm.
//
// Replaces tokenhawk_tpu/ops/pallas/qmatmul.py q4_matmul (_q4_kernel) and
// q4_matmul_i4 (_q4i4_kernel): y[B, N] = (rmsnorm(x) * g)[B, K] @ deq(W)
// with f32 accumulation, output in x's type.  The norm is optional and,
// unlike the reference (fused only when K fits one tile), always runs
// here: a pre-pass writes inv_rms[B] and the GEMV scales each staged x
// chunk by it, for any K (K = 11008 included).  Design in q4.cuh.
#include "q4.cuh"

using namespace thawk;

template <typename T>
static void run(const void* x, const void* qs, const void* scales, const void* gain, void* y,
                float* inv, int B, int K, int N, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gain);
  if (gt != nullptr) row_inv_rms_kernel<T><<<B, 256, 0, stream>>>(xt, inv, K, eps);
  launch_q4_gemv<T, T, kStore>(xt, B, K, static_cast<const uint8_t*>(qs),
                               static_cast<const float*>(scales), N, gt, inv, nullptr,
                               static_cast<T*>(y), stream);
}

extern "C" int th_q4_matmul(const void* x, const void* qs, const void* scales, const void* gain,
                            void* y, void* inv_scratch, int B, int K, int N, float eps,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* inv = static_cast<float*>(inv_scratch);
  if (dtype == kBF16)
    run<__nv_bfloat16>(x, qs, scales, gain, y, inv, B, K, N, eps, s);
  else
    run<float>(x, qs, scales, gain, y, inv, B, K, N, eps, s);
  return THAWK_LAUNCH_RESULT();
}

extern "C" const char* th_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
