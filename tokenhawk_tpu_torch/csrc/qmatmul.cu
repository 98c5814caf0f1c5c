// Kernels 1, 13 and 17: dequant-matmul with fused RMSNorm, one entry point
// for every weight form.
//
// Kernel 1 (form Q4_0) replaces tokenhawk_tpu/ops/pallas/qmatmul.py
// q4_matmul (_q4_kernel) and q4_matmul_i4 (_q4i4_kernel); kernel 13 (the
// group-code forms) replaces q8_matmul (_q8_kernel) and qk_matmul
// (_qk_kernel); kernel 17 (form sb) replaces qk_sb_matmul (_qk_sb_kernel):
//   y[b, n] = sum_g s[n,g] * (sum_{k in g} xn[b,k] q[n,k])
//           + sum_g m[n,g] * (sum_{k in g} xn[b,k]),   xn = rmsnorm(x) * gain,
// over Q4_0 nibbles, or int8 codes [N, K] with f32 scales (and mins) per
// group of G = 16 or 32 inputs: Q8_0, Q5_0, Q4_1, Q5_1 and the k-quants
// Q2_K..Q6_K (ops/qweight.py); for sb, Q4_K's codes two a byte with s and
// m = 8s - dmin*mn expanded per group from the 6-bit sc / mn and the
// per-256 d / dmin (gemv.cuh SbReader).  f32 accumulation, one rounding to x's
// type.  The norm is optional and, unlike the reference (fused only when K
// fits one tile), always runs here: a pre-pass writes inv_rms[B] and the
// GEMV scales each staged x chunk by it, for any K (K = 11008 included).
// At decode rows the kernel is bound by the weight bytes; it reads a
// column's codes of one 32-input slot with 16-byte loads and converts each
// once for every row of the tile (gemv.cuh).  The TPU's sb kernel expands
// d / dmin to per-32 rows with an MXU dot for its sublane rules; here one
// lane's slot is one group, so the expansion is two multiplies and a
// subtract in registers, and kernel 17 is kernel 13's loop over half the
// code bytes (0.59 B a weight against 1.25).  The reference's RoPE
// epilogue on q8_matmul (rope_meta, off by default) is not ported: RoPE
// runs in torch.
#include "gemv.cuh"

using namespace thawk;

template <typename T>
static bool run(const void* x, const void* qs, const void* scales, const void* mins,
                const void* hi, const void* gain, void* y, float* inv, int B, int K, int N,
                int form, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gain);
  return with_reader<true>(form, qs, scales, mins, hi, [&](const auto& wr) {
    if (gt != nullptr) row_inv_rms_kernel<T><<<B, 256, 0, stream>>>(xt, inv, K, eps);
    launch_gemv<T, T, kStore>(xt, B, K, wr, N, gt, inv, nullptr, static_cast<T*>(y), stream);
  });
}

extern "C" int th_quant_matmul(const void* x, const void* qs, const void* scales,
                               const void* mins, const void* hi, const void* gain, void* y,
                               void* inv_scratch, int B, int K, int N, int form, float eps,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* inv = static_cast<float*>(inv_scratch);
  const bool known =
      dtype == kBF16
          ? run<__nv_bfloat16>(x, qs, scales, mins, hi, gain, y, inv, B, K, N, form, eps, s)
          : run<float>(x, qs, scales, mins, hi, gain, y, inv, B, K, N, form, eps, s);
  return known ? THAWK_LAUNCH_RESULT() : static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* th_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
