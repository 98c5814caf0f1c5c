// Kernels 1, 13 and 17: dequant-matmul with fused RMSNorm over every
// weight form.
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
// fits one tile), always runs here, for any K (K = 11008 included): inside
// the launch on the decode-row walk, as a pre-pass writing inv_rms[B] on
// the GEMV and the tensor-core path.  At decode rows the kernel is bound by
// the weight bytes (gemv_stream.cuh).  The TPU's sb kernel expands d / dmin
// to per-32 rows with an MXU dot for its sublane rules; here one lane's
// slot is one group, so the expansion is two multiplies and a subtract in
// registers, and kernel 17 is kernel 13's loop over half the code bytes
// (0.59 B a weight against 1.25).  The reference's RoPE epilogue on
// q8_matmul (rope_meta, off by default) is not ported: RoPE runs in torch.
//
// Three paths, three entry points, which the Python wrapper picks:
// th_quant_matmul_stream runs the decode-row walk of gemv_stream.cuh for
// every form at 1 to 8 rows (f32 or bf16 x): persistent blocks, the weight
// stream kept in flight through a shared-memory ring a warp, the norm
// inside the launch; th_quant_matmul runs gemv.cuh's GEMV (16-byte code
// loads converted once for every row of a row tile) for f32 x above 8 rows
// only (every form); th_quant_matmul_tc runs the tensor-core GEMM of qgemm_tc.cuh for bf16 x at more than 8 rows over
// every form, kernel 17's super-blocks too (s and m expanded per group in
// the walk), where the reference's `_qdot` takes the MXU's bf16 dot and
// the work is bound by operations, not bytes.
#include "gemv.cuh"
#include "gemv_stream.cuh"
#include "qgemm_tc.cuh"

using namespace thawk;

template <typename T>
static bool run(const void* x, const void* qs, const void* scales, const void* mins,
                const void* hi, const void* gain, void* y, float* inv, int B, int K, int N,
                int form, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gain);
  return with_reader(form, qs, scales, mins, hi, [&](const auto& wr) {
    if (gt != nullptr) row_inv_rms_kernel<T><<<B, 256, 0, stream>>>(xt, inv, K, eps);
    launch_gemv(xt, B, K, wr, N, gt, inv, static_cast<T*>(y), stream);
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

// The decode-row walk: x [B, K], gain [K] (or null) and y [B, N] in dtype,
// B 1 to 8; every form (Q4_0, G32, G32 + mins, G16, G16 + mins, and sb
// with d, dmin as scales, mins and scmn its sc / mn bytes), K a multiple
// of 32 (of 256 for sb); its plan (ops/cuda/qmatmul.py stream_plan): K walked in
// `splits` segments, rings of `stages` stages, `blocks` persistent blocks,
// each column pair's K split over `parts` warps.
// Other forms, shapes and plans return an invalid-value error.
extern "C" int th_quant_matmul_stream(const void* x, const void* qs, const void* scales,
                                      const void* mins, const void* scmn, const void* gain,
                                      void* y, int B, int K,
                                      int N, int form, int splits, int stages, int blocks,
                                      int parts, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const stream::Weights w{qs, scales, mins, scmn, form};
  const stream::Plan p{splits, stages, blocks, parts};
  const cudaError_t rc =
      dtype == kBF16
          ? stream::matmul(static_cast<const __nv_bfloat16*>(x), B, K, w, N,
                           static_cast<const __nv_bfloat16*>(gain), eps,
                           static_cast<__nv_bfloat16*>(y), p, s)
          : stream::matmul(static_cast<const float*>(x), B, K, w, N,
                           static_cast<const float*>(gain), eps, static_cast<float*>(y), p, s);
  return rc != cudaSuccess ? static_cast<int>(rc) : THAWK_LAUNCH_RESULT();
}

// The tensor-core path: x, gain, y bf16; xn_scratch [B, K] bf16 (with a
// gain), xsum_scratch [B, K/G] f32 (mins forms, super-blocks) and
// part_scratch [splits, B, N] f32 (splits > 1) are its scratch.  Forms
// Q4_0, G32, G32 + mins, G16, G16 + mins and sb (d, dmin as scales, mins;
// scmn its sc / mn bytes, K a multiple of 256); unknown forms return an
// invalid-value error.
extern "C" int th_quant_matmul_tc(const void* x, const void* qs, const void* scales,
                                  const void* mins, const void* scmn, const void* gain, void* y,
                                  void* xn_scratch, void* xsum_scratch, void* part_scratch, int B,
                                  int K, int N, int form, int splits, float eps, void* stream) {
  const qgemm_tc::Call c{static_cast<const __nv_bfloat16*>(x),
                         qs,
                         scales,
                         mins,
                         scmn,
                         static_cast<const __nv_bfloat16*>(gain),
                         static_cast<__nv_bfloat16*>(y),
                         static_cast<__nv_bfloat16*>(xn_scratch),
                         static_cast<float*>(xsum_scratch),
                         static_cast<float*>(part_scratch),
                         B,
                         K,
                         N,
                         splits,
                         eps};
  const cudaError_t rc = qgemm_tc::run(form, c, static_cast<cudaStream_t>(stream));
  return rc != cudaSuccess ? static_cast<int>(rc) : THAWK_LAUNCH_RESULT();
}

// The K splits th_quant_matmul_tc takes at B rows, K inputs and N outputs
// on a card of `sms` SMs: the caller sizes part_scratch by them.
extern "C" int th_quant_matmul_tc_splits(int B, int K, int N, int sms) {
  return qgemm_tc::splits_for(B, K, N, sms);
}

extern "C" const char* th_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
