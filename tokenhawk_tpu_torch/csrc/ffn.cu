// Kernel 2: fused SwiGLU FFN with residual, decode rows (B <= 8).
//
// Replaces tokenhawk_tpu/ops/pallas/ffn.py fused_ffn (_ffn_kernel):
//   y = x + (silu(xn @ W1) * (xn @ W3)) @ W2,   xn = rmsnorm(x) * g.
// The TPU kernel walks F in tiles and carries the W2 partial sums across
// its sequential grid.  Blocks on the GPU run in no order and carry
// nothing, so the port runs two phases:
//   A: gate/up GEMV over w13 [D, 2F]; each warp owns gate column f and up
//      column F+f, and its epilogue writes h = silu(g) * u as f32 into a
//      scratch of B*F*4 bytes (459 KB at B=8, F=14336: it stays in L2);
//   B: down GEMV over w2 [F, D] reading h in f32, with the residual add in
//      its epilogue.
// w13 and w2 each take their own weight form (gemv.cuh Form: Q4_0, or
// group codes of G 16 / 32 with or without mins), as the reference's gate
// allows: a Q4_K_M file pairs a Q4_K w13 with a Q6_K or Q4_K w2.  w13 may
// also be a Q4_K super-block weight (sb, under THAWK_Q4K_SB=1; kernel 17's
// reader), w2 never, as in the reference (ffn.py can_fuse_ffn).  The
// [B, F] intermediate is never written in a narrower type.  Both phases
// stream their weights once; they are bound by weight bytes.
//
// Kernel 15: the post-attention half of a decode layer, Wo + residual +
// RMSNorm + SwiGLU FFN + residual, for B <= 8 rows.  Replaces
// tokenhawk_tpu/ops/pallas/ffn.py fused_owo_ffn (_fused_owo_ffn):
//   x' = x + ctx @ Wo                     (f32, never rounded)
//   y  = x' + (silu(n @ W1) * (n @ W3)) @ W2,   n = rmsnorm(x') * g,
// y rounded once to x's type.  The TPU kernel keeps x' in VMEM slabs across
// its sequential grid; here four launches on one stream carry it through
// an f32 scratch of B*D*4 bytes (128 KB at B=8, D=4096: it stays in L2):
//   1. the Wo GEMV over ctx, x added in its epilogue -> x' (f32);
//   2. row_inv_rms over x';
//   3. kernel 2's gate/up GEMV over x' normalised -> h (f32);
//   4. the down GEMV over h, x' added in its epilogue -> y (x's type).
// Wo, w13 and w2 each take their own weight form but sb, which the gate
// refuses as the reference's does (Wo has mins); the reference's kernel
// reads every scale as a G 32 block and drops w2's mins, the port's
// readers take each form as it is.  Bound by the bytes of the three
// weights; the scratch round trips are L2 traffic of a few hundred KB.
#include "gemv.cuh"

using namespace thawk;

template <typename T>
static bool run(const void* x, const void* w13_qs, const void* w13_s, const void* w13_m,
                const void* w13_hi, int w13_form, const void* w2_qs, const void* w2_s,
                const void* w2_m, const void* w2_hi, int w2_form, const void* gain, float* h,
                float* inv, void* y, int B, int D, int F, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  row_inv_rms_kernel<T><<<B, 256, 0, stream>>>(xt, inv, D, eps);
  const bool a = with_reader<true>(w13_form, w13_qs, w13_s, w13_m, w13_hi, [&](const auto& wr) {
    launch_gemv<T, float, kSwiGLU>(xt, B, D, wr, 2 * F, static_cast<const T*>(gain), inv,
                                   nullptr, h, stream);
  });
  const bool b = with_reader<false>(w2_form, w2_qs, w2_s, w2_m, w2_hi, [&](const auto& wr) {
    launch_gemv<float, T, kResidual>(h, B, F, wr, D, nullptr, nullptr, xt, static_cast<T*>(y),
                                     stream);
  });
  return a && b;
}

extern "C" int th_ffn(const void* x, const void* w13_qs, const void* w13_s, const void* w13_m,
                      const void* w13_hi, int w13_form, const void* w2_qs, const void* w2_s,
                      const void* w2_m, const void* w2_hi, int w2_form, const void* gain,
                      void* h_scratch, void* inv_scratch, void* y, int B, int D, int F, float eps,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(h_scratch);
  float* inv = static_cast<float*>(inv_scratch);
  if (w13_form < kFormQ4 || w13_form > kFormSb || w2_form < kFormQ4 || w2_form > kFormG16Mins)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool known =
      dtype == kBF16
          ? run<__nv_bfloat16>(x, w13_qs, w13_s, w13_m, w13_hi, w13_form, w2_qs, w2_s, w2_m,
                               w2_hi, w2_form, gain, h, inv, y, B, D, F, eps, s)
          : run<float>(x, w13_qs, w13_s, w13_m, w13_hi, w13_form, w2_qs, w2_s, w2_m, w2_hi,
                       w2_form, gain, h, inv, y, B, D, F, eps, s);
  return known ? THAWK_LAUNCH_RESULT() : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static bool run_owo(const void* ctx, const void* x, const void* wo_qs, const void* wo_s,
                    const void* wo_m, int wo_form, const void* w13_qs, const void* w13_s,
                    const void* w13_m, int w13_form, const void* w2_qs, const void* w2_s,
                    const void* w2_m, int w2_form, const void* gain, float* xp, float* h,
                    float* inv, void* y, int B, int Dq, int D, int F, float eps,
                    cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const bool a = with_reader<false>(wo_form, wo_qs, wo_s, wo_m, nullptr, [&](const auto& wr) {
    launch_gemv<T, float, kResidual, T, T>(static_cast<const T*>(ctx), B, Dq, wr, D, nullptr,
                                           nullptr, xt, xp, stream);
  });
  row_inv_rms_kernel<float><<<B, 256, 0, stream>>>(xp, inv, D, eps);
  const bool b = with_reader<false>(w13_form, w13_qs, w13_s, w13_m, nullptr, [&](const auto& wr) {
    launch_gemv<float, float, kSwiGLU, T>(xp, B, D, wr, 2 * F, static_cast<const T*>(gain), inv,
                                          nullptr, h, stream);
  });
  const bool c = with_reader<false>(w2_form, w2_qs, w2_s, w2_m, nullptr, [&](const auto& wr) {
    launch_gemv<float, T, kResidual, float, float>(h, B, F, wr, D, nullptr, nullptr, xp,
                                                   static_cast<T*>(y), stream);
  });
  return a && b && c;
}

// Kernel 15.  ctx [B, Dq] and x, y [B, D] in dtype; each weight as
// (qs, scales, mins, hi, form), hi unused (no sb form); gain [D] in dtype;
// xp [B, D], h [B, F] and inv [B] f32 scratch.
extern "C" int th_owo_ffn(const void* ctx, const void* x, const void* wo_qs, const void* wo_s,
                          const void* wo_m, const void*, int wo_form, const void* w13_qs,
                          const void* w13_s, const void* w13_m, const void*, int w13_form,
                          const void* w2_qs, const void* w2_s, const void* w2_m, const void*,
                          int w2_form, const void* gain, void* xp_scratch,
                          void* h_scratch, void* inv_scratch, void* y, int B, int Dq, int D,
                          int F, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xp = static_cast<float*>(xp_scratch);
  float* h = static_cast<float*>(h_scratch);
  float* inv = static_cast<float*>(inv_scratch);
  for (const int form : {wo_form, w13_form, w2_form})
    if (form < kFormQ4 || form > kFormG16Mins) return static_cast<int>(cudaErrorInvalidValue);
  const bool known =
      dtype == kBF16
          ? run_owo<__nv_bfloat16>(ctx, x, wo_qs, wo_s, wo_m, wo_form, w13_qs, w13_s, w13_m,
                                   w13_form, w2_qs, w2_s, w2_m, w2_form, gain, xp, h, inv, y, B,
                                   Dq, D, F, eps, s)
          : run_owo<float>(ctx, x, wo_qs, wo_s, wo_m, wo_form, w13_qs, w13_s, w13_m, w13_form,
                           w2_qs, w2_s, w2_m, w2_form, gain, xp, h, inv, y, B, Dq, D, F, eps, s);
  return known ? THAWK_LAUNCH_RESULT() : static_cast<int>(cudaErrorInvalidValue);
}
