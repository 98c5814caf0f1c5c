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
// allows: a Q4_K_M file pairs a Q4_K w13 with a Q6_K or Q4_K w2.  The
// [B, F] intermediate is never written in a narrower type.  Both phases
// stream their weights once; they are bound by weight bytes.
#include "gemv.cuh"

using namespace thawk;

template <typename T>
static bool run(const void* x, const void* w13_qs, const void* w13_s, const void* w13_m,
                int w13_form, const void* w2_qs, const void* w2_s, const void* w2_m, int w2_form,
                const void* gain, float* h, float* inv, void* y, int B, int D, int F, float eps,
                cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  row_inv_rms_kernel<T><<<B, 256, 0, stream>>>(xt, inv, D, eps);
  const bool a = with_reader(w13_form, w13_qs, w13_s, w13_m, [&](const auto& wr) {
    launch_gemv<T, float, kSwiGLU>(xt, B, D, wr, 2 * F, static_cast<const T*>(gain), inv,
                                   nullptr, h, stream);
  });
  const bool b = with_reader(w2_form, w2_qs, w2_s, w2_m, [&](const auto& wr) {
    launch_gemv<float, T, kResidual>(h, B, F, wr, D, nullptr, nullptr, xt, static_cast<T*>(y),
                                     stream);
  });
  return a && b;
}

extern "C" int th_ffn(const void* x, const void* w13_qs, const void* w13_s, const void* w13_m,
                      int w13_form, const void* w2_qs, const void* w2_s, const void* w2_m,
                      int w2_form, const void* gain, void* h_scratch, void* inv_scratch, void* y,
                      int B, int D, int F, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(h_scratch);
  float* inv = static_cast<float*>(inv_scratch);
  if (w13_form < kFormQ4 || w13_form > kFormG16Mins || w2_form < kFormQ4 || w2_form > kFormG16Mins)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool known =
      dtype == kBF16
          ? run<__nv_bfloat16>(x, w13_qs, w13_s, w13_m, w13_form, w2_qs, w2_s, w2_m, w2_form,
                               gain, h, inv, y, B, D, F, eps, s)
          : run<float>(x, w13_qs, w13_s, w13_m, w13_form, w2_qs, w2_s, w2_m, w2_form, gain, h,
                       inv, y, B, D, F, eps, s);
  return known ? THAWK_LAUNCH_RESULT() : static_cast<int>(cudaErrorInvalidValue);
}
