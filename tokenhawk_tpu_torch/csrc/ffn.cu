// Kernel 2: fused SwiGLU FFN with residual, decode rows (B <= 8).
//
// Replaces tokenhawk_tpu/ops/pallas/ffn.py fused_ffn (_ffn_kernel):
//   y = x + (silu(xn @ W1) * (xn @ W3)) @ W2,   xn = rmsnorm(x) * g.
// The TPU kernel walks F in tiles and carries the W2 partial sums across
// its sequential grid.  Blocks on the GPU run in no order and carry
// nothing, so the port runs two phases over the Q4_0 weights:
//   A: gate/up GEMV over w13 [D, 2F]; each warp owns gate column f and up
//      column F+f, and its epilogue writes h = silu(g) * u as f32 into a
//      scratch of B*F*4 bytes (352 KB at B=8, F=11008: it stays in L2);
//   B: down GEMV over w2 [F, D] reading h in f32, with the residual add in
//      its epilogue.
// The [B, F] intermediate is never written in a narrower type.  Both
// phases stream their weights once; they are bound by weight bytes.
#include "q4.cuh"

using namespace thawk;

template <typename T>
static void run(const void* x, const void* w13_qs, const void* w13_s, const void* w2_qs,
                const void* w2_s, const void* gain, float* h, float* inv, void* y, int B, int D,
                int F, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  row_inv_rms_kernel<T><<<B, 256, 0, stream>>>(xt, inv, D, eps);
  launch_q4_gemv<T, float, kSwiGLU>(xt, B, D, static_cast<const uint8_t*>(w13_qs),
                                    static_cast<const float*>(w13_s), 2 * F,
                                    static_cast<const T*>(gain), inv, nullptr, h, stream);
  launch_q4_gemv<float, T, kResidual>(h, B, F, static_cast<const uint8_t*>(w2_qs),
                                      static_cast<const float*>(w2_s), D, nullptr, nullptr, xt,
                                      static_cast<T*>(y), stream);
}

extern "C" int th_ffn(const void* x, const void* w13_qs, const void* w13_s, const void* w2_qs,
                      const void* w2_s, const void* gain, void* h_scratch, void* inv_scratch,
                      void* y, int B, int D, int F, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(h_scratch);
  float* inv = static_cast<float*>(inv_scratch);
  if (dtype == kBF16)
    run<__nv_bfloat16>(x, w13_qs, w13_s, w2_qs, w2_s, gain, h, inv, y, B, D, F, eps, s);
  else
    run<float>(x, w13_qs, w13_s, w2_qs, w2_s, gain, h, inv, y, B, D, F, eps, s);
  return THAWK_LAUNCH_RESULT();
}
