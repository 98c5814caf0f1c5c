// Kernel 2: fused SwiGLU FFN with residual, decode rows (B <= 8).
//
// Replaces tokenhawk_tpu/ops/pallas/ffn.py fused_ffn (_ffn_kernel):
//   y = x + (silu(xn @ W1) * (xn @ W3)) @ W2,   xn = rmsnorm(x) * g.
// The TPU kernel walks F in tiles and carries the W2 partial sums across
// its sequential grid.  Blocks on the GPU run in no order and carry
// nothing, so the port runs two launches of the decode-row walk
// (gemv_stream.cuh), each bound by its weight bytes:
//   A: gate/up over w13 [D, 2F], the norm inside the launch; each warp owns
//      gate column f and up column F+f, and the epilogue writes
//      h = silu(g) * u as f32 into a scratch of B*F*4 bytes (459 KB at B=8,
//      F=14336: it stays in L2);
//   B: down over w2 [F, D] reading h in f32, with the residual add in its
//      epilogue.
// Each launch runs persistent blocks, one an SM, on the plan the host's
// rule gives it (ops/cuda/qmatmul.py stream_plan), B as a programmatic
// dependent of A (its copies of w2 start while A's last blocks run), A an
// ordinary launch.  w13 and w2 each take their own weight form (gemv.cuh
// Form: Q4_0, or group codes of G 16 / 32 with or without mins), as the
// reference's gate allows: a Q4_K_M file pairs a Q4_K w13 with a Q6_K or Q4_K w2.  w13 may
// also be a Q4_K super-block weight (sb, under THAWK_Q4K_SB=1; kernel 17's
// expansion), w2 never, as in the reference (ffn.py can_fuse_ffn).  The
// [B, F] intermediate is never written in a narrower type.
//
// Kernel 15: the post-attention half of a decode layer, Wo + residual +
// RMSNorm + SwiGLU FFN + residual, for B <= 8 rows.  Replaces
// tokenhawk_tpu/ops/pallas/ffn.py fused_owo_ffn (_fused_owo_ffn):
//   x' = x + ctx @ Wo                     (f32, never rounded)
//   y  = x' + (silu(n @ W1) * (n @ W3)) @ W2,   n = rmsnorm(x') * g,
// y rounded once to x's type.  The TPU kernel keeps x' in VMEM slabs across
// its sequential grid; here three launches of the decode-row walk on one
// stream, each on the host's plan for its shape, carry it through an f32
// scratch of B*D*4 bytes (128 KB at B=8, D=4096: it stays in L2):
//   A. Wo over ctx, x added in its epilogue -> x' (f32);
//   B. gate/up over x', the norm's squares summed from the staged f32 rows
//      inside the launch -> h (f32), as kernel 2's gate/up;
//   C. down over h, x' added in its epilogue -> y (x's type).
// B is a programmatic dependent of A and C of B: each issues its first ring
// stages of weights before griddepcontrol.wait and reads x' or h only after
// it.  A is an ordinary launch: the kernel before it belongs to the caller.
// Wo and w13 take one form without mins (Q4_0, G 32, G 16), as the gate
// admits them; w2 any of kernel 2's w2 forms.  The reference's kernel reads
// every scale as a G 32 block and drops w2's mins, the port's walk takes
// each form as it is.  Bound by the bytes of the three weights; the scratch
// round trips are L2 traffic of a few hundred KB.  At float32 the three
// launches are kernel 2's instances; at bfloat16 A, B (an f32 x' with a
// bfloat16 gain) and C have their own (gemv_stream_owo_*_bf16.cu).
#include "gemv_stream.cuh"

using namespace thawk;

template <typename T>
static cudaError_t run(const void* x, const stream::Weights& w13, const stream::Weights& w2,
                       const void* gain, float* h, void* y, int B, int D, int F, float eps,
                       const stream::Plan& pa, const stream::Plan& pb, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const cudaError_t rc =
      stream::gate_up(xt, B, D, w13, 2 * F, static_cast<const T*>(gain), eps, h, pa, s);
  return rc != cudaSuccess ? rc : stream::down(h, B, F, w2, D, xt, static_cast<T*>(y), pb, s);
}

// Kernel 2.  x, y [B, D] and gain [D] in dtype; each weight as (qs, scales,
// mins, hi, form), hi the sb form's scmn; h [B, F] f32 scratch; each
// launch's plan (K segments, ring stages, blocks, parts:
// ops/cuda/qmatmul.py stream_plan) as four ints, the gate/up launch's then
// the down launch's.  An unknown form or a shape or plan the walk does not take
// returns an invalid-value error.
extern "C" int th_ffn(const void* x, const void* w13_qs, const void* w13_s, const void* w13_m,
                      const void* w13_hi, int w13_form, const void* w2_qs, const void* w2_s,
                      const void* w2_m, const void* w2_hi, int w2_form, const void* gain,
                      void* h_scratch, void* y, int B, int D, int F, float eps, int dtype,
                      int splits_a, int stages_a, int blocks_a, int parts_a, int splits_b,
                      int stages_b, int blocks_b, int parts_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(h_scratch);
  const stream::Weights w13{w13_qs, w13_s, w13_m, w13_hi, w13_form};
  const stream::Weights w2{w2_qs, w2_s, w2_m, w2_hi, w2_form};
  const stream::Plan pa{splits_a, stages_a, blocks_a, parts_a},
      pb{splits_b, stages_b, blocks_b, parts_b, true};
  const cudaError_t rc =
      dtype == kBF16 ? run<__nv_bfloat16>(x, w13, w2, gain, h, y, B, D, F, eps, pa, pb, s)
                     : run<float>(x, w13, w2, gain, h, y, B, D, F, eps, pa, pb, s);
  return rc != cudaSuccess ? static_cast<int>(rc) : THAWK_LAUNCH_RESULT();
}

template <typename T>
static cudaError_t run_owo(const void* ctx, const void* x, const stream::Weights& wo,
                           const stream::Weights& w13, const stream::Weights& w2,
                           const void* gain, float* xp, float* h, void* y, int B, int Dq, int D,
                           int F, float eps, const stream::Plan& pa, const stream::Plan& pb,
                           const stream::Plan& pc, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  cudaError_t rc = stream::down(static_cast<const T*>(ctx), B, Dq, wo, D, xt, xp, pa, s);
  if (rc == cudaSuccess)
    rc = stream::gate_up(xp, B, D, w13, 2 * F, static_cast<const T*>(gain), eps, h, pb, s);
  return rc != cudaSuccess ? rc : stream::down(h, B, F, w2, D, xp, static_cast<T*>(y), pc, s);
}

// Kernel 15.  ctx [B, Dq] and x, y [B, D] in dtype; each weight as
// (qs, scales, mins, hi, form), hi unused (no sb form), Wo and w13 without
// mins; gain [D] in dtype; xp [B, D] and h [B, F] f32 scratch; the three
// launches' plans (K segments, ring stages, blocks, parts: ops/cuda/qmatmul.py
// stream_plan), A's, B's, then C's.  A form the gate refuses returns an
// invalid-value error before any launch, a shape or plan a launch does not
// take the same error from that launch.
extern "C" int th_owo_ffn(const void* ctx, const void* x, const void* wo_qs, const void* wo_s,
                          const void* wo_m, const void*, int wo_form, const void* w13_qs,
                          const void* w13_s, const void* w13_m, const void*, int w13_form,
                          const void* w2_qs, const void* w2_s, const void* w2_m, const void*,
                          int w2_form, const void* gain, void* xp_scratch, void* h_scratch,
                          void* y, int B, int Dq, int D, int F, float eps, int dtype,
                          int splits_a, int stages_a, int blocks_a, int parts_a, int splits_b,
                          int stages_b, int blocks_b, int parts_b, int splits_c, int stages_c,
                          int blocks_c, int parts_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xp = static_cast<float*>(xp_scratch);
  float* h = static_cast<float*>(h_scratch);
  for (const int form : {wo_form, w13_form})
    if (form != kFormQ4 && form != kFormG32 && form != kFormG16)
      return static_cast<int>(cudaErrorInvalidValue);
  if (w2_form < kFormQ4 || w2_form > kFormG16Mins) return static_cast<int>(cudaErrorInvalidValue);
  const stream::Weights wo{wo_qs, wo_s, wo_m, nullptr, wo_form};
  const stream::Weights w13{w13_qs, w13_s, w13_m, nullptr, w13_form};
  const stream::Weights w2{w2_qs, w2_s, w2_m, nullptr, w2_form};
  const stream::Plan pa{splits_a, stages_a, blocks_a, parts_a},
      pb{splits_b, stages_b, blocks_b, parts_b, true},
      pc{splits_c, stages_c, blocks_c, parts_c, true};
  const cudaError_t rc =
      dtype == kBF16
          ? run_owo<__nv_bfloat16>(ctx, x, wo, w13, w2, gain, xp, h, y, B, Dq, D, F, eps, pa, pb,
                                   pc, s)
          : run_owo<float>(ctx, x, wo, w13, w2, gain, xp, h, y, B, Dq, D, F, eps, pa, pb, pc, s);
  return rc != cudaSuccess ? static_cast<int>(rc) : THAWK_LAUNCH_RESULT();
}
