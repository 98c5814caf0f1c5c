// Kernel 15's Wo launch on the decode-row walk (gemv_stream.cuh) at
// bfloat16: x' [B, D] f32 = x + ctx @ Wo, ctx and the residual x bfloat16,
// Wo in the forms without mins but sb (the gate's).  The float32 form is
// kernel 2's down instance (gemv_stream_down_f32.cu).
// One translation unit a launch and type, so that the walk's instances
// compile in parallel.
#include "gemv_stream.cuh"

namespace thawk {
namespace stream {

cudaError_t down(const __nv_bfloat16* x, int B, int K, const Weights& w, int N,
                 const __nv_bfloat16* residual, float* y, const Plan& p, cudaStream_t stream) {
  return down_of<false>(x, B, K, w, N, residual, y, p, stream);
}

}  // namespace stream
}  // namespace thawk
