// Kernel 15's down launch on the decode-row walk (gemv_stream.cuh) at
// bfloat16: y = x' + h @ W2, h and the residual x' f32, y bfloat16, w2 in
// any form but sb.  The float32 form is kernel 2's down instance
// (gemv_stream_down_f32.cu).
// One translation unit a launch and type, so that the walk's instances
// compile in parallel.
#include "gemv_stream.cuh"

namespace thawk {
namespace stream {

cudaError_t down(const float* x, int B, int K, const Weights& w, int N, const float* residual,
                 __nv_bfloat16* y, const Plan& p, cudaStream_t stream) {
  return down_of<true>(x, B, K, w, N, residual, y, p, stream);
}

}  // namespace stream
}  // namespace thawk
