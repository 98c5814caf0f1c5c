// Kernel 2's down launch and kernel 16's Wo on the decode-row walk
// (gemv_stream.cuh): f32 x, a bfloat16 residual and output.
// One translation unit a launch and type, so that the walk's instances
// compile in parallel.
#include "gemv_stream.cuh"

namespace thawk {
namespace stream {

cudaError_t down(const float* x, int B, int K, const Weights& w, int N,
                 const __nv_bfloat16* residual, __nv_bfloat16* y, const Plan& p,
                 cudaStream_t stream) {
  return down_of<true>(x, B, K, w, N, residual, y, p, stream);
}

}  // namespace stream
}  // namespace thawk
