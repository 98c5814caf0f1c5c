// Kernel 2's down launch on the decode-row walk (gemv_stream.cuh), a
// bfloat16 residual and output.
// One translation unit a launch and type, so that the walk's instances
// compile in parallel.
#include "gemv_stream.cuh"

namespace thawk {
namespace stream {

cudaError_t down(const float* h, int B, int F, const Weights& w, int D,
                 const __nv_bfloat16* residual, __nv_bfloat16* y, const Plan& p,
                 cudaStream_t stream) {
  return down_of(h, B, F, w, D, residual, y, p, stream);
}

}  // namespace stream
}  // namespace thawk
