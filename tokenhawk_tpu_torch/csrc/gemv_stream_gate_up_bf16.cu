// Kernel 2's gate/up launch on the decode-row walk (gemv_stream.cuh),
// bfloat16 x.
// One translation unit a launch and type, so that the walk's instances
// compile in parallel.
#include "gemv_stream.cuh"

namespace thawk {
namespace stream {

cudaError_t gate_up(const __nv_bfloat16* x, int B, int D, const Weights& w, int F2,
                    const __nv_bfloat16* gain, float eps, float* h, const Plan& p,
                    cudaStream_t stream) {
  return gate_up_of<true>(x, B, D, w, F2, gain, eps, h, p, stream);
}

}  // namespace stream
}  // namespace thawk
