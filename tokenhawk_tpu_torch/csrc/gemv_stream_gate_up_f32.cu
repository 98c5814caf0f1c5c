// Kernel 2's gate/up launch, and kernel 15's at float32, on the decode-row
// walk (gemv_stream.cuh), float32 x.
// One translation unit a launch and type, so that the walk's instances
// compile in parallel.
#include "gemv_stream.cuh"

namespace thawk {
namespace stream {

cudaError_t gate_up(const float* x, int B, int D, const Weights& w, int F2, const float* gain,
                    float eps, float* h, const Plan& p, cudaStream_t stream) {
  return gate_up_of<true>(x, B, D, w, F2, gain, eps, h, p, stream);
}

}  // namespace stream
}  // namespace thawk
