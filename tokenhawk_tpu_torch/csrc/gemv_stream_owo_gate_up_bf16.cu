// Kernel 15's gate/up launch on the decode-row walk (gemv_stream.cuh) at
// bfloat16: the f32 x' normalised with a bfloat16 gain, w13 in the forms
// without mins but sb (the gate's).  The float32 form is kernel 2's
// gate/up instance (gemv_stream_gate_up_f32.cu).
// One translation unit a launch and type, so that the walk's instances
// compile in parallel.
#include "gemv_stream.cuh"

namespace thawk {
namespace stream {

cudaError_t gate_up(const float* x, int B, int D, const Weights& w, int F2,
                    const __nv_bfloat16* gain, float eps, float* h, const Plan& p,
                    cudaStream_t stream) {
  return gate_up_of<false>(x, B, D, w, F2, gain, eps, h, p, stream);
}

}  // namespace stream
}  // namespace thawk
