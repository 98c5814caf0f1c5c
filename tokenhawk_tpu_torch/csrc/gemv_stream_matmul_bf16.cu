// Kernels 1, 13 and 17 on the decode-row walk (gemv_stream.cuh), bfloat16 x.
// One translation unit a launch and type, so that the walk's instances
// compile in parallel.
#include "gemv_stream.cuh"

namespace thawk {
namespace stream {

cudaError_t matmul(const __nv_bfloat16* x, int B, int K, const Weights& w, int N,
                   const __nv_bfloat16* gain, float eps, __nv_bfloat16* y, const Plan& p,
                   cudaStream_t stream) {
  return matmul_of(x, B, K, w, N, gain, eps, y, p, stream);
}

}  // namespace stream
}  // namespace thawk
