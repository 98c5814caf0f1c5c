// Kernels 1, 13 and 17 on the decode-row walk (gemv_stream.cuh), float32 x.
// One translation unit a launch and type, so that the walk's instances
// compile in parallel.
#include "gemv_stream.cuh"

namespace thawk {
namespace stream {

cudaError_t matmul(const float* x, int B, int K, const Weights& w, int N, const float* gain,
                   float eps, float* y, const Plan& p, cudaStream_t stream) {
  return matmul_of(x, B, K, w, N, gain, eps, y, p, stream);
}

}  // namespace stream
}  // namespace thawk
