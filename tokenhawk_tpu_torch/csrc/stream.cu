// Kernel 20: the HBM read-stream probe, seed + the f32 sum of a bfloat16 array.
//
// Replaces tokenhawk_tpu/utils/benchlib.py hbm_stream_gbps (_stream_sum_kernel):
// a Pallas block pipeline that copies [block_rows, 1024] blocks into VMEM and
// adds each one's sum into an SMEM scalar carried across the sequential grid,
// so that the only HBM traffic is one read of the array.  The seed makes
// repeated calls a chain (each call takes the previous one's output), so no
// call can be hoisted or elided.
//
// On the H100 the blocks run in parallel and carry nothing between them, so
// the sum takes two launches.  stream_partials: a grid-stride loop in which
// each thread keeps kUnroll 16-byte loads (8 bfloat16 values each) in flight,
// adds them in f32, and the block's sum goes through warp shuffles and shared
// memory into partials[blockIdx.x]; the grid is a few blocks per SM, enough
// threads to cover the card's memory latency.  stream_finish: one block adds
// the partials, in a fixed order, to the seed.  No atomics, so the result is
// the same on every run.  Bound by bytes: one read of the array (2 GiB at
// 3.35 TB/s takes 0.641 ms); the partials are a few KB.
#include "common.cuh"

using namespace thawk;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float sum8(uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    s += f.x + f.y;
  }
  return s;
}

// The block's sum of v, valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    stream_partials(const __nv_bfloat16* __restrict__ x, long long n,
                    float* __restrict__ partials) {
  const uint4* x16 = reinterpret_cast<const uint4*>(x);
  const long long n16 = n / 8;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float acc = 0.f;
  for (; i + (kUnroll - 1) * stride < n16; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = x16[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += sum8(v[u]);
  }
  for (; i < n16; i += stride) acc += sum8(x16[i]);
  if (blockIdx.x == 0)  // the last n % 8 values
    for (long long j = n16 * 8 + threadIdx.x; j < n; j += kThreads) acc += __bfloat162float(x[j]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
    stream_finish(const float* __restrict__ partials, int n_partials,
                  const float* __restrict__ seed, float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = seed[0] + acc;
}

}  // namespace

// x: bfloat16 [n], 16-byte aligned; seed, out: one f32 each; partials: f32
// [blocks] scratch.
extern "C" int th_stream_sum(const void* x, long long n, const void* seed, void* partials,
                             int blocks, void* out, cudaStream_t stream) {
  stream_partials<<<blocks, kThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(x), n,
                                                   static_cast<float*>(partials));
  const int rc = THAWK_LAUNCH_RESULT();
  if (rc != 0) return rc;
  stream_finish<<<1, kThreads, 0, stream>>>(static_cast<const float*>(partials), blocks,
                                            static_cast<const float*>(seed),
                                            static_cast<float*>(out));
  return THAWK_LAUNCH_RESULT();
}
