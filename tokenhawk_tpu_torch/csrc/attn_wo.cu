// Kernel 16: the attention block of one decode token, append + attend + Wo
// + residual, over the dense bf16/f32 KV cache.
//
// Replaces tokenhawk_tpu/ops/pallas/attn_block.py fused_attn_out (_attn_wo):
// for one sequence with one query per kv head,
//   x' = x + attend(q * q_scale, cache + new row) @ Wo,
// the new K / V rows written in place at lengths-1, q_scale 1/sqrt(Dh)
// rounded to q's type (the reference's wrapper scales q in its own type),
// the context kept in f32 and x' rounded once to x's type.
//
// What bounds it on the H100: the bytes of the live K / V rows
// (2*L*Dh*sizeof(cache) a head) and of Wo's codes and scales (0.625 B a
// weight for Q4_0).  The TPU kernel walks the cache, then Wo's column
// tiles, in one sequential grid, its Wo ring's first fetches issued at the
// walk's first cell so that the weight stream runs under the latency-bound
// walk.  Here two launches on one stream, each on the walk the port has
// for its half:
//   1. the attention: kernel 3's shared-memory tile walk (decode_tiles.cuh,
//      APPEND over DenseRows), one block a head or, where the heads leave
//      SMs idle, each head's live rows cut over a thread-block cluster of
//      `splits` blocks (flash_decode.decode_splits, as kernel 3 takes it)
//      and merged on chip; q scaled in the block and rounded to q's type
//      at staging; the Normalised<float> epilogue writes the unrounded
//      context into an f32 [H*Dh] scratch.  Each block lets the Wo launch
//      start once it has issued its first copies
//      (griddepcontrol.launch_dependents);
//   2. Wo: the decode-row walk (gemv_stream.cuh, stream::down: kernel 2's
//      down instances) at one row over that f32 context (K = H*Dh), x
//      added in its epilogue and x' rounded once, a programmatic dependent
//      of the attention launch: its blocks take the SMs the attention's
//      blocks free and put Wo's first ring stages in flight before
//      griddepcontrol.wait, so that Wo's stream starts while the walk's
//      last blocks run.
// One instance a (q type, cache type, head dim) serves both the one-block
// and the cluster launch (with one split the cluster form's range holds
// every row and takes the one-block path).  No atomics: both walks sum in
// a fixed order.
#include "decode_tiles.cuh"
#include "gemv_stream.cuh"

using namespace thawk;

namespace {

// Block (split, h) of a cluster of `splits` blocks runs the walk over head
// h's max(1, min(lengths[0], S)) rows, appending first.
template <typename TQ, typename TC, int DH>
__global__ void __launch_bounds__(tiles::kThreads)
    attn_ctx_tiles_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                          const TQ* __restrict__ v_new, TC* kc, TC* vc,
                          const int* __restrict__ lengths, float* __restrict__ ctx, int S,
                          int min_tiles, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t qo = static_cast<size_t>(blockIdx.y) * DH;
  const size_t co = static_cast<size_t>(blockIdx.y) * S * DH;
  tiles::walk<TQ, TC, 1, DH, tiles::kCluster, true>(
      smem, q + qo, tiles::DenseRows<TC>{kc + co, vc + co, DH}, k_new + qo, v_new + qo,
      max(1, min(lengths[0], S)), blockIdx.x, gridDim.x, min_tiles,
      tiles::Normalised<float>{ctx + qo}, q_scale, true);
}

struct Args {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* kc;
  void* vc;
  const int* lengths;
  const void* x;
  stream::Weights wo;
  float* ctx;
  void* y;
  int H, S, D, splits, min_tiles;
  float q_scale;
  stream::Plan plan;  // Wo's, a programmatic dependent
  cudaStream_t stream;
};

template <typename TQ, typename TC, int DH>
cudaError_t launch(const Args& a) {
  using A = tiles::Tiles<TC, 1, DH>;
  auto* fn = attn_ctx_tiles_kernel<TQ, TC, DH>;
  static const cudaError_t allowed = tiles::allow(fn, A::kMaxBytes, true);
  if (allowed != cudaSuccess) return allowed;
  const cudaError_t e = tiles::launch(
      fn, dim3(a.splits, a.H), a.splits, tiles::smem_bytes<TC, 1, DH>(a.splits), a.stream,
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k_new),
      static_cast<const TQ*>(a.v_new), static_cast<TC*>(a.kc), static_cast<TC*>(a.vc),
      a.lengths, a.ctx, a.S, a.min_tiles, a.q_scale);
  if (e != cudaSuccess) return e;
  return stream::down(a.ctx, 1, a.H * DH, a.wo, a.D, static_cast<const TQ*>(a.x),
                      static_cast<TQ*>(a.y), a.plan, a.stream);
}

template <typename TQ, typename TC>
cudaError_t launch_dh(const Args& a, int Dh) {
  return Dh == 64 ? launch<TQ, TC, 64>(a) : launch<TQ, TC, 128>(a);
}

}  // namespace

// Kernel 16.  q, k_new, v_new [H, Dh] in q_dtype (q unscaled); caches
// [H, S, Dh] in cache_dtype, written in place; lengths [1] int32 (tokens
// including the new one); x, y [D] in q_dtype; Wo [H*Dh, D] as (qs, scales,
// mins, hi, form), any form but sb; ctx [H*Dh] f32 scratch; the attention
// in `splits` blocks a head (1-16; a cluster above 1), its ranges at least
// min_tiles tiles; Wo's plan (K segments, ring stages, blocks, parts:
// ops/cuda/qmatmul.py stream_plan).  Dh is 64 or 128 (checked by the
// Python wrapper).  A form, split count or floor it does not take returns
// an invalid-value error before any launch.
extern "C" int th_attn_wo(const void* q, const void* k_new, const void* v_new, void* kc,
                          void* vc, const void* lengths, const void* x, const void* wo_qs,
                          const void* wo_s, const void* wo_m, const void*, int wo_form,
                          void* ctx, void* y, int H, int Dh, int S, int D, float q_scale,
                          int splits, int min_tiles, int wo_splits, int wo_stages, int wo_blocks,
                          int wo_parts, int q_dtype, int cache_dtype, void* stream) {
  if (wo_form < kFormQ4 || wo_form > kFormG16Mins || splits < 1 || splits > tiles::kMaxSplits ||
      min_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_new, v_new, kc, vc, static_cast<const int*>(lengths), x,
               stream::Weights{wo_qs, wo_s, wo_m, nullptr, wo_form}, static_cast<float*>(ctx), y,
               H, S, D, splits, min_tiles, q_scale,
               stream::Plan{wo_splits, wo_stages, wo_blocks, wo_parts, true},
               static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    e = launch_dh<__nv_bfloat16, __nv_bfloat16>(a, Dh);
  else if (q_dtype == kBF16)
    e = launch_dh<__nv_bfloat16, float>(a, Dh);
  else if (cache_dtype == kBF16)
    e = launch_dh<float, __nv_bfloat16>(a, Dh);
  else
    e = launch_dh<float, float>(a, Dh);
  const int last = THAWK_LAUNCH_RESULT();  // also clears a failed launch's error
  return e != cudaSuccess ? static_cast<int>(e) : last;
}
