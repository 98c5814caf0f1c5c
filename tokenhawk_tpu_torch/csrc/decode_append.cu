// Kernel 3: decode append + attention over the dense bf16/f32 KV cache.
//
// Replaces tokenhawk_tpu/ops/pallas/flash_decode_dma.py
// flash_decode_append_walk (_kernel_walk_append) and its grid form
// flash_decode_append (_kernel_vec_append): for each (b, kv head) it writes
// k_new / v_new at slot lengths[b]-1 in place, then attends the rep query
// heads of that kv head over lengths[b] tokens (q pre-scaled, an online
// softmax in f32).
//
// What bounds it on the H100: the bytes of the live K/V rows,
// 2*L*Dh*sizeof(cache) a head (0.0025 ms at LLaMA-7B's heads over 512
// rows).  Decode has few (sequence, kv head) pairs (32 at B=1 over the
// 7B's heads) for 132 SMs, and each block's loads must be in flight
// together to reach the card's rate.  So each block brings its whole range
// of K/V rows into shared memory by cp.async before any arithmetic, and
// where B*Hkv is below the SM count the pair's live rows are cut over a
// thread-block cluster (kernel 14's split form's ranges, flash_decode.cu,
// cut on the card from lengths), the partials merged on chip.
#include "decode_tiles.cuh"

using namespace thawk;
using tiles::DenseRows;
using tiles::Normalised;

namespace {

// Kernel 3: block (split, b * Hkv + h) of a cluster of `splits` (SPLIT) or
// block b * Hkv + h runs the walk over the pair's max(1, min(lengths[b], S))
// rows, appending first.
template <typename TQ, typename TC, int REP, int DH, bool SPLIT>
__global__ void __launch_bounds__(tiles::kThreads)
    decode_append_tiles_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                               const TQ* __restrict__ v_new, TC* kc, TC* vc,
                               const int* __restrict__ lengths, TQ* __restrict__ out, int Hkv,
                               int S, int min_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = SPLIT ? blockIdx.y : blockIdx.x;
  const size_t qo = static_cast<size_t>(bh) * REP * DH;
  const size_t co = static_cast<size_t>(bh) * S * DH;
  tiles::walk<TQ, TC, REP, DH, SPLIT ? tiles::kCluster : tiles::kOne, true>(
      smem, q + qo, DenseRows<TC>{kc + co, vc + co, DH}, k_new + static_cast<size_t>(bh) * DH,
      v_new + static_cast<size_t>(bh) * DH, max(1, min(lengths[bh / Hkv], S)),
      SPLIT ? static_cast<int>(blockIdx.x) : 0, SPLIT ? static_cast<int>(gridDim.x) : 1,
      min_tiles, Normalised<TQ>{out + qo});
}

struct Args {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* kc;
  void* vc;
  const int* lengths;
  void* out;
  int B, Hkv, S;
  cudaStream_t stream;
  int splits;     // > 1 takes the split form,
  int min_tiles;  // its ranges at least this many tiles
};

// Kernel 3: its walk in clusters of splits x 1 x 1 blocks (SPLIT) or one
// block a pair.  Both take more than 48 KB of dynamic shared memory at
// head dim 128, and SPLIT clusters above 8 blocks: allowed once for each
// instance.
template <typename TQ, typename TC, int REP, int DH, bool SPLIT>
cudaError_t launch_append(const Args& a) {
  using A = tiles::Tiles<TC, REP, DH>;
  auto* fn = decode_append_tiles_kernel<TQ, TC, REP, DH, SPLIT>;
  static const cudaError_t allowed = tiles::allow(fn, SPLIT ? A::kMaxBytes : A::kBytes, SPLIT);
  if (allowed != cudaSuccess) return allowed;
  return tiles::launch(fn, SPLIT ? dim3(a.splits, a.B * a.Hkv) : dim3(a.B * a.Hkv),
                       SPLIT ? a.splits : 1, tiles::smem_bytes<TC, REP, DH>(SPLIT ? a.splits : 1),
                       a.stream, static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k_new),
                       static_cast<const TQ*>(a.v_new), static_cast<TC*>(a.kc),
                       static_cast<TC*>(a.vc), a.lengths, static_cast<TQ*>(a.out), a.Hkv, a.S,
                       a.min_tiles);
}

// Kernel 3's launch at one instance.
template <typename TQ, typename TC, int REP, int DH>
struct LaunchAppend {
  static cudaError_t run(const Args& a) {
    return a.splits > 1 ? launch_append<TQ, TC, REP, DH, true>(a)
                        : launch_append<TQ, TC, REP, DH, false>(a);
  }
};

}  // namespace

// Kernel 3.  q, out [B, Hkv, rep, Dh] and k_new, v_new [B, Hkv, Dh] in
// q_dtype; caches [B, Hkv, S, Dh] in cache_dtype, updated in place;
// lengths [B] int32.  rep is 1, 2, 4 or 8 and Dh 64 or 128 (checked by
// the Python wrapper).  splits 1 launches one block per (b, kv head); 2-16
// the split form, in clusters of `splits` blocks, its ranges at least
// min_tiles tiles (kernel 14's ranges).
extern "C" int th_decode_append(const void* q, const void* k_new, const void* v_new, void* kc,
                                void* vc, const void* lengths, void* out, int B, int Hkv, int rep,
                                int Dh, int S, int splits, int min_tiles, int q_dtype,
                                int cache_dtype, void* stream) {
  if (splits < 1 || splits > tiles::kMaxSplits || min_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_new, v_new, kc, vc, static_cast<const int*>(lengths), out, B, Hkv, S,
               static_cast<cudaStream_t>(stream), splits, min_tiles};
  const cudaError_t e = tiles::dispatch<LaunchAppend, true>(a, q_dtype, cache_dtype, rep, Dh);
  const int last = THAWK_LAUNCH_RESULT();  // also clears a failed launch's error
  return e != cudaSuccess ? static_cast<int>(e) : last;
}
