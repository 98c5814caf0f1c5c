// Kernel 18: one shard's softmax partials of decode attention over the dense
// bf16/f32 KV cache.
//
// Replaces tokenhawk_tpu/ops/pallas/flash_decode_dma.py flash_decode_stats
// (_kernel_vec_stats), the per-shard half of context-parallel decode
// (parallel/ring.py decode_attend_cp): attention of the rep query heads of
// each (b, kv head) over its first lengths[b] rows (clamped to [0, S]; q
// pre-scaled, in the cache's type), without the final normalisation: the
// unnormalised o in f32 and each query row's max m and sum l.  Its cache may
// be a strided view (one cyclic shard of a larger cache: batch, head and row
// strides come from the wrapper, rows contiguous and 16-byte aligned).  A
// range with no row writes the merge identity (0, -inf, 0) and reads
// nothing.
//
// What bounds it on the H100: the bytes of the live K/V rows, as kernel 3.
// It runs kernel 3's shared-memory tile walk (decode_tiles.cuh, Partials
// epilogue) in one of three launches:
//   - `splits` > 1 (explicit): one block a tile-aligned range of the live
//     rows (no floor: as many tiles as an even cut gives), each writing its
//     own partials for the caller to merge (kGrid);
//   - `cluster` > 1 (splits 1, where B*Hkv leaves SMs idle: CP decode at
//     B=1): the one range cut over a thread-block cluster, ranges of at
//     least min_tiles tiles, merged on chip into one partial, m the max of
//     the ranges' m, o and l their sums weighted by exp(m_s - m) in split
//     order, never divided (kCluster);
//   - otherwise one block a (b, kv head) (kOne).
#include "decode_tiles.cuh"

using namespace thawk;
using tiles::DenseRows;
using tiles::Partials;

namespace {

// Block (split, b * Hkv + h) (kGrid, kCluster) or b * Hkv + h (kOne); o
// [splits, B, Hkv, REP, DH], m, l [splits, B, Hkv * REP], splits 1 but in
// kGrid.
template <typename T, int REP, int DH, tiles::Mode MODE>
__global__ void __launch_bounds__(tiles::kThreads)
    decode_stats_tiles_kernel(const T* __restrict__ q, const T* kc, const T* vc,
                              const int* __restrict__ lengths, float* __restrict__ o,
                              float* __restrict__ m, float* __restrict__ l, int B, int Hkv,
                              int S, long long sb, long long sh, long long sr, int min_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = MODE == tiles::kOne ? 0 : static_cast<int>(blockIdx.x);
  const int splits = MODE == tiles::kOne ? 1 : static_cast<int>(gridDim.x);
  const int bh = MODE == tiles::kOne ? blockIdx.x : blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const size_t co = b * sb + h * sh;
  const int slot = MODE == tiles::kGrid ? split : 0;  // o, m, l [slot, b, h]
  const size_t row0 = (static_cast<size_t>(slot) * B * Hkv + bh) * REP;
  tiles::walk<T, T, REP, DH, MODE, false>(
      smem, q + static_cast<size_t>(bh) * REP * DH, DenseRows<const T>{kc + co, vc + co, sr},
      static_cast<const T*>(nullptr), static_cast<const T*>(nullptr),
      min(max(lengths[b], 0), S), split, splits, min_tiles,
      Partials<DH>{o + row0 * DH, m + row0, l + row0});
}

struct StatsArgs {
  const void* q;
  const void* kc;
  const void* vc;
  const int* lengths;
  float *o, *m, *l;
  int B, Hkv, S, splits;
  long long sb, sh, sr;
  int cluster, min_tiles;
  cudaStream_t stream;
};

template <typename T, int REP, int DH, tiles::Mode MODE>
cudaError_t launch_mode(const StatsArgs& a, int blocks) {
  using A = tiles::Tiles<T, REP, DH>;
  constexpr bool kClustered = MODE == tiles::kCluster;
  auto* fn = decode_stats_tiles_kernel<T, REP, DH, MODE>;
  static const cudaError_t allowed = tiles::allow(fn, kClustered ? A::kMaxBytes : A::kBytes,
                                                  kClustered);
  if (allowed != cudaSuccess) return allowed;
  const int cluster = kClustered ? blocks : 1;
  return tiles::launch(fn, MODE == tiles::kOne ? dim3(a.B * a.Hkv) : dim3(blocks, a.B * a.Hkv),
                       cluster, tiles::smem_bytes<T, REP, DH>(cluster), a.stream,
                       static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
                       static_cast<const T*>(a.vc), a.lengths, a.o, a.m, a.l, a.B, a.Hkv, a.S,
                       a.sb, a.sh, a.sr, MODE == tiles::kGrid ? 1 : a.min_tiles);
}

// Kernel 18's launch at one instance (TC = T: one type for q and cache).
template <typename T, typename, int REP, int DH>
struct LaunchStats {
  static cudaError_t run(const StatsArgs& a) {
    if (a.splits > 1) return launch_mode<T, REP, DH, tiles::kGrid>(a, a.splits);
    if (a.cluster > 1) return launch_mode<T, REP, DH, tiles::kCluster>(a, a.cluster);
    return launch_mode<T, REP, DH, tiles::kOne>(a, 1);
  }
};

}  // namespace

// Kernel 18.  q [B, Hkv, rep, Dh] in dtype (pre-scaled); caches of
// [B, Hkv, S, Dh] shape in dtype, element strides sb, sh, sr between
// sequences, heads and rows (the last dim contiguous, rows 16-byte
// aligned); lengths [B] int32 (clamped to [0, S]); o [splits, B, Hkv, rep,
// Dh], m, l [splits, B, Hkv*rep] f32.  rep is 1, 2, 4 or 8, Dh 64 or 128
// (checked by the Python wrapper).  splits > 1 writes each range's
// partials (ranges with no floor); with splits 1, cluster 2-16 cuts the one
// range over a cluster (ranges of at least min_tiles tiles) merged into one
// partial, cluster 1 one block a (b, kv head).
extern "C" int th_flash_decode_stats(const void* q, const void* kc, const void* vc,
                                     const void* lengths, void* o, void* m, void* l, int B,
                                     int Hkv, int rep, int Dh, int S, int splits, long long sb,
                                     long long sh, long long sr, int cluster, int min_tiles,
                                     int dtype, void* stream) {
  if (splits < 1 || cluster < 1 || cluster > tiles::kMaxSplits || min_tiles < 1 ||
      (splits > 1 && cluster > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const StatsArgs a{q, kc, vc, static_cast<const int*>(lengths), static_cast<float*>(o),
                    static_cast<float*>(m), static_cast<float*>(l), B, Hkv, S, splits, sb, sh,
                    sr, cluster, min_tiles, static_cast<cudaStream_t>(stream)};
  const cudaError_t e = tiles::dispatch<LaunchStats, false>(a, dtype, dtype, rep, Dh);
  const int last = THAWK_LAUNCH_RESULT();  // also clears a failed launch's error
  return e != cudaSuccess ? static_cast<int>(e) : last;
}
