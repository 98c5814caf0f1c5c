// Kernel 14: decode attention over the dense bf16/f32 KV cache (kernels
// 3, 16 and 18, the same attention after an append, under Wo and as one
// shard's partials, run the tile walk of decode_tiles.cuh: decode_append.cu,
// attn_wo.cu, decode_stats.cu).
//
// Kernel 14 replaces tokenhawk_tpu/ops/pallas/flash_decode_dma.py
// flash_decode_dma (_kernel, _kernel_vec), flash_decode_loop (_kernel_loop)
// and ops/pallas/flash_decode.py flash_decode (_kernel, reached through
// attend_decode): kernel 3's attention with no write.  It serves
// dense-weight models, whose decode writes the cache with an index copy
// first, as the reference does.
//
// Kernel 14 runs attend_head: one block per (b, kv head), q pre-scaled by
// 1/sqrt(Dh), an online softmax in f32.  The 8 warps split the live tokens
// in tiles of 32; a lane scores one token of a tile against every query
// head of the group (16-byte loads of the K row), then owns Dh/32 of the
// head dims (4 at Dh 128, 2 at Dh 64) for P·V, one V row a step.  The
// warps' (max, sum, acc) states merge through shared memory at the end.
// Only the live tiles are read: it is bound by the cache bytes of the live
// tokens, 2*L*Dh*sizeof(cache) per head.  Kernel 14 writes nothing: its
// cache pointers are const __restrict__, so loads may take the read-only
// path.
//
// Kernel 18 (one shard's softmax partials) runs kernel 3's tile walk,
// decode_stats.cu; attend_head's STATS form, the unnormalised o and each
// query row's m and l, serves kernel 14's split form here.
//
// Kernel 14 at few (b, kv head) pairs takes a second launch, split-S with
// an on-chip merge (decode_split_kernel): one block per (b, kv head) leaves
// most of the 132 SMs idle (4 blocks at B=1 over a TinyLlama-width draft's 4
// KV heads), so where B*Hkv is below the SM count the wrapper cuts each
// pair's live rows into `splits` tile-aligned ranges, computed here from
// lengths (the host never reads lengths), none shorter than `min_tiles`
// tiles: a short live length fills its first ranges and leaves the rest
// empty rather than cut 1-tile ranges.  The `splits` blocks of one pair
// form one thread-block cluster; each runs attend_head's STATS form over
// its range and leaves its partials (o, m, l) in its own shared memory (an
// empty range the merge identity (0, -inf, 0)).
// After cluster.sync() every block merges a share of the pair's REP*DH
// outputs from all the blocks' partials over distributed shared memory
// (the max of m, each partial weighted by exp(m - max), the sums in
// split order), divides once and rounds once to q's type; a second
// cluster.sync() keeps each block's shared memory alive until the reads
// are done.  No global scratch, one launch.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace thawk;

namespace {

constexpr int kWarps = 8;

// Attention of one block's REP query rows q [REP, DH] (f32 math) over rows
// [begin, L) of one head's cache kh, vh (rows `row` elements apart) -> out
// [REP, DH] in TO.  STATS (kernel 14's split form, TO = float) writes the
// unnormalised out and each row's m_out, l_out [REP].
template <typename TQ, typename TC, int REP, int DH, typename TO, bool STATS = false>
__device__ __forceinline__ void attend_head(const TQ* __restrict__ q, const TC* kh,
                                            const TC* vh, int begin, int L, size_t row,
                                            TO* __restrict__ out, float* m_out = nullptr,
                                            float* l_out = nullptr) {
  constexpr int kPer = DH / 32;  // head dims a lane owns for P·V
  __shared__ __align__(16) float qsm[REP][DH];
  __shared__ float red_m[kWarps][REP];
  __shared__ float red_l[kWarps][REP];
  __shared__ __align__(16) float red_acc[kWarps][REP][DH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < REP * DH; i += blockDim.x) qsm[i / DH][i % DH] = to_f32(q[i]);
  __syncthreads();  // q staged

  float m[REP], l[REP], acc[REP][kPer];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[r][i] = 0.f;
  }

  const int n_tiles = (L - begin + 31) / 32;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int tok = begin + t * 32 + lane;
    const bool valid = tok < L;
    float s[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) s[r] = 0.f;
    if (valid) {
      const TC* krow = kh + static_cast<size_t>(tok) * row;
#pragma unroll 4
      for (int i = 0; i < DH; i += 8) {
        float kv[8];
        load8(krow + i, kv);
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[r] += qsm[r][i + j] * kv[j];
      }
    }
    float p[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float sr = valid ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));  // lane 0 of a tile is always live
      const float alpha = expf(m[r] - m_new);
      p[r] = valid ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[r][i] *= alpha;
    }
    const int n_live = min(32, L - begin - t * 32);
    for (int j = 0; j < n_live; ++j) {
      float v[kPer];
      load_n<kPer>(vh + static_cast<size_t>(begin + t * 32 + j) * row + lane * kPer, v);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[r][i] += pj * v[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      red_m[warp][r] = m[r];
      red_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) red_acc[warp][r][lane * kPer + i] = acc[r][i];
  }
  __syncthreads();
  for (int i = tid; i < REP * DH; i += blockDim.x) {
    const int r = i / DH, d = i % DH;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(red_m[w][r] - mx);  // 0 for a warp that had no tile
      num += red_acc[w][r][d] * f;
      den += red_l[w][r] * f;
    }
    if constexpr (STATS) {
      out[i] = num;
      if (d == 0) {
        m_out[r] = mx;
        l_out[r] = den;
      }
    } else {
      out[i] = from_f32<TO>(num / den);
    }
  }
}

// Kernel 14: attend only.
template <typename TQ, typename TC, int REP, int DH>
__global__ void __launch_bounds__(kWarps * 32)
    decode_attend_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                         const TC* __restrict__ vc, const int* __restrict__ lengths,
                         TQ* __restrict__ out, int Hkv, int S) {
  const int bh = blockIdx.x;
  const int L = max(1, min(lengths[bh / Hkv], S));
  const size_t qo = static_cast<size_t>(bh) * REP * DH;
  const size_t co = static_cast<size_t>(bh) * S * DH;
  attend_head<TQ, TC, REP, DH, TQ>(q + qo, kc + co, vc + co, 0, L, DH, out + qo);
}

// Kernel 14's split form: block (split, b * Hkv + h) of a cluster of
// gridDim.x = splits blocks attends over its range of the pair's live rows,
// then the cluster merges (see the header).
template <typename TQ, typename TC, int REP, int DH>
__global__ void __launch_bounds__(kWarps * 32)
    decode_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                        const TC* __restrict__ vc, const int* __restrict__ lengths,
                        TQ* __restrict__ out, int Hkv, int S, int min_tiles) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ __align__(16) float po[REP * DH];
  __shared__ float pm[REP], pl[REP];
  const int split = static_cast<int>(cluster.block_rank());  // blockIdx.x
  const int splits = static_cast<int>(cluster.num_blocks());  // gridDim.x
  const int bh = blockIdx.y;
  const int L = max(1, min(lengths[bh / Hkv], S));
  const int per = max(((L + 31) / 32 + splits - 1) / splits, min_tiles) * 32;  // rows a split
  const int begin = min(split * per, L), end = min(begin + per, L);
  const size_t qo = static_cast<size_t>(bh) * REP * DH;
  if (begin < end) {
    const size_t co = static_cast<size_t>(bh) * S * DH;
    attend_head<TQ, TC, REP, DH, float, true>(q + qo, kc + co, vc + co, begin, end, DH, po, pm,
                                              pl);
  } else {  // nothing to read: the merge identity
    for (int i = threadIdx.x; i < REP * DH; i += blockDim.x) po[i] = 0.f;
    if (threadIdx.x < REP) {
      pm[threadIdx.x] = -INFINITY;
      pl[threadIdx.x] = 0.f;
    }
  }
  cluster.sync();  // every block's partials written and visible to the cluster
  for (int i = split * blockDim.x + threadIdx.x; i < REP * DH; i += splits * blockDim.x) {
    const int r = i / DH;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, cluster.map_shared_rank(pm, s)[r]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float f = expf(cluster.map_shared_rank(pm, s)[r] - mx);  // 0 for an empty range
      num += cluster.map_shared_rank(po, s)[i] * f;
      den += cluster.map_shared_rank(pl, s)[r] * f;
    }
    out[qo + i] = from_f32<TQ>(num / den);
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

struct Args {
  const void* q;
  const void* kc;
  const void* vc;
  const int* lengths;
  void* out;
  int B, Hkv, S;
  cudaStream_t stream;
  int splits;     // > 1 takes the split form,
  int min_tiles;  // its ranges at least this many tiles
};

// The split form: a grid of (splits, B*Hkv) blocks in clusters of splits x
// 1 x 1 (above 8 blocks a cluster is not portable and must be allowed,
// once for each instance).
template <typename TQ, typename TC, int REP, int DH>
cudaError_t launch_split(const Args& a) {
  auto* fn = decode_split_kernel<TQ, TC, REP, DH>;
  static const cudaError_t allowed =
      cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.B * a.Hkv);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fn, static_cast<const TQ*>(a.q),
                            static_cast<const TC*>(a.kc), static_cast<const TC*>(a.vc),
                            a.lengths, static_cast<TQ*>(a.out), a.Hkv, a.S, a.min_tiles);
}

template <typename TQ, typename TC, int REP, int DH>
cudaError_t launch_one(const Args& a) {
  if (a.splits > 1) return launch_split<TQ, TC, REP, DH>(a);
  decode_attend_kernel<TQ, TC, REP, DH><<<a.B * a.Hkv, kWarps * 32, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.kc), static_cast<const TC*>(a.vc),
      a.lengths, static_cast<TQ*>(a.out), a.Hkv, a.S);
  return cudaSuccess;
}

template <typename TQ, typename TC, int DH>
cudaError_t launch_rep(const Args& a, int rep) {
  switch (rep) {
    case 1: return launch_one<TQ, TC, 1, DH>(a);
    case 2: return launch_one<TQ, TC, 2, DH>(a);
    case 4: return launch_one<TQ, TC, 4, DH>(a);
    default: return launch_one<TQ, TC, 8, DH>(a);
  }
}

template <typename TQ, typename TC>
cudaError_t launch_dh(const Args& a, int rep, int Dh) {
  return Dh == 64 ? launch_rep<TQ, TC, 64>(a, rep) : launch_rep<TQ, TC, 128>(a, rep);
}

int launch(const Args& a, int rep, int Dh, int q_dtype, int cache_dtype) {
  cudaError_t e;
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    e = launch_dh<__nv_bfloat16, __nv_bfloat16>(a, rep, Dh);
  else if (q_dtype == kBF16)
    e = launch_dh<__nv_bfloat16, float>(a, rep, Dh);
  else if (cache_dtype == kBF16)
    e = launch_dh<float, __nv_bfloat16>(a, rep, Dh);
  else
    e = launch_dh<float, float>(a, rep, Dh);
  const int last = THAWK_LAUNCH_RESULT();  // also clears a failed launch's error
  return e != cudaSuccess ? static_cast<int>(e) : last;
}

}  // namespace

// Kernel 14.  As kernel 3 (decode_append.cu) without the new rows; the
// caches are only read.
// splits 1 launches one block per (b, kv head); 2-16 the split form, in
// clusters of `splits` blocks, its ranges at least min_tiles tiles
// (checked by the Python wrapper).
extern "C" int th_decode_attend(const void* q, const void* kc, const void* vc,
                                const void* lengths, void* out, int B, int Hkv, int rep, int Dh,
                                int S, int splits, int min_tiles, int q_dtype, int cache_dtype,
                                void* stream) {
  if (splits < 1 || splits > 16 || min_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kc, vc, static_cast<const int*>(lengths), out, B, Hkv, S,
               static_cast<cudaStream_t>(stream), splits, min_tiles};
  return launch(a, rep, Dh, q_dtype, cache_dtype);
}
