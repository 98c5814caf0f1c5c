// The shared-memory tile walk of decode attention, one instance a kernel:
// kernel 3 (decode_append.cu: append + attend over the dense cache),
// kernel 18 (decode_stats.cu: one shard's softmax partials over a strided
// dense cache) and kernel 5 (paged_decode.cu: attend through a page table).
//
// What bounds them on the H100: the bytes of the live K/V rows,
// 2*L*Dh*sizeof(cache) a head.  Decode has few (sequence, kv head) pairs (32
// at B=1 over LLaMA-7B's heads) for 132 SMs, and each block's loads must be
// in flight together to reach the card's rate.  So each block brings its
// range of K/V rows into shared memory by cp.async before any arithmetic,
// and where B*Hkv is below the SM count the pair's live rows are cut over a
// thread-block cluster (ranges cut on the card from lengths), the partials
// merged on chip.
//
// The walk: the block's rows [begin, end) of one head come into shared
// memory by 16-byte cp.async, a chunk of CR rows (64 of a 2-byte cache, 32
// of a 4-byte one) at a time into a two-chunk ring, all of a chunk's copies
// issued before any arithmetic and the next chunk's in flight while this
// one is computed; rows are padded by 16 bytes.  Per chunk, with all 8
// warps busy:
//   - scores: a warp takes RW = CR / 8 rows, PARTS = 32 / RW lanes a row,
//     each lane the row's 16-byte pieces part, part + PARTS, ... against q
//     (f32, in shared memory), summed over the row's lanes by shuffles;
//   - the chunk's max per query row from the warps' maxima (one barrier);
//     p = exp(s - m) written to shared memory by one lane a row (another);
//   - P·V: thread t owns head dims 2 (t % (DH/2)) and +1 over the rows
//     g, g + G, ... (g = t / (DH/2), G = 256 / (DH/2)), the loop unrolled
//     over the chunk, V read from shared memory; each thread rescales its
//     sums by exp(m_old - m) and adds up its rows' p for l.
// At the end the G groups' sums add up through shared memory (the ring's
// space).  Rows: a policy gives the element offset of row r in the head's
// K and V (DenseRows: r times a row stride; PagedRows: through the
// sequence's page table, so a chunk may span pages).  APPEND (kernel 3):
// the block whose range holds row L-1 writes k_new / v_new there in the
// cache and puts the same values into its own tile in place of a copy, so
// no block reads that row back from device memory.
//
// Modes:
//   kOne: one block a pair takes [0, L);
//   kGrid: block `split` of `splits` takes its range (kernel 18's explicit
//     splits) and writes its own partials;
//   kCluster: block (split, pair) of a cluster of `splits` blocks takes its
//     range (at least min_tiles tiles: a short length fills the first
//     ranges and leaves the rest empty) and stores its partials (o, m, l)
//     into slot `split` of block 0's shared memory over distributed shared
//     memory, then arrives on the cluster barrier and leaves; block 0 alone
//     waits, then merges the slots of the ranges that hold rows (the max of
//     m, each partial weighted by exp(m - max), the sums in split order).
//     A first arrival at the start, waited on before the stores, makes sure
//     block 0 runs before anyone writes into it.  Where the first range
//     holds every live row (a short length), its block writes as kOne does
//     and the others leave at once: no merge, no cluster barrier.
// Epilogues: Normalised divides once and rounds to the output type
// (kernels 3 and 5); Partials writes the unnormalised o, m and l in f32
// (kernel 18: a cluster's merge gives one partial, never divided).  A pair
// with no live row (L = 0: kernel 5's length 0, kernel 18's empty shard or
// range) writes the epilogue's empty value, zeros or the merge identity
// (0, -inf, 0), and reads nothing; the merge only ever takes ranges that
// hold rows, so it never meets exp(-inf - -inf).
#pragma once

#include <cooperative_groups.h>

#include "mma.cuh"

namespace thawk {
namespace tiles {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 16;  // blocks a cluster

enum Mode { kOne, kGrid, kCluster };

// Split arrive / wait on the cluster barrier (all threads of every block).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename TC, int REP, int DH>
struct Tiles {
  static constexpr int kElt = sizeof(TC);
  static constexpr int kRow = DH + 16 / kElt;  // a shared row, padded by 16 bytes
  static constexpr int CR = kElt == 2 ? 64 : 32;
  static constexpr int RW = CR / kWarps;
  static constexpr int PARTS = 32 / RW;
  static constexpr int EPP = 16 / kElt;  // elements a 16-byte piece
  static constexpr int PIECES = DH / EPP;
  static constexpr int PPL = PIECES / PARTS;  // pieces a lane scores
  static constexpr int G = kWarps * 32 / (DH / 2);
  static constexpr int RG = CR / G;  // rows a thread takes in P·V
  static constexpr int kRingBytes = 2 * 2 * CR * kRow * kElt;  // chunks x (K, V)
  // q [REP][DH], p [REP][CR], the warps' maxima [kWarps][REP], all f32.
  static constexpr int kBytes = kRingBytes + (REP * DH + REP * CR + kWarps * REP) * 4;
  // kCluster: block 0's slots, o [REP * DH], m [REP] and l [REP] for each split.
  static constexpr int kSlot = REP * DH + 2 * REP;
  static constexpr int kMaxBytes = kBytes + kMaxSplits * kSlot * 4;
  static_assert(PPL >= 1 && PIECES % PARTS == 0 && CR % G == 0, "tile shape");
  static_assert(kRingBytes >= G * REP * (DH + 1) * 4, "room for the groups' sums");
};

// Dynamic shared memory of one block: the walk's, and in a cluster of
// `splits` blocks the slots.
template <typename TC, int REP, int DH>
int smem_bytes(int splits) {
  using A = Tiles<TC, REP, DH>;
  return A::kBytes + (splits > 1 ? splits * A::kSlot * 4 : 0);
}

// Row r of a dense head at r * stride elements (P: TC, or const TC where
// the cache is only read).
template <typename P>
struct DenseRows {
  P* k;
  P* v;
  long long stride;
  __device__ __forceinline__ size_t at(int r) const { return static_cast<size_t>(r) * stride; }
};

// Row r of a paged head: slot r % ps of page pages[r / ps], the head's base
// `k` / `v` (h * head_stride) already applied.
template <typename TC, int DH>
struct PagedRows {
  const TC* k;
  const TC* v;
  const int* pages;  // the sequence's row of the page table
  int ps;
  long long page_stride;
  __device__ __forceinline__ size_t at(int r) const {
    return static_cast<size_t>(pages[r / ps]) * page_stride + static_cast<size_t>(r % ps) * DH;
  }
};

// out[REP * DH] = num / den rounded to TO; zeros for a pair with no row.
template <typename TO>
struct Normalised {
  TO* out;
  __device__ __forceinline__ void put(int i, float num, float den) const {
    out[i] = from_f32<TO>(num / den);
  }
  __device__ __forceinline__ void put_m(int, float) const {}
  __device__ __forceinline__ void empty(int i) const { out[i] = from_f32<TO>(0.f); }
};

// o[REP * DH] = num, m[REP], l[REP] = den, all f32; the merge identity
// (0, -inf, 0) for no row.
template <int DH>
struct Partials {
  float* o;
  float* m;
  float* l;
  __device__ __forceinline__ void put(int i, float num, float den) const {
    o[i] = num;
    if (i % DH == 0) l[i / DH] = den;
  }
  __device__ __forceinline__ void put_m(int r, float mx) const { m[r] = mx; }
  __device__ __forceinline__ void empty(int i) const {
    o[i] = 0.f;
    if (i % DH == 0) {
      m[i / DH] = -INFINITY;
      l[i / DH] = 0.f;
    }
  }
};

// One block's walk over its range of one (sequence, kv head) pair's L live
// rows (see the header): q, k_new, v_new and the epilogue already at the
// pair (and, kGrid, the split); `split` of `splits` from the grid.
template <typename TQ, typename TC, int REP, int DH, Mode MODE, bool APPEND, typename Rows,
          typename Ep>
__device__ __forceinline__ void walk(unsigned char* smem, const TQ* __restrict__ q, Rows rows,
                                     const TQ* __restrict__ kn, const TQ* __restrict__ vn, int L,
                                     int split, int splits, int min_tiles, Ep ep) {
  namespace cg = cooperative_groups;
  using A = Tiles<TC, REP, DH>;
  constexpr int NT = kThreads;
  constexpr int CR = A::CR, kRow = A::kRow, PARTS = A::PARTS, EPP = A::EPP;
  TC* ring = reinterpret_cast<TC*>(smem);
  float* qsm = reinterpret_cast<float*>(smem + A::kRingBytes);  // [REP][DH]
  float* psm = qsm + REP * DH;                                   // [REP][CR]
  float* wmx = psm + REP * CR;                                   // [kWarps][REP]
  float* slots = wmx + kWarps * REP;  // kCluster: [splits][A::kSlot] in block 0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int begin = 0, end = L;
  // The ranges that hold rows; in a cluster with at most one, its block
  // writes as one block a pair does and the others leave: no merge, no
  // cluster barrier (every block of the cluster reads the same L, so all
  // agree).
  int n_live = L > 0 ? 1 : 0;
  if constexpr (MODE != kOne) {
    const int per = max(((L + 31) / 32 + splits - 1) / splits, min_tiles) * 32;  // rows a split
    begin = min(split * per, L);
    end = min(begin + per, L);
    n_live = (L + per - 1) / per;
    if (MODE == kCluster && n_live <= 1 && split > 0) return;
  }
  const bool merge = MODE == kCluster && n_live > 1;
  if (merge) cluster_arrive_relaxed();  // this block runs

  if (begin < end) {
    if constexpr (APPEND) {
      if (end == L && tid < DH) {  // this range holds row L-1: append it
        const size_t dst = rows.at(L - 1) + tid;
        rows.k[dst] = from_f32<TC>(to_f32(kn[tid]));
        rows.v[dst] = from_f32<TC>(to_f32(vn[tid]));
      }
    }
    const int n_chunks = (end - begin + CR - 1) / CR;
    // Chunk c's K and V rows into ring half c & 1; rows past end are
    // zero-filled (APPEND: row L-1 comes from k_new / v_new).
    auto issue = [&](int c) {
      TC* kt = ring + (c & 1) * 2 * CR * kRow;
      TC* vt = kt + CR * kRow;
      const int row0 = begin + c * CR;
      for (int i = tid; i < CR * A::PIECES; i += NT) {
        const int j = i / A::PIECES, e = (i % A::PIECES) * EPP, row = row0 + j;
        const bool ok = row < end;
        if constexpr (APPEND) {
          if (ok && row == L - 1) {
#pragma unroll
            for (int x = 0; x < EPP; ++x) {
              kt[j * kRow + e + x] = from_f32<TC>(to_f32(kn[e + x]));
              vt[j * kRow + e + x] = from_f32<TC>(to_f32(vn[e + x]));
            }
            continue;
          }
        }
        const size_t src = (ok ? rows.at(row) : 0) + e;
        cp_async16(kt + j * kRow + e, rows.k + src, ok);
        cp_async16(vt + j * kRow + e, rows.v + src, ok);
      }
    };
    issue(0);
    cp_async_commit();
    if (n_chunks > 1) {
      issue(1);
      cp_async_commit();
    }
    for (int i = tid; i < REP * DH; i += NT) qsm[i] = to_f32(q[i]);

    const int lrow = lane / PARTS, part = lane % PARTS;
    const int j = warp * A::RW + lrow;  // the row this lane scores, in the chunk
    const int dp = tid % (DH / 2), g = tid / (DH / 2);
    float m[REP], l[REP], acc[REP][2];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      m[r] = -INFINITY;
      l[r] = acc[r][0] = acc[r][1] = 0.f;
    }
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // chunk c (and q, on the first) landed for every thread
      const TC* kt = ring + (c & 1) * 2 * CR * kRow;
      const TC* vt = kt + CR * kRow;

      // Scores of row j against the REP query rows.
      float s[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) s[r] = 0.f;
#pragma unroll
      for (int pi = 0; pi < A::PPL; ++pi) {
        const int e = (pi * PARTS + part) * EPP;
        float kv[8];
        if constexpr (EPP == 8) {
          load8(kt + j * kRow + e, kv);
        } else {
          const float4 v4 = *reinterpret_cast<const float4*>(kt + j * kRow + e);
          kv[0] = v4.x; kv[1] = v4.y; kv[2] = v4.z; kv[3] = v4.w;
        }
#pragma unroll
        for (int r = 0; r < REP; ++r) {
#pragma unroll
          for (int x = 0; x < EPP; x += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qsm + r * DH + e + x);
            s[r] += q4.x * kv[x] + q4.y * kv[x + 1] + q4.z * kv[x + 2] + q4.w * kv[x + 3];
          }
        }
      }
      const bool valid = begin + c * CR + j < end;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
#pragma unroll
        for (int o = 1; o < PARTS; o <<= 1) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
        s[r] = valid ? s[r] : -INFINITY;
        float mx = s[r];
#pragma unroll
        for (int o = PARTS; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (lane == 0) wmx[warp * REP + r] = mx;
      }
      __syncthreads();  // the warps' maxima
      float alpha[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float mx = m[r];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wmx[w * REP + r]);  // finite: row 0 is live
        alpha[r] = expf(m[r] - mx);  // 0 on the first chunk
        m[r] = mx;
        if (part == 0) psm[r * CR + j] = valid ? expf(s[r] - mx) : 0.f;
      }
      __syncthreads();  // p of the chunk's rows
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        acc[r][0] *= alpha[r];
        acc[r][1] *= alpha[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < A::RG; ++i) {
        const int jj = g + i * A::G;
        const float2 v = load2(vt + jj * kRow + 2 * dp);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float p = psm[r * CR + jj];
          acc[r][0] += p * v.x;
          acc[r][1] += p * v.y;
          l[r] += p;
        }
      }
      __syncthreads();  // ring half c & 1, p and the maxima are free again
      if (c + 2 < n_chunks) {
        issue(c + 2);
        cp_async_commit();
      }
    }

    // The G groups' sums, in the ring's space: [G][REP][DH] and l [G][REP].
    float* red = reinterpret_cast<float*>(smem);
    float* red_l = red + A::G * REP * DH;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      *reinterpret_cast<float2*>(red + (g * REP + r) * DH + 2 * dp) =
          make_float2(acc[r][0], acc[r][1]);
      if (dp == 0) red_l[g * REP + r] = l[r];
    }
    __syncthreads();
    // kCluster: this block's slot in block 0 (every block of the cluster runs now).
    float* slot = nullptr;
    if (merge) {
      cluster_wait();
      slot = cg::this_cluster().map_shared_rank(slots, 0) + split * A::kSlot;
    }
    for (int i = tid; i < REP * DH; i += NT) {
      const int r = i / DH;
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int gg = 0; gg < A::G; ++gg) {
        num += red[(gg * REP + r) * DH + i % DH];
        den += red_l[gg * REP + r];
      }
      if (merge) {
        slot[i] = num;
        if (i % DH == 0) slot[REP * DH + REP + r] = den;
      } else {
        ep.put(i, num, den);
      }
    }
    if (tid == 0) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (merge)
          slot[REP * DH + r] = m[r];
        else
          ep.put_m(r, m[r]);
      }
    }
  } else if (merge) {
    cluster_wait();  // an empty range's block: both arrivals, nothing stored
  } else {
    // No row to read (L = 0, or kGrid's empty range): the empty value.
    for (int i = tid; i < REP * DH; i += NT) ep.empty(i);
  }
  if (merge) {
    cluster_arrive();  // this block's slot stored (release)
    if (split > 0) return;
    cluster_wait();  // every slot stored (acquire)
    for (int i = tid; i < REP * DH; i += NT) {
      const int r = i / DH;
      float mx = -INFINITY;
      for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, slots[s * A::kSlot + REP * DH + r]);
      float num = 0.f, den = 0.f;
      for (int s = 0; s < n_live; ++s) {
        const float* sl = slots + s * A::kSlot;
        const float f = expf(sl[REP * DH + r] - mx);
        num += sl[i] * f;
        den += sl[REP * DH + REP + r] * f;
      }
      ep.put(i, num, den);
      if (i % DH == 0) ep.put_m(r, mx);
    }
  }
}

// Allows `fn` (a walk kernel) its most dynamic shared memory and, where it
// runs in clusters, clusters above 8 blocks (not portable); the caller
// keeps the result in a static, so this runs once for each kernel.
template <typename F>
cudaError_t allow(F* fn, int max_smem, bool clustered) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e == cudaSuccess && clustered)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// Launches `fn` on `grid` blocks of kThreads threads with `smem` bytes of
// dynamic shared memory, in clusters of cluster x 1 x 1 blocks where
// cluster > 1.
template <typename... Params, typename... Args>
cudaError_t launch(void (*fn)(Params...), dim3 grid, int cluster, int smem, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, fn, args...);
}

// The C entries' dispatch: Launch<TQ, TC, REP, DH>::run(a) at the instance
// that the runtime q and cache types (kBF16 or f32), rep (1, 2, 4, or 8 for
// any other) and head dim (64, or 128 for any other) name.  MIXED false
// builds only TC = TQ and takes q's type for both.
template <template <typename, typename, int, int> class Launch, typename TQ, typename TC, int DH,
          typename Args>
cudaError_t dispatch_rep(const Args& a, int rep) {
  switch (rep) {
    case 1: return Launch<TQ, TC, 1, DH>::run(a);
    case 2: return Launch<TQ, TC, 2, DH>::run(a);
    case 4: return Launch<TQ, TC, 4, DH>::run(a);
    default: return Launch<TQ, TC, 8, DH>::run(a);
  }
}

template <template <typename, typename, int, int> class Launch, typename TQ, typename TC,
          typename Args>
cudaError_t dispatch_dh(const Args& a, int rep, int Dh) {
  return Dh == 64 ? dispatch_rep<Launch, TQ, TC, 64>(a, rep)
                  : dispatch_rep<Launch, TQ, TC, 128>(a, rep);
}

template <template <typename, typename, int, int> class Launch, bool MIXED, typename Args>
cudaError_t dispatch(const Args& a, int q_dtype, int cache_dtype, int rep, int Dh) {
  if constexpr (MIXED) {
    if (q_dtype == kBF16 && cache_dtype != kBF16)
      return dispatch_dh<Launch, __nv_bfloat16, float>(a, rep, Dh);
    if (q_dtype != kBF16 && cache_dtype == kBF16)
      return dispatch_dh<Launch, float, __nv_bfloat16>(a, rep, Dh);
  }
  return q_dtype == kBF16 ? dispatch_dh<Launch, __nv_bfloat16, __nv_bfloat16>(a, rep, Dh)
                          : dispatch_dh<Launch, float, float>(a, rep, Dh);
}

}  // namespace tiles
}  // namespace thawk
