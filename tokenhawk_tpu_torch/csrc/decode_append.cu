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
#include <cooperative_groups.h>

#include "mma.cuh"

using namespace thawk;

namespace {

constexpr int kWarps = 8;
constexpr int kMaxSplits = 16;  // blocks a cluster

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

// Kernel 3's walk: the block's rows [begin, end) of one head come into
// shared memory by 16-byte cp.async, a chunk of CR rows (64 of a 2-byte
// cache, 32 of a 4-byte one) at a time into a two-chunk ring, all of a
// chunk's copies issued before any arithmetic and the next chunk's in
// flight while this one is computed; rows are padded by 16 bytes.  Per
// chunk, with all 8 warps busy:
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
// space).  The block whose range holds row L-1 writes k_new / v_new there
// in the cache and puts the same values into its own tile in place of a
// copy, so no block reads that row back from device memory.
// SPLIT: block (split, b * Hkv + h) of a cluster of `splits` blocks takes
// its range of the pair's live rows (kernel 14's split form's ranges) and
// stores its partials (o, m, l) into slot `split` of block 0's shared
// memory over distributed shared memory, then arrives on the cluster
// barrier and leaves; block 0 alone waits, then merges the slots of the
// ranges that hold rows from its own shared memory (the max of m, each
// partial weighted by exp(m - max), the sums in split order, one division:
// decode_split_kernel's merge, without its loads across the cluster and
// its second barrier).  A first arrival at the start, waited on before the
// stores, makes sure block 0 runs before anyone writes into it.  Where the
// first range holds every live row (a short length), its block divides at
// the end and the others leave at once: no merge, no cluster barrier.
// Otherwise one block a pair takes [0, L) and divides at the end.
template <typename TC, int REP, int DH>
struct AppendTiles {
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
  // SPLIT: block 0's slots, o [REP * DH], m [REP] and l [REP] for each split.
  static constexpr int kSlot = REP * DH + 2 * REP;
  static_assert(PPL >= 1 && PIECES % PARTS == 0 && CR % G == 0, "tile shape");
  static_assert(kRingBytes >= G * REP * (DH + 1) * 4, "room for the groups' sums");
};

template <typename TQ, typename TC, int REP, int DH, bool SPLIT>
__global__ void __launch_bounds__(kWarps * 32)
    decode_append_tiles_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                               const TQ* __restrict__ v_new, TC* kc, TC* vc,
                               const int* __restrict__ lengths, TQ* __restrict__ out, int Hkv,
                               int S, int min_tiles) {
  namespace cg = cooperative_groups;
  using A = AppendTiles<TC, REP, DH>;
  constexpr int NT = kWarps * 32;
  constexpr int CR = A::CR, kRow = A::kRow, PARTS = A::PARTS, EPP = A::EPP;
  extern __shared__ __align__(16) unsigned char smem[];
  TC* ring = reinterpret_cast<TC*>(smem);
  float* qsm = reinterpret_cast<float*>(smem + A::kRingBytes);  // [REP][DH]
  float* psm = qsm + REP * DH;                                   // [REP][CR]
  float* wmx = psm + REP * CR;                                   // [kWarps][REP]
  float* slots = wmx + kWarps * REP;  // SPLIT: [splits][A::kSlot] in block 0

  const int split = SPLIT ? static_cast<int>(blockIdx.x) : 0;
  const int splits = SPLIT ? static_cast<int>(gridDim.x) : 1;
  const int bh = SPLIT ? blockIdx.y : blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = max(1, min(lengths[bh / Hkv], S));
  int begin = 0, end = L;
  // SPLIT: the ranges that hold rows; with one, its block normalises as one
  // block a pair does and the others leave: no merge, no cluster barrier
  // (every block of the cluster reads the same L, so all agree).
  int n_live = 1;
  if constexpr (SPLIT) {
    const int per = max(((L + 31) / 32 + splits - 1) / splits, min_tiles) * 32;  // rows a split
    begin = min(split * per, L);
    end = min(begin + per, L);
    n_live = (L + per - 1) / per;
    if (n_live == 1 && split > 0) return;
  }
  const bool merge = SPLIT && n_live > 1;
  if (merge) cluster_arrive_relaxed();  // this block runs
  const size_t qo = static_cast<size_t>(bh) * REP * DH;
  TC* kh = kc + static_cast<size_t>(bh) * S * DH;
  TC* vh = vc + static_cast<size_t>(bh) * S * DH;
  const TQ* kn = k_new + static_cast<size_t>(bh) * DH;
  const TQ* vn = v_new + static_cast<size_t>(bh) * DH;

  if (begin < end) {
    if (end == L && tid < DH) {  // this range holds row L-1: append it
      const size_t dst = static_cast<size_t>(L - 1) * DH + tid;
      kh[dst] = from_f32<TC>(to_f32(kn[tid]));
      vh[dst] = from_f32<TC>(to_f32(vn[tid]));
    }
    const int n_chunks = (end - begin + CR - 1) / CR;
    // Chunk c's K and V rows into ring half c & 1; rows past end are
    // zero-filled, row L-1 comes from k_new / v_new.
    auto issue = [&](int c) {
      TC* kt = ring + (c & 1) * 2 * CR * kRow;
      TC* vt = kt + CR * kRow;
      const int row0 = begin + c * CR;
      for (int i = tid; i < CR * A::PIECES; i += NT) {
        const int j = i / A::PIECES, e = (i % A::PIECES) * EPP, row = row0 + j;
        const bool ok = row < end;
        if (ok && row == L - 1) {
#pragma unroll
          for (int x = 0; x < EPP; ++x) {
            kt[j * kRow + e + x] = from_f32<TC>(to_f32(kn[e + x]));
            vt[j * kRow + e + x] = from_f32<TC>(to_f32(vn[e + x]));
          }
          continue;
        }
        const size_t src = static_cast<size_t>(ok ? row : 0) * DH + e;
        cp_async16(kt + j * kRow + e, kh + src, ok);
        cp_async16(vt + j * kRow + e, vh + src, ok);
      }
    };
    issue(0);
    cp_async_commit();
    if (n_chunks > 1) {
      issue(1);
      cp_async_commit();
    }
    for (int i = tid; i < REP * DH; i += NT) qsm[i] = to_f32(q[qo + i]);

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
    // SPLIT: this block's slot in block 0 (every block of the cluster runs now).
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
        out[qo + i] = from_f32<TQ>(num / den);
      }
    }
    if (merge && tid == 0) {
#pragma unroll
      for (int r = 0; r < REP; ++r) slot[REP * DH + r] = m[r];
    }
  } else if (merge) {
    cluster_wait();  // an empty range's block: both arrivals, nothing stored
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
      out[qo + i] = from_f32<TQ>(num / den);
    }
  }
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
  using A = AppendTiles<TC, REP, DH>;
  auto* fn = decode_append_tiles_kernel<TQ, TC, REP, DH, SPLIT>;
  constexpr int kSmem = A::kBytes + (SPLIT ? kMaxSplits * A::kSlot * 4 : 0);  // the most
  static const cudaError_t allowed = [fn] {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e == cudaSuccess && SPLIT)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = SPLIT ? dim3(a.splits, a.B * a.Hkv) : dim3(a.B * a.Hkv);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = A::kBytes + (SPLIT ? a.splits * A::kSlot * 4 : 0);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SPLIT ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, fn, static_cast<const TQ*>(a.q),
                            static_cast<const TQ*>(a.k_new), static_cast<const TQ*>(a.v_new),
                            static_cast<TC*>(a.kc), static_cast<TC*>(a.vc), a.lengths,
                            static_cast<TQ*>(a.out), a.Hkv, a.S, a.min_tiles);
}

template <typename TQ, typename TC, int REP, int DH>
cudaError_t launch_one(const Args& a) {
  return a.splits > 1 ? launch_append<TQ, TC, REP, DH, true>(a)
                      : launch_append<TQ, TC, REP, DH, false>(a);
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
  if (splits < 1 || splits > kMaxSplits || min_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_new, v_new, kc, vc, static_cast<const int*>(lengths), out, B, Hkv, S,
               static_cast<cudaStream_t>(stream), splits, min_tiles};
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
