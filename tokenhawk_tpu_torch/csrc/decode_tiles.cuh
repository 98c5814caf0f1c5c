// The shared-memory tile walk of decode attention, one instance a kernel:
// kernel 3 (decode_append.cu: append + attend over the dense cache),
// kernel 16's attention (attn_wo.cu: the same with q scaled in the block,
// into an f32 context), kernel 18 (decode_stats.cu: one shard's softmax
// partials over a strided dense cache), kernel 5 (paged_decode.cu: attend
// through a page table, appending first where the caller gives the new
// row), and over int8 codes with a scale a row, kernel 8 (kv_int8.cu:
// quantize and append, then attend over the dense int8 cache) and kernel 10
// (paged_int8.cu: attend through a page table over int8 pages, quantizing
// and appending first where the caller gives the new row).
//
// What bounds them on the H100: the bytes of the live K/V rows,
// 2*L*Dh*sizeof(cache) a head (int8: 2*L*(Dh + the scale's bytes)).
// Decode has few (sequence, kv head) pairs (32 at B=1 over LLaMA-7B's
// heads) for 132 SMs, and each block's loads must be in flight together to
// reach the card's rate.  So each block brings its
// range of K/V rows into shared memory by cp.async before any arithmetic,
// and where B*Hkv is below the SM count the pair's live rows are cut over a
// thread-block cluster (ranges cut on the card from lengths), the partials
// merged on chip.
//
// The walk: the block's rows [begin, end) of one head come into shared
// memory by 16-byte cp.async, a chunk of CR rows (64 of a 2-byte cache, 32
// of a 4-byte one, 128 of int8 codes: 16 KB of K at head dim 128) at a time
// into a two-chunk ring, all of a chunk's copies issued before any
// arithmetic and the next chunk's in flight while this one is computed;
// rows are padded by 16 bytes (int8: 32, so that a quarter warp's 16-byte
// score loads, two lanes a row, meet each bank once).  Int8 rows: the
// chunk's K and V scales come into shared memory in the same commit group
// (a row policy's copy_scales: the dense cache's bfloat16 scales in
// 16-byte pieces of 8, the pool's f32 scales one 4-byte copy a row, since
// a chunk may span pages; zeros past the range), and each code is widened
// to f32 times its row's scale where it is used (kv_int8.cuh widen4 /
// widen2: exact), so the walk's arithmetic is the 2-byte walk's over the
// dequantized values.  Per chunk, with all 8 warps busy:
//   - scores: a warp takes RW = CR / 8 rows, PARTS = 32 / RW lanes a row,
//     each lane the row's 16-byte pieces part, part + PARTS, ... against q
//     (f32, in shared memory), summed over the row's lanes by shuffles
//     (int8: a piece is 16 codes, each times the row's K scale);
//   - the chunk's max per query row from the warps' maxima (one barrier);
//     p = exp(s - m) written to shared memory by one lane a row (another);
//   - P·V: thread t owns head dims 2 (t % (DH/2)) and +1 over the rows
//     g, g + G, ... (g = t / (DH/2), G = 256 / (DH/2)), the loop unrolled
//     over the chunk, V read from shared memory (int8: a pair of codes,
//     each times the row's V scale, which stays out of p: l sums p); each
//     thread rescales its sums by exp(m_old - m) and adds up its rows' p
//     for l.
// At the end the G groups' sums add up through shared memory (the ring's
// space).  Rows: a policy gives the element offset of row r in the head's
// K and V (DenseRows: r times a row stride; PagedRows: through the
// sequence's page table, so a chunk may span pages; DenseRows8 and
// PagedRows8 the same over int8 codes, each with its scales).  APPEND
// (kernels 3, 8 and 16, and kernels 5 and 10 where their k_new is not
// null, a choice made at run time so that one instance serves both): the
// block whose range holds row L-1 writes k_new / v_new there in the cache
// and puts the same values into its own tile in place of a copy, so no
// block reads that row back from device memory: its copies zero-fill row
// L-1, and the first DH threads, holding element tid of k_new / v_new since
// the start, write the row into the tile of the chunk that holds it (and
// into the cache) between that chunk's barrier and one more, so the copy
// loop itself carries no branch for the row.  Kernels 8 and 10 quantize:
// warp 0 quantizes k_new, warp 1 v_new (kv_int8.cuh quantize_row) while
// the first chunks are in flight, writes the codes and the bfloat16-rounded
// scale at row L-1, and puts the same codes and rounded scale into the tile
// at the same point.
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
// (kernels 3 and 5; kernel 16's f32 context is not rounded); Partials
// writes the unnormalised o, m and l in f32 (kernel 18: a cluster's merge
// gives one partial, never divided).  A pair
// with no live row (L = 0: kernels 5's, 8's and 10's length 0, kernel 18's
// empty shard or range) writes the epilogue's empty value, zeros or the
// merge identity (0, -inf, 0), and reads nothing (kernel 8 appends
// nothing); the merge only ever takes ranges that hold rows, so it never
// meets exp(-inf - -inf).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "kv_int8.cuh"
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

// 16 bytes global -> shared of which the first `bytes` (0 to 16) are read,
// the rest zero-filled; src 16-byte aligned.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

template <typename TC, int REP, int DH>
struct Tiles {
  static constexpr int kElt = sizeof(TC);
  // A shared row, padded by 16 bytes (int8 codes: 32).
  static constexpr int kRow = DH + (kElt == 1 ? 32 : 16) / kElt;
  static constexpr int CR = kElt == 1 ? 128 : kElt == 2 ? 64 : 32;
  static constexpr int RW = CR / kWarps;
  static constexpr int PARTS = 32 / RW;
  static constexpr int EPP = 16 / kElt;  // elements a 16-byte piece
  static constexpr int PIECES = DH / EPP;
  static constexpr int PPL = PIECES / PARTS;  // pieces a lane scores
  static constexpr int G = kWarps * 32 / (DH / 2);
  static constexpr int RG = CR / G;  // rows a thread takes in P·V
  static constexpr int kRingBytes = 2 * 2 * CR * kRow * kElt;  // chunks x (K, V)
  // int8 codes: the chunks' scales [2][K, V][CR], at most 4 bytes each.
  static constexpr int kScaleBytes = kElt == 1 ? 2 * 2 * CR * 4 : 0;
  // q [REP][DH], p [REP][CR], the warps' maxima [kWarps][REP], all f32.
  static constexpr int kBytes =
      kRingBytes + kScaleBytes + (REP * DH + REP * CR + kWarps * REP) * 4;
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
// `k` / `v` (h * head_stride) already applied (written only by APPEND).
template <typename TC, int DH>
struct PagedRows {
  TC* k;
  TC* v;
  const int* pages;  // the sequence's row of the page table
  int ps;
  long long page_stride;
  __device__ __forceinline__ size_t at(int r) const {
    return static_cast<size_t>(pages[r / ps]) * page_stride + static_cast<size_t>(r % ps) * DH;
  }
};

// Row r of a dense int8 head (kernel 8): codes at r * DH, its bfloat16
// scale at r (the head's bases applied).
template <int DH>
struct DenseRows8 {
  using Scale = __nv_bfloat16;
  int8_t* k;
  int8_t* v;
  Scale* ks;
  Scale* vs;
  __device__ __forceinline__ size_t at(int r) const { return static_cast<size_t>(r) * DH; }
  __device__ __forceinline__ size_t scale_at(int r) const { return r; }
  // The scales of rows [row0, row0 + CR) below `end` into kss / vss, zeros
  // past it: 16-byte pieces of 8 (row0 is a multiple of 32, so a piece is
  // aligned wherever the head's scale row is), else one load a row.
  template <int CR>
  __device__ __forceinline__ void copy_scales(Scale* kss, Scale* vss, int row0, int end,
                                              int tid) const {
    if (((reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(vs)) & 15) == 0) {
      constexpr int kPieces = CR / 8;
      if (tid < 2 * kPieces) {
        const int p = tid % kPieces, r = row0 + 8 * p;
        const int n = min(max(end - r, 0), 8);
        const Scale* src = tid < kPieces ? ks : vs;
        cp_async16_n((tid < kPieces ? kss : vss) + 8 * p, src + (n > 0 ? r : 0), 2 * n);
      }
    } else if (tid < 2 * CR) {
      const int j = tid % CR, r = row0 + j;
      const Scale* src = tid < CR ? ks : vs;
      (tid < CR ? kss : vss)[j] = r < end ? src[r] : from_f32<Scale>(0.f);
    }
  }
};

// Row r of a paged int8 head (kernel 10): slot r % ps of page
// pages[r / ps], codes at a page stride and f32 scales at theirs, the
// head's bases applied (written only by APPEND).
template <int DH>
struct PagedRows8 {
  using Scale = float;
  int8_t* k;
  int8_t* v;
  Scale* ks;
  Scale* vs;
  const int* pages;  // the sequence's row of the page table
  int ps;
  long long page_stride, spage_stride;
  __device__ __forceinline__ size_t at(int r) const {
    return static_cast<size_t>(pages[r / ps]) * page_stride + static_cast<size_t>(r % ps) * DH;
  }
  __device__ __forceinline__ size_t scale_at(int r) const {
    return static_cast<size_t>(pages[r / ps]) * spage_stride + r % ps;
  }
  // One 4-byte copy a row (a chunk may span pages), zeros past `end`.
  template <int CR>
  __device__ __forceinline__ void copy_scales(Scale* kss, Scale* vss, int row0, int end,
                                              int tid) const {
    if (tid < 2 * CR) {
      const int j = tid % CR, r = row0 + j;
      const bool ok = r < end;
      cp_async4((tid < CR ? kss : vss) + j, (tid < CR ? ks : vs) + (ok ? scale_at(r) : 0), ok);
    }
  }
};

// A row policy's scale type: its Scale, or float for rows without scales.
template <typename Rows, typename = void>
struct ScaleOf {
  using type = float;
};
template <typename Rows>
struct ScaleOf<Rows, std::void_t<typename Rows::Scale>> {
  using type = typename Rows::Scale;
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

// N int8 codes packed in a word (byte 0 first) stored at p (N = 2 or 4,
// p aligned to N bytes).
template <int N>
__device__ __forceinline__ void put_codes(int8_t* p, uint32_t codes) {
  if constexpr (N == 4)
    *reinterpret_cast<uint32_t*>(p) = codes;
  else
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(codes);
}

// One block's walk over its range of one (sequence, kv head) pair's L live
// rows (see the header): q, k_new, v_new and the epilogue already at the
// pair (and, kGrid, the split); `split` of `splits` from the grid; APPEND
// appends only where kn is not null (kn and vn both or neither).  q is
// staged as q * q_scale rounded to q's type (kernel 16's 1/sqrt(Dh); every
// other kernel takes q pre-scaled and passes 1, which is exact); with
// `trigger` each block lets the kernel launched after this one as its
// programmatic dependent start once it has issued its first copies (kernel
// 16's Wo).
template <typename TQ, typename TC, int REP, int DH, Mode MODE, bool APPEND, typename Rows,
          typename Ep>
__device__ __forceinline__ void walk(unsigned char* smem, const TQ* __restrict__ q, Rows rows,
                                     const TQ* __restrict__ kn, const TQ* __restrict__ vn, int L,
                                     int split, int splits, int min_tiles, Ep ep,
                                     float q_scale = 1.f, bool trigger = false) {
  namespace cg = cooperative_groups;
  using A = Tiles<TC, REP, DH>;
  using Scale = typename ScaleOf<Rows>::type;
  constexpr int NT = kThreads;
  constexpr int CR = A::CR, kRow = A::kRow, PARTS = A::PARTS, EPP = A::EPP;
  constexpr bool SCALED = A::kElt == 1;  // int8 codes, a scale a row
  constexpr int NQ = DH / 32;            // kernel 8's append: values a lane quantizes
  TC* ring = reinterpret_cast<TC*>(smem);
  Scale* scl = reinterpret_cast<Scale*>(smem + A::kRingBytes);  // SCALED: [2][K, V][CR]
  float* qsm = reinterpret_cast<float*>(smem + A::kRingBytes + A::kScaleBytes);  // [REP][DH]
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
  const bool append = APPEND && kn != nullptr;

  if (begin < end) {
    const int n_chunks = (end - begin + CR - 1) / CR;
    // The block that appends (its range holds row L-1): its copies
    // zero-fill row L-1, whose values come from k_new / v_new (kernels 8
    // and 10: their quantization below) once that row's chunk has landed.
    const bool app = append && end == L;
    const int copy_end = app ? end - 1 : end;
    // 2-byte and f32 rows: element tid of the new rows, loaded now and
    // used when their chunk lands.
    TQ app_k = from_f32<TQ>(0.f), app_v = from_f32<TQ>(0.f);
    if constexpr (APPEND && !SCALED) {
      if (app && tid < DH) {
        app_k = kn[tid];
        app_v = vn[tid];
      }
    }
    // Chunk c's K and V rows into ring half c & 1; rows past end are
    // zero-filled.
    auto issue = [&](int c) {
      TC* kt = ring + (c & 1) * 2 * CR * kRow;
      TC* vt = kt + CR * kRow;
      const int row0 = begin + c * CR;
      for (int i = tid; i < CR * A::PIECES; i += NT) {
        const int j = i / A::PIECES, e = (i % A::PIECES) * EPP, row = row0 + j;
        const bool ok = row < copy_end;
        const size_t src = (ok ? rows.at(row) : 0) + e;
        cp_async16(kt + j * kRow + e, rows.k + src, ok);
        cp_async16(vt + j * kRow + e, rows.v + src, ok);
      }
      if constexpr (SCALED) {
        Scale* ss = scl + (c & 1) * 2 * CR;
        rows.template copy_scales<CR>(ss, ss + CR, row0, copy_end, tid);
      }
    };
    issue(0);
    cp_async_commit();
    if (n_chunks > 1) {
      issue(1);
      cp_async_commit();
    }
    if (trigger) grid_launch_dependents();
    for (int i = tid; i < REP * DH; i += NT)
      qsm[i] = to_f32(from_f32<TQ>(to_f32(q[i]) * q_scale));
    // Kernels 8 and 10's append: warp 0 quantizes k_new, warp 1 v_new,
    // writes the codes and the bfloat16-rounded scale at row L-1 and keeps
    // both for the tile (a lane's NQ codes packed in a word).
    uint32_t app_codes = 0;
    Scale app_scale = from_f32<Scale>(0.f);
    if constexpr (APPEND && SCALED) {
      if (app && warp < 2) {
        float x[NQ];
        load_n<NQ>((warp == 0 ? kn : vn) + lane * NQ, x);
        signed char codes[NQ];
        const float scale = quantize_row<NQ>(x, codes);
        app_scale = from_f32<Scale>(__bfloat162float(__float2bfloat16_rn(scale)));
#pragma unroll
        for (int i = 0; i < NQ; ++i)
          app_codes |= static_cast<uint32_t>(static_cast<uint8_t>(codes[i])) << (8 * i);
        put_codes<NQ>((warp == 0 ? rows.k : rows.v) + rows.at(L - 1) + lane * NQ, app_codes);
        if (lane == 0) (warp == 0 ? rows.ks : rows.vs)[rows.scale_at(L - 1)] = app_scale;
      }
    }

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
      const Scale* kss = scl + (c & 1) * 2 * CR;  // SCALED: the chunk's scales
      const Scale* vss = kss + CR;
      if constexpr (APPEND) {
        if (app && c == n_chunks - 1) {  // the chunk of row L-1: that row from the append
          const int ja = L - 1 - (begin + c * CR);
          TC* kw = ring + (c & 1) * 2 * CR * kRow;
          if constexpr (SCALED) {
            if (warp < 2) {
              put_codes<NQ>(kw + (warp * CR + ja) * kRow + lane * NQ, app_codes);
              if (lane == 0) scl[(c & 1) * 2 * CR + warp * CR + ja] = app_scale;
            }
          } else if (tid < DH) {  // the new row into the tile and the cache
            const TC k = from_f32<TC>(to_f32(app_k)), v = from_f32<TC>(to_f32(app_v));
            kw[ja * kRow + tid] = k;
            kw[(CR + ja) * kRow + tid] = v;
            const size_t dst = rows.at(L - 1) + tid;
            rows.k[dst] = k;
            rows.v[dst] = v;
          }
          __syncthreads();
        }
      }

      // Scores of row j against the REP query rows.
      float s[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) s[r] = 0.f;
      float k_scale = 0.f;
      if constexpr (SCALED) k_scale = to_f32(kss[j]);
#pragma unroll
      for (int pi = 0; pi < A::PPL; ++pi) {
        const int e = (pi * PARTS + part) * EPP;
        float kv[EPP > 8 ? EPP : 8];
        if constexpr (SCALED) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kt + j * kRow + e);
          widen4(raw.x, k_scale, kv);
          widen4(raw.y, k_scale, kv + 4);
          widen4(raw.z, k_scale, kv + 8);
          widen4(raw.w, k_scale, kv + 12);
        } else if constexpr (EPP == 8) {
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
        float2 v;
        if constexpr (SCALED)
          v = widen2(*reinterpret_cast<const uint16_t*>(vt + jj * kRow + 2 * dp), to_f32(vss[jj]));
        else
          v = load2(vt + jj * kRow + 2 * dp);
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

// The int8 walks' dispatch (kernels 8 and 10): q's type, rep and head
// dim; the cache is int8.
template <template <typename, typename, int, int> class Launch, typename Args>
cudaError_t dispatch_int8(const Args& a, int q_dtype, int rep, int Dh) {
  return q_dtype == kBF16 ? dispatch_dh<Launch, __nv_bfloat16, int8_t>(a, rep, Dh)
                          : dispatch_dh<Launch, float, int8_t>(a, rep, Dh);
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
