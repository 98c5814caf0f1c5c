// The tensor-core walk of causal prefill attention, shared by kernel 4
// (bf16 caches, flash_attention.cu) and kernel 9 (int8 caches, kv_int8.cu)
// when q is bfloat16, and by kernel 19 (the ring step, flash_attention.cu)
// over bf16 K/V blocks with its f32 q (STATS, at the end of this header).
//
// It computes what tokenhawk_tpu/ops/pallas/flash_attention.py _kernel and
// flash_attention_int8.py _kernel compute: q [B, Hkv, rep, T, Dh] (bf16,
// pre-scaled), caches [B, Hkv, S, Dh], the query at absolute position
// offsets[b] + t attending to cache slots 0 .. offsets[b] + t (and < S) with
// an online softmax in f32; out in bf16.  Dh is 64 or 128.
//
// What bounds it on the H100: at prefill lengths the work is the two
// products, 4 * Dh flops per visible (query, key) pair: 2.15 GFLOP at
// T=512 with LLaMA-7B's 32 heads, 0.032 ms at the f32 FMA peak and 0.002 at
// the bf16 tensor cores' 989 TFLOP/s, against 0.005 ms for its bytes.  So
// both products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), as the reference contracts both on the MXU
// (flash_attention.py:76, 92).
//
// A block owns up to 64 query rows of one (b, kv head): the flattened
// (t, r) pairs, t major, so the rep query heads of a KV head share every
// K/V tile, as the Pallas kernel's `for r in range(rep)` does over one tile.
// A block has 4 warps; one warp owns 16 rows, the M of the mma.  When a
// (b, kv head) has at most 16 rows (T * rep <= 16: a speculative verify at
// rep 1, a short prompt), its block instead runs the 4 warps over the same
// 16 rows, each taking 16 keys of every tile with its own online softmax,
// and merges the 4 partials through shared memory at the end (SPLIT): so
// few rows neither leave three warps idle nor walk a long cache on one
// warp's products.  Row blocks are issued last row first: under the causal
// mask the late rows see the most keys.
//
// - Q is staged once in shared memory and held in registers as A
//   fragments (ldmatrix).
// - K/V come in tiles of 64 keys by 16-byte cp.async into a two-stage ring
//   in shared memory, so the next tile's copy overlaps this tile's
//   products.  Shared rows are Dh + 8 values long: the 16 bytes of padding
//   put the 8 rows an ldmatrix phase reads in 8 distinct 4-bank groups.
// - S = Q.K^T accumulates in f32 fragments (K through ldmatrix as the "col"
//   B operand); the row max and sum reduce over the 4 lanes that share a
//   row (__shfl_xor_sync 1 and 2).  P is rescaled and repacked in registers
//   into bf16 A fragments (the accumulator's layout is the A operand's),
//   and O += P.V accumulates in f32 (V through ldmatrix.trans).  P is
//   rounded to bf16 for that product, as every tensor-core flash attention
//   does; the reference keeps both dots in f32.
// - Tiles past the block's last query position are never loaded, nor are
//   the keys of its last tile past that position or the cache's end (the
//   copy zero-fills them); a warp skips the tiles past its own last row,
//   and masks only in tiles that cross one of its rows' positions (the
//   block's last tile among them).  Rows past T * rep are neither loaded
//   (zeros) nor stored.
// - At the end O is divided by l (1 where l == 0, as the reference's
//   l_inv) and rounded once to bf16.
// - Exponentials are the special-function unit's ex2 of (s - m) log2 e.
//
// int8 caches (kernel 9): the codes arrive by cp.async as int8, half the
// bytes of bf16, and all threads widen them to bf16 in shared memory
// (exact: |code| <= 127 fits bf16's significand) while the next tile's
// codes are in flight.  The K scale multiplies S's columns in f32 after
// the mma, as the reference folds ks_row into score space
// (flash_attention_int8.py:87); the V scale multiplies P before its bf16
// rounding, as the reference computes p * vs_row (:100).
//
// STATS (kernel 19, flash_attention.py _kernel_stats): q is float32 and the
// partials are held to f32's accuracy (1e-5 of each value in the tests), so
// neither q nor P may be rounded to bf16.  Each is split in three bf16
// parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which
// carry x to about 2^-24 of itself (two parts, 2^-16, left partials 3x
// past that bound): S = q_hi.K^T + (q_mid.K^T + q_lo.K^T) in two
// accumulator chains, summed after the k-steps, and O += P_hi.V + P_mid.V
// + P_lo.V, with K and V exact as bf16 operands; l sums the unsplit p.
// q_hi is held in registers as kernel 4 holds q (its fragments built from
// f32 q in device memory); q_mid and q_lo are staged side by side in shared
// memory and read by ldmatrix at each k-step, so that two blocks still fit
// an SM.  The mask is kernel 4's with a per-sequence offset: key j is
// visible to query t iff k_start + stride*j <= q_start + stride*t, that is
// j <= t + off with off = floor((q_start - k_start) / stride), computed in
// the block from the two starts.  off may be negative (a query shard before
// the visiting block): a block whose last row sees no key loads nothing and
// writes every row's identity; a row that sees no key keeps m = -inf and
// p = 0 through the walk and is written as (0, _MASK, 0), as the CUDA-core
// walk writes it.  The outputs are the unnormalised o, m and l in f32, in
// kernel 19's layout ([B, Hkv, rep, T, Dh] and [B, Hkv, rep, T]).
#pragma once

#include "mma.cuh"

namespace thawk {
namespace prefill_tc {

constexpr int kKeys = 64;  // keys a tile
constexpr int kPad = 8;    // bf16 values of padding a shared row (16 bytes)
constexpr float kLog2e = 1.4426950408889634f;
// parallel/ring.py _MASK, rounded to f32 as the Python float is: the m of a
// row that sees no key (STATS).
constexpr float kMask = static_cast<float>(-0.7 * 3.4028234663852886e38);

// 2^x by the special-function unit (a row's exponents are at most 0 here;
// a result below 2^-126 is 0, as is 2^-inf).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four int8 codes (byte 0 first) as two bf16x2 words, exactly: each byte,
// its sign bit flipped (c + 128), goes under the exponent of 2^23, so the
// float is 2^23 + 128 + c; less 2^23 + 128 it is c, an integer of at most 8
// bits, whose float keeps its value in the high half: its bf16.  Two byte
// permutes and a float add a code, where a conversion instruction runs at
// a quarter of the rate.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// The K/V tiles of a bf16 cache: the two-stage ring is the tiles the
// products read.
template <int DH>
struct Bf16Cache {
  static constexpr bool kInt8 = false;
  static constexpr int kRow = DH + kPad;
  static constexpr int kRingBytes = 2 * 2 * kKeys * kRow * 2;  // stages x (K, V)
  static constexpr int kBytes = kRingBytes;
  const __nv_bfloat16* k;  // [B, Hkv, S, DH]
  const __nv_bfloat16* v;
  // The cache of one (b, kv head): its [S, DH] rows.
  __device__ Bf16Cache at(size_t bh, int S) const {
    const size_t rows = bh * S * DH;
    return {k + rows, v + rows};
  }
};

// The K/V tiles of an int8 cache: a two-stage ring of codes, one bf16 tile
// of K and of V that the codes widen into, and the tile's scales in f32.
template <int DH>
struct Int8Cache {
  static constexpr bool kInt8 = true;
  static constexpr int kRow = DH + kPad;
  static constexpr int kRingBytes = 2 * 2 * kKeys * DH;  // stages x (K, V), int8
  static constexpr int kTileBytes = 2 * kKeys * kRow * 2;
  static constexpr int kBytes = kRingBytes + kTileBytes + 2 * kKeys * 4;
  const int8_t* k;  // [B, Hkv, S, DH]
  const int8_t* v;
  const __nv_bfloat16* ks;  // [B, Hkv, S]
  const __nv_bfloat16* vs;
  // The cache of one (b, kv head): its [S, DH] codes and [S] scales.
  __device__ Int8Cache at(size_t bh, int S) const {
    const size_t rows = bh * S * DH;
    return {k + rows, v + rows, ks + bh * S, vs + bh * S};
  }
};

constexpr int kWarps = 4;

// What a walk reads and writes besides the cache: kernels 4 and 9 take
// bf16 q and write out = O / l in bf16; kernel 19 (STATS) takes f32 q and
// writes the partials.
template <bool STATS>
struct Io;
template <>
struct Io<false> {
  using Q = __nv_bfloat16;
  const __nv_bfloat16* q;  // [B, Hkv, rep, T, DH]
  const int* offsets;      // [B]
  __nv_bfloat16* out;      // [B, Hkv, rep, T, DH]
  __device__ int offset(int b) const { return offsets[b]; }
};
template <>
struct Io<true> {
  using Q = float;
  const float* q;         // [B, Hkv, rep, T, DH]
  const int* q_starts;    // [B]
  const int* k_starts;    // [B]
  int stride;             // >= 1
  float* o;               // [B, Hkv, rep, T, DH]
  float* m;               // [B, Hkv, rep, T]
  float* l;
  // floor((q_start - k_start) / stride): key j is visible to query t iff j <= t + off.
  __device__ int offset(int b) const {
    const int d = q_starts[b] - k_starts[b];
    return d >= 0 ? d / stride : -((stride - 1 - d) / stride);
  }
};

// A block's shared memory: its Q rows (STATS: q's mid rows, then its lo
// rows), then the K/V tiles.  SPLIT's merge reuses the tiles' space for each
// warp's o [16, DH + 8], m and l [16] in f32.
template <int DH, bool SPLIT, typename Cache, bool STATS = false>
struct Smem {
  static constexpr int kRows = SPLIT ? 16 : 16 * kWarps;  // query rows a block
  static constexpr int kQBytes = (STATS ? 2 : 1) * kRows * (DH + kPad) * 2;
  static constexpr int kBytes = kQBytes + Cache::kBytes;
  static_assert(!SPLIT || Cache::kBytes >= kWarps * 16 * (DH + 8 + 2) * 4, "merge space");
};

// Two f32 as three bf16x2 that sum to them: the bf16 of each (hi), of what
// hi leaves (mid), and of what both leave (lo).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 fh = __bfloat1622float2(h);
  const float ra = a - fh.x, rb = b - fh.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 fm = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(ra - fm.x, rb - fm.y);
}

// One block: query rows [i0, i0 + 64) of (b, kv head) blockIdx.y, 16 a warp;
// or, SPLIT, rows [0, 16) for all 4 warps, warp w taking keys [16w, 16w + 16)
// of every tile.
template <int DH, bool SPLIT, typename Cache, bool STATS>
__global__ void __launch_bounds__(kWarps * 32)
    prefill_tc_kernel(const Io<STATS> io, Cache cache, int Hkv, int rep, int T, int S) {
  static_assert(!(STATS && Cache::kInt8), "kernel 19 reads bf16 K/V blocks");
  constexpr int NT = kWarps * 32;
  constexpr int BM = Smem<DH, SPLIT, Cache, STATS>::kRows;
  constexpr int WK = SPLIT ? kKeys / kWarps : kKeys;  // keys of a tile a warp takes
  constexpr int kRow = DH + kPad;
  constexpr int kChunks = DH / 8;  // 16-byte chunks of a bf16 row
  constexpr int KS = DH / 16;      // k-steps of Q.K^T
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs_lo = qs + BM * kRow;  // STATS: q's lo parts (qs: its mid parts)
  unsigned char* cs = smem + Smem<DH, SPLIT, Cache, STATS>::kQBytes;

  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int N = T * rep;  // rows of this (b, kv head)
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = io.offset(b);
  const int last_row = min(i0 + BM, N) - 1;
  const int block_last = min(off + last_row / rep, S - 1);  // the block's last visible key
  const size_t qhead = static_cast<size_t>(bh) * rep;  // (b, h, r=0) in [B*Hkv*rep]
  const Cache head = cache.at(bh, S);

  // Row i of this (b, kv head) is query (t, r) = (i / rep, i % rep).
  auto row_ptr = [&](auto* base, int i) {
    return base + ((qhead + i % rep) * T + i / rep) * DH;
  };
  auto row_index = [&](int i) { return (qhead + i % rep) * T + i / rep; };

  if constexpr (STATS) {
    if (block_last < 0) {  // no row of the block sees a key: the identity, nothing loaded
      for (int i = tid; i < BM * DH; i += NT) {
        const int r = i / DH;
        if (i0 + r < N) row_ptr(io.o, i0 + r)[i % DH] = 0.f;
      }
      for (int r = tid; r < BM; r += NT) {
        if (i0 + r < N) {
          io.m[row_index(i0 + r)] = kMask;
          io.l[row_index(i0 + r)] = 0.f;
        }
      }
      return;
    }
  }
  const int n_tiles = block_last / kKeys + 1;

  // -- the copies: Q once (with tile 0), each K/V tile into a ring stage;
  // rows past N and keys past block_last are zero-filled --
  if constexpr (STATS) {
    // f32 q, split here into its mid and lo bf16 rows (visible after tile
    // 0's barrier; hi goes to registers below).
    for (int i = tid; i < BM * kChunks; i += NT) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      float x[8];
      if (i0 + r < N) {
        const float4* src = reinterpret_cast<const float4*>(row_ptr(io.q, i0 + r) + c);
        const float4 a = src[0], b4 = src[1];
        x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
        x[4] = b4.x; x[5] = b4.y; x[6] = b4.z; x[7] = b4.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
      uint4 hi, mid, lo;
      split_bf16(x[0], x[1], hi.x, mid.x, lo.x);
      split_bf16(x[2], x[3], hi.y, mid.y, lo.y);
      split_bf16(x[4], x[5], hi.z, mid.z, lo.z);
      split_bf16(x[6], x[7], hi.w, mid.w, lo.w);
      *reinterpret_cast<uint4*>(qs + r * kRow + c) = mid;
      *reinterpret_cast<uint4*>(qs_lo + r * kRow + c) = lo;
    }
  } else {
    for (int i = tid; i < BM * kChunks; i += NT) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = i0 + r < N;
      cp_async16(qs + r * kRow + c, ok ? row_ptr(io.q, i0 + r) + c : io.q, ok);
    }
  }
  // Per thread, the scales of the int8 tile in flight (keys tid, tid + NT, ...).
  constexpr int kScalesPer = (kKeys + NT - 1) / NT;
  float ksr[kScalesPer], vsr[kScalesPer];
  auto issue = [&](int tile) {
    const int stage = tile & 1;
    const int key0 = tile * kKeys;
    if constexpr (Cache::kInt8) {
      constexpr int kC = DH / 16;  // 16-byte chunks of an int8 row
      int8_t* kr = reinterpret_cast<int8_t*>(cs) + stage * 2 * kKeys * DH;
      int8_t* vr = kr + kKeys * DH;
      for (int i = tid; i < kKeys * kC; i += NT) {
        const int j = i / kC, c = (i % kC) * 16, key = key0 + j;
        const bool ok = key <= block_last;
        const size_t src = static_cast<size_t>(ok ? key : 0) * DH + c;
        cp_async16(kr + j * DH + c, head.k + src, ok);
        cp_async16(vr + j * DH + c, head.v + src, ok);
      }
#pragma unroll
      for (int e = 0; e < kScalesPer; ++e) {
        const int key = key0 + tid + e * NT;
        const bool ok = tid + e * NT < kKeys && key <= block_last;
        ksr[e] = ok ? to_f32(head.ks[key]) : 0.f;
        vsr[e] = ok ? to_f32(head.vs[key]) : 0.f;
      }
    } else {
      __nv_bfloat16* kr = reinterpret_cast<__nv_bfloat16*>(cs) + stage * 2 * kKeys * kRow;
      __nv_bfloat16* vr = kr + kKeys * kRow;
      for (int i = tid; i < kKeys * kChunks; i += NT) {
        const int j = i / kChunks, c = (i % kChunks) * 8, key = key0 + j;
        const bool ok = key <= block_last;
        const size_t src = static_cast<size_t>(ok ? key : 0) * DH + c;
        cp_async16(kr + j * kRow + c, head.k + src, ok);
        cp_async16(vr + j * kRow + c, head.v + src, ok);
      }
    }
  };

  // -- this warp's rows and keys --
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  const int wq = SPLIT ? 0 : warp * 16;          // the warp's first row in the block
  const int wrow = i0 + wq;
  const int wkey = SPLIT ? warp * WK : 0;  // the warp's first key in a tile
  const bool warp_live = wrow < N;
  const int pos_lo = off + (wrow + g) / rep, pos_hi = off + (wrow + g + 8) / rep;
  const int warp_first = off + wrow / rep;
  const int warp_last = off + min(wrow + 15, N - 1) / rep;

  uint32_t qf[KS][4];
  if constexpr (STATS) {
    // q_hi's A fragments from f32 q: rows g and g + 8 of the warp's 16,
    // columns c2, c2 + 1 and c2 + 8, c2 + 9 of each k-step (ldmatrix's
    // layout); rows past N are zeros.
    const float* r0 = wrow + g < N ? row_ptr(io.q, wrow + g) : nullptr;
    const float* r1 = wrow + g + 8 < N ? row_ptr(io.q, wrow + g + 8) : nullptr;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + c2;
      const float2 z = make_float2(0.f, 0.f);
      const float2 a0 = r0 ? *reinterpret_cast<const float2*>(r0 + c) : z;
      const float2 a1 = r1 ? *reinterpret_cast<const float2*>(r1 + c) : z;
      const float2 a2 = r0 ? *reinterpret_cast<const float2*>(r0 + c + 8) : z;
      const float2 a3 = r1 ? *reinterpret_cast<const float2*>(r1 + c + 8) : z;
      qf[ks][0] = pack_bf16(a0.x, a0.y);
      qf[ks][1] = pack_bf16(a1.x, a1.y);
      qf[ks][2] = pack_bf16(a2.x, a2.y);
      qf[ks][3] = pack_bf16(a3.x, a3.y);
    }
  }
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  float ks_cur[kScalesPer], vs_cur[kScalesPer];  // int8: the scales of the tile being widened
  issue(0);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kKeys;
    if constexpr (Cache::kInt8) {
#pragma unroll
      for (int e = 0; e < kScalesPer; ++e) {
        ks_cur[e] = ksr[e];
        vs_cur[e] = vsr[e];
      }
    }
    // The next tile's copy goes into the other stage, whose last tile was
    // consumed before the previous iteration's last barrier.
    if (tile + 1 < n_tiles) {
      issue(tile + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q, on the first) landed for every thread
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (Cache::kInt8) {
      // Widen the codes to bf16 (the previous tile's products are done:
      // the barrier above).  Rows past block_last are zeros.
      const int8_t* kr = reinterpret_cast<const int8_t*>(cs) + (tile & 1) * 2 * kKeys * DH;
      __nv_bfloat16* kw = reinterpret_cast<__nv_bfloat16*>(cs + Cache::kRingBytes);
      float* sc = reinterpret_cast<float*>(cs + Cache::kRingBytes + Cache::kTileBytes);
      constexpr int kC = DH / 16;
      const int n_live = block_last - key0 + 1;
      for (int i = tid; i < 2 * kKeys * kC; i += NT) {  // K rows, then V rows
        const int j = i / kC, c = (i % kC) * 16;
        uint4* dst = reinterpret_cast<uint4*>(kw + j * kRow + c);
        if (j % kKeys >= n_live) {
          dst[0] = dst[1] = make_uint4(0, 0, 0, 0);
          continue;
        }
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + j * DH + c);
        uint4 a, b;
        widen4(raw.x, a.x, a.y);
        widen4(raw.y, a.z, a.w);
        widen4(raw.z, b.x, b.y);
        widen4(raw.w, b.z, b.w);
        dst[0] = a;
        dst[1] = b;
      }
#pragma unroll
      for (int e = 0; e < kScalesPer; ++e) {
        if (tid + e * NT < kKeys) {
          sc[tid + e * NT] = ks_cur[e];
          sc[kKeys + tid + e * NT] = vs_cur[e];
        }
      }
      __syncthreads();  // the widened tile and its scales are visible
      kt = kw;
      vt = kw + kKeys * kRow;
      ksc = sc;
      vsc = sc + kKeys;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(cs) + (tile & 1) * 2 * kKeys * kRow;
      vt = kt + kKeys * kRow;
    }
    if (!STATS && tile == 0 && warp_live) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], qs + (wq + (lane & 15)) * kRow + ks * 16 + (lane >> 4) * 8);
    }

    if (warp_live && key0 + wkey <= warp_last) {
      // S = Q.K^T over the warp's WK keys of the tile: n-tiles of 8 keys.
      // SPLIT's two n-tiles accumulate even and odd k-steps apart, so that
      // two chains of mma run where one would wait on the other.  STATS:
      // q's hi parts into s, its mid and lo parts into s2.
      float s[WK / 8][4], s2[WK / 8][4];
#pragma unroll
      for (int n = 0; n < WK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qm[4], ql[4];
        if constexpr (STATS) {
          const int at = (wq + (lane & 15)) * kRow + ks * 16 + (lane >> 4) * 8;
          ldmatrix_x4(qm, qs + at);
          ldmatrix_x4(ql, qs_lo + at);
        }
#pragma unroll
        for (int np = 0; np < WK / 16; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kt + (wkey + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kRow +
                              ks * 16 + ((lane >> 3) & 1) * 8);
          if constexpr (STATS) {
            mma(s[2 * np], qf[ks], kb[0], kb[1]);
            mma(s[2 * np + 1], qf[ks], kb[2], kb[3]);
            mma(s2[2 * np], qm, kb[0], kb[1]);
            mma(s2[2 * np + 1], qm, kb[2], kb[3]);
            mma(s2[2 * np], ql, kb[0], kb[1]);
            mma(s2[2 * np + 1], ql, kb[2], kb[3]);
          } else {
            float(&acc)[WK / 8][4] = SPLIT && (ks & 1) ? s2 : s;
            mma(acc[2 * np], qf[ks], kb[0], kb[1]);
            mma(acc[2 * np + 1], qf[ks], kb[2], kb[3]);
          }
        }
      }
      if constexpr (SPLIT || STATS) {
#pragma unroll
        for (int n = 0; n < WK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += s2[n][e];
      }
      if constexpr (Cache::kInt8) {
#pragma unroll
        for (int n = 0; n < WK / 8; ++n) {
          const float k0 = ksc[wkey + n * 8 + c2], k1 = ksc[wkey + n * 8 + c2 + 1];
          s[n][0] *= k0;
          s[n][1] *= k1;
          s[n][2] *= k0;
          s[n][3] *= k1;
        }
      }
      if (key0 + wkey + WK - 1 > warp_first) {  // (so does every tile past block_last)
#pragma unroll
        for (int n = 0; n < WK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + wkey + n * 8 + c2 + (e & 1);
            if (key > (e < 2 ? pos_lo : pos_hi) || key >= S) s[n][e] = -INFINITY;
          }
        }
      }
      // Online softmax.  A row that has seen no key yet keeps m = -inf and
      // gets p = 0 (the exponent's base is 0 then, not -inf).
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int n = 0; n < WK / 8; ++n) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int d = 1; d <= 2; d <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, d));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, d));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float b_lo = mn_lo == -INFINITY ? 0.f : mn_lo * kLog2e;
      const float b_hi = mn_hi == -INFINITY ? 0.f : mn_hi * kLog2e;
      const float a_lo = exp2_approx(fmaf(m_lo, kLog2e, -b_lo));  // 0 while m was -inf
      const float a_hi = exp2_approx(fmaf(m_hi, kLog2e, -b_hi));
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int n = 0; n < WK / 8; ++n) {
        s[n][0] = exp2_approx(fmaf(s[n][0], kLog2e, -b_lo));
        s[n][1] = exp2_approx(fmaf(s[n][1], kLog2e, -b_lo));
        s[n][2] = exp2_approx(fmaf(s[n][2], kLog2e, -b_hi));
        s[n][3] = exp2_approx(fmaf(s[n][3], kLog2e, -b_hi));
        sum_lo += s[n][0] + s[n][1];
        sum_hi += s[n][2] + s[n][3];
      }
      l_lo = l_lo * a_lo + sum_lo;  // this lane's columns; the 4 lanes sum at the end
      l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[n][0] *= a_lo;
        o[n][1] *= a_lo;
        o[n][2] *= a_hi;
        o[n][3] *= a_hi;
      }
      if constexpr (Cache::kInt8) {
#pragma unroll
        for (int n = 0; n < WK / 8; ++n) {
          const float v0 = vsc[wkey + n * 8 + c2], v1 = vsc[wkey + n * 8 + c2 + 1];
          s[n][0] *= v0;
          s[n][1] *= v1;
          s[n][2] *= v0;
          s[n][3] *= v1;
        }
      }
      // O += P.V, 16 keys a k-step; P's accumulator layout is the A operand's.
      // STATS: O += P_hi.V + P_mid.V + P_lo.V.
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) {
        uint32_t pa[4], pmid[4], plo[4];
        if constexpr (STATS) {
          split_bf16(s[2 * kk][0], s[2 * kk][1], pa[0], pmid[0], plo[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], pa[1], pmid[1], plo[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pmid[2], plo[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pmid[3], plo[3]);
        } else {
          pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vt + (wkey + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow +
                                    dp * 16 + (lane >> 4) * 8);
          mma(o[2 * dp], pa, vb[0], vb[1]);
          mma(o[2 * dp + 1], pa, vb[2], vb[3]);
          if constexpr (STATS) {
            mma(o[2 * dp], pmid, vb[0], vb[1]);
            mma(o[2 * dp + 1], pmid, vb[2], vb[3]);
            mma(o[2 * dp], plo, vb[0], vb[1]);
            mma(o[2 * dp + 1], plo, vb[2], vb[3]);
          }
        }
      }
    }
    if constexpr (!Cache::kInt8) __syncthreads();  // this stage is free for tile + 2
  }

  if (!warp_live) return;  // (never in SPLIT: its warps share live rows)
#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, d);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, d);
  }
  if constexpr (SPLIT) {
    // Merge the 4 warps' partials of the same rows in the tiles' space: a
    // thread a row turns each warp's m into its weight exp(m_w - max) / the
    // weighted sum of l (0 for a warp that saw no key of the row), then
    // every thread sums two columns of o.  STATS keeps the weights
    // exp(m_w - max) undivided and writes max and the weighted sum of l; a
    // row no warp saw (max -inf) gets weights 0 and (0, _MASK, 0).
    constexpr int kORow = DH + 8;  // f32 a partial row, padded against bank conflicts
    if constexpr (Cache::kInt8) __syncthreads();  // every warp is done with the tiles
    float* po = reinterpret_cast<float*>(cs);  // [warp][16][kORow]
    float* pm = po + kWarps * 16 * kORow;      // [warp][16]: m, then the weight
    float* pl = pm + kWarps * 16;              // [warp][16]
    float* wo = po + warp * 16 * kORow;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<float2*>(wo + g * kORow + n * 8 + c2) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(wo + (g + 8) * kORow + n * 8 + c2) =
          make_float2(o[n][2], o[n][3]);
    }
    if ((lane & 3) == 0) {
      pm[warp * 16 + g] = m_lo;
      pm[warp * 16 + g + 8] = m_hi;
      pl[warp * 16 + g] = l_lo;
      pl[warp * 16 + g + 8] = l_hi;
    }
    __syncthreads();
    if (tid < 16) {
      float mx = -INFINITY, f[kWarps], den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, pm[w * 16 + tid]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        f[w] = STATS && mx == -INFINITY ? 0.f : exp2_approx((pm[w * 16 + tid] - mx) * kLog2e);
        den += pl[w * 16 + tid] * f[w];
      }
      if constexpr (STATS) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) pm[w * 16 + tid] = f[w];
        if (tid < N) {
          io.m[row_index(tid)] = mx == -INFINITY ? kMask : mx;
          io.l[row_index(tid)] = den;
        }
      } else {
        const float inv = den > 0.f ? 1.f / den : 1.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) pm[w * 16 + tid] = f[w] * inv;
      }
    }
    __syncthreads();
    for (int i = tid; i < 16 * (DH / 2); i += NT) {
      const int r = i / (DH / 2), d = (i % (DH / 2)) * 2;
      if (r >= N) break;  // rows are in order: the rest are past N too
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = pm[w * 16 + r];
        const float2 v = *reinterpret_cast<const float2*>(po + (w * 16 + r) * kORow + d);
        x += v.x * f;
        y += v.y * f;
      }
      if constexpr (STATS)
        *reinterpret_cast<float2*>(row_ptr(io.o, r) + d) = make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(row_ptr(io.out, r) + d) = pack_bf16(x, y);
    }
    return;
  }
  const int r_lo = wrow + g, r_hi = r_lo + 8;
  if constexpr (STATS) {
    // The partials as they stand; a row that saw no key: (0, _MASK, 0).
    if (r_lo < N) {
      float* dst = row_ptr(io.o, r_lo) + c2;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][0], o[n][1]);
      if ((lane & 3) == 0) {
        io.m[row_index(r_lo)] = m_lo == -INFINITY ? kMask : m_lo;
        io.l[row_index(r_lo)] = l_lo;
      }
    }
    if (r_hi < N) {
      float* dst = row_ptr(io.o, r_hi) + c2;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2], o[n][3]);
      if ((lane & 3) == 0) {
        io.m[row_index(r_hi)] = m_hi == -INFINITY ? kMask : m_hi;
        io.l[row_index(r_hi)] = l_hi;
      }
    }
  } else {
    const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 1.f;
    const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 1.f;
    if (r_lo < N) {
      __nv_bfloat16* dst = row_ptr(io.out, r_lo) + c2;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack_bf16(o[n][0] * inv_lo, o[n][1] * inv_lo);
    }
    if (r_hi < N) {
      __nv_bfloat16* dst = row_ptr(io.out, r_hi) + c2;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack_bf16(o[n][2] * inv_hi, o[n][3] * inv_hi);
    }
  }
}

template <int DH, bool SPLIT, typename Cache, bool STATS>
cudaError_t launch_walk(const Io<STATS>& io, const Cache& cache, int B, int Hkv, int rep, int T,
                        int S, cudaStream_t stream) {
  constexpr int BM = Smem<DH, SPLIT, Cache, STATS>::kRows;
  constexpr int kSmem = Smem<DH, SPLIT, Cache, STATS>::kBytes;
  auto* fn = prefill_tc_kernel<DH, SPLIT, Cache, STATS>;
  // Above 48 KB a kernel must be allowed its dynamic shared memory: once an
  // instantiation (a process of the port launches on one device), not at
  // every launch, where it would add a CUDA API call to each.
  static const cudaError_t allowed =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((T * rep + BM - 1) / BM, B * Hkv);
  fn<<<grid, kWarps * 32, kSmem, stream>>>(io, cache, Hkv, rep, T, S);
  return cudaSuccess;
}

// The walk at this head dim over `cache` (whole [B, Hkv, S, DH] arrays);
// SPLIT when a (b, kv head) has at most 16 rows.  Kernel 19 calls it with
// Io<true> over a Bf16Cache.
template <int DH, typename Cache, bool STATS>
cudaError_t launch_io(const Io<STATS>& io, const Cache& cache, int B, int Hkv, int rep, int T,
                      int S, cudaStream_t stream) {
  if (B * Hkv == 0 || T * rep == 0) return cudaSuccess;
  if (T * rep <= 16) return launch_walk<DH, true>(io, cache, B, Hkv, rep, T, S, stream);
  return launch_walk<DH, false>(io, cache, B, Hkv, rep, T, S, stream);
}

// Kernels 4 and 9: bf16 q, out = O / l in bf16.
template <int DH, typename Cache>
cudaError_t launch(const __nv_bfloat16* q, const Cache& cache, const int* offsets,
                   __nv_bfloat16* out, int B, int Hkv, int rep, int T, int S,
                   cudaStream_t stream) {
  return launch_io<DH>(Io<false>{q, offsets, out}, cache, B, Hkv, rep, T, S, stream);
}

}  // namespace prefill_tc
}  // namespace thawk
