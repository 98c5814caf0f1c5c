// The tensor-core path of kernels 1 (Q4_0), 13 (group codes) and 17 (Q4_K
// super-blocks): the quantized matmul at more than 8 bfloat16 rows
// (prefill, chunked and prefix-cache admissions, the speculative verify,
// eval windows).
//
// It computes what tokenhawk_tpu/ops/pallas/qmatmul.py q4_matmul
// (_q4_kernel), q8_matmul (_q8_kernel), qk_matmul (_qk_kernel) and
// qk_sb_matmul (_qk_sb_kernel) compute at more than 8 rows of bf16 x, where
// `_qdot` takes the MXU's bf16 dot:
//   xn[b,k] = bf16((x[b,k] * inv_rms[b]) * gain[k])        (bf16(x) without a norm)
//   y[b,n]  = bf16( sum_k xn[b,k] * bf16(code[n,k] * s[n,g(k)])     bf16 products, f32 sums
//                 + sum_g m[n,g] * sum_{k in g} xn[b,k] )            mins forms, in f32
// (Q4_0's and the super-blocks' code is the nibble less 8).  The roundings
// are the reference's: `_norm_rows` rounds xn once, `_apply_scales` forms
// code * s in f32 and `_qdot` rounds it to bf16, and KQ_BIASDOT adds the
// group sums of xn times m as an f32 dot.  The super-block form expands
// each group's s and m from its super-block's d, dmin and the group's
// 6-bit sc, mn as `_sb_expand` does (s = d*sc, m = 8s - dmin*mn, each
// product and the difference rounded in f32, as gemv.cuh's SbReader).
//
// What bounds it on the H100: the operations.  LLaMA-7B's wqkv at 512 rows
// is 51.5 GFLOP against 31 MB of codes: 0.052 ms on the bf16 tensor cores
// (989 TFLOP/s), 0.77 ms at the f32 CUDA-core peak where the GEMV
// (gemv.cuh) runs it.  So the products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate).  On the H100 the walk
// reaches a fifth of that bound (0.28 ms at LLaMA-7B's wqkv); without its
// mma's it keeps 80% of its time and without its widening 97%, so the
// copies, ldmatrix and barriers hold it, not the products (PERF.md, PR 11):
// wgmma, TMA and a producer warp are the next step.
//
// - A pre-pass writes xn in bf16 (the norm needs the whole row before any
//   rounding) and, for the mins forms, its f32 sums per group; without a
//   norm x is read as it is.
// - A block of 8 warps owns BM rows by 128 output columns: 64 rows (2 x 4
//   warps of 32 x 32) at most 64 rows, 128 (2 x 4 of 64 x 32) below 256,
//   else 256 (4 x 2 of 64 x 64, each code tile widened once for twice the
//   rows).  Blocks run with the row tiles fastest (blockIdx.x), as the
//   GEMV's do, so a column tile's codes come from device memory once a call
//   and from L2 for the other row tiles.  Where the tiles fill the SMs'
//   waves poorly (a verify's 40 rows over 32 column tiles), K splits
//   (blockIdx.z; splits_for): each split writes its f32 sums and
//   sum_splits_kernel adds them in order and rounds once.
// - K goes in steps of 64 (two groups of 32, four of 16).  A step's x rows,
//   its codes, scales (and mins and xn's group sums) arrive by cp.async in
//   a ring of 3-6 stages in dynamic shared memory; a ragged last step (K a
//   multiple of 32, not of 64) and the columns past N and rows past B are
//   zero-filled.
// - Dequantization goes through a bf16 shared tile of 128 columns by 64
//   inputs, double-buffered.  While the warps multiply step j, they widen
//   step j + 1's codes (a thread a column and 32 inputs: an exact byte to
//   float, the f32 product with the scale, one rounding to bf16), a quarter
//   after each k16 of products, so the conversions issue between the
//   mma's; one barrier a step orders both.  Shared rows of x and W are
//   64 + 8 values long, which puts the 8 rows an ldmatrix phase reads in
//   distinct banks.
// - With mins, each thread adds m * (group sum) for its fragment's rows and
//   columns in f32 FMAs, after the step's products.
// - The super-block form copies, a step and a column, its super-block's d
//   and dmin and the 4-byte words of sc and of mn that hold the step's two
//   groups (cp.async has no 2-byte copy; the words are 4-byte aligned as K
//   is a multiple of 256): 4 copies a column, as many as the G 32 mins
//   form's 2 scales and 2 mins.  The widening thread of a (column, group)
//   expands its s for the codes and writes its m into the stage, where the
//   mins terms of the next step read it, as they read a mins form's m.
// - One rounding to bf16 at the end; rows past B and columns past N are not
//   stored.
#pragma once

#include "gemv.cuh"
#include "mma.cuh"

namespace thawk {
namespace qgemm_tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;       // output columns a block
constexpr int kBK = 64;        // inputs a K step
constexpr int kRow = kBK + 8;  // bf16 values a shared x or W row (144 bytes)
// The deepest cp.async ring: 4 stages at 64-row tiles and for the mins
// forms, 6 otherwise (the fastest of 4, 5-8 at LLaMA-7B's and Llama-3-8B's
// projections on an H100: deeper rings lost up to 12% where they won
// nothing); 3 for the super-block form above 64-row tiles (Llama-3-8B's
// wqkv at 512 rows: 0.2216-0.2230 ms against 0.2444-0.2447 in 4; at 40
// rows, 64-row tiles, 4 stages kept 0.0524 against 0.0534).
constexpr int kMaxStagesSmall = 4;
constexpr int kMaxStagesLarge = 6;
constexpr int kMaxStagesSb = 3;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have on sm_90

// A weight form's tile: NIB for Q4_0's packed nibbles (else int8 codes),
// G inputs a group, MINS for the affine forms, SB for Q4_K's super-blocks
// (nibbles, G 32, the mins expanded in the walk).  kBytes code bytes of a
// column a K step, kept kStride bytes apart in shared memory: 16 bytes of
// padding put 8 neighbouring columns' 16-byte reads in distinct banks.
template <bool NIB, int G, bool MINS, bool SB = false>
struct Tile {
  static_assert(!SB || (NIB && G == 32 && MINS), "super-blocks: nibbles, G 32, mins");
  static constexpr bool kNibbles = NIB;
  static constexpr bool kMins = MINS;
  static constexpr bool kSb = SB;
  static constexpr int kG = G;
  static constexpr int kGroups = kBK / G;  // groups a K step
  static constexpr int kBytes = NIB ? kBK / 2 : kBK;
  static constexpr int kStride = kBytes + 16;
};

// A block's shared memory: kStages stages of (x rows, codes, scales, mins,
// group sums of xn, the super-blocks' raw sides), then the two bf16 W
// tiles.  The super-block form keeps no scales (its s lives in registers)
// and writes its expanded mins where a mins form's land.  The ring is as
// deep as fits, up to its cap: a step's copies have kStages - 2 steps of
// work to arrive in.
template <int BM, typename F>
struct Smem {
  static constexpr int kX = BM * kRow * 2;
  static constexpr int kCodes = kBN * F::kStride;
  static constexpr int kSides = kBN * F::kGroups * 4;  // an f32 a column a group
  static constexpr int kScales = F::kSb ? 0 : kSides;
  static constexpr int kMins = F::kMins ? kSides : 0;
  static constexpr int kSums = F::kMins ? BM * F::kGroups * 4 : 0;
  static constexpr int kRaw = F::kSb ? kBN * 16 : 0;  // d, dmin, sc word, mn word
  static constexpr int kOffScales = kX + kCodes;
  static constexpr int kOffMins = kOffScales + kScales;
  static constexpr int kOffSums = kOffMins + kMins;
  static constexpr int kOffRaw = kOffSums + kSums;
  static constexpr int kStage = kOffRaw + kRaw;
  static constexpr int kW = kBN * kRow * 2;
  static constexpr int kCap = BM == 64    ? kMaxStagesSmall
                             : F::kSb    ? kMaxStagesSb
                             : F::kMins  ? kMaxStagesSmall
                                         : kMaxStagesLarge;
  static constexpr int kStages =
      (kSmemMax - 2 * kW) / kStage < kCap ? (kSmemMax - 2 * kW) / kStage : kCap;
  static constexpr int kBytes = kStages * kStage + 2 * kW;
  static_assert(kStages >= 3, "step j + 2 is in flight while step j is multiplied");
  static_assert(kStage % 16 == 0, "each stage's x rows and codes 16-byte aligned");
};

struct Args {
  const __nv_bfloat16* x;  // [B, K]: xn
  const float* xsum;       // [B, K/G]: xn's group sums (mins forms)
  const uint8_t* qs;       // [N, K/2] nibbles or [N, K] int8 codes
  const float* scales;     // [N, K/G]; super-blocks: d [N, K/256]
  const float* mins;       // [N, K/G] or null; super-blocks: dmin [N, K/256]
  const uint8_t* scmn;     // super-blocks: [N, K/16], each column's sc then mn
  __nv_bfloat16* y;        // [B, N]
  float* part;             // [splits, B, N]: the splits' f32 sums (splits > 1)
  int B, K, N;
  int split_steps;         // K steps a split walks
};

// Four codes, one a byte of u, each the float 2^23 + byte less `bias`
// (exact), times s in f32, as two bf16x2 words (byte 0 in the low half).
__device__ __forceinline__ void scale4(uint32_t u, float bias, float s, uint32_t& lo,
                                       uint32_t& hi) {
  const float f0 = __fmul_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - bias, s);
  const float f1 = __fmul_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - bias, s);
  const float f2 = __fmul_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - bias, s);
  const float f3 = __fmul_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - bias, s);
  lo = pack_bf16(f0, f1);
  hi = pack_bf16(f2, f3);
}

// 2^23 + 8 (a Q4_0 nibble is the code + 8) and 2^23 + 128 (an int8 code
// with its sign bit flipped is the code + 128).
constexpr float kNibBias = 8388616.0f;
constexpr float kByteBias = 8388736.0f;

// A block of BM rows by 128 columns; its 8 warps in WM rows of 8 / WM, each
// warp's share (BM / WM) x (128 WM / 8) in f32 fragments.
template <int BM, int WM, typename F>
__global__ void __launch_bounds__(kThreads, 1) qgemm_kernel(Args a) {
  using S = Smem<BM, F>;
  constexpr int kStages = S::kStages;
  constexpr int G = F::kG, NG = F::kGroups;
  constexpr int WN = kWarps / WM, WROWS = BM / WM, WCOLS = kBN / WN;
  constexpr int MT = WROWS / 16, NT = WCOLS / 8;  // m16 and n8 tiles a warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + kStages * S::kStage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * kBN;
  const int B = a.B, K = a.K, N = a.N, KG = K / G;
  // This block's K steps: split blockIdx.z of the walk.
  const int k_first = blockIdx.z * a.split_steps;
  const int nk = min(a.split_steps, (K + kBK - 1) / kBK - k_first);

  // -- the copies of the block's step j into its stage --
  auto issue = [&](int j) {
    unsigned char* st = smem + (j % kStages) * S::kStage;
    const int k0 = (k_first + j) * kBK;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st);
    for (int i = tid; i < BM * 8; i += kThreads) {  // 8 chunks of 8 inputs a row
      const int r = i >> 3, k = k0 + (i & 7) * 8, row = row0 + r;
      const bool ok = row < B && k < K;
      cp_async16(xs + r * kRow + (i & 7) * 8, ok ? a.x + static_cast<size_t>(row) * K + k : a.x,
                 ok);
    }
    unsigned char* cs = st + S::kX;
    constexpr int kChunks = F::kBytes / 16;
    for (int i = tid; i < kBN * kChunks; i += kThreads) {
      const int n = i / kChunks, c = i % kChunks, col = col0 + n;
      const int k = k0 + c * (F::kNibbles ? 32 : 16);  // the chunk's first input
      const bool ok = col < N && k < K;
      const size_t off = F::kNibbles ? static_cast<size_t>(col) * (K / 2) + k / 2
                                     : static_cast<size_t>(col) * K + k;
      cp_async16(cs + n * F::kStride + c * 16, ok ? a.qs + off : a.qs, ok);
    }
    if constexpr (F::kSb) {  // d, dmin, then the sc and mn words of the step's groups
      uint32_t* rw = reinterpret_cast<uint32_t*>(st + S::kOffRaw);
      const int sb = k0 / 256, word = ((k0 / kBK) & 2) * 2;
      for (int i = tid; i < 4 * kBN; i += kThreads) {
        const int part = i / kBN, col = col0 + i % kBN;
        const bool ok = col < N;
        const void* src;
        if (part < 2)
          src = (part == 0 ? a.scales : a.mins) + (ok ? static_cast<size_t>(col) * (K / 256) + sb : 0);
        else
          src = a.scmn + (ok ? static_cast<size_t>(col) * (K / 16) + (part == 3 ? K / 32 : 0) +
                                   sb * 8 + word
                             : 0);
        cp_async4(rw + i, src, ok);
      }
    } else {
      float* ss = reinterpret_cast<float*>(st + S::kOffScales);
      for (int i = tid; i < kBN * NG; i += kThreads) {
        const int n = i / NG, g = k0 / G + i % NG, col = col0 + n;
        const bool ok = col < N && g < KG;
        const size_t off = static_cast<size_t>(col) * KG + g;
        cp_async4(ss + i, ok ? a.scales + off : a.scales, ok);
        if constexpr (F::kMins) cp_async4(ss + kBN * NG + i, ok ? a.mins + off : a.mins, ok);
      }
    }
    if constexpr (F::kMins) {
      float* xg = reinterpret_cast<float*>(st + S::kOffSums);
      for (int i = tid; i < BM * NG; i += kThreads) {
        const int r = i / NG, g = k0 / G + i % NG, row = row0 + r;
        const bool ok = row < B && g < KG;
        cp_async4(xg + i, ok ? a.xsum + static_cast<size_t>(row) * KG + g : a.xsum, ok);
      }
    }
  };

  // -- widening: thread -> column n = tid % 128 of the W tile, inputs
  // [32h, 32h + 32) of the step, h = tid / 128.  load() reads the step's
  // codes and scales (super-blocks: expands the group's s and, with
  // `mins`, writes its m into the step's stage); piece(p) turns inputs
  // [8p, 8p + 8) of the thread's 32 into bf16 code * s, one 16-byte store --
  const int wn_col = tid & (kBN - 1), wh = tid >> 7;
  uint32_t words[F::kNibbles ? 4 : 8];
  float s0, s1;
  auto load = [&](int j, bool mins) {
    unsigned char* st = smem + (j % kStages) * S::kStage;
    const unsigned char* cs = st + S::kX + wn_col * F::kStride;
    const float* ss = reinterpret_cast<const float*>(st + S::kOffScales) + wn_col * NG;
    if constexpr (F::kSb) {
      const uint4 raw = *reinterpret_cast<const uint4*>(cs + wh * 16);
      words[0] = raw.x, words[1] = raw.y, words[2] = raw.z, words[3] = raw.w;
      const uint32_t* rw = reinterpret_cast<const uint32_t*>(st + S::kOffRaw);
      const float d = __uint_as_float(rw[wn_col]), dm = __uint_as_float(rw[kBN + wn_col]);
      const int shift = (((k_first + j) * 2 + wh) & 3) * 8;  // the group's byte in the words
      const float sc = static_cast<float>((rw[2 * kBN + wn_col] >> shift) & 0xFFu);
      const float mn = static_cast<float>((rw[3 * kBN + wn_col] >> shift) & 0xFFu);
      s0 = s1 = __fmul_rn(d, sc);
      if (mins)
        reinterpret_cast<float*>(st + S::kOffMins)[wn_col * NG + wh] =
            __fsub_rn(__fmul_rn(8.f, s0), __fmul_rn(dm, mn));
    } else if constexpr (F::kNibbles) {
      const uint4 raw = *reinterpret_cast<const uint4*>(cs + wh * 16);
      words[0] = raw.x, words[1] = raw.y, words[2] = raw.z, words[3] = raw.w;
      s0 = s1 = ss[wh];
    } else {
      const uint4 r0 = *reinterpret_cast<const uint4*>(cs + wh * 32);
      const uint4 r1 = *reinterpret_cast<const uint4*>(cs + wh * 32 + 16);
      words[0] = r0.x, words[1] = r0.y, words[2] = r0.z, words[3] = r0.w;
      words[4] = r1.x, words[5] = r1.y, words[6] = r1.z, words[7] = r1.w;
      s0 = G == 32 ? ss[wh] : ss[2 * wh];
      s1 = G == 32 ? s0 : ss[2 * wh + 1];
    }
  };
  auto piece = [&](int j, int p) {
    uint4 o;
    if constexpr (F::kNibbles) {
      // Byte i of the group holds input i (low nibble) and 16 + i (high).
      const uint32_t w0 = words[(2 * p) & 3], w1 = words[(2 * p + 1) & 3];
      const int shift = p < 2 ? 0 : 4;
      scale4((w0 >> shift) & 0x0F0F0F0Fu, kNibBias, s0, o.x, o.y);
      scale4((w1 >> shift) & 0x0F0F0F0Fu, kNibBias, s0, o.z, o.w);
    } else {
      const float s = p < 2 ? s0 : s1;
      scale4(words[2 * p] ^ 0x80808080u, kByteBias, s, o.x, o.y);
      scale4(words[2 * p + 1] ^ 0x80808080u, kByteBias, s, o.z, o.w);
    }
    reinterpret_cast<uint4*>(wt + ((j & 1) * kBN + wn_col) * kRow + wh * 32)[p] = o;
  };

  // -- this warp's share: rows [wm * WROWS, +WROWS), columns [wn * WCOLS, +WCOLS) --
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // -- the walk: step j + 1 is widened while step j is multiplied --
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // step 0 landed
  __syncthreads();
  load(0, true);
#pragma unroll
  for (int p = 0; p < 4; ++p) piece(0, p);
  cp_async_wait<kStages - 3>();  // step 1 landed
  __syncthreads();
  for (int j = 0; j < nk; ++j) {
    // Step j + kStages - 1 goes into the stage of step j - 1, multiplied
    // before the last barrier and widened before the one ahead of it.
    if (j + kStages - 1 < nk) issue(j + kStages - 1);
    cp_async_commit();
    // Step j + 1's codes (at the last step, step j's again, into the W tile
    // no one reads, its m left alone) widen a quarter after each k16 of step
    // j's products, so the conversions issue between the mma's.
    load(min(j + 1, nk - 1), j + 1 < nk);
    const unsigned char* st = smem + (j % kStages) * S::kStage;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* w = wt + (j & 1) * kBN * kRow;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], xs + (wm * WROWS + mt * 16 + (lane & 15)) * kRow + ks * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, w + (wn * WCOLS + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kRow +
                            ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
      piece(j + 1, ks);
    }
    if constexpr (F::kMins) {  // m * (group sum of xn), in f32
      const float* ms = reinterpret_cast<const float*>(st + S::kOffMins);
      const float* xg = reinterpret_cast<const float*>(st + S::kOffSums);
      float xv[MT][2][NG];  // the group sums of this thread's rows
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int q = 0; q < NG; ++q)
            xv[mt][hh][q] = xg[(wm * WROWS + mt * 16 + g + hh * 8) * NG + q];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float mv[NG];  // m of column nt * 8 + c2 + e
#pragma unroll
          for (int q = 0; q < NG; ++q) mv[q] = ms[(wn * WCOLS + nt * 8 + c2 + e) * NG + q];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int q = 0; q < NG; ++q)
                acc[mt][nt][hh * 2 + e] = fmaf(xv[mt][hh][q], mv[q], acc[mt][nt][hh * 2 + e]);
        }
    }
    cp_async_wait<kStages - 3>();  // step j + 2 landed
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + wm * WROWS + mt * 16 + g + hh * 8;
      if (row >= B) continue;
      const size_t o = static_cast<size_t>(row) * N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + wn * WCOLS + nt * 8 + c2;
        const float v0 = acc[mt][nt][hh * 2], v1 = acc[mt][nt][hh * 2 + 1];
        if (gridDim.z > 1) {  // a split's f32 sums, added in order by sum_splits_kernel
          float* pr = a.part + blockIdx.z * static_cast<size_t>(B) * N + o;
          if (col < N) pr[col] = v0;
          if (col + 1 < N) pr[col + 1] = v1;
        } else if (col + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<uint32_t*>(a.y + o + col) = pack_bf16(v0, v1);
        } else {
          if (col < N) a.y[o + col] = __float2bfloat16(v0);
          if (col + 1 < N) a.y[o + col + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// y = bf16(sum over the splits of part, in split order): one rounding.
__global__ void __launch_bounds__(256) sum_splits_kernel(const float* __restrict__ part,
                                                         __nv_bfloat16* __restrict__ y,
                                                         int splits, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = part[i];
    for (int z = 1; z < splits; ++z) v += part[z * n + i];
    y[i] = __float2bfloat16(v);
  }
}

// The pre-pass, one block a row: xn = bf16((x * inv_rms) * gain) with a
// gain (inv_rms = rsqrt(mean(x^2) + eps)), and for G > 0 the f32 sums of
// xn (x without a gain) over each group of G inputs.
template <int G>
__global__ void __launch_bounds__(256) prep_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                                        const __nv_bfloat16* __restrict__ gain,
                                                        __nv_bfloat16* __restrict__ xn,
                                                        float* __restrict__ xsum, int K,
                                                        float eps) {
  constexpr int C = G > 0 ? G : 32;  // inputs a thread takes at a time
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * K;
  __shared__ float part[8];
  float inv = 1.f;
  if (gain != nullptr) {
    float s = 0.f;
    for (int k = threadIdx.x * 8; k < K; k += 256 * 8) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[i] * v[i];
    }
    s = warp_sum(s);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += part[w];
    inv = rsqrtf(s / K + eps);
  }
  for (int c = threadIdx.x; c < K / C; c += 256) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < C / 8; ++q) {
      const int k = c * C + q * 8;
      float v[8];
      load8(xr + k, v);
      if (gain != nullptr) {
        float gv[8];
        load8(gain + k, gv);
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i] = pack_bf16(__fmul_rn(__fmul_rn(v[2 * i], inv), gv[2 * i]),
                           __fmul_rn(__fmul_rn(v[2 * i + 1], inv), gv[2 * i + 1]));
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&o[i]));
          v[2 * i] = r.x;
          v[2 * i + 1] = r.y;
        }
        *reinterpret_cast<uint4*>(xn + row * K + k) = make_uint4(o[0], o[1], o[2], o[3]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += v[i];
    }
    if (G > 0) xsum[row * (K / C) + c] = sum;
  }
}

// One call of the path: x, gain and y bf16; xn [B, K] bf16, xsum [B, K/G]
// f32 and part [splits, B, N] f32 scratch the caller allocates (null where
// unused: xn without a gain, xsum without mins, part at one split).
struct Call {
  const __nv_bfloat16* x;
  const void* qs;
  const void* scales;
  const void* mins;
  const void* scmn;
  const __nv_bfloat16* gain;
  __nv_bfloat16* y;
  __nv_bfloat16* xn;
  float* xsum;
  float* part;
  int B, K, N, splits;
  float eps;
};

template <int BM, int WM, typename F>
cudaError_t launch_tiles(const Args& a, int splits, cudaStream_t stream) {
  constexpr int kSmem = Smem<BM, F>::kBytes;
  auto* fn = qgemm_kernel<BM, WM, F>;
  // Above 48 KB a kernel must be allowed its dynamic shared memory: once an
  // instantiation, not at every launch.
  static const cudaError_t allowed =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((a.B + BM - 1) / BM, (a.N + kBN - 1) / kBN, splits);
  fn<<<grid, kThreads, kSmem, stream>>>(a);
  return cudaSuccess;
}

// The block tile's rows at B rows.
inline int tile_rows(int B) { return B <= 64 ? 64 : B < 256 ? 128 : 256; }

// Splits of K.  A block runs alone on its SM, so where the tiles fill the
// card's waves of `sms` blocks poorly (few rows, a narrow N) the K steps
// split: the fewest splits whose blocks keep the SMs busy over their waves
// (else the best share), each split at least 8 steps, at most 8.  Busy is
// 80% at 64-row tiles, whose few rows are bound by the codes' bytes and
// gain from more blocks in flight, and 70% above, where a split's f32 sums
// cost more than a wave 73% full (on an H100, Llama-3-8B's wqkv at 512
// rows: 0.2267 ms in 4 splits, 0.2093 in one).
inline int splits_for(int B, int K, int N, int sms) {
  const int bm = tile_rows(B);
  const int tiles = (B + bm - 1) / bm * ((N + kBN - 1) / kBN);
  const int long_splits = (K + kBK - 1) / kBK / 8;  // splits of at least 8 steps
  const int most = long_splits < 1 ? 1 : long_splits > 8 ? 8 : long_splits;
  const double enough = bm == 64 ? 0.8 : 0.7;
  int best = 1;
  double best_busy = 0.0;
  for (int s = 1; s <= most; ++s) {
    const int blocks = tiles * s;
    const double busy = static_cast<double>(blocks) / ((blocks + sms - 1) / sms * sms);
    if (busy >= enough) return s;
    if (busy > best_busy) {
      best = s;
      best_busy = busy;
    }
  }
  return best;
}

// The pre-pass (with a gain, or for the group sums of a mins form), then
// the GEMM in tile_rows(B)-row tiles; over more than one split of K, the
// splits' sums are added and rounded after.
template <typename F>
cudaError_t run_form(const Call& c, cudaStream_t stream) {
  if (c.gain != nullptr || F::kMins) {
    prep_rows_kernel<F::kMins ? F::kG : 0><<<c.B, 256, 0, stream>>>(c.x, c.gain, c.xn, c.xsum,
                                                                     c.K, c.eps);
  }
  const int steps = (c.K + kBK - 1) / kBK;
  const int split_steps = (steps + c.splits - 1) / c.splits;
  const int splits = (steps + split_steps - 1) / split_steps;  // none of them empty
  const Args a{c.gain != nullptr ? c.xn : c.x, c.xsum, static_cast<const uint8_t*>(c.qs),
               static_cast<const float*>(c.scales), static_cast<const float*>(c.mins),
               static_cast<const uint8_t*>(c.scmn), c.y, c.part, c.B, c.K, c.N, split_steps};
  const int bm = tile_rows(c.B);
  const cudaError_t rc = bm == 64    ? launch_tiles<64, 2, F>(a, splits, stream)
                         : bm == 128 ? launch_tiles<128, 2, F>(a, splits, stream)
                                     : launch_tiles<256, 4, F>(a, splits, stream);
  if (rc != cudaSuccess || splits == 1) return rc;
  const size_t n = static_cast<size_t>(c.B) * c.N;
  const int blocks = static_cast<int>((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(c.part, c.y, splits, n);
  return cudaSuccess;
}

// The path of weight form `form` (enum Form); an invalid-value error for
// unknown forms.
inline cudaError_t run(int form, const Call& c, cudaStream_t stream) {
  if (c.splits < 1 || (c.splits > 1 && c.part == nullptr)) return cudaErrorInvalidValue;
  switch (form) {
    case kFormQ4:
      return run_form<Tile<true, 32, false>>(c, stream);
    case kFormG32:
      return run_form<Tile<false, 32, false>>(c, stream);
    case kFormG32Mins:
      return run_form<Tile<false, 32, true>>(c, stream);
    case kFormG16:
      return run_form<Tile<false, 16, false>>(c, stream);
    case kFormG16Mins:
      return run_form<Tile<false, 16, true>>(c, stream);
    case kFormSb:
      return run_form<Tile<true, 32, true, true>>(c, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace qgemm_tc
}  // namespace thawk
