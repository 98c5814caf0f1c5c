// Kernels 3, 14 and 18: decode attention over the dense bf16/f32 KV cache.
//
// Kernel 3 replaces tokenhawk_tpu/ops/pallas/flash_decode_dma.py
// flash_decode_append_walk (_kernel_walk_append) and its grid form
// flash_decode_append (_kernel_vec_append): for each (b, kv head) it
// writes k_new / v_new at slot lengths[b]-1 in place, then attends the rep
// query heads of that kv head over lengths[b] tokens.
//
// Kernel 14 replaces flash_decode_dma (_kernel, _kernel_vec),
// flash_decode_loop (_kernel_loop) and ops/pallas/flash_decode.py
// flash_decode (_kernel, reached through attend_decode): the same
// attention with no write.  It serves
// dense-weight models, whose decode writes the cache with an index copy
// first, as the reference does.
//
// Both run one body (attend_head): one block per (b, kv head), q
// pre-scaled by 1/sqrt(Dh), an online softmax in f32.  The 8 warps split
// the live tokens in tiles of 32; a lane scores one token of a tile
// against every query head of the group (16-byte loads of the K row),
// then owns Dh/32 of the head dims (4 at Dh 128, 2 at Dh 64) for P·V.
// The warps' (max, sum, acc) states merge through shared memory at the
// end.  Only the live tiles are read: both are bound by the cache bytes of
// the live tokens, 2*L*Dh*sizeof(cache) per head.
//
// Kernel 3: the block that writes a head's row is the block that reads
// it, and the barrier after q is staged orders the write before every
// read (its cache is read with plain loads, never through the
// non-coherent read-only path).  Kernel 14 writes nothing: its cache
// pointers are const __restrict__, so loads may take the read-only path.
//
// Kernel 18 replaces flash_decode_dma.py flash_decode_stats
// (_kernel_vec_stats), the per-shard half of context-parallel decode
// (parallel/ring.py decode_attend_cp): the same body without the final
// normalisation, writing the unnormalised o in f32 and each query row's
// max m and sum l.  A sequence of length 0 writes the merge identity
// (0, -inf, 0) before any read.  Its cache may be a strided view (one
// shard of a larger cache: batch, head and row strides come from the
// wrapper), and its live rows may be cut into `splits` tile-aligned
// ranges, one block each, whose partials the caller merges (an empty range
// writes the identity): with few (b, kv head) pairs, splits put more than
// B*Hkv blocks on the 132 SMs.  Bound by the live rows' bytes, as kernel 14.
//
// Kernel 16 replaces tokenhawk_tpu/ops/pallas/attn_block.py fused_attn_out
// (_attn_wo): the attention block of one decode token (B = 1, one query per
// kv head), x' = x + attend(q, cache + new row) @ Wo, with the new K / V rows
// written in place.  Two launches on one stream:
//   1. kernel 3's body, q pre-scaled in the block by 1/sqrt(Dh) and
//      rounded to q's type (the scale itself in q's type, as the
//      reference's wrapper has it), the context written as f32 into a
//      [H*Dh] scratch, never rounded;
//   2. the Wo GEMV (gemv.cuh, one row) over that f32 context, x added in
//      its epilogue and y rounded once.
// The TPU kernel streams Wo through a DMA ring during the KV walk; on the
// GPU the two launches run back to back, each bound by its own bytes (the
// live K / V rows, then Wo's blocks).
#include <type_traits>

#include "gemv.cuh"

using namespace thawk;

namespace {

constexpr int kWarps = 8;

// Attention of one block's REP query rows q [REP, DH] (f32 math) over rows
// [begin, L) of one head's cache kh, vh (rows `row` elements apart) -> out
// [REP, DH] in TO.  q_scale multiplies q first, rounded back to TQ (1 for
// kernels 3, 14 and 18, where that is exact).  STATS (kernel 18, TO =
// float) writes the unnormalised out and each row's m_out, l_out [REP].
template <typename TQ, typename TC, int REP, int DH, typename TO, bool STATS = false>
__device__ __forceinline__ void attend_head(const TQ* __restrict__ q, const TC* kh,
                                            const TC* vh, int begin, int L, size_t row,
                                            TO* __restrict__ out, float q_scale,
                                            float* m_out = nullptr, float* l_out = nullptr) {
  constexpr int kPer = DH / 32;  // head dims a lane owns for P·V
  __shared__ __align__(16) float qsm[REP][DH];
  __shared__ float red_m[kWarps][REP];
  __shared__ float red_l[kWarps][REP];
  __shared__ __align__(16) float red_acc[kWarps][REP][DH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < REP * DH; i += blockDim.x)
    qsm[i / DH][i % DH] = to_f32(from_f32<TQ>(to_f32(q[i]) * q_scale));
  __syncthreads();  // q staged (and kernel 3's appended row visible to the block)

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

// Kernel 3 (TO = TQ, q_scale 1) and kernel 16's first phase (B = 1, REP 1,
// TO = float): append the new row at lengths-1, then attend.
template <typename TQ, typename TC, int REP, int DH, typename TO>
__global__ void __launch_bounds__(kWarps * 32)
    decode_append_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                         const TQ* __restrict__ v_new, TC* kc, TC* vc,
                         const int* __restrict__ lengths, TO* __restrict__ out, int Hkv, int S,
                         float q_scale) {
  const int bh = blockIdx.x;
  const int L = max(1, min(lengths[bh / Hkv], S));
  TC* kh = kc + static_cast<size_t>(bh) * S * DH;
  TC* vh = vc + static_cast<size_t>(bh) * S * DH;
  const int tid = threadIdx.x;
  if (tid < DH) {
    const size_t src = static_cast<size_t>(bh) * DH + tid;
    const size_t dst = static_cast<size_t>(L - 1) * DH + tid;
    kh[dst] = from_f32<TC>(to_f32(k_new[src]));
    vh[dst] = from_f32<TC>(to_f32(v_new[src]));
  }
  const size_t qo = static_cast<size_t>(bh) * REP * DH;
  attend_head<TQ, TC, REP, DH, TO>(q + qo, kh, vh, 0, L, DH, out + qo, q_scale);
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
  attend_head<TQ, TC, REP, DH, TQ>(q + qo, kc + co, vc + co, 0, L, DH, out + qo, 1.f);
}

// Kernel 18: block (b * Hkv + h, split) writes the partials of its range of
// the live rows; o [splits, B, Hkv, REP, DH], m, l [splits, B, Hkv * REP].
template <typename T, int REP, int DH>
__global__ void __launch_bounds__(kWarps * 32)
    decode_stats_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ lengths,
                        float* __restrict__ o, float* __restrict__ m, float* __restrict__ l,
                        int B, int Hkv, int S, long long sb, long long sh, long long sr) {
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int L = min(max(lengths[b], 0), S);
  const int per = ((L + 31) / 32 + gridDim.y - 1) / gridDim.y * 32;  // rows of a split
  const int begin = min(split * per, L), end = min(begin + per, L);
  const size_t row0 = (static_cast<size_t>(split) * B * Hkv + bh) * REP;  // (split, b, h, 0)
  if (begin == end) {  // nothing to read: the merge identity
    for (int i = threadIdx.x; i < REP * DH; i += blockDim.x) o[row0 * DH + i] = 0.f;
    if (threadIdx.x < REP) {
      m[row0 + threadIdx.x] = -INFINITY;
      l[row0 + threadIdx.x] = 0.f;
    }
    return;
  }
  const size_t co = b * sb + h * sh;
  attend_head<T, T, REP, DH, float, true>(q + static_cast<size_t>(bh) * REP * DH, kc + co,
                                          vc + co, begin, end, sr, o + row0 * DH, 1.f,
                                          m + row0, l + row0);
}

struct Args {
  const void* q;
  const void* k_new;  // null for kernel 14
  const void* v_new;
  void* kc;
  void* vc;
  const int* lengths;
  void* out;
  int B, Hkv, S;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int REP, int DH>
void launch_one(const Args& a) {
  const dim3 grid(a.B * a.Hkv), block(kWarps * 32);
  const TQ* q = static_cast<const TQ*>(a.q);
  TQ* o = static_cast<TQ*>(a.out);
  if (a.k_new != nullptr)
    decode_append_kernel<TQ, TC, REP, DH, TQ><<<grid, block, 0, a.stream>>>(
        q, static_cast<const TQ*>(a.k_new), static_cast<const TQ*>(a.v_new),
        static_cast<TC*>(a.kc), static_cast<TC*>(a.vc), a.lengths, o, a.Hkv, a.S, 1.f);
  else
    decode_attend_kernel<TQ, TC, REP, DH><<<grid, block, 0, a.stream>>>(
        q, static_cast<const TC*>(a.kc), static_cast<const TC*>(a.vc), a.lengths, o, a.Hkv, a.S);
}

template <typename TQ, typename TC, int DH>
void launch_rep(const Args& a, int rep) {
  switch (rep) {
    case 1: launch_one<TQ, TC, 1, DH>(a); break;
    case 2: launch_one<TQ, TC, 2, DH>(a); break;
    case 4: launch_one<TQ, TC, 4, DH>(a); break;
    default: launch_one<TQ, TC, 8, DH>(a); break;
  }
}

template <typename TQ, typename TC>
void launch_dh(const Args& a, int rep, int Dh) {
  if (Dh == 64)
    launch_rep<TQ, TC, 64>(a, rep);
  else
    launch_rep<TQ, TC, 128>(a, rep);
}

int launch(const Args& a, int rep, int Dh, int q_dtype, int cache_dtype) {
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    launch_dh<__nv_bfloat16, __nv_bfloat16>(a, rep, Dh);
  else if (q_dtype == kBF16)
    launch_dh<__nv_bfloat16, float>(a, rep, Dh);
  else if (cache_dtype == kBF16)
    launch_dh<float, __nv_bfloat16>(a, rep, Dh);
  else
    launch_dh<float, float>(a, rep, Dh);
  return THAWK_LAUNCH_RESULT();
}

}  // namespace

// Kernel 3.  q, out [B, Hkv, rep, Dh] and k_new, v_new [B, Hkv, Dh] in
// q_dtype; caches [B, Hkv, S, Dh] in cache_dtype, updated in place;
// lengths [B] int32.  rep is 1, 2, 4 or 8 and Dh 64 or 128 (checked by
// the Python wrapper).
extern "C" int th_decode_append(const void* q, const void* k_new, const void* v_new, void* kc,
                                void* vc, const void* lengths, void* out, int B, int Hkv, int rep,
                                int Dh, int S, int q_dtype, int cache_dtype, void* stream) {
  const Args a{q, k_new, v_new, kc, vc, static_cast<const int*>(lengths), out, B, Hkv, S,
               static_cast<cudaStream_t>(stream)};
  return launch(a, rep, Dh, q_dtype, cache_dtype);
}

// Kernel 14.  As kernel 3 without the new rows; the caches are only read.
extern "C" int th_decode_attend(const void* q, const void* kc, const void* vc,
                                const void* lengths, void* out, int B, int Hkv, int rep, int Dh,
                                int S, int q_dtype, int cache_dtype, void* stream) {
  const Args a{q, nullptr, nullptr, const_cast<void*>(kc), const_cast<void*>(vc),
               static_cast<const int*>(lengths), out, B, Hkv, S,
               static_cast<cudaStream_t>(stream)};
  return launch(a, rep, Dh, q_dtype, cache_dtype);
}

namespace {

struct StatsArgs {
  const void* q;
  const void* kc;
  const void* vc;
  const int* lengths;
  float *o, *m, *l;
  int B, Hkv, S, splits;
  long long sb, sh, sr;
  cudaStream_t stream;
};

template <typename T, int REP, int DH>
void launch_stats(const StatsArgs& a) {
  decode_stats_kernel<T, REP, DH><<<dim3(a.B * a.Hkv, a.splits), kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kc), static_cast<const T*>(a.vc),
      a.lengths, a.o, a.m, a.l, a.B, a.Hkv, a.S, a.sb, a.sh, a.sr);
}

template <typename T, int DH>
void launch_stats_rep(const StatsArgs& a, int rep) {
  switch (rep) {
    case 1: launch_stats<T, 1, DH>(a); break;
    case 2: launch_stats<T, 2, DH>(a); break;
    case 4: launch_stats<T, 4, DH>(a); break;
    default: launch_stats<T, 8, DH>(a); break;
  }
}

template <typename T>
void launch_stats_dh(const StatsArgs& a, int rep, int Dh) {
  if (Dh == 64)
    launch_stats_rep<T, 64>(a, rep);
  else
    launch_stats_rep<T, 128>(a, rep);
}

}  // namespace

// Kernel 18.  q [B, Hkv, rep, Dh] in dtype (pre-scaled); caches of
// [B, Hkv, S, Dh] shape in dtype, element strides sb, sh, sr between
// sequences, heads and rows (the last dim contiguous); lengths [B] int32
// (clamped to [0, S]); o [splits, B, Hkv, rep, Dh], m, l [splits, B,
// Hkv*rep] f32.  rep is 1, 2, 4 or 8, Dh 64 or 128, splits >= 1 (checked
// by the Python wrapper).
extern "C" int th_flash_decode_stats(const void* q, const void* kc, const void* vc,
                                     const void* lengths, void* o, void* m, void* l, int B,
                                     int Hkv, int rep, int Dh, int S, int splits, long long sb,
                                     long long sh, long long sr, int dtype, void* stream) {
  const StatsArgs a{q, kc, vc, static_cast<const int*>(lengths), static_cast<float*>(o),
                    static_cast<float*>(m), static_cast<float*>(l), B, Hkv, S, splits, sb, sh,
                    sr, static_cast<cudaStream_t>(stream)};
  if (dtype == kBF16)
    launch_stats_dh<__nv_bfloat16>(a, rep, Dh);
  else
    launch_stats_dh<float>(a, rep, Dh);
  return THAWK_LAUNCH_RESULT();
}

namespace {

struct AttnWoArgs {
  const void* q;  // [H, Dh], not yet scaled
  const void* k_new;
  const void* v_new;
  void* kc;  // [H, S, Dh]
  void* vc;
  const int* lengths;  // [1]
  const void* x;       // [D]
  const void *wo_qs, *wo_s, *wo_m;
  int wo_form;
  float* ctx;  // [H*Dh] f32 scratch
  void* y;     // [D]
  int H, S, D;
  float q_scale;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int DH>
bool launch_attn_wo(const AttnWoArgs& a) {
  decode_append_kernel<TQ, TC, 1, DH, float><<<a.H, kWarps * 32, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k_new),
      static_cast<const TQ*>(a.v_new), static_cast<TC*>(a.kc), static_cast<TC*>(a.vc),
      a.lengths, a.ctx, a.H, a.S, a.q_scale);
  return with_reader<false>(a.wo_form, a.wo_qs, a.wo_s, a.wo_m, nullptr, [&](const auto& wr) {
    using Reader = std::decay_t<decltype(wr)>;
    gemv_kernel<float, TQ, 1, kResidual, Reader, float, TQ>
        <<<dim3(1, gemv_col_blocks(kResidual, a.D)), kGemvThreads, 0, a.stream>>>(
            a.ctx, 1, a.H * DH, wr, a.D, nullptr, nullptr, static_cast<const TQ*>(a.x),
            static_cast<TQ*>(a.y));
  });
}

template <typename TQ, typename TC>
bool launch_attn_wo_dh(const AttnWoArgs& a, int Dh) {
  return Dh == 64 ? launch_attn_wo<TQ, TC, 64>(a) : launch_attn_wo<TQ, TC, 128>(a);
}

}  // namespace

// Kernel 16.  q, k_new, v_new [H, Dh] in q_dtype (q unscaled); caches
// [H, S, Dh] in cache_dtype, written in place; lengths [1] int32 (tokens
// including the new one); x, y [D] in q_dtype; Wo [H*Dh, D] as (qs, scales,
// mins, hi, form), hi unused (no sb form); ctx [H*Dh] f32 scratch.  Dh is
// 64 or 128 (checked by the Python wrapper).
extern "C" int th_attn_wo(const void* q, const void* k_new, const void* v_new, void* kc,
                          void* vc, const void* lengths, const void* x, const void* wo_qs,
                          const void* wo_s, const void* wo_m, const void*, int wo_form,
                          void* ctx, void* y, int H, int Dh, int S, int D, float q_scale,
                          int q_dtype, int cache_dtype, void* stream) {
  if (wo_form < kFormQ4 || wo_form > kFormG16Mins) return static_cast<int>(cudaErrorInvalidValue);
  const AttnWoArgs a{q, k_new, v_new, kc, vc, static_cast<const int*>(lengths), x, wo_qs, wo_s,
                     wo_m, wo_form, static_cast<float*>(ctx), y, H, S, D, q_scale,
                     static_cast<cudaStream_t>(stream)};
  bool known;
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    known = launch_attn_wo_dh<__nv_bfloat16, __nv_bfloat16>(a, Dh);
  else if (q_dtype == kBF16)
    known = launch_attn_wo_dh<__nv_bfloat16, float>(a, Dh);
  else if (cache_dtype == kBF16)
    known = launch_attn_wo_dh<float, __nv_bfloat16>(a, Dh);
  else
    known = launch_attn_wo_dh<float, float>(a, Dh);
  return known ? THAWK_LAUNCH_RESULT() : static_cast<int>(cudaErrorInvalidValue);
}
