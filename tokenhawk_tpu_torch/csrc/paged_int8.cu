// Kernels 10-12: the int8 paged KV pool (decode attention, quantizing row
// append, dequantizing page gather).
//
// A pool holds one layer's int8 codes, [n_pages, Hkv, ps, Dh] ("contig")
// or [Hkv, n_pages, ps, Dh] ("head"), Dh 64 or 128 (a template parameter of
// every kernel), and its f32 scale pages of the same
// layout without the last axis, [n_pages, Hkv, ps] or [Hkv, n_pages, ps].
// Every kernel takes the page and head strides of the codes and of the
// scales, in elements, so both layouts run the same code.  A stored scale is
// the codec's bfloat16-rounded scale held as f32 (kv_int8.cuh).  Page ids
// come from the scheduler's tables and are trusted.
//
// Kernel 10, paged decode, replaces tokenhawk_tpu/ops/pallas/paged_decode_int8.py
// paged_flash_decode_int8_walk (_kernel_walk) and its grid form
// paged_flash_decode_int8 (_kernel_vec).  Kernel 5's walk (paged_decode.cu)
// over int8 pages: one block per (sequence, kv head), tiles of 32 tokens
// across 8 warps, a lane scoring one token (16-byte code loads, times the
// token's K scale) and owning Dh/32 head dims for P·V (probability times the
// token's V scale); f32 online softmax, exact attention over the dequantized
// pages (the TPU kernel also quantizes the query and the probabilities).
// Bound by the bytes of the live codes and scales.  A row of length 0
// writes zeros.
//
// Kernel 11, paged append, replaces paged_append_rows on int8 payloads
// together with paged_append_scales (tokenhawk_tpu/ops/pallas/paged_decode.py):
// blocks of 8 warps, a warp per row, quantize each sequence's new K and V
// rows and write codes and scale at (page, slot) of the K and V pools in
// one launch.  Sequences parked on the trash page may write the same (page,
// slot); which one lands there is unspecified.  Launch-bound (~17 KB at 7B,
// B=8).
//
// Kernel 12, page gather, replaces gather_pages_dense_int8 and the
// dequantizing multiply its caller does (tokenhawk_tpu/models/llama.py
// forward_paged_prefill_cont): one block per (sequence, table entry, kv
// head) reads that page's ps x Dh codes of K and of V and its scales and
// writes the dequantized rows, code x scale rounded once to the output type,
// into dense [B, Hkv, mp*ps, Dh] outputs.  Bound by bytes.
#include "kv_int8.cuh"

using namespace thawk;

namespace {

constexpr int kWarps = 8;

struct PoolStrides {
  long long page, head;    // codes, in elements (bytes)
  long long spage, shead;  // scales, in elements
};

template <typename TQ, int REP, int kDh>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_int8_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ kp,
                             const float* __restrict__ ksp, const int8_t* __restrict__ vp,
                             const float* __restrict__ vsp, const int* __restrict__ table,
                             const int* __restrict__ lengths, TQ* __restrict__ out, int Hkv,
                             int ps, int max_pages, PoolStrides st) {
  constexpr int kPer = kDh / 32;  // head dims a lane owns for P·V
  __shared__ __align__(16) float qsm[REP][kDh];
  __shared__ float red_m[kWarps][REP];
  __shared__ float red_l[kWarps][REP];
  __shared__ __align__(16) float red_acc[kWarps][REP][kDh];

  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = min(lengths[b], max_pages * ps);
  TQ* o = out + static_cast<size_t>(bh) * REP * kDh;
  if (L <= 0) {
    for (int i = tid; i < REP * kDh; i += blockDim.x) o[i] = from_f32<TQ>(0.f);
    return;
  }
  const int* row_pages = table + static_cast<size_t>(b) * max_pages;
  const int8_t* kh = kp + static_cast<size_t>(h) * st.head;
  const int8_t* vh = vp + static_cast<size_t>(h) * st.head;
  const float* ksh = ksp + static_cast<size_t>(h) * st.shead;
  const float* vsh = vsp + static_cast<size_t>(h) * st.shead;
  // Codes and scale of token t in this head's pages.
  auto row = [&](const int8_t* base, int t) {
    return base + static_cast<size_t>(row_pages[t / ps]) * st.page +
           static_cast<size_t>(t % ps) * kDh;
  };
  auto scale = [&](const float* base, int t) {
    return base[static_cast<size_t>(row_pages[t / ps]) * st.spage + t % ps];
  };

  for (int i = tid; i < REP * kDh; i += blockDim.x)
    qsm[i / kDh][i % kDh] = to_f32(q[static_cast<size_t>(bh) * REP * kDh + i]);
  __syncthreads();

  float m[REP], l[REP], acc[REP][kPer];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[r][i] = 0.f;
  }

  const int n_tiles = (L + 31) / 32;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int tok = t * 32 + lane;
    const bool valid = tok < L;
    float s[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) s[r] = 0.f;
    float v_scale = 0.f;
    if (valid) {
      const int8_t* krow = row(kh, tok);
#pragma unroll 2
      for (int i = 0; i < kDh; i += 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + i);
        float kv[16];
        unpack4(raw.x, kv);
        unpack4(raw.y, kv + 4);
        unpack4(raw.z, kv + 8);
        unpack4(raw.w, kv + 12);
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int j = 0; j < 16; ++j) s[r] += qsm[r][i + j] * kv[j];
      }
      const float k_scale = scale(ksh, tok);
#pragma unroll
      for (int r = 0; r < REP; ++r) s[r] *= k_scale;
      v_scale = scale(vsh, tok);
    }
    float pv[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float sr = valid ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));  // lane 0 of a tile is always live
      const float alpha = expf(m[r] - m_new);
      const float p = valid ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      pv[r] = p * v_scale;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[r][i] *= alpha;
    }
    const int n_live = min(32, L - t * 32);
    for (int j = 0; j < n_live; ++j) {
      float v[kPer];
      load_codes<kPer>(row(vh, t * 32 + j) + lane * kPer, v);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pv[r], j);
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
  for (int i = tid; i < REP * kDh; i += blockDim.x) {
    const int r = i / kDh, d = i % kDh;
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
    o[i] = from_f32<TQ>(num / den);
  }
}

// Block (b, y): warp w quantizes row 8y + w of sequence b's 2*Hkv rows (K
// heads, then V heads), kDh/32 values a lane.
template <typename TN, int kDh>
__global__ void __launch_bounds__(kWarps * 32)
    paged_append_int8_kernel(int8_t* kp, float* ksp, int8_t* vp, float* vsp,
                             const TN* __restrict__ k_new, const TN* __restrict__ v_new,
                             const int* __restrict__ page, const int* __restrict__ slot, int Hkv,
                             PoolStrides st) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const size_t pg = static_cast<size_t>(page[b]);
  const int sl = slot[b];
  if (r < 2 * Hkv) {
    const bool is_v = r >= Hkv;
    const int h = is_v ? r - Hkv : r;
    constexpr int kPer = kDh / 32;
    const TN* src =
        (is_v ? v_new : k_new) + (static_cast<size_t>(b) * Hkv + h) * kDh + lane * kPer;
    float x[kPer];
    load_n<kPer>(src, x);
    signed char codes[kPer];
    const float sc = quantize_row<kPer>(x, codes);
    int8_t* dst = (is_v ? vp : kp) + pg * st.page + static_cast<size_t>(h) * st.head +
                  static_cast<size_t>(sl) * kDh + lane * kPer;
#pragma unroll
    for (int i = 0; i < kPer; ++i) dst[i] = codes[i];
    if (lane == 0)
      (is_v ? vsp : ksp)[pg * st.spage + static_cast<size_t>(h) * st.shead + sl] =
          __bfloat162float(__float2bfloat16_rn(sc));
  }
}

// Block (b*max_pages + i, h): page table[b, i], head h; a thread turns 8
// codes of a row into 8 outputs at a time.
template <typename TO, int kDh>
__global__ void __launch_bounds__(256)
    gather_pages_int8_kernel(const int8_t* __restrict__ kp, const float* __restrict__ ksp,
                             const int8_t* __restrict__ vp, const float* __restrict__ vsp,
                             const int* __restrict__ table, TO* __restrict__ k_out,
                             TO* __restrict__ v_out, int Hkv, int max_pages, int ps,
                             PoolStrides st) {
  const int bi = blockIdx.x, h = blockIdx.y;
  const int b = bi / max_pages, i = bi % max_pages;
  const size_t pg = static_cast<size_t>(table[bi]);
  const size_t src = pg * st.page + static_cast<size_t>(h) * st.head;
  const size_t ssrc = pg * st.spage + static_cast<size_t>(h) * st.shead;
  const size_t dst = ((static_cast<size_t>(b) * Hkv + h) * max_pages + i) * ps * kDh;
  constexpr int kChunks = kDh / 8;
  for (int e = threadIdx.x; e < ps * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const size_t at = static_cast<size_t>(r) * kDh + c;
    const uint2 kr = *reinterpret_cast<const uint2*>(kp + src + at);
    const uint2 vr = *reinterpret_cast<const uint2*>(vp + src + at);
    const float k_scale = ksp[ssrc + r], v_scale = vsp[ssrc + r];
    float kv[8], vv[8];
    unpack4(kr.x, kv);
    unpack4(kr.y, kv + 4);
    unpack4(vr.x, vv);
    unpack4(vr.y, vv + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      kv[j] *= k_scale;  // exact in f32: a 7-bit code times an 8-bit scale
      vv[j] *= v_scale;
    }
    store8(k_out + dst + at, kv);
    store8(v_out + dst + at, vv);
  }
}

template <typename TQ, int kDh>
void launch_decode(const void* q, const void* kp, const void* ksp, const void* vp,
                   const void* vsp, const int* table, const int* lengths, void* out, int B,
                   int Hkv, int rep, int ps, int max_pages, PoolStrides st, cudaStream_t stream) {
  const dim3 grid(B * Hkv), block(kWarps * 32);
  const TQ* qt = static_cast<const TQ*>(q);
  const int8_t* kc = static_cast<const int8_t*>(kp);
  const int8_t* vc = static_cast<const int8_t*>(vp);
  const float* ks = static_cast<const float*>(ksp);
  const float* vs = static_cast<const float*>(vsp);
  TQ* o = static_cast<TQ*>(out);
#define THAWK_PAGED8(R)                                                                 \
  paged_decode_int8_kernel<TQ, R, kDh><<<grid, block, 0, stream>>>(                     \
      qt, kc, ks, vc, vs, table, lengths, o, Hkv, ps, max_pages, st)
  switch (rep) {
    case 1: THAWK_PAGED8(1); break;
    case 2: THAWK_PAGED8(2); break;
    case 4: THAWK_PAGED8(4); break;
    default: THAWK_PAGED8(8); break;
  }
#undef THAWK_PAGED8
}

template <typename TN, int kDh>
void launch_append(void* k_pages, void* ks_pages, void* v_pages, void* vs_pages,
                   const void* k_new, const void* v_new, const int* page, const int* slot, int B,
                   int Hkv, PoolStrides st, cudaStream_t stream) {
  const dim3 grid(B, (2 * Hkv + kWarps - 1) / kWarps);
  paged_append_int8_kernel<TN, kDh><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<int8_t*>(k_pages), static_cast<float*>(ks_pages),
      static_cast<int8_t*>(v_pages), static_cast<float*>(vs_pages),
      static_cast<const TN*>(k_new), static_cast<const TN*>(v_new), page, slot, Hkv, st);
}

template <typename TO, int kDh>
void launch_gather(const void* k_pages, const void* ks_pages, const void* v_pages,
                   const void* vs_pages, const int* table, void* k_out, void* v_out, int B,
                   int Hkv, int max_pages, int ps, PoolStrides st, cudaStream_t stream) {
  const dim3 grid(B * max_pages, Hkv);
  gather_pages_int8_kernel<TO, kDh><<<grid, 256, 0, stream>>>(
      static_cast<const int8_t*>(k_pages), static_cast<const float*>(ks_pages),
      static_cast<const int8_t*>(v_pages), static_cast<const float*>(vs_pages), table,
      static_cast<TO*>(k_out), static_cast<TO*>(v_out), Hkv, max_pages, ps, st);
}

}  // namespace

// Every entry point takes Dh, 64 or 128 (checked by the wrapper), and
// dispatches on it and on the activation type (kF32 or kBF16).
#define THAWK_DISPATCH(DTYPE, LAUNCH, ...)                                  \
  do {                                                                      \
    if (DTYPE == kBF16) {                                                   \
      if (Dh == 64) LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);                 \
      else LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);                         \
    } else {                                                                \
      if (Dh == 64) LAUNCH<float, 64>(__VA_ARGS__);                         \
      else LAUNCH<float, 128>(__VA_ARGS__);                                 \
    }                                                                       \
  } while (0)

// q, out [B, Hkv, rep, Dh] in q_dtype (q pre-scaled); k_pages, v_pages one
// layer's int8 codes and ks_pages, vs_pages its f32 scales; table
// [B, max_pages] and lengths [B] int32; strides in elements.  rep is 1, 2,
// 4 or 8 (checked by the wrapper).
extern "C" int th_paged_decode_int8(const void* q, const void* k_pages, const void* ks_pages,
                                    const void* v_pages, const void* vs_pages,
                                    const void* table, const void* lengths, void* out, int B,
                                    int Hkv, int rep, int Dh, int ps, int max_pages,
                                    long long page_stride, long long head_stride,
                                    long long spage_stride, long long shead_stride, int q_dtype,
                                    void* stream) {
  const PoolStrides st{page_stride, head_stride, spage_stride, shead_stride};
  THAWK_DISPATCH(q_dtype, launch_decode, q, k_pages, ks_pages, v_pages, vs_pages,
                 static_cast<const int*>(table), static_cast<const int*>(lengths), out, B, Hkv,
                 rep, ps, max_pages, st, static_cast<cudaStream_t>(stream));
  return THAWK_LAUNCH_RESULT();
}

// k_new, v_new [B, Hkv, Dh] in new_dtype; page, slot [B] int32; the pools
// as above, written in place.
extern "C" int th_paged_append_int8(void* k_pages, void* ks_pages, void* v_pages,
                                    void* vs_pages, const void* k_new, const void* v_new,
                                    const void* page, const void* slot, int B, int Hkv, int Dh,
                                    long long page_stride, long long head_stride,
                                    long long spage_stride, long long shead_stride,
                                    int new_dtype, void* stream) {
  const PoolStrides st{page_stride, head_stride, spage_stride, shead_stride};
  THAWK_DISPATCH(new_dtype, launch_append, k_pages, ks_pages, v_pages, vs_pages, k_new, v_new,
                 static_cast<const int*>(page), static_cast<const int*>(slot), B, Hkv, st,
                 static_cast<cudaStream_t>(stream));
  return THAWK_LAUNCH_RESULT();
}

// k_out, v_out [B, Hkv, max_pages*ps, Dh] in out_dtype; the pools as above.
extern "C" int th_gather_pages_int8(const void* k_pages, const void* ks_pages,
                                    const void* v_pages, const void* vs_pages, const void* table,
                                    void* k_out, void* v_out, int B, int Hkv, int Dh,
                                    int max_pages, int ps, long long page_stride,
                                    long long head_stride, long long spage_stride,
                                    long long shead_stride, int out_dtype, void* stream) {
  const PoolStrides st{page_stride, head_stride, spage_stride, shead_stride};
  THAWK_DISPATCH(out_dtype, launch_gather, k_pages, ks_pages, v_pages, vs_pages,
                 static_cast<const int*>(table), k_out, v_out, B, Hkv, max_pages, ps, st,
                 static_cast<cudaStream_t>(stream));
  return THAWK_LAUNCH_RESULT();
}
