// Kernels 5-7: the paged KV pool (decode attention, row append, page gather).
//
// A pool holds one layer's pages, [n_pages, Hkv, ps, Dh] ("contig",
// page-major) or [Hkv, n_pages, ps, Dh] ("head", head-major).  Every kernel
// takes the page stride and the head stride in elements, so both layouts run
// the same code; within a (page, head) the ps rows of Dh values are
// contiguous.  Page ids come from the scheduler's tables and are trusted.
//
// Kernel 5, paged decode, replaces tokenhawk_tpu/ops/pallas/paged_decode.py
// paged_flash_decode_walk (_kernel_walk) and its grid form paged_flash_decode
// (_kernel_vec).  One block per (sequence, kv head) walks the live tokens of
// its own page table in tiles of 32 and keeps an f32 online softmax for the
// rep query heads of that kv head, as kernel 3 does over a dense cache
// (flash_decode.cu): a lane scores one token against every query head, then
// owns Dh/32 of the head dims for P·V (4 at Dh 128, 2 at Dh 64); the 8
// warps' states merge through shared memory.  Bound by the bytes of the live K and V rows; at B=1 the
// grid is only Hkv blocks (32 of 132 SMs at 7B), the known limit of this
// first version.  A row of length 0 writes zeros.
//
// Kernel 6, paged append, replaces paged_append_rows (_append_kernel): one
// block per sequence copies its new K and V rows [Hkv, Dh] into (page, slot)
// of the K and V pools in one launch.  Sequences parked on the trash page
// may write the same (page, slot); which one lands there is unspecified.
//
// Kernel 7, page gather, replaces gather_pages_dense (_gather_kernel): one
// block per (sequence, table entry, kv head) copies that page's ps x Dh
// block of K and of V into the dense [B, Hkv, mp*ps, Dh] outputs.  A copy
// with 16-byte vector loads and stores, bound by bytes.
//
// Kernels 6 and 7 copy rows and pages as bytes, whatever the head dim;
// kernel 5 is built for head dims 64 (TinyLlama's) and 128 (LLaMA's).
#include "common.cuh"

using namespace thawk;

namespace {

constexpr int kWarps = 8;

template <typename TQ, typename TC, int REP, int DH>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kp,
                        const TC* __restrict__ vp, const int* __restrict__ table,
                        const int* __restrict__ lengths, TQ* __restrict__ out, int Hkv, int ps,
                        int max_pages, long long page_stride, long long head_stride) {
  constexpr int kPer = DH / 32;  // head dims a lane owns for P·V
  __shared__ __align__(16) float qsm[REP][DH];
  __shared__ float red_m[kWarps][REP];
  __shared__ float red_l[kWarps][REP];
  __shared__ __align__(16) float red_acc[kWarps][REP][DH];

  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = min(lengths[b], max_pages * ps);
  TQ* o = out + static_cast<size_t>(bh) * REP * DH;
  if (L <= 0) {
    for (int i = tid; i < REP * DH; i += blockDim.x) o[i] = from_f32<TQ>(0.f);
    return;
  }
  const int* row_pages = table + static_cast<size_t>(b) * max_pages;
  const TC* kh = kp + static_cast<size_t>(h) * head_stride;
  const TC* vh = vp + static_cast<size_t>(h) * head_stride;
  // Row of token t in this head's pages.
  auto row = [&](const TC* base, int t) {
    return base + static_cast<size_t>(row_pages[t / ps]) * page_stride +
           static_cast<size_t>(t % ps) * DH;
  };

  for (int i = tid; i < REP * DH; i += blockDim.x)
    qsm[i / DH][i % DH] = to_f32(q[static_cast<size_t>(bh) * REP * DH + i]);
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
    if (valid) {
      const TC* krow = row(kh, tok);
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
    const int n_live = min(32, L - t * 32);
    for (int j = 0; j < n_live; ++j) {
      float v[kPer];
      load_n<kPer>(row(vh, t * 32 + j) + lane * kPer, v);
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
    o[i] = from_f32<TQ>(num / den);
  }
}

template <typename TQ, typename TC, int DH>
void launch_decode(const void* q, const void* kp, const void* vp, const int* table,
                   const int* lengths, void* out, int B, int Hkv, int rep, int ps, int max_pages,
                   long long page_stride, long long head_stride, cudaStream_t stream) {
  const dim3 grid(B * Hkv), block(kWarps * 32);
  const TQ* qt = static_cast<const TQ*>(q);
  const TC* kt = static_cast<const TC*>(kp);
  const TC* vt = static_cast<const TC*>(vp);
  TQ* o = static_cast<TQ*>(out);
#define THAWK_PAGED(R)                                                                      \
  paged_decode_kernel<TQ, TC, R, DH><<<grid, block, 0, stream>>>(qt, kt, vt, table, lengths, o, \
                                                                 Hkv, ps, max_pages,           \
                                                                 page_stride, head_stride)
  switch (rep) {
    case 1: THAWK_PAGED(1); break;
    case 2: THAWK_PAGED(2); break;
    case 4: THAWK_PAGED(4); break;
    default: THAWK_PAGED(8); break;
  }
#undef THAWK_PAGED
}

template <typename TQ, typename TC>
void launch_decode_dh(int Dh, const void* q, const void* kp, const void* vp, const int* table,
                      const int* lengths, void* out, int B, int Hkv, int rep, int ps,
                      int max_pages, long long page_stride, long long head_stride,
                      cudaStream_t stream) {
  if (Dh == 64)
    launch_decode<TQ, TC, 64>(q, kp, vp, table, lengths, out, B, Hkv, rep, ps, max_pages,
                              page_stride, head_stride, stream);
  else
    launch_decode<TQ, TC, 128>(q, kp, vp, table, lengths, out, B, Hkv, rep, ps, max_pages,
                               page_stride, head_stride, stream);
}

// One block per sequence: Hkv rows of row_vecs 16-byte vectors each, for K
// and for V.
__global__ void paged_append_kernel(uint4* kp, uint4* vp, const uint4* __restrict__ k_new,
                                    const uint4* __restrict__ v_new,
                                    const int* __restrict__ page, const int* __restrict__ slot,
                                    int Hkv, int row_vecs, long long page_stride_v,
                                    long long head_stride_v) {
  const int b = blockIdx.x;
  const size_t dst0 = static_cast<size_t>(page[b]) * page_stride_v +
                      static_cast<size_t>(slot[b]) * row_vecs;
  const size_t src0 = static_cast<size_t>(b) * Hkv * row_vecs;
  for (int i = threadIdx.x; i < Hkv * row_vecs; i += blockDim.x) {
    const int h = i / row_vecs, e = i % row_vecs;
    const size_t dst = dst0 + static_cast<size_t>(h) * head_stride_v + e;
    kp[dst] = k_new[src0 + i];
    vp[dst] = v_new[src0 + i];
  }
}

// Block (b*max_pages + i, h): page table[b, i], head h, ps*Dh elements
// (page_vecs 16-byte vectors) of K and of V.
__global__ void gather_pages_kernel(const uint4* __restrict__ kp, const uint4* __restrict__ vp,
                                    const int* __restrict__ table, uint4* __restrict__ k_out,
                                    uint4* __restrict__ v_out, int Hkv, int max_pages,
                                    int page_vecs, long long page_stride_v,
                                    long long head_stride_v) {
  const int bi = blockIdx.x, h = blockIdx.y;
  const int b = bi / max_pages, i = bi % max_pages;
  const size_t src = static_cast<size_t>(table[bi]) * page_stride_v +
                     static_cast<size_t>(h) * head_stride_v;
  const size_t dst = (static_cast<size_t>(b) * Hkv + h) * max_pages * page_vecs +
                     static_cast<size_t>(i) * page_vecs;
  for (int e = threadIdx.x; e < page_vecs; e += blockDim.x) {
    k_out[dst + e] = kp[src + e];
    v_out[dst + e] = vp[src + e];
  }
}

}  // namespace

// q, out [B, Hkv, rep, Dh] in q_dtype (q pre-scaled); k_pages, v_pages one
// layer's pools in pool_dtype (strides in elements); table [B, max_pages]
// and lengths [B] int32.  rep must be 1, 2, 4 or 8 and Dh 64 or 128
// (checked by the wrapper).
extern "C" int th_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                               const void* table, const void* lengths, void* out, int B, int Hkv,
                               int rep, int Dh, int ps, int max_pages, long long page_stride,
                               long long head_stride, int q_dtype, int pool_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
#define THAWK_DECODE(TQ, TC)                                                                   \
  launch_decode_dh<TQ, TC>(Dh, q, k_pages, v_pages, tb, len, out, B, Hkv, rep, ps, max_pages, \
                           page_stride, head_stride, s)
  if (q_dtype == kBF16 && pool_dtype == kBF16)
    THAWK_DECODE(__nv_bfloat16, __nv_bfloat16);
  else if (q_dtype == kBF16)
    THAWK_DECODE(__nv_bfloat16, float);
  else if (pool_dtype == kBF16)
    THAWK_DECODE(float, __nv_bfloat16);
  else
    THAWK_DECODE(float, float);
#undef THAWK_DECODE
  return THAWK_LAUNCH_RESULT();
}

// k_new, v_new [B, Hkv, row] in the pools' type, row = row_bytes bytes;
// page, slot [B] int32; strides in bytes.  Every size is a multiple of 16
// bytes and every pointer 16-byte aligned (checked by the wrapper).
extern "C" int th_paged_append(void* k_pages, void* v_pages, const void* k_new,
                               const void* v_new, const void* page, const void* slot, int B,
                               int Hkv, int row_bytes, long long page_stride_bytes,
                               long long head_stride_bytes, void* stream) {
  paged_append_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<const int*>(page), static_cast<const int*>(slot), Hkv, row_bytes / 16,
      page_stride_bytes / 16, head_stride_bytes / 16);
  return THAWK_LAUNCH_RESULT();
}

// k_out, v_out [B, Hkv, max_pages*ps, Dh]; one page of one head is
// page_bytes contiguous bytes; strides in bytes (multiples of 16).
extern "C" int th_gather_pages(const void* k_pages, const void* v_pages, const void* table,
                               void* k_out, void* v_out, int B, int Hkv, int max_pages,
                               int page_bytes, long long page_stride_bytes,
                               long long head_stride_bytes, void* stream) {
  const dim3 grid(B * max_pages, Hkv);
  gather_pages_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k_pages), static_cast<const uint4*>(v_pages),
      static_cast<const int*>(table), static_cast<uint4*>(k_out), static_cast<uint4*>(v_out),
      Hkv, max_pages, page_bytes / 16, page_stride_bytes / 16, head_stride_bytes / 16);
  return THAWK_LAUNCH_RESULT();
}
