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
// paged_flash_decode_int8 (_kernel_vec): attention of the rep query heads
// of each (sequence, kv head) over its min(lengths[b], max_pages * ps) live
// rows, read through its own page table, f32 online softmax, exact
// attention over the dequantized pages (the TPU kernel also quantizes the
// query and the probabilities).  Bound by the bytes of the live codes and
// scales.  It runs kernel 5's form of the shared-memory tile walk
// (decode_tiles.cuh, PagedRows8) over int8 rows: each 16-byte cp.async of
// a row's codes reads table[b, t / ps] * page_stride + h * head_stride +
// (t % ps) * Dh, so a 128-row chunk may span pages; the chunk's f32 scales
// come one 4-byte cp.async a row in the same commit group, and each code
// is widened to f32 times its row's scale where the scores and P·V use it.
// One block a (sequence, kv head), or, where the wrapper asks for
// `splits` > 1 (kernel 5's rule), each pair's live rows cut on the card
// into ranges of at least min_tiles tiles over a thread-block cluster and
// merged on chip.  A row of length 0 writes zeros.
//
// Kernel 10 with kernel 11 folded in (th_paged_decode_int8_append, the int8
// decode layer's one launch): lengths[b] counts the tokens already stored;
// the block whose range holds row lengths[b] quantizes the new K and V rows
// (a warp each, kernel 11's quantize_row and bfloat16-rounded scale, so the
// pools come out bit for bit as kernel 11 writes them), writes codes and
// scale there through the table and into its own tile, and the pair attends
// over lengths[b] + 1 rows.  At the table's capacity nothing is written and
// the pair attends over the max_pages * ps rows it has.  The same instances
// serve both entries: a k_new that is not null chooses the append.
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
#include "decode_tiles.cuh"
#include "kv_int8.cuh"

using namespace thawk;

namespace {

constexpr int kWarps = 8;

struct PoolStrides {
  long long page, head;    // codes, in elements (bytes)
  long long spage, shead;  // scales, in elements
};

// Kernel 10: block (split, b * Hkv + h) of a cluster of `splits` blocks
// (one block a pair where splits is 1) runs the walk over the pair's live
// rows through the sequence's row of the table; with k_new (kernel 11
// folded in) it first quantizes and appends the pair's new row at
// lengths[b] where the table has room.
template <typename TQ, typename TC, int REP, int DH>
__global__ void __launch_bounds__(tiles::kThreads)
    paged_decode_int8_tiles_kernel(const TQ* __restrict__ q, TC* kp, float* ksp, TC* vp,
                                   float* vsp, const TQ* __restrict__ k_new,
                                   const TQ* __restrict__ v_new, const int* __restrict__ table,
                                   const int* __restrict__ lengths, TQ* __restrict__ out,
                                   int Hkv, int ps, int max_pages, PoolStrides st,
                                   int min_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const size_t qo = static_cast<size_t>(bh) * REP * DH;
  const size_t ho = static_cast<size_t>(h) * st.head, so = static_cast<size_t>(h) * st.shead;
  const int cap = max_pages * ps, n = lengths[b];
  const bool fold = k_new != nullptr;
  const bool app = fold && n >= 0 && n < cap;  // row n lies in the table
  const size_t no = static_cast<size_t>(bh) * DH;
  tiles::walk<TQ, TC, REP, DH, tiles::kCluster, true>(
      smem, q + qo,
      tiles::PagedRows8<DH>{kp + ho, vp + ho, ksp + so, vsp + so,
                            table + static_cast<size_t>(b) * max_pages, ps, st.page, st.spage},
      app ? k_new + no : nullptr, app ? v_new + no : nullptr,
      max(0, min(fold ? n + 1 : n, cap)), blockIdx.x, gridDim.x, min_tiles,
      tiles::Normalised<TQ>{out + qo});
}

struct DecodeArgs {
  const void* q;
  void* kp;
  void* ksp;
  void* vp;
  void* vsp;
  const void* k_new;  // null: attend only
  const void* v_new;
  const int* table;
  const int* lengths;
  void* out;
  int B, Hkv, ps, max_pages;
  PoolStrides st;
  int splits, min_tiles;
  cudaStream_t stream;
};

// Kernel 10's launch at one instance: splits x (B * Hkv) blocks in
// clusters of `splits`, the shared memory allowed once.
template <typename TQ, typename TC, int REP, int DH>
struct LaunchDecode {
  static cudaError_t run(const DecodeArgs& a) {
    using A = tiles::Tiles<TC, REP, DH>;
    auto* fn = paged_decode_int8_tiles_kernel<TQ, TC, REP, DH>;
    static const cudaError_t allowed = tiles::allow(fn, A::kMaxBytes, true);
    if (allowed != cudaSuccess) return allowed;
    return tiles::launch(fn, dim3(a.splits, a.B * a.Hkv), a.splits,
                         tiles::smem_bytes<TC, REP, DH>(a.splits), a.stream,
                         static_cast<const TQ*>(a.q), static_cast<TC*>(a.kp),
                         static_cast<float*>(a.ksp), static_cast<TC*>(a.vp),
                         static_cast<float*>(a.vsp), static_cast<const TQ*>(a.k_new),
                         static_cast<const TQ*>(a.v_new), a.table, a.lengths,
                         static_cast<TQ*>(a.out), a.Hkv, a.ps, a.max_pages, a.st,
                         a.min_tiles);
  }
};

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

int run_decode(const DecodeArgs& a, int q_dtype, int rep, int Dh) {
  if (a.splits < 1 || a.splits > tiles::kMaxSplits || a.min_tiles < 1 || a.ps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = tiles::dispatch_int8<LaunchDecode>(a, q_dtype, rep, Dh);
  const int last = THAWK_LAUNCH_RESULT();  // also clears a failed launch's error
  return e != cudaSuccess ? static_cast<int>(e) : last;
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

// Kernel 10.  q, out [B, Hkv, rep, Dh] in q_dtype (q pre-scaled); k_pages,
// v_pages one layer's int8 codes and ks_pages, vs_pages its f32 scales;
// table [B, max_pages] and lengths [B] int32; strides in elements.  rep is
// 1, 2, 4 or 8 (checked by the wrapper).  splits 1 launches one block per
// (b, kv head); 2-16 the split form, in clusters of `splits` blocks, its
// ranges at least min_tiles tiles; one instance serves both.
extern "C" int th_paged_decode_int8(const void* q, const void* k_pages, const void* ks_pages,
                                    const void* v_pages, const void* vs_pages,
                                    const void* table, const void* lengths, void* out, int B,
                                    int Hkv, int rep, int Dh, int ps, int max_pages,
                                    long long page_stride, long long head_stride,
                                    long long spage_stride, long long shead_stride, int splits,
                                    int min_tiles, int q_dtype, void* stream) {
  // Attend only: without k_new the walk never writes the pools.
  const DecodeArgs a{q, const_cast<void*>(k_pages), const_cast<void*>(ks_pages),
                     const_cast<void*>(v_pages), const_cast<void*>(vs_pages), nullptr, nullptr,
                     static_cast<const int*>(table), static_cast<const int*>(lengths), out, B,
                     Hkv, ps, max_pages,
                     PoolStrides{page_stride, head_stride, spage_stride, shead_stride}, splits,
                     min_tiles, static_cast<cudaStream_t>(stream)};
  return run_decode(a, q_dtype, rep, Dh);
}

// Kernel 10 with kernel 11 folded in: as th_paged_decode_int8, and k_new,
// v_new [B, Hkv, Dh] in q_dtype, quantized and appended at row lengths[b]
// (the tokens already stored) of each sequence before it attends over
// lengths[b] + 1 rows; nothing is appended where the table has no row
// lengths[b].
extern "C" int th_paged_decode_int8_append(const void* q, void* k_pages, void* ks_pages,
                                           void* v_pages, void* vs_pages, const void* k_new,
                                           const void* v_new, const void* table,
                                           const void* lengths, void* out, int B, int Hkv,
                                           int rep, int Dh, int ps, int max_pages,
                                           long long page_stride, long long head_stride,
                                           long long spage_stride, long long shead_stride,
                                           int splits, int min_tiles, int q_dtype, void* stream) {
  if (k_new == nullptr || v_new == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q, k_pages, ks_pages, v_pages, vs_pages, k_new, v_new,
                     static_cast<const int*>(table), static_cast<const int*>(lengths), out, B,
                     Hkv, ps, max_pages,
                     PoolStrides{page_stride, head_stride, spage_stride, shead_stride}, splits,
                     min_tiles, static_cast<cudaStream_t>(stream)};
  return run_decode(a, q_dtype, rep, Dh);
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
