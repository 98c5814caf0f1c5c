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
// (_kernel_vec): attention of the rep query heads of each (sequence, kv
// head) over its min(lengths[b], max_pages * ps) live rows, read through
// its own page table, an f32 online softmax.  Bound by the bytes of the
// live K and V rows.  It runs kernel 3's shared-memory tile walk
// (decode_tiles.cuh) with rows addressed through the table: each 16-byte
// cp.async of a row reads table[b, t / ps] * page_stride + h * head_stride
// + (t % ps) * Dh, so a 64-row chunk may span pages (pages of fewer than 64
// rows, or not a multiple of 64).  One block a (sequence, kv head), or, where
// the wrapper asks for `splits` > 1, each pair's live rows cut on the card
// into ranges of at least min_tiles tiles over a thread-block cluster and
// merged on chip, as kernel 3's split form.  A row of length 0 writes zeros.
//
// Kernel 5 with kernel 6 folded in (th_paged_decode_append, the decode
// layer's one launch): lengths[b] counts the tokens already stored; the
// block whose range holds row lengths[b] writes the new K / V row there
// through the table, as kernel 3 writes its dense row, takes it into its
// tile in place of a copy, and the pair attends over lengths[b] + 1 rows.
// At the table's capacity (lengths[b] >= max_pages * ps) nothing is
// written and the pair attends over the max_pages * ps rows it has.  The
// same instances serve both entries: the append is chosen at run time by a
// k_new that is not null.
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
#include "decode_tiles.cuh"

using namespace thawk;

namespace {

// Kernel 5: block (split, b * Hkv + h) of a cluster of `splits` (SPLIT) or
// block b * Hkv + h runs the walk over the pair's live rows through the
// sequence's row of the table; with k_new (kernel 6 folded in) it first
// appends the pair's new row at lengths[b] where the table has room.
template <typename TQ, typename TC, int REP, int DH, bool SPLIT>
__global__ void __launch_bounds__(tiles::kThreads)
    paged_decode_tiles_kernel(const TQ* __restrict__ q, TC* kp, TC* vp,
                              const TQ* __restrict__ k_new, const TQ* __restrict__ v_new,
                              const int* __restrict__ table, const int* __restrict__ lengths,
                              TQ* __restrict__ out, int Hkv, int ps, int max_pages,
                              long long page_stride, long long head_stride, int min_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = SPLIT ? blockIdx.y : blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const size_t qo = static_cast<size_t>(bh) * REP * DH;
  const size_t ho = static_cast<size_t>(h) * head_stride;
  const int cap = max_pages * ps, n = lengths[b];
  const bool fold = k_new != nullptr;
  const bool app = fold && n >= 0 && n < cap;  // row n lies in the table
  const size_t no = static_cast<size_t>(bh) * DH;
  tiles::walk<TQ, TC, REP, DH, SPLIT ? tiles::kCluster : tiles::kOne, true>(
      smem, q + qo,
      tiles::PagedRows<TC, DH>{kp + ho, vp + ho, table + static_cast<size_t>(b) * max_pages, ps,
                               page_stride},
      app ? k_new + no : nullptr, app ? v_new + no : nullptr,
      max(0, min(fold ? n + 1 : n, cap)), SPLIT ? static_cast<int>(blockIdx.x) : 0,
      SPLIT ? static_cast<int>(gridDim.x) : 1, min_tiles, tiles::Normalised<TQ>{out + qo});
}

struct DecodeArgs {
  const void* q;
  void* kp;
  void* vp;
  const void* k_new;  // null: attend only
  const void* v_new;
  const int* table;
  const int* lengths;
  void* out;
  int B, Hkv, ps, max_pages;
  long long page_stride, head_stride;
  int splits, min_tiles;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int REP, int DH, bool SPLIT>
cudaError_t launch_decode(const DecodeArgs& a) {
  using A = tiles::Tiles<TC, REP, DH>;
  auto* fn = paged_decode_tiles_kernel<TQ, TC, REP, DH, SPLIT>;
  static const cudaError_t allowed = tiles::allow(fn, SPLIT ? A::kMaxBytes : A::kBytes, SPLIT);
  if (allowed != cudaSuccess) return allowed;
  const int cluster = SPLIT ? a.splits : 1;
  return tiles::launch(fn, SPLIT ? dim3(a.splits, a.B * a.Hkv) : dim3(a.B * a.Hkv), cluster,
                       tiles::smem_bytes<TC, REP, DH>(cluster), a.stream,
                       static_cast<const TQ*>(a.q), static_cast<TC*>(a.kp),
                       static_cast<TC*>(a.vp), static_cast<const TQ*>(a.k_new),
                       static_cast<const TQ*>(a.v_new), a.table, a.lengths,
                       static_cast<TQ*>(a.out), a.Hkv, a.ps, a.max_pages, a.page_stride,
                       a.head_stride, a.min_tiles);
}

// Kernel 5's launch at one instance.
template <typename TQ, typename TC, int REP, int DH>
struct LaunchDecode {
  static cudaError_t run(const DecodeArgs& a) {
    return a.splits > 1 ? launch_decode<TQ, TC, REP, DH, true>(a)
                        : launch_decode<TQ, TC, REP, DH, false>(a);
  }
};

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

static int run_decode(const DecodeArgs& a, int q_dtype, int pool_dtype, int rep, int Dh) {
  if (a.splits < 1 || a.splits > tiles::kMaxSplits || a.min_tiles < 1 || a.ps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = tiles::dispatch<LaunchDecode, true>(a, q_dtype, pool_dtype, rep, Dh);
  const int last = THAWK_LAUNCH_RESULT();  // also clears a failed launch's error
  return e != cudaSuccess ? static_cast<int>(e) : last;
}

// q, out [B, Hkv, rep, Dh] in q_dtype (q pre-scaled); k_pages, v_pages one
// layer's pools in pool_dtype (strides in elements); table [B, max_pages]
// and lengths [B] int32.  rep must be 1, 2, 4 or 8 and Dh 64 or 128
// (checked by the wrapper).  splits 1 launches one block per (b, kv head);
// 2-16 the split form, in clusters of `splits` blocks, its ranges at least
// min_tiles tiles.
extern "C" int th_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                               const void* table, const void* lengths, void* out, int B, int Hkv,
                               int rep, int Dh, int ps, int max_pages, long long page_stride,
                               long long head_stride, int splits, int min_tiles, int q_dtype,
                               int pool_dtype, void* stream) {
  // Attend only: without k_new the walk never writes the pools.
  const DecodeArgs a{q, const_cast<void*>(k_pages), const_cast<void*>(v_pages), nullptr,
                     nullptr, static_cast<const int*>(table), static_cast<const int*>(lengths),
                     out, B, Hkv, ps, max_pages, page_stride, head_stride, splits, min_tiles,
                     static_cast<cudaStream_t>(stream)};
  return run_decode(a, q_dtype, pool_dtype, rep, Dh);
}

// Kernel 5 with kernel 6 folded in: as th_paged_decode, and k_new, v_new
// [B, Hkv, Dh] in q_dtype, appended at row lengths[b] (the tokens already
// stored) of each sequence before it attends over lengths[b] + 1 rows;
// nothing is appended where the table has no row lengths[b].
extern "C" int th_paged_decode_append(const void* q, void* k_pages, void* v_pages,
                                      const void* k_new, const void* v_new, const void* table,
                                      const void* lengths, void* out, int B, int Hkv, int rep,
                                      int Dh, int ps, int max_pages, long long page_stride,
                                      long long head_stride, int splits, int min_tiles,
                                      int q_dtype, int pool_dtype, void* stream) {
  if (k_new == nullptr || v_new == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q, k_pages, v_pages, k_new, v_new, static_cast<const int*>(table),
                     static_cast<const int*>(lengths), out, B, Hkv, ps, max_pages, page_stride,
                     head_stride, splits, min_tiles, static_cast<cudaStream_t>(stream)};
  return run_decode(a, q_dtype, pool_dtype, rep, Dh);
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
