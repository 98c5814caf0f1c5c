// Kernels 8 and 9: attention over the dense int8 KV cache.
//
// The cache holds int8 codes [B, Hkv, S, Dh] and one bfloat16 scale per
// (sequence, head, token) [B, Hkv, S] for K and for V (kv_int8.cuh has the
// codec); Dh is 64 or 128.  Both kernels compute exact attention over the
// dequantized cache, code x scale in f32, with an online softmax in f32.
// (The TPU decode kernel also quantizes the query and the probabilities to
// int8 to feed its matrix unit; the port does not.)
//
// Kernel 8, decode, replaces tokenhawk_tpu/ops/pallas/flash_decode_int8.py
// flash_decode_int8 (_kernel) together with the update_kv_cache_int8 before
// it: for each (b, kv head) it quantizes the new K and V rows and writes
// them at slot lengths[b]-1, then attends the rep query heads of that kv
// head over min(lengths[b], S) tokens; a row of length 0 writes zeros and
// appends nothing.  Bound by the bytes of the live codes and scales,
// 2*L*(Dh + 2) bytes a head: about half of kernel 3's.  It runs kernel 3's
// shared-memory tile walk (decode_tiles.cuh) over int8 rows: each block's
// codes come into a ring of 128-row chunks by 16-byte cp.async, the chunk's
// bfloat16 scales in 16-byte pieces in the same commit group, and each code
// is widened to f32 times its row's scale where the scores and P·V use it;
// where B*Hkv is below the SM count each pair's live rows are cut over a
// thread-block cluster (kernel 3's ranges, cut on the card from lengths)
// and merged on chip.  The block whose range holds row L-1 quantizes the
// new rows (a warp each for K and V), writes them to the cache and puts
// the same codes and rounded scales into its own tile.
//
// Kernel 9, prefill, replaces
// tokenhawk_tpu/ops/pallas/flash_attention_int8.py flash_attention_int8
// (_kernel), reached through attend_prefill_int8.  With bf16 q (every int8
// prefill of the port) th_flash_attention_int8_tc runs kernel 4's tensor-core
// walk (prefill_tc.cuh) over int8 tiles: the codes come by cp.async at one
// byte each, widen to bf16 in shared memory, the K scale multiplies the
// scores and the V scale P, as the reference folds them.  The products' flops
// bound it as they bound kernel 4, so both run on the tensor cores.  With f32
// q th_flash_attention_int8 runs the CUDA-core walk below; it keeps kernel
// 4's f32 structure: a block owns 8 consecutive queries of one (b, kv head,
// group member), stages each tile of 32 keys dequantized to f32 in shared
// memory, skips tiles past its last query and masks keys past each query's
// position.  Any T >= 1 (the TPU kernel needs T % 8 == 0).
#include "decode_tiles.cuh"
#include "kv_int8.cuh"
#include "prefill_tc.cuh"

using namespace thawk;

namespace {

constexpr int kQueries = 8;  // kernel 9: warps per block, one query each
constexpr int kKeys = 32;

// Kernel 8: block (split, b * Hkv + h) of a cluster of `splits` blocks
// (one block a pair where splits is 1: its range holds every row, so the
// cluster form takes kOne's path) runs the walk over the pair's
// min(lengths[b], S) rows (none for a length of 0), quantizing and
// appending the new row first.
template <typename TQ, typename TC, int REP, int DH>
__global__ void __launch_bounds__(tiles::kThreads)
    decode_int8_tiles_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                             const TQ* __restrict__ v_new, TC* kc, __nv_bfloat16* ksc, TC* vc,
                             __nv_bfloat16* vsc, const int* __restrict__ lengths,
                             TQ* __restrict__ out, int Hkv, int S, int min_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.y;
  const size_t qo = static_cast<size_t>(bh) * REP * DH;
  const size_t co = static_cast<size_t>(bh) * S * DH;
  const size_t so = static_cast<size_t>(bh) * S;
  tiles::walk<TQ, TC, REP, DH, tiles::kCluster, true>(
      smem, q + qo, tiles::DenseRows8<DH>{kc + co, vc + co, ksc + so, vsc + so},
      k_new + static_cast<size_t>(bh) * DH, v_new + static_cast<size_t>(bh) * DH,
      max(0, min(lengths[bh / Hkv], S)), blockIdx.x, gridDim.x, min_tiles,
      tiles::Normalised<TQ>{out + qo});
}

struct DecodeArgs {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* kc;
  void* ksc;
  void* vc;
  void* vsc;
  const int* lengths;
  void* out;
  int B, Hkv, S;
  int splits, min_tiles;
  cudaStream_t stream;
};

// Kernel 8's launch at one instance: splits x (B * Hkv) blocks in clusters
// of `splits`, the shared memory allowed once.
template <typename TQ, typename TC, int REP, int DH>
struct LaunchDecode {
  static cudaError_t run(const DecodeArgs& a) {
    using A = tiles::Tiles<TC, REP, DH>;
    auto* fn = decode_int8_tiles_kernel<TQ, TC, REP, DH>;
    static const cudaError_t allowed = tiles::allow(fn, A::kMaxBytes, true);
    if (allowed != cudaSuccess) return allowed;
    return tiles::launch(fn, dim3(a.splits, a.B * a.Hkv), a.splits,
                         tiles::smem_bytes<TC, REP, DH>(a.splits), a.stream,
                         static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.k_new),
                         static_cast<const TQ*>(a.v_new), static_cast<TC*>(a.kc),
                         static_cast<__nv_bfloat16*>(a.ksc), static_cast<TC*>(a.vc),
                         static_cast<__nv_bfloat16*>(a.vsc), a.lengths,
                         static_cast<TQ*>(a.out), a.Hkv, a.S, a.min_tiles);
  }
};

template <typename TQ, int kDh>
__global__ void __launch_bounds__(kQueries * 32)
    prefill_int8_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ ksc, const int8_t* __restrict__ vc,
                        const __nv_bfloat16* __restrict__ vsc, const int* __restrict__ offsets,
                        TQ* __restrict__ out, int Hkv, int rep, int T, int S) {
  constexpr int kRow = kDh + 4;
  constexpr int kPer = kDh / 32;  // head dims a lane owns for P·V
  __shared__ __align__(16) float ks[kKeys][kRow];
  __shared__ __align__(16) float vs[kKeys][kRow];
  __shared__ __align__(16) float qsm[kQueries][kDh];

  const int bh = blockIdx.z;
  const int b = bh / Hkv;
  const int r = blockIdx.y;
  const int t0 = blockIdx.x * kQueries;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = offsets[b];
  const size_t qbase = (static_cast<size_t>(bh) * rep + r) * T;  // row index of (b, h, r, 0)
  const int8_t* kh = kc + static_cast<size_t>(bh) * S * kDh;
  const int8_t* vh = vc + static_cast<size_t>(bh) * S * kDh;
  const __nv_bfloat16* ksh = ksc + static_cast<size_t>(bh) * S;
  const __nv_bfloat16* vsh = vsc + static_cast<size_t>(bh) * S;

  for (int i = tid; i < kQueries * kDh; i += blockDim.x) {
    const int w = i / kDh, d = i % kDh;
    qsm[w][d] = t0 + w < T ? to_f32(q[(qbase + t0 + w) * kDh + d]) : 0.f;
  }

  const int t = t0 + warp;
  const bool active = t < T;
  const int qpos = off + t;
  const int last = min(off + min(t0 + kQueries, T) - 1, S - 1);  // block's last key
  const int n_tiles = last / kKeys + 1;

  float m = -INFINITY, l = 0.f;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // previous tile consumed (and q staged, on the first)
    for (int i = tid; i < kKeys * (kDh / 8); i += blockDim.x) {
      const int j = i / (kDh / 8), c = (i % (kDh / 8)) * 8;
      const int key = tile * kKeys + j;
      float kv[8], vv[8];
      if (key < S) {
        const uint2 kr = *reinterpret_cast<const uint2*>(kh + static_cast<size_t>(key) * kDh + c);
        const uint2 vr = *reinterpret_cast<const uint2*>(vh + static_cast<size_t>(key) * kDh + c);
        unpack4(kr.x, kv);
        unpack4(kr.y, kv + 4);
        unpack4(vr.x, vv);
        unpack4(vr.y, vv + 4);
        const float k_scale = to_f32(ksh[key]), v_scale = to_f32(vsh[key]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          kv[e] *= k_scale;
          vv[e] *= v_scale;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = vv[e] = 0.f;
      }
      *reinterpret_cast<float4*>(&ks[j][c]) = make_float4(kv[0], kv[1], kv[2], kv[3]);
      *reinterpret_cast<float4*>(&ks[j][c + 4]) = make_float4(kv[4], kv[5], kv[6], kv[7]);
      *reinterpret_cast<float4*>(&vs[j][c]) = make_float4(vv[0], vv[1], vv[2], vv[3]);
      *reinterpret_cast<float4*>(&vs[j][c + 4]) = make_float4(vv[4], vv[5], vv[6], vv[7]);
    }
    __syncthreads();
    if (!active) continue;

    const int key = tile * kKeys + lane;
    const bool valid = key <= qpos && key < S;
    const float4* kr = reinterpret_cast<const float4*>(&ks[lane][0]);
    const float4* qr = reinterpret_cast<const float4*>(&qsm[warp][0]);
    float s = 0.f;
#pragma unroll 8
    for (int i = 0; i < kDh / 4; ++i) {
      const float4 a = qr[i], k4 = kr[i];
      s += a.x * k4.x + a.y * k4.y + a.z * k4.z + a.w * k4.w;
    }
    s = valid ? s : -INFINITY;
    const float tmax = warp_max(s);
    if (tmax == -INFINITY) continue;  // whole tile past this query
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
#pragma unroll 8
    for (int j = 0; j < kKeys; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      float v[kPer];
      load_n<kPer>(&vs[j][lane * kPer], v);
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += pj * v[i];
    }
  }
  if (!active) return;
  const float inv = l > 0.f ? 1.f / l : 1.f;
  TQ* o = out + (qbase + t) * kDh + lane * kPer;
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = from_f32<TQ>(acc[i] * inv);
}

template <typename TQ, int kDh>
void launch_prefill(const void* q, const void* kc, const void* ksc, const void* vc,
                    const void* vsc, const int* offsets, void* out, int B, int Hkv, int rep,
                    int T, int S, cudaStream_t stream) {
  const dim3 grid((T + kQueries - 1) / kQueries, rep, B * Hkv), block(kQueries * 32);
  prefill_int8_kernel<TQ, kDh><<<grid, block, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(kc),
      static_cast<const __nv_bfloat16*>(ksc), static_cast<const int8_t*>(vc),
      static_cast<const __nv_bfloat16*>(vsc), offsets, static_cast<TQ*>(out), Hkv, rep, T, S);
}

}  // namespace

// Kernel 8.  q, out [B, Hkv, rep, Dh] and k_new, v_new [B, Hkv, Dh] in
// q_dtype (q pre-scaled); kc, vc int8 [B, Hkv, S, Dh] and ksc, vsc bfloat16
// [B, Hkv, S], written in place; lengths [B] int32.  rep is 1, 2, 4 or 8
// and Dh 64 or 128 (checked by the Python wrapper).  splits 1 launches one
// block per (b, kv head); 2-16 the split form, in clusters of `splits`
// blocks, its ranges at least min_tiles tiles (kernel 3's ranges); one
// instance serves both.
extern "C" int th_flash_decode_int8(const void* q, const void* k_new, const void* v_new,
                                    void* kc, void* ksc, void* vc, void* vsc,
                                    const void* lengths, void* out, int B, int Hkv, int rep,
                                    int Dh, int S, int splits, int min_tiles, int q_dtype,
                                    void* stream) {
  if (splits < 1 || splits > tiles::kMaxSplits || min_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q, k_new, v_new, kc, ksc, vc, vsc, static_cast<const int*>(lengths), out,
                     B, Hkv, S, splits, min_tiles, static_cast<cudaStream_t>(stream)};
  const cudaError_t e = tiles::dispatch_int8<LaunchDecode>(a, q_dtype, rep, Dh);
  const int last = THAWK_LAUNCH_RESULT();  // also clears a failed launch's error
  return e != cudaSuccess ? static_cast<int>(e) : last;
}

// The CUDA-core walk: q, out [B, Hkv, rep, T, Dh] f32 (q pre-scaled;
// bf16 q is th_flash_attention_int8_tc's); the int8 cache as above;
// offsets [B] int32.
extern "C" int th_flash_attention_int8(const void* q, const void* kc, const void* ksc,
                                       const void* vc, const void* vsc, const void* offsets,
                                       void* out, int B, int Hkv, int rep, int Dh, int T, int S,
                                       int q_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (q_dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  if (Dh == 64)
    launch_prefill<float, 64>(q, kc, ksc, vc, vsc, off, out, B, Hkv, rep, T, S, s);
  else
    launch_prefill<float, 128>(q, kc, ksc, vc, vsc, off, out, B, Hkv, rep, T, S, s);
  return THAWK_LAUNCH_RESULT();
}

// The tensor-core walk (prefill_tc.cuh): q, out [B, Hkv, rep, T, Dh] bf16 (q
// pre-scaled); the int8 cache as above; offsets [B] int32.
extern "C" int th_flash_attention_int8_tc(const void* q, const void* kc, const void* ksc,
                                          const void* vc, const void* vsc, const void* offsets,
                                          void* out, int B, int Hkv, int rep, int Dh, int T,
                                          int S, void* stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* k = static_cast<const int8_t*>(kc);
  const auto* v = static_cast<const int8_t*>(vc);
  const auto* ks = static_cast<const __nv_bfloat16*>(ksc);
  const auto* vs = static_cast<const __nv_bfloat16*>(vsc);
  const auto* off = static_cast<const int*>(offsets);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      Dh == 64 ? prefill_tc::launch<64>(qb, prefill_tc::Int8Cache<64>{k, v, ks, vs}, off, ob, B,
                                        Hkv, rep, T, S, s)
               : prefill_tc::launch<128>(qb, prefill_tc::Int8Cache<128>{k, v, ks, vs}, off, ob,
                                         B, Hkv, rep, T, S, s);
  return e != cudaSuccess ? static_cast<int>(e) : THAWK_LAUNCH_RESULT();
}
