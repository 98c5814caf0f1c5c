// Kernel 4: causal prefill flash attention against the cache, and kernel
// 19: kernel 4's walks returning softmax partials for context parallelism.
//
// Kernel 4 replaces tokenhawk_tpu/ops/pallas/flash_attention.py
// flash_attention (_kernel), reached through attend_prefill.  q [B, Hkv,
// rep, T, Dh] is pre-scaled; the query at absolute position offsets[b] + t
// attends to cache slots 0 .. offsets[b] + t with an online softmax in f32.
// Dh is 64 or 128.
//
// Kernel 19 replaces flash_attention.py flash_attention_stats
// (_kernel_stats), the ring-attention step of parallel/ring.py: q (f32,
// pre-scaled) is one shard's query block and K / V a visiting KV block,
// at affine positions q_start[b] + stride*t and k_start[b] + stride*j
// (stride 1 for contiguous blocks, the shard count for the cyclic layout),
// under the causal mask kpos <= qpos.  It writes the unnormalised o in
// f32 and the row's max m and sum l; a row that sees no key of the block
// gets (0, _MASK, 0), _MASK = -0.7 * FLT_MAX being finite so that two
// such partials merge without NaN and vanish against any real one.  The
// TPU kernel's fully masked rows inside a partly visible tile collect
// exp(_MASK - _MASK) = 1 per slot instead; both merge to the same result.
// With bf16 K/V blocks (every CP prefill of the port: the cache's type),
// th_flash_attention_stats_tc runs the tensor-core walk of prefill_tc.cuh
// in its STATS form: q and P each split into two bf16 parts, so both
// products run on the tensor cores and the partials keep about 2^-16 of
// f32 (its header).  With f32 K/V it runs the CUDA-core walk below
// (th_flash_attention_stats).  The dtype picks the walk.
//
// Two walks, two entry points; the Python wrapper picks one by dtype.  With
// bf16 q and a bf16 cache, th_flash_prefill_tc runs the tensor-core walk of
// prefill_tc.cuh: both products through mma.sync, the rep query heads of a KV
// head packed into 64-row tiles, K/V tiles of 64 keys by cp.async (its header
// says what bounds it and why).  That is every bf16 prefill, verify, chunked
// admission and eval window of the port.
//
// With f32 q or an f32 cache (the float32 witnesses and tiny f32 models),
// th_flash_prefill runs the CUDA-core walk below, as kernel 19 does over f32 K/V: a
// block owns 8 consecutive queries of one (b, kv head, group member), one per
// warp.  It walks the keys in tiles of 32: all threads stage the tile's K and
// V rows in shared memory as f32 (row stride Dh + 4 floats, so the lanes'
// float4 reads of 32 different K rows fall in distinct banks), then each lane
// scores one key of the tile and, for P·V, owns Dh/32 of the head dims.  Tiles
// past the block's last query position are never loaded (diagonal skip);
// inside a tile, keys past a query's position are masked.  Its f32 FMAs bound
// it: at T=512 with 7B heads 2.15 GFLOP, 0.032 ms at the f32 peak; it keeps
// f32 operands exact where the tensor cores would round them.
#include "common.cuh"
#include "prefill_tc.cuh"

using namespace thawk;

namespace {

constexpr int kQueries = 8;  // warps per block
constexpr int kKeys = 32;
// parallel/ring.py _MASK, rounded to f32 as the Python float is.
constexpr float kMask = static_cast<float>(-0.7 * 3.4028234663852886e38);

// Query t sits at q_starts[b] + stride*t and key j at k_starts[b] +
// stride*j (kernel 4: q_starts = offsets, no k_starts, stride 1).  STATS
// (kernel 19, TQ = float) writes the unnormalised o and m_out, l_out
// [B, Hkv, rep, T]; otherwise out = o / l in TQ.
template <typename TQ, typename TC, int DH, bool STATS>
__global__ void __launch_bounds__(kQueries * 32)
    prefill_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                   const TC* __restrict__ vc, const int* __restrict__ q_starts,
                   const int* __restrict__ k_starts, int stride, TQ* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out, int Hkv, int rep, int T,
                   int S) {
  constexpr int kRow = DH + 4;
  constexpr int kPer = DH / 32;  // head dims a lane owns for P·V
  __shared__ __align__(16) float ks[kKeys][kRow];
  __shared__ __align__(16) float vs[kKeys][kRow];
  __shared__ __align__(16) float qsm[kQueries][DH];

  const int bh = blockIdx.z;
  const int b = bh / Hkv;
  const int r = blockIdx.y;
  const int t0 = blockIdx.x * kQueries;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = q_starts[b];
  const int k0 = k_starts == nullptr ? 0 : k_starts[b];
  const size_t qbase = (static_cast<size_t>(bh) * rep + r) * T;  // row index of (b, h, r, 0)
  const TC* kh = kc + static_cast<size_t>(bh) * S * DH;
  const TC* vh = vc + static_cast<size_t>(bh) * S * DH;

  for (int i = tid; i < kQueries * DH; i += blockDim.x) {
    const int w = i / DH, d = i % DH;
    qsm[w][d] = t0 + w < T ? to_f32(q[(qbase + t0 + w) * DH + d]) : 0.f;
  }

  const int t = t0 + warp;
  const bool active = t < T;
  const int qpos = q0 + stride * t;
  const int last_q = q0 + stride * (min(t0 + kQueries, T) - 1);  // block's last query position
  // The block's last visible key (none when its last query precedes the first key).
  const int n_tiles = last_q < k0 ? 0 : min((last_q - k0) / stride, S - 1) / kKeys + 1;

  float m = -INFINITY, l = 0.f;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // previous tile consumed (and q staged, on the first)
    for (int i = tid; i < kKeys * (DH / 8); i += blockDim.x) {
      const int j = i / (DH / 8), c = (i % (DH / 8)) * 8;
      const int key = tile * kKeys + j;
      float kv[8], vv[8];
      if (key < S) {
        load8(kh + static_cast<size_t>(key) * DH + c, kv);
        load8(vh + static_cast<size_t>(key) * DH + c, vv);
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
    const bool valid = k0 + stride * key <= qpos && key < S;
    const float4* kr = reinterpret_cast<const float4*>(&ks[lane][0]);
    const float4* qr = reinterpret_cast<const float4*>(&qsm[warp][0]);
    float s = 0.f;
#pragma unroll 8
    for (int i = 0; i < DH / 4; ++i) {
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
  TQ* o = out + (qbase + t) * DH + lane * kPer;
  if constexpr (STATS) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[i] = acc[i];  // 0 where no key was seen
    if (lane == 0) {
      m_out[qbase + t] = m == -INFINITY ? kMask : m;
      l_out[qbase + t] = l;
    }
  } else {
    const float inv = l > 0.f ? 1.f / l : 1.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[i] = from_f32<TQ>(acc[i] * inv);
  }
}

struct Args {
  const void* q;
  const void* kc;
  const void* vc;
  const int* q_starts;
  const int* k_starts;  // null for kernel 4
  int stride;
  void* out;
  float* m;  // null for kernel 4
  float* l;
  int B, Hkv, rep, T, S;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int DH, bool STATS>
void launch_dh(const Args& a) {
  const dim3 grid((a.T + kQueries - 1) / kQueries, a.rep, a.B * a.Hkv), block(kQueries * 32);
  prefill_kernel<TQ, TC, DH, STATS><<<grid, block, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.kc), static_cast<const TC*>(a.vc),
      a.q_starts, a.k_starts, a.stride, static_cast<TQ*>(a.out), a.m, a.l, a.Hkv, a.rep, a.T,
      a.S);
}

template <typename TQ, typename TC, bool STATS = false>
void launch(const Args& a, int Dh) {
  if (Dh == 64)
    launch_dh<TQ, TC, 64, STATS>(a);
  else
    launch_dh<TQ, TC, 128, STATS>(a);
}

}  // namespace

// The CUDA-core walk: q, out [B, Hkv, rep, T, Dh] in q_dtype; caches [B,
// Hkv, S, Dh] in cache_dtype, not both bf16 (that pair is
// th_flash_prefill_tc's); offsets [B] int32; Dh 64 or 128 (checked by the
// Python wrapper).
extern "C" int th_flash_prefill(const void* q, const void* kc, const void* vc,
                                const void* offsets, void* out, int B, int Hkv, int rep, int Dh,
                                int T, int S, int q_dtype, int cache_dtype, void* stream) {
  const Args a{q, kc, vc, static_cast<const int*>(offsets), nullptr, 1, out, nullptr, nullptr,
               B, Hkv, rep, T, S, static_cast<cudaStream_t>(stream)};
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == kBF16)
    launch<__nv_bfloat16, float>(a, Dh);
  else if (cache_dtype == kBF16)
    launch<float, __nv_bfloat16>(a, Dh);
  else
    launch<float, float>(a, Dh);
  return THAWK_LAUNCH_RESULT();
}

// The tensor-core walk (prefill_tc.cuh): q, out [B, Hkv, rep, T, Dh] and
// caches [B, Hkv, S, Dh] all bf16; offsets [B] int32; Dh 64 or 128.
extern "C" int th_flash_prefill_tc(const void* q, const void* kc, const void* vc,
                                   const void* offsets, void* out, int B, int Hkv, int rep,
                                   int Dh, int T, int S, void* stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(kc);
  const auto* vb = static_cast<const __nv_bfloat16*>(vc);
  const auto* off = static_cast<const int*>(offsets);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      Dh == 64 ? prefill_tc::launch<64>(qb, prefill_tc::Bf16Cache<64>{kb, vb}, off, ob, B, Hkv,
                                        rep, T, S, s)
               : prefill_tc::launch<128>(qb, prefill_tc::Bf16Cache<128>{kb, vb}, off, ob, B,
                                         Hkv, rep, T, S, s);
  return e != cudaSuccess ? static_cast<int>(e) : THAWK_LAUNCH_RESULT();
}

// Kernel 19's CUDA-core walk.  q, o [B, Hkv, rep, T, Dh] f32 (q
// pre-scaled); K / V blocks [B, Hkv, S, Dh] f32 (bf16 blocks are
// th_flash_attention_stats_tc's); q_starts, k_starts [B] int32; stride >=
// 1; m, l [B, Hkv, rep, T] f32; Dh 64 or 128 (checked by the Python
// wrapper).
extern "C" int th_flash_attention_stats(const void* q, const void* kc, const void* vc,
                                        const void* q_starts, const void* k_starts, int stride,
                                        void* o, void* m, void* l, int B, int Hkv, int rep,
                                        int Dh, int T, int S, int cache_dtype, void* stream) {
  if (cache_dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kc, vc, static_cast<const int*>(q_starts), static_cast<const int*>(k_starts),
               stride, o, static_cast<float*>(m), static_cast<float*>(l), B, Hkv, rep, T, S,
               static_cast<cudaStream_t>(stream)};
  launch<float, float, true>(a, Dh);
  return THAWK_LAUNCH_RESULT();
}

// Kernel 19's tensor-core walk (prefill_tc.cuh, STATS): as above with bf16
// K / V blocks.
extern "C" int th_flash_attention_stats_tc(const void* q, const void* kc, const void* vc,
                                           const void* q_starts, const void* k_starts,
                                           int stride, void* o, void* m, void* l, int B, int Hkv,
                                           int rep, int Dh, int T, int S, void* stream) {
  if (stride < 1) return static_cast<int>(cudaErrorInvalidValue);
  const prefill_tc::Io<true> io{static_cast<const float*>(q), static_cast<const int*>(q_starts),
                                static_cast<const int*>(k_starts), stride,
                                static_cast<float*>(o), static_cast<float*>(m),
                                static_cast<float*>(l)};
  const auto* kb = static_cast<const __nv_bfloat16*>(kc);
  const auto* vb = static_cast<const __nv_bfloat16*>(vc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      Dh == 64 ? prefill_tc::launch_io<64>(io, prefill_tc::Bf16Cache<64>{kb, vb}, B, Hkv, rep, T,
                                           S, s)
               : prefill_tc::launch_io<128>(io, prefill_tc::Bf16Cache<128>{kb, vb}, B, Hkv, rep,
                                            T, S, s);
  return e != cudaSuccess ? static_cast<int>(e) : THAWK_LAUNCH_RESULT();
}
