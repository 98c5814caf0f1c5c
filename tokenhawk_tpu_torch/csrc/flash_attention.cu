// Kernel 4: causal prefill flash attention against the cache.
//
// Replaces tokenhawk_tpu/ops/pallas/flash_attention.py flash_attention
// (_kernel), reached through attend_prefill.  q [B, Hkv, rep, T, Dh] is
// pre-scaled; the query at absolute position offsets[b] + t attends to
// cache slots 0 .. offsets[b] + t with an online softmax in f32.  Dh is
// 64 or 128.
//
// A block owns 8 consecutive queries of one (b, kv head, group member),
// one per warp.  It walks the keys in tiles of 32: all threads stage the
// tile's K and V rows in shared memory as f32 (row stride Dh + 4 floats,
// so the lanes' float4 reads of 32 different K rows fall in distinct
// banks), then each lane scores one key of the tile and, for P·V, owns
// Dh/32 of the head dims.  Tiles past the block's last query position
// are never loaded (diagonal skip); inside a tile, keys past a query's
// position are masked.  The work is O(T * L * Dh) on the CUDA cores; at
// prefill lengths it is small next to the projections, and tensor-core
// tiles are left to a later change.
#include "common.cuh"

using namespace thawk;

namespace {

constexpr int kQueries = 8;  // warps per block
constexpr int kKeys = 32;

template <typename TQ, typename TC, int DH>
__global__ void __launch_bounds__(kQueries * 32)
    prefill_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                   const TC* __restrict__ vc, const int* __restrict__ offsets,
                   TQ* __restrict__ out, int Hkv, int rep, int T, int S) {
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
  const int off = offsets[b];
  const size_t qbase = (static_cast<size_t>(bh) * rep + r) * T;  // row index of (b, h, r, 0)
  const TC* kh = kc + static_cast<size_t>(bh) * S * DH;
  const TC* vh = vc + static_cast<size_t>(bh) * S * DH;

  for (int i = tid; i < kQueries * DH; i += blockDim.x) {
    const int w = i / DH, d = i % DH;
    qsm[w][d] = t0 + w < T ? to_f32(q[(qbase + t0 + w) * DH + d]) : 0.f;
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
    const bool valid = key <= qpos && key < S;
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
  const float inv = l > 0.f ? 1.f / l : 1.f;
  TQ* o = out + (qbase + t) * DH + lane * kPer;
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = from_f32<TQ>(acc[i] * inv);
}

template <typename TQ, typename TC, int DH>
void launch_dh(const void* q, const void* kc, const void* vc, const int* offsets, void* out,
               int B, int Hkv, int rep, int T, int S, cudaStream_t stream) {
  const dim3 grid((T + kQueries - 1) / kQueries, rep, B * Hkv), block(kQueries * 32);
  prefill_kernel<TQ, TC, DH><<<grid, block, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc), static_cast<const TC*>(vc),
      offsets, static_cast<TQ*>(out), Hkv, rep, T, S);
}

template <typename TQ, typename TC>
void launch(const void* q, const void* kc, const void* vc, const int* offsets, void* out, int B,
            int Hkv, int rep, int Dh, int T, int S, cudaStream_t stream) {
  if (Dh == 64)
    launch_dh<TQ, TC, 64>(q, kc, vc, offsets, out, B, Hkv, rep, T, S, stream);
  else
    launch_dh<TQ, TC, 128>(q, kc, vc, offsets, out, B, Hkv, rep, T, S, stream);
}

}  // namespace

// q, out [B, Hkv, rep, T, Dh] in q_dtype; caches [B, Hkv, S, Dh] in
// cache_dtype; offsets [B] int32; Dh 64 or 128 (checked by the Python
// wrapper).
extern "C" int th_flash_prefill(const void* q, const void* kc, const void* vc,
                                const void* offsets, void* out, int B, int Hkv, int rep, int Dh,
                                int T, int S, int q_dtype, int cache_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, off, out, B, Hkv, rep, Dh, T, S, s);
  else if (q_dtype == kBF16)
    launch<__nv_bfloat16, float>(q, kc, vc, off, out, B, Hkv, rep, Dh, T, S, s);
  else if (cache_dtype == kBF16)
    launch<float, __nv_bfloat16>(q, kc, vc, off, out, B, Hkv, rep, Dh, T, S, s);
  else
    launch<float, float>(q, kc, vc, off, out, B, Hkv, rep, Dh, T, S, s);
  return THAWK_LAUNCH_RESULT();
}
