// Kernel 3: decode append + attend over the dense bf16 KV cache.
//
// Replaces tokenhawk_tpu/ops/pallas/flash_decode_dma.py
// flash_decode_append_walk (_kernel_walk_append) and its grid form
// flash_decode_append (_kernel_vec_append).  For each (b, kv head) it
// writes k_new / v_new at slot lengths[b]-1 in place, then attends the
// rep query heads of that kv head over lengths[b] tokens with an online
// softmax in f32.  q is pre-scaled by 1/sqrt(Dh).
//
// One block per (b, kv head): the block that writes a head's row is the
// block that reads it, and __syncthreads() orders the write before every
// read of the block (the cache is read with plain loads, never through
// the non-coherent read-only path).  The 8 warps split the live tokens in
// tiles of 32; a lane scores one token of a tile against every query head
// of the group, then owns 4 of the 128 head dims for P·V.  The warps'
// (max, sum, acc) states merge through shared memory at the end.  Only
// the live tiles are read: the kernel is bound by the cache bytes of the
// live tokens, 2*L*Dh*2 bytes per head.
#include "common.cuh"

using namespace thawk;

namespace {

constexpr int kDh = 128;
constexpr int kWarps = 8;

template <typename TQ, typename TC, int REP>
__global__ void __launch_bounds__(kWarps * 32)
    decode_append_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                         const TQ* __restrict__ v_new, TC* kc, TC* vc,
                         const int* __restrict__ lengths, TQ* __restrict__ out, int Hkv, int S) {
  __shared__ __align__(16) float qsm[REP][kDh];
  __shared__ float red_m[kWarps][REP];
  __shared__ float red_l[kWarps][REP];
  __shared__ __align__(16) float red_acc[kWarps][REP][kDh];

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = max(1, min(lengths[b], S));
  TC* kh = kc + static_cast<size_t>(bh) * S * kDh;
  TC* vh = vc + static_cast<size_t>(bh) * S * kDh;

  if (tid < kDh) {
    const size_t src = static_cast<size_t>(bh) * kDh + tid;
    const size_t dst = static_cast<size_t>(L - 1) * kDh + tid;
    kh[dst] = from_f32<TC>(to_f32(k_new[src]));
    vh[dst] = from_f32<TC>(to_f32(v_new[src]));
  }
  for (int i = tid; i < REP * kDh; i += blockDim.x)
    qsm[i / kDh][i % kDh] = to_f32(q[static_cast<size_t>(bh) * REP * kDh + i]);
  __syncthreads();  // the appended row is visible to the whole block

  float m[REP], l[REP], acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }

  const int n_tiles = (L + 31) / 32;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int tok = t * 32 + lane;
    const bool valid = tok < L;
    float s[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) s[r] = 0.f;
    if (valid) {
      const TC* krow = kh + static_cast<size_t>(tok) * kDh;
#pragma unroll 4
      for (int i = 0; i < kDh; i += 8) {
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
      for (int i = 0; i < 4; ++i) acc[r][i] *= alpha;
    }
    const int n_live = min(32, L - t * 32);
    for (int j = 0; j < n_live; ++j) {
      const float4 v = load4(vh + static_cast<size_t>(t * 32 + j) * kDh + lane * 4);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
        acc[r][0] += pj * v.x;
        acc[r][1] += pj * v.y;
        acc[r][2] += pj * v.z;
        acc[r][3] += pj * v.w;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      red_m[warp][r] = m[r];
      red_l[warp][r] = l[r];
    }
    *reinterpret_cast<float4*>(&red_acc[warp][r][lane * 4]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
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
    out[static_cast<size_t>(bh) * REP * kDh + i] = from_f32<TQ>(num / den);
  }
}

template <typename TQ, typename TC>
void launch(const void* q, const void* k_new, const void* v_new, void* kc, void* vc,
            const int* lengths, void* out, int B, int Hkv, int rep, int S, cudaStream_t stream) {
  const dim3 grid(B * Hkv), block(kWarps * 32);
  const TQ* qt = static_cast<const TQ*>(q);
  const TQ* kn = static_cast<const TQ*>(k_new);
  const TQ* vn = static_cast<const TQ*>(v_new);
  TC* kt = static_cast<TC*>(kc);
  TC* vt = static_cast<TC*>(vc);
  TQ* o = static_cast<TQ*>(out);
  switch (rep) {
    case 1:
      decode_append_kernel<TQ, TC, 1><<<grid, block, 0, stream>>>(qt, kn, vn, kt, vt, lengths, o, Hkv, S);
      break;
    case 2:
      decode_append_kernel<TQ, TC, 2><<<grid, block, 0, stream>>>(qt, kn, vn, kt, vt, lengths, o, Hkv, S);
      break;
    case 4:
      decode_append_kernel<TQ, TC, 4><<<grid, block, 0, stream>>>(qt, kn, vn, kt, vt, lengths, o, Hkv, S);
      break;
    default:
      decode_append_kernel<TQ, TC, 8><<<grid, block, 0, stream>>>(qt, kn, vn, kt, vt, lengths, o, Hkv, S);
      break;
  }
}

}  // namespace

// q, out [B, Hkv, rep, 128] and k_new, v_new [B, Hkv, 128] in q_dtype;
// caches [B, Hkv, S, 128] in cache_dtype, updated in place; lengths [B]
// int32.  rep must be 1, 2, 4 or 8 (checked by the Python wrapper).
extern "C" int th_decode_append(const void* q, const void* k_new, const void* v_new, void* kc,
                                void* vc, const void* lengths, void* out, int B, int Hkv, int rep,
                                int S, int q_dtype, int cache_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (q_dtype == kBF16 && cache_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(q, k_new, v_new, kc, vc, len, out, B, Hkv, rep, S, s);
  else if (q_dtype == kBF16)
    launch<__nv_bfloat16, float>(q, k_new, v_new, kc, vc, len, out, B, Hkv, rep, S, s);
  else if (cache_dtype == kBF16)
    launch<float, __nv_bfloat16>(q, k_new, v_new, kc, vc, len, out, B, Hkv, rep, S, s);
  else
    launch<float, float>(q, k_new, v_new, kc, vc, len, out, B, Hkv, rep, S, s);
  return THAWK_LAUNCH_RESULT();
}
