// Kernels 8 and 9: attention over the dense int8 KV cache.
//
// The cache holds int8 codes [B, Hkv, S, Dh] and one bfloat16 scale per
// (sequence, head, token) [B, Hkv, S] for K and for V (kv_int8.cuh has the
// codec); Dh is 64 or 128.  Both kernels compute exact attention over the dequantized cache,
// code x scale in f32, with an online softmax in f32.  (The TPU decode
// kernel also quantizes the query and the probabilities to int8 to feed its
// matrix unit; the port does not.)
//
// Kernel 8, decode, replaces tokenhawk_tpu/ops/pallas/flash_decode_int8.py
// flash_decode_int8 (_kernel) together with the update_kv_cache_int8 before
// it: for each (b, kv head) it quantizes the new K and V rows and writes
// them at slot lengths[b]-1, then attends the rep query heads of that kv
// head over lengths[b] tokens; a row of length 0 writes zeros and appends
// nothing.  One block per (b, kv head), as kernel 3: the block that writes a
// head's row reads it after a barrier.  The 8 warps split the live tokens in
// tiles of 32; a lane scores one token (its Dh codes in 16-byte loads,
// times the token's K scale), then owns Dh/32 head dims for P·V with the
// probability times the token's V scale.  Bound by the bytes of the live
// codes and scales, (2*L*Dh + 2*L*2) bytes per head: half of kernel 3's.
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
#include "kv_int8.cuh"
#include "prefill_tc.cuh"

using namespace thawk;

namespace {

constexpr int kWarps = 8;
constexpr int kQueries = 8;  // kernel 9: warps per block, one query each
constexpr int kKeys = 32;

template <typename TQ, int REP, int kDh>
__global__ void __launch_bounds__(kWarps * 32)
    decode_int8_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                       const TQ* __restrict__ v_new, int8_t* kc, __nv_bfloat16* ksc,
                       int8_t* vc, __nv_bfloat16* vsc, const int* __restrict__ lengths,
                       TQ* __restrict__ out, int Hkv, int S) {
  constexpr int kPer = kDh / 32;  // head dims a lane owns
  __shared__ __align__(16) float qsm[REP][kDh];
  __shared__ float red_m[kWarps][REP];
  __shared__ float red_l[kWarps][REP];
  __shared__ __align__(16) float red_acc[kWarps][REP][kDh];

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = min(lengths[b], S);
  TQ* o = out + static_cast<size_t>(bh) * REP * kDh;
  if (L <= 0) {
    for (int i = tid; i < REP * kDh; i += blockDim.x) o[i] = from_f32<TQ>(0.f);
    return;
  }
  int8_t* kh = kc + static_cast<size_t>(bh) * S * kDh;
  int8_t* vh = vc + static_cast<size_t>(bh) * S * kDh;
  __nv_bfloat16* ksh = ksc + static_cast<size_t>(bh) * S;
  __nv_bfloat16* vsh = vsc + static_cast<size_t>(bh) * S;

  if (warp < 2) {  // warp 0 appends the K row, warp 1 the V row
    const TQ* src = (warp == 0 ? k_new : v_new) + static_cast<size_t>(bh) * kDh + lane * kPer;
    float x[kPer];
    load_n<kPer>(src, x);
    signed char codes[kPer];
    const float scale = quantize_row<kPer>(x, codes);
    int8_t* dst = (warp == 0 ? kh : vh) + static_cast<size_t>(L - 1) * kDh + lane * kPer;
#pragma unroll
    for (int i = 0; i < kPer; ++i) dst[i] = codes[i];
    if (lane == 0) (warp == 0 ? ksh : vsh)[L - 1] = __float2bfloat16_rn(scale);
  }
  for (int i = tid; i < REP * kDh; i += blockDim.x)
    qsm[i / kDh][i % kDh] = to_f32(q[static_cast<size_t>(bh) * REP * kDh + i]);
  __syncthreads();  // the appended rows are visible to the whole block

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
      const int8_t* krow = kh + static_cast<size_t>(tok) * kDh;
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
      const float k_scale = to_f32(ksh[tok]);
#pragma unroll
      for (int r = 0; r < REP; ++r) s[r] *= k_scale;
      v_scale = to_f32(vsh[tok]);
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
      load_codes<kPer>(vh + static_cast<size_t>(t * 32 + j) * kDh + lane * kPer, v);
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
void launch_decode(const void* q, const void* k_new, const void* v_new, void* kc, void* ksc,
                   void* vc, void* vsc, const int* lengths, void* out, int B, int Hkv, int rep,
                   int S, cudaStream_t stream) {
  const dim3 grid(B * Hkv), block(kWarps * 32);
  const TQ* qt = static_cast<const TQ*>(q);
  const TQ* kn = static_cast<const TQ*>(k_new);
  const TQ* vn = static_cast<const TQ*>(v_new);
  int8_t* kq = static_cast<int8_t*>(kc);
  int8_t* vq = static_cast<int8_t*>(vc);
  __nv_bfloat16* ks = static_cast<__nv_bfloat16*>(ksc);
  __nv_bfloat16* vs = static_cast<__nv_bfloat16*>(vsc);
  TQ* o = static_cast<TQ*>(out);
#define THAWK_DECODE8(R) \
  decode_int8_kernel<TQ, R, kDh><<<grid, block, 0, stream>>>(qt, kn, vn, kq, ks, vq, vs, lengths, o, Hkv, S)
  switch (rep) {
    case 1: THAWK_DECODE8(1); break;
    case 2: THAWK_DECODE8(2); break;
    case 4: THAWK_DECODE8(4); break;
    default: THAWK_DECODE8(8); break;
  }
#undef THAWK_DECODE8
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

// q, out [B, Hkv, rep, Dh] and k_new, v_new [B, Hkv, Dh] in q_dtype (q
// pre-scaled); kc, vc int8 [B, Hkv, S, Dh] and ksc, vsc bfloat16 [B, Hkv, S],
// written in place; lengths [B] int32.  rep is 1, 2, 4 or 8 and Dh 64 or 128
// (checked by the Python wrapper).
extern "C" int th_flash_decode_int8(const void* q, const void* k_new, const void* v_new,
                                    void* kc, void* ksc, void* vc, void* vsc,
                                    const void* lengths, void* out, int B, int Hkv, int rep,
                                    int Dh, int S, int q_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
#define THAWK_DECODE8(TQ, DH) \
  launch_decode<TQ, DH>(q, k_new, v_new, kc, ksc, vc, vsc, len, out, B, Hkv, rep, S, s)
  if (q_dtype == kBF16) {
    if (Dh == 64) THAWK_DECODE8(__nv_bfloat16, 64); else THAWK_DECODE8(__nv_bfloat16, 128);
  } else {
    if (Dh == 64) THAWK_DECODE8(float, 64); else THAWK_DECODE8(float, 128);
  }
#undef THAWK_DECODE8
  return THAWK_LAUNCH_RESULT();
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
