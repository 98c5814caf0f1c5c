// The decode-row walk of kernel 2 (both launches, csrc/ffn.cu th_ffn) and
// of kernel 13 at 1 to 8 rows (csrc/qmatmul.cu th_quant_matmul_stream):
//   y[b, n] = epilogue(sum_g s[n,g] * (sum_{k in g} xn[b,k] q[n,k])
//                      + sum_g m[n,g] * (sum_{k in g} xn[b,k])),
// xn = (x * inv_rms[b]) * gain when a gain is given, else x, over the
// weight layouts of gemv.cuh (q4_0, the group codes, super-blocks).
//
// It is bound by the weight bytes at one row (1.25 B a weight for Q4_K's
// group codes, 0.625 for Q4_0) and by the SM's instruction issue close
// behind them (a weight costs a code conversion and an FMA a row), so its
// design keeps the weight stream in flight and spends few instructions a
// weight:
//   - persistent blocks, one an SM, 16 warps each: warp gw of the launch's
//     W takes the column pairs ("tasks") gw, gw + W, ... (a gate/up pair
//     for kSwiGLU), so every SM works until the columns run out and a
//     block's fixed costs (x, the norm) are paid once;
//   - each warp streams its tasks' codes, scales and mins through its own
//     ring of `stages` stages in dynamic shared memory; a stage is 32 slots
//     (1024 inputs) of both columns, from pointers kept a task.  For the
//     group codes each span of a stage (a column's codes, scales, mins) is
//     one 1-D bulk copy of the tensor memory accelerator issued by lane 0
//     on the stage's mbarrier: per-lane 16-byte cp.async copies held them
//     near 2.0 TB/s, with or without the arithmetic, and bulk copies reach
//     3.0 (PERF.md).  The 4-bit forms' smaller spans (512 bytes of
//     codes, 128 or fewer of sides) go by the lanes' cp.async, which ran
//     them faster; so does any span whose address or size is not a
//     multiple of 16 bytes (in 8- or 4-byte copies).  The ring runs on
//     across tasks and segments: the warp issues its first stages - 1
//     stages before any other work, then waits on its own oldest stage (its
//     mbarrier's phase, cp.async.wait_group, a warp barrier), refills the
//     slot it computed last and computes.  No block barrier stands between
//     a stage's copy and its use;
//   - a lane converts its slot's 32 codes with a byte permute and a
//     subtract each (2^23 + code, exactly), and sums each group in one FMA
//     chain a column;
//   - x is staged once a block: the rows of one K segment, as f32, in
//     shared memory (a slot padded to 36 floats, so the lanes' 16-byte
//     reads take no bank conflicts), normalised on the way, and for the
//     forms with mins each group's input sum in its slot's pad;
//   - the norm runs inside the launch: each block sums its rows' squares
//     while the first stages are in flight;
//   - K is walked in `splits` segments where one segment of x would not fit
//     beside the rings (8 rows of a long K), each warp keeping its tasks'
//     running sums in shared memory from one segment to the next, in
//     order.  The host's rule (ops/cuda/qmatmul.py stream_plan) picks the
//     blocks, the segments and the ring's depth from the rows, K, N, the
//     form and the SM count.
// The arithmetic is the reference's at these rows (f32 FMAs, `_qdot` with
// DOT_F32 "auto" at 8 rows or fewer): each code converted exactly, each
// slot's group dot scaled once, the mins as m times the group's input sum,
// the super-block's s and m = 8s - dmin*mn rounded as SbReader rounds them.
// Lane l takes slot l of a stage for both of its columns and every row;
// each lane sums its slots, the warp its lanes (xor butterfly), the
// segments add in order.  Only that order differs from the reference's.
// No atomics: the order is fixed.
//
// The launches are built in their own translation units
// (gemv_stream_*.cu: kernel 13's store, kernel 2's gate/up and down, each
// in both types), so that their instances compile in parallel.
#pragma once

#include "gemv.cuh"
#include "mma.cuh"

namespace thawk {
namespace stream {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 2;          // output columns a task (a gate/up pair for kSwiGLU)
constexpr int kSlots = 32;        // slots a stage: one a lane
constexpr int kSlotFloats = 36;   // floats of a staged slot (32 + pad)
constexpr int kAlign = 8;         // slots a segment is a multiple of
constexpr int kMaxStages = 6;     // the deepest ring
constexpr int kRedBytes = 1024;   // the norm's sums
constexpr int kBarBytes = kWarps * kMaxStages * 8;  // the stages' mbarriers
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// A weight at the C boundary (form: gemv.cuh Form; hi: the sb form's scmn)
// and the host's plan of a launch.
struct Weights {
  const void* qs;
  const void* scales;
  const void* mins;
  const void* hi;
  int form;
};
struct Plan {
  int splits;  // K segments, walked in turn
  int stages;  // the ring's depth
  int blocks;  // persistent blocks
};

// The launches (gemv_stream_*.cu).  Each returns the launch's error, or an
// invalid value for a form, shape or plan the walk does not take.
//   matmul (kernel 13):  y[B, N] = xn @ W, the group-code forms;
//   gate_up (kernel 2):  h[B, F] = silu(xn @ W1) * (xn @ W3), w13 [D, 2F]
//                        in any form, the norm always given;
//   down (kernel 2):     y[B, D] = residual + h @ W2, any form but sb.
cudaError_t matmul(const __nv_bfloat16* x, int B, int K, const Weights& w, int N,
                   const __nv_bfloat16* gain, float eps, __nv_bfloat16* y, const Plan& p,
                   cudaStream_t stream);
cudaError_t matmul(const float* x, int B, int K, const Weights& w, int N, const float* gain,
                   float eps, float* y, const Plan& p, cudaStream_t stream);
cudaError_t gate_up(const __nv_bfloat16* x, int B, int D, const Weights& w, int F2,
                    const __nv_bfloat16* gain, float eps, float* h, const Plan& p,
                    cudaStream_t stream);
cudaError_t gate_up(const float* x, int B, int D, const Weights& w, int F2, const float* gain,
                    float eps, float* h, const Plan& p, cudaStream_t stream);
cudaError_t down(const float* h, int B, int F, const Weights& w, int D,
                 const __nv_bfloat16* residual, __nv_bfloat16* y, const Plan& p,
                 cudaStream_t stream);
cudaError_t down(const float* h, int B, int F, const Weights& w, int D, const float* residual,
                 float* y, const Plan& p, cudaStream_t stream);

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// The stages' mbarriers: one arrival (the issuing lane's, with the bytes
// its bulk copies bring) completes a phase once those bytes have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Orders this thread's (and, after a warp barrier, its warp's) shared
// memory reads before the bulk copies it issues next.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A 1-D bulk copy (the tensor memory accelerator) of n bytes, src, dst and n
// multiples of 16, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(n), "r"(smem_addr(bar))
      : "memory");
}

// n bytes (a multiple of 4) from src to dst (16-byte aligned).  With BULK,
// one bulk copy by lane 0 on bar where src and n are multiples of 16
// (returns n, the bytes bar must expect); else the lanes of the warp in the
// widest cp.async copies that src's alignment and n allow, one 16-byte
// copy a lane for the spans of 512 bytes or less that the cp.async forms
// take (returns 0).
template <bool BULK>
__device__ __forceinline__ int copy_span(unsigned char* dst, const void* src, int n, int lane,
                                         uint64_t* bar) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const unsigned a =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(s)) | static_cast<unsigned>(n);
  if (BULK && (a & 15u) == 0) {
    if (lane == 0 && n > 0) bulk_copy(dst, s, n, bar);
    return n;
  }
  if ((a & 15u) == 0) {
    if (lane * 16 < n) cp_async16(dst + lane * 16, s + lane * 16, true);
  } else if ((a & 7u) == 0) {
    for (int i = lane * 8; i < n; i += 256) cp_async8(dst + i, s + i);
  } else {
    for (int i = lane * 4; i < n; i += 128) cp_async4(dst + i, s + i, true);
  }
  return 0;
}

// Byte k of u (a value 0..255) as the float 2^23 + byte, exactly: the byte
// placed under 2^23's exponent bits.
__device__ __forceinline__ float biased_byte(uint32_t u, int k) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | k));
}

// The 32 values of a slot of 4-bit codes (q4_0, sb): q - 8 for the nibbles
// in unpack_nibbles's order (input 4i+b the low nibble of byte b of word i,
// input 16+4i+b its high nibble).
__device__ __forceinline__ void nibbles(uint4 raw, float (&w)[32]) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = words[i] & 0x0F0F0F0Fu, hi = (words[i] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      w[4 * i + b] = biased_byte(lo, b) - 8388616.0f;
      w[16 + 4 * i + b] = biased_byte(hi, b) - 8388616.0f;
    }
  }
}

// The forms' stages.  Cursor holds a column's stream pointers at a slot;
// issue() copies ns slots from it into buf (one column's part of a stage,
// kBytes; ops/cuda/qmatmul.py STREAM_STAGE_BYTES) and moves it on; read()
// gives lane l's slot: 32 code values, and the scales and mins of its kSub
// groups.

struct Q4Stream {  // codes 16 B a slot | scales
  static constexpr int kSub = 1;
  static constexpr bool kMins = false;
  static constexpr bool kBulk = false;
  static constexpr int kBytes = kSlots * 16 + kSlots * 4;
  const uint8_t* qs;
  const float* scales;
  struct Cursor {
    const uint8_t* q;
    const float* s;
  };

  __device__ __forceinline__ Cursor at(int col, int slot, int K) const {
    return {qs + static_cast<size_t>(col) * (K / 2) + slot * 16,
            scales + static_cast<size_t>(col) * (K / 32) + slot};
  }
  __device__ __forceinline__ int issue(unsigned char* buf, Cursor& c, int ns, int lane,
                                       uint64_t* bar) const {
    const int bytes = copy_span<kBulk>(buf, c.q, ns * 16, lane, bar) +
                      copy_span<kBulk>(buf + kSlots * 16, c.s, ns * 4, lane, bar);
    c.q += kSlots * 16;
    c.s += kSlots;
    return bytes;
  }
  __device__ __forceinline__ void read(const unsigned char* buf, int lane, float (&w)[32],
                                       float (&sc)[kSub], float (&mn)[kSub]) const {
    nibbles(reinterpret_cast<const uint4*>(buf)[lane], w);
    sc[0] = reinterpret_cast<const float*>(buf + kSlots * 16)[lane];
    mn[0] = 0.f;
  }
};

// Kernel 17's codes and expansion (SbReader's roundings): codes as q4_0's |
// the 6-bit sc bytes | the mn bytes | d | dmin (one each 8 slots).  A
// segment and a stage start at a multiple of 8 slots, so a stage's d are
// whole.
struct SbStream {
  static constexpr int kSub = 1;
  static constexpr bool kMins = true;
  static constexpr bool kBulk = false;
  static constexpr int kBytes = kSlots * 16 + 2 * kSlots + 2 * (kSlots / 8) * 4;
  const uint8_t* qs;
  const float* d;
  const float* dmin;
  const uint8_t* scmn;
  struct Cursor {
    const uint8_t* q;
    const uint8_t* h;  // sc; mn at h + mn
    const float* d;    // d; dmin at d + dm
    int mn;            // K/32
    long long dm;      // dmin - d, in floats
  };

  __device__ __forceinline__ Cursor at(int col, int slot, int K) const {
    return {qs + static_cast<size_t>(col) * (K / 2) + slot * 16,
            scmn + static_cast<size_t>(col) * (K / 16) + slot,
            d + static_cast<size_t>(col) * (K / 256) + slot / 8, K / 32, dmin - d};
  }
  __device__ __forceinline__ int issue(unsigned char* buf, Cursor& c, int ns, int lane,
                                       uint64_t* bar) const {
    const int bytes =
        copy_span<kBulk>(buf, c.q, ns * 16, lane, bar) +
        copy_span<kBulk>(buf + kSlots * 16, c.h, ns, lane, bar) +
        copy_span<kBulk>(buf + kSlots * 17, c.h + c.mn, ns, lane, bar) +
        copy_span<kBulk>(buf + kSlots * 18, c.d, ns / 8 * 4, lane, bar) +
        copy_span<kBulk>(buf + kSlots * 18 + kSlots / 2, c.d + c.dm, ns / 8 * 4, lane, bar);
    c.q += kSlots * 16;
    c.h += kSlots;
    c.d += kSlots / 8;
    return bytes;
  }
  __device__ __forceinline__ void read(const unsigned char* buf, int lane, float (&w)[32],
                                       float (&sc)[kSub], float (&mn)[kSub]) const {
    nibbles(reinterpret_cast<const uint4*>(buf)[lane], w);
    const float* dd = reinterpret_cast<const float*>(buf + kSlots * 18);
    const float s = __fmul_rn(dd[lane / 8], static_cast<float>(buf[kSlots * 16 + lane]));
    const float m =
        __fmul_rn(dd[kSlots / 8 + lane / 8], static_cast<float>(buf[kSlots * 17 + lane]));
    sc[0] = s;
    mn[0] = __fsub_rn(__fmul_rn(8.f, s), m);
  }
};

// Group codes: a slot's 32 int8 codes (one bulk copy a stage) | scales |
// mins.
template <int G, bool MINS>
struct QkStream {
  static constexpr int kSub = 32 / G;
  static constexpr bool kMins = MINS;
  static constexpr bool kBulk = true;
  static constexpr int kBytes = kSlots * 32 + kSlots * kSub * 4 * (MINS ? 2 : 1);
  const int8_t* qs;
  const float* scales;
  const float* mins;
  struct Cursor {
    const int8_t* q;
    const float* s;
    long long m;  // mins - scales, in floats
  };

  __device__ __forceinline__ Cursor at(int col, int slot, int K) const {
    return {qs + static_cast<size_t>(col) * K + slot * 32,
            scales + static_cast<size_t>(col) * (K / G) + slot * kSub, MINS ? mins - scales : 0};
  }
  __device__ __forceinline__ int issue(unsigned char* buf, Cursor& c, int ns, int lane,
                                       uint64_t* bar) const {
    int bytes = copy_span<kBulk>(buf, c.q, ns * 32, lane, bar) +
                copy_span<kBulk>(buf + kSlots * 32, c.s, ns * kSub * 4, lane, bar);
    if (MINS)
      bytes += copy_span<kBulk>(buf + kSlots * 32 + kSlots * kSub * 4, c.s + c.m,
                                ns * kSub * 4, lane, bar);
    c.q += kSlots * 32;
    c.s += kSlots * kSub;
    return bytes;
  }
  __device__ __forceinline__ void read(const unsigned char* buf, int lane, float (&w)[32],
                                       float (&sc)[kSub], float (&mn)[kSub]) const {
    const uint4* p = reinterpret_cast<const uint4*>(buf);
    const uint4 raw[2] = {p[2 * lane], p[2 * lane + 1]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // b ^ 0x80 is b + 128 as an unsigned byte (sbyte's offset).
      const uint32_t words[4] = {raw[h].x ^ 0x80808080u, raw[h].y ^ 0x80808080u,
                                 raw[h].z ^ 0x80808080u, raw[h].w ^ 0x80808080u};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < 4; ++b) w[16 * h + 4 * i + b] = biased_byte(words[i], b) - 8388736.0f;
    }
    const float* s = reinterpret_cast<const float*>(buf + kSlots * 32);
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      sc[j] = s[lane * kSub + j];
      mn[j] = MINS ? s[kSlots * kSub + lane * kSub + j] : 0.f;
    }
  }
};

// Slots of each K segment: ceil(slots / splits) rounded up to kAlign.
__host__ __device__ inline int segment_slots(int K, int splits) {
  const int slots = K / 32;
  const int per = (slots + splits - 1) / splits;
  return (per + kAlign - 1) / kAlign * kAlign;
}

// Tasks (column pairs) of a launch over N outputs, and the most a warp
// takes when `blocks` blocks share them.
__host__ __device__ inline int pair_tasks(int EPI, int N) {
  return EPI == kSwiGLU ? N / 2 : (N + 1) / 2;
}
__host__ __device__ inline int tasks_per_warp(int EPI, int N, int blocks) {
  const int W = blocks * kWarps;
  return (pair_tasks(EPI, N) + W - 1) / W;
}

// Dynamic shared memory of a block: one K segment of x's ROWS rows (f32,
// the mins forms' group sums in each slot's pad), the warps' rings, the
// norm's sums and, where K is walked in more than one segment, each warp's
// running sums of its tasks.
template <typename Form>
__host__ __device__ inline int smem_bytes(int EPI, int rows, int K, int N, const Plan& p) {
  return rows * segment_slots(K, p.splits) * kSlotFloats * 4 +
         kWarps * p.stages * kCols * Form::kBytes + kRedBytes + kBarBytes +
         (p.splits > 1 ? kWarps * tasks_per_warp(EPI, N, p.blocks) * kCols * rows * 4 : 0);
}

__device__ __forceinline__ void wait_stages(int stages) {  // all but the newest stages - 2
  switch (stages) {
    case 2: cp_async_wait<0>(); break;
    case 3: cp_async_wait<1>(); break;
    case 4: cp_async_wait<2>(); break;
    case 5: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// Persistent blocks, one an SM: warp gw of the launch's W takes the column
// pairs (tasks) gw, gw + W, ...; K is walked in `splits` segments, each
// staged into shared memory in turn (one at decode's one row).
//   kStore:    y[B, N]   = acc                       (task t: columns 2t, 2t+1)
//   kSwiGLU:   y[B, N/2] = silu(acc[:, f]) * acc[:, f + N/2]   (task f; TY = float)
//   kResidual: y[B, N]   = residual + acc
template <typename TX, typename TY, int ROWS, int EPI, typename Form, typename TG, typename TR>
__global__ void __launch_bounds__(kThreads, 1)
    stream_kernel(const TX* __restrict__ x, int B, int K, Form form, int N,
                  const TG* __restrict__ gain, float eps, const TR* __restrict__ residual,
                  TY* __restrict__ y, int splits, int stages) {
  constexpr int SUB = Form::kSub;
  constexpr int F4_PER_SUB = 8 / SUB;  // float4s of one group
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = stages;
  const int slots = K / 32;
  const int seg = segment_slots(K, splits);
  const int xstride = seg * kSlotFloats;  // floats of a staged row
  const int P = pair_tasks(EPI, N);
  const int W = gridDim.x * kWarps;
  const int gw = blockIdx.x * kWarps + warp;
  const int n_tasks = gw < P ? (P - 1 - gw) / W + 1 : 0;
  const int tmax = tasks_per_warp(EPI, N, gridDim.x);
  float* xs = reinterpret_cast<float*>(smem);  // a slot: 32 inputs, its group sums
  unsigned char* rings = smem + ROWS * seg * kSlotFloats * 4;
  unsigned char* ring = rings + warp * R * kCols * Form::kBytes;
  float* red = reinterpret_cast<float*>(rings + kWarps * R * kCols * Form::kBytes);
  float* inv = red + kWarps * ROWS;  // [ROWS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(red) +
                                               kRedBytes) + warp * kMaxStages;  // this warp's
  float* sums = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(red) + kRedBytes +
                                         kBarBytes) +
                warp * tmax * kCols * ROWS;  // this warp's [tmax][kCols][ROWS]
  if (Form::kBulk && lane == 0) {
    for (int k = 0; k < R; ++k) mbar_init(bars + k);
    mbar_init_fence();
  }
  __syncwarp();

  auto columns = [&](int i, int (&col)[kCols], bool (&live)[kCols]) {
    const int t = gw + i * W;
    if (EPI == kSwiGLU) {
      col[0] = t;          // gate column of w13
      col[1] = t + N / 2;  // matching up column
      live[0] = live[1] = true;
    } else {
      col[0] = 2 * t;
      col[1] = 2 * t + 1;
      live[0] = true;
      live[1] = col[1] < N;
    }
  };
  // The load cursor: segment ls, task li, the next slot ln of the segment;
  // the columns' stream pointers at it.
  int ls = 0, li = 0, ln = 0;
  int lcol[kCols];
  bool llive[kCols];
  typename Form::Cursor cur[kCols];
  auto start_task = [&]() {
    columns(li, lcol, llive);
#pragma unroll
    for (int c = 0; c < kCols; ++c) cur[c] = form.at(llive[c] ? lcol[c] : 0, ls * seg, K);
  };
  if (n_tasks > 0) start_task();
  auto issue_next = [&](int slot) {
    if (ls >= splits || n_tasks == 0) return;
    const int len = min(slots, (ls + 1) * seg) - ls * seg;
    const int ns = min(kSlots, len - ln);
    unsigned char* st = ring + slot * kCols * Form::kBytes;
    int bytes = 0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (llive[c]) bytes += form.issue(st + c * Form::kBytes, cur[c], ns, lane, bars + slot);
    if (Form::kBulk && lane == 0) mbar_expect(bars + slot, bytes);
    ln += kSlots;
    if (ln >= len) {
      ln = 0;
      if (++li == n_tasks) {
        li = 0;
        ++ls;
      }
      if (ls < splits) start_task();
    }
  };
  for (int k = 0; k < R - 1; ++k) {
    issue_next(k);
    cp_async_commit();
  }

  // The norm's row statistics over all of K, while the first stages fly.
  if (gain != nullptr) {
    float ssq[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      ssq[r] = 0.f;
      if (r < B)
        for (int i = threadIdx.x; i < K / 4; i += kThreads) {
          const float4 v = load4(x + static_cast<size_t>(r) * K + i * 4);
          ssq[r] += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
        }
      ssq[r] = warp_sum(ssq[r]);
      if (lane == 0) red[warp * ROWS + r] = ssq[r];
    }
    __syncthreads();
    if (threadIdx.x < ROWS) {
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += red[w * ROWS + threadIdx.x];
      inv[threadIdx.x] = rsqrtf(total / K + eps);
    }
  }

  int use = 0;         // the ring slot of the next stage to compute
  uint32_t phase = 0;  // its mbarrier's phase
  for (int s = 0; s < splits; ++s) {
    const int lo = s * seg, hi = min(slots, lo + seg);
    __syncthreads();  // the last segment's x is consumed (and inv is written)
    // The segment of every row into shared memory (zeros past B), normalised
    // as (x * inv) * gain.
    const int n4 = (hi - lo) * 8;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float sr = gain != nullptr ? inv[r] : 1.f;
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const int k = lo * 32 + i * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < B) {
          v = load4(x + static_cast<size_t>(r) * K + k);
          if (gain != nullptr) {
            const float4 g = load4(gain + k);
            v.x = (v.x * sr) * g.x;
            v.y = (v.y * sr) * g.y;
            v.z = (v.z * sr) * g.z;
            v.w = (v.w * sr) * g.w;
          }
        }
        *reinterpret_cast<float4*>(xs + r * xstride + (i >> 3) * kSlotFloats + (i & 7) * 4) = v;
      }
    }
    if (Form::kMins) {  // each group's input sum, once a block (the mins' dot)
      __syncthreads();
      for (int i = threadIdx.x; i < ROWS * (hi - lo) * SUB; i += kThreads) {
        const int r = i / ((hi - lo) * SUB), g = i % ((hi - lo) * SUB);
        float* slot = xs + r * xstride + (g / SUB) * kSlotFloats;
        const float4* xv = reinterpret_cast<const float4*>(slot + (g % SUB) * (32 / SUB));
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < F4_PER_SUB; ++q) sum += (xv[q].x + xv[q].y) + (xv[q].z + xv[q].w);
        slot[32 + g % SUB] = sum;
      }
    }
    __syncthreads();  // x staged

    const int n_chunks = (hi - lo + kSlots - 1) / kSlots;
    for (int i = 0; i < n_tasks; ++i) {
      int col[kCols];
      bool live[kCols];
      columns(i, col, live);
      float acc[kCols][ROWS];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;
      for (int ch = 0; ch < n_chunks; ++ch) {
        wait_stages(R);  // this lane's cp.async copies of the oldest stage
        if (Form::kBulk) mbar_wait(bars + use, phase);  // its bulk copies
        __syncwarp();  // every lane's copies; the slot computed last is free
        if (Form::kBulk && lane == 0) fence_async_shared();
        issue_next(use == 0 ? R - 1 : use - 1);
        cp_async_commit();
        const unsigned char* st = ring + use * kCols * Form::kBytes;
        if (++use == R) {
          use = 0;
          phase ^= 1;
        }
        if (lane >= hi - lo - ch * kSlots) continue;  // a ragged last stage
        float w[kCols][32];
        float sc[kCols][SUB], mn[kCols][SUB];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          form.read(st + c * Form::kBytes, lane, w[c], sc[c], mn[c]);
          if (!live[c])
#pragma unroll
            for (int j = 0; j < SUB; ++j) sc[c][j] = mn[c][j] = 0.f;
        }
        const float* xl = xs + (ch * kSlots + lane) * kSlotFloats;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4* xr = reinterpret_cast<const float4*>(xl + r * xstride);
          float part[kCols][SUB], xsum[SUB];
#pragma unroll
          for (int j = 0; j < SUB; ++j) {
            xsum[j] = Form::kMins ? xl[r * xstride + 32 + j] : 0.f;
#pragma unroll
            for (int c = 0; c < kCols; ++c) part[c][j] = 0.f;
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int j = q / F4_PER_SUB;
            const float4 xv = xr[q];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              part[c][j] = fmaf(xv.x, w[c][4 * q], part[c][j]);
              part[c][j] = fmaf(xv.y, w[c][4 * q + 1], part[c][j]);
              part[c][j] = fmaf(xv.z, w[c][4 * q + 2], part[c][j]);
              part[c][j] = fmaf(xv.w, w[c][4 * q + 3], part[c][j]);
            }
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int j = 0; j < SUB; ++j) {
              acc[c][r] = fmaf(sc[c][j], part[c][j], acc[c][r]);
              if (Form::kMins) acc[c][r] = fmaf(mn[c][j], xsum[j], acc[c][r]);
            }
        }
      }
      // The task's sums (every lane holds them after the butterfly); lane r
      // keeps row r: summed over the segments in order, then the epilogue.
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float v[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          v[c] = warp_sum(acc[c][r]);
          if (splits > 1 && lane == r) {
            float* at = sums + (i * kCols + c) * ROWS + r;
            if (s > 0) v[c] += *at;
            *at = v[c];
          }
        }
        if (lane != r || r >= B || s + 1 < splits) continue;
        if (EPI == kSwiGLU) {
          y[static_cast<size_t>(r) * (N / 2) + col[0]] =
              from_f32<TY>(v[0] / (1.f + expf(-v[0])) * v[1]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            if (!live[c]) continue;
            const size_t o = static_cast<size_t>(r) * N + col[c];
            float out = v[c];
            if (EPI == kResidual) out += to_f32(residual[o]);
            y[o] = from_f32<TY>(out);
          }
        }
      }
    }
  }
}

// Host side: the row tile, the shared memory and the launch of the plan's
// blocks.
template <typename TX, typename TY, int EPI, typename TG, typename TR, int ROWS, typename Form>
cudaError_t launch_rows(const TX* x, int B, int K, const Form& form, int N, const TG* gain,
                        float eps, const TR* residual, TY* y, const Plan& p,
                        cudaStream_t stream) {
  auto* fn = stream_kernel<TX, TY, ROWS, EPI, Form, TG, TR>;
  const int smem = smem_bytes<Form>(EPI, ROWS, K, N, p);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static const cudaError_t allowed =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (allowed != cudaSuccess) return allowed;
  fn<<<p.blocks, kThreads, smem, stream>>>(x, B, K, form, N, gain, eps, residual, y, p.splits,
                                           p.stages);
  return cudaSuccess;
}

template <typename TX, typename TY, int EPI, typename TG, typename TR, typename Form>
cudaError_t launch(const TX* x, int B, int K, const Form& form, int N, const TG* gain, float eps,
                   const TR* residual, TY* y, const Plan& p, cudaStream_t stream) {
  if (B < 1 || B > 8 || K % 32 != 0 || N < 1 || (EPI == kSwiGLU && N % 2 != 0) ||
      p.splits < 1 || (p.splits - 1) * segment_slots(K, p.splits) >= K / 32 || p.stages < 2 ||
      p.stages > kMaxStages || p.blocks < 1)
    return cudaErrorInvalidValue;
  if (B == 1)
    return launch_rows<TX, TY, EPI, TG, TR, 1>(x, B, K, form, N, gain, eps, residual, y, p,
                                               stream);
  if (B == 2)
    return launch_rows<TX, TY, EPI, TG, TR, 2>(x, B, K, form, N, gain, eps, residual, y, p,
                                               stream);
  if (B <= 4)
    return launch_rows<TX, TY, EPI, TG, TR, 4>(x, B, K, form, N, gain, eps, residual, y, p,
                                               stream);
  return launch_rows<TX, TY, EPI, TG, TR, 8>(x, B, K, form, N, gain, eps, residual, y, p,
                                             stream);
}

// Calls f(form) with the stream form of w (gemv.cuh Form) and returns its
// result; an invalid value for an unknown form, for kFormQ4 unless Q4 and
// for kFormSb unless SB (kernel 13 takes neither on this walk, kernel 2's
// w2 no sb).
template <bool Q4, bool SB, typename Fn>
cudaError_t with_form(const Weights& w, Fn&& f) {
  const float* s = static_cast<const float*>(w.scales);
  const float* m = static_cast<const float*>(w.mins);
  const int8_t* q8 = static_cast<const int8_t*>(w.qs);
  const uint8_t* q4 = static_cast<const uint8_t*>(w.qs);
  switch (w.form) {
    case kFormQ4:
      if constexpr (Q4) return f(Q4Stream{q4, s});
      return cudaErrorInvalidValue;
    case kFormSb:
      if constexpr (SB) return f(SbStream{q4, s, m, static_cast<const uint8_t*>(w.hi)});
      return cudaErrorInvalidValue;
    case kFormG32:
      return f(QkStream<32, false>{q8, s, nullptr});
    case kFormG32Mins:
      return f(QkStream<32, true>{q8, s, m});
    case kFormG16:
      return f(QkStream<16, false>{q8, s, nullptr});
    case kFormG16Mins:
      return f(QkStream<16, true>{q8, s, m});
    default:
      return cudaErrorInvalidValue;
  }
}

// The bodies of the launches declared above; each gemv_stream_*.cu file
// defines one overload with them.
template <typename T>
cudaError_t matmul_of(const T* x, int B, int K, const Weights& w, int N, const T* gain, float eps,
                      T* y, const Plan& p, cudaStream_t stream) {
  return with_form<false, false>(w, [&](const auto& f) {
    return launch<T, T, kStore, T, float>(x, B, K, f, N, gain, eps, nullptr, y, p, stream);
  });
}

template <typename T>
cudaError_t gate_up_of(const T* x, int B, int D, const Weights& w, int F2, const T* gain,
                       float eps, float* h, const Plan& p, cudaStream_t stream) {
  return with_form<true, true>(w, [&](const auto& f) {
    return launch<T, float, kSwiGLU, T, float>(x, B, D, f, F2, gain, eps, nullptr, h, p, stream);
  });
}

template <typename T>
cudaError_t down_of(const float* h, int B, int F, const Weights& w, int D, const T* residual,
                    T* y, const Plan& p, cudaStream_t stream) {
  return with_form<true, false>(w, [&](const auto& f) {
    return launch<float, T, kResidual, float, T>(h, B, F, f, D, nullptr, 0.f, residual, y, p,
                                                 stream);
  });
}

}  // namespace stream
}  // namespace thawk
