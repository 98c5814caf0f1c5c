// The decode-row walk of kernels 1, 13 and 17 at 1 to 8 rows (csrc/qmatmul.cu
// th_quant_matmul_stream), of kernel 2 (both launches, csrc/ffn.cu th_ffn),
// of kernel 15 (its three launches, csrc/ffn.cu th_owo_ffn) and of kernel
// 16's Wo (csrc/attn_wo.cu th_attn_wo):
//   y[b, n] = epilogue(sum_g s[n,g] * (sum_{k in g} xn[b,k] q[n,k])
//                      + sum_g m[n,g] * (sum_{k in g} xn[b,k])),
// xn = (x * inv_rms[b]) * gain when a gain is given, else x, over the
// weight layouts of gemv.cuh (q4_0, the group codes, super-blocks).
//
// It is bound by the weight bytes at one row (0.625 B a weight for Q4_0,
// 0.59 for the super-blocks, 1.25 for Q4_K's group codes) and by the SM's
// instruction issue close behind them (a weight costs a code conversion
// and an FMA a row), and a launch's fixed cost is several microseconds of
// a 10-30 us call, so its design keeps the weight stream in flight from
// the launch's first cycle to its last and spends few instructions a
// weight:
//   - persistent blocks, one an SM, 16 warps each; the warps form groups
//     of `parts` (1, 2 or 4) consecutive warps, group g of the launch's G
//     takes the column pairs ("tasks") g, g + G, ... (a gate/up pair for
//     kSwiGLU) and its warp h walks part h of each pair's K, the parts'
//     sums added in order through shared memory (a named barrier a
//     group).  The host's rule splits a pair's K only where whole pairs
//     would leave a last wave: the most tasks a warp takes stays within
//     1.1x the mean (3072 pairs over 2112 warps took 2 where the mean was
//     1.45);
//   - each warp streams its tasks' codes, scales and mins through its own
//     ring of `stages` stages in dynamic shared memory, from pointers kept
//     a task; a stage is 32 slots (1024 inputs) of both columns for the
//     group codes and 64 for the 4-bit forms, and each of its spans (a
//     column's codes, scales, mins; the super-blocks' sc, mn, d, dmin) is
//     one 1-D bulk copy of the tensor memory accelerator issued by lane 0
//     on the stage's mbarrier (per-lane cp.async copies held the streams
//     near 2.0 TB/s, bulk copies reach 3.0; the 4-bit forms' 64-slot
//     stages make their codes 1 KB spans); a span whose address or size
//     is not a multiple of 16 bytes goes by the lanes' cp.async.  The
//     warp issues the ring's first two stages before it reads x (the
//     residual and SwiGLU launches the whole ring), the rest once x is
//     staged, then waits on its oldest stage (its mbarrier's phase,
//     cp.async.wait_group, a warp barrier), takes its slots into
//     registers, refills the stage at once and computes.  The ring runs on
//     across tasks and segments, and no block barrier stands between a
//     stage's copy and its use;
//   - a launch is a programmatic dependent of the kernel before it on the
//     stream where the host's plan says so (Plan::dependent: a
//     cudaLaunchKernelEx attribute, no instance of its own), which the
//     callers set only where that kernel is the same call's own launch and
//     writes none of this launch's weights: kernel 2's down launch, kernel
//     15's gate/up and down launches, kernel 16's Wo.  Its blocks start,
//     and issue their first stages of weights, while the launch before's
//     last blocks run; griddepcontrol.wait stands before the first read of
//     x, the gain and the residual and the first write of y.  Every launch
//     triggers its dependents once its first stages are issued.  The other
//     launches (kernels 1, 13 and 17, kernel 2's gate/up, kernel 15's Wo)
//     are ordinary ones, which find the kernel before them finished;
//   - a lane converts its slot's codes four at a time (a byte permute and
//     a subtract each: 2^23 + code, exactly) and sums each group in one
//     FMA chain a column and row;
//   - x is staged once a block and read once: the rows of one K segment,
//     as f32, in shared memory (a slot padded to 36 floats, so the lanes'
//     16-byte reads take no bank conflicts), every row's loads in flight
//     at once; the norm's sums of squares come from the staged values,
//     which are then normalised in place, and for the forms with mins each
//     group's input sum goes into its slot's pad;
//   - K is walked in `splits` segments where one segment of x would not fit
//     beside the rings (8 rows of a long K), each warp keeping its tasks'
//     running sums in shared memory from one segment to the next, in
//     order; the norm's statistics are then summed first from global
//     memory.  The host's rule (ops/cuda/qmatmul.py stream_plan) picks the
//     blocks, the segments, the ring's depth and the parts from the rows,
//     K, N, the form and the SM count.
// The arithmetic is the reference's at these rows (f32 FMAs, `_qdot` with
// DOT_F32 "auto" at 8 rows or fewer): each code converted exactly, each
// slot's group dot scaled once, the mins as m times the group's input sum,
// the super-block's s and m = 8s - dmin*mn rounded as SbReader rounds them.
// Lane l takes slots l, l + 32, ... of its task's K for both columns and
// every row; each lane sums its slots, the warp its lanes (xor butterfly),
// the segments or the parts add in order.  Only that order differs from
// the reference's.  No atomics: the order is fixed.
//
// The launches are built in their own translation units
// (gemv_stream_*.cu: kernels 1, 13 and 17's store, kernel 2's gate/up and
// down, each in both types, and the three bfloat16 launches of kernel 15
// whose types kernel 2's lack), so that their instances compile in
// parallel.
#pragma once

#include "gemv.cuh"
#include "mma.cuh"

namespace thawk {
namespace stream {

// A launch's epilogue (stream_kernel).
enum Epilogue { kStore = 0, kSwiGLU = 1, kResidual = 2 };

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 2;          // output columns a task (a gate/up pair for kSwiGLU)
constexpr int kSlots = 32;        // slots a lane's pass over a stage: one a lane
constexpr int kNibbleStage = 64;  // slots a stage of the 4-bit forms: two a lane
constexpr int kSlotFloats = 36;   // floats of a staged slot (32 + pad)
constexpr int kAlign = 8;         // slots a segment is a multiple of
constexpr int kMaxStages = 6;     // the deepest ring
constexpr int kRedBytes = 2048;   // the norm's sums, then the parts' exchange
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
  int parts;   // warps a pair's K is split over (1, 2 or 4; one segment only)
  bool dependent = false;  // a programmatic dependent of the kernel before it
};

// The launches (gemv_stream_*.cu).  Each returns the launch's error, or an
// invalid value for a form, shape or plan the walk does not take.
//   matmul (kernels 1, 13, 17):  y[B, N] = xn @ W, every form;
//   gate_up (kernels 2, 15):     h[B, F] = silu(xn @ W1) * (xn @ W3), w13
//                                [D, 2F], the norm always given: x and the
//                                gain in one type in any form (kernel 2,
//                                and kernel 15 at float32), or f32 x' with
//                                a bfloat16 gain in the forms without mins
//                                but sb (kernel 15 at bfloat16);
//   down (kernels 2, 15, 16):    y[B, N] = residual + x @ W: f32 x with a
//                                residual and y in one type, any form but
//                                sb (kernel 2's down, kernel 16's Wo and
//                                kernel 15's three launches at float32);
//                                bfloat16 x and residual into f32 y, the
//                                forms without mins but sb (kernel 15's Wo
//                                at bfloat16); f32 x and residual into
//                                bfloat16 y, any form but sb (kernel 15's
//                                down at bfloat16).
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
cudaError_t gate_up(const float* x, int B, int D, const Weights& w, int F2,
                    const __nv_bfloat16* gain, float eps, float* h, const Plan& p,
                    cudaStream_t stream);
cudaError_t down(const float* x, int B, int K, const Weights& w, int N,
                 const __nv_bfloat16* residual, __nv_bfloat16* y, const Plan& p,
                 cudaStream_t stream);
cudaError_t down(const float* x, int B, int K, const Weights& w, int N, const float* residual,
                 float* y, const Plan& p, cudaStream_t stream);
cudaError_t down(const __nv_bfloat16* x, int B, int K, const Weights& w, int N,
                 const __nv_bfloat16* residual, float* y, const Plan& p, cudaStream_t stream);
cudaError_t down(const float* x, int B, int K, const Weights& w, int N, const float* residual,
                 __nv_bfloat16* y, const Plan& p, cudaStream_t stream);

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

// n bytes (a multiple of 4) from src to dst (16-byte aligned): one bulk
// copy by lane 0 on bar where src and n are multiples of 16 (returns n, the
// bytes bar must expect); else the lanes of the warp in the widest cp.async
// copies that src's alignment and n allow (returns 0).
__device__ __forceinline__ int copy_span(unsigned char* dst, const void* src, int n, int lane,
                                         uint64_t* bar) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const unsigned a =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(s)) | static_cast<unsigned>(n);
  if ((a & 15u) == 0) {
    if (lane == 0 && n > 0) bulk_copy(dst, s, n, bar);
    return n;
  }
  if ((a & 7u) == 0) {
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

// Codes 4q..4q+3 of a slot of 4-bit codes (q4_0, sb) as q - 8, in
// unpack_nibbles's order: input 4i+b is the low nibble of byte b of word i,
// input 16+4i+b its high nibble.
__device__ __forceinline__ void nibbles4(uint4 raw, int q, float (&w)[4]) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  const uint32_t word = words[q & 3];
  const uint32_t u = (q < 4 ? word : word >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int b = 0; b < 4; ++b) w[b] = biased_byte(u, b) - 8388616.0f;
}

// A byte value 0..255 as a float, exactly (the byte under 2^23's exponent
// bits, then 2^23 off).
__device__ __forceinline__ float byte_value(uint32_t b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.0f;
}

// The forms' stages.  Cursor holds a column's stream pointers at a slot;
// issue() copies ns slots (at most kStage) from it into buf (one column's
// part of a stage, kBytes; ops/cuda/qmatmul.py STREAM_STAGE_BYTES) and
// moves it on by kStage; load() takes slot u * 32 + lane of the stage into
// registers (Raw), so that the stage can be refilled at once; sides() gives
// the scales and mins of the slot's kSub groups, codes() its code values
// 4q..4q+3 (converted four at a time, so that few are live at once).
// Every span of a stage goes by one 1-D bulk copy where its address and
// size are multiples of 16 bytes: the 4-bit forms' stages of 64 slots give
// spans of 1 KB of codes, 256 bytes of Q4_0's scales, 32-64 bytes of the
// super-blocks' sides.

struct Q4Stream {  // codes 16 B a slot | scales
  static constexpr int kStage = kNibbleStage;
  static constexpr int kSub = 1;
  static constexpr bool kMins = false;
  static constexpr int kBytes = kStage * 16 + kStage * 4;
  const uint8_t* qs;
  const float* scales;
  struct Cursor {
    const uint8_t* q;
    const float* s;
  };
  struct Raw {
    uint4 q;
    float s;
  };

  __device__ __forceinline__ Cursor at(int col, int slot, int K) const {
    return {qs + static_cast<size_t>(col) * (K / 2) + slot * 16,
            scales + static_cast<size_t>(col) * (K / 32) + slot};
  }
  __device__ __forceinline__ int issue(unsigned char* buf, Cursor& c, int ns, int lane,
                                       uint64_t* bar) const {
    const int bytes = copy_span(buf, c.q, ns * 16, lane, bar) +
                      copy_span(buf + kStage * 16, c.s, ns * 4, lane, bar);
    c.q += kStage * 16;
    c.s += kStage;
    return bytes;
  }
  __device__ __forceinline__ Raw load(const unsigned char* buf, int slot) const {
    return {reinterpret_cast<const uint4*>(buf)[slot],
            reinterpret_cast<const float*>(buf + kStage * 16)[slot]};
  }
  __device__ __forceinline__ void sides(const Raw& r, float (&sc)[kSub],
                                        float (&mn)[kSub]) const {
    sc[0] = r.s;
    mn[0] = 0.f;
  }
  __device__ __forceinline__ void codes(const Raw& r, int q, float (&w)[4]) const {
    nibbles4(r.q, q, w);
  }
};

// Kernel 17's codes and expansion (SbReader's roundings): codes as q4_0's |
// the 6-bit sc bytes | the mn bytes | d | dmin (one each 8 slots).  A
// segment and a stage start at a multiple of 8 slots, so a stage's d are
// whole.
struct SbStream {
  static constexpr int kStage = kNibbleStage;
  static constexpr int kSub = 1;
  static constexpr bool kMins = true;
  static constexpr int kBytes = kStage * 16 + 2 * kStage + 2 * (kStage / 8) * 4;
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
  struct Raw {
    uint4 q;
    float d, dmin;
    uint32_t sc, mn;
  };

  __device__ __forceinline__ Cursor at(int col, int slot, int K) const {
    return {qs + static_cast<size_t>(col) * (K / 2) + slot * 16,
            scmn + static_cast<size_t>(col) * (K / 16) + slot,
            d + static_cast<size_t>(col) * (K / 256) + slot / 8, K / 32, dmin - d};
  }
  __device__ __forceinline__ int issue(unsigned char* buf, Cursor& c, int ns, int lane,
                                       uint64_t* bar) const {
    const int bytes =
        copy_span(buf, c.q, ns * 16, lane, bar) +
        copy_span(buf + kStage * 16, c.h, ns, lane, bar) +
        copy_span(buf + kStage * 17, c.h + c.mn, ns, lane, bar) +
        copy_span(buf + kStage * 18, c.d, ns / 8 * 4, lane, bar) +
        copy_span(buf + kStage * 18 + kStage / 2, c.d + c.dm, ns / 8 * 4, lane, bar);
    c.q += kStage * 16;
    c.h += kStage;
    c.d += kStage / 8;
    return bytes;
  }
  __device__ __forceinline__ Raw load(const unsigned char* buf, int slot) const {
    const float* dd = reinterpret_cast<const float*>(buf + kStage * 18);
    return {reinterpret_cast<const uint4*>(buf)[slot], dd[slot / 8], dd[kStage / 8 + slot / 8],
            buf[kStage * 16 + slot], buf[kStage * 17 + slot]};
  }
  __device__ __forceinline__ void sides(const Raw& r, float (&sc)[kSub],
                                        float (&mn)[kSub]) const {
    const float s = __fmul_rn(r.d, byte_value(r.sc));
    const float m = __fmul_rn(r.dmin, byte_value(r.mn));
    sc[0] = s;
    mn[0] = __fsub_rn(__fmul_rn(8.f, s), m);
  }
  __device__ __forceinline__ void codes(const Raw& r, int q, float (&w)[4]) const {
    nibbles4(r.q, q, w);
  }
};

// Group codes: a slot's 32 int8 codes (one bulk copy a stage) | scales |
// mins.
template <int G, bool MINS>
struct QkStream {
  static constexpr int kStage = kSlots;
  static constexpr int kSub = 32 / G;
  static constexpr bool kMins = MINS;
  static constexpr int kBytes = kStage * 32 + kStage * kSub * 4 * (MINS ? 2 : 1);
  const int8_t* qs;
  const float* scales;
  const float* mins;
  struct Cursor {
    const int8_t* q;
    const float* s;
    long long m;  // mins - scales, in floats
  };
  struct Raw {
    uint4 q[2];
    float s[kSub], m[kSub];
  };

  __device__ __forceinline__ Cursor at(int col, int slot, int K) const {
    return {qs + static_cast<size_t>(col) * K + slot * 32,
            scales + static_cast<size_t>(col) * (K / G) + slot * kSub, MINS ? mins - scales : 0};
  }
  __device__ __forceinline__ int issue(unsigned char* buf, Cursor& c, int ns, int lane,
                                       uint64_t* bar) const {
    int bytes = copy_span(buf, c.q, ns * 32, lane, bar) +
                copy_span(buf + kSlots * 32, c.s, ns * kSub * 4, lane, bar);
    if (MINS)
      bytes += copy_span(buf + kSlots * 32 + kSlots * kSub * 4, c.s + c.m,
                                ns * kSub * 4, lane, bar);
    c.q += kSlots * 32;
    c.s += kSlots * kSub;
    return bytes;
  }
  __device__ __forceinline__ Raw load(const unsigned char* buf, int slot) const {
    const uint4* p = reinterpret_cast<const uint4*>(buf);
    const float* s = reinterpret_cast<const float*>(buf + kStage * 32);
    Raw r;
    r.q[0] = p[2 * slot];
    r.q[1] = p[2 * slot + 1];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      r.s[j] = s[slot * kSub + j];
      r.m[j] = MINS ? s[kStage * kSub + slot * kSub + j] : 0.f;
    }
    return r;
  }
  __device__ __forceinline__ void sides(const Raw& r, float (&sc)[kSub],
                                        float (&mn)[kSub]) const {
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      sc[j] = r.s[j];
      mn[j] = r.m[j];
    }
  }
  __device__ __forceinline__ void codes(const Raw& r, int q, float (&w)[4]) const {
    const uint4 h = r.q[q / 4];
    const uint32_t words[4] = {h.x, h.y, h.z, h.w};
    // b ^ 0x80 is b + 128 as an unsigned byte (sbyte's offset).
    const uint32_t u = words[q % 4] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b) w[b] = biased_byte(u, b) - 8388736.0f;
  }
};

// Slots of each of `n` equal runs of K (the segments, or one segment's
// parts): ceil(slots / n) rounded up to kAlign.
__host__ __device__ inline int segment_slots(int K, int n) {
  const int slots = K / 32;
  const int per = (slots + n - 1) / n;
  return (per + kAlign - 1) / kAlign * kAlign;
}

// Tasks (column pairs) of a launch over N outputs, and the most a warp
// takes when `blocks` blocks share them, each pair's K split over `parts`
// warps.
__host__ __device__ inline int pair_tasks(int EPI, int N) {
  return EPI == kSwiGLU ? N / 2 : (N + 1) / 2;
}
__host__ __device__ inline int tasks_per_warp(int EPI, int N, int blocks, int parts) {
  const int groups = blocks * kWarps / parts;
  return (pair_tasks(EPI, N) + groups - 1) / groups;
}

// Dynamic shared memory of a block: one K segment of x's ROWS rows (f32,
// the mins forms' group sums in each slot's pad), the warps' rings, the
// norm's sums (then the parts' exchange), the stages' mbarriers and, where
// K is walked in more than one segment, each warp's running sums of its
// tasks.
template <typename Form>
__host__ __device__ inline int smem_bytes(int EPI, int rows, int K, int N, const Plan& p) {
  return rows * segment_slots(K, p.splits) * kSlotFloats * 4 +
         kWarps * p.stages * kCols * Form::kBytes + kRedBytes + kBarBytes +
         (p.splits > 1 ? kWarps * tasks_per_warp(EPI, N, p.blocks, 1) * kCols * rows * 4 : 0);
}

// Waits for this lane's cp.async copies of all but the newest stages - 1
// stages: the oldest of a full ring.
__device__ __forceinline__ void wait_stages(int stages) {
  switch (stages) {
    case 2: cp_async_wait<1>(); break;
    case 3: cp_async_wait<2>(); break;
    case 4: cp_async_wait<3>(); break;
    case 5: cp_async_wait<4>(); break;
    default: cp_async_wait<5>(); break;
  }
}

// The `n` warps of a part group (a named barrier a group, ids 1-8).
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n * 32) : "memory");
}

// Persistent blocks, one an SM: the launch's warps form groups of `parts`
// consecutive warps; group gg of the launch's groups takes the column pairs
// (tasks) gg, gg + groups, ..., and its warp h walks part h of each pair's K
// (parts > 1 in one segment only), the parts' sums added in order through
// shared memory.  K is walked in `splits` segments, each staged into shared
// memory in turn (one at decode's one row).
//   kStore:    y[B, N]   = acc                       (task t: columns 2t, 2t+1)
//   kSwiGLU:   y[B, N/2] = silu(acc[:, f]) * acc[:, f + N/2]   (task f; TY = float)
//   kResidual: y[B, N]   = residual + acc
template <typename TX, typename TY, int ROWS, int EPI, typename Form, typename TG, typename TR>
__global__ void __launch_bounds__(kThreads, 1)
    stream_kernel(const TX* x, int B, int K, Form form, int N, const TG* gain, float eps,
                  const TR* residual, TY* y, int splits, int stages, int parts) {
  constexpr int SUB = Form::kSub;
  constexpr int F4_PER_SUB = 8 / SUB;  // float4s of one group
  constexpr int STAGE = Form::kStage;
  constexpr int PASSES = STAGE / kSlots;  // a lane's slots of a stage
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = stages;
  const int slots = K / 32;
  const int seg = segment_slots(K, splits);
  const int xstride = seg * kSlotFloats;  // floats of a staged row
  const int P = pair_tasks(EPI, N);
  const int groups = gridDim.x * kWarps / parts;
  const int gg = (blockIdx.x * kWarps + warp) / parts;  // this warp's group
  const int part = warp % parts;                        // its part of each pair's K
  const int plen = parts > 1 ? segment_slots(K, parts) : seg;
  const int n_tasks = gg < P ? (P - 1 - gg) / groups + 1 : 0;
  const int tmax = tasks_per_warp(EPI, N, gridDim.x, parts);
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
  if (lane == 0) {
    for (int k = 0; k < R; ++k) mbar_init(bars + k);
    mbar_init_fence();
  }
  __syncwarp();

  // This warp's slots of segment s: the segment's, or (one segment) its part's.
  auto first_slot = [&](int s) { return parts > 1 ? part * plen : s * seg; };
  auto end_slot = [&](int s) { return min(slots, first_slot(s) + plen); };
  auto columns = [&](int i, int (&col)[kCols], bool (&live)[kCols]) {
    const int t = gg + i * groups;
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
  // The load cursor: segment ls, task li, the next slot ln of the warp's
  // slots of the segment; the columns' stream pointers at it.
  int ls = 0, li = 0, ln = 0;
  int lcol[kCols];
  bool llive[kCols];
  typename Form::Cursor cur[kCols];
  auto start_task = [&]() {
    columns(li, lcol, llive);
#pragma unroll
    for (int c = 0; c < kCols; ++c) cur[c] = form.at(llive[c] ? lcol[c] : 0, first_slot(ls), K);
  };
  if (n_tasks > 0) start_task();
  auto issue_next = [&](int slot) {
    if (ls >= splits || n_tasks == 0) return;
    const int len = end_slot(ls) - first_slot(ls);
    const int ns = min(STAGE, len - ln);
    unsigned char* st = ring + slot * kCols * Form::kBytes;
    int bytes = 0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (llive[c]) bytes += form.issue(st + c * Form::kBytes, cur[c], ns, lane, bars + slot);
    if (lane == 0) mbar_expect(bars + slot, bytes);
    ln += STAGE;
    if (ln >= len) {
      ln = 0;
      if (++li == n_tasks) {
        li = 0;
        ++ls;
      }
      if (ls < splits) start_task();
    }
  };
  // The ring's first E stages in flight before any other work, the rest
  // once x is staged: x's loads queue behind what is issued before them, so
  // kernels 1, 13 and 17 issue two stages first; the residual and SwiGLU
  // launches issue the whole ring.  The weights are read-only, so their
  // copies start before the wait on the kernel before this one (where this
  // launch is its programmatic dependent); every read of x, the gain and
  // the residual and every write of y come after it.  Those four pointers
  // are not __restrict__, so that no read of them moves above the wait.
  const int E = EPI == kStore ? min(R, 2) : R;
  for (int k = 0; k < E; ++k) {
    issue_next(k);
    cp_async_commit();
  }
  grid_launch_dependents();
  grid_wait();

  // Over more than one segment, the norm's row statistics over all of K
  // first, from global memory; over one, from the staged row below.
  if (gain != nullptr && splits > 1) {
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
    const int n4 = (hi - lo) * 8;  // float4s of a staged row
    __syncthreads();  // the last segment's x is consumed (and inv is written)
    // Float4 i of row r's segment, final: into its slot, and for the forms
    // with mins each group's input sum into the slot's pad, folded in order
    // over the group's lanes (every lane of the warp calls it).
    auto put = [&](int r, int i, bool valid, float4 v) {
      float* slot = xs + r * xstride + (i >> 3) * kSlotFloats;
      if (valid) *reinterpret_cast<float4*>(slot + (i & 7) * 4) = v;
      if (Form::kMins) {
        const float a = (v.x + v.y) + (v.z + v.w);
        const int q0 = lane & ~(F4_PER_SUB - 1);
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < F4_PER_SUB; ++q) sum += __shfl_sync(0xffffffffu, a, q0 + q);
        if (valid && (lane & (F4_PER_SUB - 1)) == 0) slot[32 + (i & 7) / F4_PER_SUB] = sum;
      }
    };
    // The segment of every row into shared memory (zeros past B), read
    // once: raw, with its sum of squares where the norm's statistics come
    // from it, then normalised in place as (x * inv) * gain.  A thread
    // takes float4s i = threadIdx.x + j * kThreads of every row, XU of
    // them for each row in flight at once.
    constexpr int XU = ROWS >= 4 ? 1 : 4 / ROWS;
    const bool stats = gain != nullptr && splits == 1;
    float ssq[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) ssq[r] = 0.f;
    for (int b = warp * 32; b < n4; b += kThreads * XU) {
      float4 v[XU][ROWS], g[XU];
#pragma unroll
      for (int u = 0; u < XU; ++u) {
        const int i = b + u * kThreads + lane;
        g[u] = gain != nullptr && !stats && i < n4 ? load4(gain + lo * 32 + i * 4)
                                                   : make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          v[u][r] = i < n4 && r < B ? load4(x + static_cast<size_t>(r) * K + lo * 32 + i * 4)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < XU; ++u) {
        const int i = b + u * kThreads + lane;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float4 w = v[u][r];
          if (stats) {
            ssq[r] += (w.x * w.x + w.y * w.y) + (w.z * w.z + w.w * w.w);
            if (i < n4)
              *reinterpret_cast<float4*>(xs + r * xstride + (i >> 3) * kSlotFloats +
                                         (i & 7) * 4) = w;
            continue;
          }
          if (gain != nullptr) {
            const float sr = inv[r];
            w.x = (w.x * sr) * g[u].x;
            w.y = (w.y * sr) * g[u].y;
            w.z = (w.z * sr) * g[u].z;
            w.w = (w.w * sr) * g[u].w;
          }
          put(r, i, i < n4, w);
        }
      }
    }
    if (stats) {
      float sr[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        ssq[r] = warp_sum(ssq[r]);
        if (lane == 0) red[warp * ROWS + r] = ssq[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float total = 0.f;
        for (int w = 0; w < kWarps; ++w) total += red[w * ROWS + r];
        sr[r] = rsqrtf(total / K + eps);
      }
      for (int b = warp * 32; b < n4; b += kThreads) {
        const int i = b + lane;
        const float4 g = i < n4 ? load4(gain + i * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < n4) {
            w = *reinterpret_cast<const float4*>(xs + r * xstride + (i >> 3) * kSlotFloats +
                                                 (i & 7) * 4);
            w.x = (w.x * sr[r]) * g.x;
            w.y = (w.y * sr[r]) * g.y;
            w.z = (w.z * sr[r]) * g.z;
            w.w = (w.w * sr[r]) * g.w;
          }
          put(r, i, i < n4, w);
        }
      }
    }
    __syncthreads();  // x staged (red is free: the parts' exchange below)
    if (s == 0)
      for (int k = E; k < R; ++k) {
        issue_next(k);
        cp_async_commit();
      }

    const int w0 = first_slot(s), wn = end_slot(s) - w0;  // this warp's slots
    const int n_chunks = (wn + STAGE - 1) / STAGE;
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
        mbar_wait(bars + use, phase);  // its bulk copies
        __syncwarp();  // every lane's copies
        const unsigned char* st = ring + use * kCols * Form::kBytes;
        typename Form::Raw raw[PASSES][kCols];
#pragma unroll
        for (int u = 0; u < PASSES; ++u)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            raw[u][c] = form.load(st + c * Form::kBytes, u * kSlots + lane);
        __syncwarp();  // every lane has read the stage: refill it now
        if (lane == 0) fence_async_shared();
        issue_next(use);
        cp_async_commit();
        if (++use == R) {
          use = 0;
          phase ^= 1;
        }
#pragma unroll
        for (int u = 0; u < PASSES; ++u) {
          const int slot = ch * STAGE + u * kSlots + lane;  // of this warp's slots
          if (slot >= wn) continue;  // a ragged last stage
          float sc[kCols][SUB], mn[kCols][SUB];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            form.sides(raw[u][c], sc[c], mn[c]);
            if (!live[c])
#pragma unroll
              for (int j = 0; j < SUB; ++j) sc[c][j] = mn[c][j] = 0.f;
          }
          // Each group's dot a (column, row) in one FMA chain, its codes
          // converted four at a time for every row.
          const float* xl = xs + (w0 - lo + slot) * kSlotFloats;
          float part_[kCols][SUB][ROWS];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int j = 0; j < SUB; ++j)
#pragma unroll
              for (int r = 0; r < ROWS; ++r) part_[c][j][r] = 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int j = q / F4_PER_SUB;
            float w[kCols][4];
#pragma unroll
            for (int c = 0; c < kCols; ++c) form.codes(raw[u][c], q, w[c]);
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              const float4 xv = reinterpret_cast<const float4*>(xl + r * xstride)[q];
#pragma unroll
              for (int c = 0; c < kCols; ++c) {
                part_[c][j][r] = fmaf(xv.x, w[c][0], part_[c][j][r]);
                part_[c][j][r] = fmaf(xv.y, w[c][1], part_[c][j][r]);
                part_[c][j][r] = fmaf(xv.z, w[c][2], part_[c][j][r]);
                part_[c][j][r] = fmaf(xv.w, w[c][3], part_[c][j][r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int c = 0; c < kCols; ++c)
#pragma unroll
              for (int j = 0; j < SUB; ++j) {
                acc[c][r] = fmaf(sc[c][j], part_[c][j][r], acc[c][r]);
                if (Form::kMins)
                  acc[c][r] = fmaf(mn[c][j], xl[r * xstride + 32 + j], acc[c][r]);
              }
        }
      }
      // The task's sums (every lane holds them after the butterfly); lane r
      // keeps row r: summed over the segments in order, or over the parts in
      // order (part 0's warp adds the others' from shared memory), then the
      // epilogue.
      float v[kCols][ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          v[c][r] = warp_sum(acc[c][r]);
          if (splits > 1 && lane == r) {
            float* at = sums + (i * kCols + c) * ROWS + r;
            if (s > 0) v[c][r] += *at;
            *at = v[c][r];
          }
        }
      if (parts > 1) {
        float* xch = red + (warp * 2 + (i & 1)) * kCols * ROWS;  // [kCols][ROWS]
        if (part > 0 && lane < ROWS)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              if (lane == r) xch[c * ROWS + r] = v[c][r];
        group_sync(1 + warp / parts, parts);
        if (part > 0) continue;
        for (int h = 1; h < parts; ++h) {
          const float* o = red + ((warp + h) * 2 + (i & 1)) * kCols * ROWS;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              if (lane == r) v[c][r] += o[c * ROWS + r];
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (lane != r || r >= B || s + 1 < splits) continue;
        if (EPI == kSwiGLU) {
          y[static_cast<size_t>(r) * (N / 2) + col[0]] =
              from_f32<TY>(v[0][r] / (1.f + expf(-v[0][r])) * v[1][r]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            if (!live[c]) continue;
            const size_t o = static_cast<size_t>(r) * N + col[c];
            float out = v[c][r];
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
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = p.dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, fn, x, B, K, form, N, gain, eps, residual, y, p.splits,
                            p.stages, p.parts);
}

template <typename TX, typename TY, int EPI, typename TG, typename TR, typename Form>
cudaError_t launch(const TX* x, int B, int K, const Form& form, int N, const TG* gain, float eps,
                   const TR* residual, TY* y, const Plan& p, cudaStream_t stream) {
  if (B < 1 || B > 8 || K % 32 != 0 || N < 1 || (EPI == kSwiGLU && N % 2 != 0) ||
      p.splits < 1 || (p.splits - 1) * segment_slots(K, p.splits) >= K / 32 || p.stages < 2 ||
      p.stages > kMaxStages || p.blocks < 1 ||
      (p.parts != 1 && p.parts != 2 && p.parts != 4) || (p.parts > 1 && p.splits > 1) ||
      (p.parts - 1) * segment_slots(K, p.parts) >= K / 32)
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
// result; an invalid value for an unknown form, for kFormSb unless SB and
// for the forms with mins unless MINS (the launches that never take them
// do not instantiate their forms).
template <bool SB, bool MINS, typename Fn>
cudaError_t with_form(const Weights& w, Fn&& f) {
  const float* s = static_cast<const float*>(w.scales);
  const float* m = static_cast<const float*>(w.mins);
  const int8_t* q8 = static_cast<const int8_t*>(w.qs);
  const uint8_t* q4 = static_cast<const uint8_t*>(w.qs);
  switch (w.form) {
    case kFormQ4:
      return f(Q4Stream{q4, s});
    case kFormSb:
      if constexpr (SB) return f(SbStream{q4, s, m, static_cast<const uint8_t*>(w.hi)});
      return cudaErrorInvalidValue;
    case kFormG32:
      return f(QkStream<32, false>{q8, s, nullptr});
    case kFormG32Mins:
      if constexpr (MINS) return f(QkStream<32, true>{q8, s, m});
      return cudaErrorInvalidValue;
    case kFormG16:
      return f(QkStream<16, false>{q8, s, nullptr});
    case kFormG16Mins:
      if constexpr (MINS) return f(QkStream<16, true>{q8, s, m});
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// The bodies of the launches declared above; each gemv_stream_*.cu file
// defines one overload with them.  ALL takes every form kernel 2's launch
// takes (gate/up: all six; down: all but sb); without it, the forms without
// mins but sb (kernel 15's Wo and w13, as its gate admits them).
template <typename T>
cudaError_t matmul_of(const T* x, int B, int K, const Weights& w, int N, const T* gain, float eps,
                      T* y, const Plan& p, cudaStream_t stream) {
  return with_form<true, true>(w, [&](const auto& f) {
    return launch<T, T, kStore, T, float>(x, B, K, f, N, gain, eps, nullptr, y, p, stream);
  });
}

template <bool ALL, typename TX, typename TG>
cudaError_t gate_up_of(const TX* x, int B, int D, const Weights& w, int F2, const TG* gain,
                       float eps, float* h, const Plan& p, cudaStream_t stream) {
  return with_form<ALL, ALL>(w, [&](const auto& f) {
    return launch<TX, float, kSwiGLU, TG, float>(x, B, D, f, F2, gain, eps, nullptr, h, p,
                                                 stream);
  });
}

template <bool ALL, typename TX, typename TR, typename TY>
cudaError_t down_of(const TX* x, int B, int K, const Weights& w, int N, const TR* residual,
                    TY* y, const Plan& p, cudaStream_t stream) {
  return with_form<false, ALL>(w, [&](const auto& f) {
    return launch<TX, TY, kResidual, float, TR>(x, B, K, f, N, nullptr, 0.f, residual, y, p,
                                                stream);
  });
}

}  // namespace stream
}  // namespace thawk
