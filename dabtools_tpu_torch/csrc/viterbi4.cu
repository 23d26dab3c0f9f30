// Radix-4 soft-decision Viterbi for the DAB K=7 rate-1/4 code on Hopper.
//
// K1 acs4_kernel replaces dabtools_tpu/ops/viterbi_pallas4.py:29
// _acs4_kernel (launched at _decode4_call, viterbi_pallas4.py:351); K2
// traceback4_kernel replaces :177 _traceback4_kernel (launched at :389);
// K2' traceback4_onehot64_kernel replaces :246 _traceback4_kernel_onehot64
// (the same launch with traceback="onehot64").  Only the TPU kernel's
// default ACS semantics are built (select=shuffle, pack=shift4, bm=f32);
// the plain PyTorch versions that compute the same values are
// dabtools_tpu_torch/ops/viterbi.py::acs4_plain, ::traceback4_plain and
// ::traceback4_onehot64_plain (K2' computes K2's function with its own
// arithmetic).
//
// What bounds them on the card.  Both are sequential recursions over the
// double steps of a codeword (1539 at the flagship's 3078-step MSC
// codewords), so latency and instruction issue, not bandwidth or
// arithmetic, set their time: at the flagship shape K1 moves 29 MB of
// live soft bits in and 16 MB of decisions out, which HBM moves in
// ~0.013 ms.  What counts is each step's dependent chain and the
// instructions each step issues.  One codeword alone is bound by its
// warp's issue of a step's ~60 instructions, many of them dependent
// (tools/torch_viterbi4_probe.py times 1 lane against many).  At the
// flagship's 640 lanes K1 is bound by issue: its 576 MSC codewords are
// more than the card's 528 warp schedulers (132 SMs x 4), so some
// scheduler holds two of them and issues both their steps.  So the
// design keeps loads, shared memory and barriers off the per-step chain
// and cuts the instructions per step.
//
// K1 design: one warp per codeword, path metrics in registers.  Thread j
// holds states j (pm0) and 32 + j (pm1).  Both its targets, t = j and t =
// 32 + j, have the predecessors 4a..4a+3 with a = j & 15, and state 4a + p
// lives in thread 4(a & 7) + p, in pm1 if a >= 8 else pm0.  A step is 8
// __shfl_sync (both registers of the 4 source threads: the readers of one
// source want different registers), 4 selects, 8 candidate adds and two
// 4-way selects, with no shared memory and no barrier on the chain; the
// survivor's metric is an fmaxf tree, and the compares that give the
// decisions are off the chain.  4 __ballot_sync give the step's 4
// decision words, which thread 0 puts in shared memory; they leave as one
// coalesced 512 B store per chunk.  Branch metrics take 3 signed 4-term
// sums per thread instead of 8 8-term ones, since all four DAB generator
// polynomials tap both the newest and the oldest register bit.  So for
// target t and predecessor p (rows of WS4), flipping p's bit 0 negates
// the first step's 4 signs, flipping p's bit 1 negates the second step's,
// the second step's signs do not depend on p's bit 0, and t = 32 + j has
// t = j's first-step signs and negated second-step ones
// (tests/test_torch_viterbi.py::test_warp_branch_metric_signs pins this
// on WS4).  With A and B the first step's sums of p = 0 and p = 2 and C
// the second step's of p = 0, target j takes A+C, -A+C, B-C, -B-C and
// target 32 + j takes A-C, -A-C, B+C, -B+C: the same values, bit for bit,
// as summing each row's own signs, since negation is exact and rounding
// to nearest is symmetric.  The kernel reads those three sign rows of WS4
// and no other.  A trellis step has only 16 sign patterns, so thread j
// forms pattern j & 15 of trellis step j >> 4 (the first or the second)
// for each double step of a chunk before the chunk's walk, and a step
// takes its A, B and C from the threads of their patterns with 3 more
// shuffles that do not depend on the path metrics.  Soft bits come in
// chunks of kChunk = 32 double steps (1 KB a lane), one step's two float4
// per thread, coalesced; chunk k + 1 is loaded into registers while chunk
// k is walked from shared memory.  A lane's recurrence stops at
// t2[lane]; the steps after it store decision 0.  Two lanes (warps) per
// 64-thread block: the flagship's 640 lanes are 320 blocks, all resident
// at once over the 132 SMs (94 registers a thread, 3 KB of shared memory
// a block).
//
// K2 design: one warp per codeword as well, walking a warp-uniform state.
// Chunks of kChunk double steps of decision words are loaded coalesced
// (one uint4 per thread, 512 B), the next chunk down while the current
// one is walked from shared memory (one broadcast 16 B load per step,
// whose address does not depend on the state, issued a step ahead), so
// the chain per step is a few integer operations.  Thread i keeps the two
// bits of the chunk's step i, and the chunk's bits leave as one coalesced
// store (2 B per thread).  T2 need not be a multiple of kChunk.  Two lanes
// per block, as K1 (31 registers, 1 KB of shared memory a block).
//
// K2' keeps the one-hot64 kernel's idea, the survivor carried as a
// 64-state one-hot and never as a state index, in K2's layout: one warp
// per codeword, decision words staged per chunk and read as broadcasts a
// step ahead, thread i keeping the chunk's step i's two bits.  The one-hot
// is a 64-bit mask in registers, lo for states 0-31 and hi for 32-63, the
// same in every thread, so a step needs no vote and no shuffle.  The
// survivor's decision is the TPU kernel's sum(oh * dec) as a masked AND
// (the word of plane k holds state 32w + j's bit at bit j), and its output
// bits are whether the mask lies in its words' upper halves (bit 4) and in
// hi (bit 5).  The predecessor 4a + d (a = t & 15) comes by integer
// squaring, exact because the mask is a power of two: any = lo | hi has
// bit p = t & 31, any^2 (a 32x32->64 product) bit 2p, so its two words
// OR'd hold bit 2a, the fold over bits 4 and 5 of the state, and that
// squared has bit 4a of 64.  Both halves then shift left by d.  A step's
// two chains, the decision (two ANDs, a min, a multiply-add, the shift)
// and the squares (or, wide multiply, or, wide multiply, the shift), are
// five operations each; a fold (shift, or, mask) and a spread by three
// shift/or/and stages per half would make the second ten deep.
// "v != 0" is written as min(v, 1) in PTX, since the compiler's own
// compare and select cost a step two instructions more; the 32-step walk
// is 655 SASS instructions (tools/torch_viterbi4_probe.py).
//
// Semantics that must match the plain version bit for bit:
//   * branch metric bm[p*64+t] = (sum_{k<4} w_k s_k) + (sum_{k>=4} w_k s_k)
//     with w = WS4[p*64+t]: each trellis step's 4 terms summed left to
//     right, then the two sums added (products are exact, +/-1 weights);
//   * candidates c_p = pm[4*(t&15)+p] + bm[p*64+t];
//   * select with strict '>' so ties take the lower p:
//     d01 = c1>c0, d23 = c3>c2, hi = max(c2,c3) > max(c0,c1),
//     d = hi ? 2+d23 : d01;
//   * a step g >= t2[lane] freezes pm and records decision 0;
//   * metric = final pm[0].
// Built without --use_fast_math: no reassociation, no flush to zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kChunk = 32;         // double steps per staged chunk
constexpr int kLanesPerBlock = 2;  // K1/K2/K2': one warp per lane

// The 4-way select of one target: returns the survivor's metric and sets
// the decision's two bits.  fmaxf gives the strict-'>' select's value,
// since no candidate is NaN or -0 (a sum is -0 only if both terms are,
// and no path metric is), and keeps the compares off the path-metric
// chain.
__device__ __forceinline__ float select4(const float (&pred)[4],
                                         const float (&bm)[4], bool& bit0,
                                         bool& bit1) {
  const float c0 = pred[0] + bm[0], c1 = pred[1] + bm[1];
  const float c2 = pred[2] + bm[2], c3 = pred[3] + bm[3];
  const float m01 = fmaxf(c0, c1), m23 = fmaxf(c2, c3);
  const bool hi = m23 > m01;
  bit0 = hi ? c3 > c2 : c1 > c0;
  bit1 = hi;
  return fmaxf(m01, m23);
}

// Signed sum of one trellis step's 4 soft bits, left to right.
__device__ __forceinline__ float signed_sum(const float (&w)[4], float4 s) {
  return fmaf(w[3], s.w, fmaf(w[2], s.z, fmaf(w[1], s.y, w[0] * s.x)));
}

// Sign pattern 8 n0 + 4 n1 + 2 n2 + n3 of 4 +/-1 signs (n_k: w_k < 0).
__device__ __forceinline__ int sign_pattern(const float (&w)[4]) {
  return 8 * (w[0] < 0.f) + 4 * (w[1] < 0.f) + 2 * (w[2] < 0.f) +
         (w[3] < 0.f);
}

// Walk the first n (all kChunk if kFull) double steps of a staged chunk.
// Thread j first forms, for every step of the chunk, the signed sum of
// pattern j & 15 over trellis step j >> 4's 4 soft bits; a step then
// reads its A, B and C from threads la, lb and lc.
template <bool kFull>
__device__ __forceinline__ void acs4_walk(
    const float4 (*soft)[2], uint4* dec, int n, const float (&wq)[4], int j,
    int la, int lb, int lc, int src, bool upper, float& pm0, float& pm1) {
  // The chunk's signed sums first: they do not depend on the path metrics,
  // and formed inside a step their loads and 4-deep sums would sit on the
  // chain (the compiler issues a step's loads just before their use).
  float sq[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (!kFull && i >= n) break;
    sq[i] = signed_sum(wq, soft[i][j >> 4]);
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (!kFull && i >= n) break;
    const float a = __shfl_sync(kAll, sq[i], la);
    const float b = __shfl_sync(kAll, sq[i], lb);
    const float c = __shfl_sync(kAll, sq[i], lc);
    const float bm0[4] = {a + c, -a + c, b + -c, -b + -c};
    const float bm1[4] = {a + -c, -a + -c, b + c, -b + c};
    float pred[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float q0 = __shfl_sync(kAll, pm0, src + p);
      const float q1 = __shfl_sync(kAll, pm1, src + p);
      pred[p] = upper ? q1 : q0;
    }
    bool lo0, lo1, hi0, hi1;
    pm0 = select4(pred, bm0, lo0, lo1);
    pm1 = select4(pred, bm1, hi0, hi1);
    const uint32_t w0 = __ballot_sync(kAll, lo0);
    const uint32_t w1 = __ballot_sync(kAll, lo1);
    const uint32_t w2 = __ballot_sync(kAll, hi0);
    const uint32_t w3 = __ballot_sync(kAll, hi1);
    if (j == 0) dec[i] = make_uint4(w0, w1, w2, w3);
  }
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
acs4_kernel(const float* __restrict__ soft, const int* __restrict__ t2,
            const float* __restrict__ ws4, uint32_t* __restrict__ dec,
            float* __restrict__ metric, int B, int T2) {
  __shared__ float4 soft_s[kLanesPerBlock][kChunk][2];
  __shared__ uint4 dec_s[kLanesPerBlock][kChunk];
  const int warp = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const int lane = blockIdx.x * kLanesPerBlock + warp;
  if (lane >= B) return;  // warp-uniform: every lane is one whole warp

  // Sign rows (p = 0, t = j) and (p = 2, t = j) of the first step, (p = 0,
  // t = j) of the second; every other row follows from these (see above).
  // Their sums come from the threads whose own pattern they are.
  float wa[4], wb[4], wc[4], wq[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wa[k] = ws4[j * 8 + k];
    wb[k] = ws4[(128 + j) * 8 + k];
    wc[k] = ws4[j * 8 + 4 + k];
    wq[k] = ((j >> (3 - k)) & 1) ? -1.0f : 1.0f;
  }
  const int la = sign_pattern(wa), lb = sign_pattern(wb);
  const int lc = 16 + sign_pattern(wc);
  const int a = j & 15;
  const int src = 4 * (a & 7);
  const bool upper = a >= 8;
  const int len = min(max(t2[lane], 0), T2);
  const float4* s4 =
      reinterpret_cast<const float4*>(soft + (size_t)lane * T2 * 8);
  uint4* dl = reinterpret_cast<uint4*>(dec + (size_t)lane * T2 * 4);

  float pm0 = (j == 0) ? 0.0f : kNegInf, pm1 = kNegInf;
  float4 n1 = make_float4(0.f, 0.f, 0.f, 0.f), n2 = n1;
  if (j < len) {
    n1 = s4[2 * j];
    n2 = s4[2 * j + 1];
  }
  for (int base = 0; base < T2; base += kChunk) {
    const int n = min(kChunk, max(len - base, 0));  // live steps here
    if (n > 0) {
      __syncwarp();
      soft_s[warp][j][0] = n1;
      soft_s[warp][j][1] = n2;
      __syncwarp();
      const int g = base + kChunk + j;  // the next chunk, in flight
      if (g < len) {
        n1 = s4[2 * g];
        n2 = s4[2 * g + 1];
      }
      if (n == kChunk)
        acs4_walk<true>(soft_s[warp], dec_s[warp], n, wq, j, la, lb, lc, src,
                        upper, pm0, pm1);
      else
        acs4_walk<false>(soft_s[warp], dec_s[warp], n, wq, j, la, lb, lc, src,
                         upper, pm0, pm1);
      __syncwarp();
    }
    if (base + j < T2)  // steps past the lane's length record 0
      dl[base + j] = (j < n) ? dec_s[warp][j] : make_uint4(0u, 0u, 0u, 0u);
  }
  if (j == 0) metric[lane] = pm0;
}

// Walk the staged chunk's steps n-1 .. 0 (kChunk-1 .. 0 if kFull) from
// state s; thread j keeps step j's two bits in own (byte 0: bit 2g, byte
// 1: bit 2g + 1).
template <bool kFull>
__device__ __forceinline__ void traceback4_walk(const uint4* words, int n,
                                                int j, int& s,
                                                uint32_t& own) {
  uint4 next = words[kFull ? kChunk - 1 : n - 1];
#pragma unroll
  for (int i = kChunk - 1; i >= 0; --i) {
    if (!kFull && i >= n) continue;
    const uint4 w = next;
    if (i > 0) next = words[i - 1];  // broadcast load, a step ahead
    if (j == i) own = ((s >> 4) & 1) | (((s >> 5) & 1) << 8);
    const uint32_t lo = (s & 32) ? w.z : w.x;
    const uint32_t hi = (s & 32) ? w.w : w.y;
    const int b = s & 31;
    s = (4 * (s & 15)) | (int)((lo >> b) & 1u) | (int)(((hi >> b) & 1u) << 1);
  }
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
traceback4_kernel(const uint32_t* __restrict__ dec,
                  uint8_t* __restrict__ bits, int B, int T2) {
  __shared__ uint4 dec_s[kLanesPerBlock][kChunk];
  const int warp = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const int lane = blockIdx.x * kLanesPerBlock + warp;
  if (lane >= B || T2 <= 0) return;  // warp-uniform
  const uint4* dl =
      reinterpret_cast<const uint4*>(dec + (size_t)lane * T2 * 4);
  uint16_t* bl = reinterpret_cast<uint16_t*>(bits + (size_t)lane * 2 * T2);

  const int top = ((T2 - 1) / kChunk) * kChunk;  // the highest chunk
  uint4 next = make_uint4(0u, 0u, 0u, 0u);
  if (top + j < T2) next = dl[top + j];
  int s = 0;
  for (int base = top; base >= 0; base -= kChunk) {
    __syncwarp();
    dec_s[warp][j] = next;
    __syncwarp();
    if (base > 0) next = dl[base - kChunk + j];  // the chunk below, in flight
    const int n = min(kChunk, T2 - base);
    uint32_t own = 0;
    if (n == kChunk)
      traceback4_walk<true>(dec_s[warp], n, j, s, own);
    else
      traceback4_walk<false>(dec_s[warp], n, j, s, own);
    if (j < n) bl[base + j] = (uint16_t)own;
  }
}

// min(v, 1): 1 if the one-hot meets v, else 0.  As min.u32 it stays one
// instruction; written as v != 0, the compiler makes a compare and a
// select of it.
__device__ __forceinline__ uint32_t umin1(uint32_t v) {
  uint32_t r;
  asm("min.u32 %0, %1, 1;" : "=r"(r) : "r"(v));
  return r;
}

// Walk the staged chunk's steps n-1 .. 0 (kChunk-1 .. 0 if kFull) from the
// one-hot (lo, hi); bit i of u1 / u2 takes step i's bit 2g / 2g + 1.
template <bool kFull>
__device__ __forceinline__ void onehot64_walk(const uint4* words, int n,
                                              uint32_t& lo, uint32_t& hi,
                                              uint32_t& u1, uint32_t& u2) {
  uint4 next = words[kFull ? kChunk - 1 : n - 1];
#pragma unroll
  for (int i = kChunk - 1; i >= 0; --i) {
    if (!kFull && i >= n) continue;
    const uint4 w = next;
    if (i > 0) next = words[i - 1];  // broadcast load, a step ahead
    // any has bit p = t & 31 alone, so any^2 has bit 2p of 64: bit 2a
    // (a = t & 15) of its low word if p < 16, of its high word if not.
    const uint32_t any = lo | hi;
    const uint64_t sq = (uint64_t)any * any;
    const uint32_t sq_hi = (uint32_t)(sq >> 32);
    // Bit i of u1 / u2: bits 4 and 5 of the state (added: bit i is clear).
    u1 += umin1(sq_hi) << i;
    u2 += umin1(hi) << i;
    // The survivor's decision: its bit in each plane's word.
    const uint32_t d0 = umin1((lo & w.x) | (hi & w.z));
    const uint32_t d1 = umin1((lo & w.y) | (hi & w.w));
    const uint32_t d = d0 + (d1 << 1);
    // The predecessor 4a + d: x (bit 2a) squared has bit 4a of 64 alone.
    const uint32_t x = (uint32_t)sq | sq_hi;
    const uint64_t x2 = (uint64_t)x * x;
    lo = (uint32_t)x2 << d;  // no bit crosses a half: 4(a & 7) + d < 32
    hi = (uint32_t)(x2 >> 32) << d;
  }
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
traceback4_onehot64_kernel(const uint32_t* __restrict__ dec,
                           uint8_t* __restrict__ bits, int B, int T2) {
  __shared__ uint4 dec_s[kLanesPerBlock][kChunk];
  const int warp = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const int lane = blockIdx.x * kLanesPerBlock + warp;
  if (lane >= B || T2 <= 0) return;  // warp-uniform
  const uint4* dl =
      reinterpret_cast<const uint4*>(dec + (size_t)lane * T2 * 4);
  uint16_t* bl = reinterpret_cast<uint16_t*>(bits + (size_t)lane * 2 * T2);

  const int top = ((T2 - 1) / kChunk) * kChunk;  // the highest chunk
  uint4 next = make_uint4(0u, 0u, 0u, 0u);
  if (top + j < T2) next = dl[top + j];
  uint32_t lo = 1u, hi = 0u;  // the one-hot of state 0
  for (int base = top; base >= 0; base -= kChunk) {
    __syncwarp();
    dec_s[warp][j] = next;
    __syncwarp();
    if (base > 0) next = dl[base - kChunk + j];  // the chunk below, in flight
    const int n = min(kChunk, T2 - base);
    uint32_t u1 = 0u, u2 = 0u;
    if (n == kChunk)
      onehot64_walk<true>(dec_s[warp], n, lo, hi, u1, u2);
    else
      onehot64_walk<false>(dec_s[warp], n, lo, hi, u1, u2);
    if (j < n) bl[base + j] = (uint16_t)(((u1 >> j) & 1u) |
                                         (((u2 >> j) & 1u) << 8));
  }
}

}  // namespace

// C interface, loaded with ctypes (dabtools_tpu_torch/ops/viterbi_cuda.py).
// Every entry point launches on the caller's stream, on the current device
// (the wrapper selects it through PyTorch), does not synchronise, and
// returns cudaGetLastError() (0 on success).

extern "C" int dab_acs4(const float* soft, const int* t2, const float* ws4,
                        uint32_t* dec, float* metric, int B, int T2,
                        void* stream) {
  if (B > 0)
    acs4_kernel<<<(B + kLanesPerBlock - 1) / kLanesPerBlock,
                  32 * kLanesPerBlock, 0, (cudaStream_t)stream>>>(
        soft, t2, ws4, dec, metric, B, T2);
  return (int)cudaGetLastError();
}

extern "C" int dab_traceback4(const uint32_t* dec, uint8_t* bits, int B,
                              int T2, void* stream) {
  if (B > 0)
    traceback4_kernel<<<(B + kLanesPerBlock - 1) / kLanesPerBlock,
                        32 * kLanesPerBlock, 0, (cudaStream_t)stream>>>(
        dec, bits, B, T2);
  return (int)cudaGetLastError();
}

extern "C" int dab_traceback4_onehot64(const uint32_t* dec, uint8_t* bits,
                                       int B, int T2, void* stream) {
  if (B > 0)
    traceback4_onehot64_kernel<<<(B + kLanesPerBlock - 1) / kLanesPerBlock,
                                 32 * kLanesPerBlock, 0,
                                 (cudaStream_t)stream>>>(dec, bits, B, T2);
  return (int)cudaGetLastError();
}
