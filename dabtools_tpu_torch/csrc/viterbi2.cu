// Radix-2 soft-decision Viterbi for the DAB K=7 rate-1/4 code on Hopper:
// the decode of odd trellis lengths, which radix-4 cannot pair up.
//
// K3 acs2_kernel replaces dabtools_tpu/ops/viterbi_pallas.py:41
// _acs_kernel (launched at viterbi_decode_pallas, viterbi_pallas.py:157);
// K4 traceback2_kernel replaces :103 _traceback_kernel (launched at :183).
// The plain PyTorch versions that compute the same values are
// dabtools_tpu_torch/ops/viterbi.py::acs2_plain and ::traceback2_plain.
//
// What bounds them on the card.  Both are sequential recursions over the
// T steps of a codeword (3079 at 3073 information bits), so the chain of
// dependent steps, not bandwidth or arithmetic, sets their time: at 640
// lanes x 3079 steps K3 reads 31.5 MB of soft bits and writes 15.8 MB of
// decisions, which HBM moves in ~0.014 ms, and K4 reads one 4-byte word
// a step.  What counts is each step's dependent chain and the
// instructions each step issues.  One codeword alone is bound by its
// chain (tools/torch_viterbi4_probe.py times 1 lane against many); past
// the card's 528 warp schedulers (132 SMs x 4) some scheduler holds two
// codewords and issues both their steps.  So the design keeps loads,
// shared memory and barriers off the per-step chain and cuts the
// instructions per step, as viterbi4.cu does for K1/K2.
//
// K3 design: one warp per codeword, two per 64-thread block, path metrics
// in registers.  Both targets of thread j, j and 32 + j, have the
// predecessors 2j and 2j + 1 (mod 64).  Thread j holds them as x and y:
// states j and 32 + j, swapped if j is odd.  Then state 2j lives in
// thread 2(j & 15) as x if j < 16 (y if not), and state 2j + 1 in thread
// 2(j & 15) + 1 as y if j < 16 (x if not), so one shuffle of x from thread
// 2(j & 15) + h and one of y from thread 2(j & 15) + 1 - h (h = j >> 4)
// bring both predecessors, r1 and r2, with no select: r1 = pm[2j] and r2 =
// pm[2j + 1] if h is 0, the other way round if h is 1.  Branch metrics
// fold by sign: all four DAB generator polynomials tap the newest and the
// oldest register bit, so WS rows 32 + c and 64 + c are row c negated and
// row 96 + c is row c (tests/test_torch_viterbi.py::
// test_warp_radix2_branch_metric_signs pins this on WS).  With A the
// signed sum of row j, target j takes pm[2j] + A or pm[2j + 1] - A and
// target 32 + j takes pm[2j] - A or pm[2j + 1] + A.  Thread j sums row j's
// signs negated where h differs from j's parity, giving B = +/-A such
// that x' = max(r1 + B, r2 - B) and y' = max(r1 - B, r2 + B) are its new
// x and y in the same layout.  So a step's chain is a shuffle, an add and
// an fmaxf: two shuffles, four adds and two fmaxf per step, no shared
// memory and no barrier.  A warp issues in order, so the next step's
// shuffles come right after the fmaxf, before this step's decisions,
// which then fill the shuffles' latency.  A decision is whether the
// survivor differs from the even predecessor's candidate (a select and a
// compare); two __ballot_sync give x's and y's words, which thread 0
// stages, and each thread interleaves their even and odd bits into the
// words of targets j and 32 + j as it stores its step.  Thread j forms B
// for every step of a chunk before the chunk's walk, so the sums are off
// the chain too.  Soft bits come in chunks of kChunk = 32 steps (512 B a
// lane), one float4 per thread, coalesced; chunk k + 1 is loaded into
// registers while chunk k is walked from shared memory.  The decision
// words leave as one coalesced 256 B store per chunk (one uint2 per
// thread).  T need not be a multiple of kChunk.
//
// K4 design: one warp per codeword as well, walking a warp-uniform state.
// Chunks of kChunk steps of decision pairs are loaded coalesced (one
// uint2 per thread, 256 B), the chunk below while the current one is
// walked from shared memory with broadcast 8 B loads whose addresses do
// not depend on the state.  The state rides in the low 6 bits of h, and a
// step shifts its decision in without masking: h = (h << 1) | bit (h &
// 31) of the step's word, three dependent operations (a funnel shift,
// which wraps its count, and two logic ops), while bit 4 of h, the next
// state's bit 5, picks the next step's word beside them.  A state's bit 5
// is the decision of the step 6 above, so after a chunk thread i reads
// the bit of the chunk's step i from h (or from the chunk above's h), and
// the chunk's bits leave as one coalesced 32 B store.  Two lanes per
// block, as K3.
//
// Semantics that must match the plain version bit for bit:
//   * bm[r] = ((w0 s0 + w1 s1) + w2 s2) + w3 s3 with w = WS[r], summed
//     left to right (products are exact, +/-1 weights);
//   * target t: c0 = pm[2c] + bm[t], c1 = pm[2c+1] + bm[64+t];
//   * d = c1 > c0 (strict: a tie takes the lower predecessor), pm'[t] =
//     d ? c1 : c0;
//   * dec word w, bit j = d of state 32w + j; metric = final pm[0].
// Negating a row's signs negates its sum exactly (rounding to nearest is
// symmetric), but for the sign of an exact zero; adding either zero to a
// path metric gives the same candidate, since no path metric is -0 (a sum
// is -0 only if both terms are, and the first metrics are +0 and -1e30).
// So every candidate equals the plain version's.  fmaxf then gives the
// strict-'>' select's value, since no candidate is NaN or -0, and it
// returns one of its operands, so it differs from c0 iff c1 > c0: that is
// d.
// Built without --use_fast_math: no reassociation, no flush to zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kEven = 0x55555555u;  // ballot bits of the even threads
constexpr int kChunk = 32;               // steps per staged chunk
constexpr int kLanesPerBlock = 2;        // one warp per lane

// Signed sum of a step's 4 soft bits, left to right.
__device__ __forceinline__ float signed_sum(const float (&w)[4], float4 s) {
  return fmaf(w[3], s.w, fmaf(w[2], s.z, fmaf(w[1], s.y, w[0] * s.x)));
}

// Walk the first n (all kChunk if kFull) steps of a staged chunk; r1 and
// r2 enter as the first step's predecessors and leave as the next one's.
// Thread 0 stages each step's ballots of x and y as they come.
template <bool kFull>
__device__ __forceinline__ void acs2_walk(const float4* soft, uint2* dec,
                                          int n, const float (&w)[4], int j,
                                          int src1, int src2, bool hi,
                                          float& x, float& y, float& r1,
                                          float& r2) {
  // The chunk's signed sums first: they do not depend on the path metrics,
  // and formed inside a step their loads and 4-deep sums would sit on the
  // chain (the compiler issues a step's loads just before their use).
  float bq[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (!kFull && i >= n) break;
    bq[i] = signed_sum(w, soft[i]);
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (!kFull && i >= n) break;
    const float b = bq[i];
    const float x0 = r1 + b, x1 = r2 - b, y0 = r1 - b, y1 = r2 + b;
    x = fmaxf(x0, x1);
    y = fmaxf(y0, y1);
    // The next step's predecessors before this step's decisions: a warp
    // is issued in order, and shuffles and ballots keep their order, so
    // the compares and ballots below fill the shuffles' latency instead
    // of sitting on the chain.
    r1 = __shfl_sync(kAll, x, src1);
    r2 = __shfl_sync(kAll, y, src2);
    // The decision is "the odd predecessor's candidate won", and r1 is the
    // odd predecessor's metric iff hi: the survivor differs from the even
    // one's candidate (a tie keeps the even one's).
    const bool dx = x != (hi ? x1 : x0);
    const bool dy = y != (hi ? y1 : y0);
    const uint32_t wx = __ballot_sync(kAll, dx);
    const uint32_t wy = __ballot_sync(kAll, dy);
    if (j == 0) dec[i] = make_uint2(wx, wy);
  }
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
acs2_kernel(const float* __restrict__ soft, const float* __restrict__ ws2,
            uint32_t* __restrict__ dec, float* __restrict__ metric, int B,
            int T) {
  __shared__ float4 soft_s[kLanesPerBlock][kChunk];
  __shared__ uint2 dec_s[kLanesPerBlock][kChunk];
  const int warp = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const int lane = blockIdx.x * kLanesPerBlock + warp;
  if (lane >= B) return;  // warp-uniform: every lane is one whole warp

  // Row j of WS, negated iff h differs from j's parity (see above); the
  // kernel reads no other row.
  const bool hi = j >= 16;
  const float sign = (hi != ((j & 1) != 0)) ? -1.0f : 1.0f;
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = sign * ws2[j * 4 + k];
  const int src1 = 2 * (j & 15) + hi, src2 = 2 * (j & 15) + 1 - hi;
  const float4* s4 =
      reinterpret_cast<const float4*>(soft + (size_t)lane * T * 4);
  uint2* dl = reinterpret_cast<uint2*>(dec + (size_t)lane * T * 2);

  float x = (j == 0) ? 0.0f : kNegInf, y = kNegInf;
  float r1 = __shfl_sync(kAll, x, src1), r2 = __shfl_sync(kAll, y, src2);
  float4 nxt = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < T) nxt = s4[j];
  for (int base = 0; base < T; base += kChunk) {
    __syncwarp();
    soft_s[warp][j] = nxt;
    __syncwarp();
    const int g = base + kChunk + j;  // the next chunk, in flight
    if (g < T) nxt = s4[g];
    const int n = min(kChunk, T - base);
    if (n == kChunk)
      acs2_walk<true>(soft_s[warp], dec_s[warp], n, w, j, src1, src2, hi, x,
                      y, r1, r2);
    else
      acs2_walk<false>(soft_s[warp], dec_s[warp], n, w, j, src1, src2, hi, x,
                       y, r1, r2);
    __syncwarp();
    if (j < n) {
      // x holds target j on even threads and target 32 + j on odd ones:
      // interleave the two ballots' bits into the words of targets j and
      // 32 + j.
      const uint2 b = dec_s[warp][j];
      dl[base + j] = make_uint2((b.x & kEven) | (b.y & ~kEven),
                                (b.y & kEven) | (b.x & ~kEven));
    }
  }
  if (j == 0) metric[lane] = x;  // thread 0's x is state 0
}

// Walk the staged chunk's steps n-1 .. 0 (kChunk-1 .. 0 if kFull).  h
// enters with the state of the chunk's top step in its low 6 bits (the
// decisions above it, unmasked, in its higher bits) and leaves with the
// chunk's decisions shifted in: bit k = the decision of the chunk's step k.
template <bool kFull>
__device__ __forceinline__ void traceback2_walk(const uint2* words, int n,
                                                uint32_t& h) {
  const uint2 top = words[kFull ? kChunk - 1 : n - 1];
  uint32_t word = (h & 32) ? top.y : top.x;
#pragma unroll
  for (int i = kChunk - 1; i >= 0; --i) {
    if (!kFull && i >= n) continue;
    uint32_t next = 0;
    if (i > 0) {
      // Broadcast load; bit 4 of h becomes bit 5 of the next state, so
      // the next step's word is picked beside this step's chain.
      const uint2 w = words[i - 1];
      next = (h & 16) ? w.y : w.x;
    }
    // Bit h & 31 of the word (a funnel shift wraps its count mod 32).
    h = (h << 1) | (__funnelshift_r(word, word, h) & 1u);
    word = next;
  }
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
traceback2_kernel(const uint32_t* __restrict__ dec,
                  uint8_t* __restrict__ bits, int B, int T) {
  __shared__ uint2 dec_s[kLanesPerBlock][kChunk];
  const int warp = threadIdx.x >> 5;
  const int j = threadIdx.x & 31;
  const int lane = blockIdx.x * kLanesPerBlock + warp;
  if (lane >= B || T <= 0) return;  // warp-uniform
  const uint2* dl = reinterpret_cast<const uint2*>(dec + (size_t)lane * T * 2);
  uint8_t* bl = bits + (size_t)lane * T;

  const int top = ((T - 1) / kChunk) * kChunk;  // the highest chunk
  uint2 next = make_uint2(0u, 0u);
  if (top + j < T) next = dl[top + j];
  uint32_t h = 0, above = 0;  // the walk starts in state 0
  for (int base = top; base >= 0; base -= kChunk) {
    __syncwarp();
    dec_s[warp][j] = next;
    __syncwarp();
    if (base > 0) next = dl[base - kChunk + j];  // the chunk below, in flight
    const int n = min(kChunk, T - base);
    if (n == kChunk)
      traceback2_walk<true>(dec_s[warp], n, h);
    else
      traceback2_walk<false>(dec_s[warp], n, h);
    // Step g's bit is bit 5 of its state: the decision of step g + 6, in
    // h or, past the chunk's top, in the chunk above's (0 past T).
    const int k = j + 6;
    const uint32_t bit = (k < kChunk ? h >> k : above >> (k - kChunk)) & 1u;
    if (j < n) bl[base + j] = (uint8_t)bit;
    above = h;
  }
}

}  // namespace

// C interface, loaded with ctypes (dabtools_tpu_torch/ops/viterbi_cuda.py).
// Every entry point launches on the caller's stream, on the current device
// (the wrapper selects it through PyTorch), does not synchronise, and
// returns cudaGetLastError() (0 on success).

extern "C" int dab_acs2(const float* soft, const float* ws2, uint32_t* dec,
                        float* metric, int B, int T, void* stream) {
  if (B > 0)
    acs2_kernel<<<(B + kLanesPerBlock - 1) / kLanesPerBlock,
                  32 * kLanesPerBlock, 0, (cudaStream_t)stream>>>(
        soft, ws2, dec, metric, B, T);
  return (int)cudaGetLastError();
}

extern "C" int dab_traceback2(const uint32_t* dec, uint8_t* bits, int B,
                              int T, void* stream) {
  if (B > 0)
    traceback2_kernel<<<(B + kLanesPerBlock - 1) / kLanesPerBlock,
                        32 * kLanesPerBlock, 0, (cudaStream_t)stream>>>(
        dec, bits, B, T);
  return (int)cudaGetLastError();
}
