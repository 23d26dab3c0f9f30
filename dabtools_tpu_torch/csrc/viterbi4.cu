// Radix-4 soft-decision Viterbi for the DAB K=7 rate-1/4 code on Hopper.
//
// K1 acs4_kernel replaces dabtools_tpu/ops/viterbi_pallas4.py::_acs4_kernel
// (launched at _decode4_call, viterbi_pallas4.py:351); K2
// traceback4_kernel replaces ::_traceback4_kernel (launched at :389); K2'
// traceback4_onehot64_kernel replaces ::_traceback4_kernel_onehot64 (the
// same launch with traceback="onehot64").  Only the TPU kernel's default
// ACS semantics are built (select=shuffle, pack=shift4, bm=f32); the
// plain PyTorch versions that compute the same values are
// dabtools_tpu_torch/ops/viterbi.py::acs4_plain and ::traceback4_plain
// (for K2 and K2' alike: the two compute one function).
//
// What bounds them on the card.  Both are sequential recursions over the
// double steps of a codeword (1539 at the flagship's 3078-step MSC
// codewords), so latency, not bandwidth or arithmetic, sets their time: at
// the flagship shape K1 moves 31.5 MB of soft bits in and 15.8 MB of
// decisions out, and does ~50 flops per state per step.  Each step of K1
// is one dependent chain: load 8 soft bits, form 4 branch metrics, 4 adds,
// a 4-way select, one barrier.  K2 is one dependent load per step.
//
// What the design does about it.  K1 runs one 64-thread block per lane
// (codeword), one thread per target state, so all 640 lanes of a flagship
// block are resident at once (132 SMs) and the card runs every lane's
// chain side by side.  Path metrics live double-buffered in shared memory
// (one barrier per step), the 32 +/-1 branch-metric signs of a thread sit
// in registers, and the next step's soft bits are loaded before the
// current step's select so the load latency overlaps the arithmetic.
// Decisions leave as two __ballot_sync words per warp per step.  K2 runs
// one thread per lane walking an integer state: the TPU kernel's factored
// one-hot carry existed only to avoid scalar work on the TPU's vector
// unit.  K2' keeps the one-hot64 kernel's idea: the survivor state is a
// 64-wide one-hot spread over one warp per lane, two states per thread
// (j and 32 + j); warp votes read the active state's input bits and
// 2-bit decision where the TPU kernel multiplied and reduced over
// sublanes, and two shuffles move the one-hot to the predecessor.  It does
// more work per step than K2 and is expected to be slower.  Faster
// layouts (warp-shuffle ACS, coalesced decision tiles) are later work.
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

__global__ void __launch_bounds__(64)
acs4_kernel(const float* __restrict__ soft, const int* __restrict__ t2,
            const float* __restrict__ ws4, uint32_t* __restrict__ dec,
            float* __restrict__ metric, int T2) {
  const int lane = blockIdx.x;
  const int t = threadIdx.x;  // target state
  __shared__ float pm[2][64];

  float w[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) w[p][k] = ws4[(p * 64 + t) * 8 + k];
  const int pred0 = 4 * (t & 15);
  const int word = 2 * (t >> 5);
  const int len = t2[lane];
  const float4* s4 =
      reinterpret_cast<const float4*>(soft + (size_t)lane * T2 * 8);
  uint32_t* dl = dec + (size_t)lane * T2 * 4;

  pm[0][t] = (t == 0) ? 0.0f : kNegInf;
  __syncthreads();

  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (T2 > 0) {
    a = s4[0];
    b = s4[1];
  }
  int cur = 0;
  for (int g = 0; g < T2; ++g) {
    float4 na = a, nb = b;
    if (g + 1 < T2) {
      na = s4[2 * g + 2];
      nb = s4[2 * g + 3];
    }
    const float s[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float c[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float step1 = w[p][0] * s[0];
      float step2 = w[p][4] * s[4];
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        step1 += w[p][k] * s[k];
        step2 += w[p][4 + k] * s[4 + k];
      }
      c[p] = pm[cur][pred0 + p] + (step1 + step2);
    }
    const bool d01 = c[1] > c[0];
    const float m01 = d01 ? c[1] : c[0];
    const bool d23 = c[3] > c[2];
    const float m23 = d23 ? c[3] : c[2];
    const bool hi = m23 > m01;
    float nw = hi ? m23 : m01;
    int d = hi ? 2 + (int)d23 : (int)d01;
    if (g >= len) {  // dead step: freeze, record 0
      nw = pm[cur][t];
      d = 0;
    }
    pm[cur ^ 1][t] = nw;
    const uint32_t b0 = __ballot_sync(0xffffffffu, d & 1);
    const uint32_t b1 = __ballot_sync(0xffffffffu, d >> 1);
    if ((t & 31) == 0) {
      dl[4 * g + word] = b0;
      dl[4 * g + word + 1] = b1;
    }
    __syncthreads();
    cur ^= 1;
    a = na;
    b = nb;
  }
  if (t == 0) metric[lane] = pm[cur][0];
}

__global__ void traceback4_kernel(const uint32_t* __restrict__ dec,
                                  uint8_t* __restrict__ bits, int B,
                                  int T2) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const uint4* dl = reinterpret_cast<const uint4*>(dec + (size_t)lane * T2 * 4);
  uint8_t* bl = bits + (size_t)lane * 2 * T2;
  int s = 0;
  for (int g = T2 - 1; g >= 0; --g) {
    const uint4 w = dl[g];
    bl[2 * g] = (uint8_t)((s >> 4) & 1);
    bl[2 * g + 1] = (uint8_t)((s >> 5) & 1);
    const uint32_t lo = (s >> 5) ? w.z : w.x;
    const uint32_t hi = (s >> 5) ? w.w : w.y;
    const int j = s & 31;
    const int d = (int)((lo >> j) & 1u) | ((int)((hi >> j) & 1u) << 1);
    s = 4 * (s & 15) + d;
  }
}

__global__ void __launch_bounds__(128)
traceback4_onehot64_kernel(const uint32_t* __restrict__ dec,
                           uint8_t* __restrict__ bits, int B, int T2) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int j = threadIdx.x & 31;
  if (lane >= B) return;  // warp-uniform: every lane is one whole warp
  const uint4* dl =
      reinterpret_cast<const uint4*>(dec + (size_t)lane * T2 * 4);
  uint8_t* bl = bits + (size_t)lane * 2 * T2;
  // One-hot carry: lo = state j is the survivor, hi = state 32 + j is.
  int lo = (j == 0), hi = 0;
  for (int g = T2 - 1; g >= 0; --g) {
    const uint4 w = dl[g];  // one address for the whole warp: a broadcast
    const uint32_t d_lo = ((w.x >> j) & 1u) | (((w.y >> j) & 1u) << 1);
    const uint32_t d_hi = ((w.z >> j) & 1u) | (((w.w >> j) & 1u) << 1);
    const uint32_t d_own = lo ? d_lo : (hi ? d_hi : 0u);
    // Votes over the one-hot: bit 5 of the state, bit 4, the decision.
    const int u2 = __any_sync(kAll, hi);
    const int u1 = __any_sync(kAll, (lo | hi) && (j & 16));
    const int d =
        __any_sync(kAll, d_own & 1u) | (__any_sync(kAll, d_own & 2u) << 1);
    if (j == 0) {
      bl[2 * g] = (uint8_t)u1;
      bl[2 * g + 1] = (uint8_t)u2;
    }
    // Fold away u1, u2: thread k then holds the one-hot of a = k & 15.
    int f = lo | hi;
    f |= __shfl_xor_sync(kAll, f, 16);
    // Predecessor 4a + d: state j has a = j >> 2, state 32 + j has
    // a = 8 + (j >> 2); both have p = j & 3.
    const int take = (j & 3) == d;
    const int a_lo = __shfl_sync(kAll, f, j >> 2);
    const int a_hi = __shfl_sync(kAll, f, 8 + (j >> 2));
    lo = take & a_lo;
    hi = take & a_hi;
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
    acs4_kernel<<<B, 64, 0, (cudaStream_t)stream>>>(soft, t2, ws4, dec,
                                                    metric, T2);
  return (int)cudaGetLastError();
}

extern "C" int dab_traceback4(const uint32_t* dec, uint8_t* bits, int B,
                              int T2, void* stream) {
  const int threads = 128;
  if (B > 0)
    traceback4_kernel<<<(B + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(dec, bits, B, T2);
  return (int)cudaGetLastError();
}

extern "C" int dab_traceback4_onehot64(const uint32_t* dec, uint8_t* bits,
                                       int B, int T2, void* stream) {
  const int lanes_per_block = 4;  // one warp per lane
  if (B > 0)
    traceback4_onehot64_kernel<<<(B + lanes_per_block - 1) / lanes_per_block,
                                 32 * lanes_per_block, 0,
                                 (cudaStream_t)stream>>>(dec, bits, B, T2);
  return (int)cudaGetLastError();
}
