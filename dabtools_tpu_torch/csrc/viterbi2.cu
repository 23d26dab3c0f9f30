// Radix-2 soft-decision Viterbi for the DAB K=7 rate-1/4 code on Hopper:
// the decode of odd trellis lengths, which radix-4 cannot pair up.
//
// K3 acs2_kernel replaces dabtools_tpu/ops/viterbi_pallas.py::_acs_kernel
// (launched at viterbi_decode_pallas, viterbi_pallas.py:157); K4
// traceback2_kernel replaces ::_traceback_kernel (launched at :183).  The
// plain PyTorch versions that compute the same values are
// dabtools_tpu_torch/ops/viterbi.py::acs2_plain and ::traceback2_plain.
//
// What bounds them on the card.  Both are sequential recursions over the
// T steps of a codeword (3079 at 3073 information bits), so the chain of
// dependent steps, not bandwidth or arithmetic, sets their time: at 640
// lanes x 3079 steps K3 reads 31.5 MB of soft bits and writes 15.8 MB of
// decisions, and does ~220 flops per lane-step.  Each step of K3 is one
// dependent chain: 2 branch metrics, 2 adds, a compare, one barrier.  K4
// is one dependent load per step.
//
// What the design does about it.  As K1: one 64-thread block per lane,
// one thread per target state t = u*32 + c, so every lane's chain runs
// side by side.  The thread's 8 branch-metric signs (rows t and 64 + t of
// WS, the TPU kernel's target-major operator) sit in registers, path
// metrics are double-buffered in shared memory (one barrier per step), the
// next step's soft bits are loaded before the current step's select, and
// each warp's 32 decisions leave as one __ballot_sync word, the TPU
// kernel's bit packing (viterbi_pallas.py:84-87).  K4 walks an integer
// state, one thread per lane, reading one 8-byte decision pair per step;
// the TPU kernel's one-hot carry existed for its vector unit.
//
// Semantics that must match the plain version bit for bit:
//   * bm[r] = ((w0 s0 + w1 s1) + w2 s2) + w3 s3 with w = WS[r], summed
//     left to right (products are exact, +/-1 weights);
//   * target t: c0 = pm[2c] + bm[t], c1 = pm[2c+1] + bm[64+t];
//   * d = c1 > c0 (strict: a tie takes the lower predecessor), pm'[t] =
//     d ? c1 : c0;
//   * dec word w, bit j = d of state 32w + j; metric = final pm[0].
// Built without --use_fast_math: no reassociation, no flush to zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float signed_sum4(const float w[4], float4 s) {
  float acc = w[0] * s.x;
  acc += w[1] * s.y;
  acc += w[2] * s.z;
  acc += w[3] * s.w;
  return acc;
}

__global__ void __launch_bounds__(64)
acs2_kernel(const float* __restrict__ soft, const float* __restrict__ ws2,
            uint32_t* __restrict__ dec, float* __restrict__ metric, int T) {
  const int lane = blockIdx.x;
  const int t = threadIdx.x;  // target state u*32 + c
  const int c = t & 31;
  __shared__ float pm[2][64];

  float w0[4], w1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w0[k] = ws2[t * 4 + k];
    w1[k] = ws2[(64 + t) * 4 + k];
  }
  const float4* s4 =
      reinterpret_cast<const float4*>(soft + (size_t)lane * T * 4);
  uint32_t* dl = dec + (size_t)lane * T * 2;

  pm[0][t] = (t == 0) ? 0.0f : kNegInf;
  __syncthreads();

  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (T > 0) s = s4[0];
  int cur = 0;
  for (int g = 0; g < T; ++g) {
    const float4 ns = (g + 1 < T) ? s4[g + 1] : s;
    const float c0 = pm[cur][2 * c] + signed_sum4(w0, s);
    const float c1 = pm[cur][2 * c + 1] + signed_sum4(w1, s);
    const bool d = c1 > c0;
    pm[cur ^ 1][t] = d ? c1 : c0;
    const uint32_t word = __ballot_sync(0xffffffffu, d);
    if (c == 0) dl[2 * g + (t >> 5)] = word;
    __syncthreads();
    cur ^= 1;
    s = ns;
  }
  if (t == 0) metric[lane] = pm[cur][0];
}

__global__ void traceback2_kernel(const uint32_t* __restrict__ dec,
                                  uint8_t* __restrict__ bits, int B, int T) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const uint2* dl =
      reinterpret_cast<const uint2*>(dec + (size_t)lane * T * 2);
  uint8_t* bl = bits + (size_t)lane * T;
  int s = 0;
  for (int g = T - 1; g >= 0; --g) {
    const uint2 w = dl[g];
    bl[g] = (uint8_t)(s >> 5);
    const uint32_t word = (s >> 5) ? w.y : w.x;
    s = 2 * (s & 31) + (int)((word >> (s & 31)) & 1u);
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
    acs2_kernel<<<B, 64, 0, (cudaStream_t)stream>>>(soft, ws2, dec, metric,
                                                    T);
  return (int)cudaGetLastError();
}

extern "C" int dab_traceback2(const uint32_t* dec, uint8_t* bits, int B,
                              int T, void* stream) {
  const int threads = 128;
  if (B > 0)
    traceback2_kernel<<<(B + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(dec, bits, B, T);
  return (int)cudaGetLastError();
}
