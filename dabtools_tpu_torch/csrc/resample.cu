// Rational-rate polyphase resampler on Hopper: every output of one call of
// dabtools_tpu_torch/ops/resample.py::Resampler, its window indices and its
// filter, in one kernel.
//
// It replaces no Pallas kernel: the JAX resampler
// (dabtools_tpu/ops/resample.py) is plain jnp, a gather of (n_out, T)
// windows from host-built int64 phases and window starts, then two sums.
// The plain PyTorch version that computes the same values is
// dabtools_tpu_torch/ops/resample.py::resample_plain.
//
// Semantics.  The input is v = tail ++ x: the T - 1 samples kept from the
// last call, then the call's new samples.  Output i of the call has
// t = r0 + i*M, window start s = s0 + t / L and phase p = t % L, where the
// host forms r0 = (n0*M) % L and s0 from exact integers (n0 is the global
// index of the call's first output), and
//   y[i] = sum_{j = 0 .. T-1} bank[p][j] * v[s + T - 1 - j]
// in float32, the real and imaginary parts with the same taps, j in order,
// one fused multiply-add per tap (the plain version's torch.sum adds in
// another order: the two agree to float32 rounding, not bit for bit).
//
// What bounds it.  At 2.4 -> 2.048 Msps (L/M = 64/75, T = 24) an 8-frame
// hand-over is 1,843,200 new inputs and 1,572,864 outputs: 14.75 MB read
// and 12.58 MB written, 8.2 us at 3.35 TB/s, against 37.7 M taps, 75.5 M
// multiply-adds (151 M float operations, 2.3 us at 67 TFLOP/s).  Bytes
// bound it, so the design reads each input from HBM about once and writes
// each output once, and materialises nothing the size of the (n_out, T)
// window or tap tensors:
//   * a block takes opb consecutive outputs (ops/resample.py's
//     OUTS_PER_BLOCK, 1024: at the main path's shape on an H100 SXM,
//     1024 to 4096 took 31.4 us, 512 33.4 and 256 36.5); their windows
//     cover (rb + (opb - 1)*M) / L + T inputs, 1,224 at 64/75, which the
//     block stages in shared memory with coalesced 8-byte loads, from the tail
//     or from x as the index falls.  Neighbouring blocks overlap by T - 1
//     inputs, so HBM reads 1 + 23/1224 of the input;
//   * the bank, L x T float32 (6 KB at L = 64, 48 KB at L = 512), is
//     staged in shared memory too, in rows of odd stride, so that the
//     different phases of a warp's outputs fall in different banks;
//   * thread o of a block computes outputs o, o + 256, ...: consecutive
//     threads write consecutive float2, one coalesced store per output.
// Index arithmetic: a block's first t is formed in 64 bits once; inside the
// block t - t_b = rb + o*M fits 32 bits (the host checks (opb - 1)*M + L <
// 2^31), so each output takes one 32-bit division by L.
// What holds it at 3.8x the bound (31.4 us): each output reads its T taps
// and T window samples from shared memory, 288 bytes at T = 24, about
// 15 us of the SMs' shared-memory bandwidth at this shape.  Reusing window
// samples in registers across neighbouring outputs would cut that.
// Built without --use_fast_math: no reassociation, no flush to zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    resample_kernel(const float2* __restrict__ tail,
                    const float2* __restrict__ x,
                    const float* __restrict__ bank, float2* __restrict__ y,
                    long long r0, long long s0, int n_out, int M, int L,
                    int T, int opb) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int stride = T | 1;  // odd row stride of the staged bank
  float* bank_s = reinterpret_cast<float*>(smem);
  float2* span_s =
      reinterpret_cast<float2*>(smem + ((L * stride * 4 + 7) & ~7));
  const int keep = T - 1;
  const int i0 = blockIdx.x * opb;
  const int n_here = min(opb, n_out - i0);
  const long long tb = r0 + (long long)i0 * M;
  const long long qb = tb / L;
  const int rb = (int)(tb - qb * L);
  const int first = (int)(s0 + qb);  // v index of the block's first window
  const int span = (rb + (n_here - 1) * M) / L + T;

  for (int k = threadIdx.x; k < L * T; k += kThreads) {
    const int p = k / T;
    bank_s[p * stride + (k - p * T)] = bank[k];
  }
  for (int k = threadIdx.x; k < span; k += kThreads) {
    const int v = first + k;
    span_s[k] = v < keep ? tail[v] : x[v - keep];
  }
  __syncthreads();

  for (int o = threadIdx.x; o < n_here; o += kThreads) {
    const int tl = rb + o * M;
    const int st = tl / L;
    const float* w = bank_s + (tl - st * L) * stride;
    const float2* win = span_s + st + keep;
    float re = 0.f, im = 0.f;
#pragma unroll 8
    for (int j = 0; j < T; ++j) {
      const float wj = w[j];
      const float2 s = win[-j];
      re = fmaf(wj, s.x, re);
      im = fmaf(wj, s.y, im);
    }
    y[i0 + o] = make_float2(re, im);
  }
}

}  // namespace

extern "C" int dab_resample(const float2* tail, const float2* x,
                            const float* bank, float2* y, long long r0,
                            long long s0, int n_out, int M, int L, int T,
                            int opb, int smem_bytes, void* stream) {
  if (n_out > 0) {
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    resample_kernel<<<(n_out + opb - 1) / opb, kThreads, smem_bytes,
                      (cudaStream_t)stream>>>(tail, x, bank, y, r0, s0,
                                              n_out, M, L, T, opb);
  }
  return (int)cudaGetLastError();
}
