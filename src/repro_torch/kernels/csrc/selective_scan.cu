// Fused selective scan (the Mamba-1 recurrence and its output contraction)
// for Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// selective_scan_kernel replaces the reference package's Pallas kernel
//   src/repro/kernels/selective_scan.py  selective_scan              (K8)
// and computes, for every (b, d, n) and t = 0 .. S-1,
//   h_t[b, d, n] = da[b, t, d, n] * h_{t-1}[b, d, n] + dbu[b, t, d, n]
//   y[b, t, d]   = sum_n h_t[b, d, n] * cm[b, t, n]
// from h_{-1} = h0 (zeros when h0 is null), and writes h_{S-1} to h_last
// when it is not null: the chunk carry of models/mamba.py's mamba_mix.
//
// What bounds it on an H100: it reads da and dbu (8 bytes per (t, d, n))
// and does 4 flops on them (a multiply and an add for h, a multiply and an
// add for y), so it is bytes-bound by two orders of magnitude. At the
// prefill chunk (B, S, D, N) = (1, 128, 8192, 16) it moves 139.5 MB, about
// 0.042 ms at 3.35 TB/s. The design keeps that floor in reach:
//   * one thread per (b, d, n) with h in a register for the whole S loop,
//     so the state never leaves the SM (the TPU kernel kept it in VMEM
//     scratch across sequential grid steps; here blocks run in no order, so
//     S is a loop inside the thread and the parallelism is over (b, d, n));
//   * N lanes per d: at each t a warp reads 128 contiguous bytes of da and
//     of dbu, and a block of 256 threads 1 KiB of each;
//   * loads of kUnroll steps are issued before the dependent chain, so each
//     thread keeps 2 * kUnroll loads in flight;
//   * y is reduced over n with __shfl_xor_sync inside the N-lane group and
//     lane 0 of the group stores it; cm[b, t, n] is read per lane (the same
//     N floats for every d of a block, served from L1).
// h is updated with __fmul_rn / __fadd_rn, not a contracted FMA, so the
// state matches the plain torch version (a multiply, then an add) bit for
// bit; y differs from it only by the order of the sum over n.
//
// The TPU block sizes (bs, bd) have no counterpart: the launch shape is
// fixed here. N is a power of two up to 32 (a group of lanes inside one
// warp); the wrapper rejects anything else. Offsets are size_t: one call at
// B = 1, S = 32768, D = 8192, N = 16 holds 4.3e9 elements of da.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block: 256 / N channels
constexpr int kUnroll = 8;     // time steps whose loads are issued together
constexpr int kMaxBatch = 65535;  // gridDim.y

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ da, const float* __restrict__ dbu,
                      const float* __restrict__ cm, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_last, int S,
                      int D) {
  const int n = threadIdx.x % N;
  const int d = blockIdx.x * (kThreads / N) + threadIdx.x / N;
  const size_t b = blockIdx.y;
  const bool live = d < D;  // the ragged last block keeps its lanes in the shuffles
  const size_t dn = static_cast<size_t>(D) * N;
  const size_t state = (b * D + (live ? d : 0)) * N + n;
  const size_t step0 = b * static_cast<size_t>(S) * dn + static_cast<size_t>(live ? d : 0) * N + n;
  const float* c_b = cm + b * static_cast<size_t>(S) * N + n;
  float* y_b = y + b * static_cast<size_t>(S) * D + (live ? d : 0);

  float h = (live && h0 != nullptr) ? h0[state] : 0.0f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float a[kUnroll], u[kUnroll], c[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 + i;
      const bool in = live && t < S;
      const size_t off = step0 + static_cast<size_t>(t) * dn;
      a[i] = in ? __ldg(da + off) : 1.0f;
      u[i] = in ? __ldg(dbu + off) : 0.0f;
      c[i] = t < S ? __ldg(c_b + static_cast<size_t>(t) * N) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 + i;
      if (t < S) {  // uniform over the block: every lane shuffles
        h = __fadd_rn(__fmul_rn(a[i], h), u[i]);
        float p = h * c[i];
#pragma unroll
        for (int off = N / 2; off > 0; off /= 2) {
          p += __shfl_xor_sync(0xffffffffu, p, off, N);
        }
        if (live && n == 0) y_b[static_cast<size_t>(t) * D] = p;
      }
    }
  }
  if (live && h_last != nullptr) h_last[state] = h;
}

template <int N>
void launch_n(dim3 grid, cudaStream_t stream, const float* da, const float* dbu,
              const float* cm, const float* h0, float* y, float* h_last, int S, int D) {
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(da, dbu, cm, h0, y, h_last, S, D);
}

}  // namespace

extern "C" {

// da, dbu (B, S, D, N) f32; cm (B, S, N) f32; h0 (B, D, N) f32 or null;
// y (B, S, D) f32; h_last (B, D, N) f32 or null. Returns cudaGetLastError().
int selective_scan(const void* da, const void* dbu, const void* cm, const void* h0,
                   void* y, void* h_last, int B, int S, int D, int N, void* stream) {
  if (B <= 0 || B > kMaxBatch || S <= 0 || D <= 0 || N <= 0 || N > 32 || (N & (N - 1))) {
    return cudaErrorInvalidValue;
  }
  const int per_block = kThreads / N;
  const dim3 grid((D + per_block - 1) / per_block, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(da);
  const auto* u = static_cast<const float*>(dbu);
  const auto* c = static_cast<const float*>(cm);
  const auto* h = static_cast<const float*>(h0);
  auto* out = static_cast<float*>(y);
  auto* last = static_cast<float*>(h_last);
  switch (N) {
    case 1: launch_n<1>(grid, s, a, u, c, h, out, last, S, D); break;
    case 2: launch_n<2>(grid, s, a, u, c, h, out, last, S, D); break;
    case 4: launch_n<4>(grid, s, a, u, c, h, out, last, S, D); break;
    case 8: launch_n<8>(grid, s, a, u, c, h, out, last, S, D); break;
    case 16: launch_n<16>(grid, s, a, u, c, h, out, last, S, D); break;
    default: launch_n<32>(grid, s, a, u, c, h, out, last, S, D); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
