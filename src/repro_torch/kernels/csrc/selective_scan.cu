// Fused selective scan (the Mamba-1 recurrence and its output contraction)
// for Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Its two bodies replace the reference package's Pallas kernel
//   src/repro/kernels/selective_scan.py  selective_scan              (K8)
// and compute, for every (b, d, n) and t = 0 .. S-1,
//   h_t[b, d, n] = da[b, t, d, n] * h_{t-1}[b, d, n] + dbu[b, t, d, n]
//   y[b, t, d]   = sum_n h_t[b, d, n] * cm[b, t, n]
// from h_{-1} = h0 (zeros when h0 is null), and write h_{S-1} to h_last
// when it is not null: the chunk carry of models/mamba.py's mamba_mix.
//
// What bounds it on an H100: it reads da and dbu (8 bytes per (t, d, n))
// and does 4 flops on them (a multiply and an add for h, a multiply and an
// add for y), so it is bytes-bound by two orders of magnitude. The main
// path calls it at two shapes: the prefill chunk (B, S, D, N) = (1, 128,
// 8192, 16), 139.5 MB, about 0.042 ms at 3.35 TB/s, and the decode step
// (4, 1, 8192, 16), 8.5 MB (da, dbu and h0 read, h_last written), 2.54 us
// at 3.35 TB/s over a launch floor of about 1 us. The decode step asks that
// every load of the launch be issued at once, in one wave of threads.
//
// selective_scan_kernel_vec<N, U>, for N >= 4 and every S:
//   * one thread per (b, d, 4 values of n), h a float4 in registers for the
//     whole S loop, so the state never leaves the SM (the TPU kernel kept it
//     in VMEM scratch across sequential grid steps; here blocks run in no
//     order, so S is a loop inside the thread and the parallelism is over
//     (b, d, n / 4)). At the decode shape: 131,072 threads, 512 blocks of
//     256, all resident at once;
//   * N / 4 lanes per d: a warp's float4 loads of da, dbu and h0 read 512
//     contiguous bytes; cm is read as scalars (the same N floats for every
//     d, served from L1; it carries no alignment requirement);
//   * h0 and the da, dbu and cm of U steps are issued before the first
//     product; U = 1 at S = 1, so no register holds a padding step, and
//     U = kVecUnroll above;
//   * y reduced over the N / 4 lanes of a d with log2(N / 4) shuffles, lane
//     0 stores it; h_last written as float4.
// The wrapper checks that da, dbu and h0 are 16-byte aligned.
//
// selective_scan_kernel<N>, for N < 4 (no float4 row), the first design:
// one thread per (b, d, n), N lanes per d, loads of kUnroll steps issued
// together, y folded over the N lanes by shuffles.
//
// Measured (chip_smoke.py --scan-only, NVIDIA H100 80GB HBM3 at 700 W;
// device time by the profiler, warm = the same inputs every launch, cold =
// each launch the next of 200 MB of input sets; the first design, which
// served every N, in brackets): the decode step 2.33-2.36 us warm
// [8.57-9.96] over a 1.03 us launch floor, 4.06-4.08 us cold
// [10.34-10.54], 62% of its bound; the prefill chunk 51.5-51.8 us
// [52.5-52.6], 81%. ptxas: <16, 1> 36 registers, <16, 4> 85, no spill.
// The float4 body beat the first design at every S from 1 to 128 for B in
// {1, 4}, so it serves every S. U = 4 at S = 1 took 3.31-3.32 us, hence
// the one-step instance. Tried and not kept: 16 values of n per thread
// (3.85 us at the decode step), kVecUnroll = 8 (2.7% faster at the
// prefill chunk, 0.3-1.0 us slower at S = 2-8 and B = 4), 128-thread
// blocks (the same at both main-path shapes) and 64 (0.4 us slower at the
// decode step).
//
// Both bodies update h with __fmul_rn / __fadd_rn, not a contracted FMA,
// so the state matches the plain torch version (a multiply, then an add)
// bit for bit; y differs from it only by the order of the sum over n.
//
// The TPU block sizes (bs, bd) have no counterpart: the launch shape is
// fixed here. N is a power of two up to 32 (a group of lanes inside one
// warp); the wrapper rejects anything else. Offsets are size_t: one call at
// B = 1, S = 32768, D = 8192, N = 16 holds 4.3e9 elements of da.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBatch = 65535;  // gridDim.y
constexpr int kThreads = 256;  // scalar body: threads per block, 256 / N channels
constexpr int kUnroll = 8;     // scalar body: time steps whose loads are issued together
constexpr int kVecThreads = 256;  // float4 body: threads per block, 1024 / N channels
constexpr int kVecUnroll = 4;     // float4 body at S > 1: steps whose loads are issued together

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

__device__ __forceinline__ float4 step_h(float4 a, float4 h, float4 u) {
  return make_float4(__fadd_rn(__fmul_rn(a.x, h.x), u.x), __fadd_rn(__fmul_rn(a.y, h.y), u.y),
                     __fadd_rn(__fmul_rn(a.z, h.z), u.z), __fadd_rn(__fmul_rn(a.w, h.w), u.w));
}

template <int N, int U>
__global__ void __launch_bounds__(kVecThreads)
selective_scan_kernel_vec(const float4* __restrict__ da, const float4* __restrict__ dbu,
                          const float* __restrict__ cm, const float4* __restrict__ h0,
                          float* __restrict__ y, float4* __restrict__ h_last, int S, int D) {
  constexpr int kLanes = N / 4;  // lanes per channel d, one float4 of n each
  const int lane = threadIdx.x % kLanes;
  const int d = blockIdx.x * (kVecThreads / kLanes) + threadIdx.x / kLanes;
  const size_t b = blockIdx.y;
  const bool live = d < D;  // the ragged last block keeps its lanes in the shuffles
  const size_t slab = static_cast<size_t>(D) * kLanes;  // float4 per (b, t)
  const size_t row = (b * D + (live ? d : 0)) * kLanes + lane;
  const size_t step0 = b * static_cast<size_t>(S) * slab + static_cast<size_t>(live ? d : 0) * kLanes + lane;
  const float* c_b = cm + b * static_cast<size_t>(S) * N + 4 * lane;
  float* y_b = y + b * static_cast<size_t>(S) * D + (live ? d : 0);

  float4 h = (live && h0 != nullptr) ? __ldg(h0 + row) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = 0; t0 < S; t0 += U) {
    float4 a[U], u[U];
    float c[U][4];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t0 + i;
      const bool in = live && t < S;
      const size_t off = step0 + static_cast<size_t>(t) * slab;
      a[i] = in ? __ldg(da + off) : make_float4(1.f, 1.f, 1.f, 1.f);
      u[i] = in ? __ldg(dbu + off) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[i][k] = t < S ? __ldg(c_b + static_cast<size_t>(t) * N + k) : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t0 + i;
      if (t < S) {  // uniform over the block: every lane shuffles
        h = step_h(a[i], h, u[i]);
        float p = h.x * c[i][0] + h.y * c[i][1] + h.z * c[i][2] + h.w * c[i][3];
#pragma unroll
        for (int off = kLanes / 2; off > 0; off /= 2) {
          p += __shfl_xor_sync(0xffffffffu, p, off, kLanes);
        }
        if (live && lane == 0) y_b[static_cast<size_t>(t) * D] = p;
      }
    }
  }
  if (live && h_last != nullptr) h_last[row] = h;
}

template <int N>
void launch_n(int B, int S, int D, cudaStream_t stream, const float* da, const float* dbu,
              const float* cm, const float* h0, float* y, float* h_last) {
  if constexpr (N >= 4) {
    constexpr int per_block = kVecThreads / (N / 4);
    const dim3 grid((D + per_block - 1) / per_block, B);
    const auto* a = reinterpret_cast<const float4*>(da);
    const auto* u = reinterpret_cast<const float4*>(dbu);
    const auto* h = reinterpret_cast<const float4*>(h0);
    auto* last = reinterpret_cast<float4*>(h_last);
    if (S == 1) {
      selective_scan_kernel_vec<N, 1><<<grid, kVecThreads, 0, stream>>>(a, u, cm, h, y, last, S, D);
    } else {
      selective_scan_kernel_vec<N, kVecUnroll><<<grid, kVecThreads, 0, stream>>>(
          a, u, cm, h, y, last, S, D);
    }
  } else {
    constexpr int per_block = kThreads / N;
    const dim3 grid((D + per_block - 1) / per_block, B);
    selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(da, dbu, cm, h0, y, h_last, S, D);
  }
}

}  // namespace

extern "C" {

// da, dbu (B, S, D, N) f32; cm (B, S, N) f32; h0 (B, D, N) f32 or null;
// y (B, S, D) f32; h_last (B, D, N) f32 or null; for N >= 4, da, dbu, h0
// and h_last 16-byte aligned. Returns cudaGetLastError().
int selective_scan(const void* da, const void* dbu, const void* cm, const void* h0,
                   void* y, void* h_last, int B, int S, int D, int N, void* stream) {
  if (B <= 0 || B > kMaxBatch || S <= 0 || D <= 0 || N <= 0 || N > 32 || (N & (N - 1))) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(da);
  const auto* u = static_cast<const float*>(dbu);
  const auto* c = static_cast<const float*>(cm);
  const auto* h = static_cast<const float*>(h0);
  auto* out = static_cast<float*>(y);
  auto* last = static_cast<float*>(h_last);
  switch (N) {
    case 1: launch_n<1>(B, S, D, s, a, u, c, h, out, last); break;
    case 2: launch_n<2>(B, S, D, s, a, u, c, h, out, last); break;
    case 4: launch_n<4>(B, S, D, s, a, u, c, h, out, last); break;
    case 8: launch_n<8>(B, S, D, s, a, u, c, h, out, last); break;
    case 16: launch_n<16>(B, S, D, s, a, u, c, h, out, last); break;
    default: launch_n<32>(B, S, D, s, a, u, c, h, out, last); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
