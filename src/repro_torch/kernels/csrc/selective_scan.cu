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
// The wrapper checks that da, dbu and h0 are 16-byte aligned. Measured
// (chip_smoke.py --scan-only, NVIDIA H100 80GB HBM3 at 700 W; device time
// by the profiler, warm = the same inputs every launch, cold = each launch
// the next of 200 MB of input sets; the first design, which served every N
// until then, in brackets): the decode step 2.33-2.36 us warm [8.57-9.96]
// over a 1.03 us launch floor, 4.06-4.08 us cold [10.34-10.54], 62% of its
// bound; the prefill chunk 51.5-51.8 us [52.5-52.6], 81%. ptxas: <16, 1>
// 36 registers, <16, 4> 85, no spill. The float4 body beat the first
// design at every S from 1 to 128 for B in {1, 4}, so it serves every S.
// U = 4 at S = 1 took 3.31-3.32 us, hence the one-step instance. Tried and
// not kept: 16 values of n per thread (3.85 us at the decode step),
// kVecUnroll = 8 (2.7% faster at the prefill chunk, 0.3-1.0 us slower at
// S = 2-8 and B = 4), 128-thread blocks (the same at both main-path
// shapes) and 64 (0.4 us slower at the decode step).
//
// selective_scan_kernel_ring<N, K, V16>, for N in {1, 2} and every S (the
// RG-LRU scan of models/rglru.py runs (1, S, 4096, 1) once per rec block:
// 26 launches a prefill, S = 2,048 in the profiled prefill, 32,768 in the
// long one):
//   * what bounds it: bytes (8 of da and dbu in, 4 of y out per step and
//     column), 0.4808 ms at (1, 32768, 4096, 1) and 0.0301 ms at (1, 2048,
//     4096, 1) at 3.35 TB/s. But there are only B * D * N / 32 = 128 column
//     groups, and each column's recurrence is one chain over all of S.
//     Little's law asks ~3.35 TB/s x ~0.7 us = ~2.3 MB in flight; the first
//     design (one thread per column, 8 steps of loads in flight) held
//     4,096 x 8 x 8 B = 256 KB and so could not pass ~11% of HBM: it took
//     3.77 ms (12.8%);
//   * one warp (and block) per 32 contiguous (d, n) columns of one b, one
//     column a lane, 128 blocks on 132 SMs. The warp streams all of S
//     through a ring of K stages of kRingSteps = 16 steps in its own shared
//     memory: rows of da and dbu (128 contiguous bytes each) and the
//     stage's cm, copied with cp.async (16 bytes a lane where every row
//     starts 16-byte aligned, V16; else 4 bytes a lane), K - 1 stages ahead;
//   * K, the stages: 4 where the B * ceil(D * N / 32) warps would hold
//     less than 1.5 MB one stage each (up to 355 warps: 3 stages, 48 steps
//     ahead, 1.6 MB across the card at 128 warps), 2 from there (every
//     warp resident, one stage ahead), whatever S. Larger rings cost
//     shared memory and so resident warps at many columns; at 128 warps a
//     deeper one bought nothing. chip_smoke.py --scan-only at (B, S, 4096,
//     1), the earlier rule (K from S: the least of 2, 4 and 8 holding a
//     short S whole, so 8 from S = 49) in two calls against this one in
//     a third: B = 1 the same from S = 2,048 (0.7396-0.7450 ms against
//     0.7450-0.7454 at 32,768), faster below (4.22-4.34 us against 3.95-
//     3.97 at 128); B = 4 faster from S = 32 (2.303-2.310 ms against
//     2.220-2.222 at 32,768, 5.43-5.45 us against 4.66-4.68 at 128). It
//     also times 2 against 4 stages on the same inputs;
//   * the chain stays sequential and unfused: h = __fadd_rn(__fmul_rn(a,
//     h), u) in t order in a register, so h_last and every h_t are
//     bit-equal to the plain torch version (a multiply, then an add); no
//     reassociated scan (block-local prefix products and a carry fix-up)
//     could be. y is h * cm at N = 1 (bit-equal too), one shuffle at N = 2.
//     The dependent multiply and add are two 4-cycle operations a step,
//     some 0.13 ms over 32,768 steps at 1.98 GHz: under the byte bound;
//   * what holds it near 60% of the bound is the one warp's issue: the
//     copies of a stage, its 48 shared loads, and a store a step, all from
//     one warp on one scheduler of each SM.
// ptxas (sm_90a), registers, no spill and no stack in any instance:
// <1, 2, true> 70, <1, 4, true> 80, <2, 2, true> 72, <2, 4, true> 79, and
// with 4-byte copies <1, 2, false> 100, <1, 4, false> 96, <2, 2, false>
// 118, <2, 4, false> 163; K * 4,224 bytes of dynamic shared memory (8,448
// or 16,896).
//
// The first design, which served N in {1, 2} until this body, is gone:
// selective_scan_kernel<N> gave one thread to each (b, d, n) in blocks of
// 256, with kUnroll = 8 steps of loads issued together and y folded over
// the N lanes by shuffles. At (1, S, 4096, 1) that is 16 blocks on 132
// SMs and 4,096 x 8 x 8 B = 256 KB in flight, ~11% of what HBM needs:
// 3.5943 ms at 32,768 (13% of its bound), 0.2279-0.2281 ms at 2,048,
// 3.63 us at 32. It stayed a while for S = 1 over more than 2 x 132 x 32
// columns, where its one 256-thread block beat eight one-warp blocks by a
// little (1.67-2.24 us against 1.79-3.05 at (B, 1, 4096, N), 16,384
// columns and up; the two tied below); no path runs that shape (the
// RG-LRU decode step is torch ops), so the ring body takes every S.
//
// Measured (chip_smoke.py --scan-only from this tree and from its parent
// in turns, NVIDIA H100 80GB HBM3 at 700 W, warm device time by the
// profiler, under the earlier rule, K from S (8 at these lengths, 4 at S
// = 32); the first design in brackets): (1, 32768, 4096, 1) 0.7396 ms [3.5943], 65% of its
// bound; (1, 2048, 4096, 1) 0.0484-0.0485 ms [0.2279-0.2281], 62%; (1,
// 32, 4096, 1) 1.80 us [3.63]; (4, 32768, 4096, 1) 2.303-2.308 ms
// [4.319], 83%. Tried and not kept: the same body reading each stage from
// shared memory step by step, with y stored under a lane predicate (far
// slower: the compiler wrapped every store in a branch and a 64-bit
// address rebuild); 16-byte copies on that body (barely faster: the
// copies were not what held it); K from S (above); a producer warp (one
// to three of them) filling an mbarrier ring for the warp that runs the chain
// (a little faster in a standalone test, not enough for a second role and
// two barriers a stage); y staged through shared memory and written with
// 16-byte stores, by the same warp, a producer warp or a third warp (no
// faster), or with TMA bulk stores of one 128-byte row a lane (slower).
//
// Every body updates h with __fmul_rn / __fadd_rn, not a contracted FMA,
// so the state matches the plain torch version (a multiply, then an add)
// bit for bit; y differs from it only by the order of the sum over n.
//
// The TPU block sizes (bs, bd) have no counterpart: kernels/selective_scan.py
// scan_plan gives the body, the stages and the grid, and the entry checks
// that the grid covers every column once. N is a power of
// two up to 32 (a group of lanes inside one warp); the wrapper rejects
// anything else. Offsets are size_t: one call at B = 1, S = 32768, D =
// 8192, N = 16 holds 4.3e9 elements of da.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBatch = 65535;  // gridDim.y
constexpr int kVecThreads = 256;  // float4 body: threads per block, 1024 / N channels
constexpr int kVecUnroll = 4;     // float4 body at S > 1: steps whose loads are issued together
// the ring body (kernels/selective_scan.py scan_plan holds the same numbers)
constexpr int kRingSteps = 16;  // time steps per stage
constexpr int kRingCols = 32;   // (d, n) columns per warp (and block), one per lane
constexpr int kStageFloats = 2 * kRingSteps * kRingCols + 32;  // da rows, dbu rows, cm
constexpr int kStageBytes = 4 * kStageFloats;
// the body codes of the C entry (kernels/selective_scan.py BODY_*)
constexpr int kBodyVec = 0;
constexpr int kBodyRing = 1;

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

// cp.async of 4 bytes (cached in L1: the 4-byte form has no .cg variant)
// or 16 bytes (L1 bypassed; both addresses 16-byte aligned) to a 32-bit
// shared address, the group commit, and the wait until at most P of this
// thread's groups are in flight.
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int P>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(P) : "memory");
}

// Copies stage st into the slot at shared address slot: rows t0 .. t0 +
// steps - 1 of the warp's live columns of da and dbu (a_g, u_g: the
// group's row 0), and the stage's cm (lanes 0 .. steps * N - 1).
template <int N, bool V16>
__device__ __forceinline__ void ring_issue(unsigned slot, int st, int S, int dn, int lane,
                                           int live_cols, const float* a_g, const float* u_g,
                                           const float* c_g) {
  const int t0 = st * kRingSteps;
  const int steps = min(kRingSteps, S - t0);
  const size_t off = static_cast<size_t>(t0) * dn;
  if constexpr (V16) {
    // lane l copies 16 bytes (4 columns) at chunk l % 8 of rows l / 8,
    // l / 8 + 4, ...: one instruction moves 4 rows of the warp's 128
    // bytes. dn % 4 == 0, so a chunk is live or dead as a whole.
    const int c4 = (lane % 8) * 4;
    const int rows = c4 < live_cols ? steps : 0;
#pragma unroll
    for (int j = 0; j < kRingSteps / 4; ++j) {
      const int r = lane / 8 + 4 * j;
      if (r < rows) {
        cp_async16(slot + 4 * (r * kRingCols + c4), a_g + off + c4 + r * dn);
        cp_async16(slot + 4 * ((kRingSteps + r) * kRingCols + c4), u_g + off + c4 + r * dn);
      }
    }
  } else {
    const int rows = lane < live_cols ? steps : 0;
#pragma unroll
    for (int r = 0; r < kRingSteps; ++r) {
      if (r < rows) {
        cp_async4(slot + 4 * (r * kRingCols + lane), a_g + off + lane + r * dn);
        cp_async4(slot + 4 * ((kRingSteps + r) * kRingCols + lane), u_g + off + lane + r * dn);
      }
    }
  }
  if (lane < steps * N) {
    cp_async4(slot + 4 * (2 * kRingSteps * kRingCols + lane), c_g + static_cast<size_t>(t0) * N + lane);
  }
}

// One warp (and block) per 32 contiguous (d, n) columns of one b, streaming
// all of S through K stages of kRingSteps steps in shared memory. In the
// ragged last group a lane past the last column takes the last channel's
// column of its n instead, so every lane runs the same chain as some live
// lane and stores the same value to the same place: the loop carries no
// lane predicate. A stage is read into registers whole, behind a compiler
// barrier, before its first product; a full stage then runs, a step, a
// multiply and an add for h, y's product and one store (N = 2: a shuffle
// first), with no branch. The lanes read columns other lanes copied
// (16-byte copies, cm, the ragged group), hence the __syncwarp after the
// wait and after the reads (the next turn refills the slot).
template <int N, int K, bool V16>
__global__ void __launch_bounds__(32)
selective_scan_kernel_ring(const float* __restrict__ da, const float* __restrict__ dbu,
                           const float* __restrict__ cm, const float* __restrict__ h0,
                           float* __restrict__ y, float* __restrict__ h_last, int S, int D) {
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x;
  const int dn = D * N;  // the entry keeps dn * kRingSteps within int
  const int base = blockIdx.x * kRingCols;  // the warp's first column; base < dn
  const int live_cols = dn - base;
  const int col = lane < live_cols ? base + lane : dn - N + lane % N;
  const int lc = col - base;  // the lane's column in the ring's rows
  const size_t b = blockIdx.y;
  const float* a_g = da + b * S * dn + base;
  const float* u_g = dbu + b * S * dn + base;
  const float* c_g = cm + b * S * N;
  float* y_c = y + b * S * D + col / N;  // (b, t = 0, d)
  const unsigned ring_s = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const int stages = (S + kRingSteps - 1) / kRingSteps;

#pragma unroll
  for (int st = 0; st < K - 1; ++st) {
    if (st < stages) {
      ring_issue<N, V16>(ring_s + st * kStageBytes, st, S, dn, lane, live_cols, a_g, u_g, c_g);
    }
    cp_async_commit();
  }
  float h = h0 != nullptr ? h0[b * dn + col] : 0.0f;
  for (int st = 0; st < stages; ++st) {
    if (st + K - 1 < stages) {  // into the slot consumed last turn
      ring_issue<N, V16>(ring_s + ((st + K - 1) % K) * kStageBytes, st + K - 1, S, dn, lane,
                         live_cols, a_g, u_g, c_g);
    }
    cp_async_commit();
    cp_async_wait<K - 1>();  // this thread's copies of stage st have landed
    __syncwarp();            // and the other lanes'
    const float* slot = ring + (st % K) * kStageFloats;
    float a[kRingSteps], u[kRingSteps], c[kRingSteps];
#pragma unroll
    for (int i = 0; i < kRingSteps; ++i) {
      a[i] = slot[i * kRingCols + lc];
      u[i] = slot[(kRingSteps + i) * kRingCols + lc];
      c[i] = slot[2 * kRingSteps * kRingCols + i * N + lc % N];
    }
    asm volatile("" ::: "memory");  // every load above issued before the first store below
    __syncwarp();                   // every lane has read the slot the next turn refills
    const int t0 = st * kRingSteps;
    float* yp = y_c + static_cast<size_t>(t0) * D;
    if (t0 + kRingSteps <= S) {
#pragma unroll
      for (int i = 0; i < kRingSteps; ++i) {
        h = __fadd_rn(__fmul_rn(a[i], h), u[i]);
        float p = h * c[i];
        if constexpr (N == 2) p += __shfl_xor_sync(0xffffffffu, p, 1);
        yp[i * D] = p;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRingSteps; ++i) {
        if (t0 + i < S) {  // the last stage; uniform over the warp
          h = __fadd_rn(__fmul_rn(a[i], h), u[i]);
          float p = h * c[i];
          if constexpr (N == 2) p += __shfl_xor_sync(0xffffffffu, p, 1);
          yp[i * D] = p;
        }
      }
    }
  }
  if (h_last != nullptr) h_last[b * dn + col] = h;
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
  }
}

// grid_x blocks of one warp over the columns of each b; 16-byte copies
// where every row of da and dbu starts on a 16-byte boundary, else 4-byte
// ones (any alignment, any D * N)
template <int N, int K>
void launch_ring(int B, int S, int D, int grid_x, cudaStream_t stream, const float* da,
                 const float* dbu, const float* cm, const float* h0, float* y, float* h_last) {
  constexpr int smem = K * kStageBytes;
  const dim3 grid(grid_x, B);
  if ((D * N) % 4 == 0 && reinterpret_cast<uintptr_t>(da) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dbu) % 16 == 0) {
    selective_scan_kernel_ring<N, K, true><<<grid, 32, smem, stream>>>(da, dbu, cm, h0, y,
                                                                       h_last, S, D);
  } else {
    selective_scan_kernel_ring<N, K, false><<<grid, 32, smem, stream>>>(da, dbu, cm, h0, y,
                                                                        h_last, S, D);
  }
}

}  // namespace

extern "C" {

// da, dbu (B, S, D, N) f32; cm (B, S, N) f32; h0 (B, D, N) f32 or null;
// y (B, S, D) f32; h_last (B, D, N) f32 or null; for N >= 4, da, dbu, h0
// and h_last 16-byte aligned. body, stages and grid_x are
// kernels/selective_scan.py's scan_plan(B, S, D, N): the float4 body for N
// >= 4, the ring body at K = stages for N in {1, 2}, grid_x blocks over the
// columns of each b. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for arguments no body takes, or a grid that leaves a column out or a
// block with none.
int selective_scan(const void* da, const void* dbu, const void* cm, const void* h0,
                   void* y, void* h_last, int B, int S, int D, int N, int body, int stages,
                   int grid_x, void* stream) {
  if (B <= 0 || B > kMaxBatch || S <= 0 || D <= 0 || N <= 0 || N > 32 || (N & (N - 1))) {
    return cudaErrorInvalidValue;
  }
  // the columns of one b a block covers: 4 a thread (float4 body), 1 a lane
  const long long per_block = N >= 4 ? 4LL * kVecThreads : kRingCols;
  const long long cols = static_cast<long long>(D) * N;
  if (grid_x <= 0 || (grid_x - 1) * per_block >= cols || grid_x * per_block < cols) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(da);
  const auto* u = static_cast<const float*>(dbu);
  const auto* c = static_cast<const float*>(cm);
  const auto* h = static_cast<const float*>(h0);
  auto* out = static_cast<float*>(y);
  auto* last = static_cast<float*>(h_last);
  if (N >= 4) {
    if (body != kBodyVec) return cudaErrorInvalidValue;
    switch (N) {
      case 4: launch_n<4>(B, S, D, s, a, u, c, h, out, last); break;
      case 8: launch_n<8>(B, S, D, s, a, u, c, h, out, last); break;
      case 16: launch_n<16>(B, S, D, s, a, u, c, h, out, last); break;
      default: launch_n<32>(B, S, D, s, a, u, c, h, out, last); break;
    }
  } else {
    if (body != kBodyRing || D > INT_MAX / (N * kRingSteps)) return cudaErrorInvalidValue;
    switch (N * 16 + stages) {
      case 16 + 2: launch_ring<1, 2>(B, S, D, grid_x, s, a, u, c, h, out, last); break;
      case 16 + 4: launch_ring<1, 4>(B, S, D, grid_x, s, a, u, c, h, out, last); break;
      case 32 + 2: launch_ring<2, 2>(B, S, D, grid_x, s, a, u, c, h, out, last); break;
      case 32 + 4: launch_ring<2, 4>(B, S, D, grid_x, s, a, u, c, h, out, last); break;
      default: return cudaErrorInvalidValue;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
