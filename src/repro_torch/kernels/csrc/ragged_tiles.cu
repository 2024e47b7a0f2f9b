// Ragged tile kernels for the erasure-coding dataplane, written for Hopper
// (sm_90a) and bound to Python through a plain C interface (ctypes).
//
// Both kernels walk a chunk of C descriptor tiles staged by the gateway's
// coalescer: data (C, K, TN) u8 holds tile c's K source slabs, out (C, TN)
// u8 receives tile c's output slab. Zero K rows and zero tail bytes are
// the identity of both products, so no masking is needed.
//
// gf_tiles_kernel replaces the reference package's Pallas kernels
//   src/repro/kernels/ragged_decode.py  ragged_gf256_tiles        (K1)
//   src/repro/kernels/ragged_encode.py  ragged_gf256_encode_tiles (K3)
// and computes out[c, j] = XOR_k gfmul(coef[c, k], data[c, k, j]) from the
// per-tile bit-planes mc (C, K, 8) u8, mc[c, k, b] = gfmul(coef[c, k], 2^b):
// for each bit b, the bytes of x whose bit b is set select the plane
// splatted into all four bytes, XOR-accumulated over k and b.
//
// xor_tiles_kernel replaces
//   src/repro/kernels/ragged_decode.py  ragged_xor_tiles          (K2)
//   src/repro/kernels/ragged_encode.py  ragged_xor_encode_tiles   (K4)
// and computes out[c] = XOR_k data[c, k].
//
// What bounds them on an H100. A main-path launch (C = 32, K = 6 or 3,
// TN = 4096) moves under 1 MB, 0.27 us at 3.35 TB/s, so it is bound by
// latency: the launch itself, the memory round trips, and each thread's
// chain of dependent steps. The design cuts each of them:
//
//   * One memory round trip. Each thread loads its source vectors and its
//     planes (one uint2 per k, through the read-only path, splatted in
//     registers with prmt) together. Nothing waits on a barrier: there is
//     no shared memory, and the source loads are issued with the plane
//     loads.
//   * Source groups. One output vector (16 bytes of one tile row) is
//     computed by G neighbouring lanes of one warp, lane g taking sources
//     k = g, g + G, ...; the partial vectors fold with log2(G) shuffle
//     rounds and lane 0 stores. A load of the G lanes still reads whole
//     64-byte segments of G rows. G is the least power of two, at most 8
//     and at most K rounded up, that gives the launch 2^16 threads.
//   * A 2-D grid, (C, blocks of 128 threads per tile row): no division to
//     find a thread's tile. At (32, 6, 4096) G = 8 and the grid is 512
//     blocks of 4 warps, 15.5 resident warps per SM on 132 SMs (the first
//     design: 128 blocks of 2 warps); at (4, 6, 4096) G = 8, 64 blocks on
//     64 SMs (first design: 16); at (32, 6, 65536) G = 1, 1024 blocks.
//   * A shorter step. The byte mask of bit b is prmt's sign-replicate of
//     x << (7 - b) (2 instructions; the mask-and-XOR is one LOP3), where
//     the spread (x >> b) & 0x01010101 times 0xFF took 3.
//
// Measured (chip_smoke.py --tiles-only, NVIDIA H100 80GB HBM3 at 700 W,
// medians of ten runs; device time by the profiler over back-to-back
// launches, warm = the same inputs every launch, so they sit in the 50 MB
// L2, cold = each launch takes the next of 200 MB of tiles; the launch
// floor, a 16-byte fill_ in the same traces, 1.03 us; first design in
// brackets):
//   GF  (32, 6, 4096)   warm 1.83-1.84 us [2.96-2.97], cold 2.34-2.35
//       [4.91-4.92]: the floor, one round trip and the instruction count.
//       G = 2 took 1.73-1.79 us warm at 3.9 warps per SM (fewer idle lanes
//       and folds, measured with a build that forced G); G = 8 is kept
//       for the occupancy.
//   GF  (4, 6, 4096)    warm 1.34-1.35 [2.86], cold 1.76 [4.37-4.39]: the
//       floor and one round trip.
//   GF  (32, 6, 65536)  warm 5.95-5.97 [7.33-7.35], cold 7.30-7.31
//       [8.73-8.74]: 60% of its 4.38 us byte bound cold (74% warm). Warm,
//       its integer work (23 instructions per source word) takes 4.9 us
//       above the floor, about what the HBM read takes cold, and the two
//       overlap only in part.
//   XOR (32, 3, 4096)   warm 1.38 [1.60], cold 1.93-1.94 [2.65], G = 4:
//       the floor and one round trip.
//   XOR (4, 3, 4096)    warm 1.24 [1.52], cold 1.58 [2.35], G = 4.
//   XOR (32, 3, 65536)  warm 2.47-2.48 [3.05], cold 4.11-4.13 [4.25],
//       G = 1: 61% of its 2.50 us byte bound cold, the rate HBM gives an
//       8.4 MB launch (2.7 TB/s above the floor).
// Issuing a batch of 4 or 8 sources' loads before any product was no
// faster cold and up to 0.47 us slower at 4096 bytes: not kept.
//
// There is no K limit: a thread loops over its group's sources.
// Offsets are size_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                   // threads per block (4 warps)
constexpr int kVecBytes = 16;                   // bytes of a tile row one vector covers
constexpr int kMaxGroups = 8;                   // lanes that share one output vector
constexpr long long kTargetThreads = 1LL << 16; // 15.5 warps on each of 132 SMs

// 0xFF in each byte lane of x whose bit 7 is set, 0x00 elsewhere: prmt's
// sign-replicate mode (selector nibble 8 + byte index).
__device__ __forceinline__ uint32_t sign_bytes(uint32_t x) {
  uint32_t m;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(m) : "r"(x), "r"(0u), "r"(0xBA98u));
  return m;
}

// gfmul(coef, byte) for the four bytes of x, from p[b] = gfmul(coef, 2^b)
// splatted into four bytes. x << (7 - b) moves bit b of every byte to
// that byte's bit 7; lower bytes' bits land below it.
__device__ __forceinline__ uint32_t gf_word(uint32_t x, const uint32_t (&p)[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) acc ^= sign_bytes(x << (7 - b)) & p[b];
  return acc;
}

// XOR the partial vectors of the G lanes of a group into every lane of it.
template <int G>
__device__ __forceinline__ void fold(uint4& acc) {
#pragma unroll
  for (int s = 1; s < G; s <<= 1) {
    acc.x ^= __shfl_xor_sync(0xffffffffu, acc.x, s);
    acc.y ^= __shfl_xor_sync(0xffffffffu, acc.y, s);
    acc.z ^= __shfl_xor_sync(0xffffffffu, acc.z, s);
    acc.w ^= __shfl_xor_sync(0xffffffffu, acc.w, s);
  }
}

// Block (c, y) covers tile c; its thread t covers vector col = (y * kThreads
// + t) / G of the tile row with sources k = g, g + G, ... for g = t % G.
// Threads past the row's last vector load and store nothing but join the
// fold's shuffles.
template <int G>
__global__ void __launch_bounds__(kThreads)
gf_tiles_kernel(const uint8_t* __restrict__ mc, const uint8_t* __restrict__ data,
                uint8_t* __restrict__ out, int K, int row_vecs) {
  const int c = blockIdx.x;
  const int col = static_cast<int>(blockIdx.y * kThreads + threadIdx.x) / G;
  const int g = static_cast<int>(threadIdx.x) & (G - 1);
  const bool live = col < row_vecs;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  if (live) {
    const uint4* src = reinterpret_cast<const uint4*>(data) +
                       static_cast<size_t>(c) * K * row_vecs + col;
    const uint2* planes = reinterpret_cast<const uint2*>(mc) + static_cast<size_t>(c) * K;
#pragma unroll 2
    for (int k = g; k < K; k += G) {
      const uint4 x = __ldg(src + static_cast<size_t>(k) * row_vecs);
      const uint2 pl = __ldg(planes + k);
      uint32_t p[8];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        p[b] = __byte_perm(pl.x, 0u, 0x1111u * b);
        p[b + 4] = __byte_perm(pl.y, 0u, 0x1111u * b);
      }
      acc.x ^= gf_word(x.x, p);
      acc.y ^= gf_word(x.y, p);
      acc.z ^= gf_word(x.z, p);
      acc.w ^= gf_word(x.w, p);
    }
  }
  fold<G>(acc);
  if (live && g == 0) {
    reinterpret_cast<uint4*>(out)[static_cast<size_t>(c) * row_vecs + col] = acc;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
xor_tiles_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out, int K,
                 int row_vecs) {
  const int c = blockIdx.x;
  const int col = static_cast<int>(blockIdx.y * kThreads + threadIdx.x) / G;
  const int g = static_cast<int>(threadIdx.x) & (G - 1);
  const bool live = col < row_vecs;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  if (live) {
    const uint4* src = reinterpret_cast<const uint4*>(data) +
                       static_cast<size_t>(c) * K * row_vecs + col;
#pragma unroll 4
    for (int k = g; k < K; k += G) {
      const uint4 x = __ldg(src + static_cast<size_t>(k) * row_vecs);
      acc.x ^= x.x;
      acc.y ^= x.y;
      acc.z ^= x.z;
      acc.w ^= x.w;
    }
  }
  fold<G>(acc);
  if (live && g == 0) {
    reinterpret_cast<uint4*>(out)[static_cast<size_t>(c) * row_vecs + col] = acc;
  }
}

bool bad_shape(int C, int K, int TN) {
  return C <= 0 || K <= 0 || TN <= 0 || TN % kVecBytes != 0;
}

// The least power of two G <= cap with G >= K or vecs * G >= the target.
int groups_for(long long vecs, int K, int cap) {
  int g = 1;
  while (g < cap && g < K && vecs * g < kTargetThreads) g <<= 1;
  return g;
}

// Grid (C, blocks per tile row). gridDim.y is at most 65535: G = 1 holds
// rows up to 128 MB, and G > 1 is taken only below 2^16 threads in all.
dim3 grid_for(int C, int row_vecs, int G) {
  return dim3(C, static_cast<unsigned>((static_cast<long long>(row_vecs) * G + kThreads - 1) /
                                       kThreads));
}

int launch_gf(const void* mc, const void* data, void* out, int C, int K, int TN,
              void* stream) {
  if (bad_shape(C, K, TN)) return cudaErrorInvalidValue;
  const int row_vecs = TN / kVecBytes;
  const int g = groups_for(static_cast<long long>(C) * row_vecs, K, kMaxGroups);
  const auto m = static_cast<const uint8_t*>(mc);
  const auto d = static_cast<const uint8_t*>(data);
  const auto o = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(C, row_vecs, g);
  switch (g) {
    case 1: gf_tiles_kernel<1><<<grid, kThreads, 0, s>>>(m, d, o, K, row_vecs); break;
    case 2: gf_tiles_kernel<2><<<grid, kThreads, 0, s>>>(m, d, o, K, row_vecs); break;
    case 4: gf_tiles_kernel<4><<<grid, kThreads, 0, s>>>(m, d, o, K, row_vecs); break;
    default: gf_tiles_kernel<8><<<grid, kThreads, 0, s>>>(m, d, o, K, row_vecs); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_xor(const void* data, void* out, int C, int K, int TN, void* stream) {
  if (bad_shape(C, K, TN)) return cudaErrorInvalidValue;
  const int row_vecs = TN / kVecBytes;
  const int g = groups_for(static_cast<long long>(C) * row_vecs, K, kMaxGroups);
  const auto d = static_cast<const uint8_t*>(data);
  const auto o = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(C, row_vecs, g);
  switch (g) {
    case 1: xor_tiles_kernel<1><<<grid, kThreads, 0, s>>>(d, o, K, row_vecs); break;
    case 2: xor_tiles_kernel<2><<<grid, kThreads, 0, s>>>(d, o, K, row_vecs); break;
    case 4: xor_tiles_kernel<4><<<grid, kThreads, 0, s>>>(d, o, K, row_vecs); break;
    default: xor_tiles_kernel<8><<<grid, kThreads, 0, s>>>(d, o, K, row_vecs); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Four entries, one per reference jit entry, so decode and encode launches
// stay separately countable. Each returns cudaGetLastError() after its launch.
extern "C" {

int ragged_gf256_tiles(const void* mc, const void* data, void* out, int C, int K,
                       int TN, void* stream) {
  return launch_gf(mc, data, out, C, K, TN, stream);
}

int ragged_xor_tiles(const void* data, void* out, int C, int K, int TN,
                     void* stream) {
  return launch_xor(data, out, C, K, TN, stream);
}

int ragged_gf256_encode_tiles(const void* mc, const void* data, void* out, int C,
                              int K, int TN, void* stream) {
  return launch_gf(mc, data, out, C, K, TN, stream);
}

int ragged_xor_encode_tiles(const void* data, void* out, int C, int K, int TN,
                            void* stream) {
  return launch_xor(data, out, C, K, TN, stream);
}

const char* ragged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
