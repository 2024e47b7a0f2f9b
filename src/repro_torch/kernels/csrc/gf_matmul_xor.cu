// Single-op and batched GF(2^8) matrix products and XOR row folds for the
// erasure-coding dataplane, written for Hopper (sm_90a) and bound to Python
// through a plain C interface (ctypes).
//
// gf_matmul_kernel replaces the reference package's Pallas kernels
//   src/repro/kernels/gf256_matmul.py  gf256_matmul_planes          (K5)
//   src/repro/kernels/gf256_matmul.py  gf256_matmul_planes_batched  (K6)
// and computes out[b] (M, N) = coef[b] (M, K) x data[b] (K, N) over
// GF(2^8), from the bit-planes mc (B, M, K, 8) u8, mc[b, m, k, i] =
// gfmul(coef[b, m, k], 2^i). The body is the u32 mask-spread algebra of
// ragged_tiles.cu: for each bit position i, ((x >> i) & 0x01010101) * 0xFF
// is a 0x00 / 0xFF byte mask, ANDed with the plane splatted into all four
// bytes and XOR-accumulated.
//
// xor_rows_kernel replaces
//   src/repro/kernels/xor_parity.py    xor_parity                   (K7)
//   src/repro/kernels/xor_parity.py    xor_parity_batched           (K7, vmap)
// and computes out[b] (N,) = XOR_t data[b, t] (T, N).
//
// What bounds them on an H100: at the bucketed serve's shapes (N = 64 MiB
// blocks) a launch moves hundreds of MB, so device memory (3.35 TB/s) is
// the floor: K5/K6 at M = 1, K = 6 read 6 x 64 MiB and write 64 MiB, about
// 0.14 ms. The GF body spends 3 integer operations per source word and bit
// to build the mask, then 2 per target (AND, XOR), so about 8 + 4 M
// operations per source byte, which at K = 6 keeps it near the integer
// rate of the SMs rather than the memory rate. The design does what the
// TPU kernel does with its VMEM slab: every thread owns 16 consecutive
// bytes (one uint4) of each of the K source rows, loads each one ONCE and
// folds it into up to kMaxTargets register accumulators, so the M targets
// of a stripe share one read of the sources and one mask build; more
// targets take further passes. The (M, K, 8) planes of the stripe sit in
// shared memory, byte-splatted. The byte axis runs on gridDim.x (2^31 - 1
// blocks; a 64 MiB row at 1 KiB blocks is 65,536 of them, one past the
// limit of gridDim.y) and the batch on gridDim.y. All offsets are size_t:
// a batched 64 MiB launch holds more than 2^31 bytes.
//
// block_n keeps the reference's meaning at the API (the padding unit of
// ops.py: N is a multiple of it) and here sets the bytes one thread block
// covers, so the autotuner's CUDA candidates are real launch shapes.
// XOR is bytes-bound (one operation per byte); it uses the same grid.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVecBytes = 16;          // bytes each thread owns per row (one uint4)
constexpr int kMaxThreads = 256;       // threads per block
constexpr int kMaxTargets = 4;         // register accumulators per pass
constexpr int kMaxPlaneWords = 12288;  // M * K * 8 splatted planes within 48 KB
constexpr int kMaxBatch = 65535;       // gridDim.y

__device__ __forceinline__ uint32_t bit_mask(uint32_t x, int bit) {
  return ((x >> bit) & 0x01010101u) * 0xFFu;
}

template <int MT>
__global__ void gf_matmul_kernel(const uint8_t* __restrict__ mc,
                                 const uint8_t* __restrict__ data,
                                 uint8_t* __restrict__ out, int M, int K,
                                 size_t N, int block_n) {
  extern __shared__ uint32_t splat[];  // (M, K, 8) planes, byte-splatted
  const size_t b = blockIdx.y;
  const int n_planes = M * K * 8;
  const uint8_t* mc_b = mc + b * static_cast<size_t>(n_planes);
  for (int i = threadIdx.x; i < n_planes; i += blockDim.x) {
    splat[i] = 0x01010101u * static_cast<uint32_t>(mc_b[i]);
  }
  __syncthreads();
  const size_t row_vecs = N / kVecBytes;
  const uint4* src = reinterpret_cast<const uint4*>(data + b * K * N);
  uint4* dst = reinterpret_cast<uint4*>(out + b * M * N);
  const int block_vecs = block_n / kVecBytes;
  const size_t v0 = static_cast<size_t>(blockIdx.x) * block_vecs;
  for (int g = 0; g < M; g += MT) {
    const int mg = M - g < MT ? M - g : MT;
    for (int i = threadIdx.x; i < block_vecs; i += blockDim.x) {
      const size_t v = v0 + i;
      uint4 acc[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = make_uint4(0u, 0u, 0u, 0u);
      for (int k = 0; k < K; ++k) {
        const uint4 x = __ldg(src + k * row_vecs + v);
        const uint32_t* planes = splat + (static_cast<size_t>(g) * K + k) * 8;
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          const uint32_t sx = bit_mask(x.x, bit), sy = bit_mask(x.y, bit);
          const uint32_t sz = bit_mask(x.z, bit), sw = bit_mask(x.w, bit);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < mg) {
              const uint32_t p = planes[m * K * 8 + bit];
              acc[m].x ^= sx & p;
              acc[m].y ^= sy & p;
              acc[m].z ^= sz & p;
              acc[m].w ^= sw & p;
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < mg) dst[(g + m) * row_vecs + v] = acc[m];
      }
    }
  }
}

__global__ void xor_rows_kernel(const uint8_t* __restrict__ data,
                                uint8_t* __restrict__ out, int T, size_t N,
                                int block_n) {
  const size_t b = blockIdx.y;
  const size_t row_vecs = N / kVecBytes;
  const uint4* src = reinterpret_cast<const uint4*>(data + b * T * N);
  uint4* dst = reinterpret_cast<uint4*>(out + b * N);
  const int block_vecs = block_n / kVecBytes;
  const size_t v0 = static_cast<size_t>(blockIdx.x) * block_vecs;
  for (int i = threadIdx.x; i < block_vecs; i += blockDim.x) {
    const size_t v = v0 + i;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int t = 0; t < T; ++t) {
      const uint4 x = __ldg(src + t * row_vecs + v);
      acc.x ^= x.x;
      acc.y ^= x.y;
      acc.z ^= x.z;
      acc.w ^= x.w;
    }
    dst[v] = acc;
  }
}

// Grid over (N / block_n byte blocks, B stripes); false if the shape
// cannot be launched as given.
bool grid_for(int B, long long N, int block_n, dim3* grid, dim3* block) {
  if (B <= 0 || B > kMaxBatch || N <= 0 || block_n <= 0 ||
      block_n % kVecBytes != 0 || N % block_n != 0 || N / block_n > INT_MAX) {
    return false;
  }
  const int block_vecs = block_n / kVecBytes;
  *block = dim3(block_vecs < kMaxThreads ? block_vecs : kMaxThreads);
  *grid = dim3(static_cast<unsigned>(N / block_n), static_cast<unsigned>(B));
  return true;
}

template <int MT>
void launch_gf_mt(dim3 grid, dim3 block, size_t shared, cudaStream_t stream,
                  const void* mc, const void* data, void* out, int M, int K,
                  long long N, int block_n) {
  gf_matmul_kernel<MT><<<grid, block, shared, stream>>>(
      static_cast<const uint8_t*>(mc), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), M, K, static_cast<size_t>(N), block_n);
}

int launch_gf(const void* mc, const void* data, void* out, int B, int M, int K,
              long long N, int block_n, void* stream) {
  dim3 grid, block;
  if (M <= 0 || K <= 0 || M * 8 * K > kMaxPlaneWords ||
      !grid_for(B, N, block_n, &grid, &block)) {
    return cudaErrorInvalidValue;
  }
  const size_t shared = static_cast<size_t>(M) * K * 8 * sizeof(uint32_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M < kMaxTargets ? M : kMaxTargets) {
    case 1: launch_gf_mt<1>(grid, block, shared, s, mc, data, out, M, K, N, block_n); break;
    case 2: launch_gf_mt<2>(grid, block, shared, s, mc, data, out, M, K, N, block_n); break;
    case 3: launch_gf_mt<3>(grid, block, shared, s, mc, data, out, M, K, N, block_n); break;
    default: launch_gf_mt<4>(grid, block, shared, s, mc, data, out, M, K, N, block_n); break;
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_xor(const void* data, void* out, int B, int T, long long N,
               int block_n, void* stream) {
  dim3 grid, block;
  if (T <= 0 || !grid_for(B, N, block_n, &grid, &block)) {
    return cudaErrorInvalidValue;
  }
  xor_rows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), T,
      static_cast<size_t>(N), block_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Four entries, one per reference jit entry, so single-op and batched
// launches stay separately countable; the single forms run the batched
// body with B = 1. Each returns cudaGetLastError() after its launch.
extern "C" {

int gf256_matmul_planes(const void* mc, const void* data, void* out, int M,
                        int K, long long N, int block_n, void* stream) {
  return launch_gf(mc, data, out, 1, M, K, N, block_n, stream);
}

int gf256_matmul_planes_batched(const void* mc, const void* data, void* out,
                                int B, int M, int K, long long N, int block_n,
                                void* stream) {
  return launch_gf(mc, data, out, B, M, K, N, block_n, stream);
}

int xor_parity(const void* data, void* out, int T, long long N, int block_n,
               void* stream) {
  return launch_xor(data, out, 1, T, N, block_n, stream);
}

int xor_parity_batched(const void* data, void* out, int B, int T, long long N,
                       int block_n, void* stream) {
  return launch_xor(data, out, B, T, N, block_n, stream);
}

}  // extern "C"
