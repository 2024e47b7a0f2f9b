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
// per-tile bit-planes mc (C, K, 8) u8, mc[c, k, b] = gfmul(coef[c, k], 2^b).
// It is the u32 mask-spread body of _ragged_gf_kernel_packed: for each of
// the 8 bit positions, bits = (x >> b) & 0x01010101 is spread to a 0x00 /
// 0xFF byte mask (bits * 0xFF never carries) and ANDed with the plane
// splatted into all four bytes, XOR-accumulated over k and b.
//
// xor_tiles_kernel replaces
//   src/repro/kernels/ragged_decode.py  ragged_xor_tiles          (K2)
//   src/repro/kernels/ragged_encode.py  ragged_xor_encode_tiles   (K4)
// and computes out[c] = XOR_k data[c, k].
//
// What bounds them on an H100: one main-path launch (C = 32, K = 6,
// TN = 4096) moves under 1 MB, about 0.27 us at 3.35 TB/s, so a launch is
// bound by launch latency and by the host-to-device copy of its staging
// buffer, not by device memory. The GF body spends about 60 integer
// operations per source byte, which would cap it below the memory rate at
// large C. The design keeps the simple shape the bound asks for: each
// thread owns 16 consecutive bytes of one tile row (one uint4 load per
// source slab, neighbouring threads on neighbouring addresses), the
// tile's K x 8 planes sit in shared memory already byte-splatted, and the
// grid is (C, TN / (threads * 16)) with 64 threads a block. Nibble tables
// or a persistent multi-chunk launch are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;      // threads per block
constexpr int kVecBytes = 16;     // bytes each thread owns (one uint4)
constexpr int kMaxSharedK = 1536; // K * 8 planes * 4 B must fit 48 KB

__device__ __forceinline__ uint32_t gf_word(uint32_t x, const uint32_t* planes) {
  uint32_t acc = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint32_t bits = (x >> b) & 0x01010101u;
    acc ^= (bits * 0xFFu) & planes[b];
  }
  return acc;
}

__global__ void gf_tiles_kernel(const uint8_t* __restrict__ mc,
                                const uint8_t* __restrict__ data,
                                uint8_t* __restrict__ out, int K, int TN) {
  extern __shared__ uint32_t splat[];  // (K, 8) planes, byte-splatted
  const int c = blockIdx.x;
  const uint8_t* tile_mc = mc + static_cast<size_t>(c) * K * 8;
  for (int i = threadIdx.x; i < K * 8; i += blockDim.x) {
    splat[i] = 0x01010101u * static_cast<uint32_t>(tile_mc[i]);
  }
  __syncthreads();
  const int vec = blockIdx.y * blockDim.x + threadIdx.x;
  const int row_vecs = TN / kVecBytes;
  if (vec >= row_vecs) return;
  const uint4* src =
      reinterpret_cast<const uint4*>(data + static_cast<size_t>(c) * K * TN) + vec;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int k = 0; k < K; ++k) {
    const uint4 x = __ldg(src + static_cast<size_t>(k) * row_vecs);
    const uint32_t* planes = splat + k * 8;
    acc.x ^= gf_word(x.x, planes);
    acc.y ^= gf_word(x.y, planes);
    acc.z ^= gf_word(x.z, planes);
    acc.w ^= gf_word(x.w, planes);
  }
  reinterpret_cast<uint4*>(out + static_cast<size_t>(c) * TN)[vec] = acc;
}

__global__ void xor_tiles_kernel(const uint8_t* __restrict__ data,
                                 uint8_t* __restrict__ out, int K, int TN) {
  const int c = blockIdx.x;
  const int vec = blockIdx.y * blockDim.x + threadIdx.x;
  const int row_vecs = TN / kVecBytes;
  if (vec >= row_vecs) return;
  const uint4* src =
      reinterpret_cast<const uint4*>(data + static_cast<size_t>(c) * K * TN) + vec;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int k = 0; k < K; ++k) {
    const uint4 x = __ldg(src + static_cast<size_t>(k) * row_vecs);
    acc.x ^= x.x;
    acc.y ^= x.y;
    acc.z ^= x.z;
    acc.w ^= x.w;
  }
  reinterpret_cast<uint4*>(out + static_cast<size_t>(c) * TN)[vec] = acc;
}

bool bad_shape(int C, int K, int TN) {
  return C <= 0 || K <= 0 || TN <= 0 || TN % kVecBytes != 0;
}

void grid_for(int C, int TN, dim3* grid, dim3* block) {
  const int row_vecs = TN / kVecBytes;
  const int threads = row_vecs < kThreads ? row_vecs : kThreads;
  *block = dim3(threads);
  *grid = dim3(C, (row_vecs + threads - 1) / threads);
}

int launch_gf(const void* mc, const void* data, void* out, int C, int K, int TN,
              void* stream) {
  if (bad_shape(C, K, TN) || K > kMaxSharedK) return cudaErrorInvalidValue;
  dim3 grid, block;
  grid_for(C, TN, &grid, &block);
  const size_t shared = static_cast<size_t>(K) * 8 * sizeof(uint32_t);
  gf_tiles_kernel<<<grid, block, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mc), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), K, TN);
  return static_cast<int>(cudaGetLastError());
}

int launch_xor(const void* data, void* out, int C, int K, int TN, void* stream) {
  if (bad_shape(C, K, TN)) return cudaErrorInvalidValue;
  dim3 grid, block;
  grid_for(C, TN, &grid, &block);
  xor_tiles_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), K, TN);
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
