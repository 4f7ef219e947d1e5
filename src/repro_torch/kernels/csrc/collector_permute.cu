// K1: the SFPL collector's row shuffle, out[i, :] = x[perm[i], :].
//
// Replaces src/repro/kernels/collector_permute/kernel.py::collector_permute_2d
// (Pallas, TPU), which DMAs one (1, block_d) tile per grid cell from a
// scalar-prefetched source row and pads D to a multiple of 128 lanes.
//
// Bound on Hopper: bytes. The gather does no arithmetic; it reads each
// pool row once and writes it once, 2 * R * row_bytes per launch (about
// 52 MB for the 800 x 16384 bf16 pool of ResNet-56 at 100 clients).
//
// Design: each block copies a slice of one output row, so a source row is
// read by whole warps on neighbouring addresses. Every thread moves 16
// bytes per load and store (uint4) whenever the row size and both pointers
// allow it, falling back to narrower words otherwise; the copy is
// dtype-blind. No padding of D: the row is copied at its real width. The
// block reads its own index from perm (no scalar prefetch exists here).
// The backward pass of the shuffle is this same kernel with the inverse
// permutation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;

template <typename V>
__global__ void permute_rows(const V* __restrict__ x,
                             const int64_t* __restrict__ perm,
                             V* __restrict__ out, int64_t row_vecs) {
  const int64_t i = blockIdx.x;
  const V* src = x + perm[i] * row_vecs;
  V* dst = out + i * row_vecs;
  for (int64_t j = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
       j < row_vecs; j += (int64_t)gridDim.y * blockDim.x) {
    dst[j] = src[j];
  }
}

template <typename V>
int launch(const void* x, const int64_t* perm, void* out, int64_t rows,
           int64_t row_bytes, cudaStream_t stream) {
  const int64_t row_vecs = row_bytes / (int64_t)sizeof(V);
  int64_t gy = (row_vecs + kThreads * kVecsPerThread - 1) /
               (kThreads * kVecsPerThread);
  if (gy > 65535) gy = 65535;
  dim3 grid((unsigned)rows, (unsigned)gy);
  permute_rows<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(x), perm, static_cast<V*>(out), row_vecs);
  return (int)cudaGetLastError();
}

bool fits(const void* x, const void* out, int64_t row_bytes, int64_t width) {
  return row_bytes % width == 0 && (uintptr_t)x % width == 0 &&
         (uintptr_t)out % width == 0;
}

}  // namespace

// x, out: (rows, row_bytes) contiguous; perm: (rows,) int64 on the device,
// each entry in [0, rows). Returns cudaGetLastError() after the launch.
extern "C" int sfpl_collector_permute(const void* x, const int64_t* perm,
                                      void* out, int64_t rows,
                                      int64_t row_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0) return 0;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits(x, out, row_bytes, 16)) return launch<uint4>(x, perm, out, rows, row_bytes, s);
  if (fits(x, out, row_bytes, 8)) return launch<uint2>(x, perm, out, rows, row_bytes, s);
  if (fits(x, out, row_bytes, 4)) return launch<uint32_t>(x, perm, out, rows, row_bytes, s);
  if (fits(x, out, row_bytes, 2)) return launch<uint16_t>(x, perm, out, rows, row_bytes, s);
  return launch<uint8_t>(x, perm, out, rows, row_bytes, s);
}
