// The collector's row gathers: K1, K4a and K4b share one device routine,
// out[i, :] = x[idx[i], :], and differ in their index and row counts.
//
//   K1  sfpl_collector_permute: the single-device pool shuffle, idx a
//       permutation of the R rows (int64). Replaces
//       src/repro/kernels/collector_permute/kernel.py::collector_permute_2d.
//   K4a sfpl_bucket_permute: the route plan's send-side gather into
//       bucket layout, out[s*cap + r] = x[idx[s, r]], S*cap output rows
//       from R input rows. Replaces ...::bucket_permute_2d.
//   K4b sfpl_unbucket_permute: the receive-side gather of the flat
//       received block (S*cap rows, plus the zero pad row on slack-buffered
//       plans) into B output rows, out[i] = x[idx[i]]. Replaces
//       ...::unbucket_permute_2d.
//
// The Pallas kernels DMA one (1, block_d) tile per grid cell from a
// scalar-prefetched source row and pad D to a multiple of 128 lanes.
//
// Bound on Hopper: bytes. A gather does no arithmetic; it reads each
// output's source row once and writes the output once, 2 * rows *
// row_bytes per launch (52 MB for the 800 x 16384 bf16 pool of ResNet-56
// at 100 clients, 15.65 us at 3.35 TB/s).
//
// Design: each block copies a slice of one output row, so a source row is
// read by whole warps on neighbouring addresses. Every thread moves 16
// bytes per load and store (uint4) whenever the row size and both pointers
// allow it, narrower words otherwise; the copy is dtype-blind. No padding
// of D: rows are copied at their real width. The block reads its own index
// (no scalar prefetch exists here), in the index dtype the caller holds:
// int64 for K1's permutation, int32 or int64 for a route plan's indices,
// so no cast copy of the plan is made per call. Each entry point has a
// kernel symbol of its own, so a profile tells the three apart.
//
// Tried for K4a/K4b and not kept: a persistent grid that moves rows
// through Hopper's bulk-copy engine (cp.async.bulk into a ring of shared
// memory stages, indices a slab ahead) ran 0-2 % slower than this design
// on the same gather at the pool's shape (PERF.md section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;

template <typename V, typename I>
__device__ __forceinline__ void copy_row(const V* __restrict__ x,
                                         const I* __restrict__ idx,
                                         V* __restrict__ out,
                                         int64_t row_vecs) {
  const int64_t i = blockIdx.x;
  const V* src = x + (int64_t)idx[i] * row_vecs;
  V* dst = out + i * row_vecs;
  for (int64_t j = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
       j < row_vecs; j += (int64_t)gridDim.y * blockDim.x) {
    dst[j] = src[j];
  }
}

template <typename V, typename I>
__global__ void permute_rows(const V* __restrict__ x,
                             const I* __restrict__ idx, V* __restrict__ out,
                             int64_t row_vecs) {
  copy_row(x, idx, out, row_vecs);
}

template <typename V, typename I>
__global__ void bucket_gather_rows(const V* __restrict__ x,
                                   const I* __restrict__ idx,
                                   V* __restrict__ out, int64_t row_vecs) {
  copy_row(x, idx, out, row_vecs);
}

template <typename V, typename I>
__global__ void recv_gather_rows(const V* __restrict__ x,
                                 const I* __restrict__ idx,
                                 V* __restrict__ out, int64_t row_vecs) {
  copy_row(x, idx, out, row_vecs);
}

enum Which { kPermute, kBucket, kUnbucket };

template <Which W, typename V, typename I>
int launch(const void* x, const void* idx, void* out, int64_t rows,
           int64_t row_bytes, cudaStream_t stream) {
  const int64_t row_vecs = row_bytes / (int64_t)sizeof(V);
  int64_t gy = (row_vecs + kThreads * kVecsPerThread - 1) /
               (kThreads * kVecsPerThread);
  if (gy > 65535) gy = 65535;
  dim3 grid((unsigned)rows, (unsigned)gy);
  const V* xv = static_cast<const V*>(x);
  const I* iv = static_cast<const I*>(idx);
  V* ov = static_cast<V*>(out);
  if constexpr (W == kPermute) {
    permute_rows<V, I><<<grid, kThreads, 0, stream>>>(xv, iv, ov, row_vecs);
  } else if constexpr (W == kBucket) {
    bucket_gather_rows<V, I><<<grid, kThreads, 0, stream>>>(xv, iv, ov,
                                                            row_vecs);
  } else {
    recv_gather_rows<V, I><<<grid, kThreads, 0, stream>>>(xv, iv, ov,
                                                          row_vecs);
  }
  return (int)cudaGetLastError();
}

bool fits(const void* x, const void* out, int64_t row_bytes, int64_t width) {
  return row_bytes % width == 0 && (uintptr_t)x % width == 0 &&
         (uintptr_t)out % width == 0;
}

template <Which W, typename I>
int gather(const void* x, const void* idx, void* out, int64_t rows,
           int64_t row_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0) return 0;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits(x, out, row_bytes, 16))
    return launch<W, uint4, I>(x, idx, out, rows, row_bytes, s);
  if (fits(x, out, row_bytes, 8))
    return launch<W, uint2, I>(x, idx, out, rows, row_bytes, s);
  if (fits(x, out, row_bytes, 4))
    return launch<W, uint32_t, I>(x, idx, out, rows, row_bytes, s);
  if (fits(x, out, row_bytes, 2))
    return launch<W, uint16_t, I>(x, idx, out, rows, row_bytes, s);
  return launch<W, uint8_t, I>(x, idx, out, rows, row_bytes, s);
}

}  // namespace

// Every entry point: x and out contiguous with rows of row_bytes bytes;
// idx on the device, one entry per output row, each a valid row of x.
// Returns cudaGetLastError() after the launch (0 when there is nothing to
// copy).

// K1: x, out (rows, row_bytes); perm (rows,) int64.
extern "C" int sfpl_collector_permute(const void* x, const int64_t* perm,
                                      void* out, int64_t rows,
                                      int64_t row_bytes, void* stream) {
  return gather<kPermute, int64_t>(x, perm, out, rows, row_bytes, stream);
}

// K4a: out (out_rows = S*cap, row_bytes); idx (S, cap) row-major, int32
// (idx64 == 0) or int64 (idx64 != 0).
extern "C" int sfpl_bucket_permute(const void* x, const void* idx, void* out,
                                   int64_t out_rows, int64_t row_bytes,
                                   int idx64, void* stream) {
  return idx64 ? gather<kBucket, int64_t>(x, idx, out, out_rows, row_bytes,
                                          stream)
               : gather<kBucket, int32_t>(x, idx, out, out_rows, row_bytes,
                                          stream);
}

// K4b: out (out_rows = B, row_bytes); idx (B,) int32 or int64.
extern "C" int sfpl_unbucket_permute(const void* x, const void* idx,
                                     void* out, int64_t out_rows,
                                     int64_t row_bytes, int idx64,
                                     void* stream) {
  return idx64 ? gather<kUnbucket, int64_t>(x, idx, out, out_rows,
                                            row_bytes, stream)
               : gather<kUnbucket, int32_t>(x, idx, out, out_rows,
                                            row_bytes, stream);
}
