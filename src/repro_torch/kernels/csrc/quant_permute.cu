// The quantized wire's fused gathers (K5a, K5b).
//
//   K5a sfpl_quant_bucket_permute: the route plan's send-side bucket
//       gather (K4a) fused with per-row quantization into the wire grid.
//       For bucketed row k = s*cap + r with source row x[idx[k]]:
//         amax = max |x|, inv = amax > 0 ? qmax / amax : 0,
//         q[k] = int8: round_half_even(x * inv); fp8: e4m3(x * inv) (RNE),
//         scale[k] = amax * f32(1/qmax).
//       Replaces src/repro/kernels/quant_permute/kernel.py::
//       quant_bucket_permute_2d.
//   K5b sfpl_dequant_unbucket_permute: the receive-side gather (K4b)
//       fused with dequantization, out[i] = T(f32(q[idx[i]]) *
//       scale[idx[i]]). Replaces ...::dequant_unbucket_permute_2d.
//
// Both must equal the plain version (repro_torch/core/wire.py, itself
// bitwise equal to the JAX package's core/wire.py) bit for bit: the
// division is IEEE (__fdiv_rn), every multiply is rounded on its own
// (__fmul_rn, so nothing contracts into an FMA), int8 rounds half to even
// (__float2int_rn) and fp8 rounds to nearest even (__nv_cvt_float_to_fp8;
// |x * inv| <= 448 (1 + 2^-23) by construction, so saturation never
// engages). Build without --use_fast_math.
//
// Where the scale lives: q rows have a row stride of their own (ldq
// bytes) and the four scale bytes of row k sit at s + k * lds, written and
// read byte by byte in little-endian order. With ldq = lds = d + 4 and
// s = q + d this is the collector's packed wire payload, (rows, d + 4)
// with the f32 scale bitcast into the last four lanes of each row, so K5a
// writes the payload in place and K5b reads the strided q view and its
// scale lanes directly: no concatenation and no .contiguous() copy. With
// ldq = d and lds = 4 it is a separate q and f32 scale vector.
//
// Bound on Hopper: bytes (a handful of flops per element). K5a reads each
// bucketed row once from device memory and writes 1 byte per element plus
// 4 scale bytes: at the 800 x 16384 bf16 pool 26.2 MB read + 13.1 MB
// written, 11.7 us at 3.35 TB/s. K5b reads 1 byte and writes 2 (bf16) per
// element, the same 39.3 MB.
//
// Design. K5a: one block per bucketed row. The amax needs the whole row
// before the first q can be written, so the block stages the row in
// dynamic shared memory (32 KB for a 16384-wide bf16 row) while it reduces
// the amax (warp shuffles, then one warp over the per-warp maxima), and
// quantizes from shared memory: the row is read from device memory once.
// Rows too wide to stage (over 200 KB) are read a second time instead.
// K5b: like K4b, each block streams a slice of one output row after
// reading its source row's scale. Both move 4 elements per thread and
// step when the width and alignments allow (16-byte f32 / 8-byte bf16
// loads, 4-byte q stores), one element otherwise.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 512;
constexpr int kDequantThreads = 256;
constexpr int kDequantVecsPerThread = 4;
constexpr int64_t kMaxStageBytes = 200 * 1024;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <bool kInt8>
__device__ __forceinline__ uint8_t quantize(float y) {
  if constexpr (kInt8) {
    return (uint8_t)(int8_t)__float2int_rn(y);
  } else {
    return (uint8_t)__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
  }
}

template <bool kInt8>
__device__ __forceinline__ float dequantize(uint8_t q) {
  if constexpr (kInt8) {
    return (float)(int8_t)q;
  } else {
    __nv_fp8_e4m3 v;
    v.__x = q;
    return static_cast<float>(v);
  }
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// K5a: grid (rows), block kQuantThreads, dynamic shared memory d *
// sizeof(T) when stage != 0. N is the vector width (4 or 1).
template <typename T, bool kInt8, typename I, int N>
__global__ void quant_bucket_rows(const T* __restrict__ x,
                                  const I* __restrict__ idx,
                                  uint8_t* __restrict__ q, int64_t ldq,
                                  uint8_t* __restrict__ s, int64_t lds,
                                  int64_t d, float qmax, float recip,
                                  int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  using V = Vec<T, N>;
  const int64_t k = blockIdx.x;
  const int64_t nv = d / N;
  const V* src = reinterpret_cast<const V*>(x + (int64_t)idx[k] * d);
  V* row = reinterpret_cast<V*>(smem);

  float amax = 0.f;
  for (int64_t j = threadIdx.x; j < nv; j += blockDim.x) {
    const V v = src[j];
    if (stage) row[j] = v;
#pragma unroll
    for (int e = 0; e < N; ++e) amax = fmaxf(amax, fabsf(to_f32(v.v[e])));
  }
  amax = block_max(amax, red);  // its barriers also publish the staged row
  const float inv = amax > 0.f ? __fdiv_rn(qmax, amax) : 0.f;

  uint8_t* dst = q + k * ldq;
  for (int64_t j = threadIdx.x; j < nv; j += blockDim.x) {
    const V v = stage ? row[j] : src[j];
    if constexpr (N == 4) {
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        packed |= (uint32_t)quantize<kInt8>(__fmul_rn(to_f32(v.v[e]), inv))
                  << (8 * e);
      reinterpret_cast<uint32_t*>(dst)[j] = packed;
    } else {
      dst[j] = quantize<kInt8>(__fmul_rn(to_f32(v.v[0]), inv));
    }
  }
  if (threadIdx.x == 0) {
    const uint32_t bits = __float_as_uint(__fmul_rn(amax, recip));
    uint8_t* sp = s + k * lds;
#pragma unroll
    for (int e = 0; e < 4; ++e) sp[e] = (uint8_t)(bits >> (8 * e));
  }
}

// K5b: grid (rows, gy), block kDequantThreads.
template <typename T, bool kInt8, typename I, int N>
__global__ void dequant_recv_rows(const uint8_t* __restrict__ q, int64_t ldq,
                                  const uint8_t* __restrict__ s, int64_t lds,
                                  const I* __restrict__ idx,
                                  T* __restrict__ out, int64_t d) {
  using V = Vec<T, N>;
  const int64_t i = blockIdx.x;
  const int64_t r = (int64_t)idx[i];
  const uint8_t* sp = s + r * lds;
  const float sc = __uint_as_float((uint32_t)sp[0] | ((uint32_t)sp[1] << 8) |
                                   ((uint32_t)sp[2] << 16) |
                                   ((uint32_t)sp[3] << 24));
  const uint8_t* src = q + r * ldq;
  V* dst = reinterpret_cast<V*>(out + i * d);
  const int64_t nv = d / N;
  for (int64_t j = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; j < nv;
       j += (int64_t)gridDim.y * blockDim.x) {
    V o;
    if constexpr (N == 4) {
      const uint32_t packed = reinterpret_cast<const uint32_t*>(src)[j];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o.v[e] = from_f32<T>(
            __fmul_rn(dequantize<kInt8>((uint8_t)(packed >> (8 * e))), sc));
    } else {
      o.v[0] = from_f32<T>(__fmul_rn(dequantize<kInt8>(src[j]), sc));
    }
    dst[j] = o;
  }
}

bool aligned(const void* p, int64_t width) {
  return (uintptr_t)p % width == 0;
}

template <typename T, bool kInt8, typename I, int N>
int launch_quant(const void* x, const void* idx, void* q, int64_t ldq,
                 void* s, int64_t lds, int64_t rows, int64_t d, float qmax,
                 float recip, cudaStream_t stream) {
  auto kernel = quant_bucket_rows<T, kInt8, I, N>;
  const int64_t row_bytes = d * (int64_t)sizeof(T);
  const int stage = row_bytes <= kMaxStageBytes;
  const size_t smem = stage ? (size_t)row_bytes : 0;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  kernel<<<(unsigned)rows, kQuantThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const I*>(idx),
      static_cast<uint8_t*>(q), ldq, static_cast<uint8_t*>(s), lds, d, qmax,
      recip, stage);
  return (int)cudaGetLastError();
}

template <typename T, bool kInt8, typename I>
int quant_vec(const void* x, const void* idx, void* q, int64_t ldq, void* s,
              int64_t lds, int64_t rows, int64_t d, float qmax, float recip,
              cudaStream_t stream) {
  if (d % 4 == 0 && ldq % 4 == 0 && aligned(x, 4 * sizeof(T)) &&
      aligned(q, 4))
    return launch_quant<T, kInt8, I, 4>(x, idx, q, ldq, s, lds, rows, d,
                                        qmax, recip, stream);
  return launch_quant<T, kInt8, I, 1>(x, idx, q, ldq, s, lds, rows, d, qmax,
                                      recip, stream);
}

template <typename T, bool kInt8, typename I, int N>
int launch_dequant(const void* q, int64_t ldq, const void* s, int64_t lds,
                   const void* idx, void* out, int64_t rows, int64_t d,
                   cudaStream_t stream) {
  int64_t gy = (d / N + kDequantThreads * kDequantVecsPerThread - 1) /
               (kDequantThreads * kDequantVecsPerThread);
  if (gy > 65535) gy = 65535;
  dim3 grid((unsigned)rows, (unsigned)gy);
  dequant_recv_rows<T, kInt8, I, N><<<grid, kDequantThreads, 0, stream>>>(
      static_cast<const uint8_t*>(q), ldq, static_cast<const uint8_t*>(s),
      lds, static_cast<const I*>(idx), static_cast<T*>(out), d);
  return (int)cudaGetLastError();
}

template <typename T, bool kInt8, typename I>
int dequant_vec(const void* q, int64_t ldq, const void* s, int64_t lds,
                const void* idx, void* out, int64_t rows, int64_t d,
                cudaStream_t stream) {
  if (d % 4 == 0 && ldq % 4 == 0 && aligned(q, 4) &&
      aligned(out, 4 * sizeof(T)))
    return launch_dequant<T, kInt8, I, 4>(q, ldq, s, lds, idx, out, rows, d,
                                          stream);
  return launch_dequant<T, kInt8, I, 1>(q, ldq, s, lds, idx, out, rows, d,
                                        stream);
}

}  // namespace

// K5a. x: (R, d) contiguous, f32 (x_bf16 == 0) or bf16; idx: (rows,) the
// flattened (S, cap) bucket map, int32 (idx64 == 0) or int64; q: rows of d
// wire bytes at row stride ldq; s: 4 scale bytes per row at stride lds;
// wire_int8 != 0 for int8, else float8_e4m3fn. qmax and recip = f32(1/qmax)
// come from the caller. Returns cudaGetLastError() after the launch.
extern "C" int sfpl_quant_bucket_permute(const void* x, int x_bf16,
                                         const void* idx, int idx64, void* q,
                                         int64_t ldq, void* s, int64_t lds,
                                         int64_t rows, int64_t d,
                                         int wire_int8, float qmax,
                                         float recip, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SFPL_QUANT(T, INT8, I) \
  return quant_vec<T, INT8, I>(x, idx, q, ldq, s, lds, rows, d, qmax, recip, st)
  if (x_bf16) {
    if (wire_int8) {
      if (idx64) SFPL_QUANT(__nv_bfloat16, true, int64_t);
      SFPL_QUANT(__nv_bfloat16, true, int32_t);
    }
    if (idx64) SFPL_QUANT(__nv_bfloat16, false, int64_t);
    SFPL_QUANT(__nv_bfloat16, false, int32_t);
  }
  if (wire_int8) {
    if (idx64) SFPL_QUANT(float, true, int64_t);
    SFPL_QUANT(float, true, int32_t);
  }
  if (idx64) SFPL_QUANT(float, false, int64_t);
  SFPL_QUANT(float, false, int32_t);
#undef SFPL_QUANT
}

// K5b. q: rows of d wire bytes at stride ldq; s: 4 scale bytes per row at
// stride lds; idx: (rows,) int32 or int64, each a row of q; out: (rows, d)
// contiguous, f32 (out_bf16 == 0) or bf16. Returns cudaGetLastError().
extern "C" int sfpl_dequant_unbucket_permute(const void* q, int64_t ldq,
                                             const void* s, int64_t lds,
                                             const void* idx, int idx64,
                                             void* out, int out_bf16,
                                             int64_t rows, int64_t d,
                                             int wire_int8, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SFPL_DEQUANT(T, INT8, I) \
  return dequant_vec<T, INT8, I>(q, ldq, s, lds, idx, out, rows, d, st)
  if (out_bf16) {
    if (wire_int8) {
      if (idx64) SFPL_DEQUANT(__nv_bfloat16, true, int64_t);
      SFPL_DEQUANT(__nv_bfloat16, true, int32_t);
    }
    if (idx64) SFPL_DEQUANT(__nv_bfloat16, false, int64_t);
    SFPL_DEQUANT(__nv_bfloat16, false, int32_t);
  }
  if (wire_int8) {
    if (idx64) SFPL_DEQUANT(float, true, int64_t);
    SFPL_DEQUANT(float, true, int32_t);
  }
  if (idx64) SFPL_DEQUANT(float, false, int64_t);
  SFPL_DEQUANT(float, false, int32_t);
#undef SFPL_DEQUANT
}
