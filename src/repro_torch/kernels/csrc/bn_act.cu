// K2: the folded BatchNorm affine plus optional ReLU, y = relu?(x * a + b).
//
// Replaces src/repro/kernels/bn_act/kernel.py::bn_act_2d (Pallas, TPU),
// which sweeps (256, Cp) row blocks with C padded to 128 lanes.
//
// Bound on Hopper: bytes. One read of the conv output and one write of
// the activation, 2 * rows * C * sizeof(T); (a, b) are a few hundred bytes
// and stay in L1.
//
// Design: one elementwise pass over the contiguous NHWC rows, channel =
// element index mod C, no padding of C (at C = 16 padding to 128 would
// move 8x the bytes). Each thread loads and stores 16 bytes (8 bf16 or
// 4 f32 values) when C is a multiple of that vector, so a vector never
// straddles two rows. A leading group axis (gridDim.y) gives every group
// its own (a, b): the client forward of all clients, each with its own
// BN affine, is one launch. Math is in f32; multiply and add are rounded
// separately (__fmul_rn, __fadd_rn), as the plain PyTorch version does
// them, and the result is stored in the input dtype.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerGroup = 4096;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ float in(float v) { return v; }
  static __device__ float out(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ float in(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __nv_bfloat16 out(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Cvt<__half> {
  static __device__ float in(__half v) { return __half2float(v); }
  static __device__ __half out(float v) { return __float2half_rn(v); }
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

template <typename T, int VEC>
__global__ void bn_act_kernel(const T* __restrict__ x,
                              const float* __restrict__ a,
                              const float* __restrict__ b,
                              T* __restrict__ y, int64_t per_group, int C,
                              int relu) {
  const int64_t g = blockIdx.y;
  const Pack<T, VEC>* xg =
      reinterpret_cast<const Pack<T, VEC>*>(x + g * per_group);
  Pack<T, VEC>* yg = reinterpret_cast<Pack<T, VEC>*>(y + g * per_group);
  const float* ag = a + g * C;
  const float* bg = b + g * C;
  const int64_t nvec = per_group / VEC;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * blockDim.x) {
    const Pack<T, VEC> p = xg[v];
    const int c0 = (int)((v * VEC) % C);
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float f = __fadd_rn(__fmul_rn(Cvt<T>::in(p.e[k]), __ldg(ag + c0 + k)),
                          __ldg(bg + c0 + k));
      if (relu) f = f < 0.f ? 0.f : f;
      o.e[k] = Cvt<T>::out(f);
    }
    yg[v] = o;
  }
}

template <typename T, int VEC>
int launch(const void* x, const float* a, const float* b, void* y,
           int64_t groups, int64_t per_group, int C, int relu,
           cudaStream_t stream) {
  const int64_t nvec = per_group / VEC;
  int64_t gx = (nvec + kThreads - 1) / kThreads;
  if (gx > kMaxBlocksPerGroup) gx = kMaxBlocksPerGroup;
  if (gx < 1) gx = 1;
  dim3 grid((unsigned)gx, (unsigned)groups);
  bn_act_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), a, b, static_cast<T*>(y), per_group, C, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* a, const float* b, void* y,
             int64_t groups, int64_t per_group, int C, int relu,
             cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (C % kVec == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0)
    return launch<T, kVec>(x, a, b, y, groups, per_group, C, relu, s);
  return launch<T, 1>(x, a, b, y, groups, per_group, C, relu, s);
}

}  // namespace

// x, y: (groups, rows, C) contiguous, per_group = rows * C elements;
// a, b: (groups, C) f32. dtype: 0 float32, 1 bfloat16, 2 float16.
// Returns cudaGetLastError() after the launch.
extern "C" int sfpl_bn_act(const void* x, const float* a, const float* b,
                           void* y, int64_t groups, int64_t per_group,
                           int64_t C, int dtype, int relu, void* stream) {
  if (groups <= 0 || per_group <= 0) return 0;
  if (groups > 65535 || C <= 0 || C > 2147483647LL || per_group % C != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(x, a, b, y, groups, per_group, (int)C, relu, s);
    case 1: return dispatch<__nv_bfloat16>(x, a, b, y, groups, per_group, (int)C, relu, s);
    case 2: return dispatch<__half>(x, a, b, y, groups, per_group, (int)C, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
