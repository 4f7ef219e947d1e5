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
//
// The BatchNorm training op around K2: bn_moments_kernel (forward) and
// bn_grad_reduce_kernel + bn_grad_dx_kernel (backward). These replace no
// TPU kernel: they replace plain PyTorch (the f32 copy x.float(),
// torch.var_mean, the eager fold and running update, and the autograd
// chain through all of them, about 100 B and 50 launches an element and a
// call). Bound on Hopper: bytes. A training call needs the input read for
// the moments (2 B an element in bf16), K2's read and write (4 B), and the
// backward's two passes over g and x (4 B, then 6 B with dx written).
//
// Design: every thread owns VEC channels of one row lane ((G, rows, C)
// contiguous, 16-byte loads as in K2), so its per-channel parameters and
// accumulators stay in registers; a block's TR = 256 / (C / VEC) row lanes
// sweep tiles of TR rows, the grid's x axis splits the rows of a group
// into P parts (about four blocks an SM over all groups) and its y axis is
// the group, as in K2. The moments are Welford's inside a thread (f32),
// Chan's merge across the block's lanes and across the parts; the
// gradient sums are plain f32 sums. Each block writes its partials; the
// last block of a group (an atomic ticket, zeroed by the launcher) merges
// them in a fixed order, so a result depends on the shape alone, and
// writes the per-channel results: the biased variance and mean, the fold
// a = scale / sqrt(var + eps), b = bias - mean * a (IEEE division and
// square root, as the plain path), rstd, and the running state
// 0.9 * old + 0.1 * batch with count + 1; in the backward, the sums'
// coefficients and dscale, dbias. The ReLU mask of the backward is K2's
// own y > 0, recomputed from x, a and b with K2's rounding, so y is not
// kept. Nothing f32 of the full size is made or kept.
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


// --------------------------------------------------------------------------
// the BatchNorm training op

constexpr int kStatThreads = 256;
constexpr int kMomentsUnroll = 2;
// partials a thread of a group's last block loads before merging them, so
// that the loads are in flight together
constexpr int kMergeBatch = 8;

// The operands of one sfpl_bn_moments / sfpl_bn_grad call (described
// there, at the end of the file), passed to the kernels by value.
struct MomentsArgs {
  const void* x;
  int64_t groups, rows, C;
  int vec;
  int64_t parts;
  const float *scale, *bias, *run_mean, *run_var, *run_count;
  float *new_mean, *new_var, *new_count;
  float momentum, keep, eps;
  int training;
  float *ws, *stats;
};

struct GradArgs {
  const void *gy, *x;
  void* dx;
  int64_t groups, rows, C;
  int vec;
  int64_t parts, dx_parts;
  const float* stats;
  int relu;
  float *ws, *coef;
};

// g where K2's y for this element is > 0 (the same rounded multiply and
// add, ReLU and store in T), else 0; g itself without the ReLU
template <typename T>
__device__ __forceinline__ float relu_masked(float g, float x, float a,
                                             float b, int relu) {
  if (!relu) return g;
  float f = __fadd_rn(__fmul_rn(x, a), b);
  f = f < 0.f ? 0.f : f;
  return Cvt<T>::in(Cvt<T>::out(f)) > 0.f ? g : 0.f;
}

__device__ __forceinline__ int pow2_above(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Chan's merge of (nb, mb[], qb[]) into (na, ma[], qa[]): a count shared
// by V channels, their means and M2
template <int V>
__device__ __forceinline__ void chan(float& na, float* ma, float* qa,
                                     float nb, const float* mb,
                                     const float* qb, int stride = 1) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float wb = nb / n, wab = na * wb;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float d = mb[k * stride] - ma[k * stride];
    ma[k * stride] = fmaf(d, wb, ma[k * stride]);
    qa[k * stride] = qa[k * stride] + qb[k * stride] + d * d * wab;
  }
  na = n;
}

// Ticket: true in the last block of group g to finish. Every block's
// partials are visible to it (each block fences before taking a ticket).
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ws: count (G, P), mean (G, P, C), M2 (G, P, C), then G tickets.
// stats: (5, G, C) f32 mean, var, a, b, rstd.
template <typename T, int VEC>
__global__ void __launch_bounds__(kStatThreads, 4)
bn_moments_kernel(const MomentsArgs A) {
  const T* __restrict__ x = static_cast<const T*>(A.x);
  const int64_t rows = A.rows;
  const int C = (int)A.C;
  float* __restrict__ ws = A.ws;
  float* __restrict__ stats = A.stats;
  __shared__ float sh[(2 * VEC + 1) * kStatThreads];
  float* sn = sh;
  float* sm = sh + kStatThreads;
  float* sq = sh + (1 + VEC) * kStatThreads;
  const int G = gridDim.y, P = gridDim.x, g = blockIdx.y, t = threadIdx.x;
  const int tc = C / VEC, tr = kStatThreads / tc;
  const int cv = t % tc, rl = t / tc;
  const bool active = rl < tr;
  const size_t GP = (size_t)G * P;
  float* pn = ws + (size_t)g * P;
  float* pm = ws + GP + (size_t)g * P * C;
  float* pq = ws + GP + GP * C + (size_t)g * P * C;
  unsigned* ticket = reinterpret_cast<unsigned*>(ws + GP * (2 * C + 1));

  float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) mean[k] = m2[k] = 0.f;
  if (active) {
    const Pack<T, VEC>* xg =
        reinterpret_cast<const Pack<T, VEC>*>(x + (int64_t)g * rows * C);
    const int64_t step = (int64_t)P * tr;
    for (int64_t r0 = (int64_t)blockIdx.x * tr + rl; r0 < rows;
         r0 += kMomentsUnroll * step) {
      Pack<T, VEC> p[kMomentsUnroll];
#pragma unroll
      for (int u = 0; u < kMomentsUnroll; ++u)
        if (r0 + u * step < rows) p[u] = xg[(r0 + u * step) * tc + cv];
#pragma unroll
      for (int u = 0; u < kMomentsUnroll; ++u) {
        if (r0 + u * step >= rows) break;
        n += 1.f;
        const float inv = __frcp_rn(n);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = Cvt<T>::in(p[u].e[k]);
          const float d = v - mean[k];
          mean[k] = fmaf(d, inv, mean[k]);
          m2[k] = fmaf(d, v - mean[k], m2[k]);
        }
      }
    }
  }
  sn[t] = n;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sm[k * kStatThreads + t] = mean[k];
    sq[k * kStatThreads + t] = m2[k];
  }
  __syncthreads();
  for (int s = pow2_above(tr) >> 1; s > 0; s >>= 1) {
    if (active && rl < s && rl + s < tr) {
      const int o = t + s * tc;
      chan<VEC>(sn[t], sm + t, sq + t, sn[o], sm + o, sq + o, kStatThreads);
    }
    __syncthreads();
  }
  if (t < tc) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      pm[(size_t)blockIdx.x * C + t * VEC + k] = sm[k * kStatThreads + t];
      pq[(size_t)blockIdx.x * C + t * VEC + k] = sq[k * kStatThreads + t];
    }
  }
  if (t == 0) pn[blockIdx.x] = sn[0];
  if (!last_block(ticket)) return;

  // the group's last block: merge the P partials of each channel, S
  // slices of them in turn, then the slices in a tree
  const int cpb = C < kStatThreads ? C : kStatThreads;
  const int S = kStatThreads / cpb, cl = t % cpb, sl = t / cpb;
  for (int c0 = 0; c0 < C; c0 += cpb) {
    const int c = c0 + cl;
    const bool on = sl < S && c < C;
    float na = 0.f, ma = 0.f, qa = 0.f;
    if (on)
      for (int p0 = sl; p0 < P; p0 += S * kMergeBatch) {
        float nb[kMergeBatch], mb[kMergeBatch], qb[kMergeBatch];
#pragma unroll
        for (int j = 0; j < kMergeBatch; ++j) {
          const int p = p0 + j * S;
          nb[j] = p < P ? __ldcg(pn + p) : 0.f;
          mb[j] = p < P ? __ldcg(pm + (size_t)p * C + c) : 0.f;
          qb[j] = p < P ? __ldcg(pq + (size_t)p * C + c) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kMergeBatch; ++j)
          chan<1>(na, &ma, &qa, nb[j], mb + j, qb + j);
      }
    __syncthreads();
    sn[t] = na;
    sm[t] = ma;
    sq[t] = qa;
    __syncthreads();
    for (int s = pow2_above(S) >> 1; s > 0; s >>= 1) {
      if (on && sl < s && sl + s < S) {
        const int o = t + s * cpb;
        chan<1>(sn[t], sm + t, sq + t, sn[o], sm + o, sq + o);
      }
      __syncthreads();
    }
    if (on && sl == 0) {
      const size_t i = (size_t)g * C + c;
      const size_t GC = (size_t)G * C;
      const float mu = sm[t];
      const float var = __fdiv_rn(sq[t], sn[t]);
      const float sd = __fsqrt_rn(__fadd_rn(var, A.eps));
      const float a = __fdiv_rn(A.scale[i], sd);
      stats[i] = mu;
      stats[GC + i] = var;
      stats[2 * GC + i] = a;
      stats[3 * GC + i] = __fsub_rn(A.bias[i], __fmul_rn(mu, a));
      stats[4 * GC + i] = __fdiv_rn(1.f, sd);
      if (A.training) {
        A.new_mean[i] = __fadd_rn(__fmul_rn(A.momentum, A.run_mean[i]),
                                  __fmul_rn(A.keep, mu));
        A.new_var[i] = __fadd_rn(__fmul_rn(A.momentum, A.run_var[i]),
                                 __fmul_rn(A.keep, var));
      }
    }
  }
  if (A.training && t == 0)
    A.new_count[g] = __fadd_rn(A.run_count[g], 1.f);
}

// ws: sum g (G, P, C), sum g * (x - mean) (G, P, C), then G tickets.
// coef: (4, G, C) f32 sum(g) / N, rstd^2 * sum(g * (x - mean)) / N,
// dscale, dbias.
template <typename T, int VEC>
__global__ void __launch_bounds__(kStatThreads, 4)
bn_grad_reduce_kernel(const GradArgs A) {
  const T* __restrict__ gy = static_cast<const T*>(A.gy);
  const T* __restrict__ x = static_cast<const T*>(A.x);
  const int64_t rows = A.rows;
  const int C = (int)A.C, relu = A.relu;
  const float* __restrict__ stats = A.stats;
  float* __restrict__ ws = A.ws;
  float* __restrict__ coef = A.coef;
  __shared__ float sh[2 * VEC * kStatThreads];
  float* s1 = sh;
  float* s2 = sh + VEC * kStatThreads;
  const int G = gridDim.y, P = gridDim.x, g = blockIdx.y, t = threadIdx.x;
  const int tc = C / VEC, tr = kStatThreads / tc;
  const int cv = t % tc, rl = t / tc;
  const bool active = rl < tr;
  const size_t GP = (size_t)G * P, GC = (size_t)G * C;
  float* p1 = ws + (size_t)g * P * C;
  float* p2 = ws + GP * C + (size_t)g * P * C;
  unsigned* ticket = reinterpret_cast<unsigned*>(ws + 2 * GP * C);

  float sg[VEC], sgd[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) sg[k] = sgd[k] = 0.f;
  if (active) {
    float mu[VEC], a[VEC], b[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const size_t i = (size_t)g * C + cv * VEC + k;
      mu[k] = stats[i];
      a[k] = stats[2 * GC + i];
      b[k] = stats[3 * GC + i];
    }
    const int64_t base = (int64_t)g * rows * C;
    const Pack<T, VEC>* gg = reinterpret_cast<const Pack<T, VEC>*>(gy + base);
    const Pack<T, VEC>* xg = reinterpret_cast<const Pack<T, VEC>*>(x + base);
    const int64_t step = (int64_t)P * tr;
    for (int64_t r = (int64_t)blockIdx.x * tr + rl; r < rows; r += step) {
      const Pack<T, VEC> pg = gg[r * tc + cv], px = xg[r * tc + cv];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = Cvt<T>::in(px.e[k]);
        const float gm = relu_masked<T>(Cvt<T>::in(pg.e[k]), v, a[k], b[k],
                                        relu);
        sg[k] += gm;
        sgd[k] = fmaf(gm, v - mu[k], sgd[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s1[k * kStatThreads + t] = sg[k];
    s2[k * kStatThreads + t] = sgd[k];
  }
  __syncthreads();
  for (int s = pow2_above(tr) >> 1; s > 0; s >>= 1) {
    if (active && rl < s && rl + s < tr) {
      const int o = t + s * tc;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k * kStatThreads + t] += s1[k * kStatThreads + o];
        s2[k * kStatThreads + t] += s2[k * kStatThreads + o];
      }
    }
    __syncthreads();
  }
  if (t < tc) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      p1[(size_t)blockIdx.x * C + t * VEC + k] = s1[k * kStatThreads + t];
      p2[(size_t)blockIdx.x * C + t * VEC + k] = s2[k * kStatThreads + t];
    }
  }
  if (!last_block(ticket)) return;

  const int cpb = C < kStatThreads ? C : kStatThreads;
  const int S = kStatThreads / cpb, cl = t % cpb, sl = t / cpb;
  const float nrows = (float)rows;
  for (int c0 = 0; c0 < C; c0 += cpb) {
    const int c = c0 + cl;
    const bool on = sl < S && c < C;
    float a1 = 0.f, a2 = 0.f;
    if (on)
      for (int p0 = sl; p0 < P; p0 += S * kMergeBatch) {
        float b1[kMergeBatch], b2[kMergeBatch];
#pragma unroll
        for (int j = 0; j < kMergeBatch; ++j) {
          const int p = p0 + j * S;
          b1[j] = p < P ? __ldcg(p1 + (size_t)p * C + c) : 0.f;
          b2[j] = p < P ? __ldcg(p2 + (size_t)p * C + c) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kMergeBatch; ++j) {
          a1 += b1[j];
          a2 += b2[j];
        }
      }
    __syncthreads();
    s1[t] = a1;
    s2[t] = a2;
    __syncthreads();
    for (int s = pow2_above(S) >> 1; s > 0; s >>= 1) {
      if (on && sl < s && sl + s < S) {
        s1[t] += s1[t + s * cpb];
        s2[t] += s2[t + s * cpb];
      }
      __syncthreads();
    }
    if (on && sl == 0) {
      const size_t i = (size_t)g * C + c;
      const float rstd = stats[4 * GC + i];
      coef[i] = __fdiv_rn(s1[t], nrows);
      coef[GC + i] = __fmul_rn(__fmul_rn(rstd, rstd), __fdiv_rn(s2[t], nrows));
      coef[2 * GC + i] = __fmul_rn(rstd, s2[t]);
      coef[3 * GC + i] = s1[t];
    }
  }
}

// dx = a * ((gm - sum(gm) / N) - (x - mean) * rstd^2 * sum(gm * (x - mean))
// / N), in f32, stored once in T
template <typename T, int VEC>
__global__ void __launch_bounds__(kStatThreads, 4)
bn_grad_dx_kernel(const GradArgs A) {
  const T* __restrict__ gy = static_cast<const T*>(A.gy);
  const T* __restrict__ x = static_cast<const T*>(A.x);
  T* __restrict__ dx = static_cast<T*>(A.dx);
  const int64_t rows = A.rows;
  const int C = (int)A.C, relu = A.relu;
  const float* __restrict__ stats = A.stats;
  const float* __restrict__ coef = A.coef;
  const int G = gridDim.y, P = gridDim.x, g = blockIdx.y, t = threadIdx.x;
  const int tc = C / VEC, tr = kStatThreads / tc;
  const int cv = t % tc, rl = t / tc;
  if (rl >= tr) return;
  const size_t GC = (size_t)G * C;
  float mu[VEC], a[VEC], b[VEC], k1[VEC], k2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const size_t i = (size_t)g * C + cv * VEC + k;
    mu[k] = stats[i];
    a[k] = stats[2 * GC + i];
    b[k] = stats[3 * GC + i];
    k1[k] = coef[i];
    k2[k] = coef[GC + i];
  }
  const int64_t base = (int64_t)g * rows * C;
  const Pack<T, VEC>* gg = reinterpret_cast<const Pack<T, VEC>*>(gy + base);
  const Pack<T, VEC>* xg = reinterpret_cast<const Pack<T, VEC>*>(x + base);
  Pack<T, VEC>* dg = reinterpret_cast<Pack<T, VEC>*>(dx + base);
  const int64_t step = (int64_t)P * tr;
  for (int64_t r = (int64_t)blockIdx.x * tr + rl; r < rows; r += step) {
    const Pack<T, VEC> pg = gg[r * tc + cv], px = xg[r * tc + cv];
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = Cvt<T>::in(px.e[k]);
      const float gm = relu_masked<T>(Cvt<T>::in(pg.e[k]), v, a[k], b[k],
                                      relu);
      const float u = __fsub_rn(__fsub_rn(gm, k1[k]),
                                __fmul_rn(__fsub_rn(v, mu[k]), k2[k]));
      o.e[k] = Cvt<T>::out(__fmul_rn(a[k], u));
    }
    dg[r * tc + cv] = o;
  }
}

template <typename T>
bool stat_shape_ok(int64_t groups, int64_t rows, int64_t C, int vec,
                   int64_t parts) {
  return groups >= 1 && groups <= 65535 && rows >= 1 && C >= 1 &&
         parts >= 1 && parts <= 2147483647LL &&
         (vec == 1 || vec == (int)(16 / sizeof(T))) && C % vec == 0 &&
         C / vec <= kStatThreads;
}

// the groups' tickets, zeroed, then the kernel
template <typename T, int VEC>
int moments_launch(const MomentsArgs& a, cudaStream_t s) {
  unsigned* ticket = reinterpret_cast<unsigned*>(
      a.ws + (size_t)a.groups * a.parts * (2 * a.C + 1));
  cudaError_t err =
      cudaMemsetAsync(ticket, 0, a.groups * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  bn_moments_kernel<T, VEC>
      <<<dim3((unsigned)a.parts, (unsigned)a.groups), kStatThreads, 0, s>>>(
          a);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int grad_launch(const GradArgs& a, cudaStream_t s) {
  unsigned* ticket =
      reinterpret_cast<unsigned*>(a.ws + 2 * (size_t)a.groups * a.parts * a.C);
  cudaError_t err =
      cudaMemsetAsync(ticket, 0, a.groups * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  bn_grad_reduce_kernel<T, VEC>
      <<<dim3((unsigned)a.parts, (unsigned)a.groups), kStatThreads, 0, s>>>(
          a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_grad_dx_kernel<T, VEC><<<dim3((unsigned)a.dx_parts, (unsigned)a.groups),
                              kStatThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int moments_dispatch(const MomentsArgs& a, cudaStream_t s) {
  if (!stat_shape_ok<T>(a.groups, a.rows, a.C, a.vec, a.parts))
    return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  return a.vec == 1 ? moments_launch<T, 1>(a, s)
                    : moments_launch<T, kVec>(a, s);
}

template <typename T>
int grad_dispatch(const GradArgs& a, cudaStream_t s) {
  if (!stat_shape_ok<T>(a.groups, a.rows, a.C, a.vec, a.parts) ||
      a.dx_parts < 1 || a.dx_parts > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  return a.vec == 1 ? grad_launch<T, 1>(a, s) : grad_launch<T, kVec>(a, s);
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

// The BatchNorm moments of x (groups, rows, C) contiguous, with the fold
// and, when training, the running update: stats (5, groups, C) f32 mean,
// biased var, a, b, rstd; new_mean / new_var (groups, C) and new_count
// (groups) when training (else unused). ws: groups * parts * (2C + 1)
// floats of partials, then groups tickets (zeroed here). vec: 1, or the
// 16-byte vector of the dtype (C a multiple of it, x 16-byte aligned);
// parts: blocks a group. Returns the first CUDA error of the memset and
// the launch.
extern "C" int sfpl_bn_moments(const void* x, int64_t groups, int64_t rows,
                               int64_t C, int dtype, int vec, int64_t parts,
                               const float* scale, const float* bias,
                               const float* run_mean, const float* run_var,
                               const float* run_count, float* new_mean,
                               float* new_var, float* new_count,
                               float momentum, float keep, float eps,
                               int training, float* ws, float* stats,
                               void* stream) {
  const MomentsArgs a{x, groups, rows, C, vec, parts, scale, bias, run_mean,
                      run_var, run_count, new_mean, new_var, new_count,
                      momentum, keep, eps, training, ws, stats};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return moments_dispatch<float>(a, s);
    case 1: return moments_dispatch<__nv_bfloat16>(a, s);
    case 2: return moments_dispatch<__half>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward of the BatchNorm training op: gy, x, dx (groups, rows, C)
// contiguous in one dtype; stats as sfpl_bn_moments wrote them. ws:
// groups * parts * 2C floats of partials, then groups tickets (zeroed
// here); coef (4, groups, C) f32: sum(gm) / N, rstd^2 * sum(gm * (x -
// mean)) / N, dscale, dbias. parts: blocks a group of the reduction;
// dx_parts: of the dx pass. Returns the first CUDA error.
extern "C" int sfpl_bn_grad(const void* gy, const void* x, void* dx,
                            int64_t groups, int64_t rows, int64_t C,
                            int dtype, int vec, int64_t parts,
                            int64_t dx_parts, const float* stats, int relu,
                            float* ws, float* coef, void* stream) {
  const GradArgs a{gy, x, dx, groups, rows, C, vec, parts, dx_parts, stats,
                   relu, ws, coef};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return grad_dispatch<float>(a, s);
    case 1: return grad_dispatch<__nv_bfloat16>(a, s);
    case 2: return grad_dispatch<__half>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
