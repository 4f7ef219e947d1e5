// K7: flash attention forward, GQA, causal / sliding-window / ragged-edge
// masks, in the model's (B, S, heads, D) layout.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (Pallas, TPU): a (batch, q_head, q_block, kv_block) grid whose last axis
// is the sequential reduction, with running max / sum / accumulator in VMEM
// scratch, fully masked blocks gated off with `relevant`, and the caller
// transposing to (B, H, S, D) and padding S to the block size.
//
// Bound on Hopper: operations. A causal prefill at qwen3-8b's shape (B 4,
// S 4096, 32 q heads over 8 kv heads, D 128, bf16) does 5.5e11 FLOPs per
// layer over 0.13 GB of q/k/v/o: 0.56 ms at the 989 TFLOP/s bf16 tensor
// rate against 0.04 ms for the bytes. So the work has to run on the tensor
// cores and the scores must never reach device memory.
//
// Design (bf16, the path's dtype). One block per (64-row q tile, q head,
// batch row), 4 warps of 16 q rows each. Q stays in registers as mma A
// fragments for the whole block. The block walks only over the kv tiles
// that the causal, window and sequence-length bounds leave live (the TPU
// kernel's `relevant` test moved into the loop bounds); each 64-key K and V
// tile is staged in shared memory (rows padded by 16 bytes so the fragment
// loads are free of bank conflicts). S = Q K^T runs on mma.sync.m16n8k16
// (bf16 in, f32 accumulate); it is scaled by scale * log2(e) and masked
// with NEG_INF (causal iq >= ik, window iq - ik < window, ik < Skv: the
// ragged edge is masked here, nothing is padded) only on tiles that cross
// a bound. Running max and sum stay in f32 registers, the f32 accumulator
// is rescaled per tile, and the finish maps l == 0 to 1, as the TPU kernel
// does. P is rounded to bf16 for the P V mma, as FlashAttention-2 does,
// where the TPU kernel keeps P in f32: the difference is covered by the
// bf16 tolerance (2e-2) and the sum l is taken from the f32 P. Q head h
// reads kv head h / (H / K), so K and V are never repeated in memory. No
// transpose or padding copy is made: q, k and v are read through their
// strides and o is written in (B, S, H, D).
//
// f32 inputs (the test dtype, not the path's) take a plain-FMA loop of the
// same structure: 16 q rows per block, 8 threads per row each holding D/8
// of q and of the accumulator, 32-key K/V tiles in shared memory, P kept
// in f32 as the TPU kernel keeps it.
//
// Not yet: wgmma, TMA, warp specialisation, a persistent grid, and
// overlapping the next tile's loads with this tile's math (cp.async).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- bf16 tensor-core path -------------------------------------------------
constexpr int kBQ = 64;            // q rows per block: 4 warps x 16
constexpr int kBK = 64;            // keys per kv tile
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b, m16n8k16, A row-major, B column-major, bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Strides {   // in elements: batch, sequence, head (the last dim is 1)
  int64_t b, s, h;
};

// Half-open range [lo, hi) of kv tiles that hold at least one unmasked key
// for q rows [q0, q0 + rows).
__device__ __forceinline__ void live_tiles(int q0, int rows, int tile,
                                           int skv, int causal, int window,
                                           int* lo, int* hi) {
  int k_hi = skv;
  if (causal) k_hi = min(k_hi, q0 + rows);          // keys ik <= iq
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;   // iq - ik < window
  *lo = k_lo / tile;
  *hi = k_hi > k_lo ? (k_hi + tile - 1) / tile : *lo;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 int sq, int skv, int group, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale_log2, int causal,
                 int window) {
  constexpr int LD = D + 8;          // padded smem row, elements
  constexpr int KT = D / 16;         // k-steps over D in Q K^T
  constexpr int NT = kBK / 8;        // n-tiles over the keys of a tile
  constexpr int DT = D / 8;          // n-tiles over D in P V
  constexpr int CPR = D / 8;         // 16-byte chunks per row
  __shared__ __align__(16) uint16_t Ks[kBK * LD];
  __shared__ __align__(16) uint16_t Vs[kBK * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this thread's rows
  const uint16_t* qb = q + b * qs.b + h * qs.h;
  const uint16_t* kb = k + b * ks.b + (h / group) * ks.h;
  const uint16_t* vb = v + b * vs.b + (h / group) * vs.h;

  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < sq ? ld_u32(qb + r0 * qs.s + c) : 0u;
    qf[kk][1] = r1 < sq ? ld_u32(qb + r1 * qs.s + c) : 0u;
    qf[kk][2] = r0 < sq ? ld_u32(qb + r0 * qs.s + c + 8) : 0u;
    qf[kk][3] = r1 < sq ? ld_u32(qb + r1 * qs.s + c + 8) : 0u;
  }
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  int t_lo, t_hi;
  live_tiles(q0, kBQ, kBK, skv, causal, window, &t_lo, &t_hi);
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                           // last tile fully consumed
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int r = c / CPR, cc = (c % CPR) * 8, key = k0 + r;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (key < skv) {
        kx = *reinterpret_cast<const uint4*>(kb + key * ks.s + cc);
        vx = *reinterpret_cast<const uint4*>(vb + key * vs.s + cc);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LD + cc]) = kx;
      *reinterpret_cast<uint4*>(&Vs[r * LD + cc]) = vx;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint16_t* kp = &Ks[(n * 8 + g) * LD + kk * 16 + 2 * t];
        mma_bf16(s[n], qf[kk], ld_u32(kp), ld_u32(kp + 8));
      }
    }

    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int iq = e < 2 ? r0 : r1;
          const int ik = k0 + n * 8 + 2 * t + (e & 1);
          const bool ok = ik < skv && (!causal || iq >= ik) &&
                          (window <= 0 || iq - ik < window);
          if (!ok) x = kNegInf;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // the four threads of a quad hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + ps0;          // per-thread partial sums; reduced at the end
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= a0;
      acc[i][1] *= a0;
      acc[i][2] *= a1;
      acc[i][3] *= a1;
    }
    // P V: the accumulator layout of two adjacent 8-key n-tiles is the A
    // fragment layout of one 16-key k-step.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        const uint16_t* vp = &Vs[(j * 16 + 2 * t) * LD + i * 8 + g];
        const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[LD] << 16);
        const uint32_t b1 = (uint32_t)vp[8 * LD] | ((uint32_t)vp[9 * LD] << 16);
        mma_bf16(acc[i], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (l0 == 0.f) l0 = 1.f;
  if (l1 == 0.f) l1 = 1.f;
  uint16_t* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int c = i * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * os.s + c) =
          pack_bf16(acc[i][0] / l0, acc[i][1] / l0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * os.s + c) =
          pack_bf16(acc[i][2] / l1, acc[i][3] / l1);
  }
}

// ---- f32 plain-FMA path ----------------------------------------------------
constexpr int kRowsF = 16;         // q rows per block
constexpr int kParts = 8;          // threads per q row
constexpr int kBKF = 32;           // keys per kv tile

template <int D>
__global__ void __launch_bounds__(kRowsF * kParts)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int sq, int skv, int group, Strides qs, Strides ks,
                     Strides vs, Strides os, float scale, int causal,
                     int window) {
  constexpr int DP = D / kParts;     // dims per thread: d = i * kParts + p
  __shared__ float Ks[kBKF][D];
  __shared__ float Vs[kBKF][D];
  const int tid = threadIdx.x, p = tid % kParts;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kRowsF, iq = q0 + tid / kParts;
  const float* kb = k + b * ks.b + (h / group) * ks.h;
  const float* vb = v + b * vs.b + (h / group) * vs.h;
  const float* qr = q + b * qs.b + h * qs.h + (int64_t)iq * qs.s;

  float qv[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qv[i] = iq < sq ? qr[i * kParts + p] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  int t_lo, t_hi;
  live_tiles(q0, kRowsF, kBKF, skv, causal, window, &t_lo, &t_hi);
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kBKF;
    __syncthreads();
    for (int c = threadIdx.x; c < kBKF * D; c += blockDim.x) {
      const int r = c / D, d = c % D, key = k0 + r;
      Ks[r][d] = key < skv ? kb[key * ks.s + d] : 0.f;
      Vs[r][d] = key < skv ? vb[key * vs.s + d] : 0.f;
    }
    __syncthreads();
    float s[kBKF];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) part = fmaf(qv[i], Ks[j][i * kParts + p], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      const int ik = k0 + j;
      const bool ok = ik < skv && (!causal || iq >= ik) &&
                      (window <= 0 || iq - ik < window);
      s[j] = ok ? part * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx), a = expf(m - mn);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      s[j] = expf(s[j] - mn);
      ps += s[j];
    }
    l = l * a + ps;
    m = mn;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      float x = acc[i] * a;
#pragma unroll
      for (int j = 0; j < kBKF; ++j) x = fmaf(s[j], Vs[j][i * kParts + p], x);
      acc[i] = x;
    }
  }
  if (l == 0.f) l = 1.f;
  if (iq < sq) {
    float* orow = o + b * os.b + h * os.h + (int64_t)iq * os.s;
#pragma unroll
    for (int i = 0; i < DP; ++i) orow[i * kParts + p] = acc[i] / l;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t sq, int64_t skv, int64_t H, int group, const Strides* st,
           float scale, int causal, int window, int dtype,
           cudaStream_t stream) {
  if (dtype == 1) {
    dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
    flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), (int)sq,
        (int)skv, group, st[0], st[1], st[2], st[3], scale * kLog2e, causal,
        window);
  } else {
    dim3 grid((unsigned)((sq + kRowsF - 1) / kRowsF), (unsigned)H,
              (unsigned)B);
    flash_fwd_f32_kernel<D><<<grid, kRowsF * kParts, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), (int)sq,
        (int)skv, group, st[0], st[1], st[2], st[3], scale, causal, window);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Skv, K, D); unit stride on D. strides:
// 12 int64 in elements, (batch, sequence, head) for q, k, v, o in turn.
// dtype: 0 float32, 1 bfloat16. window <= 0 means none. Returns
// cudaGetLastError() after the launch.
extern "C" int sfpl_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int64_t B,
                                    int64_t sq, int64_t skv, int64_t H,
                                    int64_t K, int64_t D,
                                    const int64_t* strides, float scale,
                                    int causal, int64_t window, int dtype,
                                    void* stream) {
  if (B <= 0 || sq <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0 || skv <= 0 || sq > 2147483647LL ||
      skv > 2147483647LL || window > 2147483647LL || B > 65535 ||
      H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = (int)(H / K), w = window > 0 ? (int)window : 0;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, B, sq, skv, H, group, st, scale, causal, w, dtype, s);
    case 64: return launch<64>(q, k, v, o, B, sq, skv, H, group, st, scale, causal, w, dtype, s);
    case 128: return launch<128>(q, k, v, o, B, sq, skv, H, group, st, scale, causal, w, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
