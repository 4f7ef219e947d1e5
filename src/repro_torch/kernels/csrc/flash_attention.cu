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
// layer over 0.13 GB of q/k/v/o: 0.556 ms at the 989 TFLOP/s bf16 tensor
// rate against 0.04 ms for the bytes. So the work has to run on the tensor
// cores at their full rate (wgmma), fed without stalls, and the scores must
// never reach device memory.
//
// Design of the bf16 path at D 64, 128 and 256 (flash_fwd_hopper), in the
// shape of FlashAttention-3:
// - One CTA of 384 threads per (128-row q tile, q head, batch row), one CTA
//   an SM: warpgroup 0 is the producer, warpgroups 1 and 2 are consumers
//   of 64 q rows each. ptxas gives the kernel 168 registers a thread at
//   launch; the producer drops to 24 (setmaxnreg.dec) and the consumers
//   rise to 240 (setmaxnreg.inc).
// - Tiles (struct Smem): Q is 128 rows; K and V tiles are 128 keys, or 64
//   at D 256 (kv_rows), in a 2-stage ring. Dynamic shared memory: 164,936
//   bytes at D 128 (Q 32 KiB, 4 x 32 KiB of K and V), 197,704 at D 256 (Q
//   64 KiB, 4 x 32 KiB): 128-key tiles at D 256 would need 320 KiB.
// - Loads by TMA. The wrapper computes each tensor map's geometry
//   (kernel.py::tma_geometry): 4-D (D, heads, S, B) with the tensor's byte
//   strides, so strided views of a packed qkv load as they are. Boxes are
//   64 columns (128 bytes, the widest box the 128-byte swizzle takes) by
//   the tile's rows, so a row of D arrives as D / 64 boxes of 8-row x
//   128-byte swizzle atoms: a Q box is 16 KiB, a K or V box 16 KiB (128
//   keys) or 8 KiB (64 keys). Rows past S are zero-filled by TMA and
//   masked.
// - One producer thread loads the Q tile once, then K and V tiles into the
//   ring. Each stage has "full" mbarriers for K and for V (expect_tx of
//   the tile's bytes) and "empty" ones: every consumer thread arrives on
//   the K one once its Q K^T wgmma retired and on the V one once its P V
//   wgmma retired, so K is refilled while P V still reads V. The phase
//   parity flips every wrap of the ring.
// - S = Q K^T on wgmma.m64n128k16 (m64n64k16 at D 256) with Q and K from
//   shared memory, both K-major (128-byte swizzle, SBO 1024 bytes between
//   8-row groups, k-steps 32 bytes apart inside an atom; across boxes Q
//   steps by its 16 KiB box and K by its own box, 8 KiB at D 256).
// - Online softmax in f32 on the accumulator: a quad of threads holds one
//   row, so the row max and sum take two __shfl_xor_sync. The max is taken
//   on the raw scores and P = ex2.approx.ftz(S * scale * log2(e) - m) costs
//   one FFMA and one MUFU a score (so the scale must be >= 0: the wrapper
//   moves a negative one into q); rows with no live key yet keep a zero
//   contribution (m = -inf guarded); the finish maps l == 0 to 1, as the
//   TPU kernel does. Masks (causal iq >= ik, window iq - ik < window, ik < Skv)
//   are applied only on tiles that cross a bound for a consumer's 64 rows,
//   chosen once a tile (a template argument, so unmasked tiles run without
//   a per-score branch); kv tiles are walked from the diagonal down, so
//   the masked tiles come first. At D 256 two 64-key tiles cross a q
//   tile's diagonal, and the upper one is wholly masked for the first
//   consumer's rows: it runs masked (P = 0). Skipping such tiles without
//   a product was measured slower (PERF.md section 6, PR 18).
// - O += P V on the register-A form of wgmma (m64n64k16 at D 64, m64n128k16
//   at D 128, two m64n128k16 on the accumulator's halves at D 256): P is
//   rounded to bf16 in registers (the accumulator of two 8-column groups
//   is the A fragment of one 16-key k-step, as in FlashAttention-2), and V
//   is read from shared memory in its stored (key, d) layout, MN-major for
//   this product, through the instruction's transpose flag (LBO the V box
//   between 64-column boxes, SBO 1024 bytes between 8-key groups). l is
//   summed from the f32 P. At D 256 a consumer thread holds O in 128 f32
//   registers, S in 32 and P in 16: no spill under the 240 of setmaxnreg.
// - Each consumer runs Q K^T, softmax, P V in turn; the two consumers
//   drift apart on their own, so one's softmax overlaps the other's wgmma.
// - Schedule: the grid is (q head, batch row, q tile) with the q tile
//   reversed, so the CTAs launch heaviest causal tile first across all
//   heads and batch rows, and the H / K q heads that share a kv head are
//   adjacent in launch order, so their K / V tiles meet in L2. A launch
//   order was chosen over a persistent grid: it needs no tile counter, and
//   with ~31 waves of CTAs at the prefill's shape the heaviest-first order
//   already leaves only the lightest tiles for the tail.
// - Epilogue: each consumer normalises its 64 rows, rounds to bf16, stages
//   them in its own (now free) rows of the Q buffer in the swizzled layout
//   (exactly the Q tile's 64 KiB at D 256), and writes o in (B, S, H, D)
//   with 16-byte stores, skipping rows >= Sq.
//
// Measured against this design on the card (PERF.md section 6):
// ping-pong of the two consumers on named barriers, and overlapping one
// tile's softmax with the next tile's Q K^T inside a warpgroup, were each
// slower, and a third ring stage changed nothing, so none is kept.
//
// bf16 at D 32 keeps the FlashAttention-2-style mma.sync kernel
// (flash_fwd_kernel): D 32's 64-byte rows want the 64-byte swizzle and a
// different tiling. It served D 256 too (32-key tiles) until the Hopper
// kernel, 5.8-7.8x faster there (PERF.md section 6), took that head dim.
// f32 inputs (the test dtype, not the path's) take a plain-FMA loop of the
// same structure (flash_fwd_f32_kernel), whose key tile halves to 16 keys
// at D 256 to keep its static K and V tiles under the 48 KB static limit.
//
// Not yet: a persistent grid, a TMA store of o, 2-CTA clusters that
// multicast each K / V tile to the two q heads that share it, FA3's 80-key
// tiles at D 256 (~230 KB of shared memory), and the Hopper kernel at D 32.
#include <cuda.h>            // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- bf16 mma.sync path, D 32 ----------------------------------------------
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

// keys per kv tile: 32, or 16 at D 256 to keep K and V under 48 KB
__host__ __device__ constexpr int keys_f32(int d) { return d > 128 ? 16 : 32; }

template <int D>
__global__ void __launch_bounds__(kRowsF * kParts)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int sq, int skv, int group, Strides qs, Strides ks,
                     Strides vs, Strides os, float scale, int causal,
                     int window) {
  constexpr int kBKF = keys_f32(D);
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

// ---- bf16 Hopper path, D 64, 128 and 256 ------------------------------------
namespace hopper {

constexpr int kBM = 128;            // q rows per CTA: 2 consumer warpgroups
constexpr int kStages = 2;          // K / V ring depth
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBoxCols = 64;        // 128 bytes of bf16: the swizzle's width
constexpr uint32_t kAtom = 1024;    // 8 rows x 128 bytes, one swizzle atom

// keys per K / V tile: 128, or 64 at D 256, where Q (64 KiB) and two
// stages of 128-key K and V tiles (4 x 64 KiB) would not fit in 227 KB
__host__ __device__ constexpr int kv_rows(int d) { return d > 128 ? 64 : 128; }

// Shared memory of one CTA, in bytes from a 1024-byte aligned base. A
// tile is D / 64 boxes of (rows x 128 bytes): 128 rows for Q, kBN for K
// and V.
template <int D>
struct Smem {
  static constexpr int kBN = kv_rows(D);
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kQBox = kBM * 128;               // bytes of a Q box
  static constexpr int kKVBox = kBN * 128;              // of a K or V box
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKVTile = kBoxes * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kQTile;                     // + stage * kKVTile
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBar = kV + kStages * kKVTile;
  // barriers: Q full; K full, V full, K empty and V empty per stage
  static constexpr int kNumBars = 1 + 4 * kStages;
  static constexpr int kBytes = kBar + 8 * kNumBars + 1024;   // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x on the MUFU unit, subnormal results flushed to 0 (which a softmax
// term 2^-126 below the row max would not change in f32)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers in place around an asynchronous wgmma so the compiler
// neither reads them early nor moves their writes across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (m64n128, f32) += A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n64, f32) += A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[OFF .. OFF + 63] (m64n128, f32) += A (registers, bf16) * B (smem,
// MN-major: trans-b)
template <int N, int OFF>
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[N],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]),
        "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]),
        "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]),
        "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]),
        "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]),
        "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]),
        "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n64, f32) += A (registers, bf16) * B (smem, MN-major: trans-b)
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S (64 x kBN) = Q K^T for the 64 q rows at sQw and the kBN keys at sKs,
// both K-major in 128-byte swizzled boxes: k-steps 32 bytes apart inside
// a box's 128-byte rows; across the D / 64 boxes Q's are kQBox apart and
// K's kKVBox (16 and 8 KiB at D 256, both 16 KiB at D 128).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kv_rows(D) / 2],
                                         uint32_t sQw, uint32_t sKs) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in_box = (kk % 4) * 32;
    const uint64_t da = sw128_desc(sQw + (kk / 4) * L::kQBox + in_box, 16,
                                   kAtom);
    const uint64_t db = sw128_desc(sKs + (kk / 4) * L::kKVBox + in_box, 16,
                                   kAtom);
    if constexpr (L::kBN == 128)
      wgmma_ss_m64n128(sc, da, db, kk > 0);
    else
      wgmma_ss_m64n64(sc, da, db, kk > 0);
  }
}

// O (64 x D) += P V for the kBN keys at sVs, V MN-major (transposed B):
// 16-key k-steps 2 KiB apart, 8-key groups 1 KiB apart (SBO), 64-column
// boxes kKVBox apart (LBO). D 256 takes two n128 products a k-step, on
// the accumulator's halves: columns 128 h .. 128 h + 127 are boxes 2 h and
// 2 h + 1.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[D / 2], const uint32_t (&pa)[kv_rows(D) / 16][4],
    uint32_t sVs) {
  using L = Smem<D>;
#pragma unroll
  for (int j = 0; j < L::kBN / 16; ++j) {
    const uint32_t at = sVs + j * 16 * 128;
    if constexpr (D == 64) {
      wgmma_rs_m64n64_tb(acc, pa[j], sw128_desc(at, L::kKVBox, kAtom));
    } else {
      wgmma_rs_m64n128_tb<D / 2, 0>(acc, pa[j],
                                    sw128_desc(at, L::kKVBox, kAtom));
      if constexpr (D == 256)
        wgmma_rs_m64n128_tb<D / 2, 64>(
            acc, pa[j], sw128_desc(at + 2 * L::kKVBox, L::kKVBox, kAtom));
    }
  }
}

// One tile of the online softmax on S (the kBN keys from k0, this
// thread's rows r0 and r1 = r0 + 8), in place: mask (kMask: the tile
// crosses a bound), take the row max of the raw scores, update the running
// max m (in units of scale * log2(e), so scale_log2 must be >= 0) and
// partial sum l, and leave P = exp2(S * scale_log2 - m) in sc as f32, one
// FFMA and one MUFU a score. Returns in a0 and a1 the factors by which the
// accumulator must be rescaled. The mask is a template argument so that
// unmasked tiles carry no per-score branch.
template <bool kMask, int kBN>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kBN / 2], float& m0, float& m1, float& l0, float& l1,
    float& a0, float& a1, int k0, int r0, int r1, int t, int skv, int causal,
    int window, float scale_log2) {
  const float kInf = __int_as_float(0x7f800000);
  auto live = [&](int j, int e) {
    const int iq = e < 2 ? r0 : r1;
    const int ik = k0 + 8 * j + 2 * t + (e & 1);
    return ik < skv && (!causal || iq >= ik) &&
           (window <= 0 || iq - ik < window);
  };
  float mx0 = -kInf, mx1 = -kInf;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = !kMask || live(j, e) ? sc[4 * j + e] : -kInf;
    mx0 = fmaxf(mx0, fmaxf(x[0], x[1]));
    mx1 = fmaxf(mx1, fmaxf(x[2], x[3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // -inf stays -inf (not -inf * 0 = NaN at scale 0)
  const float mn0 = fmaxf(m0, mx0 == -kInf ? -kInf : mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 == -kInf ? -kInf : mx1 * scale_log2);
  // a row with no live key so far subtracts 0, so its exp2 stay 0
  const float ms0 = mn0 == -kInf ? 0.f : mn0;
  const float ms1 = mn1 == -kInf ? 0.f : mn1;
  a0 = exp2_ftz(m0 - ms0);
  a1 = exp2_ftz(m1 - ms1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          exp2_ftz(fmaf(sc[4 * j + e], scale_log2, e < 2 ? -ms0 : -ms1));
      sc[4 * j + e] = !kMask || live(j, e) ? p : 0.f;
    }
    ps0 += sc[4 * j] + sc[4 * j + 1];
    ps1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * a0 + ps0;      // per-thread partial sums; reduced at the end
  l1 = l1 * a1 + ps1;
}

// softmax_tile for the kv tile kt, masked only if it crosses the causal
// diagonal, the window's lower bound or Skv for the rows qw0..qw0 + 63.
template <int kBN>
__device__ __forceinline__ void softmax_kv_tile(
    float (&sc)[kBN / 2], float& m0, float& m1, float& l0, float& l1,
    float& a0, float& a1, int kt, int qw0, int r0, int r1, int t, int skv,
    int causal, int window, float scale_log2) {
  const int k0 = kt * kBN;
  if (k0 + kBN > skv || (causal && k0 + kBN - 1 > qw0) ||
      (window > 0 && qw0 + 63 - k0 >= window))
    softmax_tile<true, kBN>(sc, m0, m1, l0, l1, a0, a1, k0, r0, r1, t, skv,
                            causal, window, scale_log2);
  else
    softmax_tile<false, kBN>(sc, m0, m1, l0, l1, a0, a1, k0, r0, r1, t, skv,
                             causal, window, scale_log2);
}

// Rescale the accumulator and round P to bf16 A fragments (8-column
// groups 2j and 2j + 1 of S are the A fragment of k-step j).
template <int D>
__device__ __forceinline__ void rescale_and_pack(
    float (&acc)[D / 2], const float (&sc)[kv_rows(D) / 2],
    uint32_t (&pa)[kv_rows(D) / 16][4], float a0, float a1) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[4 * i] *= a0;
    acc[4 * i + 1] *= a0;
    acc[4 * i + 2] *= a1;
    acc[4 * i + 3] *= a1;
  }
#pragma unroll
  for (int j = 0; j < kv_rows(D) / 16; ++j) {
    pa[j][0] = pack_bf16(sc[8 * j], sc[8 * j + 1]);
    pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
    pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
    pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_hopper(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 uint16_t* __restrict__ o, Strides os, int sq, int skv,
                 int group, float scale_log2, int causal, int window) {
  using L = Smem<D>;
  constexpr int kBN = L::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gq = smem_raw + (base - raw) + L::kQ;   // generic view of Q
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  // per stage s, at + 8s: K full, V full, K empty, V empty
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * kStages,
                 bar_ke = bar_v + 8 * kStages, bar_ve = bar_ke + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // heaviest tiles first
  int t_lo, t_hi;
  live_tiles(q0, kBM, kBN, skv, causal, window, &t_lo, &t_hi);
  const int n_tiles = t_hi - t_lo;   // walked from t_hi - 1 down to t_lo

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      // every consumer thread arrives: no divergent code near the wgmma
      mbar_init(bar_ke + 8 * s, kConsumers * 128);
      mbar_init(bar_ve + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(bar_q, L::kQTile);
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load_4d(sQ + x * L::kQBox, &qmap, bar_q, x * kBoxCols, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, k0 = (t_hi - 1 - it) * kBN;
        const uint32_t parity = ((it / kStages) & 1) ^ 1;
        mbar_wait(bar_ke + 8 * s, parity);     // the K stage was read
        mbar_expect_tx(bar_k + 8 * s, L::kKVTile);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(sK + s * L::kKVTile + x * L::kKVBox, &kmap,
                      bar_k + 8 * s, x * kBoxCols, hk, k0, b);
        mbar_wait(bar_ve + 8 * s, parity);     // the V stage was read
        mbar_expect_tx(bar_v + 8 * s, L::kKVTile);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(sV + s * L::kKVTile + x * L::kKVBox, &vmap,
                      bar_v + 8 * s, x * kBoxCols, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int qw0 = q0 + 64 * c;                 // this warpgroup's first row
    const int r0 = qw0 + 16 * warp + g, r1 = r0 + 8;   // this thread's rows
    const float kInf = __int_as_float(0x7f800000);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = -kInf, m1 = -kInf, l0 = 0.f, l1 = 0.f;
    float sc[kBN / 2];             // S of one tile: 64 x kBN, f32
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    uint32_t pa[kBN / 16][4];      // P of one tile as bf16 A fragments

    mbar_wait(bar_q, 0);
    float a0, a1;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int kt = t_hi - 1 - it, k0 = kt * kBN;
      // S = Q K^T, then release K; the softmax leaves P in sc
      mbar_wait(bar_k + 8 * s, parity);
      wg_fence();
      issue_qk<D>(sc, sQ + 64 * c * 128, sK + s * L::kKVTile);
      wg_commit();
      wg_wait_all();
      fence_regs(sc);
      mbar_arrive(bar_ke + 8 * s);
      softmax_kv_tile<kBN>(sc, m0, m1, l0, l1, a0, a1, kt, qw0, r0, r1, t,
                           skv, causal, window, scale_log2);
      rescale_and_pack<D>(acc, sc, pa, a0, a1);
      // O += P V, then release V
      mbar_wait(bar_v + 8 * s, parity);
      fence_regs(acc);
      wg_fence();
      issue_pv<D>(acc, pa, sV + s * L::kKVTile);
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      mbar_arrive(bar_ve + 8 * s);
    }

    // ---- epilogue: normalise, stage in this warpgroup's Q rows, store ----
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    const int row0 = 64 * c + 16 * warp + g;     // row in the tile; & 7 == g
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int at = (j / 8) * L::kQBox + (((j % 8) ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(gq + at + row0 * 128) =
          pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(gq + at + (row0 + 8) * 128) =
          pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    named_sync(1 + c, 128);
    constexpr int kChunks = D / 8;               // 16-byte chunks per row
    uint16_t* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int i = 0; i < 64 * kChunks / 128; ++i) {
      const int id = i * 128 + tid;
      const int row = 64 * c + id / kChunks, cc = id % kChunks;
      const uint4 val = *reinterpret_cast<const uint4*>(
          gq + (cc / 8) * L::kQBox + row * 128 + (((cc % 8) ^ (row & 7)) << 4));
      if (q0 + row < sq)
        *reinterpret_cast<uint4*>(ob + (int64_t)(q0 + row) * os.s + cc * 8) =
            val;
    }
  }
}

// The cuTensorMapEncodeTiled driver entry, fetched through the runtime so
// the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Returned when cuTensorMapEncodeTiled refuses a map: kEncodeError + CUresult.
constexpr int kEncodeError = 10000;

template <int D>
int launch(const void* const* ptrs, void* o, const int64_t* geom, Strides os,
           int64_t B, int64_t sq, int64_t skv, int64_t H, int group,
           float scale, int causal, int window, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const int64_t* g = geom + 11 * i;   // dims[4], strides[3], box[4]
    const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1],
                                (cuuint64_t)g[2], (cuuint64_t)g[3]};
    const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5],
                                   (cuuint64_t)g[6]};
    const cuuint32_t box[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8],
                               (cuuint32_t)g[9], (cuuint32_t)g[10]};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const int rows = i == 0 ? kBM : Smem<D>::kBN;
    if (g[0] != D || box[0] != kBoxCols || box[1] != 1 || box[2] != rows ||
        box[3] != 1)
      return (int)cudaErrorInvalidValue;
    const CUresult r = encode(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptrs[i]),
        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_hopper<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::kBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)H, (unsigned)B, (unsigned)((sq + kBM - 1) / kBM));
  flash_fwd_hopper<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<uint16_t*>(o), os, (int)sq,
      (int)skv, group, scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace hopper

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t sq, int64_t skv, int64_t H, int group, const Strides* st,
           float scale, int causal, int window, int dtype,
           cudaStream_t stream) {
  if (dtype == 1) {
    if constexpr (D != 32) {
      return (int)cudaErrorInvalidValue;                        // Hopper path
    } else {
      dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
      flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
          static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
          static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o),
          (int)sq, (int)skv, group, st[0], st[1], st[2], st[3],
          scale * kLog2e, causal, window);
    }
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

bool shape_ok(int64_t B, int64_t sq, int64_t skv, int64_t H, int64_t K,
              int64_t window) {
  return K > 0 && H % K == 0 && skv > 0 && sq <= 2147483647LL &&
         skv <= 2147483647LL && window <= 2147483647LL && B <= 65535 &&
         H <= 65535;
}

}  // namespace

// The mma.sync and plain-FMA kernels: f32 at D 32, 64, 128 and 256, bf16 at
// D 32.
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
  if (!shape_ok(B, sq, skv, H, K, window) || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && D != 32))
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
    case 256: return launch<256>(q, k, v, o, B, sq, skv, H, group, st, scale, causal, w, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The Hopper kernel: bf16 at D 64, 128 and 256. geom: 33 int64, for q, k, v in
// turn the tensor map's dims (D, heads, S, B), byte strides (heads, S, B)
// and box (64, 1, rows, 1) (rows: 128 for q; kv_rows(D) for k and v), as
// kernel.py::tma_geometry computes them.
// o: (B, Sq, H, D) with element strides ostrides (batch, sequence, head),
// unit stride on D, 16-byte aligned rows. window <= 0 means none. Returns
// cudaGetLastError() after the launch, or 10000 + the CUresult when a
// tensor map cannot be encoded.
extern "C" int sfpl_flash_attention_tma(const void* q, const void* k,
                                        const void* v, void* o,
                                        const int64_t* geom,
                                        const int64_t* ostrides, float scale,
                                        int causal, int64_t window,
                                        void* stream) {
  const int64_t D = geom[0], H = geom[1], sq = geom[2], B = geom[3];
  const int64_t K = geom[11 + 1], skv = geom[11 + 2];
  if (B <= 0 || sq <= 0 || H <= 0) return 0;
  if (!shape_ok(B, sq, skv, H, K, window) || geom[22 + 1] != K ||
      geom[22 + 2] != skv || geom[11] != D || geom[22] != D ||
      geom[11 + 3] != B || geom[22 + 3] != B ||
      (sq + hopper::kBM - 1) / hopper::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides os{ostrides[0], ostrides[1], ostrides[2]};
  const void* ptrs[3] = {q, k, v};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = (int)(H / K), w = window > 0 ? (int)window : 0;
  switch (D) {
    case 64: return hopper::launch<64>(ptrs, o, geom, os, B, sq, skv, H, group, scale, causal, w, s);
    case 128: return hopper::launch<128>(ptrs, o, geom, os, B, sq, skv, H, group, scale, causal, w, s);
    case 256: return hopper::launch<256>(ptrs, o, geom, os, B, sq, skv, H, group, scale, causal, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The resources of the kernel that serves (D, dtype): registers a thread at
// launch, local memory a thread (the stack frame, where spills go: 0 means
// none), static and dynamic shared memory a CTA, and CTAs an SM at the
// launch's block size. Returns a cudaError_t.
extern "C" int sfpl_flash_attention_resources(int64_t D, int dtype,
                                              int* regs, int* local_bytes,
                                              int* smem_static,
                                              int* smem_dynamic,
                                              int* ctas_per_sm) {
  const void* fn = nullptr;
  int threads = 0, dyn = 0;
  if (dtype == 1 && D == 256) {
    fn = reinterpret_cast<const void*>(hopper::flash_fwd_hopper<256>);
    threads = hopper::kThreads;
    dyn = hopper::Smem<256>::kBytes;
  } else if (dtype == 1 && D == 128) {
    fn = reinterpret_cast<const void*>(hopper::flash_fwd_hopper<128>);
    threads = hopper::kThreads;
    dyn = hopper::Smem<128>::kBytes;
  } else if (dtype == 1 && D == 64) {
    fn = reinterpret_cast<const void*>(hopper::flash_fwd_hopper<64>);
    threads = hopper::kThreads;
    dyn = hopper::Smem<64>::kBytes;
  } else if (dtype == 1 && D == 32) {
    fn = reinterpret_cast<const void*>(flash_fwd_kernel<32>);
    threads = kThreads;
  } else if (dtype == 0 && D == 256) {
    fn = reinterpret_cast<const void*>(flash_fwd_f32_kernel<256>);
    threads = kRowsF * kParts;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (dyn > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_static = (int)attr.sharedSizeBytes;
  *smem_dynamic = dyn;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn,
                                                            threads, dyn);
}
