// K8: the sLSTM time recurrence (xLSTM's scalar-memory cell with stabilized
// exponential gating), forward only, in the model's (B, S, H, Dh) layout.
//
// Replaces src/repro/kernels/slstm_scan/kernel.py::slstm_scan_pallas (Pallas,
// TPU): a (batch block, time chunk) grid whose time axis is sequential, with
// (c, n, m, h) in VMEM scratch across chunks, every head's four Dh x Dh
// recurrent blocks resident in VMEM, and the caller padding S to a multiple
// of 64 and picking a batch block that divides B.
//
// Bound on Hopper: operations, then latency. At xlstm-1.3b's prefill (B 4,
// S 4096, H 4, Dh 512, f32) the recurrent products are 2 B 4 H Dh^2 S =
// 1.37e11 FLOPs, 2.05 ms at the 67 TFLOP/s f32 rate, against 0.69 GB of
// pre_*, h and R: 0.21 ms at 3.35 TB/s. The S steps depend on each other,
// so the true floor is S times one step's dependent chain: a Dh-long dot
// product, the gates, and the exchange of h between the SMs of a head.
//
// Design. A head's R (4 MiB at Dh 512) fits in no single SM, but the card's
// SMs together hold all four heads' in registers and shared memory. So each
// head's Dh output units are cut into slices of `units` units, and one block
// owns one (batch group, head, slice) for all S steps:
//  - the slice's columns of all four gates' R blocks (4 x units columns of
//    Dh rows) stay resident: thread (column j, row chunk k) keeps the first
//    kRegRows rows of its chunk in registers and the rest, if any, in
//    dynamic shared memory, all loaded once;
//  - all `rows` batch rows of the group share each R value, 4 at a time;
//    h sits in shared memory as [d][row], one broadcast float4 a row of
//    the chunk, read two rows ahead of the products;
//  - the K = 512 / (4 units) partial sums of a (row, column) meet in shared
//    memory, and one thread a (row, unit) applies the gates with its c, n
//    and m in registers: a block holds all four gates of its units, so only
//    h crosses blocks;
//  - every step the slices of a (group, head) exchange h through the L2,
//    with the step barrier carried in the data: each writes its units' h_t
//    as 64-bit words {h, t + 1} (a two-step ring a pair), and each reads
//    all of h_t back, every word until its step shows, with loads at GPU
//    scope (the L1 is not coherent). No fence, counter or block-wide
//    arrival sits on the path; `out` gets h with plain stores.
// A ring of two steps suffices: a slice writes step t + 2 only after every
// slice has written t + 1, which each does only after reading step t.
// The grid must be co-resident, or the exchange deadlocks: it is launched
// cooperatively, which refuses a grid that cannot be, and the wrapper's
// launch plan (kernel.py::plan) sizes slices and splits (group, head)
// pairs over consecutive launches from the card's SM count, shared memory
// and occupancy. A wait that never ends traps after ~2 s of spinning
// instead of hanging. The preactivations are read through their strides
// (no pad, no copy), the next step's while the slices meet. f32 throughout
// and no fast math: log_sigmoid in its stable form min(x, 0) -
// log1p(exp(-|x|)), and m starting at -1e30 makes exp(logf + m - m')
// exactly 0 at step 0 with no inf - inf.
//
// Where a step goes, and what was tried (kernels/slstm_scan/probe.py
// rebuilds this file as measurement variants and times each at the
// prefill shape; NVIDIA H100 80GB HBM3 at 700 W): 3.58 us a step as built;
// 2.13 without the exchange's reads and 2.74 reading h once without
// waiting, so the exchange is ~40 % of a step and the wait for the
// slowest slice ~23 %; 2.54 without the products; 0.83 with neither
// (barriers, sums, gates). The exchange through `out` with a fence, a
// release add on a counter a head and an acquire spin took 4.07; R in
// shared memory alone (every step then reads each R value from shared
// memory beside h) 3.97; 32 register rows 3.70; 64 register rows 3.60-3.61
// with h read none or one row ahead (28 B spilled). Also dropped, not
// kept as variants: two columns a thread, the gate threads summing the
// partials themselves (over the register budget), and a release flag a
// slice polled by one warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Measurement builds only (kernels/slstm_scan/probe.py compiles them with
// -D; the default build defines none): SFPL_SLSTM_PROBE bit 1 skips the
// recurrent products, bit 2 reads the other slices' h once without waiting
// for its step, bit 8 skips the exchange's reads altogether (each of the
// three gives wrong answers: it times what is left of a step), and bit 4
// exchanges h as the counter design would (h_t through `out`, a fence, a
// release add on a counter a (group, head), an acquire spin, then h_t read
// from `out`). SFPL_SLSTM_REG_ROWS and SFPL_SLSTM_AHEAD override kRegRows
// and kAhead.
#ifndef SFPL_SLSTM_PROBE
#define SFPL_SLSTM_PROBE 0
#endif
#ifndef SFPL_SLSTM_REG_ROWS
#define SFPL_SLSTM_REG_ROWS 48
#endif
#ifndef SFPL_SLSTM_AHEAD
#define SFPL_SLSTM_AHEAD 2
#endif

constexpr int kMaxDh = 512;
constexpr int kThreads = 512;          // a block
constexpr int kRegRows = SFPL_SLSTM_REG_ROWS;  // R rows a thread keeps in
                                               // registers
constexpr int kAhead = SFPL_SLSTM_AHEAD;  // h rows loaded ahead of the FMAs
constexpr int kHBatch = 4;             // h words a thread polls at once
constexpr long long kSpinLimit = 1ll << 32;  // clock64 cycles, ~2 s

struct Params {
  const float* x[4];              // pre_i, pre_f, pre_z, pre_o
  int64_t sb[4], ss[4], sh[4];    // their strides in elements
  const float* R;                 // (4, H, Dh, Dh), contiguous
  float* out;                     // (B, S, H, Dh), contiguous
  int64_t B, S, H, Dh;
};

struct Slicing {
  unsigned long long* ring;       // (pairs, 2, rows, Dh) {h, step}, zeroed
  int rows, units, slices, pair0;
};

// A block's dynamic shared memory, in floats from its base: R past the
// register rows (K chunks x rem rows x C columns), h of its rows padded to
// 4 ([d][row], zeros past Dh, which the register rows and the look-ahead
// reach), the partial sums (4 rows x K chunks x C) and their totals (4 rows
// x C). K = kThreads / C row chunks of `chunk` rows, C = 4 units columns.
// The kernel carves its memory from this, and the C entry holds the
// launch's `smem` to it.
struct Layout {
  int K, chunk, rem, rows4;
  int64_t hs, red, pre, floats;
};

__host__ __device__ inline Layout layout(int Dh, int units, int rows) {
  Layout l;
  const int C = 4 * units;
  l.K = kThreads / C;
  l.chunk = (Dh + l.K - 1) / l.K;
  l.rem = l.chunk > kRegRows ? l.chunk - kRegRows : 0;
  l.rows4 = (rows + 3) & ~3;
  l.hs = (int64_t)l.K * l.rem * C;
  l.red = l.hs + (int64_t)(l.K * l.chunk + kRegRows + kAhead) * l.rows4;
  l.pre = l.red + 4 * l.K * C;
  l.floats = l.pre + 4 * C;
  return l;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned step_of(unsigned long long w) {
  return (unsigned)(w >> 32);
}

__global__ void __launch_bounds__(kThreads) slstm_scan_sliced(Params p,
                                                             Slicing q) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int Dh = (int)p.Dh, H = (int)p.H;
  const int U = q.units, C = 4 * U;
  const Layout L = layout(Dh, U, q.rows);
  const int K = L.K, chunk = L.chunk, rem = L.rem, rows4 = L.rows4;
  const int hstep = rows4 / 4;
  float* Rs = reinterpret_cast<float*>(smem4);  // rows past kRegRows
  float* hs = Rs + L.hs;                         // hs[d * rows4 + b]
  float* red = Rs + L.red;
  float* pre = Rs + L.pre;                       // pre[b * C + j]

  const int pair = q.pair0 + (int)blockIdx.x / q.slices;
  const int slice = (int)blockIdx.x % q.slices;
  const int head = pair % H;
  const int64_t b0 = (int64_t)(pair / H) * q.rows;
  const int nb = (int)min((int64_t)q.rows, p.B - b0);
  const int u0 = slice * U;
  const int nu = min(U, Dh - u0);

  // dot-product thread: column j (gate j / U, unit j % U), rows
  // [d0, d0 + len), the first kRegRows of them in registers
  const int j = tid % C, k = tid / C;
  const int d0 = min(Dh, k * chunk), len = min(Dh, d0 + chunk) - d0;
  const bool col = k < K && j % U < nu;
  const float* rcol =
      p.R + ((int64_t)(j / U) * H + head) * Dh * Dh + u0 + j % U;
  float rr[kRegRows > 0 ? kRegRows : 1];
#pragma unroll
  for (int i = 0; i < kRegRows; ++i)
    rr[i] = col && i < len ? rcol[(int64_t)(d0 + i) * Dh] : 0.f;
  for (int i = 0; k < K && i < rem; ++i)
    Rs[(k * rem + i) * C + j] =
        col && kRegRows + i < len ? rcol[(int64_t)(d0 + kRegRows + i) * Dh]
                                  : 0.f;
  // h stays 0 past Dh: the register rows and the look-ahead read there
  for (int i = tid; i < (K * chunk + kRegRows + kAhead) * rows4;
       i += kThreads)
    hs[i] = 0.f;

  // gate thread: unit gu of batch row gb
  const int gu = tid % U, gb = tid / U;
  const bool gate = gb < nb && gu < nu;
  float c = 0.f, n = 1e-6f, m = -1e30f;
  float xv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 4; ++g)
    if (gate)
      xv[g] = p.x[g][(b0 + gb) * p.sb[g] + head * p.sh[g] + u0 + gu];
  unsigned long long* ring = q.ring + (int64_t)pair * 2 * q.rows * Dh;
  __syncthreads();

  for (int64_t t = 0; t < p.S; ++t) {
    unsigned long long* slot = ring + (t & 1) * q.rows * Dh;
    for (int r0 = 0; r0 < rows4; r0 += 4) {
      if (k < K) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#if !(SFPL_SLSTM_PROBE & 1)
        const float4* hp =
            reinterpret_cast<const float4*>(hs + r0) + d0 * hstep;
        float4 hq[kAhead + 1];
#pragma unroll
        for (int i = 0; i < kAhead; ++i) hq[i] = hp[i * hstep];
#pragma unroll
        for (int i = 0; i < kRegRows; ++i) {
          hq[(i + kAhead) % (kAhead + 1)] = hp[(i + kAhead) * hstep];
          const float4 hv = hq[i % (kAhead + 1)];
          a0 = fmaf(hv.x, rr[i], a0);
          a1 = fmaf(hv.y, rr[i], a1);
          a2 = fmaf(hv.z, rr[i], a2);
          a3 = fmaf(hv.w, rr[i], a3);
        }
        const float* rp = Rs + k * rem * C + j;
        hp += kRegRows * hstep;
        for (int i = 0; i < rem; ++i) {
          const float rv = rp[i * C];
          const float4 hv = hp[i * hstep];
          a0 = fmaf(hv.x, rv, a0);
          a1 = fmaf(hv.y, rv, a1);
          a2 = fmaf(hv.z, rv, a2);
          a3 = fmaf(hv.w, rv, a3);
        }
#endif
        float* rd = red + 4 * k * C + j;
        rd[0] = a0;
        rd[C] = a1;
        rd[2 * C] = a2;
        rd[3 * C] = a3;
      }
      __syncthreads();
      // the K partial sums of each of the 4 C (row, column) pairs, two
      // chains a thread; 4 C exceeds kThreads past 32 units
      for (int e = tid; e < 4 * C; e += kThreads) {
        const float* rs = red + e;
        float s0 = 0.f, s1 = 0.f;
        int kk = 0;
        for (; kk + 1 < K; kk += 2) {
          s0 += rs[4 * kk * C];
          s1 += rs[4 * (kk + 1) * C];
        }
        if (kk < K) s0 += rs[4 * kk * C];
        pre[e] = s0 + s1;
      }
      __syncthreads();
      if (gate && (gb & ~3) == r0) {
        const float* rec = pre + (gb & 3) * C + gu;
        const float i_pre = xv[0] + rec[0];
        const float f_pre = xv[1] + rec[U];
        const float z = tanhf(xv[2] + rec[2 * U]);
        const float o = sigmoid(xv[3] + rec[3 * U]);
        const float logf = log_sigmoid(f_pre);
        const float m_new = fmaxf(logf + m, i_pre);
        const float i_s = expf(i_pre - m_new);
        const float f_s = expf(logf + m - m_new);
        c = f_s * c + i_s * z;
        n = fmaxf(f_s * n + i_s, 1e-6f);
        m = m_new;
        const float h = o * (c / n);
        if (t + 1 < p.S && !(SFPL_SLSTM_PROBE & 4))
          st_relaxed(slot + gb * Dh + u0 + gu,
                     ((unsigned long long)(t + 1) << 32) |
                         __float_as_uint(h));
        p.out[(((b0 + gb) * p.S + t) * H + head) * Dh + u0 + gu] = h;
      }
      if (r0 + 4 < rows4) __syncthreads();
    }
    if (t + 1 == p.S) break;

    // next step's preactivations are in flight while the slices meet
    if (gate) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xv[g] = p.x[g][(b0 + gb) * p.sb[g] + (t + 1) * p.ss[g] +
                       head * p.sh[g] + u0 + gu];
    }
    // h_t of all the group's rows: each word read until it holds step t
    const long long start = clock64();
    const unsigned want = (unsigned)(t + 1);
    const int total = nb * Dh;
#if SFPL_SLSTM_PROBE & 4
    __syncthreads();
    if (tid == 0) {
      unsigned* count = reinterpret_cast<unsigned*>(ring);
      __threadfence();
      atomicAdd(count, 1u);
      unsigned seen;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen)
                     : "l"(count) : "memory");
        if (clock64() - start > kSpinLimit) __trap();
      } while (seen < want * q.slices);
    }
    __syncthreads();
    for (int i = tid; i < total; i += kThreads) {
      const int b = i / Dh, d = i - b * Dh;
      hs[d * rows4 + b] =
          __ldcg(p.out + (((b0 + b) * p.S + t) * H + head) * Dh + d);
    }
#elif SFPL_SLSTM_PROBE & 8
#elif SFPL_SLSTM_PROBE & 2
    for (int i = tid; i < total; i += kThreads) {
      const int b = i / Dh, d = i - b * Dh;
      hs[d * rows4 + b] = __uint_as_float((unsigned)ld_relaxed(slot + i));
    }
#else
    for (int i0 = tid; i0 < total; i0 += kThreads * kHBatch) {
      unsigned pending = 0;
      unsigned long long w[kHBatch];
#pragma unroll
      for (int r = 0; r < kHBatch; ++r)
        if (i0 + r * kThreads < total) pending |= 1u << r;
      // the first word alone until it shows, so that a slice that is late
      // is polled with one load a thread, not kHBatch
      while (step_of(ld_relaxed(slot + i0)) != want)
        if (clock64() - start > kSpinLimit) __trap();
      while (pending) {
#pragma unroll
        for (int r = 0; r < kHBatch; ++r)
          if (pending >> r & 1) w[r] = ld_relaxed(slot + i0 + r * kThreads);
#pragma unroll
        for (int r = 0; r < kHBatch; ++r) {
          if ((pending >> r & 1) && step_of(w[r]) == want) {
            const int i = i0 + r * kThreads;
            const int b = i / Dh, d = i - b * Dh;
            hs[d * rows4 + b] = __uint_as_float((unsigned)w[r]);
            pending &= ~(1u << r);
          }
        }
        if (pending && clock64() - start > kSpinLimit) __trap();
      }
    }
#endif
    __syncthreads();
  }
}

bool fill(Params& p, const float* xi, const float* xf, const float* xz,
          const float* xo, const float* R, float* out, int64_t B, int64_t S,
          int64_t H, int64_t Dh, const int64_t* strides) {
  if (Dh < 1 || Dh > kMaxDh) return false;
  const float* xs[4] = {xi, xf, xz, xo};
  for (int g = 0; g < 4; ++g) {
    p.x[g] = xs[g];
    p.sb[g] = strides[3 * g];
    p.ss[g] = strides[3 * g + 1];
    p.sh[g] = strides[3 * g + 2];
  }
  p.R = R;
  p.out = out;
  p.B = B;
  p.S = S;
  p.H = H;
  p.Dh = Dh;
  return true;
}

// Raise the kernel's dynamic shared-memory limit to `smem` on the current
// device, once per size (not on every launch, which may be captured).
cudaError_t allow_smem(int64_t smem) {
  static int64_t allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || smem <= allowed[dev]) return err;
  err = cudaFuncSetAttribute(slstm_scan_sliced,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) allowed[dev] = smem;
  return err;
}

}  // namespace

// pre_*: (B, S, H, Dh) f32 with unit stride on Dh; strides: 12 int64 in
// host memory, (batch, seq, head) for each of the four in gate order;
// R (4, H, Dh, Dh) and out (B, S, H, Dh) f32, contiguous. One launch over
// `pairs` (group, head) pairs from `pair0`, each `slices` blocks of `units`
// units and `rows` batch rows, with `smem` bytes of dynamic shared memory;
// `ring` (pairs x 2 x rows x Dh u64) zero at the first launch of a call.
// `smem` at least sfpl_slstm_scan_smem's. Launched cooperatively; returns
// the launch's error.
extern "C" int sfpl_slstm_scan(const float* xi, const float* xf,
                               const float* xz, const float* xo,
                               const float* R, float* out,
                               unsigned long long* ring, int64_t B,
                               int64_t S, int64_t H, int64_t Dh,
                               const int64_t* strides, int rows, int units,
                               int slices, int pair0, int pairs,
                               int64_t smem, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || pairs <= 0) return 0;
  Params p;
  if (!fill(p, xi, xf, xz, xo, R, out, B, S, H, Dh, strides) || units < 1 ||
      4 * units > kThreads || rows < 1 || units * rows > kThreads ||
      slices != (Dh + units - 1) / units ||
      smem < 4 * layout((int)Dh, units, rows).floats)
    return (int)cudaErrorInvalidValue;
  const Slicing q{ring, rows, units, slices, pair0};
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(pairs * slices));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, slstm_scan_sliced, p, q);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A block's dynamic shared memory in bytes at (Dh, units, rows), or -1
// outside the kernel's limits.
extern "C" int64_t sfpl_slstm_scan_smem(int64_t Dh, int units, int rows) {
  if (Dh < 1 || Dh > kMaxDh || units < 1 || 4 * units > kThreads ||
      rows < 1 || units * rows > kThreads)
    return -1;
  return 4 * layout((int)Dh, units, rows).floats;
}

// The kernel's threads a block, registers a thread, and co-resident blocks
// an SM at `smem` bytes of dynamic shared memory (the occupancy query);
// `smem_limit` the card's opt-in shared memory a block.
extern "C" int sfpl_slstm_scan_resources(int64_t smem, int* threads,
                                         int* regs, int* blocks_per_sm,
                                         int* smem_limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, slstm_scan_sliced);
  if (err != cudaSuccess) return (int)err;
  *threads = kThreads;
  *regs = attr.numRegs;
  *blocks_per_sm = 0;
  if (smem > *smem_limit) return 0;
  err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, slstm_scan_sliced, kThreads, (size_t)smem);
}
