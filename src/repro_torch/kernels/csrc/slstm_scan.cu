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
// so the true floor is S times one step's dependent chain (a Dh-long dot
// product, the gates, a barrier).
//
// Design (simple first). One block per (batch row, head); it loops over
// all S steps. Thread e owns output unit e of the head for all four gates:
// its c, n and m live in registers, h lives in shared memory,
// double-buffered, with one barrier a step. Each step thread e reads
// column e of the head's four R blocks from global memory: a head's R
// (4 MiB at Dh 512) does not fit in shared memory, so it stays in the
// 50 MB L2 and each warp's reads are coalesced along e. Blocks holding
// 2, 4 or 8 batch rows share each R read but were measured slower at the
// prefill's shape (PERF.md section 6), so a block holds one row. The
// preactivations are read through their strides (no pad, no copy) and h
// is written in place. f32 throughout and no fast math: log_sigmoid in its
// stable form min(x, 0) - log1p(exp(-|x|)), and m starting at -1e30 makes
// exp(logf + m - m') exactly 0 at step 0 with no inf - inf.
//
// Why it sits far from its bound: a head's step runs on one SM, which must
// stream that head's 4 MiB of R from L2 every step, and only B x H blocks
// exist (16 at the prefill). The redesign keeps R resident in shared
// memory: each head's 2048 gate columns split over ~32 co-resident blocks
// (128 KiB of R each) with a per-head barrier every step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDh = 512;

struct Params {
  const float* x[4];              // pre_i, pre_f, pre_z, pre_o
  int64_t sb[4], ss[4], sh[4];    // their strides in elements
  const float* R;                 // (4, H, Dh, Dh), contiguous
  float* out;                     // (B, S, H, Dh), contiguous
  int64_t B, S, H, Dh;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kMaxDh) slstm_scan_kernel(Params p) {
  extern __shared__ float h_smem[];          // two buffers of Dh
  const int e = threadIdx.x;
  const int head = blockIdx.y;
  const int64_t b = blockIdx.x;
  const int Dh = (int)p.Dh;
  const bool unit = e < Dh;

  for (int i = threadIdx.x; i < 2 * Dh; i += blockDim.x) h_smem[i] = 0.f;

  float c = 0.f, n = 1e-6f, m = -1e30f;
  const int64_t gate_stride = p.H * p.Dh * p.Dh;
  const float* r = p.R + (int64_t)head * Dh * Dh + e;    // R[0, head, 0, e]
  __syncthreads();

  for (int64_t t = 0; t < p.S; ++t) {
    const float* hc = h_smem + (t & 1) * Dh;
    float* hn = h_smem + ((t + 1) & 1) * Dh;

    // this step's preactivations, issued before the dot products
    float x[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      x[g] = unit ? p.x[g][b * p.sb[g] + t * p.ss[g] + head * p.sh[g] + e]
                  : 0.f;
    }

    // rec[g] = sum_d h[d] * R[g, head, d, e]
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (unit) {
#pragma unroll 4
      for (int d = 0; d < Dh; ++d) {
        // the four gates' loads first, so more of them are in flight
        const float* rd = r + (int64_t)d * Dh;
        float rv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) rv[g] = __ldg(rd + g * gate_stride);
        const float hv = hc[d];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = fmaf(hv, rv[g], acc[g]);
      }
    }

    const float i_pre = x[0] + acc[0];
    const float f_pre = x[1] + acc[1];
    const float z = tanhf(x[2] + acc[2]);
    const float o = sigmoid(x[3] + acc[3]);
    const float logf = log_sigmoid(f_pre);
    const float m_new = fmaxf(logf + m, i_pre);
    const float i_s = expf(i_pre - m_new);
    const float f_s = expf(logf + m - m_new);
    c = f_s * c + i_s * z;
    n = fmaxf(f_s * n + i_s, 1e-6f);
    m = m_new;
    const float h = o * (c / n);
    if (unit) {
      hn[e] = h;
      p.out[((b * p.S + t) * p.H + head) * p.Dh + e] = h;
    }
    __syncthreads();
  }
}

}  // namespace

// pre_*: (B, S, H, Dh) f32 with unit stride on Dh; strides: 12 int64 in
// host memory, (batch, seq, head) for each of the four in gate order;
// R (4, H, Dh, Dh) and out (B, S, H, Dh) f32, contiguous. Returns cudaGetLastError() after the launch.
extern "C" int sfpl_slstm_scan(const float* xi, const float* xf,
                               const float* xz, const float* xo,
                               const float* R, float* out, int64_t B,
                               int64_t S, int64_t H, int64_t Dh,
                               const int64_t* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Dh < 1 || Dh > kMaxDh) return (int)cudaErrorInvalidValue;
  Params p;
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
  const int threads = (int)((Dh + 31) / 32 * 32);
  const dim3 grid((unsigned)B, (unsigned)H);
  const size_t smem = 2 * (size_t)Dh * sizeof(float);
  slstm_scan_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
