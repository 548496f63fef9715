// Kernel D: channels-last demod + LLR sum (the headline receive terminal),
// and kernel F: channels-last demod + per-channel bit-error count, or the
// channels-last LLR plane.
//
// D replaces sdr_tpu/kernels/demod_cl_pallas.py::demod_sum_cl, F
// ::demod_count_cl and ::demod_llr_cl (all through _run_cl), the TPU's emit_pipeline
// kernel with DIF radix-2 levels down to 128-point leaf DFT matmuls.
// Same math on the same layout:
//   re_t, im_t (S*(N+cp), B) f32, symbol s in rows [s*(N+cp), (s+1)*(N+cp)),
//   the first cp rows of each symbol being the CP; hr_t, hi_t (N, B) in
//   natural bin order.
// The sample planes may also come as bfloat16 (the JAX bench's default
// input, demod_cl_pallas.py:145): each sample is widened with
// __bfloat162float on load and everything after runs in f32, as for f32
// input; that halves the bytes the kernels must read.
// Per (channel, symbol): CP strip; forward unscaled N-point FFT;
// p = conj(h) y; max-log LLRs — division-free for L <= 4 (the common
// p^2/|h|^2 term cancels), one reciprocal and the Gray fold recursion
// for L >= 8; every LLR added to the sum.
//
// One register-resident form for every N: a thread holds R points of one
// channel in registers from its loads to its tail (R = 16 or 32; all N
// points at N < R), a channel takes P = N/R threads and a block C channels,
// thread (t, c) = threadIdx t·C + c, so adjacent lanes take adjacent
// channels and a warp's row read or plane store covers adjacent channels of
// one row. The DFT runs as Stockham passes of register DFTs (regfft.cuh)
// with an exchange through shared memory between them, and h for the
// block's channels is staged in shared memory once per run of symbols. The
// DIF bin order of the TPU kernel was a Mosaic artifact: bins here are
// natural.
//
// The narrow plan (N ≤ 512, N = R · P): R = 16 points a thread up to
// N = 256 (P ≤ 16), R = 32 at N = 512 (P = 16). A block takes 2^13/N
// channels, at least 32 — 512 threads — so a warp's row read is 32
// channels: 128 bytes in f32, 64 (two whole sectors) in bf16.
//   pass A: thread t loads samples t + r·P, r < R, straight from the plane
//           into registers (2R independent loads in flight) and runs an
//           R-point DFT there — at N ≤ 16 that is the whole transform;
//   pass B: (N ≥ 32) twiddles W_N^{t·q}, read as float2 from a table of
//           N built in shared memory once a block (t·R + q: R adjacent
//           entries a thread), one exchange (point q written at position
//           q·P + t, points m read back from t·R + m), then R/P DFTs of P
//           adjacent points.
// Thread t ends with bins k = t·R/P + m div P + R·(m mod P) of its point m,
// the same bins in every symbol. With C ≥ 32 each warp's lanes share one
// t, so every write and read of the exchange buffer (one component at a
// time, N·C words, two barriers each) hits 32 adjacent words: no bank
// conflict and no padding. h is staged once per run of kNarrowSyms symbols
// in the points' order (position t·R + m, channels minor), so the tail
// reads it conflict-free. Shared memory per block is 4·3·N·C + 8·N bytes:
// up to 98 KiB to N = 256, where a thread of R = 16 fits 64 registers,
// so two blocks (32 warps) run on an SM and one block's loads are in
// flight while the other transforms; 196 KiB at N = 512 (R = 32, 128
// registers, one block). bf16 samples are loaded with a 256-byte L2 fill
// (ld_bf16_l2_256).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W against R = 32 points a
// thread at every narrow N (two blocks of 8 warps an SM up to N = 256) and
// against a cp.async ring that copies symbol s+1's tile while symbol s
// transforms: R = 16 was the fastest for the sum and the count; the ring
// was faster only for the plane, so one form stays.
//
// The wideband plan (N = 1024, 2048, 4096; the TPU kernel took
// N = 128·2^k up to 4096 with h in bf16 to fit VMEM — here h stays f32):
// N = 32 · 32 · r3, r3 = N/1024 (1, 2 or 4), a block takes C = 2^14/N
// channels — 16, 8, 4 — as C·P = 512 threads.
//   pass A: the thread loads samples t + r·P, r < 32, straight from the
//           plane into registers (64 independent loads in flight; a warp
//           reads 32/C rows of C·4 bytes) and runs a 32-point FFT there;
//   pass B: exchange through shared memory (Stockham: written at t·32 + r,
//           read at t + r·P), inter-pass twiddles W_N^{(t mod 32)·r·N/1024}
//           from the twr/twi table, a second 32-point FFT;
//   pass C: (N ≥ 2048) one more exchange, then 32/r3 radix-r3 DFTs of the
//           thread's own points with twiddles W_N^{j·r}.
// The thread ends with bins k = t + i·P, i < 32, in natural order, the
// same bins in every symbol. The exchange buffer holds one component of
// the tile at a time (the real parts, then the imaginary ones: four
// barriers an exchange, so 4 a symbol at N = 1024 and 8 above, against
// 10–12 radix-2 stages), padded by C words every 32 positions, which
// makes every write and read of it conflict-free. h for the block's
// channels is staged in shared memory once per run of kWideSyms symbols
// (natural order, channels minor) and read from there by the tail. Shared
// memory per block is 4·(N·33/32 + 2N)·C bytes, 194 KiB at every N: one
// block of 16 warps an SM, whose 64 loads a thread in flight cover the
// memory latency; __launch_bounds__(512) caps a thread at 128 registers,
// and loop-invariant addresses are kept from being hoisted (opaque()),
// which had spilled them. Eight channels a block at N = 4096 would need
// 256 KB of points, the whole register file: it keeps 4, so a block's
// row read or plane store covers 16 B of a 32-byte sector (8 B in bf16),
// the next block the other half. The blocks run as clusters of two
// adjacent channel groups, and for the plane at N >= 2048, where such
// narrow stores cost most, the pair works together: after the transform
// the two blocks swap halves of their spectra through distributed shared
// memory (16 points a thread into the partner's exchange buffer, between
// two cluster barriers), so each tail takes the pair's 2C channels over
// half the bins and a warp's store covers 2C adjacent channels of a row
// (64 B at N = 2048, 32 B at 4096, in f32). At N = 1024 (64-byte rows
// already) and for the sum and count the swap cost more than it saved,
// as measured on an NVIDIA H100 80GB HBM3 at 700 W. Bound: the f32
// FFT and the max-log tail on CUDA cores, then the bytes; chip_smoke.py
// phase 2w prints each mode against kernel C on the same tones and
// against its bound.
// The cross-block sum is deterministic: one partial per block, then one
// block adds the partials in a fixed order — no float atomics, so
// repeated runs give the same bits.
//
// F shares D's transform and LLR forms, and compares each bit's
// hard decision, taken by hard_bits (the LLR's sign without its
// magnitude), with the transmitted index plane idx_t (S*N, B) int8/int16
// in natural bin order (the TPU kernel's DIF permutation of it is not
// carried over). The count is per channel: a thread always serves the
// same channel of its block, so it keeps an integer count in a register;
// at the end each thread adds its count to out[b] with an integer atomic
// (narrow plan; the wideband one first sums a warp's lanes of one channel
// by shuffles) — exact, and the same in any order.
//
// Bound on the H100: reading the two sample planes (8 bytes per sample
// in f32, 4 in bf16; F adds 1-2 bytes of index, or writes 4 or 2 per
// LLR), and, close behind, the f32 FFT and tail on CUDA cores. The three
// modes share one tail (the lambdas of the three kernels, the same in
// every plan); the sample, index and plane types are run-time arguments
// (uniform branches around loads and stores), so each mode compiles once
// per modulation and plan: 18 kernels in each mode's translation unit.
#pragma once
#include <cuda_bf16.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "regfft.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLogN = 12;      // N <= 4096
constexpr int kMaxLogNNarrow = 9;  // the narrow plan up to N = 512

constexpr int kNarrowSyms = 32;    // symbols a narrow block runs (h staged once)
constexpr int kNarrowLogTile = 13; // N · channels of a narrow block (but 32 channels)
constexpr int kNarrowMinLogCh = 5; // at least 32 channels: a warp reads one row

constexpr int kR = 32;               // points a thread holds (both plans)
constexpr int kLogR = 5;
constexpr int kWideSyms = 16;        // symbols a wideband block runs (h staged once)
constexpr int kWideThreads = 512;     // threads a wideband block: 2^14 points / 32
constexpr int kWideLogTile = 14;     // N · channels of a wideband block
constexpr int kWideCluster = 2;      // blocks a wideband cluster (the plane's pair)

// log2 of the wideband channels per block: 16, 8, 4 at N = 1024, 2048, 4096.
__host__ __device__ __forceinline__ int wide_log_ch(int log_n) { return kWideLogTile - log_n; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The plans: narrow with 16 points a thread (N <= 256), narrow with 32
// (N = 512) and wideband (N >= 1024).
enum Plan { kNarrow16, kNarrow32, kWide };
__host__ __device__ constexpr int plan_of(int log_n) {
  return log_n > kMaxLogNNarrow ? kWide : log_n == kMaxLogNNarrow ? kNarrow32 : kNarrow16;
}
__host__ __device__ constexpr int narrow_log_r(int plan) { return plan == kNarrow32 ? 5 : 4; }

// The narrow plan's geometry for R = 2^log_r points a thread: log2 of the
// threads a channel takes (P = N/R, 1 at N <= R) and of the channels a
// block takes (2^13 points' worth, at least 32).
__host__ __device__ __forceinline__ int narrow_log_p(int log_n, int log_r) {
  return log_n > log_r ? log_n - log_r : 0;
}
__host__ __device__ __forceinline__ int narrow_log_ch(int log_n, int log_r) {
  const int lc = kNarrowLogTile - log_r - narrow_log_p(log_n, log_r);
  return lc > kNarrowMinLogCh ? lc : kNarrowMinLogCh;
}

using sdr::fft_reg;

// x *= W_N^m, 0 <= m < N, from the half-circle table (k < N/2).
__device__ __forceinline__ void mul_table(float& xr, float& xi, int m, int half,
                                          const float* __restrict__ twr,
                                          const float* __restrict__ twi) {
  const bool upper = m >= half;
  const int k = upper ? m - half : m;
  float wr = __ldg(twr + k), wi = __ldg(twi + k);
  if (upper) {
    wr = -wr;
    wi = -wi;
  }
  const float r = xr;
  xr = r * wr - xi * wi;
  xi = r * wi + xi * wr;
}

using sdr::opaque;

// Waits for every thread of the block's cluster (the pair of adjacent
// channel groups whose plane rows share sectors), its shared-memory
// stores, local or remote, then visible to both blocks.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// One Stockham exchange of the tile through shared memory (both plans): the
// thread's point i is written at word wbase + i·wstep and point i read
// back from rbase + i·rstep; the real parts first, then the imaginary
// ones, through the one buffer. The leading barrier keeps the buffer's
// last readers ahead of the first write.
template <int R>
__device__ __forceinline__ void exchange(float* buf, float (&vr)[R], float (&vi)[R],
                                         int wbase, int wstep, int rbase, int rstep) {
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i) buf[wbase + i * wstep] = vr[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i) vr[i] = buf[rbase + i * rstep];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i) buf[wbase + i * wstep] = vi[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i) vi[i] = buf[rbase + i * rstep];
}

// Pass C: the thread's 32/R3 radix-R3 DFTs j = t + q·P, inputs and outputs
// at points q + r·32/R3, twiddles W_N^{j·r}.
template <int R3, int LOG3>
__device__ __forceinline__ void last_pass(float (&vr)[kR], float (&vi)[kR], int t,
                                          int log_p, int half, const float* __restrict__ twr,
                                          const float* __restrict__ twi) {
  constexpr int Q = kR / R3;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + (q << log_p);
    float ur[R3], ui[R3];
#pragma unroll
    for (int r = 0; r < R3; ++r) {
      ur[r] = vr[q + r * Q];
      ui[r] = vi[q + r * Q];
      if (r) mul_table(ur[r], ui[r], j * r, half, twr, twi);
    }
    fft_reg<R3, LOG3>(ur, ui);
#pragma unroll
    for (int r = 0; r < R3; ++r) {
      vr[q + r * Q] = ur[r];
      vi[q + r * Q] = ui[r];
    }
  }
}

// The launch shape of every kernel here: (channel groups, symbol runs),
// the threads a block and its dynamic shared memory, opted in above 48 KB.
struct ClLaunch {
  dim3 grid;
  int threads;
  size_t smem;
};

__host__ inline ClLaunch cl_launch(int B, int S, int log_n) {
  const size_t N = (size_t)1 << log_n;
  if (log_n <= kMaxLogNNarrow) {
    const int log_r = narrow_log_r(plan_of(log_n));
    const int log_ch = narrow_log_ch(log_n, log_r), log_p = narrow_log_p(log_n, log_r);
    const int n_ch = 1 << log_ch;
    return ClLaunch{dim3((B + n_ch - 1) / n_ch, (S + kNarrowSyms - 1) / kNarrowSyms),
                    n_ch << log_p, sizeof(float) * (((log_p ? 3 : 2) * N) << log_ch) + 8 * N};
  }
  const int log_ch = wide_log_ch(log_n);
  const int n_ch = 1 << log_ch;
  const int groups = (B + n_ch - 1) / n_ch;
  return ClLaunch{dim3((groups + kWideCluster - 1) / kWideCluster * kWideCluster,
                       (S + kWideSyms - 1) / kWideSyms),
                  (int)(N >> kLogR) << log_ch,
                  sizeof(float) * ((N + (N >> 5) + 2 * N) << log_ch)};
}

// Max-log LLRs of one tone (channel c0 + c, bin k) into llr[0 ..
// BPS-1]: p = conj(h) y; the division-free form for L <= 4, one
// reciprocal and the Gray fold for L >= 8.
template <int M, bool BPSK>
__device__ __forceinline__ void tone_llrs(float yr, float yi, float h_r, float h_i, float inv_nv,
                                          const sdr::AxisTables& tab, float* llr) {
  const float h2 = h_r * h_r + h_i * h_i;
  const float pr = h_r * yr + h_i * yi;
  const float pi = h_r * yi - h_i * yr;
  if constexpr (M <= 2) {
    sdr::llr_axis_dfree<M>(pr, h2, inv_nv, tab, llr);
    if constexpr (!BPSK) sdr::llr_axis_dfree<M>(pi, h2, inv_nv, tab, llr + M);
  } else {
    const float inv_h2 = 1.0f / fmaxf(h2, 1e-12f);
    const float inv_eff = h2 * inv_nv;
    sdr::llr_axis_fold<M>(pr * inv_h2, inv_eff, tab, llr);
    sdr::llr_axis_fold<M>(pi * inv_h2, inv_eff, tab, llr + M);
  }
}

// A bf16 sample whose L2 fill is 256 bytes: a 32-channel warp reads 64 of
// them, and the rest, the next channel groups' part of the row, comes with
// it. With bf16's half-size requests the narrow plan's loads in flight
// fell short of the memory's rate; the fill makes up part of it.
__device__ __forceinline__ float ld_bf16_l2_256(const __nv_bfloat16* p) {
  unsigned short v;
  asm("ld.global.nc.L2::256B.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float((unsigned)v << 16);
}

// Pass A's loads: samples o + r·step, r < n_pts (R, or N below R), of the
// two planes, widened to f32 (bf16 ones with the 256-byte fill where
// L2_256); zeros for the rest of the R and for a thread past the last
// channel.
template <typename InT, int R, bool L2_256 = false>
__device__ __forceinline__ void load_points(const InT* __restrict__ re_t,
                                            const InT* __restrict__ im_t, long long o,
                                            long long step, bool valid, float (&vr)[R],
                                            float (&vi)[R], int n_pts) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (L2_256) {
      vr[r] = valid && r < n_pts ? ld_bf16_l2_256(re_t + o + r * step) : 0.0f;
      vi[r] = valid && r < n_pts ? ld_bf16_l2_256(im_t + o + r * step) : 0.0f;
    } else {
      vr[r] = valid && r < n_pts ? to_f32(re_t[o + r * step]) : 0.0f;
      vi[r] = valid && r < n_pts ? to_f32(im_t[o + r * step]) : 0.0f;
    }
  }
}

// The wideband body (N = 1024, 2048, 4096; the radix plan of the header):
// h staged once, then for each symbol of the block's run the radix passes
// and f(s, k, b, yr, yi, h_r, h_i) for 32 tones a thread, each with its
// transform y and channel h, where channel b < B: the bins k = t + i·P of
// the thread's own channel, or in the pair tail those the lane is given.
// A thread past the last channel loads zeros and still takes its part in
// the exchanges.
template <bool PAIR_OK, class F>
__device__ __forceinline__ void for_each_tone_wide(const void* re_t, const void* im_t, int in_bf16,
                                                   const float* __restrict__ hr_t,
                                                   const float* __restrict__ hi_t, int B, int S,
                                                   int log_n, int cp, const float* __restrict__ twr,
                                                   const float* __restrict__ twi, F f) {
  extern __shared__ float smem[];
  const int log_ch = wide_log_ch(log_n);
  const int log_p = log_n - kLogR;
  const int N = 1 << log_n, P = 1 << log_p, C = 1 << log_ch;
  float* buf = smem;                                // (N + N/32)·C words, padded
  float* shr = smem + ((N + (N >> 5)) << log_ch);  // (N, C), channels minor
  float* shi = shr + (N << log_ch);
  const int c = threadIdx.x & (C - 1);
  const int t = threadIdx.x >> log_ch;
  const int c0 = blockIdx.x << log_ch;
  const int b = c0 + c;
  const bool valid = b < B;
  // The pair tail (PAIR_OK, at N >= 2048): this block (rank 0 or 1 of its
  // cluster) and its partner take channel groups 2·pair and 2·pair + 1,
  // and this block's tail takes half `rank` of the bins of the pair's 2C
  // channels. Otherwise the tail takes the block's own C channels.
  const bool pair = PAIR_OK && log_n >= 11;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int log_pair = log_ch + 1;
  const int pair_c0 = (blockIdx.x >> 1) << log_pair;
  const int half = N >> 1;
  // h, natural order, channels minor: the tail's channels and bins.
  const int h_log_ch = pair ? log_pair : log_ch;
  const int h_c0 = pair ? pair_c0 : c0;
  const int h_k0 = pair ? rank * half : 0;
  for (int e = threadIdx.x; e < (N << log_ch); e += blockDim.x) {
    const int bb = h_c0 + (e & ((1 << h_log_ch) - 1));
    const long long ho = (long long)(h_k0 + (e >> h_log_ch)) * B + bb;
    shr[e] = bb < B ? hr_t[ho] : 0.0f;
    shi[e] = bb < B ? hi_t[ho] : 0.0f;
  }  // the first exchange's barriers order these stores before the tail
  float* partner = cluster.map_shared_rank(buf, rank ^ 1);
  const long long row_step = (long long)P * B;
  for (int s = blockIdx.y * kWideSyms, s1 = min(S, s + kWideSyms); s < s1; ++s) {
    // The optimiser must not hoist what comes from these out of the symbol
    // loop: sets of 32 addresses or twiddles held across it spill.
    const int tt = opaque(t), cc = opaque(c), lc = opaque(log_ch);
    const long long step = opaque(row_step);
    // Buffer words: position pos of channel c at (pos + pos/32)·C + c. Pass
    // A writes pos t·32 + i; passes B and C read t + i·P; pass B writes
    // (t/32)·1024 + t mod 32 + 32·i.
    const int bc_r = ((tt + (tt >> 5)) << lc) + cc;
    const int bc_step = (P + (P >> 5)) << lc;
    float vr[kR], vi[kR];
    const long long o = ((long long)s * (N + cp) + cp + tt) * B + b;
    if (in_bf16)
      load_points(static_cast<const __nv_bfloat16*>(re_t), static_cast<const __nv_bfloat16*>(im_t),
                  o, step, valid, vr, vi, kR);
    else
      load_points(static_cast<const float*>(re_t), static_cast<const float*>(im_t), o, step, valid,
                  vr, vi, kR);
    fft_reg<kR, kLogR>(vr, vi);
    exchange(buf, vr, vi, ((tt * 33) << lc) + cc, 1 << lc, bc_r, bc_step);
    const int tw_b = (tt & 31) << (log_n - 10);
#pragma unroll
    for (int r = 1; r < kR; ++r) mul_table(vr[r], vi[r], tw_b * r, half, twr, twi);
    fft_reg<kR, kLogR>(vr, vi);
    if (log_n > 10) {
      exchange(buf, vr, vi, (((tt >> 5) * 1056 + (tt & 31)) << lc) + cc, 33 << lc, bc_r, bc_step);
      if (log_n == 11) last_pass<2, 1>(vr, vi, tt, log_p, half, twr, twi);
      else last_pass<4, 2>(vr, vi, tt, log_p, half, twr, twi);
    }
    if (!pair) {
      if (!valid) continue;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int k = tt + (i << log_p);
        f(s, k, b, vr[i], vi[i], shr[(k << lc) + cc], shi[(k << lc) + cc]);
      }
      continue;
    }
    // Halves through distributed shared memory: thread (t, c) sends the
    // points of the partner's half (i < 16 at rank 1, i >= 16 at rank 0)
    // to word i·512 + threadIdx of the partner's buffer, once both
    // transforms are done with the buffers.
    cluster_sync();
#pragma unroll
    for (int i = 0; i < kR / 2; ++i) {
      partner[i * kWideThreads + threadIdx.x] = rank ? vr[i] : vr[16 + i];
      partner[(16 + i) * kWideThreads + threadIdx.x] = rank ? vi[i] : vi[16 + i];
    }
    cluster_sync();
    // The tail over the pair's 2C channels and this half's bins: a warp
    // holds 32/C rows t of C channels; each of its two steps per point
    // takes 16/C of those rows across all 2C channels (lane = row · 2C +
    // channel), own channels shuffled from the lane that holds them, the
    // partner's read from the buffer, so a store covers 2C adjacent
    // channels of a row.
    const int lane = threadIdx.x & 31;
    const int ch2 = lane & ((2 << lc) - 1);
    const int cq = ch2 & ((1 << lc) - 1);
    const bool mine = (ch2 >> lc) == rank;
    const int bt = pair_c0 + ch2;
    const int t_w = (threadIdx.x >> 5) << (5 - lc);  // the warp's first row
#pragma unroll
    for (int i = 0; i < kR / 2; ++i) {
      const float own_r = rank ? vr[16 + i] : vr[i];
      const float own_i = rank ? vi[16 + i] : vi[i];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rw = (hh << (4 - lc)) + (lane >> (lc + 1));  // row within the warp
        const int src = (rw << lc) + cq;
        const float xr = __shfl_sync(0xffffffffu, own_r, src);
        const float xi = __shfl_sync(0xffffffffu, own_i, src);
        const float pr = buf[i * kWideThreads + (t_w << lc) + src];
        const float pi = buf[(16 + i) * kWideThreads + (t_w << lc) + src];
        const int kk = t_w + rw + (i << log_p);  // bin within the half
        if (bt < B)
          f(s, rank * half + kk, bt, mine ? xr : pr, mine ? xi : pi,
            shr[(kk << (lc + 1)) + ch2], shi[(kk << (lc + 1)) + ch2]);
      }
    }
  }
}

// The DFTs of the RA/R groups of R adjacent points a thread holds.
template <int R, int LOG, int RA>
__device__ __forceinline__ void dft_groups(float (&vr)[RA], float (&vi)[RA]) {
#pragma unroll
  for (int g = 0; g < RA / R; ++g) {
    float ur[R], ui[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ur[r] = vr[g * R + r];
      ui[r] = vi[g * R + r];
    }
    fft_reg<R, LOG>(ur, ui);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      vr[g * R + r] = ur[r];
      vi[g * R + r] = ui[r];
    }
  }
}

// The same, with log2 R = lg (1 to LOG_RA) uniform across the block; the
// 32-point DFT only WITH_32 (the second pass never needs it).
template <bool WITH_32, int LOG_RA, int RA>
__device__ __forceinline__ void dft_groups_lg(int lg, float (&vr)[RA], float (&vi)[RA]) {
  switch (lg) {
    case 1: dft_groups<2, 1>(vr, vi); break;
    case 2: dft_groups<4, 2>(vr, vi); break;
    case 3: dft_groups<8, 3>(vr, vi); break;
    case 4: dft_groups<16, 4>(vr, vi); break;
    default: if constexpr (WITH_32 && LOG_RA == 5) fft_reg<RA, LOG_RA>(vr, vi);
  }
}

// The bin of point m of narrow thread t: t·R/P + m div P + R·(m mod P).
template <int LOG_R>
__device__ __forceinline__ int narrow_bin(int t, int m, int log_p) {
  return (t << (LOG_R - log_p)) + (m >> log_p) + ((m & ((1 << log_p) - 1)) << LOG_R);
}

// The narrow body (N <= 512; the plan of the header) for R = 2^LOG_R points
// a thread: h staged once, then for each symbol of the block's run the
// passes and f(s, k, b, yr, yi, h_r, h_i) for each of the thread's R tones,
// bins k of the thread's own channel b < B. A thread past the last channel
// loads zeros and still takes its part in the exchange.
template <int LOG_R, class F>
__device__ __forceinline__ void for_each_tone_narrow(const void* re_t, const void* im_t,
                                                     int in_bf16, const float* __restrict__ hr_t,
                                                     const float* __restrict__ hi_t, int B, int S,
                                                     int log_n, int cp,
                                                     const float* __restrict__ twr,
                                                     const float* __restrict__ twi, F f) {
  constexpr int R = 1 << LOG_R;
  extern __shared__ float smem[];
  const int log_p = narrow_log_p(log_n, LOG_R);
  const int log_ch = narrow_log_ch(log_n, LOG_R);
  const int log_r = log_n - log_p;  // LOG_R, or log_n at N < R
  const int N = 1 << log_n, C = 1 << log_ch;
  float* shr = smem;                 // (N, C): position t·R + m, channels minor
  float* shi = smem + (N << log_ch);
  float* buf = shi + (N << log_ch);  // the exchange, one component: N·C words
  float2* tw = reinterpret_cast<float2*>(buf + (N << log_ch));  // W_N^{t·q} at t·R + q
  const int c = threadIdx.x & (C - 1);
  const int t = threadIdx.x >> log_ch;
  const int c0 = blockIdx.x << log_ch;
  const int b = c0 + c;
  const bool valid = b < B;
  const int s0 = blockIdx.y * kNarrowSyms, s1 = min(S, s0 + kNarrowSyms);
  for (int e = threadIdx.x; e < (N << log_ch); e += blockDim.x) {
    const int pos = e >> log_ch, bb = c0 + (e & (C - 1));
    const int k = narrow_bin<LOG_R>(pos >> log_r, pos & ((1 << log_r) - 1), log_p);
    const long long ho = (long long)k * B + bb;
    shr[e] = bb < B ? hr_t[ho] : 0.0f;
    shi[e] = bb < B ? hi_t[ho] : 0.0f;
  }
  if (log_p)
    for (int e = threadIdx.x; e < N; e += blockDim.x) {
      float wr = 1.0f, wi = 0.0f;
      mul_table(wr, wi, (e >> LOG_R) * (e & (R - 1)), N >> 1, twr, twi);
      tw[e] = make_float2(wr, wi);
    }
  __syncthreads();
  const long long row_step = (long long)B << log_p;
  for (int s = s0; s < s1; ++s) {
    // As in the wideband body: what comes from these stays in the loop.
    const int tt = opaque(t), cc = opaque(c), lc = opaque(log_ch), lp = opaque(log_p);
    float vr[R], vi[R];
    const long long step = opaque(row_step);
    const long long o = ((long long)s * (N + cp) + cp + tt) * B + b;
    if (in_bf16)
      load_points<__nv_bfloat16, R, true>(static_cast<const __nv_bfloat16*>(re_t),
                                          static_cast<const __nv_bfloat16*>(im_t), o, step, valid,
                                          vr, vi, 1 << log_r);
    else
      load_points(static_cast<const float*>(re_t), static_cast<const float*>(im_t), o, step, valid,
                  vr, vi, 1 << log_r);
    dft_groups_lg<true, LOG_R>(log_r, vr, vi);
    if (lp) {
      const float2* w = tw + (tt << LOG_R);
#pragma unroll
      for (int q = 1; q < R; ++q) {
        const float2 wq = w[q];
        const float xr = vr[q];
        vr[q] = xr * wq.x - vi[q] * wq.y;
        vi[q] = xr * wq.y + vi[q] * wq.x;
      }
      exchange(buf, vr, vi, opaque((int)threadIdx.x), opaque((int)blockDim.x),
               (tt << (LOG_R + lc)) + cc, 1 << lc);
      dft_groups_lg<false, LOG_R>(lp, vr, vi);
    }
    if (!valid) continue;
    const int h0 = (tt << (log_r + lc)) + cc;
#pragma unroll
    for (int m = 0; m < R; ++m)
      if (m < (1 << log_r))
        f(s, narrow_bin<LOG_R>(tt, m, lp), b, vr[m], vi[m], shr[h0 + (m << lc)],
          shi[h0 + (m << lc)]);
  }
}

// D's, F's count and F's plane body of a plan (the wideband one with the
// pair tail where PAIR_OK).
template <int PLAN, bool PAIR_OK, class F>
__device__ __forceinline__ void for_each_tone(const void* re_t, const void* im_t, int in_bf16,
                                              const float* __restrict__ hr_t,
                                              const float* __restrict__ hi_t, int B, int S,
                                              int log_n, int cp, const float* __restrict__ twr,
                                              const float* __restrict__ twi, F f) {
  if constexpr (PLAN == kWide)
    for_each_tone_wide<PAIR_OK>(re_t, im_t, in_bf16, hr_t, hi_t, B, S, log_n, cp, twr, twi, f);
  else
    for_each_tone_narrow<narrow_log_r(PLAN)>(re_t, im_t, in_bf16, hr_t, hi_t, B, S, log_n, cp,
                                             twr, twi, f);
}

// The BPS LLRs of one tone at out[o + j·plane], rounded for a bf16 plane.
template <typename OutT, int BPS>
__device__ __forceinline__ void store_llrs(OutT* __restrict__ out, long long o, long long plane,
                                           const float* llr) {
#pragma unroll
  for (int j = 0; j < BPS; ++j) {
    if constexpr (sizeof(OutT) == 2) out[o + j * plane] = __float2bfloat16(llr[j]);
    else out[o + j * plane] = llr[j];
  }
}

using sdr::hard_bits;

// The kernels, one per mode, modulation and plan. The sample type
// (in_bf16), the index type (idx_bytes 1 or 2) and the plane's type
// (out_bf16) come at run time, as uniform branches around the loads and
// stores, so that each mode compiles once per modulation and plan (36
// kernels, not 144).
template <int M, bool BPSK, int PLAN>
__global__ void __launch_bounds__(kWideThreads, PLAN == kNarrow16 ? 2 : 1)
demod_sum_cl_kernel(const void* re_t, const void* im_t, int in_bf16,
                    const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                    float* __restrict__ partials, int B, int S, int log_n, int cp,
                    sdr::AxisTables tab, float inv_nv, const float* __restrict__ twr,
                    const float* __restrict__ twi) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  __shared__ float scratch[32];
  float acc = 0.0f;
  for_each_tone<PLAN, false>(re_t, im_t, in_bf16, hr_t, hi_t, B, S, log_n, cp, twr, twi,
                     [&](int, int, int, float yr, float yi, float h_r, float h_i) {
                       float llr[BPS];
                       tone_llrs<M, BPSK>(yr, yi, h_r, h_i, inv_nv, tab, llr);
#pragma unroll
                       for (int j = 0; j < BPS; ++j) acc += llr[j];
                     });
  const float v = sdr::block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = v;
}

template <int M, bool BPSK, int PLAN>
__global__ void __launch_bounds__(kWideThreads, PLAN == kNarrow16 ? 2 : 1)
demod_count_cl_kernel(const void* re_t, const void* im_t, int in_bf16,
                      const float* __restrict__ hr_t, const float* __restrict__ hi_t,
                      const void* idx_t, int idx_bytes, int32_t* __restrict__ out, int B, int S,
                      int log_n, int cp, sdr::AxisTables tab, float inv_nv,
                      const float* __restrict__ twr, const float* __restrict__ twi) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  const int N = 1 << log_n;
  const float norm = 1.0f / tab.inorm;
  int err = 0;
  for_each_tone<PLAN, false>(re_t, im_t, in_bf16, hr_t, hi_t, B, S, log_n, cp, twr, twi,
                     [&](int s, int k, int b, float yr, float yi, float h_r, float h_i) {
                       const long long o = ((long long)s * N + k) * B + b;
                       const int v = idx_bytes == 1 ? (int)static_cast<const int8_t*>(idx_t)[o]
                                                    : (int)static_cast<const int16_t*>(idx_t)[o];
                       const int bits = hard_bits<M, BPSK>(yr, yi, h_r, h_i, norm);
                       err += __popc((unsigned)((bits ^ v) & ((1 << BPS) - 1)));
                     });
  if constexpr (PLAN == kWide) {
    // Lanes c, c + C, ... of a warp serve channel c: shuffle-sum them into
    // lane c, which adds the warp's count for its channel.
    const int log_ch = wide_log_ch(log_n);
    for (int o = 16; o >= (1 << log_ch); o >>= 1) err += __shfl_down_sync(0xffffffffu, err, o);
    const int lane = threadIdx.x & 31;
    const int b = (blockIdx.x << log_ch) + lane;
    if (lane < (1 << log_ch) && b < B && err) atomicAdd(out + b, err);
  } else {
    // A warp's lanes serve 32 channels: each adds its own count.
    const int log_ch = narrow_log_ch(log_n, narrow_log_r(PLAN));
    const int b = (blockIdx.x << log_ch) + (threadIdx.x & ((1 << log_ch) - 1));
    if (b < B && err) atomicAdd(out + b, err);
  }
}

template <int M, bool BPSK, int PLAN>
__global__ void __launch_bounds__(kWideThreads, PLAN == kNarrow16 ? 2 : 1)
demod_llr_cl_kernel(const void* re_t, const void* im_t, int in_bf16,
                    const float* __restrict__ hr_t, const float* __restrict__ hi_t, void* out,
                    int out_bf16, int B, int S, int log_n, int cp, sdr::AxisTables tab,
                    float inv_nv, const float* __restrict__ twr, const float* __restrict__ twi) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  const int N = 1 << log_n;
  for_each_tone<PLAN, true>(
      re_t, im_t, in_bf16, hr_t, hi_t, B, S, log_n, cp, twr, twi,
      [&](int s, int k, int b, float yr, float yi, float h_r, float h_i) {
        float llr[BPS];
        tone_llrs<M, BPSK>(yr, yi, h_r, h_i, inv_nv, tab, llr);
        const long long o = ((long long)s * BPS * N + k) * B + b;
        if (out_bf16) store_llrs<__nv_bfloat16, BPS>(static_cast<__nv_bfloat16*>(out), o,
                                                     (long long)N * B, llr);
        else store_llrs<float, BPS>(static_cast<float*>(out), o, (long long)N * B, llr);
      });
}

template <class K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launches a kernel of either plan, opted in to its shared memory and to
// the largest shared-memory carveout; the wideband plan's as clusters of
// kWideCluster blocks.
template <class... P, class... A>
int launch_cl(void (*kernel)(P...), int B, int S, int log_n, cudaStream_t st, A... args) {
  const ClLaunch l = cl_launch(B, S, log_n);
  cudaError_t err = opt_in(kernel, l.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kWideCluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = l.grid;
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = log_n > kMaxLogNNarrow ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int log_n) {
  return B <= 0 || S <= 0 || log_n < 1 || log_n > kMaxLogN;
}

}  // namespace

// Calls launch_cl with the kernel of the plan that takes N = 2^log_n.
#define SDR_CL_LAUNCH(kernel, ...)                                                          \
  (plan_of(log_n) == kWide                                                                  \
       ? launch_cl(kernel<M, BPSK, kWide>, B, S, log_n, st, __VA_ARGS__)                    \
       : plan_of(log_n) == kNarrow32                                                        \
             ? launch_cl(kernel<M, BPSK, kNarrow32>, B, S, log_n, st, __VA_ARGS__)          \
             : launch_cl(kernel<M, BPSK, kNarrow16>, B, S, log_n, st, __VA_ARGS__))
