// Kernel C, rows layout: the shared-memory tile, at N = 2 to 64 alone.
// Its warp-group form (demod_rows.cuh; demod_count.cu, demod_llr.cu,
// demod_despread_*.cu, demod_tp.cu) takes the count (h plane and taps=),
// the LLR plane and the sum, each also with the despread (SC-FDE)
// receive, and the tensor-parallel stage-2 mode (tp_stage2_llr) at N =
// 128 to 4096; the post-FFT mode (llr_chain) has no transform and its own
// streaming form (llr_chain.cu). This file keeps those modes (the TP mode
// included) at N = 2 to 64.
//
// Replaces sdr_tpu/kernels/demod_pallas.py::demod_count_pallas (the
// fast engine's count terminal) with its taps= and despread modes, and
// ::demod_chain_pallas (the LLR plane in the public order, or its sum,
// with despread; demod_llr_kernel below: the same load, transform and
// tails with a store or a deterministic sum in place of the count). Per
// OFDM symbol (one row of the (B, S, N+cp) planes):
//   CP strip; forward unscaled N-point FFT; p = conj(h) y,
//   h2 = |h|^2, s = p / max(h2, 1e-12), inv_eff = h2 / nv; per-axis
//   max-log LLR (level scan for L <= 4, Gray fold recursion for L >= 8;
//   I bits then Q bits, MSB first); hard decision llr < 0 against
//   (idx >> (bps-1-j)) & 1; integer error count per channel (with the
//   pilot comb, pilot > 0, over the data tones: k % pilot != 0).
// h is (B, 1, N) or (B, S, N), or, in the taps mode, built in the
// kernel from per-symbol FIR taps (B, S, L <= 8):
//   H[k] = sum_l t_l e^{-2 pi i k l / N},
// with the twiddle of (k l) mod N from the forward table (k < N/2; the
// upper half by e^{-2 pi i (m + N/2)/N} = -e^{-2 pi i m/N}), so the
// (B, S, N) complex response never goes to device memory (the TPU kernel
// built it with one HIGHEST-precision matmul against the DFT phase rows).
// The despread mode (full-grid SC-FDMA, SC-FDE receive) replaces the
// per-tone tail with common.cuh's despread_count_tail: biased MMSE per
// tone, the row's tone-mean gain b (a fixed-order block reduction over
// the whole row), an inverse FFT on the same tile (the despread), 1/b,
// LLRs at SINR b/(1-b), counted against the time-domain indices. A row
// is whole in one block (a block holds 2^(9 - log N) rows at N 2 to 64),
// so the reduction never crosses blocks. Counts are summed with integer
// atomics, which give the same result in any order.
//
// The tile: a block of 256 threads holds 2^(9 - log N) symbols
// bit-reversed in shared memory and runs radix-2 FFTs on them, log2 N
// stages a barrier each, on CUDA cores in f32 (the TPU kernel ran the DFT
// as a Gauss 3-multiplication matmul on the MXU in bf16 passes, and the
// despread as a second matmul).
// Bound on the H100: the bytes (8 a sample read, the channel and index
// planes, 4 a bit of a plane written); its stages, each moving 4 shared
// words a point, are what hold it far under that bound, most of all in
// the despread mode, which doubles them.
#include "demod_rows.cuh"

namespace {

template <typename IdxT, int M, bool BPSK, bool DESPREAD>
__global__ void __launch_bounds__(sdr::kThreads)
demod_count_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   const float* __restrict__ hr, const float* __restrict__ hi, int h_syms,
                   const float* __restrict__ taps_r, const float* __restrict__ taps_i,
                   int n_taps, const IdxT* __restrict__ idx, int32_t* __restrict__ out,
                   long long n_rows, int S, int log_n, int cp, int log_spb, sdr::AxisTables tab,
                   float inv_nv, float nv, int pilot, const float* __restrict__ twr,
                   const float* __restrict__ twi) {
  extern __shared__ float smem[];
  const int N = 1 << log_n;
  const int spb = 1 << log_spb;
  float* sre = smem;
  float* sim = smem + (spb << log_n);
  int* cnt = (int*)(sim + (spb << log_n));
  float* tp_r = (float*)(cnt + spb);
  float* tp_i = tp_r + spb * kMaxTaps;
  float* red = tp_i + spb * kMaxTaps;
  float* bias = red + sdr::kThreads / 32;
  const long long row0 = (long long)blockIdx.x << log_spb;
  const int sym_len = N + cp;

  if ((int)threadIdx.x < spb) cnt[threadIdx.x] = 0;
  for (int e = threadIdx.x; e < (spb << log_n); e += blockDim.x) {
    const int t = e >> log_n;
    const int n = e & (N - 1);
    const long long r = row0 + t;
    float xr = 0.0f, xi = 0.0f;
    if (r < n_rows) {
      const long long o = r * sym_len + cp + n;
      xr = re[o];
      xi = im[o];
    }
    const int dst = (t << log_n) + sdr::bit_reverse(n, log_n);
    sre[dst] = xr;
    sim[dst] = xi;
  }
  for (int e = threadIdx.x; e < spb * n_taps; e += blockDim.x) {
    const int t = e / n_taps;
    const int l = e - t * n_taps;
    const long long r = row0 + t;
    if (r < n_rows) {
      tp_r[t * kMaxTaps + l] = taps_r[r * n_taps + l];
      tp_i[t * kMaxTaps + l] = taps_i[r * n_taps + l];
    }
  }
  __syncthreads();
  sdr::smem_fft(sre, sim, log_n, log_spb, N, 1, twr, twi, 1.0f);

  // Channel of tone k of block row t ((1, 0) past the last row).
  auto channel = [&](int t, int k, float& h_r, float& h_i) {
    const long long r = row0 + t;
    h_r = 1.0f;
    h_i = 0.0f;
    if (r >= n_rows) return;
    if (n_taps) {
      const int half = N >> 1;
      h_r = h_i = 0.0f;
      for (int l = 0; l < n_taps; ++l) {
        const int m = (k * l) & (N - 1);
        const float wr = m < half ? __ldg(twr + m) : -__ldg(twr + m - half);
        const float wi = m < half ? __ldg(twi + m) : -__ldg(twi + m - half);
        const float tr = tp_r[t * kMaxTaps + l], ti = tp_i[t * kMaxTaps + l];
        h_r += tr * wr - ti * wi;
        h_i += tr * wi + ti * wr;
      }
    } else {
      const long long b = r / S;
      const int s = (int)(r - b * S);
      const long long ho = ((b * h_syms + (h_syms > 1 ? s : 0)) << log_n) + k;
      h_r = hr[ho];
      h_i = hi[ho];
    }
  };
  // Transmitted index of position n of block row t (-1 past the last row).
  auto index = [&](int t, int n) {
    const long long r = row0 + t;
    return r < n_rows ? (int)idx[(r << log_n) + n] : -1;
  };

  if constexpr (DESPREAD) {
    sdr::despread_count_tail<M, BPSK>(sre, sim, log_n, log_spb, nv, twr, twi, tab, red, bias, cnt,
                                      channel, index);
  } else {
    for (int e = threadIdx.x; e < (spb << log_n); e += blockDim.x) {
      const int t = e >> log_n;
      const int k = e & (N - 1);
      const int v = index(t, k);
      if (v < 0 || (pilot && k % pilot == 0)) continue;  // past the rows, or a pilot tone
      float h_r, h_i;
      channel(t, k, h_r, h_i);
      const int err = sdr::mmse_bit_errors<M, BPSK>(sre[e], sim[e], h_r, h_i, inv_nv, tab, v);
      if (err) atomicAdd(cnt + t, err);
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < spb) {
    const long long r = row0 + threadIdx.x;
    if (r < n_rows && cnt[threadIdx.x]) atomicAdd(out + r / S, cnt[threadIdx.x]);
  }
}

// The LLR-plane and sum modes (demod_pallas.py::demod_chain_pallas): the
// count kernel's load, transform and tone (or SC-FDE) tail over an h plane
// (B, 1 | S, N), with a store of each tone's BPS LLRs in the public order
// out[(row * N + k) * BPS + j] (per time symbol with DESPREAD) in place of
// the count, or (SUM) each thread's running sum of its LLRs, reduced per
// block in a fixed order into partials[block] (sum_partials_kernel adds
// those), so repeated runs give the same bits.
//
// TP: the tensor-parallel stage-2 mode (parallel/tp.py::_stage2_llr_pallas,
// the four-step's phase B on one device's digit block). Rows are
// (b, s, k1) of the twiddled stage-1 output (B, S, n1d, N = n2), with no
// CP; the h row is (b, h_sym, k1) of the digit-major channel
// (B, h_syms, n1d, n2); the noise variance is read from device memory
// (nv_dev, one f32), so one launch sequence serves any Eb/N0 with no host
// sync, as the TPU kernel's SMEM scalar did. The store is the public
// order above: per row, subcarrier-major [k·BPS + j] (the TPU kernel
// wrote bit-major lanes and transposed them after the call). The TPU
// kernel ran the n2-point DFT as a Gauss complex matmul on the MXU; here,
// at n2 = 2 to 64, it is the same shared-memory radix-2 f32 FFT as every
// other mode (demod_rows.cuh's TP flag takes n2 = 128 to 4096).
template <int M, bool BPSK, bool DESPREAD, bool SUM, bool TP = false>
__global__ void __launch_bounds__(sdr::kThreads)
demod_llr_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 const float* __restrict__ hr, const float* __restrict__ hi, int h_syms,
                 float* __restrict__ out, long long n_rows, int S, int log_n, int cp,
                 int log_spb, sdr::AxisTables tab, float inv_nv, float nv,
                 const float* __restrict__ twr, const float* __restrict__ twi, int n1d = 1,
                 const float* __restrict__ nv_dev = nullptr) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  static_assert(!TP || (!DESPREAD && !SUM), "the TP mode stores the plane");
  if constexpr (TP) inv_nv = 1.0f / fmaxf(__ldg(nv_dev), 1e-12f);
  extern __shared__ float smem[];
  const int N = 1 << log_n;
  const int spb = 1 << log_spb;
  float* sre = smem;
  float* sim = smem + (spb << log_n);
  float* red = sim + (spb << log_n);
  float* bias = red + sdr::kThreads / 32;
  const long long row0 = (long long)blockIdx.x << log_spb;
  const int sym_len = N + cp;

  for (int e = threadIdx.x; e < (spb << log_n); e += blockDim.x) {
    const int t = e >> log_n;
    const int n = e & (N - 1);
    const long long r = row0 + t;
    float xr = 0.0f, xi = 0.0f;
    if (r < n_rows) {
      const long long o = r * sym_len + cp + n;
      xr = re[o];
      xi = im[o];
    }
    const int dst = (t << log_n) + sdr::bit_reverse(n, log_n);
    sre[dst] = xr;
    sim[dst] = xi;
  }
  __syncthreads();
  sdr::smem_fft(sre, sim, log_n, log_spb, N, 1, twr, twi, 1.0f);

  auto channel = [&](int t, int k, float& h_r, float& h_i) {
    const long long r = row0 + t;
    h_r = 1.0f;
    h_i = 0.0f;
    if (r >= n_rows) return;
    long long ho;
    if constexpr (TP) {
      const long long per_b = (long long)S * n1d;
      const long long b = r / per_b;
      const long long rem = r - b * per_b;
      const int s = (int)(rem / n1d);
      const int k1 = (int)(rem - (long long)s * n1d);
      ho = (((b * h_syms + (h_syms > 1 ? s : 0)) * n1d + k1) << log_n) + k;
    } else {
      const long long b = r / S;
      const int s = (int)(r - b * S);
      ho = ((b * h_syms + (h_syms > 1 ? s : 0)) << log_n) + k;
    }
    h_r = hr[ho];
    h_i = hi[ho];
  };
  float acc = 0.0f;
  auto sink = [&](int t, int k, const float* llr) {
    if constexpr (SUM) {
#pragma unroll
      for (int j = 0; j < BPS; ++j) acc += llr[j];
    } else {
      sdr::store_run<BPS>(out + (((row0 + t) << log_n) + k) * BPS, llr);
    }
  };

  if constexpr (DESPREAD) {
    sdr::despread_equalize(sre, sim, log_n, log_spb, nv, twr, twi, red, bias, channel);
    sdr::despread_for_each(sre, sim, log_n, log_spb, bias,
                           [&](int t, int n, float sr, float si, float sinr) {
                             if (row0 + t >= n_rows) return;
                             float llr[BPS];
                             sdr::scaled_llrs<M, BPSK>(sr, si, sinr, tab, llr);
                             sink(t, n, llr);
                           });
  } else {
    for (int e = threadIdx.x; e < (spb << log_n); e += blockDim.x) {
      const int t = e >> log_n;
      const int k = e & (N - 1);
      if (row0 + t >= n_rows) continue;
      float h_r, h_i;
      channel(t, k, h_r, h_i);
      float llr[BPS];
      sdr::mmse_llrs<M, BPSK>(sre[e], sim[e], h_r, h_i, inv_nv, tab, llr);
      sink(t, k, llr);
    }
  }
  if constexpr (SUM) {
    __syncthreads();
    const float v = sdr::block_sum(acc, red);
    if (threadIdx.x == 0) out[blockIdx.x] = v;
  }
}

// demod_llr_kernel's grid and dynamic shared memory: 2^log_spb rows of
// 2^log_n points a block.
struct LlrLaunch {
  long long blocks;
  size_t smem;
};

LlrLaunch llr_launch(long long n_rows, int log_n, int log_spb) {
  return LlrLaunch{(n_rows + (1 << log_spb) - 1) >> log_spb,
                   (size_t)2 * sizeof(float) * ((size_t)1 << (log_spb + log_n)) +
                       sizeof(float) * (sdr::kThreads / 32 + ((size_t)1 << log_spb))};
}

template <int M, bool BPSK, bool DESPREAD, bool SUM>
int launch_llr(const float* re, const float* im, const float* hr, const float* hi, int h_syms,
               float* out, float* partials, long long n_rows, int S, int log_n, int cp,
               int log_spb, const sdr::AxisTables& tab, float inv_nv, float nv, const float* twr,
               const float* twi, cudaStream_t st) {
  const LlrLaunch l = llr_launch(n_rows, log_n, log_spb);
  demod_llr_kernel<M, BPSK, DESPREAD, SUM><<<(unsigned)l.blocks, sdr::kThreads, l.smem, st>>>(
      re, im, hr, hi, h_syms, SUM ? partials : out, n_rows, S, log_n, cp, log_spb, tab, inv_nv,
      nv, twr, twi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !SUM) return (int)err;
  sdr::sum_partials_kernel<<<1, 1024, 0, st>>>(partials, (int)l.blocks, out);
  return (int)cudaGetLastError();
}

template <int M, bool BPSK>
int launch_tp_stage2(const float* tr, const float* ti, const float* hr, const float* hi,
                     int h_syms, const float* nv_dev, float* out, long long n_rows, int S,
                     int n1d, int log_n, const sdr::AxisTables& tab, const float* twr,
                     const float* twi, cudaStream_t st) {
  const int log_spb = 9 - log_n;  // N <= 64: at least 8 rows a block
  const LlrLaunch l = llr_launch(n_rows, log_n, log_spb);
  demod_llr_kernel<M, BPSK, false, false, true><<<(unsigned)l.blocks, sdr::kThreads, l.smem,
                                                  st>>>(
      tr, ti, hr, hi, h_syms, out, n_rows, S, log_n, 0, log_spb, tab, 0.0f, 0.0f, twr, twi, n1d,
      nv_dev);
  return (int)cudaGetLastError();
}

}  // namespace

// The TP stage-2 mode at n2 = 2 to 64 (sdr_tp_stage2_llr in demod_tp.cu
// takes n2 = 128 to 4096 in the warp-group form): t (B, S, n1d, n2)
// twiddled stage-1 output, h (B, h_syms, n1d, n2) digit-major, nv one f32
// on the device; out (B, S, n1d, n2·BPS) subcarrier-major.
int demod_tp_tile(const float* tr, const float* ti, const float* hr, const float* hi, int h_syms,
                  const float* nv, float* out, int B, int S, int n1d, int log_n,
                  int bits_per_axis, int bpsk, const sdr::AxisTables& tab, const float* twr,
                  const float* twi, cudaStream_t st) {
  const long long n_rows = (long long)B * S * n1d;
  if (n_rows <= 0 || h_syms < 1 || log_n < 1 || log_n >= kRowsMinLog)
    return (int)cudaErrorInvalidValue;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    return launch_tp_stage2<M, BPSK>(tr, ti, hr, hi, h_syms, nv, out, n_rows, S, n1d, log_n, tab,
                                     twr, twi, st))
  return (int)cudaErrorInvalidValue;
}

// Per-block partials of the tile's sum.
int demod_llr_tile_partials(int B, int S, int log_n) {
  const int log_spb = 9 - log_n;  // N <= 64: at least 8 rows a block
  return (int)((((long long)B * S) + (1 << log_spb) - 1) >> log_spb);
}

int demod_llr_tile(const float* re, const float* im, const float* hr, const float* hi,
                   int h_syms, float* out, float* partials, int B, int S, int log_n, int cp,
                   int bits_per_axis, int bpsk, const sdr::AxisTables& tab, float inv_nv,
                   float nv, int despread, int reduce_sum, const float* twr, const float* twi,
                   cudaStream_t st) {
  const long long n_rows = (long long)B * S;
  if (n_rows == 0) return (int)cudaErrorInvalidValue;
  const int log_spb = 9 - log_n;  // N <= 64: at least 8 rows a block
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    if (despread && reduce_sum)
      return launch_llr<M, BPSK, true, true>(re, im, hr, hi, h_syms, out, partials, n_rows, S,
                                             log_n, cp, log_spb, tab, inv_nv, nv, twr, twi, st);
    if (despread)
      return launch_llr<M, BPSK, true, false>(re, im, hr, hi, h_syms, out, partials, n_rows, S,
                                              log_n, cp, log_spb, tab, inv_nv, nv, twr, twi, st);
    if (reduce_sum)
      return launch_llr<M, BPSK, false, true>(re, im, hr, hi, h_syms, out, partials, n_rows, S,
                                              log_n, cp, log_spb, tab, inv_nv, nv, twr, twi, st);
    return launch_llr<M, BPSK, false, false>(re, im, hr, hi, h_syms, out, partials, n_rows, S,
                                             log_n, cp, log_spb, tab, inv_nv, nv, twr, twi, st))
  return (int)cudaErrorInvalidValue;
}

int demod_count_tile(const float* re, const float* im, const float* hr, const float* hi,
                     int h_syms, const float* taps_r, const float* taps_i, int n_taps,
                     const void* idx, int idx_bytes, int32_t* out, int B, int S, int log_n,
                     int cp, int bits_per_axis, int bpsk, const sdr::AxisTables& tab,
                     float inv_nv, float nv, int despread, int pilot, const float* twr,
                     const float* twi, cudaStream_t st) {
  const long long n_rows = (long long)B * S;
  if (n_rows == 0) return 0;
  if (n_taps < 0 || n_taps > kMaxTaps || (despread && n_taps)) return (int)cudaErrorInvalidValue;
  const int log_spb = 9 - log_n;  // N <= 64: at least 8 rows a block
  const long long blocks = (n_rows + (1 << log_spb) - 1) >> log_spb;
  const size_t smem = (size_t)2 * sizeof(float) * ((size_t)1 << (log_spb + log_n)) +
                      sizeof(int) * ((size_t)1 << log_spb) +
                      (size_t)2 * sizeof(float) * kMaxTaps * ((size_t)1 << log_spb) +
                      sizeof(float) * (sdr::kThreads / 32 + ((size_t)1 << log_spb));
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    SDR_DISPATCH_IDX(idx_bytes,
      if (despread) {
        demod_count_kernel<IdxT, M, BPSK, true><<<(unsigned)blocks, sdr::kThreads, smem, st>>>(
            re, im, hr, hi, h_syms, taps_r, taps_i, n_taps, (const IdxT*)idx, out, n_rows, S,
            log_n, cp, log_spb, tab, inv_nv, nv, 0, twr, twi);
      } else {
        demod_count_kernel<IdxT, M, BPSK, false><<<(unsigned)blocks, sdr::kThreads, smem, st>>>(
            re, im, hr, hi, h_syms, taps_r, taps_i, n_taps, (const IdxT*)idx, out, n_rows, S,
            log_n, cp, log_spb, tab, inv_nv, nv, pilot, twr, twi);
      }))
  return (int)cudaGetLastError();
}
