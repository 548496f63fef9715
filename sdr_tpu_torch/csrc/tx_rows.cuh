// Kernel B: fused TX + channel. The code its two entry points share:
// tx.cu (sdr_tx: channel off, or complex gains) and tx_fir.cu (sdr_tx_fir:
// the causal FIR), one translation unit each, so that nvcc builds them in
// parallel.
//
// Replaces sdr_tpu/kernels/tx_pallas.py::tx_channel_chain_pallas (gains,
// FIR, noise) and ::tx_chain_pallas (channel off), and at N 1024 to 4096
// fourstep_tx_split_pallas.py::tx_chain_fourstep2 and fourstep_tx_pallas.py
// ::tx_chain_fourstep, which split the inverse DFT into N1·N2 matmul steps
// because a dense N x N operand outgrew VMEM. The TPU kernels ran the
// inverse DFT as matmuls on the MXU; here it runs in f32 on CUDA cores.
//
// Per OFDM symbol (one row of the (B, S, N) index plane): Gray split
// gi = idx >> m, gq = idx & (L-1), prefix-XOR Gray decode, PAM level
// 2b - (L-1) (with the pilot comb of sdr_tx, tone k with k % spacing == 0
// takes the pilot point instead, PILOT_VALUE / norm, and its index is not
// read; k is the natural tone index, which the warp-group form's map step
// reads in the time layout); N-point inverse DFT scaled by norm/N; cyclic prefix (the last
// cp samples first); then either a complex gain hs, per link ((B,) or
// (B, 1)) or per symbol ((B, S)), or a causal FIR y[u] = sum_l tap_l x[u-l]
// of at most 16 taps: static (B, L), the zero-history convolution of each
// channel's whole CP'd stream, or per symbol (B, S, L), each symbol
// through its own taps with the previous symbol's tail as history
// (ops/channel.py::symbol_history); then noise sigma·n over every sample
// of the CP'd symbol, after the FIR. Noise modes: 0 off, 1 injected planes
// (n_re, n_im) of shape (B, S, N+cp), 2 keyed Philox: counter (ch_ids[b],
// s, sample, 0) on key seed ^ ROLE_NOISE, Box-Muller on words x and y —
// the bits of the plain version in sdr_tpu_torch/kernels/tx.py.
//
// Bound on the H100: the two f32 output planes, 8 bytes written a sample
// against 1 to 4 bytes of index read a tone. In the keyed mode the Philox
// multiplies (40 a sample) come close behind, then the Box-Muller
// transcendentals and the transform.
//
// The warp-group form (N 128 to 4096). The transform of kernel G and of
// C's warp-group form (warpfft.cuh), in their plans: a group of G warps
// holds one symbol in registers, R points a lane; G = 1 and R = 4, 8, 16
// at N 128, 256, 512; R = 16 and G = 2, 4, 8 at N 1024, 2048, 4096. The
// inverse runs as T2, time layout in and tone layout out (a DFT is
// symmetric in its two indices): each lane maps the tones of the time
// layout, bitrev5(lane) + 32 (w + G j) + 32 R d, so for each point a warp
// reads 32 consecutive indices of the row, a conflict-free read of the
// group's shared stage into which the row was copied by cp.async while the
// group's previous symbol stored. No bit-reversal pass, and no barrier at
// G = 1. The points, times norm/N (and the gain), go once through the
// group's padded stage (C's stride SP, written here in the tone layout and
// read in natural order), and the store pass takes the samples in natural
// order: group thread t takes V consecutive samples u = V (t + 32 G i) + v,
// V = 4, 2 or 1 as the row length and the planes' alignment allow (the
// widest that leaves at most an eighth of the lane-samples idle: at config
// 2's 320 samples a row V = 4 would idle a sixth and timed slower keyed
// than V = 2; the FIR, which loads V + L - 1 samples per V, gains most from
// V = 4), reads x[u < cp ? N - cp + u : u - cp]
// (or the FIR's taps over those), adds the noise of sample u (one Philox
// call a sample) and stores V floats to each plane: a warp's stores are one
// contiguous run. The loop stays rolled (an unrolled tail costs minutes of
// nvcc for no gain).
//
// A block takes a run of kRun = 32 symbols of one channel, so that what the
// run shares is read once a block: the twiddle tables, ch_ids[b], a
// per-link gain, static taps. A per-symbol gain is read once a symbol,
// per-symbol taps into the group's slot. The index width is read at run
// time; only the modulation, the plan and the FIR are template parameters.
// Three blocks share an SM at every plan: at 16 points a lane that holds
// the kernel to 80 registers with no spill, and it timed faster than two
// blocks at 96 registers in every mode at N 1024-4096.
//
// The FIR's history. Symbol s needs the last L-1 <= 15 clean samples of
// symbol s-1. Without the FIR the groups run free, each taking every
// (8/G)-th symbol of the run. With it they run in rounds of 8/G
// consecutive symbols between two block barriers: group g's store pass
// reads the tail of symbol s-1 from group g-1's stage, group 0 from a
// 16-sample history that the last group fills from its own stage before it
// overwrites it. A run that starts at s0 > 0 first has its last group
// transform symbol s0-1 once more, for its tail alone (one extra transform
// a run: at S = 64, one in 64); at s0 = 0 the history is zeros. No block
// reads another block's output or waits for one. Runs are kept for the FIR
// at every S, as for the gains: a channel gets ceil(S/32) blocks.
//
// N 2 to 64 (config 1 is N 64) stays on the shared-memory tile: a block
// holds a few symbols (the FIR: one channel, in order) and runs the radix-2
// FFT of common.cuh. The C entries choose by shape.
#pragma once
#include "common.cuh"
#include "philox.cuh"
#include "warpfft.cuh"

namespace {

// N = 32 R G from 2^kTxRowsMinLog: below it the tile runs.
constexpr int kTxRowsMinLog = 7;
constexpr int kMaxTaps = 16;
constexpr int kTxWarps = sdr::kThreads / 32;

// One launch of the warp-group form, by value.
struct TxArgs {
  const void* idx;        // (B, S, N) int8 / int16 / int32 indices
  float* out_re;          // (B, S, N+cp) sample planes
  float* out_im;
  const float* twr;       // forward twiddles e^{-2 pi i k/N}, k < N/2
  const float* twi;
  const float* hs_r;      // gains (B,) or (B, S), or null
  const float* hs_i;
  const float* taps_r;    // FIR taps (B, L) or (B, S, L), or null
  const float* taps_i;
  const float* n_re;      // injected noise (B, S, N+cp), noise mode 1
  const float* n_im;
  const int32_t* ch_ids;  // (B,) global channel ids, noise mode 2
  int B, S, log_n, cp, idx_bytes, h_syms, n_taps, taps_per_sym, noise_mode, vec;
  int pilot;              // the comb: tone k with k % pilot == 0 carries (pilot_r, pilot_i); 0 off
  float scale, sigma, pilot_r, pilot_i, pilot_inv;  // pilot_inv = 1/pilot (sdr::on_comb)
  sdr::PhiloxKeys keys;
};

// Byte offsets of the block's shared buffers, the same on the host (its
// size) and the device (its carving).
struct TxCarve {
  int tw;    // N float2: W_N^{bitrev5(lane) (w + G r)} (warpfft.cuh)
  int tw3;   // 32G float2 (G > 1)
  int xtw;   // 5 x 32 float2
  int stg;   // per group A·SP float2: the exchange (G > 1), then the scaled points
  int ix;    // per group N indices of idx_bytes each: the symbol's index row
  int taps;  // FIR: per group kMaxTaps float2, the symbol's taps (static: group 0's)
  int hist;  // FIR: kMaxTaps float2, the last samples of the round's previous symbol
  int total;
};

__host__ __device__ inline int tx_take(int& off, int bytes) {
  const int o = off;
  off += (bytes + 15) & ~15;
  return o;
}

__host__ __device__ inline TxCarve tx_carve(int R, int G, int idx_bytes, bool fir) {
  const int N = 32 * R * G, A = R * G, groups = kTxWarps / G;
  TxCarve c;
  int off = 0;
  c.tw = tx_take(off, 8 * N);
  c.tw3 = tx_take(off, G > 1 ? 8 * 32 * G : 0);
  c.xtw = tx_take(off, 8 * 5 * 32);
  c.stg = tx_take(off, 8 * A * sdr::stage_stride(A) * groups);
  c.ix = tx_take(off, idx_bytes * N * groups);
  c.taps = tx_take(off, fir ? 8 * kMaxTaps * groups : 0);
  c.hist = tx_take(off, fir ? 8 * kMaxTaps : 0);
  c.total = off;
  return c;
}

// Adds the noise of samples u0 .. u0 + V - 1 of symbol s (flat offset o of
// sample u0) and stores them.
template <int V>
__device__ __forceinline__ void noisy_store(const TxArgs& a, long long o, uint32_t ch, int s,
                                            int u0, float (&yr)[V], float (&yi)[V]) {
  if (a.noise_mode == 1) {
    float nr[V], ni[V];
    sdr::load_run<V>(a.n_re + o, nr);
    sdr::load_run<V>(a.n_im + o, ni);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      yr[v] += a.sigma * nr[v];
      yi[v] += a.sigma * ni[v];
    }
  } else if (a.noise_mode == 2) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint4 w =
          sdr::philox4x32_10(make_uint4(ch, (uint32_t)s, (uint32_t)(u0 + v), 0u), a.keys);
      float g1, g2;
      sdr::box_muller(w.x, w.y, g1, g2);
      yr[v] += a.sigma * g1;
      yi[v] += a.sigma * g2;
    }
  }
  sdr::store_run<V>(a.out_re + o, yr);
  sdr::store_run<V>(a.out_im + o, yi);
}

template <int V>
struct Vec {
  static constexpr int value = V;
};

template <int M, bool BPSK, int R, int G, bool FIR>
__global__ void __launch_bounds__(sdr::kThreads, 3) tx_rows_kernel(const TxArgs a) {
  using C = sdr::Ctx<R, G>;
  constexpr int N = C::N, A = C::A, SP = sdr::stage_stride(A), kGroups = kTxWarps / G;
  extern __shared__ __align__(16) unsigned char tx_smem[];
  const TxCarve cv = tx_carve(R, G, a.idx_bytes, FIR);
  float2* tw = (float2*)(tx_smem + cv.tw);
  float2* tw3 = (float2*)(tx_smem + cv.tw3);
  float2* xtw = (float2*)(tx_smem + cv.xtw);
  float2* taps = (float2*)(tx_smem + cv.taps);
  float2* hist = (float2*)(tx_smem + cv.hist);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, group = warp / G;
  const int t = tid - 32 * G * group;  // thread of the group: 32 (warp mod G) + lane
  const int n_chunks = (a.S + sdr::kRun - 1) / sdr::kRun;
  const int b = blockIdx.x / n_chunks;
  const int s0 = (blockIdx.x - b * n_chunks) * sdr::kRun;
  const int s1 = min(a.S, s0 + sdr::kRun);
  const int sym_len = N + a.cp, L = a.n_taps;

  // ---- what the run shares: twiddles, the channel id, a per-link gain,
  // static taps, the zero history -----------------------------------------
  sdr::build_tables<R, G>(tw, tw3, xtw, a.twr, a.twi, a.log_n);
  if constexpr (FIR) {
    if (!a.taps_per_sym && tid < L)
      taps[tid] = make_float2(__ldg(a.taps_r + b * L + tid), __ldg(a.taps_i + b * L + tid));
    if (tid < kMaxTaps) hist[tid] = make_float2(0.0f, 0.0f);
  }
  const uint32_t ch = a.noise_mode == 2 ? (uint32_t)__ldg(a.ch_ids + b) : 0u;
  const bool gained = !FIR && a.hs_r != nullptr;
  const float2 link_gain =
      gained && a.h_syms == 1 ? make_float2(__ldg(a.hs_r + b), __ldg(a.hs_i + b))
                              : make_float2(1.0f, 0.0f);

  float2* stg = (float2*)(tx_smem + cv.stg) + (size_t)group * A * SP;
  unsigned char* ix = tx_smem + cv.ix + (size_t)group * a.idx_bytes * N;
  float2* tp = taps + (FIR && a.taps_per_sym ? group * kMaxTaps : 0);
  const long long row0 = (long long)b * a.S;
  const char* idx_b = static_cast<const char*>(a.idx) + (row0 << a.log_n) * a.idx_bytes;
  auto fetch = [&](int s) {
    sdr::copy_async(ix, idx_b + ((long long)s << a.log_n) * a.idx_bytes, N * a.idx_bytes, t,
                    32 * G);
  };
  __syncthreads();

  // The front of symbol s: its index row (landed in ix) mapped in the time
  // layout, the copy of symbol `next` started, the inverse transform, x
  // norm/N and the gain, the points into the group's stage.
  auto front = [&](int s, int next) {
    const int ln = sdr::opaque(lane), w = sdr::opaque(warp % G);
    const C cx{ln, w, group, tw, tw3, xtw, stg};
    sdr::cp_async_wait_all();
    sdr::group_sync<G>(group);
    float vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = cx.t_index(r);  // the natural tone index of point r
      if (a.pilot && sdr::on_comb(k, a.pilot, a.pilot_inv))
        vr[r] = a.pilot_r, vi[r] = a.pilot_i;
      else
        sdr::pam_point<M, BPSK>(sdr::staged_index(ix, a.idx_bytes, k), vr[r], vi[r]);
    }
    sdr::group_sync<G>(group);  // every lane has read the row
    if (next >= 0) fetch(next);
    cx.template t2<true>(vr, vi);
    const float2 h = gained && a.h_syms > 1
                         ? make_float2(__ldg(a.hs_r + row0 + s), __ldg(a.hs_i + row0 + s))
                         : link_gain;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      vr[r] *= a.scale;
      vi[r] *= a.scale;
      if (gained) sdr::cmul<false>(vr[r], vi[r], h);
    }
    sdr::group_sync<G>(group);  // the exchange's and the last store pass's readers are done
#pragma unroll
    for (int r = 0; r < R; ++r) stg[(r * G + w) * SP + ln] = make_float2(vr[r], vi[r]);
  };

  // Sample n (natural order) of the stage st.
  auto at = [&](const float2* st, int n) { return st[(n % A) * SP + n / A]; };
  // Clean sample v of the symbol's CP'd waveform; with the FIR, v < 0 is
  // sample sym_len + v of the previous symbol (its tail: n = N + v).
  auto x_at = [&](int v) {
    if (!FIR || v >= 0) return at(stg, v < a.cp ? v + N - a.cp : v - a.cp);
    return group > 0 ? at(stg - A * SP, N + v) : hist[kMaxTaps + v];
  };

  // The store pass of symbol s, V samples a thread and step.
  auto store = [&](int s, auto vec) {
    constexpr int V = decltype(vec)::value;
    const long long o0 = (row0 + s) * sym_len;
#pragma unroll 1
    for (int u0 = V * t; u0 < sym_len; u0 += V * 32 * G) {
      float yr[V], yi[V];
      if constexpr (FIR) {
        // win[v] = x[u0 + v - l] at tap l: one new sample a tap.
        float2 win[V], acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          win[v] = x_at(u0 + v);
          acc[v] = make_float2(0.0f, 0.0f);
        }
#pragma unroll 1
        for (int l = 0; l < L; ++l) {
          const float2 g = tp[l];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            sdr::cmac(acc[v], g, win[v].x, win[v].y);
          }
#pragma unroll
          for (int v = V - 1; v > 0; --v) win[v] = win[v - 1];
          win[0] = x_at(u0 - l - 1);  // u0 - L >= -kMaxTaps: inside the history
        }
#pragma unroll
        for (int v = 0; v < V; ++v) yr[v] = acc[v].x, yi[v] = acc[v].y;
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float2 x = x_at(u0 + v);
          yr[v] = x.x, yi[v] = x.y;
        }
      }
      noisy_store<V>(a, o0 + u0, ch, s, u0, yr, yi);
    }
  };
  auto store_pass = [&](int s) {
    if (a.vec == 4) store(s, Vec<4>{});
    else if (a.vec == 2) store(s, Vec<2>{});
    else store(s, Vec<1>{});
  };

  if constexpr (!FIR) {
    if (s0 + group < s1) fetch(s0 + group);
    for (int s = s0 + group; s < s1; s += kGroups) {
      front(s, s + kGroups < s1 ? s + kGroups : -1);
      sdr::group_sync<G>(group);
      store_pass(s);
    }
  } else {
    // Rounds of kGroups consecutive symbols; the last group holds the
    // round's previous symbol (a run that starts at s0 > 0: symbol s0 - 1).
    const int last = kGroups - 1;
    bool have_prev = s0 > 0;
    if (have_prev && group == last) {
      fetch(s0 - 1);
      front(s0 - 1, s0 + last < s1 ? s0 + last : -1);
    } else if (s0 + group < s1) {
      fetch(s0 + group);
    }
    for (int base = s0; base < s1; base += kGroups) {
      const int s = base + group;
      __syncthreads();  // the last round's store passes are done with the stages and history
      if (have_prev && group == last) {
        if (t < kMaxTaps) hist[t] = at(stg, N - kMaxTaps + t);
        sdr::group_sync<G>(group);  // read before the group overwrites its stage
      }
      if (s < s1) {
        front(s, s + kGroups < s1 ? s + kGroups : -1);
        if (a.taps_per_sym && t < L) {
          const long long o = (row0 + s) * L + t;
          tp[t] = make_float2(__ldg(a.taps_r + o), __ldg(a.taps_i + o));
        }
      }
      __syncthreads();  // every stage and slot of the round written
      if (s < s1) store_pass(s);
      have_prev = true;
    }
  }
}

template <int M, bool BPSK, bool FIR, int R, int G>
int tx_rows_launch(const TxArgs& a, cudaStream_t st) {
  const TxCarve cv = tx_carve(R, G, a.idx_bytes, FIR);
  const auto kernel = tx_rows_kernel<M, BPSK, R, G, FIR>;
  if (cv.total > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cv.total);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)a.B * ((a.S + sdr::kRun - 1) / sdr::kRun);
  kernel<<<(unsigned)blocks, sdr::kThreads, cv.total, st>>>(a);
  return (int)cudaGetLastError();
}

// The plan of N = 2^log_n, 128 to 4096: one warp a symbol to N 512, then
// 2, 4 and 8.
template <int M, bool BPSK, bool FIR>
int tx_rows_launch_n(const TxArgs& a, cudaStream_t st) {
  switch (a.log_n) {
    case 7: return tx_rows_launch<M, BPSK, FIR, 4, 1>(a, st);
    case 8: return tx_rows_launch<M, BPSK, FIR, 8, 1>(a, st);
    case 9: return tx_rows_launch<M, BPSK, FIR, 16, 1>(a, st);
    case 10: return tx_rows_launch<M, BPSK, FIR, 16, 2>(a, st);
    case 11: return tx_rows_launch<M, BPSK, FIR, 16, 4>(a, st);
    case 12: return tx_rows_launch<M, BPSK, FIR, 16, 8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The samples a store takes (V): the widest of 4, 2 and 1 that divides the
// row, that the planes' alignment allows and that leaves at most an eighth
// of the row's lane-samples idle over its 32·G threads; failing that, the
// one that leaves the fewest idle.
inline int tx_vec(int sym_len, int threads, const float* n_re, const float* n_im) {
  int best = 1, best_idle = sym_len;
  for (int v = 4; v >= 1; v /= 2) {
    const uintptr_t mis = ((uintptr_t)n_re | (uintptr_t)n_im) & (uintptr_t)(4 * v - 1);
    if (sym_len % v != 0 || mis != 0) continue;
    const int step = v * threads;
    const int idle = (sym_len + step - 1) / step * step - sym_len;
    if (8 * idle <= sym_len) return v;
    if (idle < best_idle) best = v, best_idle = idle;
  }
  return best;
}

// The launch arguments every mode takes; hs, taps and their counts are the
// caller's. Returns false for a shape or alignment the form refuses.
inline bool tx_rows_args(TxArgs& a, const void* idx, int idx_bytes, float* out_re, float* out_im,
                         int B, int S, int log_n, int cp, float scale, const float* twr,
                         const float* twi, int noise_mode, const float* n_re, const float* n_im,
                         const int32_t* ch_ids, unsigned k0, unsigned k1, float sigma) {
  a = TxArgs{};
  a.idx = idx, a.out_re = out_re, a.out_im = out_im, a.twr = twr, a.twi = twi;
  a.n_re = noise_mode == 1 ? n_re : nullptr, a.n_im = noise_mode == 1 ? n_im : nullptr;
  a.ch_ids = ch_ids;
  a.B = B, a.S = S, a.log_n = log_n, a.cp = cp, a.idx_bytes = idx_bytes;
  a.noise_mode = noise_mode, a.scale = scale, a.sigma = sigma;
  a.keys = sdr::philox_keys(k0, k1);
  const int N = 1 << log_n;
  const int threads = 32 * (log_n <= 9 ? 1 : 1 << (log_n - 9));
  a.vec = tx_vec(N + cp, threads, a.n_re, a.n_im);
  const bool aligned = ((uintptr_t)idx & 15) == 0 && ((uintptr_t)out_re & 15) == 0 &&
                       ((uintptr_t)out_im & 15) == 0;
  return log_n >= kTxRowsMinLog && log_n <= 12 && cp >= 0 && cp <= N && aligned &&
         (idx_bytes == 1 || idx_bytes == 2 || idx_bytes == 4) && noise_mode >= 0 &&
         noise_mode <= 2 && (long long)B * ((S + sdr::kRun - 1) / sdr::kRun) <= 0x7FFFFFFFLL;
}

// ---- the shared-memory tile (N 2 to 64) ---------------------------------

// Symbols per block: enough for 256 butterflies per stage.
__host__ int log_symbols_per_block(int log_n) { return log_n >= 9 ? 0 : 9 - log_n; }

// Gray-map n_rows_valid of the n_tr rows starting at row0 into shared
// memory, bit-reversed within each transform; rows past the valid ones
// are zeros. With the comb (pilot > 0), tone n with n % pilot == 0 takes
// (pilot_r, pilot_i) and its index is not read.
template <typename IdxT, int M, bool BPSK>
__device__ __forceinline__ void load_symbols(const IdxT* __restrict__ idx, long long row0,
                                             int n_valid, int log_n, int log_tr, float* sre,
                                             float* sim, int pilot, float pilot_r,
                                             float pilot_i) {
  const int N = 1 << log_n;
  for (int e = threadIdx.x; e < (1 << (log_tr + log_n)); e += blockDim.x) {
    const int t = e >> log_n;
    const int n = e & (N - 1);
    float xr = 0.0f, xi = 0.0f;
    if (t < n_valid && pilot && n % pilot == 0)  // the tile: N <= 64
      xr = pilot_r, xi = pilot_i;
    else if (t < n_valid)
      sdr::pam_point<M, BPSK>((int)idx[((row0 + t) << log_n) + n], xr, xi);
    const int dst = (t << log_n) + sdr::bit_reverse(n, log_n);
    sre[dst] = xr;
    sim[dst] = xi;
  }
}

// Adds the noise of sample (b, s, u) at flat offset o and stores it.
__device__ __forceinline__ void store_noisy(float yr, float yi, long long o, int noise_mode,
                                            const float* __restrict__ n_re,
                                            const float* __restrict__ n_im, uint32_t ch, int s,
                                            int u, uint32_t k0, uint32_t k1, float sigma,
                                            float* __restrict__ out_re,
                                            float* __restrict__ out_im) {
  if (noise_mode == 1) {
    yr += sigma * n_re[o];
    yi += sigma * n_im[o];
  } else if (noise_mode == 2) {
    const uint4 w = sdr::philox4x32_10(make_uint4(ch, (uint32_t)s, (uint32_t)u, 0u), k0, k1);
    float g1, g2;
    sdr::box_muller(w.x, w.y, g1, g2);
    yr += sigma * g1;
    yi += sigma * g2;
  }
  out_re[o] = yr;
  out_im[o] = yi;
}

}  // namespace
