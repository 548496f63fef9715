// Kernel E: the fast engine's staged channel stage, one read-modify-write
// pass over an externally built waveform.
//
// Replaces sdr_tpu/kernels/channel_pallas.py::fade_awgn_pallas together with
// the FIR that the JAX route runs before it in XLA (sdr_tpu/link/fast.py::
// apply_channel_fast): over the planar (B, S, L) samples (L = N + cp),
//   out = FIR(x) + sigma * n   or   out = x * h + sigma * n,
// sigma = sqrt(noise_var / 2). The FIR is causal, y[u] = sum_l tap_l x[u-l]
// over 1 <= Lt <= L + 1 taps: static taps (B, Lt) run each channel's whole
// CP'd stream from zero history; per-symbol taps (B, S, Lt) run each symbol
// with its own taps and the previous symbol's last Lt-1 clean samples as
// history, zeros before symbol 0 (ops/channel.py::grid_fir). Either way the
// history of a sample is the channel's flat stream just before it; only the
// taps' row differs. Optional history planes (B, Lt - 1) hold the clean
// samples that precede row 0 (a time block's halo: the previous block's
// tail, link/stream.py) and replace the zeros there, for both tap layouts.
// The gain h, exclusive with the FIR, is per link (hs (B, 1)) or per symbol
// ((B, S)). Noise modes: 0 off, 1 injected planes (n_re, n_im) of shape
// (B, S, L), 2 keyed Philox with kernel B's counter: (ch_ids[b], s0 + s, u,
// 0) on key seed ^ ROLE_NOISE, Box-Muller on words 0 and 1, so the staged
// route and the fused one (kernel B's FIR mode) draw the same noise for the
// same samples, and a time block whose first symbol is s0 draws the whole
// frame's noise of its rows (the TPU kernel seeded its on-core PRNG per
// 128-channel block; that is not carried over).
//
// Bound on the H100: the bytes, two f32 planes read and two written (16 a
// sample), in every mode but the FIR with more than about 40 taps, where
// the FIR's 8 f32 operations a tap and sample take over; the keyed noise's
// Philox multiplies (40 a sample) come within half of the bytes. What sets
// the FIR mode's time is issue: its sums in kernel B's order take 6
// instructions a tap and output (a multiply, a fused multiply-add and an
// add a component), not 4, on top of the noise's Philox and Box-Muller.
//
// Design. A block takes a run of kRun consecutive symbols of one channel,
// so the channel id, a per-link gain and static taps are read once a block
// and per-symbol gains once a symbol (into shared memory). Each thread takes
// V = 4 consecutive samples of the run's flat range, on the plane's 16-byte
// grid: one 16-byte load or store a plane, and four independent Philox
// calls in flight; the quads that cross the run's ends go sample by sample.
// A quad's symbol and position are carried from one step to the next (one
// division a thread, not a sample); a quad may cross a symbol boundary when
// L is not a multiple of 4, so each sample takes its own (s, u). Planes off
// the 16-byte grid (a channel slice of an odd-length plane) take V = 1.
//
// The FIR mode stages the run tile by tile: a tile of T clean samples and at
// least Lt before it (the history, read from the input; before the channel's
// first sample from the history planes, or zeros) in shared memory as two
// planes on the 16-byte grid, and the taps of the tile's symbols beside
// them, each row padded to a multiple of four. A thread's four outputs start
// on the grid, so taps 4m .. 4m+3 meet only the quads m and m+1 before them:
// a group of four taps loads one 16-byte quad a plane (consecutive lanes,
// consecutive quads: no bank conflict) and its taps in two 16-byte
// broadcasts. The sums keep kernel B's order (csrc/tx_rows.cuh, store pass):
// acc += tap * x over l ascending from zero, so the two routes give the same
// bits. Quads at a tile's ends, and quads whose samples lie in two symbols
// of per-symbol taps, run sample by sample in the same order. No block reads
// another block's output: blocks run in any order.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kRun = 32;        // symbols of one channel a block
constexpr int kMinTile = 4096;  // FIR tile (samples): at least this and 4 Lt
constexpr int kBlocksPerSm = 4;

struct FadeArgs {
  const float* re;  // (B, S, L) clean planes
  const float* im;
  float* out_re;
  float* out_im;
  const float* hr;  // gains (B, 1) or (B, S), or null
  const float* hi;
  const float* taps_r;  // FIR taps (B, Lt) or (B, S, Lt), or null
  const float* taps_i;
  const float* n_re;  // injected noise (B, S, L), noise mode 1
  const float* n_im;
  const int32_t* ch_ids;  // (B,) global channel ids, noise mode 2
  const float* hist_r;    // (B, Lt - 1) clean samples before row 0, or null (zeros)
  const float* hist_i;
  int S, L, h_syms, n_taps, taps_per_sym, noise_mode, tile, stage, tap_stride, s0;
  float sigma;
  sdr::PhiloxKeys keys;
};

// The block's run: channel b, symbols [s0, s1), channel-relative samples
// [lo, hi); cb is the flat index of the channel's first sample.
struct Run {
  int b, s0, s1, lo, hi;
  long long cb;
};

__device__ __forceinline__ Run block_run(const FadeArgs& a) {
  const int n_chunks = (a.S + kRun - 1) / kRun;
  Run r;
  r.b = blockIdx.x / n_chunks;
  r.s0 = (blockIdx.x - r.b * n_chunks) * kRun;
  r.s1 = min(a.S, r.s0 + kRun);
  r.lo = r.s0 * a.L;
  r.hi = r.s1 * a.L;
  r.cb = (long long)r.b * a.S * a.L;
  return r;
}

// The first unit of V samples at or below channel-relative sample x whose
// flat index is a multiple of V (the planes' 16-byte grid for V = 4).
template <int V>
__device__ __forceinline__ int unit_at(const Run& r, int x) {
  return V == 1 ? x : x - (int)((r.cb + x) & (V - 1));
}

// Symbol s and position u of channel-relative sample x (x may lie a few
// samples below 0: s is then negative).
__device__ __forceinline__ void locate(int x, int L, int& s, int& u) {
  s = (x >= 0 ? x : x - L + 1) / L;
  u = x - s * L;
}

// Symbol and position of the sample v after (s, u).
__device__ __forceinline__ void step_in(int s, int u, int v, int L, int& sv, int& uv) {
  sv = s;
  uv = u + v;
  while (uv >= L) {
    uv -= L;
    ++sv;
  }
}

// (s, u) of the sample a thread's step (ds symbols and du samples) after.
__device__ __forceinline__ void advance(int& s, int& u, int ds, int du, int L) {
  u += du;
  s += ds;
  if (u >= L) {
    u -= L;
    ++s;
  }
}

// Adds the noise of the V samples from channel-relative x (symbol s,
// position u of the first) and stores those in [lo, hi); `whole`: all V are,
// so the accesses are 16 bytes wide.
template <int V>
__device__ __forceinline__ void noisy_store(const FadeArgs& a, const Run& r, uint32_t ch, int x,
                                            bool whole, int lo, int hi, int s, int u,
                                            float (&yr)[V], float (&yi)[V]) {
  const long long o = r.cb + x;
  if (a.noise_mode == 1) {
    float nr[V], ni[V];
    if (whole) {
      sdr::load_run<V>(a.n_re + o, nr);
      sdr::load_run<V>(a.n_im + o, ni);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool in = x + v >= lo && x + v < hi;
        nr[v] = in ? __ldg(a.n_re + o + v) : 0.0f;
        ni[v] = in ? __ldg(a.n_im + o + v) : 0.0f;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      yr[v] += a.sigma * nr[v];
      yi[v] += a.sigma * ni[v];
    }
  } else if (a.noise_mode == 2) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      int sv, uv;
      step_in(s, u, v, a.L, sv, uv);
      const uint4 w =
          sdr::philox4x32_10(make_uint4(ch, (uint32_t)(a.s0 + sv), (uint32_t)uv, 0u), a.keys);
      float g1, g2;
      sdr::box_muller(w.x, w.y, g1, g2);
      yr[v] += a.sigma * g1;
      yi[v] += a.sigma * g2;
    }
  }
  if (whole) {
    sdr::store_run<V>(a.out_re + o, yr);
    sdr::store_run<V>(a.out_im + o, yi);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (x + v >= lo && x + v < hi) {
        a.out_re[o + v] = yr[v];
        a.out_im[o + v] = yi[v];
      }
    }
  }
}

// The gains and noise over a run (no FIR).
template <int V>
__global__ void __launch_bounds__(sdr::kThreads, kBlocksPerSm) fade_stream_kernel(const FadeArgs a) {
  __shared__ float2 gains[kRun];
  const Run r = block_run(a);
  const int L = a.L;
  const uint32_t ch = a.noise_mode == 2 ? (uint32_t)__ldg(a.ch_ids + r.b) : 0u;
  const bool gained = a.hr != nullptr, per_sym = gained && a.h_syms > 1;
  float2 link = make_float2(1.0f, 0.0f);
  if (gained && !per_sym) link = make_float2(__ldg(a.hr + r.b), __ldg(a.hi + r.b));
  if (per_sym) {
    const long long g0 = (long long)r.b * a.S + r.s0;
    for (int i = threadIdx.x; i < r.s1 - r.s0; i += blockDim.x)
      gains[i] = make_float2(__ldg(a.hr + g0 + i), __ldg(a.hi + g0 + i));
    __syncthreads();
  }
  const int step = V * blockDim.x, ds = step / L, du = step - ds * L;
  int x = unit_at<V>(r, r.lo) + V * (int)threadIdx.x;
  int s, u;
  locate(x, L, s, u);
  for (; x < r.hi; x += step) {
    const bool whole = x >= r.lo && x + V <= r.hi;
    const long long o = r.cb + x;
    float yr[V], yi[V];
    if (whole) {
      sdr::load_run<V>(a.re + o, yr);
      sdr::load_run<V>(a.im + o, yi);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool in = x + v >= r.lo && x + v < r.hi;
        yr[v] = in ? __ldg(a.re + o + v) : 0.0f;
        yi[v] = in ? __ldg(a.im + o + v) : 0.0f;
      }
    }
    if (gained) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float2 h = link;
        if (per_sym) {
          int sv, uv;
          step_in(s, u, v, L, sv, uv);
          h = gains[min(max(sv - r.s0, 0), r.s1 - r.s0 - 1)];
        }
        const float tr = yr[v] * h.x - yi[v] * h.y;
        yi[v] = yr[v] * h.y + yi[v] * h.x;
        yr[v] = tr;
      }
    }
    noisy_store<V>(a, r, ch, x, whole, r.lo, r.hi, s, u, yr, yi);
    advance(s, u, ds, du, L);
  }
}

// Four consecutive floats from a 16-byte aligned shared address.
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

// One output of the FIR at stage index j with taps tp[0 .. Lt): kernel
// B's order, acc += tap * x over l ascending from zero.
__device__ __forceinline__ float2 fir_point(const float* xr, const float* xi, const float2* tp,
                                            int Lt, int j) {
  float2 acc = make_float2(0.0f, 0.0f);
  for (int l = 0; l < Lt; ++l) {
    const float2 g = tp[l];
    const float wr = xr[j - l], wi = xi[j - l];  // j - l >= j - Lt + 1 > 0: staged
    sdr::cmac(acc, g, wr, wi);
  }
  return acc;
}

// The four outputs at stage index j0 (a multiple of 4), the same sums as
// fir_point's. Taps go four at a time: taps 4m .. 4m+3 meet the samples
// of quads m and m+1 before j0's (quad 0 is the outputs' own), so a group
// loads one new quad a plane and two quads of taps, 16 bytes each.
__device__ __forceinline__ void fir_quad(const float* xr, const float* xi, const float2* tp,
                                         int Lt, int j0, float (&yr)[4], float (&yi)[4]) {
  float cr[4], ci[4], pr[4], pi[4];
  ld4(xr + j0, cr);
  ld4(xi + j0, ci);
  float2 acc[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) acc[v] = make_float2(0.0f, 0.0f);
  auto group = [&](int m, int n) {  // taps 4m .. 4m + n - 1
    ld4(xr + j0 - 4 * (m + 1), pr);  // >= j0 - 4 ceil(Lt / 4) >= 0: staged
    ld4(xi + j0 - 4 * (m + 1), pi);
    const float4 t01 = *reinterpret_cast<const float4*>(tp + 4 * m);
    const float4 t23 = *reinterpret_cast<const float4*>(tp + 4 * m + 2);
    const float2 g[4] = {make_float2(t01.x, t01.y), make_float2(t01.z, t01.w),
                         make_float2(t23.x, t23.y), make_float2(t23.z, t23.w)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= n) break;
#pragma unroll
      for (int v = 0; v < 4; ++v) {  // sample j0 + v - (4m + k)
        const int d = v - k;
        const float wr = d >= 0 ? cr[d] : pr[d + 4], wi = d >= 0 ? ci[d] : pi[d + 4];
        sdr::cmac(acc[v], g[k], wr, wi);
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) cr[v] = pr[v], ci[v] = pi[v];
  };
  const int full = Lt >> 2;
#pragma unroll 2
  for (int m = 0; m < full; ++m) group(m, 4);
  if (Lt & 3) group(full, Lt & 3);
#pragma unroll
  for (int v = 0; v < 4; ++v) yr[v] = acc[v].x, yi[v] = acc[v].y;
}

// The FIR, then the noise, over a run, tile by tile.
template <int V>
__global__ void __launch_bounds__(sdr::kThreads, kBlocksPerSm) fade_fir_kernel(const FadeArgs a) {
  extern __shared__ __align__(16) float fir_smem[];
  float* xr = fir_smem;
  float* xi = fir_smem + a.stage;
  float2* tp = reinterpret_cast<float2*>(fir_smem + 2 * a.stage);
  const Run r = block_run(a);
  const int L = a.L, Lt = a.n_taps, ts = a.tap_stride;
  const uint32_t ch = a.noise_mode == 2 ? (uint32_t)__ldg(a.ch_ids + r.b) : 0u;
  if (!a.taps_per_sym) {
    for (int l = threadIdx.x; l < Lt; l += blockDim.x)
      tp[l] = make_float2(__ldg(a.taps_r + (long long)r.b * Lt + l),
                          __ldg(a.taps_i + (long long)r.b * Lt + l));
  }
  const int step = V * blockDim.x, ds = step / L, du = step - ds * L;
  for (int g0 = r.lo; g0 < r.hi;) {
    const int g1 = min(r.hi, unit_at<V>(r, g0) + a.tile);
    // Stage index 0 is sample x0, on the grid and at least Lt before g0;
    // samples below the channel's first come from the history planes (the
    // Lt - 1 just before it) or are zeros.
    const int x0 = unit_at<V>(r, g0 - Lt);
    __syncthreads();  // the previous tile's readers are done
    for (int x = x0 + V * (int)threadIdx.x; x < g1; x += step) {
      const long long o = r.cb + x;
      float vr[V], vi[V];
      if (x >= 0 && x + V <= g1) {
        sdr::load_run<V>(a.re + o, vr);
        sdr::load_run<V>(a.im + o, vi);
        sdr::store_run<V>(xr + (x - x0), vr);
        sdr::store_run<V>(xi + (x - x0), vi);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (x + v >= g1) break;
          float wr = 0.0f, wi = 0.0f;
          if (x + v >= 0) {
            wr = __ldg(a.re + o + v);
            wi = __ldg(a.im + o + v);
          } else if (a.hist_r != nullptr && x + v >= 1 - Lt) {
            const long long h = (long long)r.b * (Lt - 1) + (Lt - 1) + x + v;
            wr = __ldg(a.hist_r + h);
            wi = __ldg(a.hist_i + h);
          }
          xr[x + v - x0] = wr;
          xi[x + v - x0] = wi;
        }
      }
    }
    // Per-symbol taps: the rows of the tile's symbols [sf, sl], contiguous
    // in the input, tap_stride apart here.
    const int sf = a.taps_per_sym ? g0 / L : 0;
    if (a.taps_per_sym) {
      const int n = ((g1 - 1) / L - sf + 1) * Lt;
      const long long t0 = ((long long)r.b * a.S + sf) * Lt;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int row = i / Lt;
        tp[row * ts + i - row * Lt] = make_float2(__ldg(a.taps_r + t0 + i),
                                                  __ldg(a.taps_i + t0 + i));
      }
    }
    __syncthreads();
    int x = unit_at<V>(r, g0) + V * (int)threadIdx.x;
    int s, u;
    locate(x, L, s, u);
    for (; x < g1; x += step) {
      const bool whole = x >= g0 && x + V <= g1;
      float yr[V], yi[V];
      if (V == 4 && whole && (!a.taps_per_sym || u + V <= L)) {
        if constexpr (V == 4)
          fir_quad(xr, xi, tp + (a.taps_per_sym ? (s - sf) * ts : 0), Lt, x - x0, yr, yi);
      } else {
        // Sample by sample: the tile's ends and quads across two symbols.
#pragma unroll
        for (int v = 0; v < V; ++v) {
          yr[v] = yi[v] = 0.0f;
          if (x + v < g0 || x + v >= g1) continue;
          int sv, uv;
          step_in(s, u, v, L, sv, uv);
          const float2 y =
              fir_point(xr, xi, tp + (a.taps_per_sym ? (sv - sf) * ts : 0), Lt, x + v - x0);
          yr[v] = y.x;
          yi[v] = y.y;
        }
      }
      noisy_store<V>(a, r, ch, x, whole, g0, g1, s, u, yr, yi);
      advance(s, u, ds, du, L);
    }
    g0 = g1;
  }
}

template <int V>
int launch(const FadeArgs& a, int B, cudaStream_t st) {
  const long long blocks = (long long)B * ((a.S + kRun - 1) / kRun);
  if (a.taps_r == nullptr) {
    fade_stream_kernel<V><<<(unsigned)blocks, sdr::kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  FadeArgs f = a;
  f.tap_stride = (a.n_taps + 3) & ~3;  // a tap row 16-byte aligned
  // The tile: at least kMinTile samples and 4 Lt (the history's share at
  // most a fifth), a multiple of 4, halved until the stage fits. A stage
  // plane holds the tile, Lt + 3 samples of history and its last quad.
  int tile = kMinTile;
  while (tile < 4 * a.n_taps) tile *= 2;
  size_t smem = 0;
  for (;; tile /= 2) {
    if (tile < 4) return (int)cudaErrorInvalidValue;
    const int rows = a.taps_per_sym ? min(min(kRun, a.S), (tile - 1) / a.L + 2) : 1;
    f.stage = (tile + a.n_taps + 8) & ~3;
    smem = sizeof(float) * 2 * (size_t)f.stage + sizeof(float2) * (size_t)rows * f.tap_stride;
    if (smem <= 232448) break;
  }
  f.tile = tile;
  auto kernel = fade_fir_kernel<V>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, sdr::kThreads, smem, st>>>(f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdr_fade_awgn(const float* re, const float* im, float* out_re, float* out_im,
                             int B, int S, int L, const float* hr, const float* hi, int h_syms,
                             const float* taps_r, const float* taps_i, int n_taps,
                             int taps_per_sym, const float* hist_r, const float* hist_i,
                             int s0, int noise_mode, const float* n_re, const float* n_im,
                             const int32_t* ch_ids, unsigned k0, unsigned k1, float sigma,
                             void* stream) {
  if ((long long)B * S == 0 || L == 0) return 0;
  // Channel-relative offsets are 32-bit; the FIR's taps reach back at most
  // one symbol and its history.
  if ((long long)S * L + 4 * sdr::kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (taps_r != nullptr && (n_taps < 1 || n_taps > L + 1 || hr != nullptr))
    return (int)cudaErrorInvalidValue;
  if (s0 < 0 || (long long)s0 + S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (hist_r != nullptr && (taps_r == nullptr || hist_i == nullptr))
    return (int)cudaErrorInvalidValue;
  FadeArgs a;
  a.re = re, a.im = im, a.out_re = out_re, a.out_im = out_im;
  a.hr = hr, a.hi = hi, a.h_syms = h_syms;
  a.taps_r = taps_r, a.taps_i = taps_i, a.n_taps = n_taps, a.taps_per_sym = taps_per_sym;
  a.n_re = n_re, a.n_im = n_im, a.ch_ids = ch_ids, a.noise_mode = noise_mode;
  a.hist_r = n_taps > 1 ? hist_r : nullptr, a.hist_i = n_taps > 1 ? hist_i : nullptr;
  a.S = S, a.L = L, a.tile = 0, a.stage = 0, a.tap_stride = 0, a.s0 = s0;
  a.sigma = sigma;
  a.keys = sdr::philox_keys(k0, k1);
  // 16-byte accesses need every plane on the 16-byte grid.
  const void* planes[] = {re, im, out_re, out_im, n_re, n_im};
  bool aligned = true;
  for (const void* p : planes) aligned = aligned && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return aligned ? launch<4>(a, B, st) : launch<1>(a, B, st);
}
