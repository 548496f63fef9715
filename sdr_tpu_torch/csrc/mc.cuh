// Kernel G: the whole Monte-Carlo link in one kernel. This header holds
// the kernel; mc.cu its entry point and OFDM instantiations, mc_spread.cu
// the SC-FDMA ones (two sources, so that nvcc builds them in parallel).
//
// Replaces sdr_tpu/kernels/mc_pallas.py::mc_count_pallas (n_fft 128-512,
// SC-FDMA at <= 256) and ::_mc_count_fourstep (n_fft 1024-4096) with one
// kernel. The TPU needed two because its dense N x N DFT operands
// outgrow VMEM past 512 points and Mosaic could not lower the large
// transforms any other way; register-resident FFTs have neither limit.
//
// Per symbol s of channel b:
//   indices (keyed: kernel A's layout, word k mod 4 of counter (ch, s, k div 4, 0));
//   Gray map to PAM levels; [SC-FDMA: forward DFT, x norm/sqrt(N)];
//   x H[k] per subcarrier; inverse DFT (x norm/N, or 1/N after the
//   spread); + sigma n on the N payload samples only, sigma =
//   sqrt(nv/N/2), the noise of time sample n on kernel B's counter
//   (ch, s, cp + n, 0); forward DFT; the OFDM tail (unbiased one-tap
//   MMSE, max-log LLR) or the SC-FDE tail (biased MMSE, per-symbol bias
//   b = max(mean |H|^2/(|H|^2+nv), 1e-9), inverse DFT, max-log LLR at
//   SINR b/(1-b)); errors against the indices, summed per channel.
// With CP >= L-1 the per-subcarrier channel before the inverse DFT is
// the circular convolution the fast engine's time-domain FIR gives after
// the CP strip, and the CP samples' noise is stripped there, so a keyed
// pass is the fast engine's link for the same (seed, channel id), up to
// float rounding: counts agree but for decisions on near-zero LLRs.
//
// The layout. A group of G warps holds one symbol in registers, R points
// a lane: G = 1 and R = N/32 (4, 8, 16) up to N = 512, R = 16 and G = 2,
// 4 or 8 at N = 1024, 2048 or 4096. Everything the link does between its
// transforms is elementwise (x H[k], the noise of sample n, the per-tone
// tail against idx[k]), so no point is ever put into natural order: each
// lane knows the index of every point it holds. With A = N/32:
//   tone layout: point r of thread (w, lane) is index A*lane + G*r + w;
//   time layout: point j*G + d is index bitrev5(lane) + 32*(w + G*j) + 32*R*d.
// T1 takes the tone layout to the time layout: the 32-point DFT across
// the lanes as decimation in frequency (five __shfl_xor_sync stages,
// natural lane order in, bit-reversed out), the twiddle
// W_N^{bitrev5(lane) (w + G r)}, the R-point DFT in registers, and for
// G > 1 the twiddle W_A^{c w}, one exchange through the group's shared
// buffer and G-point DFTs in registers. T2 runs the same steps backwards
// (the cross-lane stages as decimation in time, bit-reversed in, natural
// out), from the time layout to the tone layout. Either runs forward or
// inverse (csrc/warpfft.cuh, shared with kernel C's warp-group form).
// OFDM: tones -> T1 inverse -> noise -> T2 forward -> tones.
// SC-FDMA: the spread input at the tone layout -> T1 forward (spread) ->
// x H at the time layout (its indices are the subcarriers) -> T2 inverse
// -> noise -> T1 forward -> equalise -> T2 inverse (despread) -> LLRs
// against the indices at the tone layout. Every lane draws the noise of
// the samples it holds and the indices of its own quads of tones (A*lane +
// 4i .. +3 for G = 1; for G > 1 each word goes through the group's index
// stash to its owner). The twiddles come from shared tables built once a
// block. The noise, the SC-FDE equaliser and the tails run as rolled loops
// (two points an iteration) over the points staged in shared memory, not
// unrolled over all R: that halved the build and cost no time on the
// H100. A warp never waits on another outside its group, and a group of
// one warp never waits at all.
//
// Channel state, drawn once per block on the fast engine's fading
// stream (ops/channel.py, key seed ^ ROLE_FADING), a block taking one
// channel and a run of its symbols: flat Rayleigh (lane 0, counter
// (ch, 0, 0)); Rician (LOS phase lane 1, diffuse lane 0); static taps
// (lane 0, counter (ch, 0, l), x sqrt(p_l / sum p)) and their H[k], built
// once into shared memory; the Jakes paths' (cos theta, phi) (lane 2,
// counter (ch, row, p), 16 paths; row = the tap for per-tap Jakes taps).
// Per symbol a warp evaluates the 16 path terms of a gain in 16 lanes and
// sums them in path order, rounding as torch's jakes_eval does; per-tap
// Jakes taps then give H[k] per symbol. H[k] of a tap set is L complex
// multiply-adds on the powers of W_N^k. The injected mode reads idx, the N(0, 1) noise planes
// and the response planes (B, 1 | S, N) instead of drawing them
// (mc_pallas.py:242-247).
//
// Bound on the H100: operations. Only the seed, the channel ids and the
// (B,) counts touch device memory. Per sample the kernel runs one
// Philox-4x32-10 call and a Box-Muller pair for the noise, a quarter of a
// call for the index (40 32-bit multiplies a call), two (four with
// SC-FDMA) FFTs' butterflies in registers and shuffles, and the LLR tail.
// The TPU kernel ran its transforms as matmuls on the MXU; here they are
// f32 on CUDA cores.
#pragma once
#include "common.cuh"
#include "philox.cuh"
#include "warpfft.cuh"

// Launch parameters, passed by value from kernels/_lib.py::McParams. At
// namespace scope (not in the anonymous namespace below), so that the
// extern "C" entry point that takes it keeps external linkage.
struct McParams {
  const int32_t* ch_ids;  // (B,) global channel ids
  int32_t* out;           // (B,) error counts, accumulated
  const int32_t* idx_in;  // injected (B, S, N) indices, or null (keyed)
  const float* n_re;      // injected (B, S, N) N(0, 1) noise planes
  const float* n_im;
  const float* h_re;      // injected (B, h_syms, N) response planes
  const float* h_im;
  const float* amps;      // (L,) tap amplitudes sqrt(p_l / sum p)
  const float* twr;       // forward twiddles e^{-2 pi i k/N}, k < N/2
  const float* twi;
  int B, S, log_n, cp;
  int spc;       // symbols a block takes (set by the C entry)
  int n_chunks;  // blocks a channel (set by the C entry)
  int kind, n_taps, h_syms, noise;
  unsigned kp0, kp1, kn0, kn1, kf0, kf1;  // payload, noise, fading keys
  int idx_mask;
  float sigma;         // time-domain noise std per component
  float nv, inv_nv;    // subcarrier noise variance (clamped) and 1/nv
  float tx_scale;      // norm/N (OFDM) or 1/N (after the spread)
  float spread_scale;  // norm/sqrt(N) (SC-FDMA)
  float a_los, s_dif;  // Rician sqrt(K/(K+1)), sqrt(0.5/(K+1))
  float jakes_w;       // (float)(2 pi fd)
};

namespace {

// The transform and its helpers (warpfft.cuh).
using namespace sdr;

// Channel kinds (the wrapper maps the channel model to these).
enum : int {
  kNone = 0,     // IDENTITY, AWGN: H = 1
  kFlat = 1,     // RAYLEIGH_FLAT: one complex gain per channel
  kRician = 2,   // RICIAN: LOS + diffuse gain per channel
  kJakes = 3,    // RAYLEIGH_TIME: one Jakes gain per symbol
  kTaps = 4,     // MULTIPATH: static taps
  kTapsSym = 5,  // MULTIPATH_TIME: per-tap Jakes taps per symbol
  kPlane = 6,    // injected response planes (B, h_syms, N)
};

constexpr int kJakesPaths = 16;
constexpr int kJakesLane = 2;
constexpr int kWarps = sdr::kThreads / 32;

// Byte offsets of the block's shared tables (dynamic shared memory), the
// same on the host (its size) and the device (its carving). Positions
// within a table of N entries: pos = (r*G + w)*32 + lane for point r of
// thread (w, lane), so that a warp's 32 lanes touch 32 adjacent words.
struct Carve {
  int tw;    // N float2: W_N^{bitrev5(lane) (w + G r)} at pos (step 2 of T1/T2)
  int tw3;   // 32G float2: W_A^{c w} at w*32 + c (G > 1)
  int xtw;   // 5 x 32 float2: the cross-lane stages' twiddles
  int xch;   // per group N float2: the exchange buffer (G > 1)
  int hk;    // N float2: static-tap H at pos (kTaps)
  int wk;    // N float2: W_N^k of the point's subcarrier at pos (kTapsSym)
  int jp;    // rows x 16 float2: (cos theta, phi) of the Jakes paths
  int tg;    // L float2: static tap gains (kTaps)
  int wg;    // per warp L float2: the symbol's taps (kTapsSym)
  int hw;    // per group N float2: the symbol's H at pos (kTapsSym, kPlane)
  int sidx;  // per group N int16: the symbol's indices at pos
  int stg;   // per group N float2: the points staged at pos for the rolled loops (G = 1;
             // groups of several warps stage through xch)
  int red;   // kWarps floats: the SC-FDE bias partials
  int misc;  // flat gain (float2), block count (int)
  int total;
};

__host__ __device__ inline int take(int& off, int bytes) {
  const int o = off;
  off += (bytes + 15) & ~15;
  return o;
}

__host__ __device__ inline Carve carve(int N, int G, int kind, int L) {
  const int groups = kWarps / G;
  const int rows = kind == kJakes ? 1 : (kind == kTapsSym ? L : 0);
  Carve c;
  int off = 0;
  c.tw = take(off, 8 * N);
  c.tw3 = take(off, G > 1 ? 8 * 32 * G : 0);
  c.xtw = take(off, 8 * 5 * 32);
  c.xch = take(off, G > 1 ? 8 * N * groups : 0);
  c.hk = take(off, kind == kTaps ? 8 * N : 0);
  c.wk = take(off, kind == kTapsSym ? 8 * N : 0);
  c.jp = take(off, 8 * kJakesPaths * rows);
  c.tg = take(off, kind == kTaps ? 8 * L : 0);
  c.wg = take(off, kind == kTapsSym ? 8 * L * kWarps : 0);
  c.hw = take(off, (kind == kTapsSym || kind == kPlane) ? 8 * N * groups : 0);
  c.sidx = take(off, 2 * N * groups);
  c.stg = take(off, G > 1 ? 0 : 8 * N * groups);
  c.red = take(off, 4 * kWarps);
  c.misc = take(off, 16);
  c.total = off;
  return c;
}

// W_N^m (forward), 0 <= m < N, from the half-circle table.
__device__ __forceinline__ float2 w_table(const McParams& p, int m) {
  return sdr::w_table(p.twr, p.twi, p.log_n, m);
}

// The 16 path terms e^{i(ws cos theta_p + phi_p)} of the Jakes row `row`
// of this half-warp at ws = (float)(2 pi fd) * s, one a lane (path lane
// mod 16), summed in path order with separate roundings, as torch's
// ops/channel.py::jakes_eval; times 1/4. Every lane of the half gets the
// row's gain. jp: (cos theta, phi) at row*16 + p; a row >= n_rows gives 0.
__device__ __forceinline__ float2 jakes_half(const float2* jp, int row, int n_rows, float ws,
                                             int lane) {
  float cr = 0.0f, ci = 0.0f;
  if (row < n_rows) {
    const float2 q = jp[row * kJakesPaths + (lane & 15)];
    const float ang = __fadd_rn(__fmul_rn(ws, q.x), q.y);
    cr = cosf(ang);
    ci = sinf(ang);
  }
  float ar = 0.0f, ai = 0.0f;
#pragma unroll
  for (int q = 0; q < kJakesPaths; ++q) {
    ar = __fadd_rn(ar, __shfl_sync(kFull, cr, (lane & 16) + q));
    ai = __fadd_rn(ai, __shfl_sync(kFull, ci, (lane & 16) + q));
  }
  return make_float2(ar * 0.25f, ai * 0.25f);
}

// Up to 85 registers a thread for R <= 8 (three blocks of 256 threads an
// SM), 128 for R = 16 (two).
template <int M, bool BPSK, bool SPREAD, int R, int G>
__global__ void __launch_bounds__(sdr::kThreads, R <= 8 ? 3 : 2)
    mc_kernel(McParams p, sdr::AxisTables tab, sdr::PhiloxKeys kpay, sdr::PhiloxKeys knoise) {
  using C = Ctx<R, G>;
  constexpr int N = C::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.n_taps;
  const Carve cv = carve(N, G, p.kind, L);
  float2* tw = (float2*)(smem + cv.tw);
  float2* tw3 = (float2*)(smem + cv.tw3);
  float2* xtw = (float2*)(smem + cv.xtw);
  float2* hk = (float2*)(smem + cv.hk);
  float2* wk = (float2*)(smem + cv.wk);
  float2* jp = (float2*)(smem + cv.jp);
  float2* tg = (float2*)(smem + cv.tg);
  float* red = (float*)(smem + cv.red);
  float2* flat = (float2*)(smem + cv.misc);
  int* cnt = (int*)(smem + cv.misc + 8);

  const int b = blockIdx.x / p.n_chunks;
  const int s0 = (blockIdx.x - b * p.n_chunks) * p.spc;
  const int s1 = min(p.S, s0 + p.spc);
  const uint32_t ch = (uint32_t)p.ch_ids[b];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  // ---- the block's tables and the channel's state --------------------
  if (tid == 0) *cnt = 0;
  build_tables<R, G>(tw, tw3, xtw, p.twr, p.twi, p.log_n);
  // The subcarrier of table position e (point r of thread (w, lane)): the
  // tone layout's index (OFDM) or the time layout's (SC-FDMA: x H sits
  // between the spread and T2).
  auto h_tone = [&](int e) {
    const int l = e & 31, w = (e >> 5) % G, r = (e >> 5) / G;
    return SPREAD ? C::t_at(l, w, r) : C::f_at(l, w, r);
  };
  if (p.kind == kFlat || p.kind == kRician) {
    if (tid == 0) {
      const uint4 u = sdr::philox4x32_10(make_uint4(ch, 0u, 0u, 0u), p.kf0, p.kf1);
      float g1, g2;
      sdr::box_muller(u.x, u.y, g1, g2);
      if (p.kind == kFlat) {
        *flat = make_float2(g1 * 0.70710677f, g2 * 0.70710677f);
      } else {
        const uint4 v = sdr::philox4x32_10(make_uint4(ch, 0u, 0u, 1u), p.kf0, p.kf1);
        const float ph = sdr::uniform_01(v.x) * 6.2831855f;
        *flat = make_float2(p.a_los * cosf(ph) + g1 * p.s_dif, p.a_los * sinf(ph) + g2 * p.s_dif);
      }
    }
  } else if (p.kind == kTaps) {
    for (int l = tid; l < L; l += blockDim.x) {
      const uint4 u = sdr::philox4x32_10(make_uint4(ch, 0u, (uint32_t)l, 0u), p.kf0, p.kf1);
      float g1, g2;
      sdr::box_muller(u.x, u.y, g1, g2);
      tg[l] = make_float2(g1 * 0.70710677f * p.amps[l], g2 * 0.70710677f * p.amps[l]);
    }
    __syncthreads();
    for (int e = tid; e < N; e += blockDim.x) hk[e] = taps_response(tg, L, w_table(p, h_tone(e)));
  } else if (p.kind == kJakes || p.kind == kTapsSym) {
    const int rows = p.kind == kJakes ? 1 : L;
    for (int e = tid; e < rows * kJakesPaths; e += blockDim.x) {
      const int row = e / kJakesPaths, q = e - row * kJakesPaths;
      const uint4 u = sdr::philox4x32_10(
          make_uint4(ch, (uint32_t)row, (uint32_t)q, (uint32_t)kJakesLane), p.kf0, p.kf1);
      const float th = __fmul_rn(sdr::uniform_01(u.x), 6.2831855f);
      const float ph = __fmul_rn(sdr::uniform_01(u.y), 6.2831855f);
      jp[e] = make_float2(cosf(th), ph);
    }
    if (p.kind == kTapsSym) {
      for (int e = tid; e < N; e += blockDim.x) wk[e] = w_table(p, h_tone(e));
    }
  }
  __syncthreads();

  // ---- the symbols: group `group` takes s0 + group, + groups, ... ------
  const int lane = tid & 31;
  const int group = warp / G;
  const C cx{lane, warp % G, group, tw, tw3, xtw,
             (float2*)(smem + cv.xch) + (size_t)group * N};
  int16_t* sidx = (int16_t*)(smem + cv.sidx) + (size_t)group * N;
  // The points staged through shared memory at their positions: the
  // noise, the SC-FDE equaliser and the tails run as rolled loops over
  // them, which keeps the symbol loop's code small. A group of several
  // warps stages through its exchange buffer, once the exchange's last
  // readers are past a barrier (a warp alone touches only its own words).
  float2* stg = G > 1 ? cx.xch : (float2*)(smem + cv.stg) + (size_t)group * N;
  auto stage = [&](const float (&xr)[R], const float (&xi)[R], float scale) {
    if (G > 1) group_sync<G>(group);
#pragma unroll
    for (int r = 0; r < R; ++r) stg[cx.pos(r)] = make_float2(xr[r] * scale, xi[r] * scale);
  };
  float2* hw = (float2*)(smem + cv.hw) + (size_t)group * N;
  float2* wg = (float2*)(smem + cv.wg) + (size_t)warp * L;
  const float2 h_flat = (p.kind == kFlat || p.kind == kRician) ? *flat : make_float2(1.0f, 0.0f);
  const float2* hp =
      p.kind == kTaps ? hk : ((p.kind == kTapsSym || p.kind == kPlane) ? hw : nullptr);
  const uint32_t mask = (uint32_t)p.idx_mask;
  int err = 0;

  for (int s = s0 + group; s < s1; s += kWarps / G) {
    const long long row = (long long)b * p.S + s;
    // Indices into the stash. Keyed: thread (w, lane) draws the quads
    // i = w + G m of its lane's tones A*lane + 4i .. + 3; word e belongs to
    // point pos (4i + e)*32 + lane (the tone's point r*G + w = 4i + e).
    group_sync<G>(group);  // the last symbol's readers of the stash are done
    if (p.idx_in != nullptr) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        sidx[cx.pos(r)] = (int16_t)p.idx_in[(row << p.log_n) + cx.f_index(r)];
    } else {
#pragma unroll
      for (int m = 0; m < R / 4; ++m) {
        const int i = cx.w + G * m;
        const uint4 u = sdr::philox4x32_10(
            make_uint4(ch, (uint32_t)s, (uint32_t)((C::A / 4) * lane + i), 0u), kpay);
        int16_t* d = sidx + 4 * i * 32 + lane;
        d[0] = (int16_t)(u.x & mask);
        d[32] = (int16_t)(u.y & mask);
        d[64] = (int16_t)(u.z & mask);
        d[96] = (int16_t)(u.w & mask);
      }
    }
    group_sync<G>(group);

    // The symbol's channel: a scalar h0, or H at the points' positions.
    float2 h0 = h_flat;
    if (p.kind == kJakes) {
      h0 = jakes_half(jp, 0, 1, __fmul_rn(p.jakes_w, (float)s), lane);
    } else if (p.kind == kTapsSym) {
      const float ws = __fmul_rn(p.jakes_w, (float)s);
      __syncwarp();  // the last symbol's readers of wg are done
      for (int l = 0; l < L; l += 2) {
        const int mine = l + (lane >> 4);  // the halves take taps l and l + 1
        const float2 g = jakes_half(jp, mine, L, ws, lane);
        if ((lane & 15) == 0 && mine < L)
          wg[mine] = make_float2(g.x * p.amps[mine], g.y * p.amps[mine]);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < R; ++q) hw[cx.pos(q)] = taps_response(wg, L, wk[cx.pos(q)]);
    } else if (p.kind == kPlane) {
      const long long ho = ((long long)b * p.h_syms + (p.h_syms > 1 ? s : 0)) << p.log_n;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int k = SPREAD ? cx.t_index(q) : cx.f_index(q);
        hw[cx.pos(q)] = make_float2(p.h_re[ho + k], p.h_im[ho + k]);
      }
    }
    auto h_at = [&](int q) { return hp != nullptr ? hp[cx.pos(q)] : h0; };

    // TX: PAM levels, [spread], x H, inverse DFT, scale.
    float vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sdr::pam_point<M, BPSK>(sidx[cx.pos(r)], vr[r], vi[r]);
    if (SPREAD) {
      cx.template t1<false>(vr, vi);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        vr[r] *= p.spread_scale;
        vi[r] *= p.spread_scale;
        if (p.kind != kNone) cmul<false>(vr[r], vi[r], h_at(r));
      }
      cx.template t2<true>(vr, vi);
    } else {
      if (p.kind != kNone) {
#pragma unroll
        for (int r = 0; r < R; ++r) cmul<false>(vr[r], vi[r], h_at(r));
      }
      cx.template t1<true>(vr, vi);
    }

    // Channel: scale, + the noise of payload sample n (counter (ch, s, cp + n)).
    stage(vr, vi, p.tx_scale);
    if (p.noise) {
#pragma unroll 2
      for (int r = 0; r < R; ++r) {
        const int n = SPREAD ? cx.f_index(r) : cx.t_index(r);
        float g1, g2;
        if (p.n_re != nullptr) {
          g1 = p.n_re[(row << p.log_n) + n];
          g2 = p.n_im[(row << p.log_n) + n];
        } else {
          const uint4 u =
              sdr::philox4x32_10(make_uint4(ch, (uint32_t)s, (uint32_t)(p.cp + n), 0u), knoise);
          sdr::box_muller(u.x, u.y, g1, g2);
        }
        float2& x = stg[cx.pos(r)];
        x.x += p.sigma * g1;
        x.y += p.sigma * g2;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 x = stg[cx.pos(r)];
      vr[r] = x.x;
      vi[r] = x.y;
    }

    // RX: forward DFT, equalise, LLR, count.
    if (SPREAD) {
      cx.template t1<false>(vr, vi);
      // The SC-FDE equaliser: biased MMSE per tone, the bias of the symbol
      // summed in a fixed order (lanes, then the group's warps).
      stage(vr, vi, 1.0f);
      float acc = 0.0f;
#pragma unroll 2
      for (int r = 0; r < R; ++r) {
        const float2 h = h_at(r);
        float2& y = stg[cx.pos(r)];
        cmul<false>(y.x, y.y, mmse_weight(h.x, h.y, p.nv, acc));
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 y = stg[cx.pos(r)];
        vr[r] = y.x;
        vi[r] = y.y;
      }
      const float tot = group_bias_sum<G>(acc, red, warp, group, lane);
      cx.template t2<true>(vr, vi);  // the despread, unscaled
      float scale, sinr;
      despread_gain(tot, N, scale, sinr);
      stage(vr, vi, 1.0f);
#pragma unroll 2
      for (int r = 0; r < R; ++r) {
        const float2 y = stg[cx.pos(r)];
        err += sdr::scaled_bit_errors<M, BPSK>(y.x * scale, y.y * scale, sinr, tab,
                                               sidx[cx.pos(r)]);
      }
    } else {
      cx.template t2<false>(vr, vi);
      stage(vr, vi, 1.0f);
#pragma unroll 2
      for (int r = 0; r < R; ++r) {
        const float2 y = stg[cx.pos(r)];
        const float2 h = h_at(r);
        err += sdr::mmse_bit_errors<M, BPSK>(y.x, y.y, h.x, h.y, p.inv_nv, tab, sidx[cx.pos(r)]);
      }
    }
  }

  // Counts: a warp sum, one shared atomic a warp, one global atomic a block
  // (integer sums: exact in any order).
  err = __reduce_add_sync(kFull, err);
  if (lane == 0 && err) atomicAdd(cnt, err);
  __syncthreads();
  if (tid == 0 && *cnt) atomicAdd(p.out + b, *cnt);
}

template <int M, bool BPSK, bool SPREAD, int R, int G>
int launch(const McParams& p, const sdr::AxisTables& tab, cudaStream_t st) {
  const Carve cv = carve(32 * R * G, G, p.kind, p.n_taps);
  const auto kernel = mc_kernel<M, BPSK, SPREAD, R, G>;
  if (cv.total > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cv.total);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)p.B * p.n_chunks;
  kernel<<<(unsigned)blocks, sdr::kThreads, cv.total, st>>>(
      p, tab, sdr::philox_keys(p.kp0, p.kp1), sdr::philox_keys(p.kn0, p.kn1));
  return 0;
}

// N = 32 R G: one warp a symbol up to 512 points, then 2, 4 and 8.
// SC-FDMA is built at N 128-256 only (kernels/mc.py's MAX_SPREAD_N_FFT);
// its despread tail itself holds no N limit.
template <int M, bool BPSK, bool SPREAD>
int launch_n(const McParams& p, const sdr::AxisTables& tab, cudaStream_t st) {
  if constexpr (SPREAD) {
    switch (p.log_n) {
      case 7: return launch<M, BPSK, SPREAD, 4, 1>(p, tab, st);
      case 8: return launch<M, BPSK, SPREAD, 8, 1>(p, tab, st);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (p.log_n) {
      case 7: return launch<M, BPSK, SPREAD, 4, 1>(p, tab, st);
      case 8: return launch<M, BPSK, SPREAD, 8, 1>(p, tab, st);
      case 9: return launch<M, BPSK, SPREAD, 16, 1>(p, tab, st);
      case 10: return launch<M, BPSK, SPREAD, 16, 2>(p, tab, st);
      case 11: return launch<M, BPSK, SPREAD, 16, 4>(p, tab, st);
      default: return launch<M, BPSK, SPREAD, 16, 8>(p, tab, st);
    }
  }
}

template <bool SPREAD>
int launch_mod(const McParams& p, int bits_per_axis, int bpsk, const sdr::AxisTables& tab,
               cudaStream_t st) {
  SDR_DISPATCH_MOD(bits_per_axis, bpsk, return launch_n<M, BPSK, SPREAD>(p, tab, st))
  return 0;
}

}  // namespace

// The launches of one pass, OFDM (mc.cu) and SC-FDMA (mc_spread.cu).
int mc_launch_ofdm(const McParams& p, int bits_per_axis, int bpsk, const sdr::AxisTables& tab,
                   cudaStream_t st);
int mc_launch_spread(const McParams& p, int bits_per_axis, int bpsk, const sdr::AxisTables& tab,
                     cudaStream_t st);
