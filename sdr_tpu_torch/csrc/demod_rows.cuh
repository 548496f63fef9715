// Kernel C, rows layout: the warp-group form of its count (h plane or
// taps=), LLR-plane and sum modes, each also with the despread (SC-FDE)
// receive, and of its tensor-parallel stage-2 mode (the plane with the TP
// flag), at N = 128 to 4096, and the entry points of the shared-memory
// tile in demod.cu, which keeps N = 2 to 64 of every mode. demod_count.cu
// holds the count's instantiations and entry point, demod_llr.cu the
// plane's and the sum's, demod_despread_count.cu, demod_despread_llr.cu
// and demod_despread_sum.cu those of the three despread modes, and
// demod_tp.cu the TP mode's, so that nvcc builds them in parallel. The
// post-FFT mode (llr_chain) has no transform: its streaming form is
// llr_chain.cu.
//
// Replaces, at these N, sdr_tpu/kernels/demod_pallas.py::demod_count_pallas
// (the count, with taps=) and ::demod_chain_pallas (the plane and the sum),
// and at N 1024 to 4096 the four-step kernels fourstep_split_pallas.py::
// demod_chain_fourstep2 and fourstep_pallas.py::demod_chain_fourstep, which
// split the DFT into N1·N2 matmul steps because dense DFT operands outgrew
// VMEM; the TPU kernels ran their DFTs as matmuls on the MXU, here they run
// in f32 on CUDA cores, in registers and across lanes.
//
// Per OFDM symbol (one row of the (B, S, N+cp) planes): CP strip; forward
// unscaled N-point DFT; p = conj(h) y, h2 = |h|^2, s = p / max(h2, 1e-12),
// inv_eff = h2 / nv; per-axis max-log LLR (common.cuh's mmse_llrs), the
// LLRs stored in the public order out[(row·N + k)·BPS + j] or summed; the
// count takes each LLR's sign alone (common.cuh's hard_bits, as kernel
// F's count) and counts it against the indices, with the pilot comb
// (pilot > 0, not with the despread) over the data tones alone: tone k
// with k % pilot == 0 is skipped, k the natural tone index of the tail.
//
// The form. A group of G warps holds one symbol in registers, R points a
// lane, in the plans of kernel G (csrc/mc.cuh): G = 1 and R = 4, 8, 16 at
// N 128, 256, 512; R = 16 and G = 2, 4, 8 at N 1024, 2048, 4096. Point
// j·G + d of thread (w, lane) is time sample bitrev5(lane) + 32·(w + G·j)
// + 32·R·d, so a warp's 32 lanes read one permuted 128-byte run of the
// sample planes: the loads are coalesced with no shared tile and no
// bit-reversal pass. T2 (warpfft.cuh: at G > 1 one exchange through the
// group's buffer, the R-point DFTs in registers, a twiddle, five shuffle
// stages across the lanes) leaves tone A·lane + G·r + w in point r
// (A = N/32). The points then go once through the group's shared buffer,
// at (r·G + w)·SP + lane, SP = 32 + max(1, 16/A) float2 (no bank conflict
// on the write, nor on the read in natural order), and the tail takes
// tone k = 32·G·i + t of group thread t = 32·w + lane: a warp's h, index
// and plane accesses are then one contiguous run each, for every plan
// (at G = 1 a lane's own tones are contiguous and could move as vectors,
// but the stores of a warp would then be 32 runs apart), and the tail is
// one rolled loop (two tones an iteration), which keeps the build small
// (an unrolled tail costs minutes of nvcc for no gain on the card).
//
// A block takes a run of kRun symbols of one channel, its 8/G groups
// every (8/G)-th of them, so that what is the same for the run is built
// once a block: the twiddle tables; h when the plane has one row a
// channel (h_syms = 1, the AWGN and flat-fading planes), staged in
// natural order; with taps=, the table of W_N^k, from which each tone
// builds H[k] = sum_l t_l W_N^{kl} of its symbol's taps (staged per
// symbol in the warp's slot) by L complex multiply-adds. What is the
// symbol's own, the index row (count) and a per-symbol h row (h_syms = S),
// is copied into the group's shared stages by cp.async when the symbol
// starts, so that it lands while the samples load and transform and the
// tail reads it from shared memory. The index width is read at run time
// (int8, int16 or int32), not made a template. HBM reads stay in flight
// across symbols by occupancy (three blocks an SM at 4 and 8 points a
// lane, two at 16) and, at 16 points a lane, by loading the group's next
// symbol into registers while this one runs: both ways were timed at
// every N, and each plan keeps the one faster for most of its modes. The count is summed per warp,
// then per block in shared memory and added to the channel's counter by
// one integer atomic a block; the sum's per-thread order is fixed, so
// block_sum's per-block partials, added by sum_partials_kernel in a fixed
// order, give the same bits on every run.
//
// The despread (DESP, full-grid SC-FDMA's SC-FDE receive, common.cuh's
// despread_equalize and despread_for_each on the tile) runs two
// transforms a symbol and no bit-reversal pass: T2 forward as above,
// then per tone the biased MMSE conj(h) y / (|h|^2 + nv) and the symbol's
// bias b = max(mean_k |h|^2 / (|h|^2 + nv), 1e-9), then T1 inverse (the
// despread, unscaled), which takes the tone layout to the time layout;
// each point is scaled by 1/(sqrt(N) b) and its max-log LLRs taken at
// SINR b / max(1 - b, 1e-9), against the time-domain indices. With one h
// row a channel, the weights and b are the run's: the prologue builds
// them once a block (b by block_sum, in a fixed order), the weights in
// the tone layout at (r·G + w)·SP + lane, so each point is weighted in
// registers. With one row a symbol, the points go once through the
// group's stage in natural order, as the tail above: each tone is
// weighted against the staged h row in place and the group sums its
// bias partials (lanes, then its warps in a fixed order), and the points
// return in the tone layout. After T1 a thread's points are time
// samples bitrev5(lane) + 32·c: a warp's indices and plane stores cover
// one contiguous run a point, so the tail is one rolled loop over the
// thread's own points, staged at their tone-layout slots (read back by
// the thread that wrote them: no pass to natural order).
//
// The TP flag (demod_tp.cu; sdr_tpu/parallel/tp.py::_stage2_llr_pallas,
// the four-step's phase B on one rank's digit block, which ran its
// n2-point DFT as a Gauss complex matmul on the MXU) changes three things
// of the plane mode. The row map: a run's channel is the digit row
// (b, k1) of t (B, S, n1d, n2), symbol s of it row (b·S + s)·n1d + k1
// with no CP, its h row (b·h_syms + (h_syms > 1 ? s : 0))·n1d + k1, and
// the grid B·n1d·⌈S/32⌉ blocks. The noise variance: 1/max(nv, 1e-12) from
// the one f32 on the device, read once by each thread, so no host sync.
// The store: the plane's, row by row in the public order [k·BPS + j].
//
// Bound on the H100: the bytes, 8 a sample read (S·N rows: the CP is
// skipped), the h plane, the indices, and 4·BPS a tone written by the
// plane; the transform (5·N·log2 N f32 operations a symbol) and the tail
// are the compute side, and with the shuffles and the shared passes they
// keep the form under the byte bound. The despread adds a second
// transform and keeps the same bytes.
#pragma once
#include "common.cuh"
#include "warpfft.cuh"

// The shared-memory tile (demod.cu): kernel C's form at N = 2 to 64, the
// despread and TP modes included. Arguments as the extern "C" entry points.
int demod_count_tile(const float* re, const float* im, const float* hr, const float* hi,
                     int h_syms, const float* taps_r, const float* taps_i, int n_taps,
                     const void* idx, int idx_bytes, int32_t* out, int B, int S, int log_n,
                     int cp, int bits_per_axis, int bpsk, const sdr::AxisTables& tab,
                     float inv_nv, float nv, int despread, int pilot, const float* twr,
                     const float* twi, cudaStream_t st);
int demod_llr_tile(const float* re, const float* im, const float* hr, const float* hi,
                   int h_syms, float* out, float* partials, int B, int S, int log_n, int cp,
                   int bits_per_axis, int bpsk, const sdr::AxisTables& tab, float inv_nv,
                   float nv, int despread, int reduce_sum, const float* twr, const float* twi,
                   cudaStream_t st);
int demod_llr_tile_partials(int B, int S, int log_n);
int demod_tp_tile(const float* tr, const float* ti, const float* hr, const float* hi, int h_syms,
                  const float* nv, float* out, int B, int S, int n1d, int log_n,
                  int bits_per_axis, int bpsk, const sdr::AxisTables& tab, const float* twr,
                  const float* twi, cudaStream_t st);

// One launch of the warp-group form, by value. At namespace scope, so
// that the functions that take it keep external linkage.
struct RowsArgs {
  const float* re;      // (B, S, N+cp) sample planes
  const float* im;
  const float* hr;      // (B, h_syms, N), or null with taps
  const float* hi;
  const float* taps_r;  // (B, S, L) per-symbol taps, or null
  const float* taps_i;
  const void* idx;      // (B, S, N) int8 / int16 / int32 indices (count)
  void* out;            // (B,) int32 counts, the (B, S, N·BPS) plane, or the partials
  float* sum;           // the sum's one float (sum mode)
  const float* twr;     // forward twiddles e^{-2 pi i k/N}, k < N/2
  const float* twi;
  int B, S, log_n, cp, h_syms, n_taps, idx_bytes;
  float inv_nv;
  float nv;  // the despread's MMSE noise variance (clamped at 1e-12)
  int n1d;             // TP: digit rows a symbol (1 otherwise)
  const float* nv_dev;  // TP: the noise variance, one f32 on the device
  int pilot;            // count: skip tones k with k % pilot == 0 (the comb); 0 off
  float pilot_inv;      // 1/pilot (sdr::on_comb)
};

// N = 32 R G from 2^kRowsMinLog: below it the tile (demod.cu) runs.
constexpr int kRowsMinLog = 7;
using sdr::kRun;

// The despread modes of the warp-group form (demod_despread_count.cu,
// demod_despread_llr.cu, demod_despread_sum.cu); the caller has checked
// the shape (rows_bad_shape, no taps).
int demod_despread_count(const RowsArgs& a, const sdr::AxisTables& tab, int bits_per_axis,
                         int bpsk, cudaStream_t st);
int demod_despread_plane(const RowsArgs& a, const sdr::AxisTables& tab, int bits_per_axis,
                         int bpsk, cudaStream_t st);
int demod_despread_sum(const RowsArgs& a, const sdr::AxisTables& tab, int bits_per_axis,
                       int bpsk, cudaStream_t st);

// Blocks of a launch over `runs` channels (B, or B·n1d with TP) of S
// symbols; the sum's per-block partials, one a block.
inline long long rows_blocks(long long runs, int S) { return runs * ((S + kRun - 1) / kRun); }

namespace {

constexpr int kMaxTaps = 8;
constexpr int kRowsWarps = sdr::kThreads / 32;
enum : int { kCount = 0, kPlane = 1, kSum = 2 };

// Byte offsets of the block's shared buffers, the same on the host (its
// size) and the device (its carving).
struct RowsCarve {
  int tw;   // N float2: W_N^{bitrev5(lane) (w + G r)} (warpfft.cuh)
  int tw3;  // 32G float2 (G > 1)
  int xtw;  // 5 x 32 float2
  int stg;  // per group A·SP float2: the exchange (G > 1), then the points for the tail
  int hw;   // N float2, natural order: h (h_syms = 1) or W_N^k (taps=); with
            // the despread A·SP float2, the MMSE weights in the tone layout
  int hs;   // per group 2N floats: the symbol's h rows, re then im (h_syms = S)
  int ix;   // per group N indices of idx_bytes each: the symbol's index row (count)
  int wg;   // per warp kMaxTaps float2: the symbol's taps
  int red;  // kRowsWarps floats (block_sum), then the block's count
  int bz;   // despread: kRowsWarps floats (per-warp bias partials), then the
            // block's bias sum (one h row a channel)
  int total;
};

__host__ __device__ inline int rows_take(int& off, int bytes) {
  const int o = off;
  off += (bytes + 15) & ~15;
  return o;
}

// What a launch stages: h or W_N^k once a block (table; the despread's
// weights in the tone layout), h rows per symbol (h_syms = S without
// taps), index rows of ix_bytes (count; else 0).
__host__ __device__ inline RowsCarve rows_carve(int R, int G, const RowsArgs& a, int ix_bytes,
                                                bool desp) {
  const int N = 32 * R * G, A = R * G, groups = kRowsWarps / G;
  const bool table = a.n_taps > 0 || a.h_syms == 1;
  RowsCarve c;
  int off = 0;
  c.tw = rows_take(off, 8 * N);
  c.tw3 = rows_take(off, G > 1 ? 8 * 32 * G : 0);
  c.xtw = rows_take(off, 8 * 5 * 32);
  c.stg = rows_take(off, 8 * A * sdr::stage_stride(A) * groups);
  c.hw = rows_take(off, table ? 8 * (desp ? A * sdr::stage_stride(A) : N) : 0);
  c.hs = rows_take(off, table ? 0 : 8 * N * groups);
  c.ix = rows_take(off, ix_bytes * N * groups);
  c.wg = rows_take(off, 8 * kMaxTaps * kRowsWarps);
  c.red = rows_take(off, 4 * kRowsWarps + 4);
  c.bz = rows_take(off, desp ? 4 * kRowsWarps + 4 : 0);
  c.total = off;
  return c;
}

template <int M, bool BPSK, int MODE, int R, int G, bool DESP, bool TP>
__global__ void __launch_bounds__(sdr::kThreads, R <= 8 ? 3 : 2)
    demod_rows_kernel(RowsArgs a, sdr::AxisTables tab) {
  static_assert(!TP || (MODE == kPlane && !DESP), "the TP mode stores the plane");
  using C = sdr::Ctx<R, G>;
  // At 16 points a lane (two blocks an SM) a group loads its next symbol
  // into registers while this one runs; at 4 and 8 (three blocks an SM,
  // more groups in flight) it loads each symbol as it starts it. Both were
  // timed at every N; each plan keeps the one faster for most of its modes.
  constexpr bool PF = R == 16;
  constexpr int N = C::N, A = C::A, SP = sdr::stage_stride(A), kGroups = kRowsWarps / G;
  constexpr int BPS = BPSK ? 1 : 2 * M;
  extern __shared__ __align__(16) unsigned char rows_smem[];
  unsigned char* smem = rows_smem;
  const int L = a.n_taps;
  const bool per_sym_h = L == 0 && a.h_syms > 1;
  const int ix_bytes = MODE == kCount ? a.idx_bytes : 0;
  const RowsCarve cv = rows_carve(R, G, a, ix_bytes, DESP);
  float2* tw = (float2*)(smem + cv.tw);
  float2* tw3 = (float2*)(smem + cv.tw3);
  float2* xtw = (float2*)(smem + cv.xtw);
  float2* hw = (float2*)(smem + cv.hw);
  float* red = (float*)(smem + cv.red);
  int* cnt = (int*)(red + kRowsWarps);
  float* bz = (float*)(smem + cv.bz);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, group = warp / G;
  // The run's channel: b, or with TP the digit row (b, k1); symbol s of
  // it is row (b·S + s)·n1d + k1 of the planes.
  const int n_chunks = (a.S + kRun - 1) / kRun;
  const int ch = blockIdx.x / n_chunks;
  const int n1d = TP ? a.n1d : 1;
  const int b = TP ? ch / n1d : ch;
  const int k1 = TP ? ch - b * n1d : 0;
  const int s0 = (blockIdx.x - ch * n_chunks) * kRun;
  const int s1 = min(a.S, s0 + kRun);
  const float inv_nv = TP ? 1.0f / fmaxf(__ldg(a.nv_dev), 1e-12f) : a.inv_nv;

  // ---- what the run shares: twiddles, then h or W_N^k in natural order,
  // or the despread's MMSE weights in the tone layout and the bias sum ---
  sdr::build_tables<R, G>(tw, tw3, xtw, a.twr, a.twi, a.log_n);
  if (L > 0) {
    for (int k = tid; k < N; k += blockDim.x) hw[k] = sdr::w_table(a.twr, a.twi, a.log_n, k);
  } else if (a.h_syms == 1) {
    const long long ho = ((long long)b * n1d + k1) * N;
    float g = 0.0f;
    for (int k = tid; k < N; k += blockDim.x) {
      const float h_r = __ldg(a.hr + ho + k), h_i = __ldg(a.hi + ho + k);
      if constexpr (DESP) {
        hw[(k % A) * SP + k / A] = sdr::mmse_weight(h_r, h_i, a.nv, g);
      } else {
        hw[k] = make_float2(h_r, h_i);
      }
    }
    if constexpr (DESP) {
      g = sdr::block_sum(g, red);
      if (tid == 0) bz[kRowsWarps] = g;
    }
  }
  if (MODE == kCount && tid == 0) *cnt = 0;
  __syncthreads();

  float2* stg = (float2*)(smem + cv.stg) + (size_t)group * A * SP;
  float* hsr = (float*)(smem + cv.hs) + (size_t)group * 2 * N;
  float* hsi = hsr + N;
  unsigned char* ix = smem + cv.ix + (size_t)group * ix_bytes * N;
  float2* wg = (float2*)(smem + cv.wg) + (size_t)warp * kMaxTaps;
  const float norm = 1.0f / tab.inorm;
  float d_scale = 0.0f, d_sinr = 0.0f;
  if (DESP && !per_sym_h) sdr::despread_gain(bz[kRowsWarps], N, d_scale, d_sinr);
  // Time layout: point j·G + d of symbol s <- sample bitrev5(lane) +
  // 32(w + G j) + 32 R d of its row.
  auto load = [&](int s, int ln, int w, float(&xr)[R], float(&xi)[R]) {
    const long long o = (((long long)b * a.S + s) * n1d + k1) * (N + a.cp) + a.cp +
                        sdr::brev5(ln) + 32 * w;
#pragma unroll
    for (int j = 0; j < R / G; ++j) {
#pragma unroll
      for (int d = 0; d < G; ++d) {
        xr[j * G + d] = __ldg(a.re + o + 32 * (G * j + R * d));
        xi[j * G + d] = __ldg(a.im + o + 32 * (G * j + R * d));
      }
    }
  };
  float nr[R], ni[R];  // PF: the group's next symbol
  if (PF && s0 + group < s1) load(s0 + group, lane, warp % G, nr, ni);
  int err = 0;
  float acc = 0.0f;
  for (int s = s0 + group; s < s1; s += kGroups) {
    const int ln = sdr::opaque(lane), w = sdr::opaque(warp % G);
    const C cx{ln, w, group, tw, tw3, xtw, stg};
    const long long row = ((long long)b * a.S + s) * n1d + k1;
    const long long e0 = row << a.log_n;
    const int t = 32 * w + ln;
    // The symbol's index row and h rows, copied into the group's stages
    // while its samples load and transform (the last tail's readers of
    // those stages done first).
    if (MODE == kCount || per_sym_h) {
      sdr::group_sync<G>(group);
      if (MODE == kCount)
        sdr::copy_async(ix, static_cast<const char*>(a.idx) + e0 * ix_bytes, N * ix_bytes, t,
                        32 * G);
      if (per_sym_h) {
        const long long h0 = (((long long)b * a.h_syms + s) * n1d + k1) << a.log_n;
        sdr::copy_async(hsr, a.hr + h0, 4 * N, t, 32 * G);
        sdr::copy_async(hsi, a.hi + h0, 4 * N, t, 32 * G);
      }
    }
    float vr[R], vi[R];
    if (PF) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        vr[r] = nr[r];
        vi[r] = ni[r];
      }
      if (s + kGroups < s1) load(s + kGroups, ln, w, nr, ni);
    } else {
      load(s, ln, w, vr, vi);
    }
    cx.template t2<false>(vr, vi);

    if constexpr (DESP) {
      float scale = d_scale, sinr = d_sinr;
      if (!per_sym_h) {
        // The run's weights, staged in the tone layout.
#pragma unroll
        for (int r = 0; r < R; ++r) sdr::cmul<false>(vr[r], vi[r], hw[(r * G + w) * SP + ln]);
      } else {
        // Through the stage in natural order: each tone weighted in place
        // against the symbol's h row, the bias partials summed.
        sdr::group_sync<G>(group);  // the exchange's and the last tail's readers are done
#pragma unroll
        for (int r = 0; r < R; ++r) stg[(r * G + w) * SP + ln] = make_float2(vr[r], vi[r]);
        sdr::cp_async_wait_all();
        sdr::group_sync<G>(group);
        float g = 0.0f;
#pragma unroll 2
        for (int i = 0; i < R; ++i) {
          const int k = 32 * G * i + t;
          float2& y = stg[(k % A) * SP + k / A];
          sdr::cmul<false>(y.x, y.y, sdr::mmse_weight(hsr[k], hsi[k], a.nv, g));
        }
        g = sdr::group_bias_sum<G>(g, bz, warp, group, ln);
        sdr::despread_gain(g, N, scale, sinr);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 y = stg[(r * G + w) * SP + ln];
          vr[r] = y.x;
          vi[r] = y.y;
        }
      }
      cx.template t1<true>(vr, vi);  // the despread, unscaled: the time layout
      if (MODE == kCount && !per_sym_h) sdr::cp_async_wait_all();
      sdr::group_sync<G>(group);  // T1's exchange read; the index row landed
#pragma unroll
      for (int r = 0; r < R; ++r)
        stg[(r * G + w) * SP + ln] = make_float2(vr[r] * scale, vi[r] * scale);
      // The tail over the thread's own points, time sample n of point r.
#pragma unroll 2
      for (int r = 0; r < R; ++r) {
        const float2 y = stg[(r * G + w) * SP + ln];
        const int n = C::t_at(ln, w, r);
        if constexpr (MODE == kCount) {
          const int bits = sdr::hard_bits<M, BPSK>(y.x, y.y, 1.0f, 0.0f, norm);
          const int v = sdr::staged_index(ix, ix_bytes, n);
          err += __popc((unsigned)((bits ^ v) & ((1 << BPS) - 1)));
        } else {
          float llr[BPS];
          sdr::scaled_llrs<M, BPSK>(y.x, y.y, sinr, tab, llr);
          if constexpr (MODE == kSum) {
#pragma unroll
            for (int j = 0; j < BPS; ++j) acc += llr[j];
          } else {
            sdr::store_run<BPS>(static_cast<float*>(a.out) + (e0 + n) * BPS, llr);
          }
        }
      }
      continue;
    }

    // The points at their stage rows, the symbol's taps in the warp's slot.
    sdr::group_sync<G>(group);  // the exchange's and the last tail's readers are done
#pragma unroll
    for (int r = 0; r < R; ++r) stg[(r * G + w) * SP + ln] = make_float2(vr[r], vi[r]);
    if (ln < L) {
      const long long t0 = row * L + ln;
      wg[ln] = make_float2(__ldg(a.taps_r + t0), __ldg(a.taps_i + t0));
    }
    if (MODE == kCount || per_sym_h) sdr::cp_async_wait_all();
    sdr::group_sync<G>(group);

    // The tail, tone k = 32 G i + t in natural order.
#pragma unroll 2
    for (int i = 0; i < R; ++i) {
      const int k = 32 * G * i + t;
      const float2 y = stg[(k % A) * SP + k / A];
      float2 h;
      if (L > 0)
        h = sdr::taps_response(wg, L, hw[k]);
      else if (a.h_syms == 1)
        h = hw[k];
      else
        h = make_float2(hsr[k], hsi[k]);
      if constexpr (MODE == kCount) {
        const int bits = sdr::hard_bits<M, BPSK>(y.x, y.y, h.x, h.y, norm);
        const int v = sdr::staged_index(ix, ix_bytes, k);
        // k is the natural tone index: the comb's tones carry no payload.
        if (!a.pilot || !sdr::on_comb(k, a.pilot, a.pilot_inv))
          err += __popc((unsigned)((bits ^ v) & ((1 << BPS) - 1)));
      } else {
        float llr[BPS];
        sdr::mmse_llrs<M, BPSK>(y.x, y.y, h.x, h.y, inv_nv, tab, llr);
        if constexpr (MODE == kSum) {
#pragma unroll
          for (int j = 0; j < BPS; ++j) acc += llr[j];
        } else {
          sdr::store_run<BPS>(static_cast<float*>(a.out) + (e0 + k) * BPS, llr);
        }
      }
    }
  }

  if constexpr (MODE == kCount) {
    // A warp sum, one shared atomic a warp, one global atomic a block
    // (integer sums: exact in any order).
    err = __reduce_add_sync(sdr::kFull, err);
    if (lane == 0 && err) atomicAdd(cnt, err);
    __syncthreads();
    if (tid == 0 && *cnt) atomicAdd(static_cast<int32_t*>(a.out) + b, *cnt);
  } else if constexpr (MODE == kSum) {
    const float v = sdr::block_sum(acc, red);
    if (tid == 0) static_cast<float*>(a.out)[blockIdx.x] = v;
  }
}

template <int M, bool BPSK, int MODE, bool DESP, bool TP, int R, int G>
int rows_launch(const RowsArgs& a, const sdr::AxisTables& tab, cudaStream_t st) {
  const RowsCarve cv = rows_carve(R, G, a, MODE == kCount ? a.idx_bytes : 0, DESP);
  const auto kernel = demod_rows_kernel<M, BPSK, MODE, R, G, DESP, TP>;
  if (cv.total > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cv.total);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = rows_blocks(TP ? (long long)a.B * a.n1d : a.B, a.S);
  kernel<<<(unsigned)blocks, sdr::kThreads, cv.total, st>>>(a, tab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || MODE != kSum) return (int)err;
  sdr::sum_partials_kernel<<<1, 1024, 0, st>>>(static_cast<const float*>(a.out), (int)blocks,
                                               a.sum);
  return (int)cudaGetLastError();
}

// The plan of N = 2^log_n, 128 to 4096: one warp a symbol to N 512, then
// 2, 4 and 8.
template <int M, bool BPSK, int MODE, bool DESP = false, bool TP = false>
int rows_launch_n(const RowsArgs& a, const sdr::AxisTables& tab, cudaStream_t st) {
  switch (a.log_n) {
    case 7: return rows_launch<M, BPSK, MODE, DESP, TP, 4, 1>(a, tab, st);
    case 8: return rows_launch<M, BPSK, MODE, DESP, TP, 8, 1>(a, tab, st);
    case 9: return rows_launch<M, BPSK, MODE, DESP, TP, 16, 1>(a, tab, st);
    case 10: return rows_launch<M, BPSK, MODE, DESP, TP, 16, 2>(a, tab, st);
    case 11: return rows_launch<M, BPSK, MODE, DESP, TP, 16, 4>(a, tab, st);
    case 12: return rows_launch<M, BPSK, MODE, DESP, TP, 16, 8>(a, tab, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shapes the warp-group form refuses (the wrapper checks them first).
inline bool rows_bad_shape(const RowsArgs& a) {
  return a.log_n < kRowsMinLog || a.log_n > 12 || a.h_syms < 0 || a.n_taps < 0 ||
         a.n_taps > kMaxTaps || (a.n_taps == 0 && a.h_syms != 1 && a.h_syms != a.S) ||
         a.n1d < 1 || rows_blocks((long long)a.B * a.n1d, a.S) > 0x7FFFFFFFLL;
}

}  // namespace
