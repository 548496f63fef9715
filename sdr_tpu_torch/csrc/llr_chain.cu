// Kernel C's post-FFT mode, the streaming form (sdr_llr_chain,
// sdr_llr_chain_partials). Replaces sdr_tpu/kernels/llr_pallas.py::
// llr_chain_pallas, the hybrid route's equalise + LLR kernel: the
// frequency-domain grid y (B, S, N) comes in transformed, and each tone
// runs C's one-tap tail against h (B, 1 | S, N) — s = conj(h) y /
// max(|h|^2, 1e-12), max-log LLRs scaled by |h|^2 / nv (common.cuh's
// one_tap_llrs, the float operations of mmse_llrs) — storing its BPS LLRs
// in the public order out[(row·N + k)·BPS + j], or (SUM) adding them to
// the thread's sum. y is two planes (yr, yi), or one interleaved complex64
// plane (yi null: re, im of tone e at 2e, 2e + 1), which the hybrid route
// passes as torch.view_as_real of its FFT's output, uncopied.
//
// Bound on the H100: the bytes, 8 a tone of y read, the h plane, and
// 4·BPS a tone written by the plane. There is no transform; the tail is
// about 84 f32 operations a tone at 64-QAM (the Gray fold), so counted in
// instructions the sum sits close to its byte bound, and the plane's
// stores hide the tail.
//
// The form. A block of 256 threads takes a run of symbols of one channel
// (and, where a row is wider than the block's 1024 tones, one 1024-tone
// slice of those rows): b comes from the block index, so no division by S
// remains per tone. Each thread owns V = 4 consecutive tones of a row (2
// at N = 2) at the same k in every symbol of the run, so with one h row a
// channel (h_syms = 1) it loads its h once and builds |h|^2, 1/max(|h|^2,
// 1e-12) and |h|^2/nv once (one_tap), where the earlier grid-stride form
// reloaded and rebuilt them every tone; with h_syms = S it reads h per
// symbol, as its bytes demand. y arrives as 16-byte vectors (one a plane,
// or two of the interleaved plane for 4 tones), and the loads in flight
// are those of the other warps: occupancy keeps enough bytes moving.
// Loading a thread's next symbol into registers while this one ran was
// timed against that: it lost the sums (but the one with h per symbol)
// and tied the planes, so it went. The plane's LLRs go through a per-warp
// shared stage, so that a warp writes its 32·V tones' 4·V·BPS floats as
// consecutive 16-byte units (a thread's own 16·BPS-byte run, stored
// directly, left the warp's stores strided, and the plane ran slower than
// the grid-stride form this one replaced). The sum: each thread adds its LLRs in a fixed
// order, block_sum writes partials[block] in a fixed order, and
// sum_partials_kernel adds those: a shape gives the same bits on every
// run, in either y layout.
#include "common.cuh"

namespace {

constexpr int kChainRun = 32;  // symbols of one channel a block, at least

// The grid of a shape: V tones a thread, rows of the block's row_threads
// threads (N/V, at most 256), rpp rows a pass of the block, `cols` tone
// slices of a row, runs of `rs` symbols (a multiple of rpp).
struct ChainPlan {
  int v, log_row_threads, rpp, cols, rs, runs;
  long long blocks;
};

ChainPlan chain_plan(int B, int S, int log_n) {
  ChainPlan p;
  p.v = log_n >= 2 ? 4 : 2;
  const int vecs = (1 << log_n) / p.v;
  const int row_threads = vecs < sdr::kThreads ? vecs : sdr::kThreads;
  p.log_row_threads = __builtin_ctz(row_threads);
  p.rpp = sdr::kThreads / row_threads;
  p.cols = vecs / row_threads;
  p.rs = p.rpp > kChainRun ? p.rpp : kChainRun;
  p.runs = (S + p.rs - 1) / p.rs;
  p.blocks = (long long)B * p.runs * p.cols;
  return p;
}

struct ChainArgs {
  const float* yr;  // (B, S, N), or the interleaved (B, S, N, 2) plane
  const float* yi;  // (B, S, N), or null
  const float* hr;  // (B, h_syms, N)
  const float* hi;
  float* out;       // the (B, S, N·BPS) plane, or the partials
  int S, log_n, h_syms;
  float inv_nv;
  ChainPlan p;
};

// y of V consecutive tones from tone e: V floats a plane, or 2V
// interleaved.
template <int V, bool IL>
__device__ __forceinline__ void load_y(const ChainArgs& a, long long e, float (&yr)[V],
                                       float (&yi)[V]) {
  if constexpr (IL) {
    const float4* q = reinterpret_cast<const float4*>(a.yr + 2 * e);
#pragma unroll
    for (int u = 0; u < V / 2; ++u) {
      const float4 w = __ldg(q + u);
      yr[2 * u] = w.x;
      yi[2 * u] = w.y;
      yr[2 * u + 1] = w.z;
      yi[2 * u + 1] = w.w;
    }
  } else if constexpr (V == 4) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(a.yr + e));
    const float4 i = __ldg(reinterpret_cast<const float4*>(a.yi + e));
    yr[0] = r.x, yr[1] = r.y, yr[2] = r.z, yr[3] = r.w;
    yi[0] = i.x, yi[1] = i.y, yi[2] = i.z, yi[3] = i.w;
  } else {
    const float2 r = __ldg(reinterpret_cast<const float2*>(a.yr + e));
    const float2 i = __ldg(reinterpret_cast<const float2*>(a.yi + e));
    yr[0] = r.x, yr[1] = r.y;
    yi[0] = i.x, yi[1] = i.y;
  }
}

// V consecutive floats of an h plane from offset o.
template <int V>
__device__ __forceinline__ void load_h(const float* __restrict__ p, long long o, float (&h)[V]) {
  if constexpr (V == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p + o));
    h[0] = w.x, h[1] = w.y, h[2] = w.z, h[3] = w.w;
  } else {
    const float2 w = __ldg(reinterpret_cast<const float2*>(p + o));
    h[0] = w.x, h[1] = w.y;
  }
}

template <int M, bool BPSK, bool SUM, int V, bool IL>
__global__ void __launch_bounds__(sdr::kThreads) llr_chain_kernel(ChainArgs a,
                                                                  sdr::AxisTables tab) {
  constexpr int BPS = BPSK ? 1 : 2 * M;
  __shared__ float red[sdr::kThreads / 32];
  const ChainPlan& p = a.p;
  // Block (b, run, col); thread (row r_off of the pass, vector vec).
  const int col = blockIdx.x % p.cols;
  const int br = blockIdx.x / p.cols;
  const int b = br / p.runs;
  const int s_begin = (br - b * p.runs) * p.rs;
  const int s_end = min(a.S, s_begin + p.rs);
  const int tid = threadIdx.x;
  const int vec = tid & ((1 << p.log_row_threads) - 1);
  const int k = ((col << p.log_row_threads) + vec) * V;
  const bool per_sym_h = a.h_syms > 1;

  sdr::OneTap g[V];
  if (!per_sym_h) {
    float h_r[V], h_i[V];
    const long long ho = ((long long)b << a.log_n) + k;
    load_h<V>(a.hr, ho, h_r);
    load_h<V>(a.hi, ho, h_i);
#pragma unroll
    for (int j = 0; j < V; ++j) g[j] = sdr::one_tap(h_r[j], h_i[j], a.inv_nv);
  }
  // The LLRs of a warp's 32·V tones, which are consecutive in the plane
  // (one row, or whole consecutive rows at N < 128), staged so that the
  // warp stores them as consecutive 16-byte units: unit u of the warp's
  // run at slot u ^ ((u >> 3) & 7), which spreads a lane's BPS units over
  // the banks (V = 4; at N = 2 each thread stores its own run).
  constexpr bool STAGE = !SUM && V == 4;
  __shared__ float4 stage[STAGE ? sdr::kThreads * BPS : 1];
  const int lane = tid & 31, warp = tid >> 5;
  auto slot = [](int u) { return u ^ ((u >> 3) & 7); };
  // Symbol of thread t's row in pass i.
  auto sym = [&](int t, int i) { return s_begin + (t >> p.log_row_threads) + i * p.rpp; };

  float acc = 0.0f;
  // Every thread of the block runs the same passes (a warp stores together).
  const int passes = (s_end - s_begin + p.rpp - 1) / p.rpp;
  for (int i = 0; i < passes; ++i) {
    const int s = sym(tid, i);
    const bool valid = s < s_end;
    const long long e = (((long long)b * a.S + s) << a.log_n) + k;  // the thread's first tone
    float llr[V * BPS];
    if (valid) {
      float yr[V], yi[V];
      load_y<V, IL>(a, e, yr, yi);
      if (per_sym_h) {  // the symbol's h row
        float h_r[V], h_i[V];
        load_h<V>(a.hr, e, h_r);
        load_h<V>(a.hi, e, h_i);
#pragma unroll
        for (int j = 0; j < V; ++j) g[j] = sdr::one_tap(h_r[j], h_i[j], a.inv_nv);
      }
#pragma unroll
      for (int j = 0; j < V; ++j)
        sdr::one_tap_llrs<M, BPSK>(yr[j], yi[j], g[j], tab, llr + j * BPS);
    }
    if constexpr (SUM) {
      if (valid) {
#pragma unroll
        for (int j = 0; j < V * BPS; ++j) acc += llr[j];
      }
    } else if constexpr (STAGE) {
      float4* st = stage + warp * 32 * BPS;
#pragma unroll
      for (int q = 0; q < BPS; ++q)
        st[slot(lane * BPS + q)] =
            make_float4(llr[4 * q], llr[4 * q + 1], llr[4 * q + 2], llr[4 * q + 3]);
      __syncwarp();
      // Lane 0's run starts the warp's; unit u belongs to lane u / BPS.
      float4* dst = reinterpret_cast<float4*>(a.out + (e - 4 * lane) * BPS);
#pragma unroll
      for (int q = 0; q < BPS; ++q) {
        const int u = q * 32 + lane;
        if (sym(warp * 32 + u / BPS, i) < s_end) dst[u] = st[slot(u)];
      }
      __syncwarp();
    } else if (valid) {
      sdr::store_run<V * BPS>(a.out + e * BPS, llr);
    }
  }
  if constexpr (SUM) {
    const float v = sdr::block_sum(acc, red);
    if (tid == 0) a.out[blockIdx.x] = v;
  }
}

template <int M, bool BPSK, bool SUM>
int launch_chain(const ChainArgs& a, const sdr::AxisTables& tab, float* sum, cudaStream_t st) {
  const unsigned blocks = (unsigned)a.p.blocks;
  const bool il = a.yi == nullptr;
  if (a.p.v == 4) {
    if (il) llr_chain_kernel<M, BPSK, SUM, 4, true><<<blocks, sdr::kThreads, 0, st>>>(a, tab);
    else llr_chain_kernel<M, BPSK, SUM, 4, false><<<blocks, sdr::kThreads, 0, st>>>(a, tab);
  } else {
    if (il) llr_chain_kernel<M, BPSK, SUM, 2, true><<<blocks, sdr::kThreads, 0, st>>>(a, tab);
    else llr_chain_kernel<M, BPSK, SUM, 2, false><<<blocks, sdr::kThreads, 0, st>>>(a, tab);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !SUM) return (int)err;
  sdr::sum_partials_kernel<<<1, 1024, 0, st>>>(a.out, (int)a.p.blocks, sum);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of per-block partials the post-FFT sum's wrapper must allocate:
// the streaming form's block count.
extern "C" int sdr_llr_chain_partials(int B, int S, int log_n) {
  return (int)chain_plan(B, S, log_n).blocks;
}

// yr/yi (B, S, N) planes, or yr the interleaved (B, S, N, 2) plane and yi
// null; every y, h and plane pointer 16-byte aligned (8 at N = 2).
extern "C" int sdr_llr_chain(const float* yr, const float* yi, const float* hr, const float* hi,
                             int h_syms, float* out, float* partials, int B, int S, int log_n,
                             int bits_per_axis, int bpsk, sdr::AxisTables tab, float inv_nv,
                             int reduce_sum, void* stream) {
  if (B <= 0 || S <= 0 || log_n < 1 || log_n > 30 || (h_syms != 1 && h_syms != S))
    return (int)cudaErrorInvalidValue;
  const ChainPlan p = chain_plan(B, S, log_n);
  if (p.blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const ChainArgs a{yr, yi, hr, hi, reduce_sum ? partials : out, S, log_n, h_syms, inv_nv, p};
  cudaStream_t st = (cudaStream_t)stream;
  SDR_DISPATCH_MOD(bits_per_axis, bpsk,
    if (reduce_sum) return launch_chain<M, BPSK, true>(a, tab, out, st);
    return launch_chain<M, BPSK, false>(a, tab, out, st))
  return (int)cudaErrorInvalidValue;
}
