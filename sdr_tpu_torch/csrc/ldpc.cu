// Kernel H: QC-LDPC offset min-sum decode, every iteration in one launch.
//
// Replaces sdr_tpu/kernels/ldpc_pallas.py::ldpc_decode_pallas (lane-major Z,
// rows-major (batch, n) LLRs) and ::ldpc_decode_pallas_sublane /
// ::ldpc_decode_sublane_t (sublane-major Z, flooding and layered, rows-major
// or transposed (n, batch) LLRs). The TPU needed two kernels because Mosaic
// lowered lane rotates and sublane concatenations so differently; here the
// two layouts differ only in the strides with which a block stages its
// codeword, so one kernel serves all three entry points.
//
// A block decodes one codeword with Z threads: thread r takes lifted row r.
//   - The per-variable totals live in shared memory in variable alignment,
//     tot[j][v] (nb·Z floats); the check-aligned read of edge e (column j,
//     shift s) at row r is tot[j][(r + s) mod Z]. A block first stages its
//     codeword's LLRs there and stores its hard bits from there.
//   - The check-to-variable messages live in shared memory, c2v[e][.]
//     (E·Z floats): in variable alignment for flooding, so that the
//     totals read each message at the thread's own row and a row update
//     reads and writes it at the same rotated row as the total; in check
//     alignment for layered, where a row update reads and writes its own
//     slot and the totals are updated in place.
//   - The channel LLRs of row r of every base column stay in registers.
//   - The code's tables (per edge its shift and its total and message
//     planes; per base row its degree and first edge; per base column its
//     total plane, degree and messages), as byte offsets, are a by-value
//     __grid_constant__ kernel parameter: every thread reads the same
//     entry, from the constant bank, with an immediate address where the
//     index is known at compile time. No table read is a shared-memory
//     access in front of the data.
//
// Flooding, per iteration: every thread sums its totals in the plain
// version's order (channel first, then the column's edges in e_by_col
// order; the column loop is unrolled to kMaxColDeg predicated slots);
// barrier; each thread updates its check rows; barrier. Each row degree
// (up to kMaxRowDeg) has its own fully unrolled body. A row's rotated
// totals and messages are loaded back to back, its extrinsic inputs
// m = tot - c2v stay in registers through the min pass (min1/min2 and the
// sign bits) and the update, and each edge's new message is written once,
// in place. Layered, per base row: the same, and each thread also writes
// (new - old) back into the totals it read (no other thread touches them
// in that row); barrier. Sign transport is on the bit patterns, as in the
// sublane kernel; the float operations (adds, subtractions, min, max; no
// products, so no contraction) and their order are the plain version's,
// so the decisions are identical.
//
// Shared-memory accesses per edge per lifted row and iteration: flooding 4
// (totals: one message read; row: one rotated total read, one message read
// and write) plus nb/E total writes;
// layered 4 (one rotated total read and write, one message read and write).
// The first form of this kernel made about ten, half of them table reads,
// with dependent table lookups in front of each.
//
// Bound on the H100: arithmetic, about ten float/integer operations per edge
// per iteration (E·Z·iters per codeword), against reading n·4 bytes and
// writing n bytes per codeword; between it and that bound stand the
// shared-memory accesses above, the issue rate of ~15 instructions per
// edge-iteration, and the (E + nb)·Z·4 bytes of state per codeword that cap
// the codewords resident on an SM (five at the stock rates, Z = 128).
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kMaxNb = 32;        // base columns (channel LLRs held in registers)
constexpr int kMaxMb = 32;        // base rows
constexpr int kMaxE = 128;        // edges of the base matrix
constexpr int kMaxRowDeg = 16;    // edges of one base row (one unrolled body per degree)
constexpr int kMaxColDeg = 3;     // edges of one base column (predicated slots)
constexpr int kMaxZ = 1024;       // lifted rows (one thread each)

// One code's tables (sdr_tpu_torch/kernels/ldpc.py::code_tables writes the
// same layout). Offsets are in bytes from the start of the block's shared
// memory; a plane holds the Z lifted rows of one edge or column.
struct LdpcCode {
  int nb, mb, n_e, z;
  int2 row[kMaxMb];  // per base row: x: degree, y: first edge (edges in row order)
  int4 edge[kMaxE];  // per edge: x: s·4, y: tot[j] plane, z: c2v[e] plane, w: 0
  int2 col[kMaxNb];  // per base column: x: tot[j] plane, y: degree
  int col_edge[kMaxNb][kMaxColDeg];  // per column, e_by_col order: the c2v[e] plane
};

// Shared-memory loads and stores at 32-bit shared-window addresses: each
// rotated address is then one three-input add (base + plane + row).
__device__ __forceinline__ float lds(unsigned addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

__device__ __forceinline__ void sts(unsigned addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(x) : "memory");
}

// A thread's place: base = the shared-window address of the block's
// shared memory; own = the byte offset of its lifted row r within any
// plane (4·r); z4 = one plane's bytes (Z·4).
struct Lane {
  unsigned base, own, z4;
};

// Flooding totals of row r of every column: the channel LLR, then the
// column's messages in e_by_col order, each at the thread's own row.
__device__ __forceinline__ void totals(const LdpcCode& code, const Lane& ln,
                                       const float (&ch)[kMaxNb]) {
  const unsigned mine = ln.base + ln.own;
#pragma unroll
  for (int j = 0; j < kMaxNb; ++j) {
    if (j >= code.nb) break;
    float t = ch[j];
#pragma unroll
    for (int k = 0; k < kMaxColDeg; ++k) {
      if (k < code.col[j].y) t += lds(mine + code.col_edge[j][k]);
    }
    sts(mine + code.col[j].x, t);
  }
}

// Base row of DEG edges from edge e0: the rotated totals and the messages
// loaded back to back; the extrinsic inputs m kept in registers through the
// min pass and the update; each new message written once in place (and,
// layered, each total written back). The two candidate outputs
// max(min - beta, 0) carry the row's sign product, so an edge's message is
// one select and one sign flip.
template <bool LAYERED, int DEG>
__device__ __forceinline__ void row_update(const LdpcCode& code, const Lane& ln, int e0,
                                           float beta) {
  const unsigned crow = ln.base + ln.own + e0 * ln.z4;  // layered: the row's own slots
  float t[DEG], c_old[DEG], m[DEG];
  unsigned ti[DEG], ci[DEG];
#pragma unroll
  for (int d = 0; d < DEG; ++d) {
    const int4 te = code.edge[e0 + d];
    // Row (r + s) mod Z of a plane: own + s·4, less one plane where it wraps.
    const unsigned p = ln.own + te.x;
    const unsigned q = min(p, p - ln.z4);
    ti[d] = ln.base + te.y + q;
    ci[d] = LAYERED ? crow + d * ln.z4 : ln.base + te.z + q;
    t[d] = lds(ti[d]);
    c_old[d] = lds(ci[d]);
  }
  unsigned rsign = 0;
  float min1 = 0.0f, min2 = 3.4e38f;
#pragma unroll
  for (int d = 0; d < DEG; ++d) {
    m[d] = t[d] - c_old[d];
    const float a = fabsf(m[d]);
    const unsigned sign = __float_as_uint(m[d]) & 0x80000000u;
    if (d == 0) {
      rsign = sign;
      min1 = a;
    } else {
      rsign ^= sign;
      min2 = fminf(min2, fmaxf(min1, a));
      min1 = fminf(min1, a);
    }
  }
  // The message where |m| != min1, and where |m| == min1.
  const unsigned out1 = __float_as_uint(fmaxf(min1 - beta, 0.0f)) | rsign;
  const unsigned out2 = __float_as_uint(fmaxf(min2 - beta, 0.0f)) | rsign;
#pragma unroll
  for (int d = 0; d < DEG; ++d) {
    const unsigned pick = fabsf(m[d]) == min1 ? out2 : out1;
    const float v = __uint_as_float(pick ^ (__float_as_uint(m[d]) & 0x80000000u));
    if (LAYERED) sts(ti[d], t[d] + (v - c_old[d]));
    sts(ci[d], v);
  }
}

// One body per row degree: a loop unrolled to a fixed maximum would issue
// every predicated-off edge slot of the shorter rows.
template <bool LAYERED, int DEG>
__device__ __forceinline__ void row_update_deg(const LdpcCode& code, const Lane& ln, int2 row,
                                               float beta) {
  if constexpr (DEG <= kMaxRowDeg) {
    if (row.x == DEG) row_update<LAYERED, DEG>(code, ln, row.y, beta);
    else row_update_deg<LAYERED, DEG + 1>(code, ln, row, beta);
  }
}

template <bool LAYERED, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    ldpc_minsum_kernel(const float* __restrict__ llr, int8_t* __restrict__ out,
                       const __grid_constant__ LdpcCode code, int iters, float beta,
                       long long cw_stride, long long pos_stride) {
  extern __shared__ float4 smem4[];
  const int z = code.z, nb = code.nb;
  const int n = nb * z;
  Lane ln;
  ln.base = (unsigned)__cvta_generic_to_shared(smem4);
  ln.own = 4 * threadIdx.x;
  ln.z4 = 4 * z;
  float* const c2v = reinterpret_cast<float*>(smem4);  // [n_e][z]
  float* const tot = c2v + code.n_e * z;               // [nb][z]
  const float* const src = llr + (long long)blockIdx.x * cw_stride;
  int8_t* const dst = out + (long long)blockIdx.x * cw_stride;

  // Stage the codeword's LLRs into tot.
  for (int pos = threadIdx.x; pos < n; pos += blockDim.x) tot[pos] = src[pos * pos_stride];
  for (int i = threadIdx.x; i < code.n_e * z; i += blockDim.x) c2v[i] = 0.0f;
  __syncthreads();

  float ch[kMaxNb];
  if (!LAYERED) {
#pragma unroll
    for (int j = 0; j < kMaxNb; ++j) {
      if (j < nb) ch[j] = lds(ln.base + ln.own + code.col[j].x);
    }
  }

  for (int it = 0; it < iters; ++it) {
    if (!LAYERED) {
      totals(code, ln, ch);
      __syncthreads();
    }
    for (int i = 0; i < code.mb; ++i) {
      row_update_deg<LAYERED, 1>(code, ln, code.row[i], beta);
      if (LAYERED) __syncthreads();
    }
    if (!LAYERED) __syncthreads();
  }
  if (!LAYERED) {
    totals(code, ln, ch);
    __syncthreads();
  }

  // Hard bits from the final totals.
  for (int pos = threadIdx.x; pos < n; pos += blockDim.x)
    dst[pos * pos_stride] = (int8_t)(tot[pos] < 0.0f);
}

template <bool LAYERED, int MAXT, int MINB = 1>
int launch(const float* llr, int8_t* out, const LdpcCode& code, int iters, float beta,
           long long n_cw, long long cw_stride, long long pos_stride, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)(code.n_e + code.nb) * code.z;
  if (code.z > MAXT || smem > 232448 || n_cw > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kern = ldpc_minsum_kernel<LAYERED, MAXT, MINB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)n_cw, code.z, smem, st>>>(llr, out, code, iters, beta, cw_stride, pos_stride);
  return (int)cudaGetLastError();
}

// One codeword a block. Z <= 128 takes the form bounded to five blocks an SM
// (at most 102 registers: five codewords' state fills the shared memory at
// the stock rates), Z > 512 the wide form (up to 1024 threads).
template <bool LAYERED>
int dispatch(const float* llr, int8_t* out, const LdpcCode& code, int iters, float beta,
             long long n_cw, long long cw_stride, long long pos_stride, cudaStream_t st) {
  if (code.z <= 128)
    return launch<LAYERED, 128, 5>(llr, out, code, iters, beta, n_cw, cw_stride, pos_stride, st);
  if (code.z <= 512)
    return launch<LAYERED, 512>(llr, out, code, iters, beta, n_cw, cw_stride, pos_stride, st);
  return launch<LAYERED, kMaxZ>(llr, out, code, iters, beta, n_cw, cw_stride, pos_stride, st);
}

}  // namespace

// tables: n_ints int32 in LdpcCode's layout (host memory).
extern "C" int sdr_ldpc_minsum(const float* llr, int8_t* out, const int* tables, int n_ints,
                               int iters, float beta, int layered, long long n_cw,
                               long long cw_stride, long long pos_stride, void* stream) {
  if (n_cw == 0) return 0;
  LdpcCode code;
  if (n_ints * sizeof(int) != sizeof(LdpcCode)) return (int)cudaErrorInvalidValue;
  memcpy(&code, tables, sizeof(LdpcCode));
  if (code.nb < 1 || code.nb > kMaxNb || code.mb < 1 || code.mb > kMaxMb || code.z < 1 ||
      code.z > kMaxZ || code.n_e < 1 || code.n_e > kMaxE || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (layered)
    return dispatch<true>(llr, out, code, iters, beta, n_cw, cw_stride, pos_stride, st);
  return dispatch<false>(llr, out, code, iters, beta, n_cw, cw_stride, pos_stride, st);
}
