// Kernel H: QC-LDPC offset min-sum decode, every iteration in one launch.
//
// Replaces sdr_tpu/kernels/ldpc_pallas.py::ldpc_decode_pallas (lane-major Z,
// rows-major (batch, n) LLRs) and ::ldpc_decode_pallas_sublane /
// ::ldpc_decode_sublane_t (sublane-major Z, flooding and layered, rows-major
// or transposed (n, batch) LLRs). The TPU needed two kernels because Mosaic
// lowered lane rotates and sublane concatenations so differently; here the
// two layouts differ only in strides (cw_stride, pos_stride), so one kernel
// serves all three entry points.
//
// One block decodes one codeword with one thread per lifted row r < Z:
//   - the check-to-variable messages of every edge live in shared memory in
//     CHECK alignment, c2v[e][r] (E*Z floats); thread r owns column r;
//   - the per-variable totals live in shared memory in variable alignment,
//     tot[j][v] (nb*Z floats); the check-aligned read of column j at row r is
//     tot[j][(r + s) mod Z];
//   - the channel LLRs of position r of every base column stay in registers.
// The base matrix is taken at run time: its edge tables (int32, built by the
// wrapper) are copied into shared memory at block start.
//
// Flooding, per iteration: every thread sums its totals in the plain
// version's order (channel first, then the column's edges in e_by_col order,
// each read at its check-aligned row (v - s) mod Z); barrier; each thread
// updates its check rows (min1/min2 and the sign product in one pass,
// the self-excluded offset minimum in a second); barrier. Layered, per base
// row: each thread reads its check-aligned totals, updates the row, and adds
// (new - old) message back into the totals it read (no other thread touches
// them in that row); barrier. Sign transport is on the bit patterns, as in
// the sublane kernel; the float operations (adds, subtractions, min, max; no
// products, so no contraction) and their order are the plain version's, so
// the decisions are identical.
//
// Bound on the H100: arithmetic, about ten float/integer operations per edge
// per iteration (E*Z*iters per codeword), against reading n*4 bytes and
// writing n bytes per codeword; in this first form the shared-memory traffic
// (four accesses per edge per iteration) and one block of Z threads per
// 45 KB of state (four blocks per SM at the stock rates) stand between it and
// that bound.
#include "common.cuh"

namespace {

constexpr int kMaxNb = 32;  // base columns held in registers

template <bool LAYERED>
__global__ void ldpc_minsum_kernel(const float* __restrict__ llr, int8_t* __restrict__ out,
                                   const int* __restrict__ tables, int n_e, int nb, int mb, int z,
                                   int iters, float beta, long long cw_stride,
                                   long long pos_stride) {
  extern __shared__ float smem[];
  float* c2v = smem;              // [n_e][z], check alignment
  float* tot = c2v + n_e * z;     // [nb][z], variable alignment
  int* t_col = (int*)(tot + nb * z);
  int* t_shift = t_col + n_e;
  int* t_row = t_shift + n_e;         // mb + 1
  int* t_col_start = t_row + mb + 1;  // nb + 1
  int* t_col_edges = t_col_start + nb + 1;
  const int n_tab = 3 * n_e + mb + nb + 2;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) t_col[i] = tables[i];

  const int r = threadIdx.x;
  const long long base = (long long)blockIdx.x * cw_stride;
  float ch[kMaxNb];
#pragma unroll
  for (int j = 0; j < kMaxNb; ++j) {
    if (j < nb) ch[j] = llr[base + (long long)(j * z + r) * pos_stride];
  }
  for (int e = 0; e < n_e; ++e) c2v[e * z + r] = 0.0f;
  if (LAYERED) {
#pragma unroll
    for (int j = 0; j < kMaxNb; ++j) {
      if (j < nb) tot[j * z + r] = ch[j];
    }
  }
  __syncthreads();

  // Totals of position r of every column (flooding), in the plain order.
  auto totals = [&](bool store_hard) {
#pragma unroll
    for (int j = 0; j < kMaxNb; ++j) {
      if (j < nb) {
        float t = ch[j];
        for (int k = t_col_start[j]; k < t_col_start[j + 1]; ++k) {
          const int e = t_col_edges[k];
          int rc = r - t_shift[e];
          if (rc < 0) rc += z;
          t += c2v[e * z + rc];
        }
        if (store_hard) out[base + (long long)(j * z + r) * pos_stride] = (int8_t)(t < 0.0f);
        else tot[j * z + r] = t;
      }
    }
  };

  for (int it = 0; it < iters; ++it) {
    if (!LAYERED) {
      totals(false);
      __syncthreads();
    }
    for (int i = 0; i < mb; ++i) {
      const int e0 = t_row[i], e1 = t_row[i + 1];
      unsigned rsign = 0u;
      float min1 = 0.0f, min2 = 0.0f;
      for (int e = e0; e < e1; ++e) {
        int p = r + t_shift[e];
        if (p >= z) p -= z;
        const float m = tot[t_col[e] * z + p] - c2v[e * z + r];
        if (!LAYERED) c2v[e * z + r] = m;
        const unsigned bits = __float_as_uint(m);
        rsign ^= bits & 0x80000000u;
        const float a = __uint_as_float(bits & 0x7fffffffu);
        if (e == e0) {
          min1 = a;
          min2 = 3.4e38f;
        } else {
          min2 = fminf(min2, fmaxf(min1, a));
          min1 = fminf(min1, a);
        }
      }
      for (int e = e0; e < e1; ++e) {
        float m, t = 0.0f, c_old = 0.0f;
        int p = 0;
        if (LAYERED) {
          p = r + t_shift[e];
          if (p >= z) p -= z;
          t = tot[t_col[e] * z + p];
          c_old = c2v[e * z + r];
          m = t - c_old;
        } else {
          m = c2v[e * z + r];
        }
        const unsigned bits = __float_as_uint(m);
        const float a = __uint_as_float(bits & 0x7fffffffu);
        const float excl = a == min1 ? min2 : min1;
        const float mag = fmaxf(excl - beta, 0.0f);
        const float v = __uint_as_float(__float_as_uint(mag) | (rsign ^ (bits & 0x80000000u)));
        if (LAYERED) tot[t_col[e] * z + p] = t + (v - c_old);
        c2v[e * z + r] = v;
      }
      if (LAYERED) __syncthreads();
    }
    if (!LAYERED) __syncthreads();
  }

  if (LAYERED) {
#pragma unroll
    for (int j = 0; j < kMaxNb; ++j) {
      if (j < nb) out[base + (long long)(j * z + r) * pos_stride] = (int8_t)(tot[j * z + r] < 0.0f);
    }
  } else {
    totals(true);
  }
}

template <bool LAYERED>
int launch(const float* llr, int8_t* out, const int* tables, int n_e, int nb, int mb, int z,
           int iters, float beta, long long n_cw, long long cw_stride, long long pos_stride,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)(n_e + nb) * z + 3 * n_e + mb + nb + 2);
  cudaError_t err = cudaFuncSetAttribute(ldpc_minsum_kernel<LAYERED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ldpc_minsum_kernel<LAYERED><<<(unsigned)n_cw, z, smem, st>>>(
      llr, out, tables, n_e, nb, mb, z, iters, beta, cw_stride, pos_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdr_ldpc_minsum(const float* llr, int8_t* out, const int* tables, int n_e, int nb,
                               int mb, int z, int iters, float beta, int layered, long long n_cw,
                               long long cw_stride, long long pos_stride, void* stream) {
  if (n_cw == 0) return 0;
  if (nb < 1 || nb > kMaxNb || mb < 1 || z < 1 || z > 1024 || n_e < 1 || iters < 0 ||
      n_cw > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (layered)
    return launch<true>(llr, out, tables, n_e, nb, mb, z, iters, beta, n_cw, cw_stride,
                        pos_stride, st);
  return launch<false>(llr, out, tables, n_e, nb, mb, z, iters, beta, n_cw, cw_stride,
                       pos_stride, st);
}
