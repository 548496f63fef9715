// Kernel A: keyed payload draw.
//
// Replaces sdr_tpu/kernels/channel_pallas.py::payload_idx_pallas, the
// TPU's on-core-PRNG symbol-index draw (128-channel block seeding).
//
//   idx[b, s, n] = word (n mod 4) of Philox4x32-10(key = seed ^ ROLE_PAYLOAD,
//                  ctr = (ch_ids[b], s0 + s, n div 4, 0)) & (2^bps - 1),
//
// the words in the order (x, y, z, w); when N is not a multiple of 4 the
// last call's extra words are dropped. int8 out for bps <= 7, int16
// otherwise (the JAX rule). Each index is a pure function of (seed, role,
// global channel id, s, n), so any slice of channels reproduces the full
// run bit for bit, with no block rule; s0 (a time block's first symbol)
// gives rows s0 .. s0 + S - 1 of the whole frame's draw.
//
// Bound on the H100: integer multiplies — ten Philox rounds of two
// 32-bit multiply-high/low pairs per call, at 64 multiplies per clock per
// SM — against one byte (int8) written per index. The design keeps all
// four words of each call (one call per four indices), so a thread writes
// its four indices as one 32-bit (int8) or 64-bit (int16) store and a
// warp writes 128 or 256 contiguous bytes. The grid is (channel, quads of
// the channel's S x N indices): no division per index. The round keys are
// computed once on the host and passed by value, so the ten rounds read
// them from the constant bank.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kQuadThreads = 256;

template <typename OutT>
__global__ void __launch_bounds__(kQuadThreads)
    payload_kernel(OutT* __restrict__ out, const int32_t* __restrict__ ch_ids, int S, int N,
                   int log_q, uint32_t mask, int s0, sdr::PhiloxKeys keys) {
  const int quads = S << log_q;
  const int l = blockIdx.y * kQuadThreads + threadIdx.x;
  if (l >= quads) return;
  const int b = blockIdx.x;
  const int s = l >> log_q;
  const int q = l & ((1 << log_q) - 1);
  const uint4 w = sdr::philox4x32_10(
      make_uint4((uint32_t)__ldg(ch_ids + b), (uint32_t)(s0 + s), (uint32_t)q, 0u), keys);
  OutT* row = out + ((long long)b * S + s) * N;
  const int n0 = q << 2;
  if (N >= 4) {
    // N is a power of two, so a quad never straddles a row and the store is aligned.
    if constexpr (sizeof(OutT) == 1) {
      *reinterpret_cast<uint32_t*>(row + n0) =
          (w.x & mask) | (w.y & mask) << 8 | (w.z & mask) << 16 | (w.w & mask) << 24;
    } else {
      *reinterpret_cast<uint2*>(row + n0) =
          make_uint2((w.x & mask) | (w.y & mask) << 16, (w.z & mask) | (w.w & mask) << 16);
    }
  } else {
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
    for (int i = 0; i < N; ++i) row[i] = (OutT)(v[i] & mask);
  }
}

}  // namespace

extern "C" int sdr_payload(void* out, int out_bytes, const int32_t* ch_ids, int B, int S,
                           int log_n, int bps, int s0, unsigned k0, unsigned k1,
                           void* stream) {
  if ((long long)B * S == 0) return 0;
  const int N = 1 << log_n;
  const int log_q = log_n >= 2 ? log_n - 2 : 0;
  const long long quads = (long long)S << log_q;
  const long long grid_y = (quads + kQuadThreads - 1) / kQuadThreads;
  if (grid_y > 65535 || out_bytes < 1 || out_bytes > 2 || s0 < 0)
    return (int)cudaErrorInvalidValue;
  const uint32_t mask = (1u << bps) - 1u;
  const sdr::PhiloxKeys keys = sdr::philox_keys(k0, k1);
  const dim3 grid((unsigned)B, (unsigned)grid_y);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bytes == 1) {
    payload_kernel<int8_t><<<grid, kQuadThreads, 0, st>>>((int8_t*)out, ch_ids, S, N, log_q,
                                                          mask, s0, keys);
  } else {
    payload_kernel<int16_t><<<grid, kQuadThreads, 0, st>>>((int16_t*)out, ch_ids, S, N, log_q,
                                                           mask, s0, keys);
  }
  return (int)cudaGetLastError();
}
