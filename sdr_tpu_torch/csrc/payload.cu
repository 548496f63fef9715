// Kernel A: keyed payload draw.
//
// Replaces sdr_tpu/kernels/channel_pallas.py::payload_idx_pallas, the
// TPU's on-core-PRNG symbol-index draw (128-channel block seeding).
//
//   idx[b, s, n] = Philox4x32-10(key = seed ^ ROLE_PAYLOAD,
//                                ctr = (ch_ids[b], s, n, 0)).x & (2^bps - 1)
//
// int8 out for bps <= 7, int16 otherwise (the JAX rule). Because the
// counter is per (global channel, symbol, subcarrier), any slice of
// channels reproduces the full run bit for bit, with no block rule.
//
// Bound on the H100: integer throughput — ten Philox rounds (two
// 32-bit multiply-high/low pairs each) per output byte, against one
// byte written. The design keeps it a single elementwise grid-stride
// pass with nothing but the output written; using all four Philox
// words per call (4x fewer rounds) is the obvious next step and would
// change the stream's counter layout.
#include "common.cuh"
#include "philox.cuh"

template <typename OutT>
__global__ void payload_kernel(OutT* __restrict__ out, const int32_t* __restrict__ ch_ids,
                               long long total, int S, int log_n, uint32_t mask,
                               uint32_t k0, uint32_t k1) {
  const int n_mask = (1 << log_n) - 1;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i & n_mask);
    const long long r = i >> log_n;
    const int s = (int)(r % S);
    const long long b = r / S;
    const uint4 w = sdr::philox4x32_10(make_uint4((uint32_t)ch_ids[b], (uint32_t)s, (uint32_t)n, 0u),
                                       k0, k1);
    out[i] = (OutT)(w.x & mask);
  }
}

extern "C" int sdr_payload(void* out, int out_bytes, const int32_t* ch_ids, int B, int S,
                           int log_n, int bps, unsigned k0, unsigned k1, void* stream) {
  const long long total = (long long)B * S << log_n;
  if (total == 0) return 0;
  const uint32_t mask = (1u << bps) - 1u;
  long long blocks = (total + sdr::kThreads - 1) / sdr::kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bytes == 1) {
    payload_kernel<int8_t><<<(int)blocks, sdr::kThreads, 0, st>>>(
        (int8_t*)out, ch_ids, total, S, log_n, mask, k0, k1);
  } else if (out_bytes == 2) {
    payload_kernel<int16_t><<<(int)blocks, sdr::kThreads, 0, st>>>(
        (int16_t*)out, ch_ids, total, S, log_n, mask, k0, k1);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
