// Kernel G's entry point and its OFDM instantiations; the kernel is in
// mc.cuh, the SC-FDMA instantiations in mc_spread.cu.
#include "mc.cuh"

namespace {

// Blocks wanted in flight, a streaming multiprocessor, before a channel's
// symbols are split over several blocks.
constexpr int kBlocksPerSm = 4;

}  // namespace

int mc_launch_ofdm(const McParams& p, int bits_per_axis, int bpsk, const sdr::AxisTables& tab,
                   cudaStream_t st) {
  return launch_mod<false>(p, bits_per_axis, bpsk, tab, st);
}

// One Monte-Carlo pass; counts are added into p.out (zeroed by the caller).
extern "C" int sdr_mc_count(McParams p, int bits_per_axis, int bpsk, int spread,
                            sdr::AxisTables tab, void* stream) {
  if ((long long)p.B * p.S == 0) return 0;
  // log_n >= 7 (N >= 128, kernels/mc.py's MIN_N_FFT): four points a lane
  // at least, so the keyed draw takes whole quads of a lane's tones.
  if (p.log_n < 7 || p.log_n > 12 || p.n_taps < 0 || p.idx_mask > 0x7FFF)
    return (int)cudaErrorInvalidValue;
  if (spread && p.log_n > 8) return (int)cudaErrorInvalidValue;  // SC-FDMA: N <= 256
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // One block a channel, its groups taking every (kWarps/G)-th symbol;
  // with too few channels to fill the card, a channel's symbols split into
  // runs, at least a symbol a group.
  const int groups = p.log_n <= 9 ? kWarps : kWarps >> (p.log_n - 9);
  const int max_chunks = (p.S + groups - 1) / groups;
  const int want = (kBlocksPerSm * sms + p.B - 1) / p.B;
  const int chunks = want < 1 ? 1 : (want > max_chunks ? max_chunks : want);
  p.spc = (p.S + chunks - 1) / chunks;
  p.n_chunks = (p.S + p.spc - 1) / p.spc;
  if ((long long)p.B * p.n_chunks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = spread ? mc_launch_spread(p, bits_per_axis, bpsk, tab, st)
                        : mc_launch_ofdm(p, bits_per_axis, bpsk, tab, st);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
