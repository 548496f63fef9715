#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sdr_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository on a machine with a Hopper card:

    python3 chip_smoke.py

It builds the kernel library from ``sdr_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit), torch's
   version and the kernels' build time;
2. runs each kernel A–H and each mode (B's per-symbol gains, FIR and
   channel-off TX, C's taps=, despread, LLR-plane and sum modes, E's
   gains, noise and FIR — 24 taps, static and per symbol — F's LLR
   mode in f32 and bf16) against its plain torch version on the card at
   the slice's shapes and prints both times (CUDA events, after a
   warm-up, in turns plain, kernel, kernel, plain) and, for D and F, the
   share of the bound; D's sum and F's count also at N 128 and 512 (the
   narrow plan's other shapes) at terminal-cl's sample count, in the
   kernels line under ``other_n`` of their entries; phase 2w does the same
   at phase 3i's shapes — config 3 (N 1024) at B × 64 (B's modes and C's
   plane at B/4 × 64, the coded batch; B's flat and FIR modes at B × 64
   too, the link's batch, held against the plain version channel slice by
   slice), N 2048 and config 5's shape
   (N 4096) at B/2 × 16 — for B in every channel mode, C's count, plane
   and sums, C's despread count (at the link's batch) and plane (at the
   coded batch) on an SC-FDMA waveform, D and F in their wideband mode
   and C's post-FFT mode (``llr_chain``, plane and sum, on the
   interleaved plane the hybrid route passes, each with its bound and
   share, and the planar build's bits equal to it), the ``K1`` line per
   N giving
   F's count beside C's on the same tones and each mode's share of its
   bound (C's count, sum and plane, each also with the despread, and its
   TP mode at N 128–4096 run its warp-group form, ``csrc/demod_rows.cuh``;
   the post-FFT mode its streaming form, ``csrc/llr_chain.cu``; the form
   each entry ran is its ``form``); then holds the staged
   channel route (kernel B's channel-off TX, then kernel E's FIR) against
   the fused one (kernel B's FIR), which must agree bit for bit; kernel G in its injected and keyed modes (five channels,
   SC-FDMA, config 3's N 1024 and config 5's N 4096), with its bound
   and its share of it; C's despread at config 2
   and at config 5's shape; kernel H (min-sum decode, flooding 25 and
   layered 13 iterations, rows and transposed layouts) on the coded
   link's LLRs at config 2, 8192 × 64 (172,032 codewords of the rate-1/2
   code): identical hard bits to the plain version, each layout and
   schedule timed beside its bound; kernel A at 8192 × 64 × 256
   int8 (bps 4) and int16 (bps 10) bit for bit, timed beside
   ``torch.randint``, and at a symbol offset (s0 = 32: rows 32.. of the
   frame, bit for bit; timed at s0 = 64); kernel E at a time block's seam
   (s0 = 32 and the FIR's history planes, 24 static and per-symbol taps,
   injected and keyed, against the plain version, timed; the block's rows
   with the frame's tail as history equal to the frame's, bit for bit);
   2t. kernel C's tensor-parallel stage-2 mode (``tp_stage2_llr``, #20)
   against ``stage2_llr_plain`` at the shapes the TP path runs — rows of
   n2 = 1024 (config 5 split over 4 ranks, 256 × 64 per rank),
   n2 = 4096 (one rank; h per link and per symbol) and n2 = 512 (8
   ranks), 16-QAM, the noise variance a device tensor, all in the
   warp-group form: within 1e-4 of the peak, equal signs where
   |LLR| ≥ 1e-3, times, bound and share;
   2b. kernels D and F on bfloat16 sample planes against their plain
   versions (D at 32768 × 64, F's count and plane at 8192 × 64), then,
   with the counters zeroed, the BER gate of bf16 input through
   ``demod_count_chain_cl`` on identical synthetic links (per-tone
   Rayleigh, N 256, B/4 × 64): 16-QAM at 8 and 14 dB and 64-QAM at
   18 dB within 0.5 % of the f32 input's errors, 1024-QAM at 30 dB
   printed and within 10.1 % (the JAX gate's rows);
3. drives the keyed fast link (``fast_simulate``) at BASELINE config-2
   numerology (16-QAM, N = 256, CP = 64) with 8192 channels × 64
   symbols: AWGN at 10 dB against exact theory (within 5 %), flat
   Rayleigh at 12 dB (within 10 %), and channels [0, 4096) alone against
   the full run (identical counts);
   3b. the selective and time-varying channels at the same size —
   MULTIPATH with BASELINE config 4's PDP, RAYLEIGH_TIME and
   MULTIPATH_TIME at doppler 0.02, MULTIPATH with 24 taps (the staged
   route: kernel E's FIR) — each BER within 2 % of the exact BER over the
   channel the run drew, with its time, and split == full for
   MULTIPATH_TIME;
   3c. ``layout="cl"`` for AWGN and flat Rayleigh: counts equal to the
   rows run's (but for bits with plain |LLR| < 1e-3), the same BER
   gates, and both layouts' end-to-end times;
4. times the channels-last demod-sum terminal at the headline bench's
   shape (32768 channels × 64 symbols) through ``demod_sum_chain_cl``, on
   f32 and on bf16 sample planes;
   3d. the Monte-Carlo engine (``mc_simulate``, kernel G, 4 passes) at
   config 2, 8192 × 64: time and GS/s (CP excluded), AWGN 8 dB within
   1 % of exact theory, four fading models within 2 % of the BER over
   the channels the passes drew, pass 0 against ``fast_simulate`` on the
   same seed (per channel equal but for bits with plain |LLR| < 1e-3;
   totals within 1e-5 relative), and one call at 32768 channels;
   3e. wideband and SC-FDMA: ``mc_simulate`` at config 5 (N = 4096,
   MULTIPATH 5 taps, 14 dB) and with ``dft_spread`` at N = 4096 (the
   staged route through C's despread), ``fast_simulate`` with
   ``dft_spread`` at config 2;
   3f. ``ebno_sweep(engine="mc")`` over BASELINE config 2's grid (every
   point with ≥ 1e4 errors within 3 % of theory), resumed from its
   checkpoint with no launch of G, and one point each of config 3
   (engine "mc") and config 2 (engine "fast");
   3g. the coded engine (``ldpc_fast_simulate``) at config 2, 8192 × 64,
   rate 1/2: ms per call and info Mb/s of the staged and fused seams,
   flooding 25 and layered 13 iterations, at RAYLEIGH_FLAT 6 dB, and
   rates 2/3 and 3/4; gates: layered 13 within 30 % of flooding 25 in
   info-bit errors, the seams within max(8, 1 %) at 9 dB, coded BER below
   a third of the uncoded at AWGN 6 dB, channels [0, B/2) alone equal to
   the full run, and the engine with every kernel swapped for its plain
   version on 512 channels, held at the decoder: its input LLRs within
   1e-4 of their peak, H equal to the plain decoder on them, info bits
   decoded differently only in codewords holding a plain |LLR| < 1e-3,
   totals within max(8, 0.1 %);
   3h. the LLR-plane terminals a user calls (``demod_llr_chain_cl`` f32
   and bf16, ``demod_chain`` plane, sum and despread,
   ``demod_chain_hybrid`` plane and sum) at 8192 × 64;
   3i. the wideband link: ``fast_simulate`` at config 3 (64-QAM, N 1024,
   CP 128, 8192 × 64; AWGN 12 dB and RAYLEIGH_FLAT 15 dB against exact
   theory within 5 % / 10 %, MULTIPATH with config 4's PDP at 14 dB
   within 2 % of the BER over the drawn channel; channels [0, B/2) alone
   equal to the full run), at config 5's shape (N 4096, CP 512, 5 taps,
   14 dB, 4096 × 16; drawn-channel gate) and at N 2048 (the same
   channel, 4096 × 16), each in both layouts (cl counts equal to rows but
   for the near-zero bits; ms per call and GS/s); ``ldpc_fast_simulate``
   at config 3 (2048 × 64, rate 1/2, RAYLEIGH_FLAT 9 dB) and at N 2048
   and 4096, staged and fused seams within max(8, 1 %); the terminals
   ``demod_sum_chain_cl``, ``demod_count_chain_cl``,
   ``demod_llr_chain_cl``, ``demod_chain`` (sum) and
   ``demod_chain_hybrid`` at N 1024,
   2048 and 4096, every sum within 1e-5 of the plain sum, and the SC-FDE
   receive (``demod_count_chain`` and
   ``demod_chain`` with ``despread``; the sum at N 4096) (CUDA events);
   3p. the link pipeline (``link.pipeline.simulate``) at config 2, 8192
   × 64, counters zeroed before it: ``__graft_entry__.entry()``'s link
   (MULTIPATH PDP (1, .5, .25, .125), MMSE, 12 dB) within 2 % of the BER
   over the drawn channel, its counts equal to ``fast_simulate``'s on the
   same seed and channels [0, B/2) alone equal to the full run; AWGN
   10 dB MMSE and NONE within 5 % of theory; ZF on the entry link (kernel
   C's one-tap tail, as MMSE) within 2 % of the drawn channel's BER;
   RICIAN, RAYLEIGH_TIME and
   MULTIPATH_TIME within 2 % of theirs; SC-FDMA AWGN 10 dB within 2 % of
   theory; ``want_llrs=True`` (kernel C's plane: its shape, and its hard
   bits against the count but for bits with |LLR| < 1e-3); and
   ``link.stream.stream_simulate`` at n_blocks 4 against ``simulate``:
   bit for bit on the entry link, and on MULTIPATH_TIME (fd 0.03) but
   for the same margin — each
   with ms (median of 3 warm calls, CUDA events) and the launches of one
   call (kernels A, B off, E, C);
   3q. pilots, counters zeroed before it: kernel B's pilot comb (spacing
   8, channel off) and kernel C's count skipping the comb's tones against
   their plain versions at 8192 × 64 (phase 2's tolerances), each timed
   beside its mode without the comb; the receive's torch work timed alone
   (the comb frame's FFT, the LS and DFT estimates, frame-averaged and per
   symbol, the block pilots' pilot-row FFT and data-row gather); then
   ``pipeline.simulate`` at config 2, 8192 × 64, on the comb links
   (MULTIPATH PDP (1, .5, .25, .125) 12 dB spacing 8: LS, DFT (32 taps),
   DFT with ZF; RAYLEIGH_TIME fd 0.02 LS per symbol; MULTIPATH_TIME PDP
   (1, .5, .25) fd 0.02 DFT per symbol) and the SC-FDMA block-pilot links
   (spacing 4, DFT, MMSE: MULTIPATH config 4's PDP 14 dB, and under
   MULTIPATH_TIME and RAYLEIGH_TIME fd 0.02), each against its genie twin
   (pilot_spacing 0, the same seed) with the JAX tests' gates — LS and
   block static ≤ 2 × max(genie, 1e-4), DFT < LS and DFT ≤ 1.6 × genie +
   2e-4, per symbol and block time-varying ≤ 3 × genie + 1e-3 — with ms
   (median of 3 warm calls) and launches a call; ``want_llrs`` on the DFT
   link (the data tones' plane, its hard bits against the comb count);
   ``make_sharded_simulate_fn`` on one rank equal to ``simulate``;
   3r. front-end impairments, counters zeroed before it: kernel E's
   noise-only mode on the acquired link's stream, one (B, 1, 21477) row a
   channel, against its plain version (phase 2's tolerance) and timed
   beside it; its channel-only mode on the acquired link's (B, 67, 320)
   plane with ``pipeline.acquired_plane``'s gains and taps (per-link and
   per-symbol gains, static and per-symbol taps), likewise; the acquired
   receive's torch parts on a full-width stream
   (the timing metric, the fractional correction, the integer CFO, fine
   timing, the full-stream correction, the payload gather, the Wiener
   draw, ``iq_compensate``, the whole ``acquire_start``; CUDA events); then
   ``pipeline.simulate`` at config 2, 8192 × 64, spacing 8 unless named,
   on ``impairment_links``: acquired AWGN (QPSK 6 dB, CFO 2.3, offset 37)
   < 1.1 × the aligned link at 5.5 dB; acquired MULTIPATH (PDP (1, .3,
   .1), 8 dB) < 2 × its aligned twin; acquisition + PA (IBO 6 dB) < 5e-3;
   the aligned PA (16-QAM 10 dB) — IBO 20 within the linear link's
   Poisson band, IBO 0 > 5 × linear, DPD at IBO 5 < raw; the tracked LO
   walk (std scaled by √(80/320) from the JAX tests' N 64 CP 16) on AWGN
   (the untracked walk > 0.015 and > 10 × tracked) and MULTIPATH, and
   with acquisition; I/Q (1.1, 0.1) compensated against clean (at (1.3,
   0.25) the uncompensated link > 2 × compensated + 1e-3), and (1.05, 0.03) with acquisition at CFO 1.3 and at CFO
   0 with offset 37; the full front end over MULTIPATH_TIME < 3 × its
   unimpaired twin + 5e-3; SC-FDMA block pilots (spacing 4, DFT) with
   acquisition and a PA < max(2.5 × aligned twin, 5e-3) — each with ms
   (median of 3 warm calls) and launches a call, the window
   ``launches_impairments``, its wall time and peak memory;
   ``make_sharded_simulate_fn`` on one rank equal to ``simulate`` on the
   acquired AWGN link;
   3m. MIMO on the frame-static models, counters zeroed before it: on one
   pass of ``pipeline.CHUNK`` channels, kernel E's channel-only mode over
   the 2 × 2 pair plane (B·4, 66, 320) with the pairs' gains and static
   taps, its noise-only mode over the RX planes (B, 132, 320), and C's
   post-FFT mode on whitened tones (h per link, and per symbol after
   SC-FDMA's despread), each against its plain version (phase 2's
   tolerances) and timed beside it; the link's parts timed alone on that
   pass (A, B off and the preamble rows, the pair-plane copy, E, the torch
   sum over TX antennas, E's noise, the FFT, the preamble estimate, each
   detector, ``whitened_llrs``, the torch count); then ``pipeline.simulate``
   on ``mimo_links``: Alamouti 2x1, 2x2 and MRC 1x2 (16-QAM 10 dB, 8192 ×
   64) within 10 % of ``ber_alamouti_exact`` / ``ber_mrc_exact`` and 2 %
   of the exact BER over the drawn Σ|h|² (½ for Alamouti); the 2x2 mux
   with MMSE, ZF, SIC and ML and the 2x4 mux at 12 dB (ML < SIC < 0.8 ×
   MMSE, 2x4 < 0.25 × 2x2); the preamble links, LS and DFT, against their
   genie twins at 5 dB (the JAX gates of ``test_preamble_ber_near_genie``);
   at 2048 × 64 the JAX tests' MULTIPATH (and a MULTIPATH Alamouti link
   against its drawn channel), RICIAN, PA and SC-FDMA gate forms — each
   with ms (median of 3 warm calls), peak memory (under 40 GiB) and
   launches a call, the window ``launches_mimo``;
   3v. time-varying and impaired MIMO, counters zeroed before it: on one
   pass of ``pipeline.CHUNK`` channels, kernel E's channel-only mode over
   the 2 × 2 pair plane with per-symbol gains (RAYLEIGH_TIME, 64 rows) and
   per-symbol taps with in-plane history (MULTIPATH_TIME with midambles,
   96 rows), over the acquired MRC pair plane (83 rows, the tail row), its
   noise-only mode over the acquired streams (B, 2, 31717), and C's
   post-FFT mode with h per symbol and tone, each against its plain
   version and timed beside it; the receive's parts timed alone
   (``mimo_stream``, the mixer, ``acquire_array_start``, the slice, the
   midamble estimates, each per-symbol detector, ``whitened_llrs``); then
   ``pipeline.simulate`` on ``mimo_time_links``' 32 links at config 2's
   numerology (8192 × 64; ML and the TDL forms 2048 × 64): MRC 1x2 under
   Jakes fd 0.02 within 2 % of the exact BER over the drawn per-symbol
   Σ|h|², fd 1e-5 Alamouti 2x1 and MRC 1x2 within 10 % of theory, and the
   JAX tests' gate forms (per-symbol ML and SIC, the Doppler floor,
   midamble tracking, the TDL ladder, blind acquisition with the walk, I/Q,
   the PA, Jakes and SC-FDMA, the walk and I/Q alone) — each with ms
   (median of 3 warm calls), peak memory (under 40 GiB) and launches, the
   window ``launches_mimo_time``;
   3k. the coded links (``link.coded``): the Viterbi decoder alone at
   config 2's frame (B × 65536 LLRs) and the polar fast-SSCL decoder
   alone over B × 256 codewords of (256, 128) CRC-11, L 8, each the median
   of 3 warm calls with its peak memory and its decisions equal to the
   CPU's on the first 256 channels of the same LLRs; B off, E's noise and
   C's plane on the conv link's frame and H on the LDPC link's LLRs
   against their plain versions; the config-2 links at B × 64 AWGN
   (``coded_link_cell``): conv at rates 1/2, 2/3 and 3/4, LDPC 1/2
   flooding 25, polar L 8 — the JAX tests' gates (conv 1/2 under uncoded
   theory / 10, BER(1/2) ≤ BER(2/3) ≤ BER(3/4), LDPC under 1/12288 —
   the JAX test's zero errors in 12288 info bits as a rate —, polar under
   theory / 6.25), each link's ms, peak memory and
   launches; the JAX tests' SC-FDMA and MIMO compositions and a conv and a
   polar sweep point at their own sizes; the window
   ``launches_coded_link``;
   3x. the packet modem (``link.packet``, ``PacketConfig()``: 64 bytes,
   QPSK, N 64, CP 16, comb spacing 8; B packets a campaign): B's comb on
   the bodies, E's channel alone over the (B, 13, 80) burst plane and its
   noise over the (B, 1, 1077) stream row, C's plane on the tracked comb
   estimate and H on the LDPC packets' LLRs against their plain versions;
   then ``simulate_packets`` — conv 1/2, 2/3 and 3/4 under MULTIPATH (1,
   .5) at 16 dB with CFO 1.3 and delay 37 (crc_ok mean ≥ 0.75), conv at
   −6 dB AWGN (byte errors), LDPC and polar at 10 dB with CFO 1.3 (PER ≤
   1 %, and the JAX test's 5 packets) — each with the no-false-accept
   gate (no packet passes the CRC with a byte error; false alarms, a CRC
   bit wrong under a right payload, counted), ms
   (median of 3 warm calls), packets/s, the decoder alone and its share,
   peak memory and launches; ``receive_stream`` on 1024 captures of three
   16-byte bursts (each found within cp_len, the extra rounds
   CRC-rejected); the card's decisions against the CPU's on 64 packets of
   each family; the window ``launches_packet``;
   3y. link adaptation (``link.adapt``): ``calibrate`` over
   ``DEFAULT_LADDER`` and the default grid at config 2's width (N 256, CP
   64, AWGN; 1024 channels, 8 symbols: a depth cut), target 1e-3, with
   the JAX tests' gates (every rung at or below the target, thresholds
   monotone in efficiency per family, QAM64 < QAM256 < QAM1024 at 3/4,
   QPSK 1/2 LDPC ≤ conv and polar ≤ conv + 1 dB), its wall time, links and
   seconds by family; ``simulate_adaptive`` over a seeded shadowed profile
   (1024 channels, N(14, 6) dB) under 5e-3 info BER; the window
   ``launches_adapt``;
   5. the parallel layer: ``parallel.dryrun.dryrun_multichip`` on 4
   gloo ranks sharing the one card (spawned; the library built above is
   only loaded there) — TP at BASELINE config 5's full width (256 × 64,
   N 4096, CP 512, a MULTIPATH 14 dB link) against kernel C's unsharded
   plane (1e-4 of the peak, equal signs) and the drawn channel's BER
   (2 %); DP fast rows and cl at config 5's shape, config 2 and config 4;
   DP MC keyed (1 % of theory) and injected; DP coded-fast; DP SC-FDMA
   at N 1024; PP 2 × 2; the time-block stream with its halo exchange
   (2 × 2, n_blocks 4, 1024 × 64, the entry link and MULTIPATH_TIME fd
   0.03; also against ``pipeline.simulate``), the 2 × 2 ML MIMO link on
   the preamble's DFT estimate (``dryrun.mimo_cfg``), the polar CA-SCL
   coded link (list 2) — each bit-exact against
   the unsharded port, with its wall time (not a scaling figure); 5n. one NCCL rank runs TP at
   N 4096 and DP fast, so that device tensors go to the collectives;
6. checks that each path launched every kernel and mode of its slice
   (the counters are zeroed just before phase 3 and read after phase 4
   for kernels A–F, E's FIR mode included, zeroed again before phase 3d
   and read after 3f for G, C's despread and E's gain and noise mode
   (the SC-FDMA links), again before 3g and read after it for H and the
   LLR modes the coded engine runs (C's plane, F's f32), and again
   before 3h and read after it for the modes only the terminals run
   (C's sum and despread, F's bf16), and in 3i around each main-path call
   of the wideband link, into one window per N: C's post-FFT mode there,
   and every kernel and mode phase 2w held at an N, in that N's window;
   before 2b's gate and read after it for F on bf16 planes (D's bf16
   mode is in phase 4's window); and in phase 5's ranks around each
   sharded call, summed, for kernel #20 — phase 5n's window holds its
   launches at n2 = 4096; and in phase 3p around each pipeline and
   stream call, for A, B off, E (both modes) and C's count, despread
   count and plane, ``launches_pipeline``; and in phase 3q around each
   pilot link's call, for B's comb and C's comb count,
   ``launches_pilots``; and in phase 3r around each impaired link's call,
   for A, B's comb, E (the acquired stream's noise row among its noise
   launches, and the FIR) and C's comb and despread counts,
   ``launches_impairments``, the acquired links' calls also in a window
   of their own, where E's noise launches are the row's alone; and in
   phase 3m around each MIMO link's call, for A, B off, E (gains, FIR) and
   C's post-FFT mode, ``launches_mimo``; and in phase 3v around each
   time-varying or impaired MIMO link's call, for the same kernels,
   ``launches_mimo_time``; and in phase 3k around each coded link's call,
   for B off, E, C's plane and H, ``launches_coded_link``; in phase 3x
   around each packet campaign, capture and card-side check, for B's
   comb, E (both modes), C's plane and H, ``launches_packet``; in phase 3y
   around the calibration and the adaptive run, for B off, E, C's plane
   and H, ``launches_adapt``)
   and prints one JSON line per kernel set, with each kernel's bound (bytes over 3.35 TB/s or f32
   operations over 67 TFLOP/s, the H100 SXM data sheet) and its launches
   in each window (``launches_fast``, ``launches_mc``, ``launches_coded``,
   ``launches_terminals``, ``launches_wide`` — the sum of 3i's N
   windows; ``launches_bf16``, ``launches_parallel``, ``launches_nccl``,
   ``launches_pipeline``, ``launches_pilots``, ``launches_impairments``,
   ``launches_mimo``, ``launches_mimo_time``, ``launches_coded_link``,
   ``launches_packet``, ``launches_adapt``; ``launches`` is the
   window of its own path, the one checked; the entry ``fade_awgn@acquired_stream`` carries
   phase 3r's check of E at the stream's shape and the row's launches in the acquired links' window;
   the entries ``fade_awgn@mimo_pair_plane``, ``fade_awgn_fir@mimo_pair_plane``,
   ``fade_awgn@mimo_rx_noise`` and ``llr_chain@mimo_whitened_h_per_link`` /
   ``_h_per_symbol`` phase 3m's checks and their counters' launches in its window;
   the entries ``fade_awgn@mimo_time_pair_gains``,
   ``fade_awgn_fir@mimo_time_pair_taps``, ``fade_awgn@mimo_time_acquired_plane``,
   ``fade_awgn@mimo_time_stream_noise`` and ``llr_chain@mimo_time_h_per_symbol``
   phase 3v's; the entries ``tx_off@coded_link``, ``fade_awgn@coded_link``,
   ``demod_llr@coded_link`` and ``ldpc_minsum@coded_link`` phase 3k's;
   ``tx_comb@packet``, ``fade_awgn@packet``, ``fade_awgn_fir@packet``,
   ``demod_llr@packet`` and ``ldpc_minsum@packet`` phase 3x's;
   the entries named ``<counter>@N1024``, ``@N2048`` and ``@N4096`` carry
   phase 2w's numbers, the launches in that N's window and the TPU
   four-step, post-FFT or channels-last kernel they replace there),
   before it one ``phase 6 C`` line for each entry of kernel C's
   warp-group, TP and post-FFT modes (its form, ms, bound, share of the
   bound, launches and launches × (ms − bound ms)), one ``phase 6 E``
   line for each mode phase 2 timed kernel E in (its form, ms, plain ms,
   bound, share, the launches of its counter in its path's window and
   launches × (ms − bound ms)) and one ``phase 6 B`` line for each
   mode and N at which phases 2 and 2w timed kernel B (its form — the
   tile, or the warp-group plan R × G of ``csrc/tx_rows.cuh`` — ms, plain
   ms, bound, share, the launches of its counter in that N's window and
   launches × (ms − bound ms)), then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits 1 before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time


# The H100 SXM's published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# 32-bit integer multiplies: 64 per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0), 132 SMs at the
# 1.98 GHz boost clock.
IMUL_PER_S = 132 * 64 * 1.98e9
PHILOX_IMUL = 40  # ten rounds of two multiply-high/low pairs per Philox-4x32-10 call

SEED = 20261016

# Phase 3k's Eb/N0: uncoded 16-QAM errs at the percent level there while
# each family's gate (the JAX tests' forms) holds.
CODED_EBNO_DB = 4.0

# The coded cell's seam × schedule variants (phase 3g times them,
# ``profile_coded.py`` profiles them).
CODED_VARIANTS = (("staged", "flooding", 25), ("fused", "flooding", 25),
                  ("staged", "layered", 13), ("fused", "layered", 13))


def coded_cell(n_channels: int = 8192):
    """The coded cell's link (root PERF.md §4, coded-config2): BASELINE
    config 2 (16-QAM, N = 256, CP 64), 64 symbols, RAYLEIGH_FLAT 6 dB;
    the engine runs it at rate 1/2."""
    from sdr_tpu_torch.core.config import (
        ChannelConfig,
        ChannelModel,
        LinkConfig,
        Modulation,
        OFDMConfig,
    )

    return LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(n_fft=256, cp_len=64),
                      channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=6.0),
                      n_symbols=64, n_channels=n_channels)


def pipeline_cell(n_channels: int = 8192, **kw):
    """The pipeline cells' link (root PERF.md §4, pipeline-entry):
    ``__graft_entry__.entry()``'s — BASELINE config 2 (16-QAM, N = 256,
    CP 64), MULTIPATH PDP (1, .5, .25, .125), MMSE, 12 dB — at 64 symbols
    (``equalizer=Equalizer.ZF``: pipeline-zf)."""
    from sdr_tpu_torch.core.config import (
        ChannelConfig,
        ChannelModel,
        Equalizer,
        LinkConfig,
        Modulation,
        OFDMConfig,
    )

    return LinkConfig(**{**dict(
        modulation=Modulation.QAM16, ofdm=OFDMConfig(n_fft=256, cp_len=64),
        channel=ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=12.0,
                              pdp=(1.0, 0.5, 0.25, 0.125)),
        equalizer=Equalizer.MMSE, n_symbols=64, n_channels=n_channels), **kw})


# Phase 3r's front-end impairment links at config 2's width (N 256, CP 64,
# 64 symbols, comb spacing 8 unless named), each with the modulation,
# Eb/N0, impairment values and gate form of the JAX test it follows. The
# LO walk's std is per sample: scaled so that std·√(N + cp) equals the JAX
# test's at N 64, CP 16 (0.01 → 0.005, 0.008 → 0.004, 2e-3 → 1e-3).
PN_SCALE = (80 / 320) ** 0.5


def coded_link_cell(n_channels: int = 8192):
    """Phase 3k's coded links' link: BASELINE config 2 (16-QAM, N 256,
    CP 64), 64 symbols, AWGN at CODED_EBNO_DB (each family's frame at
    65536 bits: conv 32762 info bits at rate 1/2, LDPC 21 codewords, polar
    256 codewords)."""
    from sdr_tpu_torch.core.config import (
        ChannelConfig,
        ChannelModel,
        LinkConfig,
        Modulation,
        OFDMConfig,
    )

    return LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(n_fft=256, cp_len=64),
                      channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=CODED_EBNO_DB),
                      n_symbols=64, n_channels=n_channels)


def impairment_links(n_channels: int = 8192):
    """Phase 3r's links: (label, config of the main-path call, reference
    configs by name (run outside the launch window, the same seed), gate)
    with gate(ber, ref_bers, bits) → (ok, rule), bits the count of every
    link of the entry. A reference is a config (``pipeline.simulate``) or
    an oracle fn(seed, device) → per-channel errors: the JAX tests' links
    with a stage left out, which must fail where the stage is needed."""
    import dataclasses

    import torch

    from sdr_tpu_torch.kernels import demod as kc
    from sdr_tpu_torch.link import pipeline
    from sdr_tpu_torch.ops import pilots as pil
    from sdr_tpu_torch.ops.fft import fft as t_fft

    from sdr_tpu_torch.core.config import (
        ChannelConfig,
        ChannelEstimator,
        ChannelModel,
        Equalizer,
        LinkConfig,
        Modulation,
        OFDMConfig,
    )

    def link(mod, ebno_db, model=ChannelModel.AWGN, spacing=8, dft_spread=False,
             estimator=ChannelEstimator.LS, **channel):
        return LinkConfig(modulation=mod, ofdm=OFDMConfig(n_fft=256, cp_len=64),
                          channel=ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                          equalizer=Equalizer.MMSE, n_symbols=64, n_channels=n_channels,
                          pilot_spacing=spacing, dft_spread=dft_spread, estimator=estimator)

    def without(cfg, *names):
        defaults = dict(cfo_subcarriers=0.0, timing_offset=0, pa_ibo_db=None, pa_dpd=False,
                        phase_noise_std=0.0, iq_gain=1.0, iq_phase_rad=0.0)
        return dataclasses.replace(cfg, channel=dataclasses.replace(
            cfg.channel, **{k: defaults[k] for k in names}))

    acq = ("cfo_subcarriers", "timing_offset")
    q, q16 = Modulation.QPSK, Modulation.QAM16
    mp = ChannelModel.MULTIPATH
    acq_awgn = link(q, 6.0, cfo_subcarriers=2.3, timing_offset=37)
    acq_mp = link(q, 8.0, mp, pdp=(1.0, 0.3, 0.1), cfo_subcarriers=2.3, timing_offset=37)
    pa_dpd = link(q16, 10.0, pa_ibo_db=5.0, pa_dpd=True)
    pn_awgn = link(q16, 16.0, phase_noise_std=0.01 * PN_SCALE)
    pn_mp = link(q16, 16.0, mp, pdp=(1.0, 0.5, 0.25), phase_noise_std=0.008 * PN_SCALE)
    acq14 = link(q16, 14.0, cfo_subcarriers=1.3, timing_offset=37)
    pn_acq = dataclasses.replace(acq14, channel=dataclasses.replace(
        acq14.channel, phase_noise_std=2e-3 * PN_SCALE))
    iq = link(q16, 16.0, iq_gain=1.1, iq_phase_rad=0.1)
    iq_strong = link(q16, 16.0, iq_gain=1.3, iq_phase_rad=0.25)
    iq_acq = dataclasses.replace(acq14, channel=dataclasses.replace(
        acq14.channel, iq_gain=1.05, iq_phase_rad=0.03))
    iq_zero = without(dataclasses.replace(iq_acq, channel=dataclasses.replace(
        iq_acq.channel, timing_offset=37)), "cfo_subcarriers")
    full = link(q16, 16.0, ChannelModel.MULTIPATH_TIME, pdp=(1.0, 0.5, 0.25), doppler_norm=0.02,
                cfo_subcarriers=1.3, timing_offset=37, pa_ibo_db=8.0,
                phase_noise_std=2e-3 * PN_SCALE, iq_gain=1.05, iq_phase_rad=0.03)
    block = link(q16, 14.0, mp, spacing=4, dft_spread=True, estimator=ChannelEstimator.DFT,
                 pdp=(1.0, 0.5, 0.25, 0.125), cfo_subcarriers=1.3, timing_offset=37,
                 pa_ibo_db=6.0)

    def aligned(cfg, seed, dev):
        ids = torch.arange(cfg.n_channels, dtype=torch.int32, device=dev)
        idx = pipeline.draw_idx(cfg, seed, ids)
        return (idx, *pipeline.apply_channel(cfg, seed, ids, pipeline.tx_idx(cfg, idx)))

    def uncompensated(cfg):
        """The aligned link's planes counted with ``skip_iq``: no blind I/Q
        compensator (tests/test_iq_imbalance.py:186-219)."""
        def run(seed, dev):
            idx, rx, _, nv = aligned(cfg, seed, dev)
            return pipeline.count_errors(cfg, rx, None, nv, idx, skip_iq=True)
        return run

    def untracked(cfg):
        """The aligned link's planes counted on the frame-averaged LS comb
        estimate: no phase tracking (tests/test_phase_noise.py:136-171)."""
        def run(seed, dev):
            idx, rx, _, nv = aligned(cfg, seed, dev)
            cp = cfg.ofdm.cp_len
            h = pil.estimate_ls_comb(t_fft(torch.complex(*rx)[..., cp:]), cfg.pilot_spacing)
            hr, hi = pipeline._h_plane(h, cfg.n_channels, cfg.ofdm.n_fft, dev)
            return kc.demod_count(*rx, hr, hi, idx, cp, cfg.modulation, nv,
                                  pilot_spacing=cfg.pilot_spacing)
        return run

    def pa_gate(ber, r, bits):
        e = {k: v * bits for k, v in r.items()}
        band = abs(e["ibo20"] - e["linear"]) <= 4.0 * (max(e["linear"], 1) ** 0.5) + 10.0
        return (band and e["ibo0"] > 5 * max(e["linear"], 1) and ber < r["ibo5_raw"],
                "errors: |IBO 20 - linear| <= 4 sqrt(linear) + 10, IBO 0 > 5 x linear, "
                "DPD < raw at IBO 5")

    return [
        ("acq-awgn (QPSK 6 dB, CFO 2.3, offset 37)", acq_awgn,
         {"aligned 5.5 dB": without(link(q, 5.5), *acq)},
         lambda b, r, _: (b < 1.1 * r["aligned 5.5 dB"], "< 1.1 x aligned at 5.5 dB")),
        ("acq-multipath (PDP (1, .3, .1), 8 dB)", acq_mp, {"aligned": without(acq_mp, *acq)},
         lambda b, r, _: (b < 2.0 * r["aligned"], "< 2 x aligned twin")),
        ("acq-pa (QPSK 12 dB, CFO 1.7, offset 41, IBO 6 dB)",
         link(q, 12.0, cfo_subcarriers=1.7, timing_offset=41, pa_ibo_db=6.0), {},
         lambda b, r, _: (b < 5e-3, "< 5e-3")),
        ("pa-dpd (16-QAM 10 dB, IBO 5 dB, DPD)", pa_dpd,
         {"linear": without(pa_dpd, "pa_ibo_db", "pa_dpd"),
          "ibo20": dataclasses.replace(pa_dpd, channel=dataclasses.replace(
              pa_dpd.channel, pa_ibo_db=20.0, pa_dpd=False)),
          "ibo0": dataclasses.replace(pa_dpd, channel=dataclasses.replace(
              pa_dpd.channel, pa_ibo_db=0.0, pa_dpd=False)),
          "ibo5_raw": without(pa_dpd, "pa_dpd")}, pa_gate),
        ("pn-tracked-awgn (16-QAM 16 dB, std 0.005)", pn_awgn,
         {"clean": without(pn_awgn, "phase_noise_std"), "untracked": untracked(pn_awgn)},
         lambda b, r, _: (b < 3.0 * r["clean"] + 2e-3 and b < 0.02 and r["untracked"] > 0.015
                          and b < r["untracked"] / 10.0,
                          "< 3 x clean + 2e-3, < 0.02; untracked > 0.015 and > 10 x tracked")),
        ("pn-tracked-multipath (16-QAM 16 dB, std 0.004)", pn_mp,
         {"clean": without(pn_mp, "phase_noise_std")},
         lambda b, r, _: (b < 3.0 * r["clean"] + 5e-3, "< 3 x clean + 5e-3")),
        ("pn-acq (16-QAM 14 dB, CFO 1.3, offset 37, std 0.001)", pn_acq,
         {"acquisition only": acq14},
         lambda b, r, _: (b < max(2.5 * r["acquisition only"], 5e-3),
                       "< max(2.5 x acquisition only, 5e-3)")),
        ("iq-compensated (16-QAM 16 dB, 1.1, 0.1 rad)", iq,
         {"clean": without(iq, "iq_gain", "iq_phase_rad"), "compensated 1.3, 0.25": iq_strong,
          "uncompensated 1.3, 0.25": uncompensated(iq_strong)},
         lambda b, r, _: (b < 3.0 * r["clean"] + 2e-3 and r["uncompensated 1.3, 0.25"] > 2.0 * r[
             "compensated 1.3, 0.25"] + 1e-3, "< 3 x clean + 2e-3; uncompensated at (1.3, 0.25) "
                                             "> 2 x compensated + 1e-3")),
        ("iq-acq (16-QAM 14 dB, CFO 1.3, offset 37, 1.05, 0.03 rad)", iq_acq,
         {"acquisition only": acq14},
         lambda b, r, _: (b < max(2.5 * r["acquisition only"], 5e-3),
                       "< max(2.5 x acquisition only, 5e-3)")),
        ("iq-acq-zero-cfo (offset 37, CFO 0)", iq_zero, {"aligned": without(iq_zero, *acq)},
         lambda b, r, _: (b < max(2.5 * r["aligned"], 2e-4), "< max(2.5 x aligned, 2e-4)")),
        ("front-end-full (MULTIPATH_TIME fd 0.02, CFO 1.3, offset 37, IBO 8 dB, std 0.001, "
         "I/Q 1.05, 0.03 rad)", full,
         {"unimpaired": without(full, *acq, "pa_ibo_db", "phase_noise_std", "iq_gain",
                                "iq_phase_rad")},
         lambda b, r, _: (b < 3.0 * r["unimpaired"] + 5e-3, "< 3 x unimpaired twin + 5e-3")),
        ("scfdma-block-acq-pa (spacing 4, DFT, PDP (1, .5, .25, .125) 14 dB, CFO 1.3, "
         "offset 37, IBO 6 dB)", block, {"aligned": without(block, *acq)},
         lambda b, r, _: (b < max(2.5 * r["aligned"], 5e-3), "< max(2.5 x aligned twin, 5e-3)")),
    ]


def mimo_links(n_channels: int = 8192, n_side: int = 2048):
    """Phase 3m's links (root PERF.md §4, the MIMO cells to be): (key, label,
    config) in run order, at config 2's numerology (N 256, CP 64, 64
    symbols); the diversity, detector and preamble links at 16-QAM and
    ``n_channels``, the other JAX gate forms (MULTIPATH, RICIAN, the PA,
    SC-FDMA) at the JAX tests' modulation and Eb/N0 and ``n_side``. Then
    the theory (key → (name, BER)), the drawn-channel scale of the exact
    BER over Σ|h|² (key → ½ for Alamouti, 1 for MRC), and the gates
    (rule, fn(ber: key → BER) → ok), each the JAX test's form."""
    from sdr_tpu_torch.core.config import (
        ChannelConfig,
        ChannelEstimator,
        ChannelModel,
        Equalizer,
        LinkConfig,
        MIMOConfig,
        MIMOScheme,
        Modulation,
        OFDMConfig,
    )
    from sdr_tpu_torch.link.ber import ber_alamouti_exact, ber_mrc_exact

    import dataclasses

    A, M, X = MIMOScheme.ALAMOUTI, MIMOScheme.MRC, MIMOScheme.SPATIAL_MUX
    q16, q = Modulation.QAM16, Modulation.QPSK
    flat, mp = ChannelModel.RAYLEIGH_FLAT, ChannelModel.MULTIPATH
    dft = ChannelEstimator.DFT

    def link(mimo, ebno_db, model=flat, mod=q16, n=n_channels, estimator=ChannelEstimator.LS,
             equalizer=Equalizer.MMSE, dft_spread=False, **channel):
        return LinkConfig(modulation=mod, ofdm=OFDMConfig(n_fft=256, cp_len=64),
                          channel=ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                          equalizer=equalizer, estimator=estimator, n_symbols=64, n_channels=n,
                          dft_spread=dft_spread, mimo=mimo)

    pre = dict(csi="preamble")
    links = [
        ("a21", "Alamouti 2x1 RAYLEIGH_FLAT 10 dB", link(MIMOConfig(A, 2, 1), 10.0)),
        ("a22", "Alamouti 2x2 RAYLEIGH_FLAT 10 dB", link(MIMOConfig(A, 2, 2), 10.0)),
        ("m12", "MRC 1x2 RAYLEIGH_FLAT 10 dB", link(MIMOConfig(M, 1, 2), 10.0)),
        ("mmse", "mux 2x2 MMSE 12 dB", link(MIMOConfig(X, 2, 2), 12.0)),
        ("zf", "mux 2x2 ZF 12 dB", link(MIMOConfig(X, 2, 2), 12.0, equalizer=Equalizer.ZF)),
        ("sic", "mux 2x2 SIC 12 dB", link(MIMOConfig(X, 2, 2, detector="sic"), 12.0)),
        ("ml", "mux 2x2 ML 12 dB", link(MIMOConfig(X, 2, 2, detector="ml"), 12.0)),
        ("mux24", "mux 2x4 MMSE 12 dB", link(MIMOConfig(X, 2, 4), 12.0)),
    ]
    for key, label, mimo in (("a22", "Alamouti 2x2", MIMOConfig(A, 2, 2)),
                             ("m12", "MRC 1x2", MIMOConfig(M, 1, 2)),
                             ("ml", "mux 2x2 ML", MIMOConfig(X, 2, 2, detector="ml"))):
        genie = dataclasses.replace(mimo, csi="genie")
        est = dataclasses.replace(mimo, csi="preamble")
        links += [(f"{key}_genie5", f"{label} genie CSI 5 dB", link(genie, 5.0)),
                  (f"{key}_ls5", f"{label} preamble LS 5 dB", link(est, 5.0)),
                  (f"{key}_dft5", f"{label} preamble DFT 5 dB", link(est, 5.0, estimator=dft))]
    side = dict(n=n_side, mod=q)
    links += [
        ("mp_a22", "MULTIPATH (1, .5, .25) Alamouti 2x2 QPSK 30 dB",
         link(MIMOConfig(A, 2, 2), 30.0, mp, pdp=(1.0, 0.5, 0.25), **side)),
        ("mp_mux24", "MULTIPATH (1, .5, .25) mux 2x4 MMSE QPSK 30 dB",
         link(MIMOConfig(X, 2, 4), 30.0, mp, pdp=(1.0, 0.5, 0.25), **side)),
        ("mp_ml23", "MULTIPATH (1, .5) mux 2x3 ML 16-QAM 35 dB",
         link(MIMOConfig(X, 2, 3, detector="ml"), 35.0, mp, pdp=(1.0, 0.5), n=n_side)),
        ("mp_a22_10", "MULTIPATH (1, .5, .25, .125) Alamouti 2x2 16-QAM 10 dB",
         link(MIMOConfig(A, 2, 2), 10.0, mp, pdp=(1.0, 0.5, 0.25, 0.125), n=n_side)),
        ("ray21", "Alamouti 2x1 RAYLEIGH_FLAT QPSK 5 dB", link(MIMOConfig(A, 2, 1), 5.0, **side)),
        ("ric21", "Alamouti 2x1 RICIAN K 10 QPSK 5 dB",
         link(MIMOConfig(A, 2, 1), 5.0, ChannelModel.RICIAN, k_factor=10.0, **side)),
        ("pa_lin", "Alamouti 2x2 preamble QPSK 10 dB, no PA",
         link(MIMOConfig(A, 2, 2, **pre), 10.0, **side)),
        ("pa8", "Alamouti 2x2 preamble QPSK 10 dB, PA IBO 8 dB",
         link(MIMOConfig(A, 2, 2, **pre), 10.0, pa_ibo_db=8.0, **side)),
        ("dpd4", "Alamouti 2x2 preamble QPSK 10 dB, PA IBO 4 dB with DPD",
         link(MIMOConfig(A, 2, 2, **pre), 10.0, pa_ibo_db=4.0, pa_dpd=True, **side)),
    ]
    for key, label, mimo in (("a", "Alamouti 2x2", MIMOConfig(A, 2, 2, **pre)),
                             ("m", "MRC 1x2", MIMOConfig(M, 1, 2, **pre)),
                             ("x", "mux 2x2 MMSE", MIMOConfig(X, 2, 2, **pre))):
        for wave, spread in (("ofdm", False), ("sc", True)):
            links.append((f"{wave}_{key}", f"{'SC-FDMA' if spread else 'OFDM'} {label} preamble "
                          "QPSK 10 dB", link(mimo, 10.0, dft_spread=spread, **side)))
    for wave, spread in (("ofdm", False), ("sc", True)):
        links += [(f"{wave}_mp", f"{'SC-FDMA' if spread else 'OFDM'} Alamouti 2x2 preamble "
                   "MULTIPATH (1, .3) QPSK 10 dB",
                   link(MIMOConfig(A, 2, 2, **pre), 10.0, mp, pdp=(1.0, 0.3), dft_spread=spread,
                        **side)),
                  (f"{wave}_pa3", f"{'SC-FDMA' if spread else 'OFDM'} Alamouti 2x2 preamble "
                   "QPSK 10 dB, PA IBO 3 dB",
                   link(MIMOConfig(A, 2, 2, **pre), 10.0, pa_ibo_db=3.0, dft_spread=spread,
                        **side))]
    theory = {"a21": ("ber_alamouti_exact n_rx 1", ber_alamouti_exact(q16, 10.0, 1)),
              "a22": ("ber_alamouti_exact n_rx 2", ber_alamouti_exact(q16, 10.0, 2)),
              "m12": ("ber_mrc_exact n_rx 2", ber_mrc_exact(q16, 10.0, 2))}
    drawn = {"a21": 0.5, "a22": 0.5, "m12": 1.0, "mp_a22_10": 0.5}

    def near_genie(k):
        return (f"{k} preamble: 0.8 x genie < DFT < 3 x genie, 0.8 x genie < LS < 12 x genie, "
                "DFT < LS (tests/test_mimo.py:449-469)",
                lambda b: (0.8 * b[f"{k}_genie5"] < b[f"{k}_dft5"] < 3.0 * b[f"{k}_genie5"]
                           and 0.8 * b[f"{k}_genie5"] < b[f"{k}_ls5"] < 12.0 * b[f"{k}_genie5"]
                           and b[f"{k}_dft5"] < b[f"{k}_ls5"]))

    gates = [
        ("ML < SIC < MMSE and SIC < 0.8 x MMSE (tests/test_mimo.py:359-370)",
         lambda b: b["ml"] < b["sic"] < b["mmse"] and b["sic"] < 0.8 * b["mmse"]),
        ("2x4 < 0.25 x 2x2, MMSE (tests/test_mimo.py:198-208)",
         lambda b: b["mux24"] < 0.25 * b["mmse"]),
        near_genie("a22"), near_genie("m12"), near_genie("ml"),
        ("MULTIPATH Alamouti 2x2 30 dB < 1e-4, mux 2x4 < 1e-3 (tests/test_mimo.py:211-236)",
         lambda b: b["mp_a22"] < 1e-4 and b["mp_mux24"] < 1e-3),
        ("MULTIPATH ML 2x3 35 dB < 1e-3 (tests/test_mimo.py:316-329)",
         lambda b: b["mp_ml23"] < 1e-3),
        ("RICIAN K 10 < Rayleigh (tests/test_mimo.py:239-248)", lambda b: b["ric21"] < b["ray21"]),
        ("PA IBO 8 < 6 x max(linear, 1e-4), DPD at 4 < 8 x max(linear, 1e-4) "
         "(tests/test_pa.py:305-306)",
         lambda b: (b["pa8"] < 6.0 * max(b["pa_lin"], 1e-4)
                    and b["dpd4"] < 8.0 * max(b["pa_lin"], 1e-4))),
        ("SC-FDMA < 2 x OFDM for Alamouti, MRC and mux; < OFDM under MULTIPATH (1, .3) and "
         "a PA at IBO 3 (tests/test_scfdma.py:270-284)",
         lambda b: (all(b[f"sc_{k}"] < 2.0 * b[f"ofdm_{k}"] for k in "amx")
                    and b["sc_mp"] < b["ofdm_mp"] and b["sc_pa3"] < b["ofdm_pa3"])),
    ]
    return links, theory, drawn, gates


def mimo_time_links(n_channels: int = 8192, n_side: int = 2048):
    """Phase 3v's links (root PERF.md §4, the time-varying and impaired MIMO
    cells to be): (key, label, config) in run order, at config 2's
    numerology (N 256, CP 64, 64 symbols), ``n_channels`` channels, ML and
    the side forms (the per-tap-Jakes TDL) at ``n_side``; each JAX gate's
    modulation and Eb/N0 where its bound depends on them (QPSK), 16-QAM
    10 dB (config 2's) for the theory and drawn-channel gates; the LO walk's
    std × √(80/320) (per sample at N 256, CP 64, as phase 3r). Then the
    theory (key → (name, BER)), the drawn-channel keys (the exact BER over
    the drawn per-symbol Σ|h|²), and the gates (rule, fn(r: key → per-channel
    BER, a numpy array) → ok), each the JAX test's form."""
    from sdr_tpu_torch.core.config import (
        ChannelConfig,
        ChannelEstimator,
        ChannelModel,
        Equalizer,
        LinkConfig,
        MIMOConfig,
        MIMOScheme,
        Modulation,
        OFDMConfig,
    )
    from sdr_tpu_torch.link.ber import ber_alamouti_exact, ber_mrc_exact

    A, M, X = MIMOScheme.ALAMOUTI, MIMOScheme.MRC, MIMOScheme.SPATIAL_MUX
    q16, q = Modulation.QAM16, Modulation.QPSK
    flat, rt, mt = ChannelModel.RAYLEIGH_FLAT, ChannelModel.RAYLEIGH_TIME, ChannelModel.MULTIPATH_TIME
    dft = ChannelEstimator.DFT
    pdp = (1.0, 0.5, 0.25)
    walk = 2e-3 * PN_SCALE

    def link(mimo, ebno_db, model=rt, mod=q, n=n_channels, estimator=ChannelEstimator.LS,
             dft_spread=False, **channel):
        if model in (rt, mt):
            channel.setdefault("doppler_norm", 0.02)
        if model == mt:
            channel.setdefault("pdp", pdp)
        return LinkConfig(modulation=mod, ofdm=OFDMConfig(n_fft=256, cp_len=64),
                          channel=ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                          equalizer=Equalizer.MMSE, estimator=estimator, n_symbols=64,
                          n_channels=n, dft_spread=dft_spread, mimo=mimo)

    def pre(k=0, **kw):
        return dict(csi="preamble", midamble_period=k, **kw)

    acq = dict(cfo_subcarriers=1.3, timing_offset=37)
    links = [
        ("m12_rt", "MRC 1x2 RAYLEIGH_TIME fd 0.02 genie 16-QAM 10 dB",
         link(MIMOConfig(M, 1, 2), 10.0, mod=q16)),
        ("a21_slow", "Alamouti 2x1 RAYLEIGH_TIME fd 1e-5 genie 16-QAM 10 dB",
         link(MIMOConfig(A, 2, 1), 10.0, mod=q16, doppler_norm=1e-5)),
        ("m12_slow", "MRC 1x2 RAYLEIGH_TIME fd 1e-5 genie 16-QAM 10 dB",
         link(MIMOConfig(M, 1, 2), 10.0, mod=q16, doppler_norm=1e-5)),
        ("ml_flat", "mux 2x2 ML RAYLEIGH_FLAT genie 5 dB",
         link(MIMOConfig(X, 2, 2, detector="ml"), 5.0, flat, n=n_side)),
        ("ml_fast", "mux 2x2 ML RAYLEIGH_TIME fd 0.2 genie (per symbol) 5 dB",
         link(MIMOConfig(X, 2, 2, detector="ml"), 5.0, doppler_norm=0.2, n=n_side)),
        ("sic_fast", "mux 2x2 SIC RAYLEIGH_TIME fd 0.2 genie 5 dB",
         link(MIMOConfig(X, 2, 2, detector="sic"), 5.0, doppler_norm=0.2, n=n_side)),
        ("mmse_mid", "mux 2x2 MMSE RAYLEIGH_TIME fd 0.02 midamble K 8 10 dB",
         link(MIMOConfig(X, 2, 2, **pre(8)), 10.0)),
        ("a22_slow20", "Alamouti 2x2 RAYLEIGH_TIME fd 1e-4 genie 20 dB",
         link(MIMOConfig(A, 2, 2), 20.0, doppler_norm=1e-4)),
        ("a22_fast20", "Alamouti 2x2 RAYLEIGH_TIME fd 0.3 genie 20 dB",
         link(MIMOConfig(A, 2, 2), 20.0, doppler_norm=0.3)),
        ("m12_genie005", "MRC 1x2 RAYLEIGH_TIME fd 0.005 genie 5 dB",
         link(MIMOConfig(M, 1, 2), 5.0, doppler_norm=0.005)),
        ("m12_k4_005", "MRC 1x2 RAYLEIGH_TIME fd 0.005 midamble K 4 5 dB",
         link(MIMOConfig(M, 1, 2, **pre(4)), 5.0, doppler_norm=0.005)),
        ("m12_k2_08", "MRC 1x2 RAYLEIGH_TIME fd 0.08 midamble K 2 15 dB",
         link(MIMOConfig(M, 1, 2, **pre(2)), 15.0, doppler_norm=0.08)),
        ("m12_k16_08", "MRC 1x2 RAYLEIGH_TIME fd 0.08 midamble K 16 15 dB",
         link(MIMOConfig(M, 1, 2, **pre(16)), 15.0, doppler_norm=0.08)),
        ("tdl_siso", "SISO MULTIPATH_TIME (1, .5, .25) fd 0.02 16-QAM 16 dB",
         link(None, 16.0, mt, mod=q16, n=n_side)),
        ("tdl_a22", "Alamouti 2x2 MULTIPATH_TIME genie 16-QAM 16 dB",
         link(MIMOConfig(A, 2, 2), 16.0, mt, mod=q16, n=n_side)),
        ("tdl_m12", "MRC 1x2 MULTIPATH_TIME genie 16-QAM 16 dB",
         link(MIMOConfig(M, 1, 2), 16.0, mt, mod=q16, n=n_side)),
        ("tdl_a22_k4", "Alamouti 2x2 MULTIPATH_TIME midamble K 4 LS 16-QAM 16 dB",
         link(MIMOConfig(A, 2, 2, **pre(4)), 16.0, mt, mod=q16, n=n_side)),
        ("tdl_a22_k4_dft", "Alamouti 2x2 MULTIPATH_TIME midamble K 4 DFT 16-QAM 16 dB",
         link(MIMOConfig(A, 2, 2, **pre(4)), 16.0, mt, mod=q16, n=n_side, estimator=dft)),
        ("aligned_dft", "Alamouti 2x2 RAYLEIGH_FLAT head preamble DFT 8 dB",
         link(MIMOConfig(A, 2, 2, **pre()), 8.0, flat, estimator=dft)),
        ("acq_dft", "Alamouti 2x2 acquired (CFO 1.3, offset 37) midamble K 4 DFT 8 dB",
         link(MIMOConfig(A, 2, 2, **pre(4)), 8.0, flat, estimator=dft, **acq)),
        ("acq_ls", "Alamouti 2x2 acquired midamble K 4 LS 8 dB",
         link(MIMOConfig(A, 2, 2, **pre(4)), 8.0, flat, **acq)),
        ("acq_walk_iq", "Alamouti 2x2 acquired midamble K 4 LS 8 dB, LO walk and I/Q (1.05, .03)",
         link(MIMOConfig(A, 2, 2, **pre(4)), 8.0, flat, phase_noise_std=walk, iq_gain=1.05,
              iq_phase_rad=0.03, **acq)),
        ("acq_pa8", "Alamouti 2x2 acquired midamble K 4 LS 8 dB, PA IBO 8 dB",
         link(MIMOConfig(A, 2, 2, **pre(4)), 8.0, flat, pa_ibo_db=8.0, **acq)),
        ("acq_ml", "mux 2x2 ML acquired midamble K 4 8 dB",
         link(MIMOConfig(X, 2, 2, detector="ml", **pre(4)), 8.0, flat, n=n_side, **acq)),
        ("jk_genie", "MRC 1x2 RAYLEIGH_TIME fd 0.02 genie 5 dB",
         link(MIMOConfig(M, 1, 2), 5.0)),
        ("jk_mid", "MRC 1x2 RAYLEIGH_TIME fd 0.02 midamble K 4 5 dB",
         link(MIMOConfig(M, 1, 2, **pre(4)), 5.0)),
        ("jk_acq", "MRC 1x2 RAYLEIGH_TIME fd 0.02 acquired (CFO 1.7, offset 21) K 4 5 dB",
         link(MIMOConfig(M, 1, 2, **pre(4)), 5.0, cfo_subcarriers=1.7, timing_offset=21)),
        ("pn_clean", "Alamouti 2x2 RAYLEIGH_FLAT head preamble LS 8 dB",
         link(MIMOConfig(A, 2, 2, **pre()), 8.0, flat)),
        ("pn", "Alamouti 2x2 RAYLEIGH_FLAT midamble K 4 8 dB, LO walk",
         link(MIMOConfig(A, 2, 2, **pre(4)), 8.0, flat, phase_noise_std=walk)),
        ("iq", "Alamouti 2x2 RAYLEIGH_FLAT head preamble DFT 8 dB, I/Q (1.05, .03)",
         link(MIMOConfig(A, 2, 2, **pre()), 8.0, flat, estimator=dft, iq_gain=1.05,
              iq_phase_rad=0.03)),
        ("sc_aligned", "SC-FDMA Alamouti 2x2 head preamble 8 dB",
         link(MIMOConfig(A, 2, 2, **pre()), 8.0, flat, dft_spread=True)),
        ("sc_acq", "SC-FDMA Alamouti 2x2 acquired midamble K 4 8 dB",
         link(MIMOConfig(A, 2, 2, **pre(4)), 8.0, flat, dft_spread=True, **acq)),
    ]
    theory = {"a21_slow": ("ber_alamouti_exact n_rx 1", ber_alamouti_exact(q16, 10.0, 1)),
              "m12_slow": ("ber_mrc_exact n_rx 2", ber_mrc_exact(q16, 10.0, 2))}
    drawn = ("m12_rt",)
    t_bits = 64 * 256 * 2  # a QPSK channel's bits

    def in_lock(r):
        return r[r <= 0.25]

    gates = [
        ("ML per symbol at fd 0.2 within (0.6, 1.4) x flat ML; SIC at fd 0.2 0 < BER < 0.5 "
         "(tests/test_mimo.py:590-611)",
         lambda r: 0.6 < r["ml_fast"].mean() / r["ml_flat"].mean() < 1.4
         and 0 < r["sic_fast"].mean() < 0.5),
        ("the midamble-tracked mux runs: 0 <= BER < 0.5 (tests/test_mimo.py:664-680)",
         lambda r: 0 <= r["mmse_mid"].mean() < 0.5),
        ("Alamouti 2x2 at 20 dB: fd 0.3 > 5 x max(fd 1e-4, 1e-6) (tests/test_mimo.py:614-625)",
         lambda r: r["a22_fast20"].mean() > 5 * max(r["a22_slow20"].mean(), 1e-6)),
        ("MRC midamble K 4 < 2 x genie at fd 0.005; at fd 0.08 K 2 < 0.7 x K 16 "
         "(tests/test_mimo.py:644-661)",
         lambda r: (r["m12_k4_005"].mean() < 2.0 * r["m12_genie005"].mean()
                    and r["m12_k2_08"].mean() < 0.7 * r["m12_k16_08"].mean())),
        ("MULTIPATH_TIME: Alamouti 2x2 < MRC 1x2 < SISO; midamble K 4 DFT < LS < 0.05 "
         "(tests/test_channel_time.py:243-290)",
         lambda r: (r["tdl_a22"].mean() < r["tdl_m12"].mean() < r["tdl_siso"].mean()
                    and r["tdl_a22_k4_dft"].mean() < r["tdl_a22_k4"].mean() < 0.05)),
        ("acquisition: outage (BER > 0.25) < 5 %, in-lock mean < 3 x max(aligned mean, 5e-4); "
         "mux ML through it 0 < BER < 0.2 (tests/test_mimo.py:683-752)",
         lambda r: ((r["acq_dft"] > 0.25).mean() < 0.05
                    and in_lock(r["acq_dft"]).mean() < 3.0 * max(r["aligned_dft"].mean(), 5e-4)
                    and 0 < r["acq_ml"].mean() < 0.2)),
        ("acquired with LO walk and I/Q < 1.5 x acquired clean (tests/test_mimo.py:755-791)",
         lambda r: r["acq_walk_iq"].mean() < 1.5 * r["acq_ls"].mean()),
        ("acquired PA IBO 8 < 6 x max(acquired linear, 1e-4) (tests/test_pa.py:305's form)",
         lambda r: r["acq_pa8"].mean() < 6.0 * max(r["acq_ls"].mean(), 1e-4)),
        ("acquisition under Jakes fd 0.02: outages <= 3/64 of the channels, in-lock mean <= 2 x "
         "max(genie mean, 1 error), in-lock sum <= 1.5 x midamble sum (tests/test_mimo.py:"
         "794-839)",
         lambda r: ((r["jk_acq"] > 0.25).mean() <= 3 / 64
                    and in_lock(r["jk_acq"]).mean() * t_bits
                    <= 2.0 * max(r["jk_genie"].mean() * t_bits, 1.0)
                    and in_lock(r["jk_acq"]).sum() <= 1.5 * r["jk_mid"].sum())),
        ("LO walk with midamble K 4 < 1.8 x clean head preamble (tests/test_mimo.py:842-899)",
         lambda r: r["pn"].mean() < 1.8 * r["pn_clean"].mean()),
        ("I/Q (1.05, .03) compensated < 1.6 x matched, DFT (tests/test_mimo.py:902-923)",
         lambda r: r["iq"].mean() < 1.6 * r["aligned_dft"].mean()),
        ("SC-FDMA acquired: outage < 5 %, in-lock mean < 2.5 x max(aligned mean, 1 error) "
         "(tests/test_scfdma.py:298-330)",
         lambda r: ((r["sc_acq"] > 0.25).mean() < 0.05
                    and in_lock(r["sc_acq"]).mean() * t_bits
                    < 2.5 * max(r["sc_aligned"].mean() * t_bits, 1.0))),
    ]
    return links, theory, drawn, gates


def _fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def bound(n_bytes: float, n_flops: float, n_imul: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate,
    the f32 operations over the f32 peak and the 32-bit integer multiplies
    over the integer-multiply rate. The kernels that draw keyed numbers
    count 40 multiplies per Philox-4x32-10 call (``PHILOX_IMUL``): A its
    index draws, B and E one call per noise sample, G one per noise
    sample, a quarter per index and its fading calls. Transcendentals are
    not counted, so the bounds are lower bounds. The demodulating kernels
    (C, D, F, #20) never load a cyclic prefix, so their bounds count the
    S·N sample rows they read, not S·(N+CP)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_flops / F32_FLOPS, n_imul / IMUL_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def fft_flops(n: int) -> float:
    """Real operations of one radix-2 complex FFT of n points."""
    return 5.0 * n * math.log2(n)


def tail_flops(mod) -> float:
    """Per tone: the one-tap equalisation (12) and the max-log LLRs (per
    axis 3 per level and 2 per bit for the level scan, L ≤ 4; 12 per bit
    for the Gray fold)."""
    L, m = mod.levels_per_axis, mod.bits_per_axis
    axes = 1 if mod.bits_per_symbol == 1 else 2
    return 12.0 + axes * (3 * L + 2 * m if L <= 4 else 12 * m)


def despread_flops(mod, n: int, rows: int, h_rows: int, count: bool = False) -> float:
    """The despread (SC-FDE) receive of ``rows`` n-point symbols with
    ``h_rows`` rows of h: per symbol the forward and the inverse transform;
    per tone the MMSE weighting (6) and the scale (2), then the hard
    decisions (count: 3 a bit, as hard_bits) or the max-log LLRs
    (tail_flops less its one-tap equalisation); per h row and tone the
    MMSE weight and its bias term (9)."""
    axes = 1 if mod.bits_per_symbol == 1 else 2
    tone = 3.0 * axes * mod.bits_per_axis if count else tail_flops(mod) - 12
    return rows * (2 * fft_flops(n) + n * (8 + tone)) + h_rows * n * 9.0


# Kernel C's modes: those the warp-group form (csrc/demod_rows.cuh) takes
# at N 128-4096 (below that the shared-memory tile, demod.cu), and those
# of the post-FFT mode's streaming form (csrc/llr_chain.cu), at every N.
C_ROWS_MODES = ("demod_count", "demod_count_taps", "demod_llr", "demod_sum",
                "demod_count_despread", "demod_llr_despread", "demod_sum_despread",
                "tp_stage2_llr", "demod_count_comb")
C_STREAM_MODES = ("llr_chain", "llr_chain_sum")


def c_form(name: str, n_fft: int) -> dict:
    """The form of kernel C that mode ``name`` runs at ``n_fft``."""
    if name in C_STREAM_MODES:
        return {"form": "streaming: a block a run of one channel's symbols, 4 tones a thread at "
                        "a fixed k, h and its gains once a run, 16-byte loads and stores"}
    if name in C_ROWS_MODES and n_fft >= 128:
        r, g = (n_fft // 32, 1) if n_fft <= 512 else (16, n_fft // 512)
        dfts = "two shuffle DFTs (the despread's inverse)" if "despread" in name else \
            "shuffle DFTs"
        run = "a digit row's run of 32 symbols" if name == "tp_stage2_llr" else \
            "a run of 32 symbols"
        return {"form": f"warp-group: {g} warp{'s' if g > 1 else ''} a symbol, {r} points a "
                        f"lane in registers, {dfts}, a block {run}"}
    return {"form": "shared-memory tile: radix-2 stages, a barrier each"}


def b_form(n_fft: int) -> str:
    """The form of kernel B at ``n_fft``: csrc/tx_rows.cuh's plan, or the tile."""
    if n_fft >= 128:
        r, g = (n_fft // 32, 1) if n_fft <= 512 else (16, n_fft // 512)
        return (f"warp-group: plan R {r} x G {g} ({g} warp{'s' if g > 1 else ''} a symbol, {r} "
                "points a lane), a block a run of 32 symbols")
    return "shared-memory tile: radix-2 stages, a barrier each"


def e_form(name: str) -> str:
    """The form of kernel E (csrc/channel.cu) that counter ``name`` runs."""
    form = ("streaming: a block a run of 32 symbols of one channel, 4 samples a thread, "
            "16-byte accesses")
    if name == "fade_awgn_fir":
        form += ", the FIR over a shared-memory tile of 4096 samples and its history"
    return form


def _check(ok: bool, msg: str) -> None:
    if not ok:
        _fail(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    return smoke(torch.device("cuda"))


def smoke(dev, B: int = 8192, BD: int = 32768) -> int:
    """The phases on ``dev`` with B link channels and BD terminal channels."""
    t_script = time.perf_counter()
    import torch

    from sdr_tpu_torch.core.config import (
        ChannelConfig,
        ChannelModel,
        LinkConfig,
        Modulation,
        OFDMConfig,
    )
    from sdr_tpu_torch.kernels import _lib
    from sdr_tpu_torch.kernels import channel as ke
    from sdr_tpu_torch.kernels import demod as kc
    from sdr_tpu_torch.kernels import demod_cl as kd
    from sdr_tpu_torch.kernels import ldpc as kh
    from sdr_tpu_torch.kernels import mc as kg
    from sdr_tpu_torch.kernels import payload as ka
    from sdr_tpu_torch.kernels import tx as kb
    from sdr_tpu_torch.core import prng
    from sdr_tpu_torch.link import fast, fast_coded, mc
    from sdr_tpu_torch.link.coded import ldpc_code_for, ldpc_codewords_per_channel
    from sdr_tpu_torch.link.ber import ber_awgn_exact, ber_given_gain, ber_rayleigh_exact
    from sdr_tpu_torch.obs.sweep import ebno_sweep
    from sdr_tpu_torch.ops import channel as chan
    from sdr_tpu_torch.ops.demod import (
        demod_chain,
        demod_chain_hybrid,
        demod_count_chain,
        demod_count_chain_cl,
        demod_llr_chain_cl,
        demod_sum_chain_cl,
    )
    from sdr_tpu_torch.ops.interleave import deinterleave, interleave
    from sdr_tpu_torch.ops.ldpc import ldpc_encode
    from sdr_tpu_torch.ops.modulation import constellation

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: the card, torch, the build ---------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = smi
    prebuilt = _lib.library_path().exists()
    t0 = time.perf_counter()
    _lib.lib()
    print(smi)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernel library {_lib.source_hash()} "
          f"{'found prebuilt, loaded' if prebuilt else 'built from source and loaded'} "
          f"in {time.perf_counter() - t0:.1f} s")

    def timed(fn, reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def compare_times(kernel_fn, plain_fn, reps=3, kernel_reps=None):
        """Warm up both, then time in turns plain, kernel, kernel, plain
        (``kernel_reps`` calls of the kernel a turn, default ``reps``: a
        kernel of well under a millisecond timed one call a turn also
        carries the host's time to launch it)."""
        kernel_fn()
        plain_fn()
        p1 = timed(plain_fn, reps)
        k1 = timed(kernel_fn, kernel_reps or reps)
        k2 = timed(kernel_fn, kernel_reps or reps)
        p2 = timed(plain_fn, reps)
        return (k1 + k2) / 2, (p1 + p2) / 2

    mod = Modulation.QAM16
    N, CP, S = 256, 64, 64
    bps = mod.bits_per_symbol
    seed = SEED
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    report = {}

    def plane_err(got, want):
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    def plane_peak(planes):
        return max(float(b.abs().max()) for b in planes)

    def of_bound(rep):
        return (f"bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}), share "
                f"{rep['bound_ms'] / rep['ms']:.4f}")

    def chain_bound(b, s, n, h_syms, mod_, reduce_sum):
        """Kernel #19's bound: y (8 bytes a tone) and h read, the plane (4
        a bit) or the sum written; the tail's f32 operations."""
        out_bytes = 4 if reduce_sum else 4 * b * s * n * mod_.bits_per_symbol
        return bound(8 * b * s * n + 8 * b * h_syms * n + out_bytes, b * s * n * tail_flops(mod_))

    # ---- phase 2: each kernel against its plain version ------------------
    # A: payload draw, exact, in int8 (bps 4) and int16 (bps 10); four
    # indices per Philox call.
    for bps_a in (10, bps):
        idx = ka.payload_idx(S, N, bps_a, seed, ids)
        idx_plain = ka.payload_idx_plain(S, N, bps_a, seed, ids)
        _check(idx.dtype == ka.out_dtype(bps_a) and torch.equal(idx, idx_plain),
               f"kernel A differs from its plain version at bps {bps_a}")
        del idx_plain
    # A at a symbol offset (a time block of link.stream): rows S/2 .. S-1
    # of the frame's draw, bit for bit, and equal to the plain version.
    half_s = S // 2
    idx_s0 = ka.payload_idx(half_s, N, bps, seed, ids, s0=half_s)
    _check(torch.equal(idx_s0, ka.payload_idx_plain(half_s, N, bps, seed, ids, s0=half_s))
           and torch.equal(idx_s0, idx[:, half_s:]),
           "kernel A at s0 differs from its plain version or from the frame's rows")
    del idx_s0

    def plain_a():
        return ka.payload_idx_plain(S, N, bps, seed, ids)

    def randint():
        return torch.randint(0, 1 << bps, (B, S, N), dtype=torch.int8, device=dev)

    plain_a()
    pms = timed(plain_a, 3)
    # The kernel beside torch.randint: 20 calls each, in turns.
    randint()
    r1 = timed(randint, 20)
    k1 = timed(lambda: ka.payload_idx(S, N, bps, seed, ids), 20)
    k2 = timed(lambda: ka.payload_idx(S, N, bps, seed, ids), 20)
    r2 = timed(randint, 20)
    ms, lib_ms = (k1 + k2) / 2, (r1 + r2) / 2
    # The same draw at s0 = S (the frame's next S rows), 20 calls.
    ms_s0 = timed(lambda: ka.payload_idx(S, N, bps, seed, ids, s0=S), 20)
    n_calls = B * S * (-(-N // 4))
    report["payload"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=lib_ms,
                             ms_s0=ms_s0, **bound(B * S * N + 4 * B, 0, n_calls * PHILOX_IMUL))
    a_bytes = bound(B * S * N + 4 * B, 0)["bound_ms"]
    print(f"phase 2 A payload ({B}x{S}x{N} int8, bps {bps}; int16 bps 10 exact too): exact; "
          f"kernel {ms:.4f} ms, torch.randint {lib_ms:.4f} ms (20 calls each, in turns; "
          f"kernel/randint {ms / lib_ms:.3f}; at s0 = {S} {ms_s0:.4f} ms, rows s0.. exact), "
          f"plain {pms:.3f} ms; bound "
          f"{report['payload']['bound_ms']:.4f} ms ({report['payload']['bound_by']}: {n_calls} "
          f"Philox calls x {PHILOX_IMUL} multiplies; bytes {a_bytes:.4f} ms), "
          f"{report['payload']['bound_ms'] / ms:.3f} of it")

    # B: fused TX + flat channel.
    nv10 = 1.0 / (10.0 ** 1.0 * bps)
    tvar = nv10 / N
    h = chan.rayleigh_flat(seed, ids)
    hs_r = h.real.reshape(-1).contiguous()
    hs_i = h.imag.reshape(-1).contiguous()
    noise = (torch.randn((B, S, N + CP), device=dev), torch.randn((B, S, N + CP), device=dev))
    got = kb.tx_channel(idx, CP, mod, hs_r, hs_i, tvar, noise=noise)
    want = kb.tx_channel_plain(idx, CP, mod, hs_r, hs_i, tvar, noise=noise)
    inj_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    _check(inj_err <= 1e-4, f"kernel B (injected noise) max abs diff {inj_err:g} > 1e-4")
    del noise, got, want
    got = kb.tx_channel(idx, CP, mod, hs_r, hs_i, tvar, seed=seed, ch_ids=ids)
    want = kb.tx_channel_plain(idx, CP, mod, hs_r, hs_i, tvar, seed=seed, ch_ids=ids)
    key_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    peak = max(float(b.abs().max()) for b in want)
    _check(key_err <= 1e-5 * peak, f"kernel B (keyed noise) max abs diff {key_err:g} > 1e-5 of {peak:g}")
    del got, want
    ms, pms = compare_times(
        lambda: kb.tx_channel(idx, CP, mod, hs_r, hs_i, tvar, seed=seed, ch_ids=ids),
        lambda: kb.tx_channel_plain(idx, CP, mod, hs_r, hs_i, tvar, seed=seed, ch_ids=ids),
    )
    nrow = B * S  # OFDM symbols in the phase-2 planes
    b_rows = []  # kernel B's timed modes, for the phase 6 B lines

    def b_timed(mode, counter, n, cp_, b, s, idx_bytes, ms, pms, chan_bytes, sample_ops, keyed):
        """Kernel B's bound for one timed mode — bytes: the indices, the two
        output planes, the channel and (keyed) the channel ids; f32
        operations: the inverse FFT and, a sample, the gain or the FIR and
        the noise; keyed: a Philox call a sample — kept for its phase 6 B
        line."""
        rows = b * s
        rep = dict(ms=ms, plain_ms=pms,
                   **bound(rows * n * idx_bytes + 8 * rows * (n + cp_) + chan_bytes
                           + (4 * b if keyed else 0),
                           rows * (fft_flops(n) + sample_ops * (n + cp_)),
                           rows * (n + cp_) * PHILOX_IMUL if keyed else 0))
        b_rows.append(dict(rep, mode=mode, counter=counter, n_fft=n,
                           shape=f"{b}x{s}x{n + cp_}"))
        return rep

    report["tx"] = dict(max_abs_err=key_err,
                        **b_timed("flat gains, keyed", "tx", N, CP, B, S, 1, ms, pms, 8 * B, 10,
                                  True))
    print(f"phase 2 B tx+channel ({B}x{S}x{N + CP}): injected-noise max abs diff {inj_err:.3g}, "
          f"keyed-noise max abs diff {key_err:.3g} (peak {peak:.3g}); "
          f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
    got = kb.tx_chain(idx, CP, mod)
    off_err = plane_err(got, kb.tx_channel_plain(idx, CP, mod))
    _check(off_err <= 1e-5 * plane_peak(got), f"kernel B (channel off) max abs diff {off_err:g}")
    del got
    ms, pms = compare_times(lambda: kb.tx_chain(idx, CP, mod),
                            lambda: kb.tx_channel_plain(idx, CP, mod), reps=1)
    off = b_timed("channel off", "tx_off", N, CP, B, S, 1, ms, pms, 0, 0, False)
    report["tx_off"] = dict(off, max_abs_err=off_err)
    print(f"phase 2 B tx channel off ({B}x{S}x{N + CP}): max abs diff {off_err:.3g}; kernel "
          f"{ms:.3f} ms, plain {pms:.3f} ms, {of_bound(off)}")

    # C: rows demod + error count on the AWGN 10 dB waveform.
    re, im = kb.tx_channel(idx, CP, mod, noise_var=tvar, seed=seed, ch_ids=ids)
    hr = torch.ones((B, 1, N), device=dev)
    hi = torch.zeros((B, 1, N), device=dev)
    cnt = kc.demod_count(re, im, hr, hi, idx, CP, mod, nv10)
    llr = kc.demod_chain(re, im, hr, hi, CP, mod, nv10)
    cnt_plain = kc.count_errors(llr, idx, bps)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    del llr
    diff = (cnt - cnt_plain).abs()
    _check(bool((diff <= margin).all()), "kernel C counts differ beyond the |LLR| < 1e-3 bits")
    ms, pms = compare_times(
        lambda: kc.demod_count(re, im, hr, hi, idx, CP, mod, nv10),
        lambda: kc.demod_count_plain(re, im, hr, hi, idx, CP, mod, nv10),
    )
    report["demod_count"] = dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=pms,
                                 **bound(8 * nrow * N + 8 * B * N + nrow * N + 4 * B,
                                         nrow * (fft_flops(N) + N * tail_flops(mod))))
    print(f"phase 2 C demod+count ({B}x{S}x{N + CP}): {int(cnt.sum())} errors, plain "
          f"{int(cnt_plain.sum())}, max per-channel diff {int(diff.max())} "
          f"(allowed {int(margin.max())}); kernel {ms:.4f} ms, plain {pms:.3f} ms; "
          f"{of_bound(report['demod_count'])}")

    # C's LLR-plane mode on the same waveform: within 1e-4 of the plane's peak.
    def llr_check(label, got, want):
        err, peak = float((got.float() - want).abs().max()), float(want.abs().max())
        _check(err <= 1e-4 * peak, f"{label}: max abs diff {err:g} > 1e-4 of the peak {peak:g}")
        return err, peak

    c_err, c_peak = llr_check("kernel C llr", kc.demod_llr(re, im, hr, hi, CP, mod, nv10),
                              kc.demod_chain(re, im, hr, hi, CP, mod, nv10))
    ms, pms = compare_times(lambda: kc.demod_llr(re, im, hr, hi, CP, mod, nv10),
                            lambda: kc.demod_chain(re, im, hr, hi, CP, mod, nv10), reps=1)
    c_flops = nrow * (fft_flops(N) + N * tail_flops(mod))
    report["demod_llr"] = dict(max_abs_err=c_err, ms=ms, plain_ms=pms,
                               **bound(8 * nrow * N + 8 * B * N + 4 * nrow * N * bps,
                                       c_flops))
    print(f"phase 2 C llr plane ({B}x{S}x{N * bps} f32): max abs diff {c_err:.3g} (peak "
          f"{c_peak:.3g}, allowed 1e-4 of it); kernel {ms:.4f} ms, plain {pms:.3f} ms; "
          f"{of_bound(report['demod_llr'])}")
    del re, im, hr, hi, cnt, cnt_plain

    # C's sum mode, and its despread form, on bench.py-style rows inputs
    # (noise-like samples, Rayleigh h per link), whose LLR sum does not
    # cancel: within 1e-5 relative of the plain sum, the same bits twice.
    gen_c = torch.Generator(device=dev).manual_seed(seed + 1)
    sr, si = (torch.randn((B, S, N + CP), device=dev, generator=gen_c) * (1.0 / (2 * N) ** 0.5)
              for _ in range(2))
    shr, shi = (torch.randn((B, 1, N), device=dev, generator=gen_c) * 0.5 ** 0.5 for _ in range(2))
    for name, desp in (("demod_sum", False), ("demod_sum_despread", True)):
        tot_c = float(kc.demod_llr(sr, si, shr, shi, CP, mod, nv10, reduce_sum=True,
                                   despread=desp))
        tot_p = float(kc.demod_chain(sr, si, shr, shi, CP, mod, nv10, reduce_sum=True,
                                     despread=desp))
        s_err = abs(tot_c - tot_p)
        _check(s_err <= 1e-5 * abs(tot_p), f"kernel C {name} {tot_c!r} vs plain {tot_p!r}")
        _check(float(kc.demod_llr(sr, si, shr, shi, CP, mod, nv10, reduce_sum=True,
                                  despread=desp)) == tot_c, f"kernel C {name} is not deterministic")
        ms, pms = compare_times(
            lambda: kc.demod_llr(sr, si, shr, shi, CP, mod, nv10, reduce_sum=True, despread=desp),
            lambda: kc.demod_chain(sr, si, shr, shi, CP, mod, nv10, reduce_sum=True,
                                   despread=desp), reps=1)
        flops = despread_flops(mod, N, nrow, B) if desp else c_flops
        report[name] = dict(max_abs_err=s_err, ms=ms, plain_ms=pms,
                            **bound(8 * nrow * N + 8 * B * N + 4, flops))
        print(f"phase 2 C {'despread ' if desp else ''}sum ({B}x{S}x{N + CP}): {tot_c:.9g}, "
              f"plain {tot_p:.9g}, rel diff {s_err / abs(tot_p):.3g} (allowed 1e-5), "
              f"deterministic; kernel {ms:.4f} ms, plain {pms:.3f} ms; {of_bound(report[name])}")
    del sr, si, shr, shi

    def check_modes(label, kernel_fn, plain_fn, noise_shape, kernel_reps=None):
        """Injected noise, then keyed (channels [0, noise_shape[0])): max
        abs diff ≤ 1e-5 of the peak; times in the keyed mode
        (``kernel_reps`` kernel calls a turn)."""
        ch = ids[:noise_shape[0]]
        noise_i = (torch.randn(noise_shape, device=dev), torch.randn(noise_shape, device=dev))
        want = plain_fn(noise=noise_i)
        e_inj = plane_err(kernel_fn(noise=noise_i), want)
        p_inj = plane_peak(want)
        del noise_i, want
        want = plain_fn(seed=seed, ch_ids=ch)
        e_key = plane_err(kernel_fn(seed=seed, ch_ids=ch), want)
        p_key = plane_peak(want)
        del want
        _check(e_inj <= 1e-5 * p_inj, f"{label} (injected noise) max abs diff {e_inj:g}")
        _check(e_key <= 1e-5 * p_key, f"{label} (keyed noise) max abs diff {e_key:g}")
        ms, pms = compare_times(lambda: kernel_fn(seed=seed, ch_ids=ch),
                                lambda: plain_fn(seed=seed, ch_ids=ch), reps=1,
                                kernel_reps=kernel_reps)
        print(f"phase 2 {label}: max abs diff injected {e_inj:.3g}, keyed {e_key:.3g} "
              f"(peak {p_key:.3g}); kernel {ms:.3f} ms, plain {pms:.3f} ms")
        return dict(max_abs_err=max(e_inj, e_key), ms=ms, plain_ms=pms)

    def count_margin(llr):
        return (llr.abs() < 1e-3).sum(dim=(1, 2))

    # B: per-symbol gains, static 4 taps, per-symbol 3 taps.
    pdp4 = (1.0, 0.5, 0.25, 0.125)
    pdp3 = (1.0, 0.5, 0.25)
    pdp5 = (1.0, 0.6, 0.3, 0.1, 0.05)  # config 5's profile
    tx_shape = (B, S, N + CP)
    g_sym = chan.jakes_gains(seed, ids, S, 0.02)
    gs_r, gs_i = g_sym.real.contiguous(), g_sym.imag.contiguous()
    rep = check_modes(f"B tx+channel per-symbol gains ({B}x{S}x{N + CP})",
                      lambda **kw: kb.tx_channel(idx, CP, mod, gs_r, gs_i, tvar, **kw),
                      lambda **kw: kb.tx_channel_plain(idx, CP, mod, gs_r, gs_i, tvar, **kw),
                      tx_shape)
    b_timed("per-symbol gains, keyed", "tx", N, CP, B, S, 1, rep["ms"], rep["plain_ms"],
            8 * nrow, 10, True)
    t4_r = torch.tensor(pdp4, device=dev).expand(B, 4).contiguous()
    t4_i = torch.zeros_like(t4_r)
    rep = check_modes("B tx+FIR static 4 taps",
                      lambda **kw: kb.tx_channel(idx, CP, mod, noise_var=tvar, taps_r=t4_r,
                                                 taps_i=t4_i, **kw),
                      lambda **kw: kb.tx_channel_plain(idx, CP, mod, noise_var=tvar, taps_r=t4_r,
                                                       taps_i=t4_i, **kw), tx_shape)
    b_timed("FIR static 4 taps, keyed", "tx_taps", N, CP, B, S, 1, rep["ms"], rep["plain_ms"],
            32 * B, 8 * 4 + 4, True)
    taps3 = chan.multipath_time_taps(seed, ids, pdp3, S, 0.02)
    t3_r, t3_i = taps3.real.contiguous(), taps3.imag.contiguous()
    rep = check_modes(
        "B tx+FIR per-symbol 3 taps",
        lambda **kw: kb.tx_channel(idx, CP, mod, noise_var=tvar, taps_r=t3_r, taps_i=t3_i, **kw),
        lambda **kw: kb.tx_channel_plain(idx, CP, mod, noise_var=tvar, taps_r=t3_r, taps_i=t3_i,
                                         **kw), tx_shape)
    report["tx_taps"] = dict(rep, **b_timed("FIR per-symbol 3 taps, keyed", "tx_taps", N, CP, B,
                                            S, 1, rep["ms"], rep["plain_ms"], 24 * nrow,
                                            8 * 3 + 4, True))

    # C: taps= (3 taps per symbol) on the TDL waveform at 12 dB.
    nv12 = 1.0 / (10.0 ** 1.2 * bps)
    re, im = kb.tx_channel(idx, CP, mod, noise_var=nv12 / N, seed=seed, ch_ids=ids,
                           taps_r=t3_r, taps_i=t3_i)
    taps_pair = (t3_r, t3_i)
    cnt = kc.demod_count(re, im, None, None, idx, CP, mod, nv12, taps=taps_pair)
    llr = kc.demod_chain(re, im, *kc.taps_plane(taps_pair, N), CP, mod, nv12)
    cnt_plain = kc.count_errors(llr, idx, bps)
    margin = count_margin(llr)
    del llr
    diff = (cnt - cnt_plain).abs()
    _check(bool((diff <= margin).all()),
           "kernel C (taps=) counts differ beyond the |LLR| < 1e-3 bits")
    ms, pms = compare_times(
        lambda: kc.demod_count(re, im, None, None, idx, CP, mod, nv12, taps=taps_pair),
        lambda: kc.demod_count_plain(re, im, None, None, idx, CP, mod, nv12, taps=taps_pair),
        reps=1)
    report["demod_count_taps"] = dict(
        max_abs_err=float(diff.max()), ms=ms, plain_ms=pms,
        **bound(8 * nrow * N + 24 * nrow + nrow * N + 4 * B,
                nrow * (fft_flops(N) + N * (tail_flops(mod) + 8 * 3))))
    print(f"phase 2 C demod+count taps= (3 per symbol): {int(cnt.sum())} errors, plain "
          f"{int(cnt_plain.sum())}, max per-channel diff {int(diff.max())} (allowed "
          f"{int(margin.max())}); kernel {ms:.4f} ms, plain {pms:.3f} ms; "
          f"{of_bound(report['demod_count_taps'])}")
    del re, im, cnt, cnt_plain

    # E: per-link gains, per-symbol gains, noise only and the FIR (24 taps,
    # static and per symbol), over the clean waveform. Bound: 16 bytes a
    # sample, the gains or taps and the channel ids; f32 operations a
    # sample: 6 for a gain, 8 a tap, 4 for the noise; a Philox call a sample.
    clean = kb.tx_chain(idx, CP, mod)
    pdp24 = tuple(0.8 ** l for l in range(24))
    t24 = chan.multipath_taps(seed, ids, pdp24)
    t24s = chan.multipath_time_taps(seed, ids, pdp24, S, 0.02)
    e_rows = []  # kernel E's timed modes, for the phase 6 E lines
    for label, counter, chan_kw, chan_bytes, sample_ops in (
        ("per-link gains", "fade_awgn", dict(hr_s=hs_r[:, None], hi_s=hs_i[:, None]), 8 * B, 6),
        ("per-symbol gains", "fade_awgn", dict(hr_s=gs_r, hi_s=gs_i), 8 * nrow, 6),
        ("noise only", "fade_awgn", {}, 0, 0),
        ("FIR 24 static taps", "fade_awgn_fir",
         dict(taps_r=t24.real.contiguous(), taps_i=t24.imag.contiguous()), 8 * 24 * B, 8 * 24),
        ("FIR 24 per-symbol taps", "fade_awgn_fir",
         dict(taps_r=t24s.real.contiguous(), taps_i=t24s.imag.contiguous()), 8 * 24 * nrow,
         8 * 24),
    ):
        rep = check_modes(f"E {label} ({B}x{S}x{N + CP})",
                          lambda **kw: ke.fade_awgn(*clean, noise_var=tvar, **chan_kw, **kw),
                          lambda **kw: ke.fade_awgn_plain(*clean, noise_var=tvar, **chan_kw, **kw),
                          tx_shape, kernel_reps=10)
        rep.update(bound(16 * nrow * (N + CP) + chan_bytes + 4 * B,
                         (sample_ops + 4) * nrow * (N + CP), nrow * (N + CP) * PHILOX_IMUL))
        e_rows.append(dict(rep, mode=label, counter=counter))
        if label in ("per-symbol gains", "FIR 24 static taps"):
            report[counter] = rep
    # E at a time block's seam (link/stream.py): s0 = S/2 and the FIR's
    # history planes (the clean tail of the frame's last symbol), static
    # and per-symbol taps, injected and keyed, against the plain version;
    # then rows [S/2, S) at s0 = S/2 with the frame's row S/2 - 1 tail as
    # history against the whole frame's rows, bit for bit.
    hist24 = tuple(p[:, -1, -23:].contiguous() for p in clean)
    for label, taps24 in (("static", t24), ("per-symbol", t24s)):
        t_r, t_i = taps24.real.contiguous(), taps24.imag.contiguous()
        hist_kw = dict(taps_r=t_r, taps_i=t_i, s0=half_s, history_r=hist24[0],
                       history_i=hist24[1])
        rep = check_modes(f"E FIR 24 {label} taps from history planes at s0 = {half_s} "
                          f"({B}x{S}x{N + CP})",
                          lambda **kw: ke.fade_awgn(*clean, noise_var=tvar, **hist_kw, **kw),
                          lambda **kw: ke.fade_awgn_plain(*clean, noise_var=tvar, **hist_kw,
                                                          **kw),
                          tx_shape, kernel_reps=10)
        rep.update(bound(16 * nrow * (N + CP) + 8 * t_r.numel() + 8 * 23 * B + 4 * B,
                         (8 * 24 + 4) * nrow * (N + CP), nrow * (N + CP) * PHILOX_IMUL))
        e_rows.append(dict(rep, mode=f"FIR 24 {label} taps, history, s0 {half_s}",
                           counter="fade_awgn_fir"))
        rows_kw = dict(taps_r=t_r, taps_i=t_i) if label == "static" else dict(
            taps_r=t_r[:, half_s:].contiguous(), taps_i=t_i[:, half_s:].contiguous())
        full_e = ke.fade_awgn(*clean, noise_var=tvar, taps_r=t_r, taps_i=t_i, seed=seed,
                              ch_ids=ids)
        part_e = ke.fade_awgn(*(p[:, half_s:].contiguous() for p in clean), noise_var=tvar,
                              seed=seed, ch_ids=ids, s0=half_s,
                              history_r=clean[0][:, half_s - 1, -23:].contiguous(),
                              history_i=clean[1][:, half_s - 1, -23:].contiguous(), **rows_kw)
        same = all(torch.equal(a, b[:, half_s:]) for a, b in zip(part_e, full_e))
        _check(same, f"kernel E ({label} taps): the block at s0 = {half_s} with the frame's "
                     "tail differs from the frame's rows")
        print(f"phase 2 E FIR 24 {label} taps: rows [{half_s}, {S}) at s0 = {half_s} with the "
              f"frame's tail as history == the frame's rows (bit for bit)")
        del full_e, part_e
    del clean, t24, t24s, hist24

    # Route cross-check: staged (B off, then E's FIR) against fused (B's FIR).
    cfg_mp = LinkConfig(modulation=mod, ofdm=OFDMConfig(N, CP),
                        channel=ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=14.0,
                                              pdp=pdp4),
                        n_symbols=S, n_channels=B)
    fused = fast.tx_with_channel(cfg_mp, seed, ids, idx)
    staged = fast.apply_channel_fast(cfg_mp, seed, ids, *kb.tx_chain(idx, CP, mod))
    r_err, r_peak = plane_err(staged, fused), plane_peak(fused)
    _check(r_err <= 1e-5 * r_peak, f"staged route differs from the fused route by {r_err:g}")
    print(f"phase 2 route cross-check MULTIPATH 4 taps: staged (E's FIR) vs fused (B) max abs "
          f"diff {r_err:.3g} (peak {r_peak:.3g})")
    del staged

    # F: channels-last count on the 4-tap MULTIPATH waveform at 14 dB.
    nv14 = 1.0 / (10.0 ** 1.4 * bps)
    re_t, im_t = fast._to_cl(*fused)
    del fused
    h_mp = fast.rx_plane(fast.fade_state(cfg_mp, seed, ids, plane=False)[1], N)[:, 0, :].T
    hr_c, hi_c = h_mp.real.contiguous(), h_mp.imag.contiguous()
    idx_t = idx.permute(1, 2, 0).reshape(S * N, B).contiguous()
    cnt = kd.demod_count_cl(re_t, im_t, hr_c, hi_c, idx_t, CP, mod, nv14)
    cnt_plain = torch.zeros_like(cnt)
    margin = torch.zeros_like(cnt)
    hr_rows, hi_rows = hr_c.T[:, None, :], hi_c.T[:, None, :]
    for s in range(S):
        rows = slice(s * (N + CP) + CP, (s + 1) * (N + CP))
        llr = kc.demod_chain(re_t[rows].T[:, None, :], im_t[rows].T[:, None, :], hr_rows, hi_rows,
                             0, mod, nv14)
        cnt_plain += kc.count_errors(llr, idx_t[s * N:(s + 1) * N].T[:, None, :], bps)
        margin += count_margin(llr).to(torch.int32)
    diff = (cnt - cnt_plain).abs()
    _check(bool((diff <= margin).all()), "kernel F counts differ beyond the |LLR| < 1e-3 bits")
    ms, pms = compare_times(
        lambda: kd.demod_count_cl(re_t, im_t, hr_c, hi_c, idx_t, CP, mod, nv14),
        lambda: kd.demod_count_cl_plain(re_t, im_t, hr_c, hi_c, idx_t, CP, mod, nv14), reps=1)
    report["demod_count_cl"] = dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=pms,
                                    **bound(8 * nrow * N + 8 * N * B + nrow * N + 4 * B,
                                            nrow * (fft_flops(N) + N * tail_flops(mod))))
    print(f"phase 2 F demod+count channels-last ({S * (N + CP)}x{B}): {int(cnt.sum())} errors, "
          f"plain {int(cnt_plain.sum())}, max per-channel diff {int(diff.max())} (allowed "
          f"{int(margin.max())}); kernel {ms:.4f} ms, plain {pms:.3f} ms; "
          f"{of_bound(report['demod_count_cl'])}")
    del llr

    # F's LLR mode (kernel order) on the same waveform: f32 within 1e-4 of
    # the peak; bf16 sign-identical to f32 wherever |LLR| >= 1e-3 and
    # within bf16's rounding (2^-8 relative) of it.
    got = kd.demod_llr_cl(re_t, im_t, hr_c, hi_c, CP, mod, nv14)
    f_err, f_peak = llr_check("kernel F llr", got,
                              kd.demod_llr_cl_plain(re_t, im_t, hr_c, hi_c, CP, mod, nv14))
    half = kd.demod_llr_cl(re_t, im_t, hr_c, hi_c, CP, mod, nv14, out_dtype=torch.bfloat16)
    big = got.abs() >= 1e-3
    _check(torch.equal((half.float() < 0)[big], (got < 0)[big]),
           "kernel F bf16 LLR signs differ from f32 where |LLR| >= 1e-3")
    h_err = float((half.float() - got).abs().max())
    _check(float(((half.float() - got).abs() - got.abs() * 2.0 ** -8).max()) <= 0.0,
           "kernel F bf16 LLRs are not the f32 plane rounded")
    del got, half, big
    f_bytes = 8 * nrow * N + 8 * N * B
    f_flops = nrow * (fft_flops(N) + N * tail_flops(mod))
    for name, dt, err in (("demod_llr_cl", torch.float32, f_err),
                          ("demod_llr_cl_bf16", torch.bfloat16, h_err)):
        ms, pms = compare_times(
            lambda: kd.demod_llr_cl(re_t, im_t, hr_c, hi_c, CP, mod, nv14, out_dtype=dt),
            lambda: kd.demod_llr_cl_plain(re_t, im_t, hr_c, hi_c, CP, mod, nv14, out_dtype=dt),
            reps=1)
        report[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                            **bound(f_bytes + (4 if dt == torch.float32 else 2) * nrow * N * bps,
                                    f_flops))
        print(f"phase 2 F llr channels-last {str(dt)[6:]} ({S * bps * N}x{B}): max abs diff "
              f"{err:.3g} ({'vs plain, peak ' + format(f_peak, '.3g') if dt == torch.float32 else 'vs the f32 kernel plane'}); "
              f"kernel {ms:.4f} ms, plain {pms:.3f} ms; {of_bound(report[name])}")
    del re_t, im_t, idx_t, cnt, cnt_plain, idx, h, hs_r, hs_i, g_sym, gs_r, gs_i, taps3
    torch.cuda.empty_cache()

    # D: channels-last demod-sum at the headline bench's shape (bench.py's
    # synthetic inputs: noise-like samples, Rayleigh h, 16-QAM at 12 dB).
    gen = torch.Generator(device=dev).manual_seed(seed)
    re_t = torch.randn((S * (N + CP), BD), device=dev, generator=gen) * (1.0 / (2 * N) ** 0.5)
    im_t = torch.randn((S * (N + CP), BD), device=dev, generator=gen) * (1.0 / (2 * N) ** 0.5)
    hr_t = torch.randn((N, BD), device=dev, generator=gen) * 0.5 ** 0.5
    hi_t = torch.randn((N, BD), device=dev, generator=gen) * 0.5 ** 0.5
    tot = kd.demod_sum_cl(re_t, im_t, hr_t, hi_t, CP, mod, nv12)
    tot_plain = kd.demod_sum_cl_plain(re_t, im_t, hr_t, hi_t, CP, mod, nv12)
    d_err = abs(float(tot) - float(tot_plain))
    _check(d_err <= 1e-5 * abs(float(tot_plain)),
           f"kernel D sum {float(tot)!r} vs plain {float(tot_plain)!r}")
    _check(float(kd.demod_sum_cl(re_t, im_t, hr_t, hi_t, CP, mod, nv12)) == float(tot),
           "kernel D is not deterministic")
    ms, pms = compare_times(
        lambda: kd.demod_sum_cl(re_t, im_t, hr_t, hi_t, CP, mod, nv12),
        lambda: kd.demod_sum_cl_plain(re_t, im_t, hr_t, hi_t, CP, mod, nv12),
        reps=2,
    )
    report["demod_sum_cl"] = dict(max_abs_err=d_err, ms=ms, plain_ms=pms,
                                  **bound(8 * BD * S * N + 8 * N * BD + 4,
                                          BD * S * (fft_flops(N) + N * tail_flops(mod))))
    print(f"phase 2 D demod-sum channels-last ({S * (N + CP)}x{BD}): sum {float(tot):.9g}, "
          f"plain {float(tot_plain):.9g}, rel diff {d_err / abs(float(tot_plain)):.3g} (allowed "
          f"1e-5); kernel {ms:.4f} ms, plain {pms:.3f} ms; {of_bound(report['demod_sum_cl'])}")

    # D's sum and F's count in the narrow plan's other shapes, N 128 and
    # 512 (16-QAM, CP N/4, bench-style inputs), at terminal-cl's sample
    # count BD·S·N: each against its plain version and its bound.
    for n_x in (128, 512):
        cp_x, b_x = n_x // 4, BD * N // n_x
        gen_x = torch.Generator(device=dev).manual_seed(seed + n_x)
        x_planes = tuple(torch.randn((S * (n_x + cp_x), b_x), device=dev, generator=gen_x)
                         * (1.0 / (2 * n_x) ** 0.5) for _ in range(2)) + tuple(
            torch.randn((n_x, b_x), device=dev, generator=gen_x) * 0.5 ** 0.5 for _ in range(2))
        x_idx = torch.randint(0, 1 << bps, (S * n_x, b_x), device=dev, generator=gen_x,
                              dtype=torch.int8)
        x_tot = float(kd.demod_sum_cl(*x_planes, cp_x, mod, nv12))
        x_plain = float(kd.demod_sum_cl_plain(*x_planes, cp_x, mod, nv12))
        x_err = abs(x_tot - x_plain)
        _check(x_err <= 1e-5 * abs(x_plain), f"kernel D at N {n_x}: {x_tot!r} vs plain {x_plain!r}")
        _check(float(kd.demod_sum_cl(*x_planes, cp_x, mod, nv12)) == x_tot,
               f"kernel D is not deterministic at N {n_x}")
        ms, pms = compare_times(lambda: kd.demod_sum_cl(*x_planes, cp_x, mod, nv12),
                                lambda: kd.demod_sum_cl_plain(*x_planes, cp_x, mod, nv12), reps=2)
        x_flops = b_x * S * (fft_flops(n_x) + n_x * tail_flops(mod))
        rep_d = dict(max_abs_err=x_err, ms=ms, plain_ms=pms,
                     **bound(8 * b_x * S * n_x + 8 * n_x * b_x + 4, x_flops))
        report["demod_sum_cl"].setdefault("other_n", {})[f"N{n_x}"] = rep_d
        cnt = kd.demod_count_cl(*x_planes, x_idx, cp_x, mod, nv12)
        cnt_plain = kd.demod_count_cl_plain(*x_planes, x_idx, cp_x, mod, nv12)
        margin = torch.zeros_like(cnt)
        hr_rows, hi_rows = x_planes[2].T[:, None, :], x_planes[3].T[:, None, :]
        for s in range(S):
            rows = slice(s * (n_x + cp_x) + cp_x, (s + 1) * (n_x + cp_x))
            margin += count_margin(kc.demod_chain(x_planes[0][rows].T[:, None, :],
                                                  x_planes[1][rows].T[:, None, :], hr_rows,
                                                  hi_rows, 0, mod, nv12)).to(torch.int32)
        diff = (cnt - cnt_plain).abs()
        _check(bool((diff <= margin).all()),
               f"kernel F counts at N {n_x} differ beyond the |LLR| < 1e-3 bits")
        ms, pms = compare_times(
            lambda: kd.demod_count_cl(*x_planes, x_idx, cp_x, mod, nv12),
            lambda: kd.demod_count_cl_plain(*x_planes, x_idx, cp_x, mod, nv12), reps=1)
        rep_f = dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=pms,
                     **bound(8 * b_x * S * n_x + 8 * n_x * b_x + b_x * S * n_x + 4 * b_x,
                             x_flops))
        report["demod_count_cl"].setdefault("other_n", {})[f"N{n_x}"] = rep_f
        print(f"phase 2 D/F narrow plan N {n_x} ({S * (n_x + cp_x)}x{b_x}): D sum {x_tot:.9g}, "
              f"plain {x_plain:.9g}, rel diff {x_err / abs(x_plain):.3g}; kernel "
              f"{rep_d['ms']:.4f} ms, plain {rep_d['plain_ms']:.3f} ms; {of_bound(rep_d)}. F count "
              f"{int(cnt.sum())} errors, plain {int(cnt_plain.sum())}, max per-channel diff "
              f"{int(diff.max())} (allowed {int(margin.max())}); kernel {ms:.4f} ms, plain "
              f"{pms:.3f} ms; {of_bound(rep_f)}")
        del x_planes, x_idx, cnt, cnt_plain, margin, diff
    torch.cuda.empty_cache()

    # G: the one-kernel Monte-Carlo pass against its plain twin, injected
    # then keyed; counts may differ only on bits whose plain |LLR| < 1e-3.
    def link_cfg(model, ebno_db, n_channels=B, n_fft=N, cp=CP, n_symbols=S, modulation=mod,
                 dft_spread=False, **channel):
        return LinkConfig(modulation=modulation, ofdm=OFDMConfig(n_fft=n_fft, cp_len=cp),
                          channel=ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                          n_symbols=n_symbols, n_channels=n_channels, dft_spread=dft_spread)

    def g_bound(cfg, inject):
        """Kernel G's bound for one pass: channel ids in and counts out
        (plus the injected planes); two transforms (four with SC-FDMA:
        spread, IDFT, DFT, despread), the channel, noise and LLR tail per
        tone, and 8·L per tone to build H once from L taps: once per
        channel for static taps, once per symbol for time-varying ones
        (injected H is read, not built). Keyed, the integer multiplies:
        one Philox call per payload sample for the noise (none without
        noise), a quarter for the index, and the fading calls per channel
        (flat 1, Rician 2, static taps L, Jakes 16 paths per tap: drawn
        once per channel, each symbol evaluates them)."""
        n, rows_g = cfg.ofdm.n_fft, cfg.n_channels * cfg.n_symbols
        model = cfg.channel.model
        taps = len(cfg.channel.pdp) if model in (ChannelModel.MULTIPATH,
                                                 ChannelModel.MULTIPATH_TIME) else 0
        n_bytes = 8 * cfg.n_channels
        n_imul = 0.0
        if inject:
            n_bytes += 12 * rows_g * n + 8 * cfg.n_channels * kg.h_syms(cfg) * n
        else:
            noise = PHILOX_IMUL if model != ChannelModel.IDENTITY else 0
            fading = {ChannelModel.RAYLEIGH_FLAT: 1, ChannelModel.RICIAN: 2,
                      ChannelModel.MULTIPATH: taps, ChannelModel.RAYLEIGH_TIME: 16,
                      ChannelModel.MULTIPATH_TIME: 16 * taps}.get(model, 0)
            n_imul = (rows_g * n * (noise + PHILOX_IMUL / 4)
                      + cfg.n_channels * fading * PHILOX_IMUL)
        h_builds = rows_g if model == ChannelModel.MULTIPATH_TIME else cfg.n_channels
        flops = (rows_g * ((4 if cfg.dft_spread else 2) * fft_flops(n)
                           + n * (10 + tail_flops(cfg.modulation)))
                 + h_builds * 8 * (0 if inject else taps) * n)
        return bound(n_bytes, flops, n_imul)

    def coded_llrs(cfg, code, n_cw):
        """The coded link's deinterleaved LLRs (B·n_cw, n) and its info
        bits (B, n_cw, k), built as the engine's staged seam builds them
        (the plain demod on the keyed waveform)."""
        b = cfg.n_channels
        ids_c = ids[:b]
        info = prng.info_bits(seed, ids_c, n_cw, code.k)
        frame = torch.zeros((b, S * N * bps), dtype=torch.int8, device=dev)
        frame[:, :n_cw * code.n] = ldpc_encode(code, info).reshape(b, -1)
        idx_c = fast_coded._frame_to_idx(interleave(frame), bps).reshape(b, S, N)
        del frame
        h_c, _ = fast.fade_state(cfg, seed, ids_c)
        re_c, im_c = fast.tx_with_channel(cfg, seed, ids_c, idx_c, h=h_c)
        hb = h_c.expand(b, 1, N)
        llr = kc.demod_chain(re_c, im_c, hb.real.contiguous(), hb.imag.contiguous(), CP, mod,
                             fast.noise_var(cfg)).reshape(b, -1)
        return deinterleave(llr)[:, :n_cw * code.n].reshape(-1, code.n).contiguous(), info

    def h_bound(code, n_cws, iters):
        """Kernel H's bound: n·4 bytes read and n bytes written per
        codeword; 10 operations per edge per lifted row per iteration."""
        n_e = len(kh.edge_lists(code)[0])
        return bound(n_cws * code.n * 5, n_cws * n_e * code.z * iters * 10.0)

    for label, cfg_g, inject in (
        ("injected RAYLEIGH_FLAT", link_cfg(ChannelModel.RAYLEIGH_FLAT, 12.0), True),
        ("injected MULTIPATH_TIME 3 taps fd 0.02",
         link_cfg(ChannelModel.MULTIPATH_TIME, 12.0, pdp=pdp3, doppler_norm=0.02), True),
        ("keyed AWGN", link_cfg(ChannelModel.AWGN, 10.0), False),
        ("keyed RAYLEIGH_FLAT", link_cfg(ChannelModel.RAYLEIGH_FLAT, 12.0), False),
        ("keyed MULTIPATH 4 taps", link_cfg(ChannelModel.MULTIPATH, 14.0, pdp=pdp4), False),
        ("keyed MULTIPATH_TIME 3 taps fd 0.02",
         link_cfg(ChannelModel.MULTIPATH_TIME, 12.0, pdp=pdp3, doppler_norm=0.02), False),
        ("keyed SC-FDMA AWGN", link_cfg(ChannelModel.AWGN, 10.0, dft_spread=True), False),
        ("keyed config 3 64-QAM MULTIPATH 4 taps 14 dB (N 1024, CP 128)",
         link_cfg(ChannelModel.MULTIPATH, 14.0, n_channels=B // 4, n_fft=1024, cp=128,
                  modulation=Modulation.QAM64, pdp=pdp4), False),
        ("keyed config 5 MULTIPATH 5 taps 14 dB (N 4096, CP 512)",
         link_cfg(ChannelModel.MULTIPATH, 14.0, n_channels=B // 4, n_fft=4096, cp=512,
                  n_symbols=16, pdp=pdp5), False),
    ):
        rand = None
        ids_g = ids[:cfg_g.n_channels]
        shape_g = (cfg_g.n_channels, cfg_g.n_symbols, cfg_g.ofdm.n_fft)
        if inject:
            hs = kg.h_syms(cfg_g)
            rand = (torch.randint(0, 1 << bps, (B, S, N), dtype=torch.int32, device=dev),
                    torch.randn((B, S, N), device=dev), torch.randn((B, S, N), device=dev),
                    torch.randn((B, hs, N), device=dev) * 0.5 ** 0.5,
                    torch.randn((B, hs, N), device=dev) * 0.5 ** 0.5)
        cnt = kg.mc_count(cfg_g, seed, ids_g, rand_inputs=rand)
        llr, idx_g = kg.mc_llr_plain(cfg_g, seed, ids_g, rand_inputs=rand)
        cnt_plain = kc.count_errors(llr, idx_g, cfg_g.modulation.bits_per_symbol)
        margin = count_margin(llr)
        del llr, idx_g
        diff = (cnt - cnt_plain).abs()
        _check(int(cnt_plain.sum()) > 0, f"kernel G {label}: no errors")
        _check(bool((diff <= margin).all()),
               f"kernel G {label}: counts differ beyond the |LLR| < 1e-3 bits")
        ms, pms = compare_times(lambda: kg.mc_count(cfg_g, seed, ids_g, rand_inputs=rand),
                                lambda: kg.mc_count_plain(cfg_g, seed, ids_g, rand_inputs=rand),
                                reps=1)
        bnd = g_bound(cfg_g, inject)
        if label == "keyed AWGN":
            report["mc_count"] = dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=pms, **bnd)
        print(f"phase 2 G mc_count {label} ({'x'.join(map(str, shape_g))}): {int(cnt.sum())} errors, plain "
              f"{int(cnt_plain.sum())}, max per-channel diff {int(diff.max())} (allowed "
              f"{int(margin.max())}); kernel {ms:.3f} ms, plain {pms:.3f} ms; bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), {bnd['bound_ms'] / ms:.3f} of it")
        del cnt, cnt_plain, rand
    torch.cuda.empty_cache()

    # C despread: SC-FDE receive of an SC-FDMA waveform through 4-tap
    # MULTIPATH at config 2, then at config 5's shape (N = 4096, 5 taps).
    for label, cfg_d in (
        (f"config 2 MULTIPATH 4 taps ({B}x{S}x{N + CP})",
         link_cfg(ChannelModel.MULTIPATH, 14.0, pdp=pdp4, dft_spread=True)),
        ("config 5 shape MULTIPATH 5 taps (256x16x4608)",
         link_cfg(ChannelModel.MULTIPATH, 14.0, n_channels=min(256, B), n_fft=4096, cp=512,
                  n_symbols=16, pdp=pdp5, dft_spread=True)),
    ):
        ids_d = ids[:cfg_d.n_channels]
        n_d, cp_d, s_d = cfg_d.ofdm.n_fft, cfg_d.ofdm.cp_len, cfg_d.n_symbols
        nv_d = fast.noise_var(cfg_d)
        idx_d = fast.draw_idx(cfg_d, seed, ids_d)
        re, im = fast.tx_with_channel(cfg_d, seed, ids_d, idx_d)
        h_d, _ = fast.fade_state(cfg_d, seed, ids_d)
        hr_d, hi_d = h_d.real.contiguous(), h_d.imag.contiguous()
        cnt = kc.demod_count(re, im, hr_d, hi_d, idx_d, cp_d, mod, nv_d, despread=True)
        llr = kc.demod_chain(re, im, hr_d, hi_d, cp_d, mod, nv_d, despread=True)
        cnt_plain = kc.count_errors(llr, idx_d, bps)
        margin = count_margin(llr)
        if n_d == N:
            # C's despread LLR plane on the same waveform.
            rows_d = cfg_d.n_channels * s_d
            d_err, d_peak = llr_check(
                "kernel C despread llr",
                kc.demod_llr(re, im, hr_d, hi_d, cp_d, mod, nv_d, despread=True), llr)
            ms, pms = compare_times(
                lambda: kc.demod_llr(re, im, hr_d, hi_d, cp_d, mod, nv_d, despread=True),
                lambda: kc.demod_chain(re, im, hr_d, hi_d, cp_d, mod, nv_d, despread=True),
                reps=1)
            report["demod_llr_despread"] = dict(
                max_abs_err=d_err, ms=ms, plain_ms=pms,
                **bound(8 * rows_d * n_d + 8 * cfg_d.n_channels * n_d
                        + 4 * rows_d * n_d * bps,
                        despread_flops(mod, n_d, rows_d, hr_d.shape[0] * hr_d.shape[1])))
            print(f"phase 2 C despread llr plane {label}: max abs diff {d_err:.3g} (peak "
                  f"{d_peak:.3g}); kernel {ms:.3f} ms, plain {pms:.3f} ms; bound "
                  f"{report['demod_llr_despread']['bound_ms']:.4f} ms")
        del llr
        diff = (cnt - cnt_plain).abs()
        _check(int(cnt_plain.sum()) > 0, f"kernel C despread {label}: no errors")
        _check(bool((diff <= margin).all()),
               f"kernel C despread {label}: counts differ beyond the |LLR| < 1e-3 bits")
        # Twenty calls a turn at config 5's shape: one wave of 256 blocks
        # in a fraction of a millisecond reads unsteadily from one.
        ms, pms = compare_times(
            lambda: kc.demod_count(re, im, hr_d, hi_d, idx_d, cp_d, mod, nv_d, despread=True),
            lambda: kc.demod_count_plain(re, im, hr_d, hi_d, idx_d, cp_d, mod, nv_d,
                                         despread=True), reps=1 if n_d == N else 20)
        rows_d = cfg_d.n_channels * s_d
        bnd = bound(8 * rows_d * n_d + 8 * cfg_d.n_channels * n_d + rows_d * n_d
                    + 4 * cfg_d.n_channels,
                    despread_flops(mod, n_d, rows_d, hr_d.shape[0] * hr_d.shape[1],
                                   count=True))
        if n_d == N:
            report["demod_count_despread"] = dict(max_abs_err=float(diff.max()), ms=ms,
                                                  plain_ms=pms, **bnd)
        print(f"phase 2 C demod+count despread {label}: {int(cnt.sum())} errors, plain "
              f"{int(cnt_plain.sum())}, max per-channel diff {int(diff.max())} (allowed "
              f"{int(margin.max())}); kernel {ms:.3f} ms, plain {pms:.3f} ms; bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        del re, im, cnt, cnt_plain, idx_d, h_d, hr_d, hi_d
    torch.cuda.empty_cache()

    # H: min-sum decode of the coded link's LLRs (config 2, RAYLEIGH_FLAT
    # 6 dB, rate 1/2: 21 codewords per channel), both schedules and both
    # layouts: identical hard bits to the plain version.
    code = ldpc_code_for("1/2")
    cfg_h = coded_cell(B)
    n_cw = ldpc_codewords_per_channel(cfg_h, code)
    llr_h, info_h = coded_llrs(cfg_h, code, n_cw)
    n_cws = B * n_cw
    llr_t = llr_h.T.contiguous()
    for schedule, iters in (("flooding", 25), ("layered", 13)):
        want = kh.ldpc_decode_plain(code, llr_h, iters, 0.5, schedule)
        got = kh.ldpc_decode(code, llr_h, iters, 0.5, schedule)
        n_diff = int((got != want).sum())
        got_t = kh.ldpc_decode(code, llr_t, iters, 0.5, schedule, transposed=True)
        n_diff_t = int((got_t.T != want).sum())
        del got, got_t
        _check(n_diff == 0 and n_diff_t == 0,
               f"kernel H {schedule}: {n_diff} (rows) / {n_diff_t} (transposed) hard bits differ")
        info_err = int((want[:, :code.k].reshape(B, n_cw, code.k) != info_h).sum())
        del want
        ms, pms = compare_times(lambda: kh.ldpc_decode(code, llr_h, iters, 0.5, schedule),
                                lambda: kh.ldpc_decode_plain(code, llr_h, iters, 0.5, schedule),
                                reps=1)
        ms_t, pms_t = compare_times(
            lambda: kh.ldpc_decode(code, llr_t, iters, 0.5, schedule, transposed=True),
            lambda: kh.ldpc_decode_plain(code, llr_t, iters, 0.5, schedule, transposed=True),
            reps=1)
        bnd = h_bound(code, n_cws, iters)
        report[kh.counter_name(schedule, False)] = dict(max_abs_err=float(n_diff), ms=ms,
                                                        plain_ms=pms, **bnd)
        report[kh.counter_name(schedule, True)] = dict(max_abs_err=float(n_diff_t), ms=ms_t,
                                                       plain_ms=pms_t, **bnd)
        print(f"phase 2 H ldpc_minsum {schedule} {iters} iterations ({n_cws} codewords of "
              f"n {code.n}, {len(kh.edge_lists(code)[0])} edges): hard bits identical to plain "
              f"in both layouts ({info_err} info-bit errors); rows "
              f"kernel {ms:.3f} ms, plain {pms:.3f} ms; transposed kernel {ms_t:.3f} ms, plain "
              f"{pms_t:.3f} ms; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
              f"{bnd['bound_ms'] / ms:.4f} (rows) / {bnd['bound_ms'] / ms_t:.4f} (transposed) "
              f"of it")
    del llr_t
    del llr_h, info_h
    torch.cuda.empty_cache()

    # ---- phase 2w: the wideband kernels and modes against their plain versions
    # At phase 3i's shapes: config 3 (64-QAM, N 1024, CP 128) at B × 64, the
    # batch of its links and terminals, with B's modes and C's plane at
    # B/4 × 64, the coded link's; N 2048 (16-QAM, CP 256) and config 5's
    # shape (16-QAM, N 4096, CP 512) at B/2 × 16. Kernel B in every channel
    # mode, C's count, plane and sum (and despread count and plane at each
    # N, on an SC-FDMA waveform, and despread sum at N 4096), the
    # channels-last kernels D and F in their wideband mode (f32 and bf16
    # planes), and C's post-FFT mode. The plain versions that build a whole
    # LLR plane run b_p channels at a time: at B × 64 their temporaries
    # would not fit beside the kernels' outputs.
    wide_report = {}

    def parts_check(label, got, plain, parts, cols=False):
        """``llr_check`` of ``got`` against ``plain(sl)`` over the channel
        slices ``parts`` (rows, or the columns of a channels-last plane)."""
        err = peak = 0.0
        for sl in parts:
            want = plain(sl)
            part = got[:, sl] if cols else got[sl]
            err = max(err, float((part.float() - want).abs().max()))
            peak = max(peak, float(want.abs().max()))
            del want, part
        _check(err <= 1e-4 * peak, f"{label}: max abs diff {err:g} > 1e-4 of the peak {peak:g}")
        return err, peak

    def each(fn, parts):
        """A plain version over the channel slices, outputs dropped (timing)."""
        for sl in parts:
            fn(sl)

    for cfg_name, mod_w, n_w, cp_w, b_w, s_w, b_p in (
        ("config 3", Modulation.QAM64, 1024, 128, B, 64, B // 4),
        ("N 2048", Modulation.QAM16, 2048, 256, B // 2, 16, B // 2),
        ("config 5", Modulation.QAM16, 4096, 512, B // 2, 16, B // 2),
    ):
        bps_w = mod_w.bits_per_symbol
        parts = [slice(c, c + b_p) for c in range(0, b_w, b_p)]
        ids_w = ids[:b_w]
        rows_w, rows_p = b_w * s_w, b_p * s_w
        tag = f"{cfg_name} ({b_w}x{s_w}x{n_w + cp_w})"
        tag_p = f"{cfg_name} ({b_p}x{s_w}x{n_w + cp_w})"
        nv_w = 1.0 / (10.0 ** 1.4 * bps_w)  # 14 dB
        tvar_w = nv_w / n_w
        idx_w = ka.payload_idx(s_w, n_w, bps_w, seed, ids_w)
        idx_p = idx_w[:b_p]
        shape_p = (b_p, s_w, n_w + cp_w)
        g_w = chan.rayleigh_flat(seed, ids_w[:b_p])[:, 0, 0]
        gw_r, gw_i = g_w.real.contiguous(), g_w.imag.contiguous()
        gs_w = chan.jakes_gains(seed, ids_w[:b_p], s_w, 0.02)
        taps_w = chan.multipath_taps(seed, ids_w, pdp5)  # (b_w, 5)
        tw_r, tw_i = taps_w.real.contiguous(), taps_w.imag.contiguous()
        got = kb.tx_chain(idx_p, cp_w, mod_w)
        off_err = plane_err(got, kb.tx_channel_plain(idx_p, cp_w, mod_w))
        _check(off_err <= 1e-5 * plane_peak(got), f"kernel B {tag_p} channel off: {off_err:g}")
        del got
        ms, pms = compare_times(lambda: kb.tx_chain(idx_p, cp_w, mod_w),
                                lambda: kb.tx_channel_plain(idx_p, cp_w, mod_w), reps=1)
        ib = idx_w.element_size()
        off = b_timed("channel off", "tx_off", n_w, cp_w, b_p, s_w, ib, ms, pms, 0, 0, False)
        print(f"phase 2w B tx channel off {tag_p}: max abs diff {off_err:.3g}; kernel {ms:.3f} ms, "
              f"plain {pms:.3f} ms, {of_bound(off)}")
        # (label, channel, counter, the channel's bytes, f32 operations a sample)
        b_modes = (
            ("flat gains", dict(hs_r=gw_r, hs_i=gw_i), "tx", 8 * b_p, 10),
            ("per-symbol gains", dict(hs_r=gs_w.real.contiguous(), hs_i=gs_w.imag.contiguous()),
             None, 8 * rows_p, 10),
            ("FIR 5 taps (config 5's PDP)", dict(taps_r=tw_r[:b_p], taps_i=tw_i[:b_p]), "tx_taps",
             40 * b_p, 8 * 5 + 4),
        )
        for label, kw, name, chan_bytes, ops in b_modes:
            rep = check_modes(f"B tx+{label} {tag_p}",
                              lambda **k: kb.tx_channel(idx_p, cp_w, mod_w, noise_var=tvar_w,
                                                        **kw, **k),
                              lambda **k: kb.tx_channel_plain(idx_p, cp_w, mod_w,
                                                              noise_var=tvar_w, **kw, **k),
                              shape_p)
            rep.update(b_timed(f"{label}, keyed", name or "tx", n_w, cp_w, b_p, s_w, ib,
                               rep["ms"], rep["plain_ms"], chan_bytes, ops, True))
            if name:
                wide_report[(name, n_w)] = rep
        if b_w > b_p:
            # The flat and FIR modes at the link's batch (phase 3i's b_w x s_w),
            # held against the plain version channel slice by slice.
            g_all = chan.rayleigh_flat(seed, ids_w)[:, 0, 0]
            for label, kw, name, chan_bytes, ops in (
                ("flat gains", dict(hs_r=g_all.real.contiguous(), hs_i=g_all.imag.contiguous()),
                 "tx", 8 * b_w, 10),
                ("FIR 5 taps (config 5's PDP)", dict(taps_r=tw_r, taps_i=tw_i), "tx_taps",
                 40 * b_w, 8 * 5 + 4),
            ):
                def b_kernel():
                    return kb.tx_channel(idx_w, cp_w, mod_w, noise_var=tvar_w, seed=seed,
                                         ch_ids=ids_w, **kw)

                def b_plain(sl):
                    return kb.tx_channel_plain(idx_w[sl], cp_w, mod_w, noise_var=tvar_w,
                                               seed=seed, ch_ids=ids_w[sl],
                                               **{k: v[sl] for k, v in kw.items()})

                got = b_kernel()
                err = peak = 0.0
                for sl in parts:
                    want = b_plain(sl)
                    err = max(err, plane_err([g[sl] for g in got], want))
                    peak = max(peak, plane_peak(want))
                    del want
                _check(err <= 1e-5 * peak, f"kernel B {tag} {label}: max abs diff {err:g}")
                del got
                ms, pms = compare_times(b_kernel, lambda: each(b_plain, parts), reps=2)
                link = b_timed(f"{label}, keyed", name, n_w, cp_w, b_w, s_w, ib, ms, pms,
                               chan_bytes, ops, True)
                wide_report[(name, n_w)]["link_batch"] = dict(link, max_abs_err=err,
                                                              shape=f"{b_w}x{s_w}x{n_w + cp_w}")
                print(f"phase 2w B tx+{label} {tag} (the link's batch): max abs diff keyed "
                      f"{err:.3g} (peak {peak:.3g}); kernel {ms:.3f} ms, plain {pms:.3f} ms "
                      f"(in {len(parts)} channel slices); {of_bound(link)}")
                torch.cuda.empty_cache()
        # The FIR waveform (keyed noise) at b_w channels through C, F and the
        # post-FFT mode.
        re, im = kb.tx_channel(idx_w, cp_w, mod_w, noise_var=tvar_w, seed=seed, ch_ids=ids_w,
                               taps_r=tw_r, taps_i=tw_i)
        h_w = fast.rx_plane(taps_w, n_w)  # (b_w, 1, N)
        hr_w, hi_w = h_w.real.contiguous(), h_w.imag.contiguous()
        del h_w
        def c_count_and_plane(re, im, hr, hi, idx, nv, channel, despread=False):
            """C's count at the b_w channels and its plane at the first b_p
            (the coded link's batch), against the plain versions channel
            slice by slice; returns the plain counts and their margins."""
            kw = dict(despread=True) if despread else {}
            mode, suffix = ("despread ", "_despread") if despread else ("", "")
            cnt = kc.demod_count(re, im, hr, hi, idx, cp_w, mod_w, nv, **kw)
            cnt_plain, margin, llr_p = [], [], None
            for sl in parts:
                llr = kc.demod_chain(re[sl], im[sl], hr[sl], hi[sl], cp_w, mod_w, nv, **kw)
                cnt_plain.append(kc.count_errors(llr, idx[sl], bps_w))
                margin.append(count_margin(llr))
                if llr_p is None:
                    llr_p = llr  # the first b_p channels, for the plane below
                del llr
            cnt_plain, margin = torch.cat(cnt_plain), torch.cat(margin)
            diff = (cnt - cnt_plain).abs()
            _check(int(cnt_plain.sum()) > 0 and bool((diff <= margin).all()),
                   f"kernel C {mode}{tag}: counts differ beyond the |LLR| < 1e-3 bits")
            ms, pms = compare_times(
                lambda: kc.demod_count(re, im, hr, hi, idx, cp_w, mod_w, nv, **kw),
                lambda: each(lambda sl: kc.demod_count_plain(re[sl], im[sl], hr[sl], hi[sl],
                                                             idx[sl], cp_w, mod_w, nv, **kw),
                             parts),
                reps=1)
            # f32 operations: the transform and the tone tail, or the
            # despread's two transforms, its weighting and its tail.
            def ops(rows, count):
                if despread:
                    return despread_flops(mod_w, n_w, rows, rows // s_w * hr.shape[1], count)
                return rows * (fft_flops(n_w) + n_w * tail_flops(mod_w))

            wide_report[("demod_count" + suffix, n_w)] = dict(
                max_abs_err=float(diff.max()), ms=ms, plain_ms=pms,
                **bound(8 * rows_w * n_w + 8 * b_w * n_w + rows_w * n_w * idx.element_size()
                        + 4 * b_w, ops(rows_w, True)))
            print(f"phase 2w C demod+count {mode}{tag} ({channel}): {int(cnt.sum())} errors, "
                  f"plain {int(cnt_plain.sum())}, max per-channel diff {int(diff.max())} "
                  f"(allowed {int(margin.max())}); kernel {ms:.3f} ms, plain {pms:.3f} ms")
            re_p, im_p, hr_p, hi_p = re[:b_p], im[:b_p], hr[:b_p], hi[:b_p]
            c_err, c_peak = llr_check(
                f"kernel C {mode}llr {tag_p}",
                kc.demod_llr(re_p, im_p, hr_p, hi_p, cp_w, mod_w, nv, **kw), llr_p)
            del llr_p
            ms, pms = compare_times(
                lambda: kc.demod_llr(re_p, im_p, hr_p, hi_p, cp_w, mod_w, nv, **kw),
                lambda: kc.demod_chain(re_p, im_p, hr_p, hi_p, cp_w, mod_w, nv, **kw), reps=1)
            wide_report[("demod_llr" + suffix, n_w)] = dict(
                max_abs_err=c_err, ms=ms, plain_ms=pms,
                **bound(8 * rows_p * n_w + 8 * b_p * n_w + 4 * rows_p * n_w * bps_w,
                        ops(rows_p, False)))
            print(f"phase 2w C {mode}llr plane {tag_p}: max abs diff {c_err:.3g} (peak "
                  f"{c_peak:.3g}); kernel {ms:.3f} ms, plain {pms:.3f} ms")
            return cnt_plain, margin

        cnt_plain, margin = c_count_and_plane(re, im, hr_w, hi_w, idx_w, nv_w,
                                              "MULTIPATH 5 taps, 14 dB")
        c_in = 8 * rows_w * n_w + 8 * b_w * n_w
        c_flops_w = rows_w * (fft_flops(n_w) + n_w * tail_flops(mod_w))
        # C's post-FFT mode on the same waveform's frequency-domain grid, in
        # the layout the hybrid route passes: the FFT's complex64 output read
        # in place (torch.view_as_real, yi None). The planar build, on copies
        # of the first slice's grid, gives the same bits.
        y_w = torch.view_as_real(torch.fft.fft(torch.complex(re, im)[..., cp_w:]))

        def llr_chain_part(sl, **kw):
            return kc.llr_chain_plain(y_w[sl], None, hr_w[sl], hi_w[sl], mod_w, nv_w, **kw)

        got = kc.llr_chain(y_w, None, hr_w, hi_w, mod_w, nv_w)
        l_err, l_peak = parts_check(f"kernel C llr_chain {tag}", got, llr_chain_part, parts)
        sl = parts[0]
        _check(torch.equal(kc.llr_chain(y_w[sl][..., 0].contiguous(), y_w[sl][..., 1].contiguous(),
                                        hr_w[sl], hi_w[sl], mod_w, nv_w), got[sl]),
               f"kernel C llr_chain {tag}: the planar and interleaved builds differ")
        del got
        ms, pms = compare_times(lambda: kc.llr_chain(y_w, None, hr_w, hi_w, mod_w, nv_w),
                                lambda: each(llr_chain_part, parts), reps=1, kernel_reps=10)
        plane_bytes = 4 * rows_w * n_w * bps_w
        wide_report[("llr_chain", n_w)] = dict(
            max_abs_err=l_err, ms=ms, plain_ms=pms,
            **chain_bound(b_w, s_w, n_w, 1, mod_w, False))
        print(f"phase 2w C llr_chain (post-FFT) {tag}: max abs diff {l_err:.3g} (peak "
              f"{l_peak:.3g}); kernel {ms:.4f} ms, plain {pms:.3f} ms; "
              f"{of_bound(wide_report[('llr_chain', n_w)])}")
        # F (count, LLR plane f32 / bf16) on the same waveform, channels-last.
        wre_t, wim_t = fast._to_cl(re, im)
        del re, im, y_w
        torch.cuda.empty_cache()
        whr_t, whi_t = hr_w[:, 0, :].T.contiguous(), hi_w[:, 0, :].T.contiguous()
        widx_t = idx_w.permute(1, 2, 0).reshape(s_w * n_w, b_w).contiguous()
        planes = (wre_t, wim_t, whr_t, whi_t)
        cnt_f = kd.demod_count_cl(*planes, widx_t, cp_w, mod_w, nv_w)
        diff = (cnt_f - cnt_plain).abs()
        _check(bool((diff <= margin).all()),
               f"kernel F {tag}: counts differ beyond the |LLR| < 1e-3 bits")
        ms, pms = compare_times(
            lambda: kd.demod_count_cl(*planes, widx_t, cp_w, mod_w, nv_w),
            lambda: kd.demod_count_cl_plain(*planes, widx_t, cp_w, mod_w, nv_w), reps=1)
        wide_report[("demod_count_cl", n_w)] = dict(
            max_abs_err=float(diff.max()), ms=ms, plain_ms=pms,
            **bound(c_in + rows_w * n_w + 4 * b_w, c_flops_w))
        print(f"phase 2w F demod+count channels-last {tag}: {int(cnt_f.sum())} errors, plain "
              f"{int(cnt_plain.sum())}, max per-channel diff {int(diff.max())} (allowed "
              f"{int(margin.max())}); kernel {ms:.3f} ms, plain {pms:.3f} ms")
        del cnt_f, cnt_plain, margin

        def llr_cl_part(sl, out_dtype=torch.float32):
            return kd.demod_llr_cl_plain(*(p[:, sl] for p in planes), cp_w, mod_w, nv_w,
                                         out_dtype=out_dtype)

        got = kd.demod_llr_cl(*planes, cp_w, mod_w, nv_w)
        f_err, f_peak = parts_check(f"kernel F llr {tag}", got, llr_cl_part, parts, cols=True)
        half = kd.demod_llr_cl(*planes, cp_w, mod_w, nv_w, out_dtype=torch.bfloat16)
        h_err = 0.0
        for sl in parts:
            g, h = got[:, sl], half[:, sl].float()
            big = g.abs() >= 1e-3
            _check(torch.equal((h < 0)[big], (g < 0)[big]),
                   f"kernel F bf16 {tag}: signs differ from f32 where |LLR| >= 1e-3")
            h_err = max(h_err, float((h - g).abs().max()))
            del g, h, big
        del got, half
        for name, dt, err in (("demod_llr_cl", torch.float32, f_err),
                              ("demod_llr_cl_bf16", torch.bfloat16, h_err)):
            ms, pms = compare_times(
                lambda: kd.demod_llr_cl(*planes, cp_w, mod_w, nv_w, out_dtype=dt),
                lambda: each(lambda sl: llr_cl_part(sl, dt), parts), reps=1)
            wide_report[(name, n_w)] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms,
                **bound(c_in + plane_bytes // (1 if dt == torch.float32 else 2), c_flops_w))
            vs = f"vs plain, peak {f_peak:.3g}" if dt == torch.float32 else "vs the f32 plane"
            print(f"phase 2w F llr channels-last {str(dt)[6:]} {tag}: max abs diff {err:.3g} "
                  f"({vs}); kernel {ms:.3f} ms, plain {pms:.3f} ms")
        del planes, wre_t, wim_t, widx_t, idx_w, idx_p
        torch.cuda.empty_cache()
        # C's despread (SC-FDE) count and plane on an SC-FDMA waveform
        # through config 5's PDP at 14 dB.
        cfg_s = link_cfg(ChannelModel.MULTIPATH, 14.0, n_channels=b_w, n_fft=n_w, cp=cp_w,
                         n_symbols=s_w, modulation=mod_w, pdp=pdp5, dft_spread=True)
        idx_s = fast.draw_idx(cfg_s, seed, ids_w)
        re, im = fast.tx_with_channel(cfg_s, seed, ids_w, idx_s)
        h_s, _ = fast.fade_state(cfg_s, seed, ids_w)
        c_count_and_plane(re, im, h_s.real.contiguous(), h_s.imag.contiguous(), idx_s,
                          fast.noise_var(cfg_s), "SC-FDMA, MULTIPATH 5 taps, 14 dB",
                          despread=True)
        del re, im, h_s, idx_s
        torch.cuda.empty_cache()
        # Sums on bench.py-style inputs (noise-like samples, Rayleigh h per
        # link), whose LLR sum does not cancel: C's sum (and its despread
        # form at N 4096), D's channels-last sum and the post-FFT sum,
        # within 1e-5 relative of the plain sums and the same bits twice.
        gen_w = torch.Generator(device=dev).manual_seed(seed + n_w)
        br, bi = (torch.randn((b_w, s_w, n_w + cp_w), device=dev, generator=gen_w)
                  * (1.0 / (2 * n_w) ** 0.5) for _ in range(2))
        bhr, bhi = (torch.randn((b_w, 1, n_w), device=dev, generator=gen_w) * 0.5 ** 0.5
                    for _ in range(2))
        br_t, bi_t = fast._to_cl(br, bi)
        bhr_t, bhi_t = bhr[:, 0, :].T.contiguous(), bhi[:, 0, :].T.contiguous()
        by = torch.view_as_real(torch.fft.fft(torch.complex(br, bi)[..., cp_w:]))

        def plain_sum(fn):
            return lambda: sum(float(fn(sl)) for sl in parts)

        def c_sum_part(sl, despread=False):
            return kc.demod_chain(br[sl], bi[sl], bhr[sl], bhi[sl], cp_w, mod_w, nv_w,
                                  reduce_sum=True, despread=despread)

        sums = [
            ("demod_sum", lambda: kc.demod_llr(br, bi, bhr, bhi, cp_w, mod_w, nv_w,
                                               reduce_sum=True),
             plain_sum(c_sum_part), bound(c_in + 4, c_flops_w)),
            ("demod_sum_cl", lambda: kd.demod_sum_cl(br_t, bi_t, bhr_t, bhi_t, cp_w, mod_w, nv_w),
             lambda: kd.demod_sum_cl_plain(br_t, bi_t, bhr_t, bhi_t, cp_w, mod_w, nv_w),
             bound(c_in + 4, c_flops_w)),
            ("llr_chain_sum", lambda: kc.llr_chain(by, None, bhr, bhi, mod_w, nv_w,
                                                   reduce_sum=True),
             plain_sum(lambda sl: kc.llr_chain_plain(by[sl], None, bhr[sl], bhi[sl], mod_w,
                                                     nv_w, reduce_sum=True)),
             chain_bound(b_w, s_w, n_w, 1, mod_w, True)),
        ]
        if n_w == 4096:
            sums.append(("demod_sum_despread",
                         lambda: kc.demod_llr(br, bi, bhr, bhi, cp_w, mod_w, nv_w,
                                              reduce_sum=True, despread=True),
                         plain_sum(lambda sl: c_sum_part(sl, despread=True)),
                         bound(c_in + 4, despread_flops(mod_w, n_w, rows_w, b_w))))
        got_sums = {}
        for name, kfn, pfn, bnd in sums:
            tot_k, tot_p = float(kfn()), float(pfn())
            got_sums[name] = tot_k
            s_err = abs(tot_k - tot_p)
            _check(s_err <= 1e-5 * abs(tot_p), f"{name} {tag}: {tot_k!r} vs plain {tot_p!r}")
            _check(float(kfn()) == tot_k, f"{name} {tag} is not deterministic")
            # #19's sum, under a millisecond at N 2048 and 4096: ten calls a turn.
            ms, pms = compare_times(kfn, pfn, reps=1,
                                    kernel_reps=10 if name == "llr_chain_sum" else None)
            wide_report[(name, n_w)] = dict(max_abs_err=s_err, ms=ms, plain_ms=pms, **bnd)
            print(f"phase 2w {name} {tag}: {tot_k:.9g}, plain {tot_p:.9g}, rel diff "
                  f"{s_err / abs(tot_p):.3g} (allowed 1e-5), deterministic; kernel {ms:.4f} ms, "
                  f"plain {pms:.3f} ms; {of_bound(wide_report[(name, n_w)])}")
        # The post-FFT sum of the planar build: the same bits as the
        # interleaved one's.
        _check(float(kc.llr_chain(by[..., 0].contiguous(), by[..., 1].contiguous(), bhr, bhi,
                                  mod_w, nv_w, reduce_sum=True))
               == got_sums["llr_chain_sum"],
               f"llr_chain_sum {tag}: the planar and interleaved builds differ")
        del br, bi, bhr, bhi, br_t, bi_t, bhr_t, bhi_t, by
        torch.cuda.empty_cache()
        # K1 (D/F's wideband form) against C on the same tones, and each
        # mode's share of its bound. C's plane ran on b_p channels: its
        # ratio is per channel.
        rep_n = {name: wide_report[(name, n_w)] for name in (
            "demod_sum_cl", "demod_count_cl", "demod_llr_cl", "demod_llr_cl_bf16", "demod_sum",
            "demod_count", "demod_llr")}
        per_ch = (rep_n["demod_llr_cl"]["ms"] / b_w) / (rep_n["demod_llr"]["ms"] / b_p)
        shares = ", ".join(f"{label} {rep_n[name]['bound_ms'] / rep_n[name]['ms']:.4f}"
                           for label, name in (("sum", "demod_sum_cl"), ("count", "demod_count_cl"),
                                               ("plane f32", "demod_llr_cl"),
                                               ("plane bf16", "demod_llr_cl_bf16")))
        c_shares = ", ".join(f"{label} {rep_n[name]['ms']:.4f} ms, "
                             f"{rep_n[name]['bound_ms'] / rep_n[name]['ms']:.4f}"
                             for label, name in (("count", "demod_count"), ("sum", "demod_sum"),
                                                 ("plane", "demod_llr")))
        print(f"phase 2w K1 {tag}: K1/C sum "
              f"{rep_n['demod_sum_cl']['ms'] / rep_n['demod_sum']['ms']:.4f}, count "
              f"{rep_n['demod_count_cl']['ms'] / rep_n['demod_count']['ms']:.4f} (F's count "
              f"{rep_n['demod_count_cl']['ms']:.4f} ms, C's {rep_n['demod_count']['ms']:.4f} ms "
              f"on the same tones), plane f32 "
              f"{per_ch:.4f} (per channel, C on {b_p}); share of bound {shares}; C "
              f"({c_form('demod_count', n_w)['form']}) {c_shares}")

    # ---- phase 2t: kernel #20, C's TP stage-2 mode, against its plain version
    # At the shapes the TP path runs: config 5 split over 4 ranks (rows of
    # n2 = 1024, 256 x 64 per rank, h per link) and one rank (n2 = 4096,
    # h per link and per symbol), and over 8 ranks (n2 = 512), 16-QAM; the
    # noise variance a device tensor; the warp-group form (n2 >= 128). The
    # rows have the TP path's scale: variance 1/n2 per
    # sample, so that the n2-point transform gives the unit-energy grid
    # H·X + N the equaliser sees on a link (14 dB). Within 1e-4 of the
    # peak, equal signs where |LLR| >= 1e-3.
    gen_t = torch.Generator(device=dev).manual_seed(seed + 20)
    nv_t = torch.tensor(1.0 / (10.0 ** 1.4 * bps), dtype=torch.float32, device=dev)
    tp_report = {}
    for label, n2, h_syms in (("n2=1024", 1024, 1), ("n2=4096", 4096, 1),
                              ("n2=4096 h per symbol", 4096, S), ("n2=512", 512, 1)):
        b_t = B // 32  # 256 at B = 8192: config 5's 256 channels
        tr, ti = (torch.randn((b_t, S, 1, n2), device=dev, generator=gen_t) * (0.5 / n2) ** 0.5
                  for _ in range(2))
        thr, thi = (torch.randn((b_t, h_syms, 1, n2), device=dev, generator=gen_t) * 0.5 ** 0.5
                    for _ in range(2))
        got = kc.tp_stage2_llr(tr, ti, thr, thi, nv_t, mod)
        want = kc.stage2_llr_plain(tr, ti, thr, thi, nv_t, mod)
        t_err, t_peak = llr_check(f"kernel C tp_stage2_llr {label}", got, want)
        big = want.abs() >= 1e-3
        _check(torch.equal((got < 0)[big], (want < 0)[big]),
               f"kernel C tp_stage2_llr {label}: signs differ where |LLR| >= 1e-3")
        del got, want, big
        ms, pms = compare_times(lambda: kc.tp_stage2_llr(tr, ti, thr, thi, nv_t, mod),
                                lambda: kc.stage2_llr_plain(tr, ti, thr, thi, nv_t, mod), reps=10)
        rows_t = b_t * S
        bnd = bound(8 * rows_t * n2 + 8 * b_t * h_syms * n2 + 4 * rows_t * n2 * bps + 4,
                    rows_t * (fft_flops(n2) + n2 * tail_flops(mod)))
        tp_report[label] = dict(max_abs_err=t_err, ms=ms, plain_ms=pms, **bnd)
        print(f"phase 2t C tp_stage2_llr {label} ({b_t}x{S}x1x{n2}, h_syms {h_syms}; "
              f"{c_form('tp_stage2_llr', n2)['form']}): max abs diff {t_err:.3g} (peak "
              f"{t_peak:.3g}, allowed 1e-4 of it), signs equal; kernel {ms:.4f} ms, plain "
              f"{pms:.3f} ms; {of_bound(tp_report[label])}")
        del tr, ti, thr, thi
    report["tp_stage2_llr"] = tp_report["n2=1024"]
    torch.cuda.empty_cache()

    # ---- phase 2b: kernels D and F on bf16 sample planes ---------------------
    # Against their plain versions on the same bf16 planes (D at the bench's
    # 32768 x 64, F's count and plane at 8192 x 64 on bench-style inputs).
    gen_b = torch.Generator(device=dev).manual_seed(seed + 21)
    bf_re, bf_im = ((torch.randn((S * (N + CP), BD), device=dev, generator=gen_b)
                     * (1.0 / (2 * N) ** 0.5)).to(torch.bfloat16) for _ in range(2))
    bf_hr, bf_hi = (torch.randn((N, BD), device=dev, generator=gen_b) * 0.5 ** 0.5
                    for _ in range(2))
    tot_k = float(kd.demod_sum_cl(bf_re, bf_im, bf_hr, bf_hi, CP, mod, nv12))
    tot_p = float(kd.demod_sum_cl_plain(bf_re, bf_im, bf_hr, bf_hi, CP, mod, nv12))
    b_err = abs(tot_k - tot_p)
    _check(b_err <= 1e-5 * abs(tot_p), f"kernel D bf16 in: sum {tot_k!r} vs plain {tot_p!r}")
    ms, pms = compare_times(lambda: kd.demod_sum_cl(bf_re, bf_im, bf_hr, bf_hi, CP, mod, nv12),
                            lambda: kd.demod_sum_cl_plain(bf_re, bf_im, bf_hr, bf_hi, CP, mod,
                                                          nv12), reps=2)
    report["demod_sum_cl_in_bf16"] = dict(
        max_abs_err=b_err, ms=ms, plain_ms=pms,
        **bound(4 * BD * S * N + 8 * N * BD + 4,
                BD * S * (fft_flops(N) + N * tail_flops(mod))))
    print(f"phase 2b D demod-sum channels-last bf16 in ({S * (N + CP)}x{BD}): sum {tot_k:.9g}, "
          f"plain {tot_p:.9g}, rel diff {b_err / abs(tot_p):.3g} (allowed 1e-5); kernel "
          f"{ms:.4f} ms, plain {pms:.3f} ms; {of_bound(report['demod_sum_cl_in_bf16'])} (f32 in: "
          f"kernel {report['demod_sum_cl']['ms']:.4f} ms, bound "
          f"{report['demod_sum_cl']['bound_ms']:.4f} ms)")
    bf_re, bf_im = ((torch.randn((S * (N + CP), B), device=dev, generator=gen_b)
                     * (1.0 / (2 * N) ** 0.5)).to(torch.bfloat16) for _ in range(2))
    bf_hr, bf_hi = (torch.randn((N, B), device=dev, generator=gen_b) * 0.5 ** 0.5
                    for _ in range(2))
    bf_idx = torch.randint(0, 1 << bps, (S * N, B), device=dev, generator=gen_b,
                           dtype=torch.int8)
    plane_p = kd.demod_llr_cl_plain(bf_re, bf_im, bf_hr, bf_hi, CP, mod, nv12)
    cnt = kd.demod_count_cl(bf_re, bf_im, bf_hr, bf_hi, bf_idx, CP, mod, nv12)
    cnt_p = kd.demod_count_cl_plain(bf_re, bf_im, bf_hr, bf_hi, bf_idx, CP, mod, nv12)
    margin = (plane_p.abs() < 1e-3).sum(dim=0)
    diff = (cnt - cnt_p).abs()
    _check(bool((diff <= margin).all()), "kernel F bf16 in: counts differ beyond the margin")
    ms, pms = compare_times(
        lambda: kd.demod_count_cl(bf_re, bf_im, bf_hr, bf_hi, bf_idx, CP, mod, nv12),
        lambda: kd.demod_count_cl_plain(bf_re, bf_im, bf_hr, bf_hi, bf_idx, CP, mod, nv12),
        reps=1)
    report["demod_count_cl_in_bf16"] = dict(
        max_abs_err=float(diff.max()), ms=ms, plain_ms=pms,
        **bound(4 * nrow * N + 8 * N * B + nrow * N + 4 * B,
                nrow * (fft_flops(N) + N * tail_flops(mod))))
    print(f"phase 2b F demod+count channels-last bf16 in ({S * (N + CP)}x{B}): "
          f"{int(cnt.sum())} errors, plain {int(cnt_p.sum())}, max per-channel diff "
          f"{int(diff.max())} (allowed {int(margin.max())}); kernel {ms:.4f} ms, plain "
          f"{pms:.3f} ms; {of_bound(report['demod_count_cl_in_bf16'])}")
    got = kd.demod_llr_cl(bf_re, bf_im, bf_hr, bf_hi, CP, mod, nv12)
    l_err, l_peak = llr_check("kernel F llr bf16 in", got, plane_p)
    half = kd.demod_llr_cl(bf_re, bf_im, bf_hr, bf_hi, CP, mod, nv12, out_dtype=torch.bfloat16)
    big = plane_p.abs() >= 1e-3
    _check(torch.equal((half.float() < 0)[big], (plane_p < 0)[big]),
           "kernel F bf16 in, bf16 out: signs differ where |LLR| >= 1e-3")
    _check(float(((half.float() - got).abs() - got.abs() * 2.0 ** -8).max()) <= 0.0,
           "kernel F bf16 in, bf16 out: not the f32 plane rounded")
    h_err = float((half.float() - got).abs().max())
    del got, half, big, plane_p
    for name, dt, err in (("demod_llr_cl_in_bf16", torch.float32, l_err),
                          ("demod_llr_cl_bf16_in_bf16", torch.bfloat16, h_err)):
        ms, pms = compare_times(
            lambda: kd.demod_llr_cl(bf_re, bf_im, bf_hr, bf_hi, CP, mod, nv12, out_dtype=dt),
            lambda: kd.demod_llr_cl_plain(bf_re, bf_im, bf_hr, bf_hi, CP, mod, nv12,
                                          out_dtype=dt), reps=1)
        report[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms,
            **bound(4 * nrow * N + 8 * N * B + (4 if dt == torch.float32 else 2) * nrow * N * bps,
                    nrow * (fft_flops(N) + N * tail_flops(mod))))
        vs = f"vs plain, peak {l_peak:.3g}" if dt == torch.float32 else "vs the f32 kernel plane"
        print(f"phase 2b F llr channels-last bf16 in, {str(dt)[6:]} out ({S * bps * N}x{B}): "
              f"max abs diff {err:.3g} ({vs}); kernel {ms:.4f} ms, plain {pms:.3f} ms; "
              f"{of_bound(report[name])}")
    del bf_re, bf_im, bf_hr, bf_hi, bf_idx, cnt, cnt_p
    torch.cuda.empty_cache()

    # The BER gate of bf16 input (the JAX gate, docs/PERF.md:538-553, and
    # scripts/gate_cl.py's construction): identical synthetic links (per-tone
    # Rayleigh H, AWGN in the frequency domain, time plane = IFFT + CP),
    # counted through ``demod_count_chain_cl`` on the f32 planes and on the
    # same planes rounded to bf16. The counters are zeroed just before: this
    # is the bf16 path's window (F's count and plane on bf16 planes).
    _lib.reset_launches()
    b_g = B // 4  # 2048 links of 64 symbols at B = 8192
    gates = []
    for mod_g, ebno_g, limit in ((Modulation.QAM16, 8.0, 0.005), (Modulation.QAM16, 14.0, 0.005),
                                 (Modulation.QAM64, 18.0, 0.005),
                                 (Modulation.QAM1024, 30.0, 0.101)):
        bps_g = mod_g.bits_per_symbol
        gen_g = torch.Generator(device=dev).manual_seed(seed + 22)
        idx_g = torch.randint(0, 1 << bps_g, (b_g, S, N), device=dev, generator=gen_g)
        hg = torch.complex(*(torch.randn((b_g, 1, N), device=dev, generator=gen_g) * 0.5 ** 0.5
                             for _ in range(2)))
        nv_g = 1.0 / (10.0 ** (ebno_g / 10.0) * bps_g)
        y = constellation(mod_g, dev)[idx_g] * hg + torch.complex(
            *(torch.randn((b_g, S, N), device=dev, generator=gen_g) for _ in range(2))) * (
            (nv_g / 2) ** 0.5)
        xt = torch.fft.ifft(y, dim=-1)
        del y
        xt = torch.cat([xt[..., N - CP:], xt], dim=-1)
        g_re, g_im = fast._to_cl(xt.real.contiguous(), xt.imag.contiguous())
        del xt
        g_hr, g_hi = hg[:, 0, :].real.T.contiguous(), hg[:, 0, :].imag.T.contiguous()
        g_idx = idx_g.permute(1, 2, 0).reshape(S * N, b_g).to(
            torch.int8 if bps_g <= 7 else torch.int16).contiguous()
        del idx_g, hg
        e_f32 = int(demod_count_chain_cl(g_re, g_im, g_hr, g_hi, g_idx, CP, mod_g, nv_g).sum())
        e_bf16 = int(demod_count_chain_cl(g_re.to(torch.bfloat16), g_im.to(torch.bfloat16), g_hr,
                                          g_hi, g_idx, CP, mod_g, nv_g).sum())
        for out_g in (torch.float32, torch.bfloat16):
            plane_bf = demod_llr_chain_cl(g_re[:, :64].to(torch.bfloat16).contiguous(),
                                          g_im[:, :64].to(torch.bfloat16).contiguous(),
                                          g_hr[:, :64].contiguous(), g_hi[:, :64].contiguous(),
                                          CP, mod_g, nv_g, out_dtype=out_g)
            _check(bool(torch.isfinite(plane_bf).all()), "bf16-in LLR plane not finite")
        del g_re, g_im, g_hr, g_hi, g_idx, plane_bf
        delta = (e_bf16 - e_f32) / max(e_f32, 1)
        bits_g = b_g * S * N * bps_g
        gates.append((mod_g, ebno_g, e_f32, e_bf16, delta, limit))
        print(f"phase 2b BER gate {mod_g.value} {ebno_g:g} dB ({b_g}x{S}, N {N}): f32 in "
              f"{e_f32} errors (BER {e_f32 / bits_g:.4e}), bf16 in {e_bf16} ({delta * 100:+.3f} "
              f"%, allowed {limit * 100:.1f} %)")
        _check(abs(delta) <= limit, f"bf16 BER gate {mod_g.value} {ebno_g:g} dB: {delta:+.4%}")
    launches_bf16 = dict(_lib.LAUNCHES)  # phase 2b's gate: the bf16-input path
    torch.cuda.empty_cache()

    # ---- phase 3: the slice, counters zeroed just before ------------------
    _lib.reset_launches()

    def run_link(model, ebno_db, n_channels=B, ch=None, layout="auto", **channel):
        cfg = link_cfg(model, ebno_db, n_channels, **channel)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if ch is None:
            errors, counted = fast.fast_simulate(cfg, seed, device=dev, layout=layout)
        else:
            errors, counted = fast.fast_core(cfg, seed, ch, layout=layout)
        torch.cuda.synchronize()
        return errors, counted, time.perf_counter() - t

    fast.fast_simulate(LinkConfig(modulation=mod, ofdm=OFDMConfig(N, CP), n_symbols=S,
                                  n_channels=128), seed, device=dev)  # warm-up
    errors, counted, t_awgn = run_link(ChannelModel.AWGN, 10.0)
    ber = int(errors.sum()) / int(counted.sum())
    th = ber_awgn_exact(mod, 10.0)
    _check(abs(ber / th - 1) <= 0.05, f"AWGN BER {ber:g} vs theory {th:g}")
    half = B // 2
    part, _, _ = run_link(ChannelModel.AWGN, 10.0, ch=ids[:half])
    _check(torch.equal(part, errors[:half]), "split run differs from the full run")
    errors_r, counted_r, t_ray = run_link(ChannelModel.RAYLEIGH_FLAT, 12.0)
    ber_r = int(errors_r.sum()) / int(counted_r.sum())
    th_r = ber_rayleigh_exact(mod, 12.0)
    _check(abs(ber_r / th_r - 1) <= 0.10, f"Rayleigh BER {ber_r:g} vs theory {th_r:g}")
    samples = B * S * (N + CP)
    print(f"phase 3 fast_simulate {B}x{S} config 2: AWGN 10 dB BER {ber:.6g} (theory {th:.6g}, "
          f"{int(counted.sum())} bits) in {t_awgn * 1e3:.1f} ms; Rayleigh 12 dB BER {ber_r:.6g} "
          f"(theory {th_r:.6g}) in {t_ray * 1e3:.1f} ms; split [0, {half}) == full; "
          f"{samples / t_awgn / 1e9:.3f} GS/s end to end (AWGN) on {card}")
    del part

    # ---- phase 3b: selective and time-varying channels -------------------
    for label, model, ebno_db, channel in (
        ("MULTIPATH config-4 PDP (4 taps)", ChannelModel.MULTIPATH, 14.0, dict(pdp=pdp4)),
        ("RAYLEIGH_TIME doppler 0.02", ChannelModel.RAYLEIGH_TIME, 12.0,
         dict(doppler_norm=0.02)),
        ("MULTIPATH_TIME PDP (1, .5, .25) doppler 0.02", ChannelModel.MULTIPATH_TIME, 12.0,
         dict(pdp=pdp3, doppler_norm=0.02)),
        ("MULTIPATH 24 taps 0.8^l (staged route)", ChannelModel.MULTIPATH, 14.0,
         dict(pdp=pdp24)),
    ):
        run_link(model, ebno_db, **channel)  # warm-up at full size: the time below is warm
        errors_s, counted_s, t_s = run_link(model, ebno_db, **channel)
        ber_s = int(errors_s.sum()) / int(counted_s.sum())
        h_s, _ = fast.fade_state(link_cfg(model, ebno_db, **channel), seed, ids)
        want = ber_given_gain(mod, ebno_db, (h_s.abs() ** 2).to(torch.float64))
        del h_s
        _check(abs(ber_s / want - 1) <= 0.02,
               f"{label}: BER {ber_s:g} vs {want:g} over the drawn channel")
        extra = ""
        if model == ChannelModel.MULTIPATH_TIME:
            part, _, _ = run_link(model, ebno_db, ch=ids[:half], **channel)
            _check(torch.equal(part, errors_s[:half]), f"{label}: split run differs from full")
            extra = f"; split [0, {half}) == full"
        print(f"phase 3b fast_simulate {B}x{S} config 2 {label} at {ebno_db:g} dB: BER "
              f"{ber_s:.6g}, over the drawn channel {want:.6g} "
              f"(ratio {ber_s / want:.5f}; Rayleigh theory {ber_rayleigh_exact(mod, ebno_db):.6g})"
              f" in {t_s * 1e3:.1f} ms{extra}")
    del errors_s, counted_s

    # ---- phase 3c: the channels-last layout against rows ---------------------
    for label, model, ebno_db, rows_errors, th_c, tol in (
        ("AWGN 10 dB", ChannelModel.AWGN, 10.0, errors, th, 0.05),
        ("RAYLEIGH_FLAT 12 dB", ChannelModel.RAYLEIGH_FLAT, 12.0, errors_r, th_r, 0.10),
    ):
        errors_c, counted_c, _ = run_link(model, ebno_db, layout="cl")
        ber_c = int(errors_c.sum()) / int(counted_c.sum())
        _check(abs(ber_c / th_c - 1) <= tol, f"cl {label} BER {ber_c:g} vs theory {th_c:g}")
        cfg_c = link_cfg(model, ebno_db)
        re, im = fast.tx_channel_core(cfg_c, seed, ids)
        h_c, _ = fast.fade_state(cfg_c, seed, ids)
        hb = torch.ones((B, 1, 1), dtype=torch.complex64, device=dev) if h_c is None else h_c
        hb = hb.expand(B, 1, N)
        llr = kc.demod_chain(re, im, hb.real, hb.imag, CP, mod, fast.noise_var(cfg_c))
        margin = count_margin(llr)
        del llr, re, im
        diff = (errors_c - rows_errors).abs()
        _check(bool((diff <= margin).all()), f"cl {label}: counts differ from rows beyond margin")
        times = {"rows": [], "cl": []}
        for layout in ("rows", "cl", "cl", "rows", "rows", "cl"):
            times[layout].append(run_link(model, ebno_db, layout=layout)[2])
        t_rows, t_cl = sorted(times["rows"])[1], sorted(times["cl"])[1]
        print(f"phase 3c layout='cl' {B}x{S} config 2 {label}: BER {ber_c:.6g} (theory "
              f"{th_c:.6g}); per-channel counts vs rows max diff {int(diff.max())} (allowed "
              f"{int(margin.max())}); end to end rows {t_rows * 1e3:.3f} ms, cl "
              f"{t_cl * 1e3:.3f} ms (median of 3 each, in turns) on {card}")
    del errors, counted, errors_r, counted_r, errors_c
    torch.cuda.empty_cache()

    # ---- phase 4: the headline terminal at the bench's shape ----------------
    perm = torch.as_tensor(kd.dif_perm(N), device=dev)
    hr_d = hr_t[perm].contiguous()
    hi_d = hi_t[perm].contiguous()
    val = demod_sum_chain_cl(re_t, im_t, hr_d, hi_d, CP, mod, nv12, h_in_dif_order=True)
    _check(torch.isfinite(val).item() and float(val) == float(tot),
           "terminal with DIF-ordered h differs from natural order")
    iters = 10
    ms_term = timed(lambda: demod_sum_chain_cl(re_t, im_t, hr_d, hi_d, CP, mod, nv12,
                                               h_in_dif_order=True), iters)
    rate = S * (N + CP) * BD / (ms_term * 1e-3)
    print(f"phase 4 demod_sum_chain_cl {BD}x{S} f32: {ms_term:.4f} ms per call, "
          f"{rate / 1e9:.3f} GS/s ({rate:.6g} samples/s), share "
          f"{report['demod_sum_cl']['bound_ms'] / ms_term:.4f} of D's bound on {card}")
    # The same terminal on the bf16 planes (the JAX bench's default input),
    # timed in turns with f32 (f32, bf16, bf16, f32).
    re_h, im_h = re_t.to(torch.bfloat16), im_t.to(torch.bfloat16)
    val_h = demod_sum_chain_cl(re_h, im_h, hr_d, hi_d, CP, mod, nv12, h_in_dif_order=True)
    _check(math.isfinite(float(val_h)), "terminal on bf16 planes: non-finite sum")
    ms_h, ms_f = compare_times(
        lambda: demod_sum_chain_cl(re_h, im_h, hr_d, hi_d, CP, mod, nv12, h_in_dif_order=True),
        lambda: demod_sum_chain_cl(re_t, im_t, hr_d, hi_d, CP, mod, nv12, h_in_dif_order=True),
        reps=iters)
    rate_h = S * (N + CP) * BD / (ms_h * 1e-3)
    print(f"phase 4 demod_sum_chain_cl {BD}x{S} bf16 in: {ms_h:.4f} ms per call, "
          f"{rate_h / 1e9:.3f} GS/s, share "
          f"{report['demod_sum_cl_in_bf16']['bound_ms'] / ms_h:.4f} of its bound; f32 in the "
          f"same turns {ms_f:.4f} ms; sum {float(val_h):.9g} (f32 {float(tot):.9g}) on {card}")
    del re_h, im_h

    launches = dict(_lib.LAUNCHES)  # phases 3-4: the fast engine and the terminal
    del re_t, im_t, hr_t, hi_t, hr_d, hi_d
    torch.cuda.empty_cache()

    # ---- phase 3d: the Monte-Carlo engine, counters zeroed just before -------
    _lib.reset_launches()
    n_pass = 4

    def run_mc(cfg, iters=n_pass):
        torch.cuda.synchronize()
        t = time.perf_counter()
        errors, counted = mc.mc_simulate(cfg, seed, iters=iters, device=dev)
        torch.cuda.synchronize()
        return errors, counted, time.perf_counter() - t

    def ber_of(errors, counted):
        return int(errors.sum(dtype=torch.int64)) / int(counted.sum(dtype=torch.int64))

    def drawn_ber(cfg, iters=n_pass):
        """Exact BER over the channels the passes drew (fade_state on each
        pass's seed: kernel G keys its fading as the fast engine does)."""
        ids_c = ids[:cfg.n_channels] if cfg.n_channels <= B else torch.arange(
            cfg.n_channels, dtype=torch.int32, device=dev)
        total = 0.0
        for i in range(iters):
            h_i, _ = fast.fade_state(cfg, mc.pass_seed(seed, i), ids_c)
            total += ber_given_gain(mod, cfg.channel.ebno_db, (h_i.abs() ** 2).to(torch.float64))
            del h_i
        return total / iters

    run_mc(link_cfg(ChannelModel.AWGN, 8.0), iters=1)  # warm-up
    mc_rate = None
    for label, cfg_m, exact in (
        ("AWGN 8 dB", link_cfg(ChannelModel.AWGN, 8.0), True),
        ("RAYLEIGH_FLAT 20 dB", link_cfg(ChannelModel.RAYLEIGH_FLAT, 20.0), False),
        ("RAYLEIGH_TIME 15 dB fd 0.02",
         link_cfg(ChannelModel.RAYLEIGH_TIME, 15.0, doppler_norm=0.02), False),
        ("MULTIPATH 4 taps 14 dB", link_cfg(ChannelModel.MULTIPATH, 14.0, pdp=pdp4), False),
        ("MULTIPATH_TIME 3 taps fd 0.02 12 dB",
         link_cfg(ChannelModel.MULTIPATH_TIME, 12.0, pdp=pdp3, doppler_norm=0.02), False),
    ):
        errors, counted, t_m = run_mc(cfg_m)
        ber_m = ber_of(errors, counted)
        want = ber_awgn_exact(mod, cfg_m.channel.ebno_db) if exact else drawn_ber(cfg_m)
        tol = 0.01 if exact else 0.02
        _check(abs(ber_m / want - 1) <= tol,
               f"mc_simulate {label}: BER {ber_m:g} vs {want:g} ({'theory' if exact else 'drawn'})")
        rate_m = B * S * N * n_pass / t_m
        mc_rate = mc_rate or rate_m
        extra = ""
        if cfg_m.channel.model != ChannelModel.RAYLEIGH_TIME:
            # Pass 0 is fast_simulate on the same seed, through other float
            # paths: per channel equal but for bits with plain |LLR| < 1e-3,
            # over the whole batch; totals within 1e-5 relative. Below 8192
            # channels (the CPU rehearsal) 1e-5 of the total is less than
            # one bit, so there the total may differ by the batch's count
            # of such bits.
            e0, _, _ = run_mc(cfg_m, iters=1)
            ef, _ = fast.fast_simulate(cfg_m, seed, device=dev)
            tot0, totf = int(e0.sum(dtype=torch.int64)), int(ef.sum(dtype=torch.int64))
            llr, _ = kg.mc_llr_plain(cfg_m, seed, ids)
            margin = count_margin(llr)
            del llr
            d0 = (e0 - ef).abs()
            allowed = 1e-5 * totf
            if B < 8192:
                allowed = max(allowed, int(margin.sum(dtype=torch.int64)))
            _check(abs(tot0 - totf) <= allowed,
                   f"mc_simulate {label}: pass 0 total {tot0} vs fast_simulate {totf}")
            _check(bool((d0 <= margin).all()),
                   f"mc_simulate {label}: pass 0 differs from fast_simulate beyond the margin")
            extra = (f"; pass 0 vs fast_simulate: totals {tot0} / {totf} (rel diff "
                     f"{abs(tot0 - totf) / totf:.3g}, allowed {allowed:g}), per channel max diff "
                     f"{int(d0.max())} (allowed {int(margin.max())})")
            del e0, ef, margin
        bnd_m = g_bound(cfg_m, False)["bound_ms"] * n_pass
        print(f"phase 3d mc_simulate {B}x{S}x{n_pass} passes config 2 {label}: BER {ber_m:.6g}, "
              f"{'exact theory' if exact else 'over the drawn channel'} {want:.6g} (ratio "
              f"{ber_m / want:.5f}) in {t_m * 1e3:.3f} ms = {rate_m / 1e9:.3f} GS/s (CP excluded),"
              f" bound {bnd_m:.4f} ms ({bnd_m / (t_m * 1e3):.3f} of it){extra} on {card}")
    # The fast engine warm at the same batch (phase 3's AWGN call is its
    # first at full size and carries the allocator's growth).
    t_fast = sorted(run_link(ChannelModel.AWGN, 8.0)[2] for _ in range(3))[1]
    fast_rate = B * S * N / t_fast
    first_rate = B * S * N / t_awgn
    print(f"phase 3d MC vs fast engine at {B}x{S} config 2: mc_simulate {mc_rate / 1e9:.3f} GS/s, "
          f"fast_simulate AWGN {fast_rate / 1e9:.3f} GS/s ({t_fast * 1e3:.3f} ms, median of 3 "
          f"warm calls), both counting N samples per symbol; ratio {mc_rate / fast_rate:.3f}; "
          f"against phase 3's first full-size AWGN call ({first_rate / 1e9:.3f} GS/s, the "
          f"earlier yardstick) {mc_rate / first_rate:.3f}")
    cfg_big = link_cfg(ChannelModel.AWGN, 8.0, n_channels=4 * B)
    run_mc(cfg_big, iters=1)
    errors, counted, t_big = run_mc(cfg_big)
    ber_big = ber_of(errors, counted)
    _check(abs(ber_big / ber_awgn_exact(mod, 8.0) - 1) <= 0.01,
           f"mc_simulate at {4 * B} channels: BER {ber_big:g}")
    print(f"phase 3d mc_simulate {4 * B}x{S}x{n_pass} passes AWGN 8 dB: BER {ber_big:.6g} in "
          f"{t_big * 1e3:.3f} ms = {4 * B * S * N * n_pass / t_big / 1e9:.3f} GS/s on {card}")

    # ---- phase 3e: wideband and SC-FDMA ------------------------------------------
    # Config 5 at 4096 channels (B/2: the CPU rehearsal runs smaller).
    cfg5 = link_cfg(ChannelModel.MULTIPATH, 14.0, n_channels=B // 2, n_fft=4096, cp=512,
                    n_symbols=16, pdp=pdp5)
    run_mc(cfg5, iters=1)
    errors, counted, t5 = run_mc(cfg5)
    ber5, want5 = ber_of(errors, counted), drawn_ber(cfg5)
    _check(abs(ber5 / want5 - 1) <= 0.02, f"mc_simulate config 5: BER {ber5:g} vs {want5:g}")
    bnd5 = g_bound(cfg5, False)["bound_ms"] * n_pass
    print(f"phase 3e mc_simulate config 5 (N 4096, CP 512, MULTIPATH 5 taps, 14 dB) "
          f"{B // 2}x16x{n_pass} passes: BER {ber5:.6g}, over the drawn channel {want5:.6g} "
          f"(ratio {ber5 / want5:.5f}) in {t5 * 1e3:.3f} ms = "
          f"{B // 2 * 16 * 4096 * n_pass / t5 / 1e9:.3f} GS/s, bound {bnd5:.4f} ms "
          f"({bnd5 / (t5 * 1e3):.3f} of it) on {card}")
    cfg5s = link_cfg(ChannelModel.AWGN, 8.0, n_channels=B // 2, n_fft=4096, cp=512, n_symbols=16,
                     dft_spread=True)
    errors, counted, t5s = run_mc(cfg5s, iters=2)
    ber5s, th8 = ber_of(errors, counted), ber_awgn_exact(mod, 8.0)
    _check(abs(ber5s / th8 - 1) <= 0.02, f"mc_simulate SC-FDMA N 4096: BER {ber5s:g} vs {th8:g}")
    print(f"phase 3e mc_simulate SC-FDMA N 4096 AWGN 8 dB {B // 2}x16x2 passes (fast engine + C "
          f"despread): BER {ber5s:.6g}, theory {th8:.6g} (ratio {ber5s / th8:.5f}) in "
          f"{t5s * 1e3:.3f} ms")
    cfg_sc = link_cfg(ChannelModel.AWGN, 10.0, dft_spread=True)
    fast.fast_simulate(cfg_sc, seed, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    errors, counted = fast.fast_simulate(cfg_sc, seed, device=dev)
    torch.cuda.synchronize()
    t_sc = time.perf_counter() - t
    ber_sc = ber_of(errors, counted)
    _check(abs(ber_sc / th - 1) <= 0.02, f"fast_simulate SC-FDMA: BER {ber_sc:g} vs {th:g}")
    print(f"phase 3e fast_simulate SC-FDMA {B}x{S} config 2 AWGN 10 dB: BER {ber_sc:.6g}, theory "
          f"{th:.6g} (ratio {ber_sc / th:.5f}) in {t_sc * 1e3:.3f} ms")
    del errors, counted
    torch.cuda.empty_cache()

    # ---- phase 3f: the Eb/N0 sweep on the MC engine --------------------------------
    grid = [float(e) for e in range(0, 21, 2)]
    # max_bits 2e9 at B = 8192 (scaled with B for the CPU rehearsal).
    sweep_kw = dict(seed=seed, target_errors=100_000, max_bits=2_000_000_000 * B // 8192,
                    device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "sweep.json")
        n_before = _lib.LAUNCHES["mc_count"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ebno_sweep(link_cfg(ChannelModel.AWGN, 0.0), grid, checkpoint_path=ck,
                         engine="mc", mc_iters=1, **sweep_kw)
        t_sw = time.perf_counter() - t
        for pt, th_pt in zip(res.points, res.theory(mod)):
            gated = pt.bit_errors >= 10_000
            _check(not gated or abs(pt.ber / th_pt - 1) <= 0.03,
                   f"sweep {pt.ebno_db} dB: BER {pt.ber:g} vs theory {th_pt:g}")
            print(f"phase 3f sweep mc {pt.ebno_db:4.1f} dB: BER {pt.ber:.6g} theory {th_pt:.6g} "
                  f"({pt.bit_errors} errors / {pt.bits_counted} bits, {pt.batches} invocations"
                  f"{'' if gated else ', not gated: < 1e4 errors'})")
        n_g = _lib.LAUNCHES["mc_count"]
        again = ebno_sweep(link_cfg(ChannelModel.AWGN, 0.0), grid, checkpoint_path=ck,
                           engine="mc", mc_iters=1, **sweep_kw)
        _check(again.points == res.points and _lib.LAUNCHES["mc_count"] == n_g,
               "the resumed sweep differs or launched kernel G")
    print(f"phase 3f sweep config 2 grid 0-20 dB step 2, {B}x{S} per invocation: "
          f"{n_g - n_before} launches of G in {t_sw:.3f} s; resumed from its checkpoint: same "
          f"points, 0 launches")
    for label, cfg_p, engine, th_p in (
        (f"config 3 (64-QAM, N 1024, CP 128) 12 dB {B // 4}x32",
         link_cfg(ChannelModel.AWGN, 12.0, n_channels=B // 4, n_fft=1024, cp=128, n_symbols=32,
                  modulation=Modulation.QAM64), "mc", ber_awgn_exact(Modulation.QAM64, 12.0)),
        (f"config 2 10 dB {B}x{S}", link_cfg(ChannelModel.AWGN, 10.0), "fast", th),
    ):
        pt = ebno_sweep(cfg_p, [cfg_p.channel.ebno_db], engine=engine, mc_iters=1,
                        **sweep_kw).points[0]
        _check(abs(pt.ber / th_p - 1) <= 0.03, f"sweep {label}: BER {pt.ber:g} vs {th_p:g}")
        print(f"phase 3f sweep {engine} {label}: BER {pt.ber:.6g}, theory {th_p:.6g} "
              f"({pt.bit_errors} errors, {pt.batches} invocations)")

    launches_mc = dict(_lib.LAUNCHES)  # phases 3d-3f: the Monte-Carlo engine and the sweep

    # ---- phase 3g: the coded engine, counters zeroed just before -------------
    _lib.reset_launches()

    def run_coded(cfg, ch=None, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if ch is None:
            errors, counted = fast_coded.ldpc_fast_simulate(cfg, seed, device=dev, **kw)
        else:
            errors, counted = fast_coded.ldpc_fast_core(cfg, seed, ch, **kw)
        torch.cuda.synchronize()
        return errors, counted, time.perf_counter() - t

    @contextlib.contextmanager
    def plain_kernels():
        """Every kernel wrapper on the coded engine's path swapped for its
        plain version (the module attributes the engine calls through),
        restored on exit."""
        def llr_cl_plain(re_t, im_t, hr_t, hi_t, cp_len, mod_, nv, out_dtype=torch.float32,
                         h_in_dif_order=False):
            return kd.demod_llr_cl_plain(re_t, im_t, *kd.h_natural(hr_t, hi_t, h_in_dif_order),
                                         cp_len, mod_, nv, out_dtype)

        swaps = [(kb, "tx_channel", kb.tx_channel_plain),
                 (kb, "tx_chain", lambda idx_, cp_len, mod_: kb.tx_channel_plain(idx_, cp_len,
                                                                                  mod_)),
                 (fast, "fade_awgn", ke.fade_awgn_plain), (kc, "demod_llr", kc.demod_chain),
                 (kd, "demod_llr_cl", llr_cl_plain), (kh, "ldpc_decode", kh.ldpc_decode_plain)]
        saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
        for m, name, fn in swaps:
            setattr(m, name, fn)
        try:
            yield
        finally:
            for m, name, fn in saved:
                setattr(m, name, fn)

    @contextlib.contextmanager
    def decoder_io(calls):
        """Record each call of the decoder wrapper the engine calls
        through (kernel H, or its plain version inside plain_kernels): its
        input LLRs, its hard bits and its arguments, in the decoder's
        layout; restored on exit."""
        inner = kh.ldpc_decode

        def recording(code_, llr, *args, **kwargs):
            out = inner(code_, llr, *args, **kwargs)
            calls.append((llr.clone(), out, args, kwargs))
            return out

        kh.ldpc_decode = recording
        try:
            yield
        finally:
            kh.ldpc_decode = inner

    def ber_of_run(errors, counted):
        return int(errors.sum(dtype=torch.int64)) / int(counted.sum(dtype=torch.int64))

    code = ldpc_code_for("1/2")
    info_per_call = B * n_cw * code.k
    fast_coded.ldpc_fast_simulate(coded_cell(128), seed, device=dev)  # warm-up
    cfg_c6 = coded_cell(B)
    variants = list(CODED_VARIANTS)
    for seam, schedule, iters in variants:  # warm-up at full size: the times below are warm
        run_coded(cfg_c6, seam=seam, schedule=schedule, iters=iters)
    coded_runs = {v: [] for v in variants}
    for rep in range(3):
        for v in (variants if rep % 2 == 0 else variants[::-1]):
            coded_runs[v].append(run_coded(cfg_c6, seam=v[0], schedule=v[1], iters=v[2]))
    coded_ms = {}
    for v in variants:
        errors, counted, _ = coded_runs[v][0]
        for e2, _, _ in coded_runs[v][1:]:
            _check(torch.equal(e2, errors), f"coded {v}: repeated runs differ")
        t_c = sorted(r[2] for r in coded_runs[v])[1]
        coded_ms[v] = t_c * 1e3
        print(f"phase 3g ldpc_fast_simulate {B}x{S} config 2 rate 1/2 RAYLEIGH_FLAT 6 dB "
              f"seam={v[0]} {v[1]} {v[2]} iterations: {t_c * 1e3:.3f} ms per call (median of 3, "
              f"in turns), {info_per_call / t_c / 1e6:.3f} Mb/s info; info BER "
              f"{ber_of_run(errors, counted):.6g} ({int(errors.sum())} errors of "
              f"{int(counted.sum(dtype=torch.int64))}) on {card}")
    e_f = int(coded_runs[("staged", "flooding", 25)][0][0].sum())
    e_l = int(coded_runs[("staged", "layered", 13)][0][0].sum())
    _check(e_f > 0 and abs(e_l - e_f) <= 0.3 * e_f,
           f"layered 13 iterations {e_l} info-bit errors vs flooding 25 {e_f} (> 30 %)")
    # The same gate in AWGN at 1.8 dB, on the code's waterfall (where the
    # schedules, not the deep fades, decide which codewords fail).
    cfg_w = link_cfg(ChannelModel.AWGN, 1.8)
    e_wf = int(run_coded(cfg_w, seam="staged")[0].sum())
    e_wl = int(run_coded(cfg_w, seam="staged", schedule="layered", iters=13)[0].sum())
    _check(e_wf > 0 and abs(e_wl - e_wf) <= 0.3 * e_wf,
           f"AWGN 1.8 dB: layered 13 iterations {e_wl} info-bit errors vs flooding 25 {e_wf}")
    print(f"phase 3g gate: layered 13 iterations vs flooding 25, info-bit errors: RAYLEIGH_FLAT "
          f"6 dB {e_l} / {e_f} (ratio {e_l / e_f:.4f}), AWGN 1.8 dB {e_wl} / {e_wf} (ratio "
          f"{e_wl / e_wf:.4f}); allowed 0.7-1.3")
    for rate in ("2/3", "3/4"):
        run_coded(cfg_c6, rate=rate, seam="staged")
        errors, counted, t_r = run_coded(cfg_c6, rate=rate, seam="staged")
        k_r = ldpc_code_for(rate).k
        n_r = ldpc_codewords_per_channel(cfg_c6, ldpc_code_for(rate))
        print(f"phase 3g ldpc_fast_simulate rate {rate} seam=staged flooding 25: "
              f"{t_r * 1e3:.3f} ms per call, {B * n_r * k_r / t_r / 1e6:.3f} Mb/s info; info BER "
              f"{ber_of_run(errors, counted):.6g}")
    cfg_c9 = link_cfg(ChannelModel.RAYLEIGH_FLAT, 9.0)
    e_s9, c9, _ = run_coded(cfg_c9, seam="staged")
    e_f9, _, _ = run_coded(cfg_c9, seam="fused")
    ds, dfu = int(e_s9.sum()), int(e_f9.sum())
    _check(0 < ds and abs(ds - dfu) <= max(8, ds // 100),
           f"seams disagree at RAYLEIGH_FLAT 9 dB: staged {ds}, fused {dfu}")
    cfg_a6 = link_cfg(ChannelModel.AWGN, 6.0)
    e_c, c_c, _ = run_coded(cfg_a6)
    e_u, c_u = fast.fast_simulate(cfg_a6, seed, device=dev)
    ber_c, ber_u = ber_of_run(e_c, c_c), ber_of_run(e_u, c_u)
    _check(ber_c < ber_u / 3, f"coded BER {ber_c:g} not below uncoded {ber_u:g} / 3 at AWGN 6 dB")
    half = B // 2
    e_full, _, _ = run_coded(cfg_c6)
    e_part, _, _ = run_coded(cfg_c6, ch=ids[:half])
    _check(torch.equal(e_part, e_full[:half]), "coded: channels [0, B/2) alone differ from full")
    print(f"phase 3g gates: seams at RAYLEIGH_FLAT 9 dB staged {ds} / fused {dfu} info-bit errors "
          f"(allowed diff {max(8, ds // 100)}); AWGN 6 dB coded BER {ber_c:.6g} vs uncoded "
          f"{ber_u:.6g} (< 1/3 of it); split [0, {half}) == full (seam auto)")
    # The engine against itself with every kernel swapped for its plain
    # version, held at the decoder's seam: its input LLRs within C's / F's
    # tolerance (every kernel before H, the gathers and the encoder); H's
    # hard bits equal to the plain decoder's on that same input; then,
    # codeword by codeword, info bits decoded differently only in
    # codewords that hold a plain |LLR| < 1e-3; totals within max(8, 0.1 %).
    n_p = min(512, B)
    cfg_p = coded_cell(n_p)
    for seam in ("staged", "fused"):
        io_k, io_p = [], []
        with decoder_io(io_k):
            e_k, _ = fast_coded.ldpc_fast_simulate(cfg_p, seed, seam=seam, device=dev)
        before = dict(_lib.LAUNCHES)
        with plain_kernels(), decoder_io(io_p):
            e_p, _ = fast_coded.ldpc_fast_simulate(cfg_p, seed, seam=seam, device=dev)
        _check(dict(_lib.LAUNCHES) == before, "the plain engine launched a kernel")
        _check(len(io_k) == 1 and len(io_p) == 1, f"coded {seam}: one decoder call expected")
        (llr_k, hard_k, args, kwargs), (llr_p, hard_p, _, _) = io_k[0], io_p[0]
        peak = float(llr_p.abs().max())
        llr_err = float((llr_k - llr_p).abs().max())
        _check(llr_err <= 1e-4 * peak,
               f"coded {seam}: decoder input {llr_err:g} from plain (peak {peak:g})")
        _check(torch.equal(hard_k, kh.ldpc_decode_plain(code, llr_k, *args, **kwargs)),
               f"coded {seam}: kernel H differs from the plain decoder on the engine's LLRs")
        pos = 0 if kwargs.get("transposed", False) else 1  # the axis of a codeword's n bits
        info_k, info_p = (h.narrow(pos, 0, code.k) for h in (hard_k, hard_p))
        differs = (info_k != info_p).any(dim=pos)
        near = (llr_p.abs() < 1e-3).any(dim=pos)
        n_far = int((differs & ~near).sum())
        _check(n_far == 0, f"coded {seam}: {n_far} codewords with no near-zero LLR decode "
                           f"differently from plain")
        tot_k, tot_p = int(e_k.sum()), int(e_p.sum())
        _check(abs(tot_k - tot_p) <= max(8, tot_p // 1000),
               f"coded {seam}: info-bit errors {tot_k} vs plain {tot_p}")
        print(f"phase 3g gate: the engine with every kernel swapped for its plain version, "
              f"{n_p} channels, seam={seam}: decoder input max abs diff {llr_err:.3g} (peak "
              f"{peak:.4g}, allowed 1e-4 of it); H on it equal to plain; {int(differs.sum())} of "
              f"{differs.numel()} codewords decode differently, each holding a plain |LLR| < 1e-3 "
              f"({int(near.sum())} hold one); totals {tot_k} / {tot_p} info-bit errors (allowed "
              f"diff {max(8, tot_p // 1000)})")
        del io_k, io_p, llr_k, llr_p, hard_k, hard_p, info_k, info_p
    del e_full, e_part, e_c, e_u
    torch.cuda.empty_cache()
    launches_coded = dict(_lib.LAUNCHES)  # phase 3g: the coded engine

    # ---- phase 3h: the LLR-plane terminals a user calls, counters zeroed -----
    _lib.reset_launches()
    gen_t = torch.Generator(device=dev).manual_seed(seed + 2)
    tr, ti = (torch.randn((B, S, N + CP), device=dev, generator=gen_t) * (1.0 / (2 * N) ** 0.5)
              for _ in range(2))
    thr, thi = (torch.randn((B, 1, N), device=dev, generator=gen_t) * 0.5 ** 0.5 for _ in range(2))
    tr_t, ti_t = fast._to_cl(tr, ti)
    thr_t, thi_t = thr[:, 0, :].T.contiguous(), thi[:, 0, :].T.contiguous()
    terminals = [
        ("demod_llr_chain_cl f32, kernel order",
         lambda: demod_llr_chain_cl(tr_t, ti_t, thr_t, thi_t, CP, mod, nv10, kernel_order=True)),
        ("demod_llr_chain_cl bf16, kernel order",
         lambda: demod_llr_chain_cl(tr_t, ti_t, thr_t, thi_t, CP, mod, nv10,
                                    out_dtype=torch.bfloat16, kernel_order=True)),
        ("demod_chain llr plane", lambda: demod_chain(tr, ti, thr, thi, CP, mod, nv10)),
        ("demod_chain sum", lambda: demod_chain(tr, ti, thr, thi, CP, mod, nv10, reduce_sum=True)),
        ("demod_chain despread llr plane",
         lambda: demod_chain(tr, ti, thr, thi, CP, mod, nv10, despread=True)),
        ("demod_chain despread sum",
         lambda: demod_chain(tr, ti, thr, thi, CP, mod, nv10, reduce_sum=True, despread=True)),
        ("demod_chain_hybrid plane", lambda: demod_chain_hybrid(tr, ti, thr, thi, CP, mod, nv10)),
        ("demod_chain_hybrid sum",
         lambda: demod_chain_hybrid(tr, ti, thr, thi, CP, mod, nv10, reduce_sum=True)),
    ]
    for label, fn in terminals:
        out = fn()
        _check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite output")
        del out
        ms_t = timed(fn, 5)
        print(f"phase 3h {label} ({B}x{S}x{N + CP} f32 in): {ms_t:.3f} ms per call, "
              f"{B * S * (N + CP) / (ms_t * 1e-3) / 1e9:.3f} GS/s on {card}")
    del tr, ti, thr, thi, tr_t, ti_t, thr_t, thi_t
    torch.cuda.empty_cache()

    # ---- counters and result ------------------------------------------------
    launches_terminals = dict(_lib.LAUNCHES)  # phase 3h: the LLR-plane terminals

    # ---- phase 3i: the wideband link (configs 3 and 5), counters zeroed ------
    # Each main-path call runs inside ``at_n(N)``: the counters are zeroed
    # on entry and added to N's window on exit. The reference work between
    # those calls (the plain margins and sums) is in no window.
    launches_at = {n: dict.fromkeys(_lib.LAUNCHES, 0) for n in (1024, 2048, 4096)}

    @contextlib.contextmanager
    def at_n(n):
        _lib.reset_launches()
        yield
        for k, v in _lib.LAUNCHES.items():
            launches_at[n][k] += v

    mod3 = Modulation.QAM64
    w3 = dict(n_fft=1024, cp=128, modulation=mod3)  # config 3, 64 symbols
    w5 = dict(n_fft=4096, cp=512, n_symbols=16, modulation=mod)  # config 5's shape

    def rows_margin(cfg, ch, chunk=1024):
        """Per-channel count of bits whose plain |LLR| < 1e-3 on the rows
        waveform of ``cfg`` (plain demod in chunks of channels)."""
        re_m, im_m = fast.tx_channel_core(cfg, seed, ch)
        h_m, _ = fast.fade_state(cfg, seed, ch)
        n_m = cfg.ofdm.n_fft
        h_m = (torch.ones((ch.shape[0], 1, n_m), dtype=torch.complex64, device=dev) if h_m is None
               else h_m.to(torch.complex64).expand(ch.shape[0], 1, n_m))
        parts = []
        for c in range(0, ch.shape[0], chunk):
            sl = slice(c, c + chunk)
            llr = kc.demod_chain(re_m[sl], im_m[sl], h_m[sl].real, h_m[sl].imag, cfg.ofdm.cp_len,
                                 cfg.modulation, fast.noise_var(cfg))
            parts.append(count_margin(llr))
            del llr
        return torch.cat(parts)

    def wide_link(label, model, ebno_db, gate, n_channels=B, **kw):
        """Both layouts of one wideband cell: warm, then timed in turns
        (rows, cl, cl, rows, rows, cl; median of 3 each); BER within the
        gate of ``gate`` (exact theory, or the BER of the drawn channel);
        cl counts equal to rows but for the near-zero bits."""
        cfg = link_cfg(model, ebno_db, n_channels, **kw)
        runs = {"rows": [], "cl": []}
        with at_n(cfg.ofdm.n_fft):
            run_link(model, ebno_db, n_channels, **kw)
            run_link(model, ebno_db, n_channels, layout="cl", **kw)
            for layout in ("rows", "cl", "cl", "rows", "rows", "cl"):
                runs[layout].append(run_link(model, ebno_db, n_channels, layout=layout, **kw))
        for layout in ("cl", "rows"):
            for e2, _, _ in runs[layout][1:]:
                _check(torch.equal(e2, runs[layout][0][0]), f"{label} {layout}: runs differ")
        (e_r, c_r, _), (e_c, _, _) = runs["rows"][0], runs["cl"][0]
        want, tol, what = gate(cfg)
        ber_r = ber_of(e_r, c_r)
        ber_c = ber_of(e_c, c_r)
        for lay, b_ in (("rows", ber_r), ("cl", ber_c)):
            _check(abs(b_ / want - 1) <= tol, f"{label} {lay}: BER {b_:g} vs {what} {want:g}")
        margin = rows_margin(cfg, ids[:n_channels])
        diff = (e_c - e_r).abs()
        _check(bool((diff <= margin).all()), f"{label}: cl counts differ from rows beyond margin")
        t_rows = sorted(r[2] for r in runs["rows"])[1]
        t_cl = sorted(r[2] for r in runs["cl"])[1]
        samples = n_channels * cfg.n_symbols * (cfg.ofdm.n_fft + cfg.ofdm.cp_len)
        print(f"phase 3i fast_simulate {label} {n_channels}x{cfg.n_symbols}: BER rows {ber_r:.6g}, "
              f"cl {ber_c:.6g}, {what} {want:.6g} (ratio {ber_r / want:.5f}, allowed {tol:g}); "
              f"cl vs rows per-channel max diff {int(diff.max())} (allowed {int(margin.max())}); "
              f"rows {t_rows * 1e3:.3f} ms = {samples / t_rows / 1e9:.3f} GS/s, cl "
              f"{t_cl * 1e3:.3f} ms = {samples / t_cl / 1e9:.3f} GS/s (median of 3 each, in turns)"
              f" on {card}")
        return e_r

    def theory(fn, tol):
        return lambda cfg: (fn(cfg.modulation, cfg.channel.ebno_db), tol, "exact theory")

    def drawn(cfg):
        h_d, _ = fast.fade_state(cfg, seed, ids[:cfg.n_channels])
        return (ber_given_gain(cfg.modulation, cfg.channel.ebno_db,
                               (h_d.abs() ** 2).to(torch.float64)), 0.02, "drawn-channel BER")

    with at_n(1024):
        run_link(ChannelModel.AWGN, 12.0, 128, **w3)  # warm-up
    e3 = wide_link("config 3 AWGN 12 dB", ChannelModel.AWGN, 12.0,
                   theory(ber_awgn_exact, 0.05), **w3)
    with at_n(1024):
        part, _, _ = run_link(ChannelModel.AWGN, 12.0, ch=ids[:half], **w3)
    _check(torch.equal(part, e3[:half]), "config 3: channels [0, B/2) alone differ from full")
    print(f"phase 3i config 3 AWGN: split [0, {half}) == full")
    del part, e3
    wide_link("config 3 RAYLEIGH_FLAT 15 dB", ChannelModel.RAYLEIGH_FLAT, 15.0,
              theory(ber_rayleigh_exact, 0.10), **w3)
    wide_link("config 3 MULTIPATH config-4 PDP 14 dB", ChannelModel.MULTIPATH, 14.0, drawn,
              pdp=pdp4, **w3)
    torch.cuda.empty_cache()
    wide_link("config 5 shape (N 4096, CP 512) MULTIPATH 5 taps 14 dB", ChannelModel.MULTIPATH,
              14.0, drawn, n_channels=B // 2, pdp=pdp5, **w5)
    wide_link("N 2048, CP 256, 16-QAM MULTIPATH 5 taps 14 dB", ChannelModel.MULTIPATH, 14.0,
              drawn, n_channels=B // 2, pdp=pdp5,
              **dict(n_fft=2048, cp=256, n_symbols=16, modulation=mod))
    torch.cuda.empty_cache()

    # The coded engine at config 3 (B/4 × 64: the plane is six times wider
    # per channel than at config 2), both seams — the fused one through F's
    # wideband LLR mode; then both seams at N 2048 and 4096 on 512 channels.
    for label, cfg_l, n_ch in (
        ("config 3 (64-QAM, N 1024, CP 128)",
         link_cfg(ChannelModel.RAYLEIGH_FLAT, 9.0, B // 4, **w3), B // 4),
        ("N 2048, CP 256, 16-QAM, 16 symbols",
         link_cfg(ChannelModel.RAYLEIGH_FLAT, 9.0, min(512, B), n_fft=2048, cp=256,
                  n_symbols=16), min(512, B)),
        ("config 5 shape (N 4096, CP 512), 16 symbols",
         link_cfg(ChannelModel.RAYLEIGH_FLAT, 9.0, min(512, B), **w5), min(512, B)),
    ):
        code_l = ldpc_code_for("1/2")
        info_l = n_ch * ldpc_codewords_per_channel(cfg_l, code_l) * code_l.k
        res = {}
        with at_n(cfg_l.ofdm.n_fft):
            for seam in ("staged", "fused"):
                run_coded(cfg_l, seam=seam)
                res[seam] = run_coded(cfg_l, seam=seam)
        es, ef = int(res["staged"][0].sum()), int(res["fused"][0].sum())
        _check(0 < es and abs(es - ef) <= max(8, es // 100),
               f"coded {label}: seams disagree, staged {es}, fused {ef}")
        t_s, t_f = res["staged"][2], res["fused"][2]
        print(f"phase 3i ldpc_fast_simulate {label} {n_ch} channels rate 1/2 RAYLEIGH_FLAT 9 dB "
              f"flooding 25: staged {es} / fused {ef} info-bit errors (allowed diff "
              f"{max(8, es // 100)}); staged {t_s * 1e3:.3f} ms ({info_l / t_s / 1e6:.3f} Mb/s "
              f"info), fused {t_f * 1e3:.3f} ms ({info_l / t_f / 1e6:.3f} Mb/s) on {card}")
        del res
    torch.cuda.empty_cache()

    # The terminals a user calls at N 1024, 2048 and 4096 (bench.py-style
    # inputs, the link cells' batches): the channels-last sum, count and LLR
    # plane (kernels D and F in their wideband mode), kernel C's sum through
    # ``demod_chain`` and the hybrid route; every sum within 1e-5 relative
    # of the plain sum on the same grid (taken B/4 channels at a time).
    for label, n_t, cp_t, s_t, b_t, mod_t in (
        ("config 3", 1024, 128, 64, B, mod3), ("N 2048", 2048, 256, 16, B // 2, mod),
        ("config 5 shape", 4096, 512, 16, B // 2, mod),
    ):
        gen_i = torch.Generator(device=dev).manual_seed(seed + 3 + n_t)
        xr, xi = (torch.randn((b_t, s_t, n_t + cp_t), device=dev, generator=gen_i)
                  * (1.0 / (2 * n_t) ** 0.5) for _ in range(2))
        hr_i, hi_i = (torch.randn((b_t, 1, n_t), device=dev, generator=gen_i) * 0.5 ** 0.5
                      for _ in range(2))
        xr_t, xi_t = fast._to_cl(xr, xi)
        hr_it, hi_it = hr_i[:, 0, :].T.contiguous(), hi_i[:, 0, :].T.contiguous()
        idx_i = torch.randint(0, 1 << mod_t.bits_per_symbol, (s_t * n_t, b_t), dtype=torch.int8,
                              device=dev, generator=gen_i)
        nv_t = 1.0 / (10.0 ** 1.2 * mod_t.bits_per_symbol)
        ref_sum = sum(float(kc.demod_chain(xr[c:c + B // 4], xi[c:c + B // 4],
                                           hr_i[c:c + B // 4], hi_i[c:c + B // 4], cp_t, mod_t,
                                           nv_t, reduce_sum=True))
                      for c in range(0, b_t, B // 4))
        calls = [
            ("demod_sum_chain_cl", lambda: demod_sum_chain_cl(xr_t, xi_t, hr_it, hi_it, cp_t, mod_t,
                                                              nv_t)),
            ("demod_count_chain_cl", lambda: demod_count_chain_cl(xr_t, xi_t, hr_it, hi_it, idx_i,
                                                                  cp_t, mod_t, nv_t)),
            ("demod_llr_chain_cl f32 kernel order",
             lambda: demod_llr_chain_cl(xr_t, xi_t, hr_it, hi_it, cp_t, mod_t, nv_t,
                                        kernel_order=True)),
            ("demod_llr_chain_cl bf16 kernel order",
             lambda: demod_llr_chain_cl(xr_t, xi_t, hr_it, hi_it, cp_t, mod_t, nv_t,
                                        out_dtype=torch.bfloat16, kernel_order=True)),
            ("demod_chain_hybrid plane", lambda: demod_chain_hybrid(xr, xi, hr_i, hi_i, cp_t, mod_t,
                                                                    nv_t)),
            ("demod_chain_hybrid sum", lambda: demod_chain_hybrid(xr, xi, hr_i, hi_i, cp_t, mod_t,
                                                                  nv_t, reduce_sum=True)),
            ("demod_chain sum", lambda: demod_chain(xr, xi, hr_i, hi_i, cp_t, mod_t, nv_t,
                                                    reduce_sum=True)),
        ]
        # The SC-FDE receive (kernel C's despread modes; rows #4, #8, #15):
        # the count against time-domain indices and the plane at every N,
        # the sum at N 4096.
        idx_r = torch.randint(0, 1 << mod_t.bits_per_symbol, (b_t, s_t, n_t), dtype=torch.int8,
                              device=dev, generator=gen_i)
        calls += [
            ("demod_count_chain despread",
             lambda: demod_count_chain(xr, xi, hr_i, hi_i, idx_r, cp_t, mod_t, nv_t,
                                       despread=True)),
            ("demod_chain despread plane",
             lambda: demod_chain(xr, xi, hr_i, hi_i, cp_t, mod_t, nv_t, despread=True)),
        ]
        if n_t == 4096:
            calls.append(("demod_chain despread sum",
                          lambda: demod_chain(xr, xi, hr_i, hi_i, cp_t, mod_t, nv_t,
                                              reduce_sum=True, despread=True)))
        for name, fn in calls:
            with at_n(n_t):
                out = fn()
                ms_t = timed(fn, 3)
            _check(bool(torch.isfinite(out.float()).all()), f"{name} {label}: non-finite output")
            if out.ndim == 0 and "despread" not in name:
                _check(abs(float(out) - ref_sum) <= 1e-5 * abs(ref_sum),
                       f"{name} {label}: sum {float(out)!r} vs plain {ref_sum!r}")
            del out
            print(f"phase 3i {name} {label} ({b_t}x{s_t}x{n_t + cp_t} f32 in): {ms_t:.3f} ms per "
                  f"call, {b_t * s_t * (n_t + cp_t) / (ms_t * 1e-3) / 1e9:.3f} GS/s on {card}")
        del xr, xi, hr_i, hi_i, xr_t, xi_t, hr_it, hi_it, idx_i, idx_r
        torch.cuda.empty_cache()
    # phase 3i: the wideband link and terminals, the sum of the N windows
    launches_wide = {k: sum(w[k] for w in launches_at.values()) for k in _lib.LAUNCHES}

    # ---- phase 3p: the link pipeline and the blocked stream, counters zeroed --
    # ``link.pipeline.simulate`` at config 2, B x 64: the link that
    # ``__graft_entry__.entry()`` compiles (MULTIPATH PDP (1, .5, .25, .125),
    # MMSE, 12 dB), the other receivers and models, ``want_llrs``, and
    # ``link.stream.stream_simulate``. Each main-path call runs inside
    # ``in_pipeline()`` (the counters zeroed on entry, added to the window on
    # exit); the references (fast_simulate, the drawn channel's BER, the
    # LLR margins) are in no window. Each line: ms the median of 3 warm
    # calls (CUDA events) and the launches of one call.
    from sdr_tpu_torch.core.config import Equalizer
    from sdr_tpu_torch.link import pipeline
    from sdr_tpu_torch.link.stream import exact_at_seams, stream_simulate

    launches_pipeline = dict.fromkeys(_lib.LAUNCHES, 0)
    pipeline_path = ("payload", "tx_off", "fade_awgn", "fade_awgn_fir", "demod_count",
                     "demod_count_despread", "demod_llr")

    @contextlib.contextmanager
    def in_pipeline():
        _lib.reset_launches()
        yield
        for k, v in _lib.LAUNCHES.items():
            launches_pipeline[k] += v

    def p_cfg(model, ebno_db, equalizer=Equalizer.MMSE, dft_spread=False, **channel):
        return LinkConfig(modulation=mod, ofdm=OFDMConfig(N, CP),
                          channel=ChannelConfig(model=model, ebno_db=ebno_db, **channel),
                          equalizer=equalizer, n_symbols=S, n_channels=B, dft_spread=dft_spread)

    def p_run(fn):
        """fn() warm, then 3 timed calls: (result, median ms, launches of one call)."""
        with in_pipeline():
            out = fn()
            torch.cuda.synchronize()
            per_call = {k: v for k, v in _lib.LAUNCHES.items() if v}
            ms_p = sorted(timed(fn, 1) for _ in range(3))[1]
        return out, ms_p, per_call

    def p_ber(res):
        return int(res.bit_errors.sum()) / int(res.bits_counted.sum())

    def drawn(cfg):
        h_d, _ = fast.fade_state(cfg, seed, ids)
        return ber_given_gain(mod, cfg.channel.ebno_db, (h_d.abs() ** 2).to(torch.float64))

    def plane_margin(cfg):
        llrs = pipeline.simulate(cfg, seed, device=dev, want_llrs=True).llrs
        return (llrs.abs() < 1e-3).sum(dim=(1, 2))

    t3p = time.perf_counter()
    half = B // 2
    entry = pipeline_cell(B)
    res_e, ms_e, per_e = p_run(lambda: pipeline.simulate(entry, seed, device=dev))
    ber_e, want_e = p_ber(res_e), drawn(entry)
    _check(abs(ber_e / want_e - 1) <= 0.02,
           f"pipeline entry link: BER {ber_e:g} vs {want_e:g} over the drawn channel")
    fast_e, _ = fast.fast_simulate(entry, seed, device=dev)
    _check(torch.equal(res_e.bit_errors, fast_e), "pipeline: bit_errors differ from fast_simulate")
    with in_pipeline():
        part_e, _, _ = pipeline.simulate_core(entry, seed, ids[:half])
    _check(torch.equal(part_e, res_e.bit_errors[:half]), "pipeline: split run differs from full")
    pipe_rows = [dict(label="entry MULTIPATH 4 taps MMSE 12 dB", ms=ms_e, ber=ber_e)]
    print(f"phase 3p pipeline.simulate {B}x{S} config 2 MULTIPATH PDP (1, .5, .25, .125) MMSE "
          f"12 dB (the entry link): BER {ber_e:.6g}, over the drawn channel {want_e:.6g} (ratio "
          f"{ber_e / want_e:.5f}, allowed 2 %); bit_errors == fast_simulate's; split [0, {half}) "
          f"== full; {ms_e:.3f} ms (median of 3 warm calls, CUDA events), launches a call "
          f"{per_e} on {card}")
    del fast_e, part_e
    th10 = ber_awgn_exact(mod, 10.0)
    for label, cfg, want, tol in (
        ("AWGN 10 dB MMSE", p_cfg(ChannelModel.AWGN, 10.0), th10, 0.05),
        ("AWGN 10 dB NONE", p_cfg(ChannelModel.AWGN, 10.0, Equalizer.NONE), th10, 0.05),
        ("ZF on the entry link", pipeline_cell(B, equalizer=Equalizer.ZF), want_e, 0.02),
        ("RICIAN K 4 12 dB MMSE", p_cfg(ChannelModel.RICIAN, 12.0), None, 0.02),
        ("RAYLEIGH_TIME fd 0.02 12 dB MMSE",
         p_cfg(ChannelModel.RAYLEIGH_TIME, 12.0, doppler_norm=0.02), None, 0.02),
        ("MULTIPATH_TIME PDP (1, .5, .25) fd 0.02 12 dB MMSE",
         p_cfg(ChannelModel.MULTIPATH_TIME, 12.0, pdp=pdp3, doppler_norm=0.02), None, 0.02),
        ("SC-FDMA AWGN 10 dB MMSE (SC-FDE)", p_cfg(ChannelModel.AWGN, 10.0, dft_spread=True),
         th10, 0.02),
    ):
        res_p, ms_p, per_p = p_run(lambda: pipeline.simulate(cfg, seed, device=dev))
        ber_p = p_ber(res_p)
        against = "theory" if want is not None and cfg.channel.model == ChannelModel.AWGN else \
            "the drawn channel"
        want = drawn(cfg) if want is None else want
        _check(abs(ber_p / want - 1) <= tol, f"pipeline {label}: BER {ber_p:g} vs {want:g}")
        pipe_rows.append(dict(label=label, ms=ms_p, ber=ber_p))
        print(f"phase 3p pipeline.simulate {B}x{S} config 2 {label}: BER {ber_p:.6g}, {against} "
              f"{want:.6g} (ratio {ber_p / want:.5f}, allowed {tol:.0%}); {ms_p:.3f} ms, "
              f"launches a call {per_p}")
        del res_p
    res_l, ms_l, per_l = p_run(lambda: pipeline.simulate(entry, seed, device=dev,
                                                         want_llrs=True))
    llrs_e = res_l.llrs
    _check(tuple(llrs_e.shape) == (B, S, N * bps) and bool(torch.isfinite(llrs_e).all()),
           f"pipeline want_llrs: plane {tuple(llrs_e.shape)}")
    margin_e = (llrs_e.abs() < 1e-3).sum(dim=(1, 2))
    diff_l = (res_l.bit_errors - res_e.bit_errors).abs()
    _check(bool((diff_l <= margin_e).all()),
           "pipeline want_llrs: the plane's hard bits differ from the count beyond the margin")
    pipe_rows.append(dict(label="entry, want_llrs", ms=ms_l, ber=p_ber(res_l)))
    print(f"phase 3p pipeline.simulate want_llrs=True (entry link): C's plane "
          f"{tuple(llrs_e.shape)} f32, its hard bits vs the count max per-channel diff "
          f"{int(diff_l.max())} (allowed {int(margin_e.max())}); {ms_l:.3f} ms, launches a call "
          f"{per_l}")
    del res_l, llrs_e
    torch.cuda.empty_cache()
    tdl = p_cfg(ChannelModel.MULTIPATH_TIME, 12.0, pdp=pdp4, doppler_norm=0.03)
    for label, cfg, ref_errors in (
        ("entry link", entry, res_e.bit_errors),
        ("MULTIPATH_TIME PDP (1, .5, .25, .125) fd 0.03 12 dB",
         tdl, pipeline.simulate(tdl, seed, device=dev).bit_errors),
    ):
        # Static taps: every draw keyed by absolute position, so bit for bit;
        # Jakes fading: but for the bits whose |LLR| < 1e-3.
        exact = exact_at_seams(cfg)
        margin = torch.zeros_like(ref_errors) if exact else plane_margin(cfg)
        (errors_st, _), ms_st, per_st = p_run(lambda: stream_simulate(cfg, seed, 4, device=dev))
        diff_st = (errors_st - ref_errors).abs()
        _check(bool((diff_st <= margin).all()),
               f"stream {label}: differs from simulate"
               + ("" if exact else " beyond the |LLR| < 1e-3 bits"))
        pipe_rows.append(dict(label=f"stream n_blocks 4, {label}", ms=ms_st,
                              ber=int(errors_st.sum()) / (B * S * N * bps)))
        print(f"phase 3p stream_simulate n_blocks 4 {B}x{S} {label}: == simulate "
              f"{bool(torch.equal(errors_st, ref_errors))} (max per-channel diff "
              f"{int(diff_st.max())}, allowed {int(margin.max())}"
              f"{', bit-exact required' if exact else ''}); {ms_st:.3f} ms, launches a "
              f"call {per_st}")
    del res_e, margin_e
    torch.cuda.empty_cache()
    for name in pipeline_path:
        _check(launches_pipeline[name] > 0, f"phase 3p: kernel {name} was not launched")
    print(f"phase 3p: {len(pipe_rows)} lines in {time.perf_counter() - t3p:.1f} s; window "
          f"{ {k: launches_pipeline[k] for k in pipeline_path} }")

    # ---- phase 3q: pilots and channel estimation, counters zeroed -----------
    # First kernel B's pilot comb and kernel C's pilot-skipping count at full
    # width against their plain versions (phase 2's tolerances), each timed
    # beside its mode without the comb on the same inputs (in turns, off,
    # comb, comb, off) and its plain version; the receive's torch work (the
    # frame's FFT for the comb's pilot tones, the estimates, the block
    # pilots' pilot-row FFT and data-row gather) timed alone. Then the pilot
    # links through ``pipeline.simulate`` at config 2, B x 64, each against
    # its genie twin (pilot_spacing 0, the same seed and data) with the JAX
    # tests' gates; ms the median of 3 warm calls (CUDA events). Each
    # main-path call runs inside ``in_pilots()``; the twins and the
    # references are in no window.
    import dataclasses

    from sdr_tpu_torch.core.config import ChannelEstimator
    from sdr_tpu_torch.ops import pilots as pil
    from sdr_tpu_torch.ops.ofdm import ofdm_rx
    from sdr_tpu_torch.parallel import make_link_mesh, make_sharded_simulate_fn

    t3q = time.perf_counter()
    SP = 8  # the comb's spacing: 32 pilot tones of 256
    n_data = pil.n_data_subcarriers(N, SP)
    idx_q = ka.payload_idx(S, N, bps, seed, ids)
    got = kb.tx_chain(idx_q, CP, mod, pilot_spacing=SP)
    comb_err = plane_err(got, kb.tx_channel_plain(idx_q, CP, mod, pilot_spacing=SP))
    _check(comb_err <= 1e-5 * plane_peak(got), f"kernel B (pilot comb) max abs diff {comb_err:g}")
    del got
    ms_comb, ms_off = compare_times(lambda: kb.tx_chain(idx_q, CP, mod, pilot_spacing=SP),
                                    lambda: kb.tx_chain(idx_q, CP, mod))
    pms = timed(lambda: kb.tx_channel_plain(idx_q, CP, mod, pilot_spacing=SP), 1)
    # Bytes: the data tones' indices read, the two planes written; the IFFT.
    report["tx_comb"] = dict(max_abs_err=comb_err, ms=ms_comb, plain_ms=pms, off_ms=ms_off,
                             **bound(nrow * n_data + 8 * nrow * (N + CP), nrow * fft_flops(N)))
    print(f"phase 3q B tx pilot comb spacing {SP} ({B}x{S}x{N + CP}): max abs diff "
          f"{comb_err:.3g}; kernel {ms_comb:.4f} ms beside the channel-off mode's {ms_off:.4f} "
          f"(ratio {ms_comb / ms_off:.4f}), plain {pms:.3f} ms, {of_bound(report['tx_comb'])}")
    re_q, im_q = kb.tx_channel(idx_q, CP, mod, noise_var=tvar, seed=seed, ch_ids=ids,
                               pilot_spacing=SP)
    h1 = (torch.ones((B, 1, N), device=dev), torch.zeros((B, 1, N), device=dev))
    cnt = kc.demod_count(re_q, im_q, *h1, idx_q, CP, mod, nv10, pilot_spacing=SP)
    llr = pil.data_tones(kc.demod_chain(re_q, im_q, *h1, CP, mod, nv10), SP, bps)
    cnt_plain = kc.count_errors(llr, pil.data_tones(idx_q, SP), bps)
    margin = (llr.abs() < 1e-3).sum(dim=(1, 2))
    del llr
    diff = (cnt - cnt_plain).abs()
    _check(bool((diff <= margin).all()) and int(cnt_plain.sum()) > 0,
           "kernel C (pilot comb) counts differ beyond the |LLR| < 1e-3 bits")
    ms_cc, ms_c = compare_times(
        lambda: kc.demod_count(re_q, im_q, *h1, idx_q, CP, mod, nv10, pilot_spacing=SP),
        lambda: kc.demod_count(re_q, im_q, *h1, idx_q, CP, mod, nv10))
    pms = timed(lambda: kc.demod_count_plain(re_q, im_q, *h1, idx_q, CP, mod, nv10,
                                             pilot_spacing=SP), 1)
    # Bytes: S·N sample rows, h, the data tones' indices, the counts; the FFT
    # of every symbol and the tail of its data tones.
    report["demod_count_comb"] = dict(
        max_abs_err=float(diff.max()), ms=ms_cc, plain_ms=pms, no_comb_ms=ms_c,
        **bound(8 * nrow * N + 8 * B * N + nrow * n_data + 4 * B,
                nrow * (fft_flops(N) + n_data * tail_flops(mod))))
    print(f"phase 3q C demod+count pilot comb spacing {SP} ({B}x{S}x{N + CP}): "
          f"{int(cnt.sum())} errors, plain {int(cnt_plain.sum())}, max per-channel diff "
          f"{int(diff.max())} (allowed {int(margin.max())}); kernel {ms_cc:.4f} ms beside the "
          f"count without the comb {ms_c:.4f} (ratio {ms_cc / ms_c:.4f}), plain {pms:.3f} ms, "
          f"{of_bound(report['demod_count_comb'])}")

    def q_cfg(model, ebno_db, spacing=SP, estimator=ChannelEstimator.LS,
              equalizer=Equalizer.MMSE, dft_spread=False, **channel):
        return dataclasses.replace(
            p_cfg(model, ebno_db, equalizer, dft_spread, **channel), pilot_spacing=spacing,
            estimator=estimator)

    block = q_cfg(ChannelModel.MULTIPATH, 14.0, 4, ChannelEstimator.DFT, dft_spread=True,
                  pdp=pdp4)
    parts = {}
    y_q = ofdm_rx(torch.complex(re_q, im_q), CP)
    parts["comb frame FFT (complex + ofdm_rx)"] = timed(
        lambda: ofdm_rx(torch.complex(re_q, im_q), CP), 3)
    n_taps_q = pil.dft_n_taps(N, CP, SP)
    for label, fn in (("LS estimate", lambda: pil.estimate_ls_comb(y_q, SP)),
                      ("DFT estimate", lambda: pil.estimate_dft_comb(y_q, SP, n_taps_q)),
                      ("LS estimate per symbol",
                       lambda: pil.estimate_ls_comb(y_q, SP, per_symbol=True)),
                      ("DFT estimate per symbol",
                       lambda: pil.estimate_dft_comb(y_q, SP, n_taps_q, per_symbol=True)),
                      ("block pilot-row FFT", lambda: ofdm_rx(torch.complex(
                          *(pipeline._block_view(block, t)[:, :, 0] for t in (re_q, im_q))), CP)),
                      ("block data-row gather", lambda: (pipeline._data_rows(block, re_q),
                                                         pipeline._data_rows(block, im_q)))):
        fn()  # warm: the tables' first copy to the card, the first complex product
        parts[label] = timed(fn, 3)
    del y_q, re_q, im_q, idx_q
    torch.cuda.empty_cache()
    print(f"phase 3q receive parts ({B}x{S}x{N + CP}, CUDA events, 3 warm calls each): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))

    launches_pilots = dict.fromkeys(_lib.LAUNCHES, 0)
    pilot_path = ("tx_comb", "demod_count_comb")

    @contextlib.contextmanager
    def in_pilots():
        _lib.reset_launches()
        yield
        for k, v in _lib.LAUNCHES.items():
            launches_pilots[k] += v

    def q_run(fn):
        """fn() warm, then 3 timed calls: (result, median ms, launches of one call)."""
        with in_pilots():
            out = fn()
            torch.cuda.synchronize()
            per_call = {k: v for k, v in _lib.LAUNCHES.items() if v}
            ms_p = sorted(timed(fn, 1) for _ in range(3))[1]
        return out, ms_p, per_call

    def static_gate(ber, genie):
        return ber <= 2.0 * max(genie, 1e-4), "2 x max(genie, 1e-4)"

    def dft_gate(ber, genie):
        return ber <= 1.6 * genie + 2e-4, "1.6 x genie + 2e-4"

    def varying_gate(ber, genie):
        return ber <= 3.0 * genie + 1e-3, "3 x genie + 1e-3"

    DFT_E = ChannelEstimator.DFT
    q_links = (
        ("pilots-comb-ls", q_cfg(ChannelModel.MULTIPATH, 12.0, pdp=pdp4), static_gate),
        ("pilots-comb-dft", q_cfg(ChannelModel.MULTIPATH, 12.0, estimator=DFT_E, pdp=pdp4),
         dft_gate),
        ("pilots-comb-dft-zf", q_cfg(ChannelModel.MULTIPATH, 12.0, estimator=DFT_E,
                                     equalizer=Equalizer.ZF, pdp=pdp4), dft_gate),
        ("pilots-comb-rayleigh-time", q_cfg(ChannelModel.RAYLEIGH_TIME, 12.0, doppler_norm=0.02),
         varying_gate),
        ("pilots-comb-multipath-time", q_cfg(ChannelModel.MULTIPATH_TIME, 12.0, estimator=DFT_E,
                                             pdp=pdp3, doppler_norm=0.02), varying_gate),
        ("pilots-block-scfdma", block, static_gate),
        ("pilots-block-scfdma-time (MULTIPATH_TIME, interp_full)",
         dataclasses.replace(block, channel=dataclasses.replace(
             block.channel, model=ChannelModel.MULTIPATH_TIME, doppler_norm=0.02)), varying_gate),
        ("pilots-block-scfdma-time (RAYLEIGH_TIME, interp)",
         dataclasses.replace(block, channel=dataclasses.replace(
             block.channel, model=ChannelModel.RAYLEIGH_TIME, doppler_norm=0.02, pdp=(1.0,))),
         varying_gate),
    )
    q_rows = []
    q_ber = {}
    for label, cfg, gate in q_links:
        res_q, ms_q, per_q = q_run(lambda: pipeline.simulate(cfg, seed, device=dev))
        genie = p_ber(pipeline.simulate(dataclasses.replace(cfg, pilot_spacing=0), seed,
                                        device=dev))
        ber_q = p_ber(res_q)
        _check(int(res_q.bits_counted[0]) == cfg.n_data_symbols * cfg.bits_per_ofdm_symbol,
               f"{label}: bits_counted")
        ok, rule = gate(ber_q, genie)
        _check(ok, f"{label}: BER {ber_q:g} vs genie {genie:g} breaks {rule}")
        q_ber[label] = ber_q
        q_rows.append(dict(label=label, ms=ms_q, ber=ber_q, genie=genie))
        print(f"phase 3q pipeline.simulate {B}x{S} config 2 {label}: BER {ber_q:.6g}, genie twin "
              f"{genie:.6g} (ratio {ber_q / genie:.5f}, gate {rule}); {ms_q:.3f} ms (median of 3 "
              f"warm calls, CUDA events), launches a call {per_q} on {card}")
        del res_q
    _check(q_ber["pilots-comb-dft"] < q_ber["pilots-comb-ls"],
           f"pilots: DFT BER {q_ber['pilots-comb-dft']:g} not below LS "
           f"{q_ber['pilots-comb-ls']:g}")
    dft_cfg = q_links[1][1]
    res_c, _, _ = q_run(lambda: pipeline.simulate(dft_cfg, seed, device=dev))
    res_l, ms_l, per_l = q_run(lambda: pipeline.simulate(dft_cfg, seed, device=dev,
                                                         want_llrs=True))
    want_shape = (B, S, n_data * bps)
    _check(tuple(res_l.llrs.shape) == want_shape and bool(torch.isfinite(res_l.llrs).all()),
           f"pilots want_llrs: plane {tuple(res_l.llrs.shape)}, want {want_shape}")
    margin_l = (res_l.llrs.abs() < 1e-3).sum(dim=(1, 2))
    diff_l = (res_l.bit_errors - res_c.bit_errors).abs()
    _check(bool((diff_l <= margin_l).all()),
           "pilots want_llrs: the plane's hard bits differ from the count beyond the margin")
    q_rows.append(dict(label="pilots-comb-dft, want_llrs", ms=ms_l, ber=p_ber(res_l)))
    print(f"phase 3q pipeline.simulate want_llrs=True (pilots-comb-dft): the data tones' plane "
          f"{tuple(res_l.llrs.shape)} f32, its hard bits vs the comb count max per-channel diff "
          f"{int(diff_l.max())} (allowed {int(margin_l.max())}); {ms_l:.3f} ms, launches a call "
          f"{per_l}")
    del res_l, margin_l
    with in_pilots():
        errors_sh, counted_sh = make_sharded_simulate_fn(dft_cfg, make_link_mesh(), device=dev)(
            seed)
    _check(torch.equal(errors_sh, res_c.bit_errors) and torch.equal(counted_sh,
                                                                     res_c.bits_counted),
           "pilots: make_sharded_simulate_fn (one rank) differs from simulate")
    print(f"phase 3q make_sharded_simulate_fn (one rank, 1 x 1 mesh) on pilots-comb-dft: == "
          f"simulate bit for bit")
    del res_c
    torch.cuda.empty_cache()
    for name in pilot_path:
        _check(launches_pilots[name] > 0, f"phase 3q: kernel {name} was not launched")
    print(f"phase 3q: {len(q_rows)} links in {time.perf_counter() - t3q:.1f} s; window "
          f"{ {k: v for k, v in launches_pilots.items() if v} }")

    # ---- phase 3r: front-end impairments, counters zeroed -----------------------
    # First kernel E's noise-only mode on the acquired link's stream, one
    # (B, 1, T) row a channel (T = 37 + 67·320 = 21477, odd: off E's 16-byte
    # grid, so its V = 1 path), against its plain version (phase 2's
    # tolerance) and timed beside it; then the acquired receive's torch parts
    # on a full-width stream; then the links of ``impairment_links`` through
    # ``pipeline.simulate`` at config 2, B x 64, each gated against its
    # references (the same seed, outside the window) with the JAX test's
    # gate form; ms the median of 3 warm calls (CUDA events). Each main-path
    # call runs inside ``in_impairments()``.
    from sdr_tpu_torch.ops import channel as chan_ops
    from sdr_tpu_torch.ops import sync
    from sdr_tpu_torch.ops.fft import fft as t_fft

    t3r = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launches_impairments = dict.fromkeys(_lib.LAUNCHES, 0)
    acq_cfg = impairment_links(B)[0][1]
    T = pipeline.stream_len(acq_cfg)
    nv_q = fast.noise_var(acq_cfg)
    row_shape = (B, 1, T)
    stream_clean = torch.complex(*(torch.randn(row_shape, device=dev) * (0.5 / N) ** 0.5
                                   for _ in range(2)))
    row = tuple(t.contiguous() for t in fast._planar(stream_clean))
    rep = check_modes(f"E noise only on the acquired stream ({B}x1x{T})",
                      lambda **kw: ke.fade_awgn(*row, noise_var=nv_q / N, **kw),
                      lambda **kw: ke.fade_awgn_plain(*row, noise_var=nv_q / N, **kw),
                      row_shape, kernel_reps=10)
    rep.update(bound(16 * B * T + 4 * B, 4 * B * T, B * T * PHILOX_IMUL))
    # The row's launches are counted in the acquired links' own window
    # (``launches_acquired``), below.
    launches_acquired = dict.fromkeys(_lib.LAUNCHES, 0)
    e_rows.append(dict(rep, mode=f"noise only, acquired stream row 1 x {T}", counter="fade_awgn",
                       shape=f"{B}x1x{T}", window=launches_acquired))
    report["fade_awgn@acquired_stream"] = rep
    del row, stream_clean
    ids_r = ids
    idx_r = pipeline.draw_idx(acq_cfg, seed, ids_r)
    # E's channel-only mode (no noise) on the acquired link's (B, S+3, N+cp)
    # plane (67 rows: a partial run of E's 32-symbol blocks), with the
    # inputs ``pipeline.acquired_plane`` builds for each fading kind,
    # against its plain version (1e-5 of the peak), timed beside it. Bound:
    # 16 bytes a sample and the gains or taps; 6 f32 operations a sample
    # for a gain, 8 a tap. The FIR rows' launches are the acquired links'
    # (acq-multipath and scfdma-block: static, front-end-full: per
    # symbol); no 3r link runs an acquired gains model, so theirs are 0.
    acq_shape = (B, S + 3, N + CP)
    n_acq = B * (S + 3) * (N + CP)
    for label, model, pdp, counter in (
        ("per-link gains", ChannelModel.RAYLEIGH_FLAT, None, "fade_awgn"),
        ("per-symbol gains, a unit tail row", ChannelModel.RAYLEIGH_TIME, None, "fade_awgn"),
        ("static taps (1, .3, .1)", ChannelModel.MULTIPATH, (1.0, 0.3, 0.1), "fade_awgn_fir"),
        ("per-symbol taps (1, .5, .25), the last row repeated", ChannelModel.MULTIPATH_TIME,
         (1.0, 0.5, 0.25), "fade_awgn_fir"),
    ):
        cfg_p = dataclasses.replace(acq_cfg, channel=dataclasses.replace(
            acq_cfg.channel, model=model, pdp=pdp or acq_cfg.channel.pdp, doppler_norm=0.02))
        plane_p, kw_p = pipeline.acquired_plane(cfg_p, seed, ids_r, idx_r)
        _check(tuple(plane_p[0].shape) == acq_shape and kw_p is not None,
               f"acquired plane ({label}): shape {tuple(plane_p[0].shape)}")
        want = ke.fade_awgn_plain(*plane_p, **kw_p)
        err, peak = plane_err(ke.fade_awgn(*plane_p, **kw_p), want), plane_peak(want)
        del want
        _check(err <= 1e-5 * peak, f"E channel only on the acquired plane ({label}): max abs "
                                   f"diff {err:g} of peak {peak:g}")
        ms, pms = compare_times(lambda: ke.fade_awgn(*plane_p, **kw_p),
                                lambda: ke.fade_awgn_plain(*plane_p, **kw_p), reps=1,
                                kernel_reps=10)
        side = kw_p.get("taps_r", kw_p.get("hr_s"))
        per_sample = 8 * side.shape[-1] if counter == "fade_awgn_fir" else 6
        rep = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                   **bound(16 * n_acq + 8 * side.numel(), per_sample * n_acq))
        window = launches_acquired if counter == "fade_awgn_fir" else {"fade_awgn": 0}
        e_rows.append(dict(rep, mode=f"channel only, acquired plane, {label}", counter=counter,
                           shape="x".join(map(str, acq_shape)), window=window))
        print(f"phase 3r E channel only on the acquired plane ({'x'.join(map(str, acq_shape))}, "
              f"{label}): max abs diff {err:.3g} (peak {peak:.3g}, allowed 1e-5 of it); kernel "
              f"{ms:.4f} ms, plain {pms:.3f} ms; {of_bound(rep)} on {card}")
        del plane_p, kw_p
    stream_r = pipeline.acquired_stream(acq_cfg, seed, ids_r, idx_r)
    parts = {}

    def part(label, fn):
        out = fn()  # warm
        parts[label] = timed(fn, 3)
        return out

    d_r, frac_r = part("timing metric and coarse estimate",
                       lambda: sync.estimate_timing_cfo(stream_r, N))
    w1, w2 = part("fractional correction (the two preamble windows)", lambda: (
        sync.corrected_slice(stream_r, frac_r, d_r, N, N),
        sync.corrected_slice(stream_r, frac_r, d_r + N + CP, N, N)))
    mu_r = part("integer CFO (two FFTs, 5 shifts)",
                lambda: sync.estimate_integer_cfo(t_fft(w1), t_fft(w2), N))
    total_r = frac_r + mu_r.to(torch.float32)
    start_r = part("fine timing (window, 2048-point correlation)",
                   lambda: sync._fine_start(stream_r, total_r, d_r, N, CP, sync.PREAMBLE_SEED))
    part("full-stream correction (the JAX rx_c; the link corrects the payload only)",
         lambda: sync.correct_cfo(stream_r, total_r, N))
    part("payload gather and correction", lambda: sync.corrected_slice(
        stream_r, total_r, start_r, S * (N + CP), N))
    part("Wiener draw (keyed increments and walk, B x T)",
         lambda: chan_ops.wiener_phase(seed, ids_r, T, 1e-3))
    part("iq_compensate (diff_lag one symbol, B x T)",
         lambda: chan_ops.iq_compensate(stream_r, diff_lag=N + CP))
    part("acquire_start (the whole acquisition)", lambda: sync.acquire_start(stream_r, N, CP))
    want_start = acq_cfg.channel.timing_offset + 2 * (N + CP)
    locked = float((start_r == want_start).float().mean())
    _check(locked > 0.99, f"phase 3r: acquisition locked on {locked:.4f} of the channels")
    del stream_r, w1, w2, idx_r
    torch.cuda.empty_cache()
    print(f"phase 3r receive parts ({B} x {T} stream, CUDA events, 3 warm calls each, the "
          f"whole batch in one pass; start exact on {locked:.4f} of the channels; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()) + f" on {card}")
    torch.cuda.reset_peak_memory_stats()

    impairment_path = ("payload", "tx_comb", "fade_awgn", "fade_awgn_fir", "demod_count_comb",
                       "demod_count_despread")

    @contextlib.contextmanager
    def in_impairments(acquired=False):
        """3r's window; an acquired link's launches also go to its own."""
        _lib.reset_launches()
        yield
        for k, v in _lib.LAUNCHES.items():
            launches_impairments[k] += v
            if acquired:
                launches_acquired[k] += v

    r_rows = []
    gains_models = (ChannelModel.RAYLEIGH_FLAT, ChannelModel.RAYLEIGH_TIME, ChannelModel.RICIAN)
    for label, cfg, refs, gate in impairment_links(B):
        acquired = cfg.channel.impaired
        # An acquired link's E launches outside the FIR counter are then its
        # noise row's alone.
        _check(not (acquired and cfg.channel.model in gains_models),
               f"{label}: an acquired gains model would share the row's counter")
        with in_impairments(acquired):
            res_r = pipeline.simulate(cfg, seed, device=dev)
            torch.cuda.synchronize()
            per_r = {k: v for k, v in _lib.LAUNCHES.items() if v}
            ms_r = sorted(timed(lambda: pipeline.simulate(cfg, seed, device=dev), 1)
                          for _ in range(3))[1]
        _check(int(res_r.bits_counted[0]) == cfg.n_data_symbols * cfg.bits_per_ofdm_symbol,
               f"{label}: bits_counted")
        errs = {"main": int(res_r.bit_errors.sum())}
        bits = int(res_r.bits_counted.sum())
        del res_r
        for name, ref in refs.items():
            errs[name] = int((ref(seed, dev) if callable(ref) else pipeline.simulate(
                ref, seed, device=dev).bit_errors).sum())
        ber_r = errs["main"] / bits
        ref_ber = {k: v / bits for k, v in errs.items() if k != "main"}
        ok, rule = gate(ber_r, ref_ber, bits)
        _check(ok, f"{label}: BER {ber_r:g} against {ref_ber} breaks {rule}")
        r_rows.append(dict(label=label, ms=ms_r, ber=ber_r, refs=ref_ber))
        print(f"phase 3r pipeline.simulate {B}x{S} config 2 {label}: BER {ber_r:.6g}, "
              f"references {ref_ber} (gate {rule}: met); {ms_r:.3f} ms (median of 3 warm "
              f"calls, CUDA events), launches a call {per_r} on {card}")
    with in_impairments(acquired=True):
        errors_sh, _ = make_sharded_simulate_fn(acq_cfg, make_link_mesh(), device=dev)(seed)
    _check(torch.equal(errors_sh, pipeline.simulate(acq_cfg, seed, device=dev).bit_errors),
           "phase 3r: make_sharded_simulate_fn (one rank) differs from simulate")
    print("phase 3r make_sharded_simulate_fn (one rank, 1 x 1 mesh) on acq-awgn: == simulate "
          "bit for bit")
    torch.cuda.empty_cache()
    for name in impairment_path:
        _check(launches_impairments[name] > 0, f"phase 3r: kernel {name} was not launched")
    print(f"phase 3r: {len(r_rows)} links in {time.perf_counter() - t3r:.1f} s (the links' peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated); window "
          f"{ {k: v for k, v in launches_impairments.items() if v} }; the acquired links' own "
          f"window { {k: v for k, v in launches_acquired.items() if v} }")

    # ---- phase 3m: MIMO on frame-static channels, counters zeroed -------------
    # First the MIMO link's kernels at its shapes, one pass of
    # ``pipeline.CHUNK`` channels (the link runs in such passes): kernel E's
    # channel-only mode over the pair plane (B·n_rx·n_tx, S', N+cp) with the
    # pairs' gains and static taps, its noise-only mode over the RX planes
    # (B, n_rx·S', N+cp), and C's post-FFT mode on whitened tones (h per link
    # and, SC-FDMA, per symbol), each against its plain version and timed
    # beside it; then the link's parts timed alone on that pass; then the
    # links of ``mimo_links`` through ``pipeline.simulate``, each inside
    # ``in_mimo()``, with ms the median of 3 warm calls (CUDA events), its
    # peak memory and its launches; then the gates.
    from sdr_tpu_torch.ops import pilots as pil_ops
    from sdr_tpu_torch.ops.ofdm import ofdm_rx as t_ofdm_rx

    t3m = time.perf_counter()
    launches_mimo = dict.fromkeys(_lib.LAUNCHES, 0)
    mimo_path = ("payload", "tx_off", "fade_awgn", "fade_awgn_fir", "llr_chain")
    m_links, m_theory, m_drawn, m_gates = mimo_links(B, B // 4)
    m_cfg = {key: cfg for key, _, cfg in m_links}
    P = min(pipeline.CHUNK, B)
    ids_m = ids[:P]
    cfg_pre = dataclasses.replace(m_cfg["a22_ls5"], n_channels=P)
    cfg_mp = dataclasses.replace(m_cfg["mp_a22_10"], n_channels=P)
    m_parts = {}

    def m_part(label, fn):
        out = fn()  # warm
        m_parts[label] = timed(fn, 3)
        return out

    idx_m = m_part("A payload (P x 2·64 x 256 for the mux)",
                   lambda: pipeline.draw_mimo_idx(m_cfg["mmse"], seed, ids_m))
    tx_pre = m_part("B off + preamble rows (Alamouti 2x2 grid, 66 rows)",
                    lambda: pipeline.mimo_tx(cfg_pre, pipeline.draw_mimo_idx(cfg_pre, seed,
                                                                             ids_m)))
    pair = m_part("pair plane (expand and copy, 4 pairs)",
                  lambda: pipeline.pair_plane(tx_pre, 2))
    def e_check(phase, label, name, counter, cfg_k, planes, window, n_steps=None, tail=False):
        """E's channel-only mode on the pair plane ``planes`` with ``cfg_k``'s
        keyed pair fading (at ``n_steps`` steps on the time-varying models)
        against its plain version, then timed beside it; its report entry
        and phase 6 E row."""
        fade = pipeline.mimo_fading(cfg_k, seed, ids[:P], n_steps)
        kw_k = pipeline.pair_channel(cfg_k, fade, tail)
        want = ke.fade_awgn_plain(*planes, **kw_k)
        got = ke.fade_awgn(*planes, **kw_k)
        err, peak = plane_err(got, want), plane_peak(want)
        del want, got
        _check(err <= 1e-5 * peak, f"E channel only on the {label}: max abs diff {err:g} of "
                                   f"peak {peak:g}")
        ms, pms = compare_times(lambda: ke.fade_awgn(*planes, **kw_k),
                                lambda: ke.fade_awgn_plain(*planes, **kw_k), reps=1,
                                kernel_reps=10)
        side = kw_k.get("taps_r", kw_k.get("hr_s"))
        n_pl = planes[0].numel()
        per_sample = 8 * side.shape[-1] if counter == "fade_awgn_fir" else 6
        rep = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                   **bound(16 * n_pl + 8 * side.numel(), per_sample * n_pl))
        shape = "x".join(map(str, planes[0].shape))
        e_rows.append(dict(rep, mode=f"channel only, {label}", counter=counter, shape=shape,
                           window=window))
        report[name] = rep
        print(f"phase {phase} E channel only on the {label} ({shape}): max abs diff {err:.3g} "
              f"(peak {peak:.3g}, allowed 1e-5 of it); kernel {ms:.4f} ms, plain {pms:.3f} ms; "
              f"{of_bound(rep)} on {card}")

    for label, cfg_k, counter in (("gains", cfg_pre, "fade_awgn"),
                                  ("static taps (1, .5, .25, .125)", cfg_mp, "fade_awgn_fir")):
        e_check("3m", f"MIMO pair plane, {label}", f"{counter}@mimo_pair_plane", counter, cfg_k,
                pair, launches_mimo)
    kw_pre = pipeline.pair_channel(cfg_pre, pipeline.mimo_fading(cfg_pre, seed, ids_m))
    y_pair = m_part("E channel only on the pair plane (gains)",
                    lambda: ke.fade_awgn(*pair, **kw_pre))
    rx_m = m_part("torch sum over TX antennas", lambda: pipeline.rx_sum(y_pair, P, 2, 2))
    del y_pair, pair
    rx_shape = (P, 2 * rx_m[0].shape[2], N + CP)
    rx_v = tuple(t.view(rx_shape) for t in rx_m)
    nv_m = pipeline.mimo_noise_var(cfg_pre)
    rep = check_modes(f"E noise only on the MIMO RX planes ({'x'.join(map(str, rx_shape))})",
                      lambda **kw: ke.fade_awgn(*rx_v, noise_var=nv_m / N, **kw),
                      lambda **kw: ke.fade_awgn_plain(*rx_v, noise_var=nv_m / N, **kw),
                      rx_shape, kernel_reps=10)
    n_rx_s = rx_v[0].numel()
    rep.update(bound(16 * n_rx_s + 4 * P, 4 * n_rx_s, n_rx_s * PHILOX_IMUL))
    e_rows.append(dict(rep, mode="noise only, MIMO RX planes", counter="fade_awgn",
                       shape="x".join(map(str, rx_shape)), window=launches_mimo))
    report["fade_awgn@mimo_rx_noise"] = rep
    rx_n = m_part("E noise only on the RX planes", lambda: tuple(
        t.view(rx_m[0].shape) for t in ke.fade_awgn(*rx_v, noise_var=nv_m / N, seed=seed,
                                                     ch_ids=ids_m)))
    y_m = m_part("FFT (ofdm_rx of the RX planes)", lambda: t_ofdm_rx(torch.complex(*rx_n), CP))
    pre_norm = (torch.tensor(pil_ops.PILOT_VALUE, dtype=torch.complex64, device=dev)
                / torch.from_numpy(pipeline.preamble_ref(cfg_pre)).to(dev))
    h_pre = m_part("preamble estimate (LS)",
                   lambda: pil_ops.estimate_mimo_preamble(y_m[:, :, :2] * pre_norm, 0))
    y_d = y_m[:, :, 2:]
    s_a, eff_a = m_part("detector: Alamouti combine",
                        lambda: pipeline.mimo_detect(cfg_pre, y_d, h_pre, nv_m))
    h_g = pipeline.mimo_fading(cfg_pre, seed, ids_m)
    for key in ("mmse", "zf", "sic", "ml"):
        cfg_d = dataclasses.replace(m_cfg[key], n_channels=P)
        m_part(f"detector: mux 2x2 {key}", lambda: pipeline.mimo_detect(cfg_d, y_d, h_g, nv_m))
    m_part("whitened_llrs (the whitening, then llr_chain)",
           lambda: pipeline.whitened_llrs(cfg_pre, s_a, eff_a))
    for label, cfg_w, (s_w, eff_w) in (
        ("h per link (Alamouti 2x2)", cfg_pre, (s_a, eff_a)),
        ("h per symbol (SC-FDMA despread, mux 2x2 MMSE)",
         dataclasses.replace(m_cfg["mmse"], dft_spread=True, n_channels=P),
         pipeline.mimo_detect(m_cfg["mmse"], y_d, h_g, nv_m)),
    ):
        # The whitened tones and h exactly as ``whitened_llrs`` builds them.
        Bw, K, Sw, Nw = s_w.shape
        if cfg_w.dft_spread:
            eff_w = torch.broadcast_to(eff_w, s_w.shape).mean(dim=-1, keepdim=True)
            s_w = (torch.fft.ifft(s_w, dim=-1) * Nw ** 0.5).to(torch.complex64)
        g_w = torch.rsqrt(torch.clamp(eff_w, min=pipeline._EFF_FLOOR))
        y_w = torch.view_as_real((s_w * g_w).reshape(Bw * K, Sw, Nw))
        hr_w = g_w.expand(Bw, K, g_w.shape[2], Nw).reshape(Bw * K, g_w.shape[2], Nw).contiguous()
        hi_w = torch.zeros_like(hr_w)
        got = kc.llr_chain(y_w, None, hr_w, hi_w, mod, 1.0)
        want = kc.llr_chain_plain(y_w, None, hr_w, hi_w, mod, 1.0)
        err, peak = float((got - want).abs().max()), float(want.abs().max())
        _check(err <= 1e-4 * peak, f"C llr_chain on whitened MIMO tones ({label}): max abs diff "
                                   f"{err:g} > 1e-4 of the peak {peak:g}")
        del got, want
        ms, pms = compare_times(lambda: kc.llr_chain(y_w, None, hr_w, hi_w, mod, 1.0),
                                lambda: kc.llr_chain_plain(y_w, None, hr_w, hi_w, mod, 1.0),
                                reps=1, kernel_reps=10)
        rep = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                   **chain_bound(Bw * K, Sw, Nw, hr_w.shape[1], mod, False))
        tag = "h_per_link" if hr_w.shape[1] == 1 else "h_per_symbol"
        report[f"llr_chain@mimo_whitened_{tag}"] = rep
        print(f"phase 3m C llr_chain on whitened MIMO tones ({label}, {Bw * K}x{Sw}x{Nw}): max "
              f"abs diff {err:.3g} (peak {peak:.3g}, allowed 1e-4 of it); kernel {ms:.4f} ms, "
              f"plain {pms:.3f} ms; {of_bound(rep)} on {card}")
        del y_w, hr_w, hi_w
    llrs_m = pipeline.whitened_llrs(cfg_pre, s_a, eff_a)
    m_part("torch count (kernels.demod.count_errors)", lambda: kc.count_errors(
        llrs_m.reshape(P, -1, llrs_m.shape[-1]), pipeline.draw_mimo_idx(cfg_pre, seed, ids_m),
        bps))
    del llrs_m, s_a, eff_a, y_m, y_d, rx_m, rx_n, rx_v, tx_pre, idx_m
    torch.cuda.empty_cache()
    print(f"phase 3m link parts (one pass of {P} channels, the link runs {-(-B // P)} a call at "
          f"{B} channels; CUDA events, 3 warm calls each): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in m_parts.items()) + f" on {card}")

    @contextlib.contextmanager
    def in_mimo():
        _lib.reset_launches()
        yield
        for k, v in _lib.LAUNCHES.items():
            launches_mimo[k] += v

    m_ber, m_rows = {}, []
    for key, label, cfg in m_links:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with in_mimo():
            res_m = pipeline.simulate(cfg, seed, device=dev)
            torch.cuda.synchronize()
            per_m = {k: v for k, v in _lib.LAUNCHES.items() if v}
            ms_m = sorted(timed(lambda: pipeline.simulate(cfg, seed, device=dev), 1)
                          for _ in range(3))[1]
        peak_m = torch.cuda.max_memory_allocated() / 2 ** 30
        bits_m = int(res_m.bits_counted.sum())
        _check(int(res_m.bits_counted[0]) == cfg.mimo.n_streams * S * N * cfg.modulation
               .bits_per_symbol, f"{label}: bits_counted")
        m_ber[key] = int(res_m.bit_errors.sum()) / bits_m
        del res_m
        extra = ""
        if key in m_theory:
            name, th = m_theory[key]
            _check(abs(m_ber[key] / th - 1) <= 0.10,
                   f"{label}: BER {m_ber[key]:g} vs {name} {th:g} (allowed 10 %)")
            extra += f", {name} {th:.6g} (ratio {m_ber[key] / th:.5f}, allowed 10 %)"
        if key in m_drawn:
            fade = pipeline.mimo_fading(cfg, seed, ids[:cfg.n_channels])
            if cfg.channel.model == ChannelModel.MULTIPATH:
                fade = chan.freq_response(fade, N)
            g2 = (fade.abs() ** 2).sum(dim=(1, 2)).to(torch.float64) * m_drawn[key]
            want_m = ber_given_gain(cfg.modulation, cfg.channel.ebno_db, g2)
            _check(abs(m_ber[key] / want_m - 1) <= 0.02,
                   f"{label}: BER {m_ber[key]:g} vs {want_m:g} over the drawn channel")
            extra += (f", over the drawn channel {want_m:.6g} (ratio {m_ber[key] / want_m:.5f}, "
                      "allowed 2 %)")
            del fade, g2
        m_rows.append(dict(key=key, label=label, ms=ms_m, ber=m_ber[key], peak_gib=peak_m,
                           launches=per_m))
        print(f"phase 3m pipeline.simulate {cfg.n_channels}x{S} config 2 {label}: BER "
              f"{m_ber[key]:.6g}{extra}; {ms_m:.3f} ms (median of 3 warm calls, CUDA events), "
              f"peak {peak_m:.2f} GiB allocated, launches a call {per_m} on {card}")
    for rule, gate in m_gates:
        _check(gate(m_ber), f"phase 3m: {rule} fails: {m_ber}")
        print(f"phase 3m gate met: {rule}")
    _check(max(r["peak_gib"] for r in m_rows) < 40.0, "phase 3m: a link's peak exceeds 40 GiB")
    for name in mimo_path:
        _check(launches_mimo[name] > 0, f"phase 3m: kernel {name} was not launched")
    print(f"phase 3m: {len(m_rows)} links in {time.perf_counter() - t3m:.1f} s (the largest peak "
          f"{max(r['peak_gib'] for r in m_rows):.2f} GiB allocated); window "
          f"{ {k: v for k, v in launches_mimo.items() if v} }")

    # ---- phase 3v: time-varying and impaired MIMO, counters zeroed -------------
    # First the link's new kernel shapes, one pass of ``pipeline.CHUNK``
    # channels: kernel E's channel-only mode over the pair plane with
    # per-symbol gains (RAYLEIGH_TIME, genie: S' = 64 rows) and per-symbol
    # taps with in-plane history (MULTIPATH_TIME with midambles, S' = 96),
    # over the acquired pair plane (per-symbol gains and the tail row, 83
    # rows), its noise-only mode over the acquired streams (B, n_rx, T), T
    # odd (off the 16-byte grid), and C's post-FFT mode with h per symbol on
    # the per-symbol detector's whitened tones — each against its plain
    # version (phase 2's tolerances) and timed beside it; then the receive's
    # parts timed alone on that pass; then the links of ``mimo_time_links``
    # through ``pipeline.simulate``, each inside ``in_mimo_time()``, with ms
    # the median of 3 warm calls, its peak memory and its launches; then the
    # gates.
    from sdr_tpu_torch.core.config import Equalizer

    t3v = time.perf_counter()
    launches_mimo_time = dict.fromkeys(_lib.LAUNCHES, 0)
    v_links, v_theory, v_drawn, v_gates = mimo_time_links(B, B // 4)
    v_cfg = {key: cfg for key, _, cfg in v_links}
    ids_v = ids[:P]

    def v_cfg_p(key):
        return dataclasses.replace(v_cfg[key], n_channels=P)

    v_parts = {}

    def v_part(label, fn):
        out = fn()  # warm
        v_parts[label] = timed(fn, 3)
        return out

    cfg_g = v_cfg_p("a22_fast20")  # genie RAYLEIGH_TIME: per-symbol gains on 64 rows
    tx_g = pipeline.mimo_tx(cfg_g, pipeline.draw_mimo_idx(cfg_g, seed, ids_v))
    pair_g = pipeline.pair_plane(tx_g, 2)
    del tx_g
    e_check("3v", "MIMO pair plane, per-symbol gains (RAYLEIGH_TIME)",
            "fade_awgn@mimo_time_pair_gains", "fade_awgn", cfg_g, pair_g, launches_mimo_time, S)
    del pair_g
    cfg_t = v_cfg_p("tdl_a22_k4")  # MULTIPATH_TIME with midambles: per-symbol taps, 96 rows
    tx_t = v_part("B off + midamble rows (Alamouti 2x2, K 4: 96 rows)",
                  lambda: pipeline.mimo_tx(cfg_t, pipeline.draw_mimo_idx(cfg_t, seed, ids_v)))
    Sp_t = tx_t[0].shape[2]
    pair_t = pipeline.pair_plane(tx_t, 2)
    e_check("3v", "MIMO pair plane, per-symbol taps (MULTIPATH_TIME, 3 taps, midambles)",
            "fade_awgn_fir@mimo_time_pair_taps", "fade_awgn_fir", cfg_t, pair_t,
            launches_mimo_time, Sp_t)
    del pair_t
    cfg_j = v_cfg_p("jk_acq")  # acquired RAYLEIGH_TIME MRC: 2 + 80 + 1 rows
    tx_j = pipeline.mimo_tx(cfg_j, pipeline.draw_mimo_idx(cfg_j, seed, ids_v))
    pair_j = pipeline.pair_plane(tx_j, 2)
    e_check("3v", "acquired MIMO pair plane, per-symbol gains and the tail row",
            "fade_awgn@mimo_time_acquired_plane", "fade_awgn", cfg_j, pair_j,
            launches_mimo_time, tx_j[0].shape[2] - 1, tail=True)
    del pair_j, tx_j
    cfg_a = v_cfg_p("acq_walk_iq")
    tx_a = v_part("B off + sync and midamble rows (Alamouti 2x2, acquired: 99 rows)",
                  lambda: pipeline.mimo_tx(cfg_a, pipeline.draw_mimo_idx(cfg_a, seed, ids_v)))
    z_a = v_part("mimo_stream (PA, E on the pair plane, TX sum, delay, CFO, E's noise, walk, "
                 "I/Q and its compensation)",
                 lambda: pipeline.mimo_stream(cfg_a, seed, ids_v, tx_a))
    del tx_a
    T_v = z_a.shape[-1]
    st_shape = (P, 2, T_v)
    st = tuple(t.contiguous() for t in fast._planar(z_a))
    nv_v = pipeline.mimo_noise_var(cfg_a)
    rep = check_modes(f"E noise only on the acquired MIMO streams ({P}x2x{T_v})",
                      lambda **kw: ke.fade_awgn(*st, noise_var=nv_v / N, **kw),
                      lambda **kw: ke.fade_awgn_plain(*st, noise_var=nv_v / N, **kw),
                      st_shape, kernel_reps=10)
    n_st = st[0].numel()
    rep.update(bound(16 * n_st + 4 * P, 4 * n_st, n_st * PHILOX_IMUL))
    e_rows.append(dict(rep, mode="noise only, acquired MIMO streams", counter="fade_awgn",
                       shape="x".join(map(str, st_shape)), window=launches_mimo_time))
    report["fade_awgn@mimo_time_stream_noise"] = rep
    del st
    v_part(f"mixer (LO walk draw, I/Q, per-antenna compensation; {P}x2x{T_v})",
           lambda: pipeline.mixer(cfg_a, seed, ids_v, z_a, compensate_lag=N + CP))
    start_v, total_v = v_part("acquire_array_start", lambda: sync.acquire_array_start(z_a, N, CP))
    Sp_a = pipeline.n_tx_symbols(cfg_a)
    v_part("the CFO-corrected slice (corrected_slice, every antenna)",
           lambda: sync.corrected_slice(z_a, total_v, start_v[:, None], Sp_a * (N + CP), N))
    del z_a
    # The per-symbol receive on the MULTIPATH_TIME midamble link's frame.
    rx_t, _ = pipeline.mimo_channel(cfg_t, seed, ids_v, tx_t)
    del tx_t
    y_t = t_ofdm_rx(torch.complex(*rx_t), CP)
    del rx_t
    for est_key in ("tdl_a22_k4", "tdl_a22_k4_dft"):
        h_v, y_dv = v_part(f"midamble estimate ({v_cfg[est_key].estimator.value}, per tone)",
                           lambda: pipeline.estimate_mimo_midamble(v_cfg_p(est_key), y_t))
    cfg_rt = v_cfg_p("m12_k4_005")
    y_rt = torch.complex(torch.randn((P, 2, pipeline.n_tx_symbols(cfg_rt), N), device=dev),
                         torch.randn((P, 2, pipeline.n_tx_symbols(cfg_rt), N), device=dev))
    v_part("midamble estimate (RAYLEIGH_TIME, tone mean)",
           lambda: pipeline.estimate_mimo_midamble(cfg_rt, y_rt))
    del y_rt
    nv_t = pipeline.mimo_noise_var(cfg_t)
    s_v, eff_v = v_part("per-symbol detector: Alamouti (pair-mean H, per tone)",
                        lambda: pipeline.mimo_detect_per_symbol(cfg_t, y_dv, h_v, nv_t))
    h_mrc = h_v[:, :, :, :1].contiguous()
    v_part("per-symbol detector: MRC 1x2 (per tone)",
           lambda: pipeline.mimo_detect_per_symbol(v_cfg_p("tdl_m12"), y_dv, h_mrc, nv_t))
    for key, label in (("mmse_mid", "MMSE"), ("sic_fast", "SIC"), ("ml_fast", "ML")):
        cfg_d = v_cfg_p(key)
        v_part(f"per-symbol detector: mux 2x2 {label} ({cfg_d.modulation.value}, per tone)",
               lambda: pipeline.mimo_detect_per_symbol(cfg_d, y_dv, h_v, nv_t))
    cfg_zf = dataclasses.replace(v_cfg_p("mmse_mid"), equalizer=Equalizer.ZF)
    v_part("per-symbol detector: mux 2x2 ZF (qpsk, per tone)",
           lambda: pipeline.mimo_detect_per_symbol(cfg_zf, y_dv, h_v, nv_t))
    v_part("whitened_llrs (h per symbol, then llr_chain)",
           lambda: pipeline.whitened_llrs(cfg_t, s_v, eff_v))
    # C's post-FFT mode on those whitened tones, h per symbol and tone.
    Bw, Kw, Sw, Nw = s_v.shape
    g_w = torch.rsqrt(torch.clamp(eff_v, min=pipeline._EFF_FLOOR))
    y_w = torch.view_as_real((s_v * g_w).reshape(Bw * Kw, Sw, Nw))
    hr_w = g_w.expand(Bw, Kw, Sw, Nw).reshape(Bw * Kw, Sw, Nw).contiguous()
    hi_w = torch.zeros_like(hr_w)
    mod_t = v_cfg["tdl_a22_k4"].modulation
    got = kc.llr_chain(y_w, None, hr_w, hi_w, mod_t, 1.0)
    want = kc.llr_chain_plain(y_w, None, hr_w, hi_w, mod_t, 1.0)
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    _check(err <= 1e-4 * peak, f"C llr_chain on per-symbol whitened MIMO tones: max abs diff "
                               f"{err:g} > 1e-4 of the peak {peak:g}")
    del got, want
    ms, pms = compare_times(lambda: kc.llr_chain(y_w, None, hr_w, hi_w, mod_t, 1.0),
                            lambda: kc.llr_chain_plain(y_w, None, hr_w, hi_w, mod_t, 1.0),
                            reps=1, kernel_reps=10)
    rep = dict(max_abs_err=err, ms=ms, plain_ms=pms,
               **chain_bound(Bw * Kw, Sw, Nw, Sw, mod_t, False))
    report["llr_chain@mimo_time_h_per_symbol"] = rep
    print(f"phase 3v C llr_chain on per-symbol whitened MIMO tones (h per symbol and tone, "
          f"{Bw * Kw}x{Sw}x{Nw}): max abs diff {err:.3g} (peak {peak:.3g}, allowed 1e-4 of "
          f"it); kernel {ms:.4f} ms, plain {pms:.3f} ms; {of_bound(rep)} on {card}")
    del y_w, hr_w, hi_w, g_w, s_v, eff_v, y_dv, h_v, h_mrc, y_t
    torch.cuda.empty_cache()
    print(f"phase 3v link parts (one pass of {P} channels; CUDA events, 3 warm calls each): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in v_parts.items()) + f" on {card}")

    @contextlib.contextmanager
    def in_mimo_time():
        _lib.reset_launches()
        yield
        for k, v in _lib.LAUNCHES.items():
            launches_mimo_time[k] += v

    v_ber, v_rows = {}, []
    for key, label, cfg in v_links:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with in_mimo_time():
            res_v = pipeline.simulate(cfg, seed, device=dev)
            torch.cuda.synchronize()
            per_v = {k: v for k, v in _lib.LAUNCHES.items() if v}
            ms_v = sorted(timed(lambda: pipeline.simulate(cfg, seed, device=dev), 1)
                          for _ in range(3))[1]
        peak_v = torch.cuda.max_memory_allocated() / 2 ** 30
        n_bits = cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
        _check(bool((res_v.bits_counted == n_bits).all()), f"{label}: bits_counted")
        v_ber[key] = (res_v.bit_errors.to(torch.float64) / n_bits).cpu().numpy()
        del res_v
        ber_v = float(v_ber[key].mean())
        extra = ""
        if key in v_theory:
            name, th = v_theory[key]
            _check(abs(ber_v / th - 1) <= 0.10,
                   f"{label}: BER {ber_v:g} vs {name} {th:g} (allowed 10 %)")
            extra += f", {name} {th:.6g} (ratio {ber_v / th:.5f}, allowed 10 %)"
        if key in v_drawn:
            fade = pipeline.mimo_fading(cfg, seed, ids[:cfg.n_channels], S)
            g2 = (fade.abs() ** 2).sum(dim=(1, 2)).to(torch.float64)  # (B, S, 1): Σ_r |h_rs|²
            want_v = ber_given_gain(cfg.modulation, cfg.channel.ebno_db, g2)
            _check(abs(ber_v / want_v - 1) <= 0.02,
                   f"{label}: BER {ber_v:g} vs {want_v:g} over the drawn per-symbol channel")
            extra += (f", over the drawn per-symbol channel {want_v:.6g} (ratio "
                      f"{ber_v / want_v:.5f}, allowed 2 %)")
            del fade, g2
        outage = float((v_ber[key] > 0.25).mean())
        v_rows.append(dict(key=key, label=label, ms=ms_v, ber=ber_v, peak_gib=peak_v,
                           launches=per_v))
        print(f"phase 3v pipeline.simulate {cfg.n_channels}x{S} config 2 {label}: BER "
              f"{ber_v:.6g}{extra}; channels with BER > 0.25 {outage:.5f}; {ms_v:.3f} ms "
              f"(median of 3 warm calls, CUDA events), peak {peak_v:.2f} GiB allocated, "
              f"launches a call {per_v} on {card}")
    for rule, gate in v_gates:
        _check(gate(v_ber), f"phase 3v: {rule} fails: "
                            f"{ {k: float(v.mean()) for k, v in v_ber.items()} }")
        print(f"phase 3v gate met: {rule}")
    _check(max(r["peak_gib"] for r in v_rows) < 40.0, "phase 3v: a link's peak exceeds 40 GiB")
    for name in mimo_path:
        _check(launches_mimo_time[name] > 0, f"phase 3v: kernel {name} was not launched")
    print(f"phase 3v: {len(v_rows)} links in {time.perf_counter() - t3v:.1f} s (the largest peak "
          f"{max(r['peak_gib'] for r in v_rows):.2f} GiB allocated); window "
          f"{ {k: v for k, v in launches_mimo_time.items() if v} }")

    # ---- phase 3k: the coded links (item 11f), counters zeroed ----------------
    # First each decoder alone at full width, on the card and, for the first
    # 256 channels of the same LLR tensor, on the CPU (decisions equal): the
    # Viterbi decoder at config 2's frame (B, 65536) and the polar fast-SSCL
    # decoder over B × 256 codewords of (256, 128) CRC-11, L 8, each timed as
    # the median of 3 warm calls (CUDA events) with its peak memory; then the
    # kernels the coded links run, at their shapes, against their plain
    # versions (phase 2's tolerances) and timed beside them — B off on the
    # conv link's interleaved frame, E's noise over it, C's plane of it, H
    # on the LDPC link's LLRs; then the config-2 links at B × 64
    # (``coded_link_cell``) through ``make_family_fn``, each inside
    # ``in_coded_link()``: its gates, ms of the counted call (CUDA events,
    # warm: the decoders and kernels ran just before), peak memory and
    # launches; then the JAX tests' compositions and sweep points at their
    # own sizes, in the same window.
    from sdr_tpu_torch.link import coded as coded_k
    from sdr_tpu_torch.link import pipeline as pipe_k
    from sdr_tpu_torch.ops import fec as fec_k
    from sdr_tpu_torch.ops.polar import polar_encode_payload

    t3k = time.perf_counter()
    launches_coded_link = dict.fromkeys(_lib.LAUNCHES, 0)
    coded_link_path = ("tx_off", "fade_awgn", "demod_llr", "ldpc_minsum")
    cfg_k = coded_link_cell(B)
    n_cmp = min(256, B)
    gen_k = torch.Generator(device=dev).manual_seed(seed + 23)

    def median3(fn):
        return sorted(timed(fn, 1) for _ in range(3))[1]

    def noisy_llrs(bits, sigma):
        """BPSK LLRs 2y/σ² of the coded bits at noise σ."""
        y = (1.0 - 2.0 * bits.to(torch.float32)) + sigma * torch.randn(
            bits.shape, device=dev, generator=gen_k)
        return y * (2.0 / sigma ** 2)

    def decoder_alone(label, decode, llr, sent, n_work):
        """The decoder at full width: warm call and peak above its input,
        median of 3 warm calls, the CPU on the first n_cmp channels."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dec = decode(llr)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        ms = median3(lambda: decode(llr))
        t_c = time.perf_counter()
        dec_c = decode(llr[:n_cmp].cpu())
        t_c = time.perf_counter() - t_c
        _check(torch.equal(dec_c, dec[:n_cmp].cpu()),
               f"phase 3k {label}: the card's decisions differ from the CPU's")
        ber = float((dec != sent).to(torch.float64).mean())
        print(f"phase 3k {label}: {ms:.3f} ms (median of 3 warm calls, CUDA events), peak "
              f"{peak:.3f} GiB above its input, {n_work}; decisions equal to the CPU's on the "
              f"first {n_cmp} channels ({t_c:.1f} s there); BER {ber:.6g} on {card}")
        return dict(ms=ms, peak_gib=peak, cpu_s=t_c, ber=ber)

    n_info_k = coded_k.info_bits_per_channel(cfg_k)
    info_v = prng.info_bits(seed, ids, 1, n_info_k)[:, 0]
    T_v = n_info_k + fec_k.DEFAULT_K - 1
    llr_v = noisy_llrs(fec_k.conv_encode(info_v), 0.9)
    k_dec = {"viterbi": decoder_alone(
        f"viterbi_decode alone ({B} x {2 * T_v} LLRs, K 7 rate 1/2, T {T_v} steps)",
        lambda x: fec_k.viterbi_decode(x, n_info_k), llr_v, info_v,
        f"{T_v} forward steps of 3 launches and {T_v} traceback steps of 6")}
    del llr_v, info_v
    code_p = coded_k.polar_code_for()
    n_cw_p = coded_k.polar_codewords_per_channel(cfg_k, code_p.block_len)
    pay_p = prng.info_bits(seed, ids, n_cw_p, code_p.payload_len)
    llr_pp = noisy_llrs(polar_encode_payload(pay_p, code_p), 0.8)
    step_p = coded_k.polar_pass_channels(code_p, n_cw_p, 8)
    k_dec["polar"] = decoder_alone(
        f"polar fast-SSCL alone ({B * n_cw_p} codewords of (256, 128) CRC-11, L 8)",
        lambda x: coded_k.polar_decode_passes(x, code_p, 8), llr_pp, pay_p,
        f"passes of {step_p} channels ({step_p * n_cw_p} codewords)")
    del llr_pp, pay_p

    # The kernels at the coded links' shapes.
    frame_k = torch.zeros((B, coded_k.frame_bits(cfg_k)), dtype=torch.int8, device=dev)
    cw_k = fec_k.conv_encode(prng.info_bits(seed, ids, 1, n_info_k)[:, 0])
    frame_k[:, :cw_k.shape[1]] = cw_k
    del cw_k
    bits_k = interleave(frame_k).view(B, S, N * bps)
    del frame_k
    idx_k = pipe_k._bits_to_ints(bits_k, bps).to(ka.out_dtype(bps))
    del bits_k
    got = kb.tx_chain(idx_k, CP, mod)
    off_err = plane_err(got, kb.tx_channel_plain(idx_k, CP, mod))
    _check(off_err <= 1e-5 * plane_peak(got), f"3k B off: max abs diff {off_err:g}")
    del got
    ms, pms = compare_times(lambda: kb.tx_chain(idx_k, CP, mod),
                            lambda: kb.tx_channel_plain(idx_k, CP, mod), reps=1)
    report["tx_off@coded_link"] = dict(
        b_timed("channel off, the conv link's frame", "tx_off", N, CP, B, S, 1, ms, pms, 0, 0,
                False), max_abs_err=off_err)
    print(f"phase 3k B off on the conv link's interleaved frame ({B}x{S}x{N + CP}): max abs "
          f"diff {off_err:.3g}; kernel {ms:.4f} ms, plain {pms:.3f} ms; "
          f"{of_bound(report['tx_off@coded_link'])} on {card}")
    tx_k = kb.tx_chain(idx_k, CP, mod)
    nv_k = fast.noise_var(cfg_k)
    rep = check_modes(f"E noise only on the conv link's waveform ({B}x{S}x{N + CP})",
                      lambda **kw: ke.fade_awgn(*tx_k, noise_var=nv_k / N, **kw),
                      lambda **kw: ke.fade_awgn_plain(*tx_k, noise_var=nv_k / N, **kw),
                      (B, S, N + CP), kernel_reps=10)
    n_tx_k = tx_k[0].numel()
    rep.update(bound(16 * n_tx_k + 4 * B, 4 * n_tx_k, n_tx_k * PHILOX_IMUL))
    e_rows.append(dict(rep, mode="noise only, the conv link's waveform", counter="fade_awgn",
                       window=launches_coded_link))
    report["fade_awgn@coded_link"] = rep
    re_k, im_k = ke.fade_awgn(*tx_k, noise_var=nv_k / N, seed=seed, ch_ids=ids)
    del tx_k
    hr_k = torch.ones((B, 1, N), device=dev)
    hi_k = torch.zeros((B, 1, N), device=dev)
    c_err, c_peak = llr_check("3k C llr plane",
                              kc.demod_llr(re_k, im_k, hr_k, hi_k, CP, mod, nv_k),
                              kc.demod_chain(re_k, im_k, hr_k, hi_k, CP, mod, nv_k))
    ms, pms = compare_times(lambda: kc.demod_llr(re_k, im_k, hr_k, hi_k, CP, mod, nv_k),
                            lambda: kc.demod_chain(re_k, im_k, hr_k, hi_k, CP, mod, nv_k),
                            reps=1)
    report["demod_llr@coded_link"] = dict(
        max_abs_err=c_err, ms=ms, plain_ms=pms,
        **bound(8 * nrow * N + 8 * B * N + 4 * nrow * N * bps,
                nrow * (fft_flops(N) + N * tail_flops(mod))))
    print(f"phase 3k C llr plane of the conv link ({B}x{S}x{N * bps} f32): max abs diff "
          f"{c_err:.3g} (peak {c_peak:.3g}, allowed 1e-4 of it); kernel {ms:.4f} ms, plain "
          f"{pms:.3f} ms; {of_bound(report['demod_llr@coded_link'])} on {card}")
    del re_k, im_k, hr_k, hi_k, idx_k
    code_h = ldpc_code_for("1/2")
    n_cw_h = ldpc_codewords_per_channel(cfg_k, code_h)
    cw_h = ldpc_encode(code_h, prng.info_bits(seed, ids, n_cw_h, code_h.k)).reshape(B, -1)
    llr_h = coded_k._carry(cfg_k, seed, ids, cw_h, {}).reshape(B * n_cw_h, code_h.n)
    del cw_h
    want = kh.ldpc_decode_plain(code_h, llr_h, 25, 0.5, "flooding")
    n_diff = int((kh.ldpc_decode(code_h, llr_h, 25, 0.5, "flooding") != want).sum())
    _check(n_diff == 0, f"3k H on the LDPC link's LLRs: {n_diff} hard bits differ from plain")
    del want
    pms = timed(lambda: kh.ldpc_decode_plain(code_h, llr_h, 25, 0.5, "flooding"), 1)
    ms = timed(lambda: kh.ldpc_decode(code_h, llr_h, 25, 0.5, "flooding"), 3)
    report["ldpc_minsum@coded_link"] = dict(max_abs_err=float(n_diff), ms=ms, plain_ms=pms,
                                            **h_bound(code_h, B * n_cw_h, 25))
    print(f"phase 3k H flooding 25 on the LDPC link's LLRs ({B * n_cw_h} codewords): hard bits "
          f"identical to plain; kernel {ms:.3f} ms (mean of 3 calls), plain {pms:.3f} ms (1 call); "
          f"{of_bound(report['ldpc_minsum@coded_link'])} on {card}")
    del llr_h
    torch.cuda.empty_cache()

    @contextlib.contextmanager
    def in_coded_link():
        _lib.reset_launches()
        yield
        for k, v in _lib.LAUNCHES.items():
            launches_coded_link[k] += v

    def coded_run(label, fn, seed_k=seed):
        """(errors, counted) of fn(seed_k) inside the window, with its ms
        (CUDA events), peak memory and launches printed."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with in_coded_link():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            errors, counted = fn(seed_k)
            end.record()
            torch.cuda.synchronize()
            per = {k: v for k, v in _lib.LAUNCHES.items() if v}
        ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ber = int(errors.sum()) / int(counted.sum())
        print(f"phase 3k {label}: BER {ber:.6g} ({int(errors.sum())} of {int(counted.sum())} info "
              f"bits); {ms:.3f} ms (CUDA events), peak {peak:.2f} GiB allocated, launches a call "
              f"{per} on {card}")
        return errors, ber, dict(label=label, ms=ms, peak_gib=peak, ber=ber, launches=per)

    th_k = ber_awgn_exact(mod, cfg_k.channel.ebno_db)
    k_rows, k_ber = [], {}
    for key, fam, kw in (("conv 1/2", "conv", dict(rate="1/2")),
                         ("conv 2/3", "conv", dict(rate="2/3")),
                         ("conv 3/4", "conv", dict(rate="3/4")),
                         ("LDPC 1/2 flooding 25", "ldpc", dict(iters=25)),
                         ("polar (256, 128) CRC-11 L 8", "polar", dict(list_size=8))):
        _, k_ber[key], row = coded_run(
            f"{key} at {B}x{S} config 2 AWGN {cfg_k.channel.ebno_db:g} dB",
            coded_k.make_family_fn(cfg_k, fam, device=dev, **kw))
        k_rows.append(row)
    k_gates = (
        ("conv 1/2 < uncoded theory / 10 (tests/test_fec.py:84-100)",
         k_ber["conv 1/2"] < th_k / 10),
        ("BER(1/2) <= BER(2/3) <= BER(3/4) (tests/test_fec.py:144-172)",
         k_ber["conv 1/2"] <= k_ber["conv 2/3"] <= k_ber["conv 3/4"]),
        ("LDPC 1/2 < 1/12288: the JAX test's zero errors in 8 x 1536 info bits where "
         "uncoded errs, as a rate (tests/test_ldpc.py:86-95)",
         k_ber["LDPC 1/2 flooding 25"] < 1.0 / 12288),
        ("polar < uncoded theory / 6.25 (2e-3 against 1.25e-2, tests/test_polar.py:111-131)",
         k_ber["polar (256, 128) CRC-11 L 8"] < th_k / 6.25),
    )
    for rule, ok in k_gates:
        _check(ok, f"phase 3k: {rule} fails: {k_ber} (uncoded theory {th_k:g})")
        print(f"phase 3k gate met: {rule} (uncoded theory {th_k:.6g})")
    _check(max(r["peak_gib"] for r in k_rows) < 16.0, "phase 3k: a link's peak exceeds 16 GiB")

    # The JAX tests' compositions and sweep points at their own sizes.
    from sdr_tpu_torch.core.config import Equalizer, MIMOConfig, MIMOScheme

    base_sc = LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(n_fft=128, cp_len=16),
                         channel=ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=14.0,
                                               pdp=(1.0, 0.3)),
                         equalizer=Equalizer.MMSE, pilot_spacing=8, n_symbols=32,
                         n_channels=8, dft_spread=True)
    for fam in coded_k.CODE_FAMILIES:
        e_sc, _, _ = coded_run(f"SC-FDMA block pilots {fam} (tests/test_scfdma.py:328-355, 8 x "
                               f"32)", coded_k.make_family_fn(base_sc, fam, device=dev), 2)
        clean = int((e_sc == 0).sum())
        _check(clean >= 6, f"phase 3k SC-FDMA {fam}: {clean} of 8 channels error-free")
        print(f"phase 3k gate met: SC-FDMA {fam} {clean} of 8 channels error-free (>= 6)")
    cfg_mm = LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(n_fft=128, cp_len=16),
                        channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=10.0),
                        mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble"),
                        equalizer=Equalizer.MMSE, n_symbols=16, n_channels=8)
    e_mm, _, _ = coded_run("polar over Alamouti 2x2 preamble CSI, L 4 (tests/test_scfdma.py:"
                           "358-380, 8 x 16)",
                           coded_k.make_polar_fn(cfg_mm, list_size=4, device=dev), 1)
    _check(int(e_mm.sum()) <= 10, f"phase 3k polar over MIMO: {int(e_mm.sum())} errors > 10")
    print(f"phase 3k gate met: polar over Alamouti 2x2, {int(e_mm.sum())} payload errors (<= 10)")
    cfg_sw = LinkConfig(modulation=Modulation.QPSK, ofdm=OFDMConfig(n_fft=128, cp_len=16),
                        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=5.0),
                        n_symbols=16, n_channels=4)
    for fam in ("conv", "polar"):
        with in_coded_link():
            res_sw = ebno_sweep(cfg_sw, [5.0], seed=1, target_errors=1, max_bits=10_000,
                                code=fam, device=dev)
        pt = res_sw.points[0]
        th_sw = res_sw.theory(Modulation.QPSK)[0]
        _check(pt.ber < th_sw and res_sw.config_summary.endswith(f"/{fam}-1/2/torch"),
               f"phase 3k sweep {fam}: BER {pt.ber:g} vs theory {th_sw:g}")
        print(f"phase 3k sweep point {fam} at 5 dB (tests/test_obs.py:65-91, 4 x 16): BER "
              f"{pt.ber:.6g} < uncoded theory {th_sw:.6g}, {pt.batches} invocations, summary "
              f"{res_sw.config_summary}")
    for name in coded_link_path:
        _check(launches_coded_link[name] > 0, f"phase 3k: kernel {name} was not launched")
    print(f"phase 3k the decoders alone against their links: Viterbi "
          f"{k_dec['viterbi']['ms'] / k_rows[0]['ms']:.3f} of conv 1/2's time, polar "
          f"{k_dec['polar']['ms'] / k_rows[4]['ms']:.3f} of the polar link's; H "
          f"{report['ldpc_minsum@coded_link']['ms'] / k_rows[3]['ms']:.3f} of LDPC's")
    print(f"phase 3k: {len(k_rows)} config-2 links and the compositions in "
          f"{time.perf_counter() - t3k:.1f} s (the largest peak "
          f"{max(r['peak_gib'] for r in k_rows):.2f} GiB allocated); window "
          f"{ {k: v for k, v in launches_coded_link.items() if v} }")

    # ---- phase 3x: the packet modem (item 11g), counters zeroed -----------------
    # The modem's own numerology (``PacketConfig``'s defaults: 64 bytes, QPSK,
    # N 64, CP 16, comb spacing 8), B packets a campaign. First the kernels a
    # campaign runs, at its shapes, against their plain versions (outside the
    # window): B's comb on the bodies, E's channel alone over the
    # (B, 3 + S, N+cp) burst plane (static taps), E's keyed noise over the
    # (B, 1, T) stream row, C's LLR plane on the tracked comb estimate, H on
    # the LDPC campaign's LLRs. Then each campaign inside ``in_packet()``:
    # the first call gated (the JAX ``tests/test_packet.py`` forms), then ms
    # as the median of 3 warm calls (CUDA events), packets/s, and the
    # decoder alone on the campaign's LLRs (its share); the JAX block-code
    # test's 5 packets; ``receive_stream`` on 1024 captures of three bursts;
    # the card's decisions against the CPU's on 64 packets.
    import numpy as np

    from sdr_tpu_torch.link import packet as pk

    t3x = time.perf_counter()
    launches_packet = dict.fromkeys(_lib.LAUNCHES, 0)
    packet_path = ("tx_comb", "fade_awgn", "fade_awgn_fir", "demod_llr", "ldpc_minsum")
    NP = B
    pc_x = pk.PacketConfig()
    S_x, L_x, N_x, CP_x = pc_x.n_symbols, pc_x.ofdm.symbol_len, pc_x.ofdm.n_fft, pc_x.ofdm.cp_len
    ids_x = torch.arange(NP, dtype=torch.int32, device=dev)
    mp16 = ChannelConfig(model=ChannelModel.MULTIPATH, ebno_db=16.0, pdp=(1.0, 0.5),
                         cfo_subcarriers=1.3, timing_offset=37)

    @contextlib.contextmanager
    def in_packet():
        _lib.reset_launches()
        yield
        for k, v in _lib.LAUNCHES.items():
            launches_packet[k] += v

    # The kernels at the packet shapes.
    cfg_x = pc_x._link_cfg()
    bits_x = torch.randint(0, 2, (NP, S_x, cfg_x.bits_per_ofdm_symbol), dtype=torch.int8,
                           device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    idx_x = pipeline._grid_of(cfg_x, pipeline._bits_to_ints(bits_x, 2).to(ka.out_dtype(2)))
    del bits_x
    got = kb.tx_chain(idx_x, CP_x, Modulation.QPSK, pilot_spacing=8)
    comb_err = plane_err(got, kb.tx_channel_plain(idx_x, CP_x, Modulation.QPSK, pilot_spacing=8))
    _check(comb_err <= 1e-5 * plane_peak(got), f"3x B comb: max abs diff {comb_err:g}")
    del got
    ms, pms = compare_times(lambda: kb.tx_chain(idx_x, CP_x, Modulation.QPSK, pilot_spacing=8),
                            lambda: kb.tx_channel_plain(idx_x, CP_x, Modulation.QPSK,
                                                        pilot_spacing=8), reps=1, kernel_reps=10)
    report["tx_comb@packet"] = dict(
        b_timed("comb, channel off, a packet's body", "tx_comb", N_x, CP_x, NP, S_x, 1, ms, pms,
                0, 0, False), max_abs_err=comb_err)
    b_rows[-1]["window"] = launches_packet
    print(f"phase 3x B comb on the packets' bodies ({NP}x{S_x}x{L_x}): max abs diff "
          f"{comb_err:.3g}; kernel {ms:.4f} ms, plain {pms:.3f} ms; "
          f"{of_bound(report['tx_comb@packet'])} on {card}")
    del idx_x
    burst_x = pk.encode_packet(pc_x, pk.draw_payload(pc_x, seed, ids_x))
    n_rows_x = burst_x.shape[1] // L_x
    plane_x = tuple(torch.cat([t, torch.zeros((NP, 1, L_x), device=dev)], dim=1).contiguous()
                    for t in fast._planar(burst_x.reshape(NP, n_rows_x, L_x)))
    kw_x = pk._fading(pc_x, mp16, seed, ids_x, None, n_rows_x)
    want = ke.fade_awgn_plain(*plane_x, **kw_x)
    err, peak = plane_err(ke.fade_awgn(*plane_x, **kw_x), want), plane_peak(want)
    del want
    _check(err <= 1e-5 * peak, f"3x E channel only on the burst plane: max abs diff {err:g}")
    ms, pms = compare_times(lambda: ke.fade_awgn(*plane_x, **kw_x),
                            lambda: ke.fade_awgn_plain(*plane_x, **kw_x), reps=1, kernel_reps=10)
    n_pl = plane_x[0].numel()
    rep = dict(max_abs_err=err, ms=ms, plain_ms=pms,
               **bound(16 * n_pl + 8 * kw_x["taps_r"].numel(), 8 * 2 * n_pl))
    report["fade_awgn_fir@packet"] = rep
    e_rows.append(dict(rep, mode="channel only, the packets' burst plane, static taps (1, .5)",
                       counter="fade_awgn_fir", shape=f"{NP}x{n_rows_x + 1}x{L_x}",
                       n_fft=N_x, window=launches_packet))
    print(f"phase 3x E channel only on the burst plane ({NP}x{n_rows_x + 1}x{L_x}, static taps "
          f"(1, .5)): max abs diff {err:.3g} (peak {peak:.3g}); kernel {ms:.4f} ms, plain "
          f"{pms:.3f} ms; {of_bound(rep)} on {card}")
    del plane_x, kw_x
    stream_x, nv_x = pk.transmit_over_channel(pc_x, mp16, seed, burst_x, ids_x)
    T_x = stream_x.shape[1]
    row_x = fast._planar(stream_x[:, None, :])
    rep = check_modes(f"E noise only on the packets' stream row ({NP}x1x{T_x})",
                      lambda **kw: ke.fade_awgn(*row_x, noise_var=nv_x / N_x, **kw),
                      lambda **kw: ke.fade_awgn_plain(*row_x, noise_var=nv_x / N_x, **kw),
                      (NP, 1, T_x), kernel_reps=10)
    rep.update(bound(16 * NP * T_x + 4 * NP, 4 * NP * T_x, NP * T_x * PHILOX_IMUL))
    report["fade_awgn@packet"] = rep
    e_rows.append(dict(rep, mode=f"noise only, the packets' stream row 1 x {T_x}",
                       counter="fade_awgn", shape=f"{NP}x1x{T_x}", n_fft=N_x,
                       window=launches_packet))
    del row_x
    _, planes_x = pk._acquire(pc_x, stream_x)
    _, h_x = pipeline._estimate(cfg_x, planes_x, track_phase=True)
    hr_x, hi_x = fast._planar(h_x.to(torch.complex64))
    c_err, c_peak = llr_check(
        "3x C llr plane", kc.demod_llr(*planes_x, hr_x, hi_x, CP_x, Modulation.QPSK, nv_x),
        kc.demod_chain(*planes_x, hr_x, hi_x, CP_x, Modulation.QPSK, nv_x))
    ms, pms = compare_times(
        lambda: kc.demod_llr(*planes_x, hr_x, hi_x, CP_x, Modulation.QPSK, nv_x),
        lambda: kc.demod_chain(*planes_x, hr_x, hi_x, CP_x, Modulation.QPSK, nv_x), reps=1,
        kernel_reps=10)
    rows_x = NP * S_x
    report["demod_llr@packet"] = dict(
        max_abs_err=c_err, ms=ms, plain_ms=pms,
        **bound(8 * rows_x * N_x + 8 * rows_x * N_x + 4 * rows_x * N_x * 2,
                rows_x * (fft_flops(N_x) + N_x * tail_flops(Modulation.QPSK))))
    print(f"phase 3x C llr plane on the tracked comb estimate ({NP}x{S_x}x{N_x * 2} f32, h per "
          f"symbol): max abs diff {c_err:.3g} (peak {c_peak:.3g}, allowed 1e-4 of it); kernel "
          f"{ms:.4f} ms, plain {pms:.3f} ms; {of_bound(report['demod_llr@packet'])} on {card}")
    del planes_x, h_x, hr_x, hi_x, stream_x, burst_x
    pc_l = pk.PacketConfig(fec="ldpc")
    code_l = pc_l._block_code()
    stream_l, nv_l = pk.transmit_over_channel(
        pc_l, mp16, seed, pk.encode_packet(pc_l, pk.draw_payload(pc_l, seed, ids_x)), ids_x)
    llr_l = pk.sent_llrs(pc_l, pk._acquire(pc_l, stream_l)[1], nv_l).reshape(-1, code_l.n)
    del stream_l
    want = kh.ldpc_decode_plain(code_l, llr_l, 25, 0.5, "flooding")
    n_diff = int((kh.ldpc_decode(code_l, llr_l, 25, 0.5, "flooding") != want).sum())
    _check(n_diff == 0, f"3x H on the LDPC packets' LLRs: {n_diff} hard bits differ from plain")
    del want
    pms = timed(lambda: kh.ldpc_decode_plain(code_l, llr_l, 25, 0.5, "flooding"), 1)
    ms = timed(lambda: kh.ldpc_decode(code_l, llr_l, 25, 0.5, "flooding"), 3)
    report["ldpc_minsum@packet"] = dict(max_abs_err=float(n_diff), ms=ms, plain_ms=pms,
                                        **h_bound(code_l, llr_l.shape[0], 25))
    print(f"phase 3x H flooding 25 on the LDPC packets' LLRs ({llr_l.shape[0]} codewords): hard "
          f"bits identical to plain; kernel {ms:.3f} ms (mean of 3 calls), plain {pms:.3f} ms; "
          f"{of_bound(report['ldpc_minsum@packet'])} on {card}")
    del llr_l
    torch.cuda.empty_cache()

    def packet_parts(pc, ch, seed_x):
        """A campaign's payloads, the decoder's input LLRs and the decoded
        info words (payload and CRC bits), through the pieces
        ``simulate_packets`` runs, on the same keys."""
        pay = pk.draw_payload(pc, seed_x, ids_x)
        stream, nv = pk.transmit_over_channel(pc, ch, seed_x, pk.encode_packet(pc, pay), ids_x)
        llr = pk.sent_llrs(pc, pk._acquire(pc, stream)[1], nv)
        return pay, llr, pk._fec_decode(pc, llr)

    x_rows = []

    def packet_run(label, pc, ch, seed_x):
        """(byte_errors, crc_ok) of a campaign's first call, inside the
        window, its no-false-accept gate; then its ms (median of 3 warm calls),
        packets/s, the decoder alone on its LLRs (median of 3) and its
        share, and the launches a call printed.

        The CRC gate is the no-false-accept gate: no packet passes the CRC
        with a byte error (crc_ok ⇒ byte_errors == 0). A CRC failure on a
        packet whose payload bytes are right (a false alarm: a CRC bit
        decoded wrong) is counted, not refused: at conv 3/4 the JAX decoder
        makes the same ones on the same LLRs
        (``tests/test_torch_packet.py::test_crc_false_alarms_are_the_jax_decoders``).
        The pieces reproduce the campaign's byte errors and crc_ok exactly."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with in_packet():
            errs, ok = pk.simulate_packets(pc, ch, seed_x, NP, device=dev)
            torch.cuda.synchronize()
            per = {k: v for k, v in _lib.LAUNCHES.items() if v}
            ms = median3(lambda: pk.simulate_packets(pc, ch, seed_x, NP, device=dev))
            pay, llr, dec = packet_parts(pc, ch, seed_x)
            dec_ms = median3(lambda: pk._fec_decode(pc, llr))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rx, ok_p = pk._check_crc(pc, dec)
        _check(torch.equal(ok_p, ok) and torch.equal((rx != pay).sum(dim=1, dtype=torch.int32),
                                                     errs), f"3x {label}: the pieces differ")
        silent = int((ok & (errs > 0)).sum())
        alarms = int((~ok & (errs == 0)).sum())
        _check(silent == 0, f"3x {label}: {silent} CRC false accepts")
        per_s = NP / (ms / 1e3)
        decoder = {"conv": "Viterbi", "ldpc": "kernel H", "polar": "CA-SCL-8 scan"}[pc.fec]
        print(f"phase 3x {label}: PER {float((errs > 0).float().mean()):.6g}, crc_ok mean "
              f"{float(ok.float().mean()):.6g}, no false accept ({alarms} false alarms: the "
              f"payload right, a CRC bit wrong); "
              f"{ms:.3f} ms a campaign of {NP} (median of 3 warm calls, CUDA events), "
              f"{per_s:.6g} packets/s; the {decoder} decoder alone {dec_ms:.3f} ms, share "
              f"{dec_ms / ms:.4f}; peak {peak:.2f} GiB allocated; launches a call {per} on {card}")
        x_rows.append(dict(label=label, ms=ms, packets_per_s=per_s, decoder_ms=dec_ms,
                           decoder_share=dec_ms / ms, false_alarms=alarms, launches=per))
        return errs, ok

    for rate in ("1/2", "2/3", "3/4"):
        errs, ok = packet_run(f"conv {rate} MULTIPATH (1, .5) 16 dB CFO 1.3 delay 37",
                              dataclasses.replace(pc_x, rate=rate), mp16, seed)
        _check(float(ok.float().mean()) >= 0.75, f"3x conv {rate}: crc_ok mean < 0.75")
        print(f"phase 3x gate met: conv {rate} crc_ok mean {float(ok.float().mean()):.6g} >= "
              f"0.75, no false accept (tests/test_packet.py:76-96)")
    errs, ok = packet_run("conv 1/2 AWGN -6 dB", pc_x,
                          ChannelConfig(model=ChannelModel.AWGN, ebno_db=-6.0), seed + 1)
    _check(int(errs.sum()) > 0, "3x low SNR: no byte errors")
    print(f"phase 3x gate met: AWGN -6 dB, {int(errs.sum())} byte errors > 0, no false "
          f"accept (tests/test_packet.py:99-104)")
    awgn10 = ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0, cfo_subcarriers=1.3,
                           timing_offset=17)
    for fec in ("ldpc", "polar"):
        pc_b = pk.PacketConfig(fec=fec)
        errs, ok = packet_run(f"{fec} 1/2 AWGN 10 dB CFO 1.3 delay 17", pc_b, awgn10, seed + 2)
        per = float((errs > 0).float().mean())
        _check(per <= 0.01, f"3x {fec}: PER {per:g} > 0.01")
        rng_b = np.random.default_rng(3)
        n_ok = 0
        with in_packet():
            for t in range(5):
                pay = torch.as_tensor(rng_b.integers(0, 256, (1, 64)).astype(np.uint8), device=dev)
                ch_t = dataclasses.replace(awgn10, timing_offset=17 + t)
                e_t, ok_t = pk.simulate_packets(pc_b, ch_t, 50 + t, 1, device=dev, payload=pay)
                n_ok += int(bool(ok_t[0]) and int(e_t[0]) == 0)
        _check(n_ok == 5, f"3x {fec}: {n_ok} of the JAX test's 5 packets decode")
        print(f"phase 3x gate met: {fec} PER {per:.6g} <= 0.01 with no false accept, and the "
              f"JAX test's 5 packets all decode (tests/test_packet.py:174-206)")

    # receive_stream: 1024 captures of 4096 samples, three 16-byte bursts.
    pc_s = pk.PacketConfig(payload_bytes=16)
    n_cap, T_s, max_b = 1024, 4096, 5
    positions, cfos = (180, 1500, 2890), (0.4, -0.8, 1.2)
    cap_ids = torch.arange(3 * n_cap, dtype=torch.int32, device=dev)
    sent_s = pk.draw_payload(pc_s, seed + 3, cap_ids).reshape(n_cap, 3, -1)
    bursts_s = pk.encode_packet(pc_s, sent_s.reshape(3 * n_cap, -1)).reshape(n_cap, 3, -1)
    clean_s = torch.zeros((n_cap, T_s), dtype=torch.complex64, device=dev)
    for j, (pos, cfo) in enumerate(zip(positions, cfos)):
        clean_s[:, pos:pos + bursts_s.shape[-1]] = sync.apply_cfo(bursts_s[:, j], cfo, 64)
    nv_s = pk.noise_var(pc_s, ChannelConfig(ebno_db=20.0))
    with in_packet():
        re_s, im_s = ke.fade_awgn(*fast._planar(clean_s[:, None, :]), noise_var=nv_s / 64,
                                  seed=seed, ch_ids=cap_ids[:n_cap])
        stream_s = torch.complex(re_s[:, 0], im_s[:, 0])
        del re_s, im_s
        rx_s, oks_s, starts_s = pk.receive_stream(pc_s, stream_s, nv_s, max_b)
        ms_s = median3(lambda: pk.receive_stream(pc_s, stream_s, nv_s, max_b))
    found = []
    for j, pos in enumerate(positions):
        hit = oks_s & ((starts_s - pos).abs() <= pc_s.ofdm.cp_len) & (
            rx_s == sent_s[:, j:j + 1]).all(dim=-1)
        found.append(hit.any(dim=1))
    all_found = torch.stack(found, 1).all(dim=1)
    n_ok_s = oks_s.sum(dim=1)
    _check(bool(all_found.all()) and bool((n_ok_s == 3).all()),
           f"3x receive_stream: {int(all_found.sum())} of {n_cap} captures found all three "
           f"bursts; captures with a count of CRC-passing rounds other than 3: "
           f"{int((n_ok_s != 3).sum())}")
    print(f"phase 3x receive_stream ({n_cap} captures of {T_s} samples, 3 bursts of 16 bytes at "
          f"{positions} with CFOs {cfos}, 20 dB, max_bursts {max_b}): every capture found all "
          f"three within cp_len with their payloads, its 2 extra rounds CRC-rejected; "
          f"{ms_s:.3f} ms a call (median of 3 warm calls), "
          f"{3 * n_cap / (ms_s / 1e3):.6g} bursts/s on {card}")
    del stream_s, clean_s, bursts_s

    # The card's decisions against the CPU's on 64 packets of each family.
    n_c = 64
    ids_c = torch.arange(n_c, dtype=torch.int32)
    for label, pc_c, ch_c in (("conv 1/2", pc_x, mp16), ("ldpc", pk.PacketConfig(fec="ldpc"),
                                                          awgn10),
                              ("polar", pk.PacketConfig(fec="polar"), awgn10)):
        with in_packet():
            e_d, ok_d = pk.simulate_packets(pc_c, ch_c, seed, n_c, device=dev)
        t_c = time.perf_counter()
        e_c, ok_c = pk.simulate_packets(pc_c, ch_c, seed, n_c, device="cpu")
        t_c = time.perf_counter() - t_c
        burst_c = pk.encode_packet(pc_c, pk.draw_payload(pc_c, seed, ids_c))
        s_c, nv_c = pk.transmit_over_channel(pc_c, ch_c, seed, burst_c, ids_c)
        llr_c = pk.sent_llrs(pc_c, pk._acquire(pc_c, s_c)[1], nv_c)
        weak = (llr_c.abs() < 1e-3).any(dim=1)
        same = (e_d.cpu() == e_c) & (ok_d.cpu() == ok_c)
        _check(bool((same | weak).all()), f"3x {label}: the card's decisions differ from the "
                                          f"CPU's beyond the packets with a |LLR| < 1e-3 bit")
        print(f"phase 3x {label}: decisions on the card equal the CPU's on {int(same.sum())} of "
              f"{n_c} packets ({int(weak.sum())} hold a coded bit with CPU |LLR| < 1e-3, where "
              f"they may differ); the CPU run {t_c:.1f} s")
    for name in packet_path:
        _check(launches_packet[name] > 0, f"phase 3x: kernel {name} was not launched")
    print(f"phase 3x: {len(x_rows)} campaigns of {NP} packets, the captures and the CPU checks in "
          f"{time.perf_counter() - t3x:.1f} s; window "
          f"{ {k: v for k, v in launches_packet.items() if v} }")

    # ---- phase 3y: link adaptation (item 11g), counters zeroed ------------------
    # ``adapt.calibrate`` at config 2's width (N 256, CP 64, AWGN, MMSE) over
    # ``DEFAULT_LADDER`` and the default grid (-2 to 36 dB, step 2), target
    # 1e-3 (the JAX tests'), 8 symbols (a depth cut: the torch Viterbi's
    # time grows with the frame, not with the channels) and 1024 channels,
    # one call a family's rungs (rungs calibrate independently), each timed
    # on the wall clock (it ends in a host copy) and counted by B's launches
    # (one a coded link: 1024 channels are one pass); the JAX tests' gates;
    # then ``simulate_adaptive`` over a seeded shadowed profile (1024
    # channels, mean 14 dB, std 6 dB).
    from sdr_tpu_torch.core.config import Equalizer
    from sdr_tpu_torch.link import adapt as adapt_k

    t3y = time.perf_counter()
    launches_adapt = dict.fromkeys(_lib.LAUNCHES, 0)
    base_y = LinkConfig(modulation=Modulation.QAM16, ofdm=OFDMConfig(n_fft=256, cp_len=64),
                        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0),
                        equalizer=Equalizer.MMSE, n_symbols=8, n_channels=1024)
    _check(base_y.n_channels <= pipeline.CHUNK, "3y: a coded link runs more than one pass")
    assert all(len(r) == 3 for r in adapt_k.DEFAULT_LADDER)  # (mod, family, rate) rungs
    cal_s, cal_n, table_y = {}, {}, []
    for fam in coded_k.CODE_FAMILIES:
        _lib.reset_launches()
        t = time.perf_counter()
        table_y += adapt_k.calibrate(base_y, seed, 1e-3, None,
                                     [r for r in adapt_k.DEFAULT_LADDER if r[1] == fam],
                                     device=dev)
        cal_s[fam] = time.perf_counter() - t
        cal_n[fam] = _lib.LAUNCHES["tx_off"]
        for k, v in _lib.LAUNCHES.items():
            launches_adapt[k] += v
    order = [(m, f, r) for m, f, r in adapt_k.DEFAULT_LADDER]
    table_y.sort(key=lambda t: order.index((t.modulation, t.family, t.rate)))
    t_cal = sum(cal_s.values())
    profile = np.random.default_rng(seed).normal(14.0, 6.0, 1024)
    _lib.reset_launches()
    t_ad = time.perf_counter()
    res_y = adapt_k.simulate_adaptive(base_y, seed + 1, profile, table_y, device=dev)
    t_ad = time.perf_counter() - t_ad
    n_ad = _lib.LAUNCHES["tx_off"]
    for k, v in _lib.LAUNCHES.items():
        launches_adapt[k] += v
    for t in table_y:
        print(f"phase 3y rung {t.modulation.value} {t.family} {t.rate}: threshold {t.esno_db:g} dB "
              f"Es/N0, efficiency {t.efficiency:.6g}, BER there {t.measured_ber:.6g}")
    _check(all(t.measured_ber <= 1e-3 for t in table_y), "3y: a rung's BER exceeds the target")
    for fam in coded_k.CODE_FAMILIES:
        rungs = sorted((t for t in table_y if t.family == fam), key=lambda t: t.efficiency)
        for a, b in zip(rungs, rungs[1:]):
            _check(b.efficiency == a.efficiency or b.esno_db >= a.esno_db,
                   f"3y: {fam} thresholds not monotone in efficiency: {a} then {b}")
    key = {(t.modulation, t.family, t.rate): t for t in table_y}
    dense = [key.get(k) for k in ((Modulation.QAM64, "conv", "3/4"),
                                  (Modulation.QAM256, "ldpc", "3/4"),
                                  (Modulation.QAM1024, "ldpc", "3/4"))]
    _check(None not in dense, "3y: a dense 3/4 rung did not calibrate")
    _check(dense[0].esno_db < dense[1].esno_db < dense[2].esno_db and
           dense[0].efficiency < dense[1].efficiency < dense[2].efficiency,
           "3y: QAM64 < QAM256 < QAM1024 fails")
    q = {f: key.get((Modulation.QPSK, f, "1/2")) for f in coded_k.CODE_FAMILIES}
    _check(None not in q.values(), "3y: a QPSK 1/2 rung did not calibrate")
    _check(q["ldpc"].esno_db <= q["conv"].esno_db and q["polar"].esno_db <= q["conv"].esno_db + 1,
           f"3y: QPSK 1/2 LDPC {q['ldpc'].esno_db} / polar {q['polar'].esno_db} vs conv "
           f"{q['conv'].esno_db}")
    ber_y = float(res_y["bit_errors"].sum()) / max(float(res_y["info_bits"].sum()), 1.0)
    _check(ber_y < 5e-3, f"3y: the adaptive link's info BER {ber_y:g} >= 5e-3")
    for name in ("tx_off", "fade_awgn", "demod_llr", "ldpc_minsum"):
        _check(launches_adapt[name] > 0, f"phase 3y: kernel {name} was not launched")
    print(f"phase 3y gates met: every rung at or below 1e-3, thresholds monotone in efficiency "
          f"per family, QAM64 < QAM256 < QAM1024 ({[t.esno_db for t in dense]} dB, efficiencies "
          f"{[round(t.efficiency, 4) for t in dense]}), QPSK 1/2 LDPC {q['ldpc'].esno_db:g} <= conv "
          f"{q['conv'].esno_db:g}, polar {q['polar'].esno_db:g} <= conv + 1 "
          f"(tests/test_adapt.py:68-77, 149-156, 188-220)")
    print(f"phase 3y calibrate ({base_y.n_channels} channels x {base_y.n_symbols} symbols, N 256, "
          f"{len(adapt_k.DEFAULT_LADDER)} rungs, {len(table_y)} calibrated): {t_cal:.1f} s wall, "
          f"{sum(cal_n.values())} coded links ({cal_n}); seconds by family "
          f"{ {k: round(v, 2) for k, v in cal_s.items()} } on {card}")
    print(f"phase 3y simulate_adaptive (1024 channels, shadowed N(14, 6) dB Es/N0): info BER "
          f"{ber_y:.6g} < 5e-3, achieved efficiency {res_y['achieved_efficiency']:.6g}, silent "
          f"{res_y['silent_channels']}, {n_ad} coded links in "
          f"{t_ad:.1f} s; phase 3y {time.perf_counter() - t3y:.1f} s; window "
          f"{ {k: v for k, v in launches_adapt.items() if v} }")

    # ---- phase 5: the parallel layer, 4 gloo ranks sharing the one card -----
    # ``dryrun_multichip`` spawns the ranks (the kernel library was built in
    # phase 1; the ranks only load it), runs every row at full width, holds
    # each against the unsharded port and prints one line per row. Each
    # rank counts the launches of its sharded calls only (zeroed around
    # them); their sum over rows and ranks is this phase's window.
    from sdr_tpu_torch.parallel import dryrun

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t5 = time.perf_counter()
    rows = dryrun.dryrun_multichip(4, str(dev), timeout=480)
    t5 = time.perf_counter() - t5
    for row in rows:
        _check(row["ok"], f"phase 5: {row['line']}")

    def window(rows_):
        out = dict.fromkeys(_lib.LAUNCHES, 0)
        for row in rows_:
            for k, v in row["launches"].items():
                out[k] += v
        return out

    launches_parallel = window(rows)
    print(f"phase 5 dryrun_multichip: {len(rows)} rows OK in {t5:.1f} s with the spawn "
          f"(4 {dryrun.SHARED_CARD}); kernel C's tp_stage2_llr launched "
          f"{launches_parallel['tp_stage2_llr']} times on the ranks")

    # ---- phase 5n: one NCCL rank, device tensors to the collectives ----------
    full = {c["name"]: c for c in dryrun.dryrun_cases(4)}
    cases_n = [dict(full["TP config 5"], name="TP config 5 on one rank (n2 4096)", mesh=(1, 1)),
               dict(full["DP fast rows config 2 AWGN"], name="DP fast rows config 2 AWGN on one "
                    "rank", mesh=(1, 1))]
    t5n = time.perf_counter()
    rows_n = dryrun.check_rows(cases_n, dryrun.spawn(1, dryrun.run_cases, (str(dev), cases_n),
                                                     backend="nccl", timeout=300))
    t5n = time.perf_counter() - t5n
    for row in rows_n:
        print(f"phase 5n {row['line']} (one NCCL rank)")
        _check(row["ok"], f"phase 5n: {row['line']}")
    launches_nccl = window(rows_n)
    _check(launches_nccl["tp_stage2_llr"] > 0, "phase 5n: kernel #20 was not launched")
    print(f"phase 5n: {len(rows_n)} rows OK in {t5n:.1f} s with the spawn")
    mc_path = ("mc_count", "demod_count_despread", "fade_awgn")
    coded_path = ("demod_llr", "demod_llr_cl", "ldpc_minsum", "ldpc_minsum_layered",
                  "ldpc_minsum_t", "ldpc_minsum_t_layered")
    terminal_path = ("demod_sum", "demod_llr_despread", "demod_sum_despread",
                     "demod_llr_cl_bf16")
    wide_path = ("llr_chain", "llr_chain_sum")
    bf16_path = ("demod_count_cl_in_bf16", "demod_llr_cl_in_bf16", "demod_llr_cl_bf16_in_bf16")
    parallel_path = ("tp_stage2_llr",)
    windows = ((coded_path, launches_coded), (terminal_path, launches_terminals),
               (mc_path, launches_mc), (wide_path, launches_wide), (bf16_path, launches_bf16),
               (parallel_path, launches_parallel), (pilot_path, launches_pilots))
    own = {name: next((w[name] for path, w in windows if name in path), launches[name])
           for name in launches}
    for name, n in own.items():
        _check(n > 0, f"kernel {name} was not launched on the main path")
    # Each kernel and mode held in phase 2w at an N must have launched in
    # phase 3i's window of that N (the wideband mode of D and F included).
    for name, n_w in wide_report:
        _check(launches_at[n_w][name] > 0, f"kernel {name} was not launched at N {n_w} in 3i")
    c_rows = "sdr_tpu/kernels/demod_pallas.py:398"
    sources = {
        "payload": ("sdr_tpu_torch/csrc/payload.cu", "sdr_tpu/kernels/channel_pallas.py:233"),
        "tx": ("sdr_tpu_torch/csrc/tx.cu", "sdr_tpu/kernels/tx_pallas.py:329"),
        "tx_taps": ("sdr_tpu_torch/csrc/tx_fir.cu", "sdr_tpu/kernels/tx_pallas.py:329"),
        "tx_off": ("sdr_tpu_torch/csrc/tx.cu", "sdr_tpu/kernels/tx_pallas.py:265"),
        "demod_count": ("sdr_tpu_torch/csrc/demod_count.cu",
                        "sdr_tpu/kernels/demod_pallas.py:500"),
        "demod_count_taps": ("sdr_tpu_torch/csrc/demod_count.cu",
                             "sdr_tpu/kernels/demod_pallas.py:500"),
        "demod_count_despread": ("sdr_tpu_torch/csrc/demod_despread_count.cu",
                                 "sdr_tpu/kernels/demod_pallas.py:500"),
        "demod_sum_cl": ("sdr_tpu_torch/csrc/demod_cl.cu",
                         "sdr_tpu/kernels/demod_cl_pallas.py:727"),
        "fade_awgn": ("sdr_tpu_torch/csrc/channel.cu", "sdr_tpu/kernels/channel_pallas.py:80"),
        "fade_awgn_fir": ("sdr_tpu_torch/csrc/channel.cu",
                          "sdr_tpu/kernels/channel_pallas.py:80"),
        "demod_count_cl": ("sdr_tpu_torch/csrc/demod_cl_count.cu",
                           "sdr_tpu/kernels/demod_cl_pallas.py:741"),
        "mc_count": ("sdr_tpu_torch/csrc/mc.cuh", "sdr_tpu/kernels/mc_pallas.py:229"),
        "demod_llr": ("sdr_tpu_torch/csrc/demod_llr.cu", c_rows),
        "demod_sum": ("sdr_tpu_torch/csrc/demod_llr.cu", c_rows),
        "demod_llr_despread": ("sdr_tpu_torch/csrc/demod_despread_llr.cu", c_rows),
        "demod_sum_despread": ("sdr_tpu_torch/csrc/demod_despread_sum.cu", c_rows),
        "demod_llr_cl": ("sdr_tpu_torch/csrc/demod_cl_llr.cu",
                         "sdr_tpu/kernels/demod_cl_pallas.py:753"),
        "demod_llr_cl_bf16": ("sdr_tpu_torch/csrc/demod_cl_llr.cu",
                              "sdr_tpu/kernels/demod_cl_pallas.py:753"),
        "ldpc_minsum": ("sdr_tpu_torch/csrc/ldpc.cu", "sdr_tpu/kernels/ldpc_pallas.py:49"),
        "ldpc_minsum_layered": ("sdr_tpu_torch/csrc/ldpc.cu",
                                "sdr_tpu/kernels/ldpc_pallas.py:197"),
        "ldpc_minsum_t": ("sdr_tpu_torch/csrc/ldpc.cu", "sdr_tpu/kernels/ldpc_pallas.py:370"),
        "ldpc_minsum_t_layered": ("sdr_tpu_torch/csrc/ldpc.cu",
                                  "sdr_tpu/kernels/ldpc_pallas.py:370"),
        "demod_sum_cl_in_bf16": ("sdr_tpu_torch/csrc/demod_cl.cu",
                                 "sdr_tpu/kernels/demod_cl_pallas.py:727"),
        "demod_count_cl_in_bf16": ("sdr_tpu_torch/csrc/demod_cl_count.cu",
                                   "sdr_tpu/kernels/demod_cl_pallas.py:741"),
        "demod_llr_cl_in_bf16": ("sdr_tpu_torch/csrc/demod_cl_llr.cu",
                                 "sdr_tpu/kernels/demod_cl_pallas.py:753"),
        "demod_llr_cl_bf16_in_bf16": ("sdr_tpu_torch/csrc/demod_cl_llr.cu",
                                      "sdr_tpu/kernels/demod_cl_pallas.py:753"),
        "tp_stage2_llr": ("sdr_tpu_torch/csrc/demod_tp.cu", "sdr_tpu/parallel/tp.py:69"),
        "tx_comb": ("sdr_tpu_torch/csrc/tx.cu", "sdr_tpu/kernels/tx_pallas.py:265"),
        "demod_count_comb": ("sdr_tpu_torch/csrc/demod_count.cu",
                             "sdr_tpu/kernels/demod_pallas.py:500"),
    }
    # The wideband entries: each counter at N 1024, 2048 and 4096, with its
    # launches in that N's window of phase 3i, against the TPU kernel it
    # replaces there (the split four-step form; the single-kernel form it
    # also replaces in "also_replaces").
    tx4 = ("sdr_tpu/kernels/fourstep_tx_split_pallas.py:86",
           "sdr_tpu/kernels/fourstep_tx_pallas.py:149")
    demod4 = ("sdr_tpu/kernels/fourstep_split_pallas.py:175",
              "sdr_tpu/kernels/fourstep_pallas.py:277")
    cl_rows = {"demod_sum_cl": "sdr_tpu/kernels/demod_cl_pallas.py:727",
               "demod_count_cl": "sdr_tpu/kernels/demod_cl_pallas.py:741",
               "demod_llr_cl": "sdr_tpu/kernels/demod_cl_pallas.py:753",
               "demod_llr_cl_bf16": "sdr_tpu/kernels/demod_cl_pallas.py:753"}
    wide_sources = {
        "tx": tx4, "tx_taps": tx4, "demod_llr": demod4, "demod_sum": demod4,
        "demod_count": (demod4[0],),
        "demod_sum_despread": ("sdr_tpu/kernels/fourstep_split_pallas.py:376",),
        "demod_count_despread": ("sdr_tpu/kernels/fourstep_split_pallas.py:376",),
        "demod_llr_despread": (c_rows,),
        "llr_chain": ("sdr_tpu/kernels/llr_pallas.py:54",),
        "llr_chain_sum": ("sdr_tpu/kernels/llr_pallas.py:54",),
        **{k: (v,) for k, v in cl_rows.items()},
    }
    def windows_of(name):
        return dict(launches_fast=launches[name], launches_mc=launches_mc[name],
                    launches_coded=launches_coded[name],
                    launches_terminals=launches_terminals[name],
                    launches_wide=launches_wide[name], launches_bf16=launches_bf16[name],
                    launches_parallel=launches_parallel[name], launches_nccl=launches_nccl[name],
                    launches_pipeline=launches_pipeline[name],
                    launches_pilots=launches_pilots[name],
                    launches_impairments=launches_impairments[name],
                    launches_mimo=launches_mimo[name],
                    launches_mimo_time=launches_mimo_time[name],
                    launches_coded_link=launches_coded_link[name],
                    launches_packet=launches_packet[name], launches_adapt=launches_adapt[name])

    # The form of C, D and F each entry ran (csrc/demod_rows.cuh's plans,
    # demod.cu's tile, csrc/demod_cl.cuh's plans).
    def cl_form(name, n_fft):
        if name in ("tx", "tx_taps", "tx_off", "tx_comb"):
            return {"form": b_form(n_fft)}
        if name in ("fade_awgn", "fade_awgn_fir"):
            return {"form": e_form(name)}
        if name in C_ROWS_MODES or name in C_STREAM_MODES:
            return c_form(name, n_fft)
        if not sources.get(name, ("",))[0].startswith("sdr_tpu_torch/csrc/demod_cl"):
            return {}
        if n_fft <= 512:
            return {"form": "narrow plan: 16 points a thread in registers (32 at N 512), "
                            "N = R * N/R, one exchange a symbol, h staged once per 32 symbols"}
        return {"form": "wideband plan: 32 points a thread in registers, N = 32 * 32 * N/1024, "
                        "h staged once per 16 symbols"}

    kernels = [
        dict(name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
             **cl_form(name, 1024 if name == "tp_stage2_llr" else N), launches=own[name],
             **windows_of(name), **{"library_ms": None, **report[name]})
        for name in sources
    ] + [
        dict(name=f"{name}@N{n_w}", route="cuda",
             source=sources[name][0] if name in sources else "sdr_tpu_torch/csrc/llr_chain.cu",
             replaces=wide_sources[name][0], also_replaces=list(wide_sources[name][1:]),
             **cl_form(name, n_w), launches=launches_at[n_w][name], **windows_of(name),
             **{"library_ms": None, **rep})
        for (name, n_w), rep in wide_report.items()
    ] + [
        # Kernel E's noise-only mode at the acquired link's stream shape
        # (phase 3r, (B, 1, 21477)): its counter's launches in the acquired
        # links' own window, where they are the noise row's alone (no 3r
        # acquired link runs a gains model).
        dict(name="fade_awgn@acquired_stream", route="cuda", source=sources["fade_awgn"][0],
             replaces=sources["fade_awgn"][1], form=e_form("fade_awgn"),
             launches=launches_acquired["fade_awgn"], **windows_of("fade_awgn"),
             **{"library_ms": None, **report["fade_awgn@acquired_stream"]})
    ] + [
        # Kernel #20 at phase 2t's other shapes: at one rank's n2 = 4096
        # with h per link the launches of phase 5n's window, where the TP
        # path runs that shape; no path runs n2 = 512 or h per symbol, so 0.
        dict(name=f"tp_stage2_llr@{label.replace(' ', '_')}", route="cuda",
             source=sources["tp_stage2_llr"][0], replaces=sources["tp_stage2_llr"][1],
             **c_form("tp_stage2_llr", n2),
             launches=launches_nccl["tp_stage2_llr"] if label == "n2=4096" else 0,
             **windows_of("tp_stage2_llr"), **{"library_ms": None, **tp_report[label]})
        for label, n2 in (("n2=4096", 4096), ("n2=4096 h per symbol", 4096), ("n2=512", 512))
    ]
    # The MIMO link's shapes (phase 3m, one pass of CHUNK channels): E over
    # the pair plane (gains, static taps) and the RX planes' noise, C's
    # post-FFT mode on whitened tones; each with its counter's launches in
    # 3m's window (E's gains and noise launches share ``fade_awgn``).
    mimo_sources = {**sources, "llr_chain": ("sdr_tpu_torch/csrc/llr_chain.cu",
                                             "sdr_tpu/kernels/llr_pallas.py:54")}
    kernels += [
        dict(name=key, route="cuda", source=mimo_sources[key.split("@")[0]][0],
             replaces=mimo_sources[key.split("@")[0]][1], **cl_form(key.split("@")[0], N),
             launches=launches_mimo[key.split("@")[0]], **windows_of(key.split("@")[0]),
             **{"library_ms": None, **report[key]})
        for key in ("fade_awgn@mimo_pair_plane", "fade_awgn_fir@mimo_pair_plane",
                    "fade_awgn@mimo_rx_noise", "llr_chain@mimo_whitened_h_per_link",
                    "llr_chain@mimo_whitened_h_per_symbol")
    ]
    # The time-varying and impaired MIMO link's shapes (phase 3v, one pass of
    # CHUNK channels): E's per-symbol gains and taps on the pair plane, the
    # acquired pair plane and the streams' noise, C's post-FFT mode with h per
    # symbol; each with its counter's launches in 3v's window.
    kernels += [
        dict(name=key, route="cuda", source=mimo_sources[key.split("@")[0]][0],
             replaces=mimo_sources[key.split("@")[0]][1], **cl_form(key.split("@")[0], N),
             launches=launches_mimo_time[key.split("@")[0]], **windows_of(key.split("@")[0]),
             **{"library_ms": None, **report[key]})
        for key in ("fade_awgn@mimo_time_pair_gains", "fade_awgn_fir@mimo_time_pair_taps",
                    "fade_awgn@mimo_time_acquired_plane", "fade_awgn@mimo_time_stream_noise",
                    "llr_chain@mimo_time_h_per_symbol")
    ]
    # The coded links' shapes (phase 3k, config 2 at B × 64): B off, E's
    # noise and C's plane on the conv link's frame, H on the LDPC link's
    # LLRs; each with its counter's launches in 3k's window.
    kernels += [
        dict(name=key, route="cuda", source=sources[key.split("@")[0]][0],
             replaces=sources[key.split("@")[0]][1], **cl_form(key.split("@")[0], N),
             launches=launches_coded_link[key.split("@")[0]], **windows_of(key.split("@")[0]),
             **{"library_ms": None, **report[key]})
        for key in ("tx_off@coded_link", "fade_awgn@coded_link", "demod_llr@coded_link",
                    "ldpc_minsum@coded_link")
    ]
    # The packet modem's shapes (phase 3x, 8192 packets of N 64 + CP 16):
    # B's comb on the bodies, E's channel alone over the burst plane and its
    # noise over the stream row, C's plane on the tracked comb estimate, H on
    # the LDPC packets' LLRs; each with its counter's launches in 3x's window.
    kernels += [
        dict(name=key, route="cuda", source=sources[key.split("@")[0]][0],
             replaces=sources[key.split("@")[0]][1], **cl_form(key.split("@")[0], 64),
             launches=launches_packet[key.split("@")[0]], **windows_of(key.split("@")[0]),
             **{"library_ms": None, **report[key]})
        for key in ("tx_comb@packet", "fade_awgn@packet", "fade_awgn_fir@packet",
                    "demod_llr@packet", "ldpc_minsum@packet")
    ]
    # Kernel C's modes: form, time, share of the bound, launches in the
    # path's window and launches × (ms − bound ms).
    for k in kernels:
        if k["name"].split("@")[0] in C_ROWS_MODES + C_STREAM_MODES:
            print(f"phase 6 C {k['name']} ({k['form']}): {k['ms']:.4f} ms, bound "
                  f"{k['bound_ms']:.4f} ms ({k['bound_by']}), share "
                  f"{k['bound_ms'] / k['ms']:.4f}, launches {k['launches']}, launches x gap "
                  f"{k['launches'] * (k['ms'] - k['bound_ms']):.2f}")
    # Kernel B's timed modes: form, time, share of the bound and the
    # launches of its counter in the window of its N (phases 3-4 at N 256,
    # 3i's window at N 1024-4096) or of its path (3x's comb at N 64).
    for r in b_rows:
        n = r["n_fft"]
        n_launch = r["window"][r["counter"]] if "window" in r else (
            launches[r["counter"]] if n == N else launches_at[n][r["counter"]])
        print(f"phase 6 B {r['mode']} N {n} ({r['shape']}; {b_form(n)}): {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"share {r['bound_ms'] / r['ms']:.4f}, launches of {r['counter']} {n_launch}, "
              f"launches x gap {n_launch * (r['ms'] - r['bound_ms']):.2f}")
    # Kernel E's timed modes (phase 2): form, time, share of the bound and
    # the launches of its counter in its path's window (the FIR in phases
    # 3-4: the 24-tap link; the gains and noise in 3d-3f: SC-FDMA).
    for r in e_rows:
        n_launch = r.get("window", own)[r["counter"]]
        print(f"phase 6 E {r['mode']} N {r.get('n_fft', N)} ({r.get('shape', f'{B}x{S}x{N + CP}')}; "
              f"{e_form(r['counter'])}): "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), share {r['bound_ms'] / r['ms']:.4f}, launches of "
              f"{r['counter']} {n_launch}, launches x gap {n_launch * (r['ms'] - r['bound_ms']):.2f}")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_script:.1f} s of wall "
          f"time, the build included")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
