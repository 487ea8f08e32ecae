#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's paths on ``cuda``: the AAC-LC flagship (v4
wire, 1024 distinct stereo 48 kHz streams from the committed fixtures
in ``tests/data/torch_port``) through
``soundkit_tpu_torch.models.aac_lc_batch.BatchedAacLcDecoder``, the
batched telephony codecs (G.711 mu/A-law, G.722, G.726 at 16/24/32/40
kbit/s; 1024 distinct lanes per codec from the committed fixtures in
``tests/data/torch_port/telephony``, chunk 2048) through
``soundkit_tpu_torch.models.telephony_batch``, the batched FLAC decoder
(1024 ragged lanes of the fixtures in ``tests/data/torch_port/flac``,
16- and 24-bit, mono and stereo, stride 4608) through
``soundkit_tpu_torch.models.flac_batch.BatchedFlacDecoder``, the batched
MP3 decoder (1024 ragged stereo lanes of the fixtures in
``tests/data/torch_port/mp3``: MPEG-1, -2 and -2.5, mono and stereo)
through ``soundkit_tpu_torch.models.mp3_batch_model.BatchedMp3Decoder``,
the batched Opus CELT decoder (1024 ragged stereo lanes of the fixtures
in ``tests/data/torch_port/opus``: libopus clips with the comb postfilter
and transient frames, a mono clip, an owned-encoder clip, an OpusHead
gain) through ``soundkit_tpu_torch.models.opus_batch.BatchedCeltDecoder``,
the batched Opus SILK and hybrid decoders (1024 ragged voice lanes of the
libopus voice fixtures in the same directory: SILK NB / MB / WB, a
quarter stereo; hybrid SWB mono and FB stereo) through
``BatchedSilkDeviceDecoder`` and ``BatchedHybridDecoder``, the batched
Ogg Vorbis decoder (1024 ragged stereo 44.1 kHz lanes of the libvorbis
fixtures in ``tests/data/torch_port/vorbis``, blocksizes 256 and 2048)
through ``soundkit_tpu_torch.models.vorbis_batch.BatchedVorbisDecoder``,
the batched FLAC encoder (1024 lanes of 16-bit stereo 44.1 kHz PCM
from the FLAC fixtures) through
``soundkit_tpu_torch.models.flac_encode_batch.BatchedFlacEncoder``, the
MP3 -> 8 kHz µ-law transcode chain (1024 lanes of the 44.1 kHz stereo
MP3 fixture through ``BatchedMp3Decoder`` and the carried-state resampler)
through ``soundkit_tpu_torch.tools.transcode``, the device pitch shift
(1024 mono lanes of 2 s) through
``soundkit_tpu_torch.ops.stretch.pitch_shift_batch_device``, and
the serving runtime ``soundkit_tpu_torch.models.fleet.StreamFleet``
over the six decoders (1024 lanes a group), and the streaming decode
pipeline ``soundkit_tpu_torch.pipeline.decode_pipeline.DecodePipeline``
(one stream at a time, K3, K6, K7 and K10 on one lane), and the encode
direction: the owned Opus and FLAC encoders on the host, their streams
decoded by a ``StreamFleet`` on the card, and soundkit's v2 frame stream
(``simple.SoundKitFrameDecoder``). Phases:

a. build the CUDA kernels (one ``nvcc`` a source, all started together),
   the host parser, the FLAC walk, the MP3 parser, the Opus parse (CELT,
   SILK, hybrid glue), the Vorbis packet parse, the FLAC frame packer
   and the GSM, ALAC, G.729 and AMR-NB decoders from the checkout;
b. print the card (``nvidia-smi`` name and power limit), the kernels'
   launch shapes (K4's lanes a block and a warp, K6's threads a lane,
   K7's threads a band and steps a tile, K3's codes a thread and threads
   a block, K8's warps a block and values a chunk, K9's lanes a block,
   samples a tile and mover threads, K10's threads a channel and rounds a
   matrixing thread sums, K14's threads a row and samples a thread, from
   their sources), the versions and the host (name, CPU model, cores);
c. hold each kernel against its plain PyTorch version on the card at
   the main path's shapes (B = 1024), with the inputs and bounds of
   ``soundkit_tpu_torch.tools.kernel_check`` (K4 also on seeded random
   inputs at B = 1001; K5 on every TNS layout there; the ~900-line
   region is the timed one); time the kernel by replaying a CUDA graph
   of 20 launches (device time, no host issue gaps), the plain version
   with CUDA events around its calls, and, for
   K1, ``torch.matmul`` on the same inputs as the library yardstick;
   compute each kernel's bound (the larger of its bytes at 3.35 TB/s and
   its operations at 495 TFLOP/s TF32 or 67 TFLOP/s float32) from the
   case's shapes;
d. decode 46 lockstep batches through the decoder, with every launch
   counter reset just before, and check that all batches took the v4
   wire and every kernel of the path launched; hold two batches'
   PCM and carried state against the port's plain path on the CPU
   (same wire buffers); report aggregate x realtime at 48 kHz (host
   parse + h2d + device step per batch, synchronized per batch) and
   the per-layer split the decoder times (parse, h2d, device step);
e. telephony kernels: K3 (G.711 decode, mixed laws, ragged counts), K6
   (G.726 decode and encode at each rate) and K7 (G.722 decode and
   encode) against their plain versions on the card at the path's
   shapes (B = 1024, 2048 codes), bit-exact, timed by graph replay;
   each scan also from a carried state (512 codes: the plain scans are
   Python loops, most of this phase's time); beside K3,
   an empty kernel on K3's grid (``launch_floor_ms``: what the launch
   alone costs) and, as its ``library_ms``, one PyTorch call computing
   its function, the [2, 256] code table indexed by (law, code), held to
   K3 on the same codes without counts (one call cannot also zero a
   ragged lane past its count);
f. telephony compare: per codec, two full-width decoder steps and one
   encoder step on the card against the port's plain path on the CPU,
   from the same pushes: PCM, lengths, bytes and carried state equal;
g. telephony: per codec, every lane's stream through
   ``BatchedTelephonyDecoder(timed=True)`` until all lanes drain, then
   every lane's PCM through ``BatchedTelephonyEncoder``, launch counters
   reset just before; checks that the codec's kernel launched on every
   step, that the output is not silent and that every pushed code came
   out; one ``[telephony]`` line per codec (x realtime at the codec's
   rate, step times, the decoder's pack / h2d / step split);
h. FLAC kernels: K8 (Rice plane) and K9 (LPC, wasted bits,
   decorrelation) against their plain versions on the card, bit-exact,
   on the wire of the FLAC phase's first decode (its first push to 1024
   fixture lanes, every ready round folded into the lane axis: the
   shape the path launches them at; phase j checks that its first
   decode had that many rounds), timed by graph replay; also on the wire
   of one round and on seeded random inputs, with and without the
   parameters no walk emits; the bound is the bytes moved (the frame
   bytes, segment table, warm-up and plane for K8; each valid lane's
   block of residuals in and the samples out for K9), and beside it, on
   the log line only, each kernel's chain floor, estimated from the code (the longest serial
   chain of the case: a segment's codes, a row's samples, at an
   estimated count of dependent cycles a step and 1.98 GHz); K8's fill
   alone (``fill_ms``: the same wire with an empty segment table);
i. FLAC compare: two ``decode_batches`` calls of a 1024-lane decoder on
   the card against the port's plain path on the CPU, samples and
   ``metas`` identical;
j. FLAC: 1024 ragged lanes pushed in three rounds with a decode after
   each until every lane drains, launch counters reset just before; one
   ``[flac]`` line (x realtime at each lane's own rate, the decoder's
   walk / export / h2d / step medians);
k. MP3 kernel: K10 (one granule of every stream from its packed wire
   row: requantize, M/S, alias butterflies, IMDCT, overlap-add and
   polyphase synthesis) against its plain version on the card on the
   path's next wire row (1024 ragged fixture streams, C = 2, after three
   decoded granules, with the decoder's carried state; the timed case),
   and on seeded random wires of 1024 streams chained over four granules
   at C = 2 and C = 1 (block types -7..8, mixed and invalid lanes, M/S
   with an invalid partner, alias boundaries outside 0..31, a non-zero
   starting state); bound 1e-5 of the largest plain value on the PCM and
   both states; the bound time from the wire's bytes and the operations
   of the prologue and of the path each subband takes;
l. MP3 compare: two ``decode_batches`` calls of a 1024-lane decoder on
   the card against the port's plain path on the CPU: PCM >= 100 dB per
   lane, the carried overlap and FIFO within K10's bound;
m. MP3: 1024 ragged lanes pushed in three rounds with a decode of every
   ready granule after each until every lane drains, launch counters
   reset just before; K10 must launch once a granule step, every
   granule of the streams must come out, and a granule step must run at
   most two device kernels (``torch.profiler``); one ``[mp3]`` line (x
   realtime at each lane's own rate, the decoder's parse / pop / h2d /
   step medians, and the device kernels and device time of a granule
   step);
n. CELT kernel: K11 (``celt_postfilter``: overlap-add, comb postfilter
   and de-emphasis of a 20 ms frame, one launch a round) against its
   plain version and its first design (``tools/first_designs``) on the
   card on the CELT path's next round (1024 ragged fixture lanes, C = 2,
   after three decoded rounds, with the decoder's carried state; timed
   by graph replay in turns with the first design), on seeded random
   frames of 1024 streams at C = 2 and C = 1 (periods 15..1022 and the
   edge periods, all three tapsets, zero and non-zero gains, invalid
   streams; timed the same way) and on the frames its step widths turn
   on (zero sets at period 15 beside long active ones, the postfilter
   turning on and off); bound 1e-5 of the largest plain value on the PCM
   and each state, and of the first design's, invalid streams
   bit-equal; beside the bound, on the log line only, the chain floor
   estimated from the code and both builds' registers and spills;
o. CELT compare: two decodes of a 1024-lane ``BatchedCeltDecoder`` on
   the card against the port's plain path on the CPU, on the f32 and on
   the i16 wire: PCM >= 100 dB per lane, lengths identical, the carried
   state within K11's bound;
p. CELT: 1024 ragged stereo lanes (lane i: clip i mod 4 from packet
   7·(i // 4), every fourth lane of a clip shorter) pushed in three
   rounds with a decode of every ready round after each, launch counters
   reset just before; K11 must launch once a round and every sample of
   the streams come out; one ``[celt]`` line (x realtime at 48 kHz, the
   decoder's parse / h2d / step medians, the device operations and their
   device time a round by ``torch.profiler``);
q. SILK kernel: K12 (``silk_synth``: the LTP/LPC synthesis of a 20 ms
   frame of every (lane, channel) row, one launch a bandwidth group a
   round) against its plain version and its first design on the card,
   bit-exact: on the [silk] path's WB round after three decoded rounds
   (1024 lanes of the [silk] mix x 2 rows, with the decoder's carried
   state; timed by graph replay in turns with the first design), on
   seeded random rounds of 1024 streams at NB, MB and WB, C = 2 and 1
   (lags at both ends of the range, voiced and unvoiced rows, lead-in,
   invalid and all-zero lanes; C = 2 timed the same way), and on the
   rounds its schedule turns on (rows with and without lead-in side by
   side, lags 3, 16 and 288, gains apart in every subframe); beside the
   bound, the chain floor and the issue floor of the LPC recursion,
   estimated, and both builds' registers and spills;
r. SILK and hybrid compare: two decodes of a 1024-lane
   ``BatchedSilkDeviceDecoder`` (the [silk] mix) and of a
   ``BatchedHybridDecoder`` (the [hybrid] mix) on the card against the
   port's plain path on the CPU: PCM >= 100 dB per lane, lengths
   identical, the carried state within 1e-5 of its largest value;
s. SILK: 1024 ragged voice lanes (lane i: clip i mod 8 of four WB mono,
   an NB, an MB and two WB stereo, each from its OpusHead's pre-skip and
   gain), three pushes of their packets and a decode of every ready
   round after each, launch counters reset just before; K12 once a
   bandwidth group a round (at most 3), every valid sample out; one
   ``[silk]`` line (x realtime at 48 kHz, the walk a round, the h2d and
   the step, the device operations and their device time a round by
   ``torch.profiler``);
t. hybrid: 1024 ragged lanes of the SWB and FB clips the same way, K12
   and K11 once a round of every chunk of 8; one ``[hybrid]`` line with
   the same figures a chunk;
u. Vorbis kernel: K13 (``vorbis_overlap``: the window, the block-size
   shift, the overlap-add, the new lap and the masks of one packet, after
   the two IMDCT products; one launch a round) against its plain version
   on the card, bit-exact: on the [vorbis] path's round after three
   decoded rounds (1024 lanes, C = 2, with the decoder's lap; the timed
   case), and on seeded random rounds of 1024 streams (every (previous,
   current) block-size case, invalid lanes) at C = 2 and 1, with n0 ==
   n1 and with (512, 4096) among them; beside the graph-replay time
   (whose launches find their 38 MB warm in the 50 MB L2), the same
   launches with the inputs rotated over four copies (``cold_ms``);
v. Vorbis compare: two decodes of a 1024-lane ``BatchedVorbisDecoder`` on
   the card against the port's plain path on the CPU: lengths identical,
   PCM >= 120 dB per lane, the lap within 1e-6 of its largest value;
w. Vorbis: 1024 ragged stereo lanes (lane i: clip i mod 2 from page
   3·(i // 2), wrapping, every fourth lane of a clip shorter) pushed in
   three rounds with a decode of every ready round after each, launch
   counters reset just before; K13 once a round, every sample of the
   streams out; one ``[vorbis]`` line (x realtime at 44.1 kHz, the parse
   a push, the decoder's pack a collect, h2d and the step a round by CUDA
   events, the device operations and their device time a round by
   ``torch.profiler``);
x. FLAC encode kernel: K14 (``flac_analyze``: the plan of a FLAC block a
   row: stereo candidates, fixed order, windowed autocorrelation,
   Levinson, quantized LPC and its exact residual, Rice estimates, kind
   and assignment; one launch a device call) against its plain version
   on the card, plan rows identical: on the wire of [flac-enc]'s first
   encode_pending (10,240 rows of 4096 samples; timed by graph replay),
   on seeded random rows at 16 and 24 bits, stereo and mono, and on edge
   rows (silence, constant blocks, full-scale noise, +-max alternating
   with a side channel of bits + 1, 16-sample blocks, n_valid < N, a
   block longer than a tile); its bound the larger of its bytes, its
   float64 operations at 34 TFLOP/s and its integer operations at the
   SMs' issue rate (``kernel_check.flac_analyze_work``);
y. FLAC encode compare: for each of the four FLAC fixtures, 64 lanes of
   its PCM (decoded by the port's FLAC decoder), each rotated by its own
   offset, through an encoder on the card and one on the CPU with the
   same pushes: byte-identical streams; every stream decodes on the card
   to its input bit for bit, with the input's MD5 in its STREAMINFO;
z. FLAC encode: 1024 lanes of 4 s (alternating the stereo16 and
   const_wasted PCM, each from its own offset) in four pushes with an
   encode_pending after each, then finish_all, launch counters reset
   just before; K14 once a device call (each encode_pending and each
   distinct tail length), 64 lanes decoded back bit-exactly with their
   MD5; one ``[flac-enc]`` line (x realtime at 44.1 kHz, the MD5 at push
   time, the wire, h2d, K14 by CUDA events, the plans' copy back, the
   native pack);
aa. resampler kernel: K15 (``polyphase_fir``: the polyphase FIR of
   ``ops.resample.resample`` and ``resample_stateful``) against its plain
   version on the card (cuDNN's ``conv1d`` under the repaired
   ``ieee_fp32``) at every pair of ``COMMON_SAMPLE_RATES`` and 3000 ->
   2000, one-shot and from a carried history (1e-5 of the largest plain
   value), chunked equal to one-shot bit for bit; timed by graph replay on
   the [transcode] chunk (1024 x 28,224 samples and a history, 44.1 -> 8
   kHz) and on the [stretch] resample (1024 x 165,375, 3000 -> 2000), each
   beside its bound, ``F.conv1d`` and its first design
   (``tools/first_designs``, equal to it bit for bit, timed in turns), with
   its launch plan, registers and resident warps;
bb. transcode: 1024 lanes of the stereo44 MP3 fixture, each the whole
   clip from its own frame, decoded in chunks of 49 granules (K10 a
   granule) and through the tail (downmix, K15's carried-state resample
   44.1 -> 8 kHz, µ-law), codes left on the card; the counted run (launch
   counters reset just before: K10 once a granule, K15 once a chunk) held
   to a continuous one-shot ``resample_np`` of each lane's whole decoded
   mono signal (>= 99.99 % of codes identical, the rest within one µ-law
   step); then three timed passes as the reference's bench runs them; one
   ``[transcode]`` line (x realtime of the decode and tail, best of three,
   and with the parse; parse / pop / h2d / K10 step medians, the tail);
cc. vocoder kernels: on the [stretch] path's own tensors (the vocoder's
   analysis at 1.875 over the dd. lanes), K17 (``phase_lock``) with its
   ``nearest`` identical to the plain version's, its spectrum within 3
   ulps of the rotation's argument and within 2^-21 of the magnitude of
   float64 cos / sin of the argument, and K16 (``overlap_add``) bit-exact
   on the irfft of K17's spectrum, against its plain version and its
   first design; both timed by graph replay in turns with their first
   designs (``tools/first_designs``; K17's nearest identical), with their
   byte bounds and builds, K16 beside ``F.fold``;
dd. stretch: ``pitch_shift_batch_device`` over 1024 mono lanes of 2 s at
   44.1 kHz (the stereo44 fixture decoded on the card and downmixed, lane
   i from its own offset), time ratio 1.25, pitch 1.5, with
   ``formant_scale`` None and 1.0: K15, K16 and K17 once a call, four
   lanes held to the float64 host ``stretch_pitch`` (40 dB; 25 dB with
   the formant warp), x realtime, peak device memory and the device time
   by operation (``torch.profiler``: FFTs, cumsum, K15-K17, glue; from a
   session whose operation count, the largest seen, another repeats) and
   the call's span by CUDA events; one ``[stretch]`` line each;
ee. fleet: one ``StreamFleet(capacity_per_group=1024)`` serving 1024 AAC
   lanes (detected from ADTS), 1024 MP3 lanes (detected from their frame
   headers), 1024 FLAC lanes (detected from ``fLaC``), 1024 Ogg Opus
   lanes (detected from ``OggS`` and ``OpusHead``: CELT, SILK and hybrid
   streams, clip i mod 10 of the four CELT and six voice clips), 1024 Ogg
   Vorbis lanes (detected from ``OggS`` and the identification header:
   44.1 kHz stereo, four pages, <= ~1 s) and 1024
   G.722 lanes (explicit kind), pushed raggedly in four rounds with a
   ``collect(device_out=True)`` after each, a quarter of the streams
   ended after the second round and their lanes taken by new streams;
   every stream's fetched PCM is held against the bare model's output
   for the same bytes (MP3, FLAC and G.722 bit-exact, AAC and Opus >=
   100 dB and Vorbis >= 120 dB under the same rounds), and every kernel
   of the six groups must have launched; beside the lanes the same run
   serves streams on the host fallback (``fleet_host_streams``: four
   beyond capacity for each group, 1024 G.711 and G.726-32 fillers and
   four beyond them, four WAV and four raw-Opus streams, the single-
   stream Ogg Opus reroutes, a 5.1 and a family-255 multistream Ogg
   Opus stream rerouted at their heads to the owned multistream decoder,
   a 22.05 kHz mono Ogg Vorbis stream of
   another topology), each equal to its lone decode on the card, the
   fallback's K3 / K6 / K7 / K10 launches counted inside its pushes;
   one stream of each owned host codec (GSM, G.729 and AMR-NB by their
   kinds, AIFF-C µ-law, ALAC in MP4, AC-3 and Ogg Speex WB detected) and
   one detected stream of
   each container (``FLEET_CONTAINER_STREAMS``: M4A AAC, WebM Opus, WebM
   Vorbis), each equal to its lone decode too, their push seconds by kind
   of stream; a detected 5.1 ADTS stream and a 5.1 M4A stream of ~2 s
   (``FLEET_AAC_MC_STREAMS``) on the host fallback, each equal to its
   lone decode on the card and on the CPU, six channels; the two Opus
   heads neither package opens must raise ``FleetUnsupported``; the
   waves run again without the host streams for the x realtime beside;
   then an ``out_bits=16`` collect against the quantized
   bare output (Opus CELT on the i16 spectral wire), and per group a
   fleet serving that group alone, its x realtime beside the bare model's
   on the same bytes; one ``[fleet]`` line;
ff. pipeline: K3, K6 and K7 at B = 1 on 1, 127 and 313 codes and on one
   4096-byte send (K6 at 16384 / 10922 / 8192 / 6553 codes decoding and
   4096 encoding, K7 at 4096 codes both ways, K3 at 4096), from a
   carried state, unmasked, and K10 on one granule of a stereo and a
   mono stream at B = 1, each against its plain version (the scans at a
   send against the plain scan run in 128-code segments, a lane each,
   from the kernel's states at the segments' starts,
   ``kernel_check.segmented_scan_pair``); K7's refusal of an odd sample
   count and K10's of a FIFO off a 16-byte boundary; a stream of at
   least 60 s of every pipeline format (MP3 and AAC-ADTS fixture frames
   concatenated; 16-bit stereo and 24-bit FLAC encoded on the card by
   ``BatchedFlacEncoder``; G.711 mu / A, G.722 and G.726 at 16 / 24 / 32
   / 40 kbit/s encoded on the card by the streaming encoders from the
   telephony fixtures' PCM in 4096-sample chunks, their K6 / K7 launches
   counted alone as ``stream_encoder_launches``; WAV and raw PCM); the
   first send of each telephony stream, its encoded codes against a
   plain encode of the same PCM and its decoded PCM against a plain
   decode; then, the launch counters reset, each stream through
   ``DecodePipeline`` on the card (``spawn()`` where the format is
   detected, else its ``spawn_*``) in 4096-byte sends, no
   ``DecodeError`` allowed, with x realtime; the counters read (the four
   decode wrappers above 0, the encode wrappers at 0); each stream's
   first 15 s again under the timing hook: the median host time of a
   chunk's ``process``, its span between CUDA events, and the timed x
   realtime (the hook's cost beside the untimed one);
   each stream's first 5 s (G.722 and G.726: 1000 codes, their plain
   scans step a code at a time on the CPU) through the same pipeline on
   the CPU, bit-exact but MP3, which is held within 1 LSB, and at >= 100
   dB in float32 through ``Mp3Decoder``; eight host-decoded streams of ~10 s
   (``pipeline_host_streams``: Ogg Opus CELT stereo and mono, SILK WB,
   hybrid FB, raw Opus, Ogg Vorbis, 5.1 multistream Ogg Opus, 5.1 ADTS
   AAC-LC ``adts_51``) the same way, hooked on their first 2.5 s and held
   on their first 2.5 s against the CPU bit for bit (the host code is the
   same on both), the whole stream also against the JAX package's
   references: the 5.1 Opus stream against
   the JAX package's decode of its clip (``multistream_reference_check``:
   1 LSB, and >= 104 dB a channel in float32) and the 5.1 AAC streams
   (``adts_51`` and the M4A ``m4a_51``) against the JAX package's own
   decoder and libavcodec (``aac_mc_reference_check``: 1 LSB, and the
   PNS-free SNR); sixteen streams of the
   owned host codecs (``pipeline_codec_streams``: GSM standard and WAV49,
   AIFF 16-bit, AIFF-C µ-law and A-law, 60 s each; ALAC in CAF and in
   MP4, 20 s; AC-3 stereo 5 s; Ogg Speex NB / WB / UWB 5 / 3 / 2 s;
   MPEG audio Layer II stereo 48 kHz and LSF mono 22.05 kHz, 60 s each,
   and Layer I stereo 48 kHz, 20 s, by ``spawn_mp3``, each an
   ``mpa_fixtures`` clip's frames repeated; G.729 and AMR-NB, 60 s each,
   by ``spawn_g729`` / ``spawn_amr_nb``, ``celp_fixtures`` clips' frames
   repeated)
   the same way, hooked on their first 2 s (AIFF and ALAC, decoded at
   EOF, whole), held against the CPU bit for bit, whole (GSM, MPEG
   audio, G.729, AMR-NB, AIFF and ALAC) or on their first 2.5 s (AC-3
   and Speex), and against the JAX package's decode of their
   clip (``codec_reference_check``: exact, AC-3 and Speex within 1 LSB;
   the MPEG audio streams within 1 LSB of the committed float32 PCM of
   the clip, and the clip alone through ``Mp3Decoder`` at >= 100 dB in
   float32, ``mpa_reference_check``; G.729 exact and AMR-NB at >= 90 dB
   against the clip's committed int16 PCM, ``celp_reference_check``),
   AIFF-C's K3 once at each file's end;
   six container streams (``pipeline_container_streams``: M4A AAC and
   LOAS/LATM AAC 30 s, by detection and ``spawn_aac_latm``; WebM Vorbis
   and Opus CELT 10 s, Opus SILK 20 s, detected; each a container case's
   units repeated, ``container_fixtures.long_stream``; the 5.1 M4A
   ``m4a_51``, ``adts_51``'s units, 10 s) the same way, hooked on their
   first 2.5 s (the M4A streams, decoded at EOF, whole), held on their
   first 2.5 s (the M4A streams whole) against the CPU bit for bit
   (``m4a_51`` against ``adts_51``'s CPU decode: the same units) and
   against the JAX package's owned decode of the case
   (``container_reference_check``: exact, the SILK stream within 1 LSB
   of the committed PCM of its first second); eight mixed pipelines
   at once, each equal to its lone run; one ``[pipeline]`` line a format
   and a summary line;
gg. containers: ``simple.AudioTrackDemuxer`` over the MP4, WebM and
   three-track MPEG-TS cases of ``container_fixtures`` (their bytes first
   held to the index's hash), fed in 188-byte pushes and whole: its
   events equal the JAX package's as the index records them; one
   ``[containers]`` line a case and a summary line;
hh. encode: 8 seeded 4 s stereo 48 kHz clips (``encode_clip``) through
   the port's encoders on the host (``simple.OpusEncoder``, CELT 64
   kbit/s stereo, native; ``encoders.OpusEncoder(mode="voice")``, SILK WB
   mono, native; ``simple.FlacEncoder``, 16-bit stereo, level 5; one 1 s
   hybrid FB clip, Python SILK), each encoder's x realtime on the host
   clock; the native and Python CELT and SILK encoders equal on 10
   frames; the packets muxed by ``OggOpusWriter``, the FLAC frames behind
   ``fLaC`` + STREAMINFO; 1024 FLAC and 1024 Ogg Opus streams (512 CELT,
   384 SILK, 128 hybrid; each clip repeated across its lanes) through one
   ``StreamFleet(capacity_per_group=1024)`` on the card in four ragged
   pushes: every FLAC lane equal to its source samples, every Opus lane
   bit-identical to the other lanes of its clip and, over its clip's first
   25 packets, within 100 dB (CELT) / 90 dB (SILK, hybrid) of a fleet on
   the CPU; each Opus clip's SNR against its source; K8 / K9 / K11 / K12
   launched; one ``[encode]`` line a clip and a summary line;
ii. frames: one clip's Opus packets as v2 frames (``encode_frame``, CRC
   on) through ``simple.SoundKitFrameDecoder`` in 313-byte pushes, the
   payloads equal to the packets; where the ``cryptography`` package is
   installed, encrypted frames (fixed nonces, a decimal key) and each
   packet through an ACE1 seal / open too, else a line that says so;
jj. print the kernels' JSON line (all seventeen kernels, K2 with no
   launch: it is not on a path; K3, K6, K7 and K10 with their
   ``pipeline_launches`` and ``fleet_fallback_launches``, K3 also with
   ``pipeline_aifc_launches``, K6 and K7 with ``stream_encoder_launches``,
   K8, K9, K11 and K12 with ``encode_launches``), then the result line.

Any failed phase exits non-zero before the result line. Without a
CUDA device, or outside a checkout of the repository, it exits 1
without a result.
"""
from __future__ import annotations

import json
import struct
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s, dense TF32 and float32 FLOP/s
HBM_RATE = 3.35e12
TF32_RATE = 495e12
FP32_RATE = 67e12
B = 1024
C = 2
RATE = 48000.0
N_BATCHES = 46
N_COMPARE = 2
TEL_CHUNK = 2048
TEL_COMPARE_STEPS = 2
FLAC_STRIDE = 4608
SM_CLOCK = 1.98e9     # H100 SXM boost clock, Hz: chain floors are estimated at it
K8_CHAIN_CYCLES = 30  # dependent cycles a Rice code (clz, window shift and refill, remainder)
K9_CHAIN_CYCLES = 14  # dependent cycles a sample (IMAD.WIDE, 64-bit >> and +)
FLAC_ROUNDS = 3       # pushes of the [flac] phase, a decode after each
FLEET_ROUNDS = 4
FLEET_AAC_FRAMES = 64  # AAC frames a fleet stream carries: its first push passes MIN_DETECT
FLEET_FLAC_FRAMES = 6
FLEET_TEL_BYTES = 6000
FLEET_TEL_KIND = "g722"
FLEET_MP3_FRAMES = 24  # MP3 frames a fleet stream carries (48 granules of MPEG-1, 24 of LSF)
MP3_ROUNDS = 3         # pushes of the [mp3] phase, a decode after each
MP3_WARM = 3           # granules the [mp3-kernels] path case decodes before its round
CELT_ROUNDS = 3        # pushes of the [celt] phase, a decode after each
CELT_WARM = 3          # rounds the [celt-kernels] path case decodes before its round
CELT_COMPARE_PACKETS = 8
K11_STEP_CYCLES = 60   # dependent cycles a comb step (five shared loads, the tap sums, a store)
K11_SCAN_CYCLES = 33   # dependent cycles a level of the de-emphasis scan (a shuffle, a multiply, an add)
FLEET_OPUS_PACKETS = 60  # packets an Ogg Opus fleet stream carries (1.2 s)
SILK_ROUNDS = 3        # pushes of the [silk] phase, a decode after each
SILK_WARM = 3          # rounds the [silk-kernels] path case decodes before its round
SILK_COMPARE_PACKETS = 8
HYBRID_ROUNDS = 3      # pushes of the [hybrid] phase, a decode after each
HYBRID_COMPARE_PACKETS = 16
K12_SAMPLE_CYCLES = 8  # dependent cycles an LPC sample (the coeff[0] product and the add)
# the [silk] lanes: lane i plays clip SILK_MIX[i mod 8] (mostly WB, a quarter stereo)
SILK_MIX = ("silk_wb",) * 4 + ("silk_nb", "silk_mb") + ("silk_wb_stereo",) * 2
HYBRID_MIX = ("hybrid_swb", "hybrid_fb")
VORBIS_ROUNDS = 3        # pushes of the [vorbis] phase, a decode after each
VORBIS_WARM = 3          # rounds the [vorbis-kernels] path case decodes before its round
VORBIS_COMPARE_PAGES = 1  # audio pages a [vorbis-compare] lane carries (~20 packets)
VORBIS_RATE = 44100.0
FLEET_VORBIS_PAGES = 4   # audio pages an Ogg Vorbis fleet stream carries (<= ~1 s)
FLEET_OVERFLOW = 4       # streams beyond a full group's lanes, decoded on the host
# telephony groups filled to capacity in [fleet]'s last round, so that their overflow
# streams run K3 and K6 on the host fallback
FLEET_FILLERS = ("g711_mulaw", "g726_32")
FLEET_FILLER_BYTES = 400
FLEET_HOST_WAV_SECONDS = 1.0
# one host stream of each owned host codec in [fleet], {sid: (host_codec_fixtures clip, explicit
# kind or None for detection, seconds at least)}, made by host_codec_fixtures.long_stream; pushed
# whole after round 0's pushes
FLEET_CODEC_STREAMS = {"gsm-host-0": ("gsm_standard", "gsm", 10.0),
                       "aifc_ulaw-host-0": ("aifc_ulaw", None, 10.0),
                       "alac_mp4-host-0": ("alac_mp4", None, 5.0),
                       "ac3-host-0": ("ac3_stereo", None, 2.0),
                       "speex_wb-host-0": ("speex_wb", None, 2.0),
                       "g729-host-0": ("g729_speech", "g729", 10.0),
                       "amr_nb-host-0": ("amrnb_switch", "amr_nb", 10.0)}
# one detected host stream of each container in [fleet], {sid: (container_fixtures case, seconds
# at least)}; pushed whole after round 0's pushes (the M4A decodes at its end)
FLEET_CONTAINER_STREAMS = {"m4a_aac-host-0": ("m4a_aac", 5.0),
                           "webm_opus-host-0": ("webm_opus_celt", 5.0),
                           "webm_vorbis-host-0": ("webm_vorbis", 5.0)}
# the 5.1 AAC-LC streams of [fleet] (aac_mc_fixtures clip or case, seconds at least), each detected
# and pushed whole after round 0's pushes: the ADTS one leaves its AAC lane at the push (channel
# configuration 6), the M4A one decodes at its end; both on the host fallback
FLEET_AAC_MC_STREAMS = {"adts_51-host-0": ("cfg6", 2.0), "m4a_51-host-0": ("m4a_51", 2.0)}
# the multistream Ogg Opus streams of [fleet] (opus_ms_fixtures clips), each pushed whole with
# kind "opus" after round 0's pushes and rerouted at its head to the host fallback
FLEET_MULTISTREAM = ("surround51", "voip255")
FLAC_ENC_RATE = 44100.0
FLAC_ENC_SECONDS = 4.0    # PCM a [flac-enc] lane carries
FLAC_ENC_PUSHES = 4       # pushes of the [flac-enc] phase, an encode_pending after each
FLAC_ENC_COMPARE_LANES = 64
FLAC_ENC_ROUNDTRIP = 64   # [flac-enc] lanes decoded back on the card
RESAMPLE_SWEEP_LANES = 64  # rows of each rate pair's K15 check
TRANSCODE_CHUNK_SAMPLES = 49 * 576  # a [transcode] chunk: 64 x 441 samples at 44.1 kHz
TRANSCODE_PASSES = 3       # timed passes of the [transcode] phase, the parsers re-fed each
STRETCH_RATE = 44100.0
STRETCH_SECONDS = 2.0      # a [stretch] lane
STRETCH_RATIO = 1.25       # time ratio of the [stretch] pitch shift
STRETCH_PITCH = 1.5        # its pitch scale: the vocoder at 1.875, then 3000 -> 2000


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn`` over ``reps`` calls, by CUDA events on the
    stream (host issue gaps count)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn`` call: a CUDA graph of ``reps`` calls,
    replayed ``replays`` times between CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


#: profiler sessions a pitch shift's split takes, at least and at most: on
#: the card's machine a session can lose any share of its device operations,
#: from none to all (about half of the sessions of a 37-operation pitch shift
#: lost some), so the split is read from a session whose operation count,
#: the largest seen, another session repeats
PROFILE_SESSIONS = (3, 12)


def device_events(run) -> tuple:
    """(the device operations of ``run()`` by ``torch.profiler``, their
    span in ms by CUDA events), synchronized."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return ops, start.elapsed_time(stop)


def bound(nbytes: float, flops: float = 0.0, rate: float = FP32_RATE) -> dict:
    """The least time the card could take: bytes at HBM_RATE against
    operations at ``rate``, whichever is larger."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_RATE, 1e3 * flops / rate
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def measure(tag: str, name: str, kernel, plain, nbytes: float, flops: float = 0.0,
            rate: float = FP32_RATE, plain_reps: int = 20, library=None) -> dict:
    """Hold ``kernel`` to ``plain`` and time both (and ``library``)."""
    from soundkit_tpu_torch.tools import kernel_check as kc

    r = kc.compare(name, kernel, plain)
    r["ms"] = graph_ms(kernel)
    r["plain_ms"] = cuda_ms(plain, plain_reps)
    r.update(bound(nbytes, flops, rate))
    r["library_ms"] = None if library is None else graph_ms(library)
    log(f"[kernels] {tag}: {r}")
    return r


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    import threading

    from soundkit_tpu_torch import _build
    from soundkit_tpu_torch.tools import first_designs

    first = {}

    def build_first():
        t = time.perf_counter()
        try:
            first["path"] = first_designs.library_path()
        except Exception as e:  # raised below, in this thread
            first["error"] = e
        first["s"] = time.perf_counter() - t

    first_build = threading.Thread(target=build_first)
    first_build.start()
    t0 = time.perf_counter()
    kpath = _build.kernel_library_path()
    t1 = time.perf_counter()
    ppath = _build.parser_library_path()
    t2 = time.perf_counter()
    fpath = _build.flac_library_path()
    t3 = time.perf_counter()
    mpath = _build.mp3_library_path()
    t4 = time.perf_counter()
    cpath = _build.opus_library_path()
    t5 = time.perf_counter()
    vpath = _build.vorbis_library_path()
    t6 = time.perf_counter()
    epath = _build.flac_pack_library_path()
    t7 = time.perf_counter()
    gpath = _build.gsm_library_path()
    t8 = time.perf_counter()
    apath = _build.alac_library_path()
    t9 = time.perf_counter()
    g729path = _build.g729_library_path()
    t10 = time.perf_counter()
    amrpath = _build.amrnb_library_path()
    t11 = time.perf_counter()
    _build.kernels()
    first_build.join()
    if "error" in first:
        raise first["error"]
    first_designs.library()
    log(f"[build] first designs of K11, K12, K15, K16 and K17 {first['path'].relative_to(ROOT)} in "
        f"{first['s']:.3f} s, beside the kernels")
    log(f"[build] kernels {kpath.relative_to(ROOT)} in {t1 - t0:.3f} s; "
        f"parser {ppath.relative_to(ROOT)} in {t2 - t1:.3f} s; "
        f"FLAC walk {fpath.relative_to(ROOT)} in {t3 - t2:.3f} s; "
        f"MP3 parser {mpath.relative_to(ROOT)} in {t4 - t3:.3f} s; "
        f"Opus parse {cpath.relative_to(ROOT)} in {t5 - t4:.3f} s; "
        f"Vorbis parse {vpath.relative_to(ROOT)} in {t6 - t5:.3f} s; "
        f"FLAC packer {epath.relative_to(ROOT)} in {t7 - t6:.3f} s; "
        f"GSM decoder {gpath.relative_to(ROOT)} in {t8 - t7:.3f} s; "
        f"ALAC decoder {apath.relative_to(ROOT)} in {t9 - t8:.3f} s; "
        f"G.729 decoder {g729path.relative_to(ROOT)} in {t10 - t9:.3f} s; "
        f"AMR-NB decoder {amrpath.relative_to(ROOT)} in {t11 - t10:.3f} s")
    blog = kpath.with_suffix(".log")
    if blog.exists():
        for line in blog.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("[build] " + line.strip())


def host_cpu() -> str:
    """The host's CPU as the first entry of ``/proc/cpuinfo`` names it
    (vendor, family, model, model name and clock; a sandboxed kernel
    may report the model name as unknown)."""
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            first = f.read().split("\n\n")[0]
    except OSError as e:
        return f"{platform.processor() or 'unknown'} (/proc/cpuinfo: {e.strerror})"
    info = dict(line.split(":", 1) for line in first.splitlines() if ":" in line)
    info = {k.strip(): v.strip() for k, v in info.items()}
    keys = ("vendor_id", "cpu family", "model", "model name", "cpu MHz")
    return ", ".join(f"{k} {info[k]}" for k in keys if k in info) or "unknown"


def cu_constant(source: str, name: str) -> int:
    """The value of ``constexpr int <name>`` in ``csrc/<source>``."""
    import re

    m = re.search(rf"constexpr int {name} = (\d+);",
                  (ROOT / "soundkit_tpu_torch" / "csrc" / source).read_text())
    check(m is not None, f"csrc/{source} defines no {name}")
    return int(m.group(1))


def phase_card() -> str:
    import os
    import socket

    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    log(card)
    log(f"[config] K4 lanes per block {cu_constant('aac_spectral.cu', 'LANES_PER_BLOCK')}, "
        f"lanes per warp {cu_constant('aac_spectral.cu', 'LANES_PER_WARP')}; "
        f"K6 threads per lane {cu_constant('g726.cu', 'G')}; "
        f"K7 threads per band {cu_constant('g722.cu', 'G')}, steps per tile "
        f"{cu_constant('g722.cu', 'TILE')}; K3 codes per thread {cu_constant('g711.cu', 'VEC')}, "
        f"threads per block {cu_constant('g711.cu', 'THREADS')}; "
        f"K8 warps per block {cu_constant('flac_rice.cu', 'SEG_WARPS')}, values per chunk "
        f"{cu_constant('flac_rice.cu', 'CHUNK')}, fill threads "
        f"{cu_constant('flac_rice.cu', 'FILL_THREADS')}; K9 lanes per block "
        f"{cu_constant('flac_lpc.cu', 'LANES')}, samples per tile {cu_constant('flac_lpc.cu', 'TILE')}, "
        f"mover threads {cu_constant('flac_lpc.cu', 'MOVERS')}; K10 threads per channel "
        f"{cu_constant('mp3_synth.cu', 'THREADS')}, rounds a matrixing thread sums "
        f"{cu_constant('mp3_synth.cu', 'RB')}; K14 threads per row "
        f"{cu_constant('flac_analyze.cu', 'THREADS')}, samples a thread takes in a tile "
        f"{cu_constant('flac_analyze.cu', 'SPT')}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}; host {socket.gethostname()} "
        f"cpu {host_cpu()} cores {os.cpu_count()} usable {len(os.sched_getaffinity(0))}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_kernels(wire0):
    """Each kernel against its plain version on the card, B = 1024."""
    import torch

    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    rows = B * C
    wire = torch.from_numpy(wire0).to(dev)
    f = 4  # bytes of a float32 or int32
    res = {}
    res["spectral_decode"] = phase_spectral(wire)
    # K5: coef, perm, filt_id and out rows, the LPC taps; at most 40 FLOP a line
    tns_bytes = rows * 1024 * 4 * 4 + rows * 8 * 20 * f
    res["tns_filter"] = measure("tns_filter/long", "tns_filter", *kc.tns_case(B, C, dev, 5, kind="long"),
                                nbytes=tns_bytes, flops=40 * rows * 1024, plain_reps=2)
    cases = {}
    for kind in kc.TNS_KINDS[1:]:
        kernel, plain = kc.tns_case(B, C, dev, 6, kind=kind)
        r = kc.compare("tns_filter", kernel, plain)
        r["ms"] = graph_ms(kernel)
        log(f"[kernels] tns_filter/{kind}: {r}")
        cases[kind] = r
    res["tns_filter"]["cases"] = cases
    res["tns_filter"]["max_abs_err"] = max(r["max_abs_err"] for r in (res["tns_filter"], *cases.values()))
    res["tns_filter"]["rel_err"] = max(r["rel_err"] for r in (res["tns_filter"], *cases.values()))

    def synthesis(L, K, N):
        # A, the K-major basis, the window bank and indices, out; 3xTF32 products
        nbytes = L * K * f + N * K * f + (16 if N == 2048 else 32) * N * f + L * 4 + L * N * f
        return dict(nbytes=nbytes, flops=3 * 2 * L * K * N, rate=TF32_RATE)

    long = measure("imdct_window/long", "imdct_window", *kc.imdct_case(rows, False, dev, seed=1),
                   library=kc.imdct_library(rows, False, dev, seed=1), **synthesis(rows, 1024, 2048))
    short = measure("imdct_window/short", "imdct_window", *kc.imdct_case(rows * 8, True, dev, seed=2),
                    library=kc.imdct_library(rows * 8, True, dev, seed=2),
                    **synthesis(rows * 8, 128, 256))
    res["imdct_window"] = {
        "max_abs_err": max(long["max_abs_err"], short["max_abs_err"]),
        "rel_err": max(long["rel_err"], short["rel_err"]),
        **{k: long[k] + short[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": long["bound_by"], "long": long, "short": short,
        # the same products on plain FFMA, for comparison
        "bound_ms_ffma": sum(1e3 * 2 * L * K * N / FP32_RATE
                             for L, K, N in ((rows, 1024, 2048), (rows * 8, 128, 256))),
    }
    dq = synthesis(rows, 1024, 2048)
    dq["nbytes"] += rows * 1024 * 4  # quant and scale in place of coef
    res["dequant_imdct_window"] = measure(
        "dequant_imdct_window", "dequant_imdct_window", *kc.dequant_imdct_case(rows, dev, seed=3), **dq)
    return res


def phase_spectral(wire):
    """K4 on the fixture wire (the timed case) and on random inputs at
    B = 1001 (2002 lanes, no multiple of a block's lanes); both
    bit-exact."""
    import torch

    from soundkit_tpu_torch.ops import aac_batch as ab
    from soundkit_tpu_torch.ops import aac_entropy as ae
    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    # AU bytes, bit offsets, run programs and counts (int32), the two-level table; quant out
    table = ae.build_spectral_lut2().nbytes
    kernel, plain = kc.spectral_case(wire, B)
    r = measure("spectral_decode", "spectral_decode", kernel, plain,
                nbytes=B * 1024 + 2 * B * 4 + 2 * B * 128 * 4 + 2 * B * 4 + table + 2 * B * 1024 * 4,
                plain_reps=2)
    f = ab.unpack_v4_wire(wire, B)
    r["longest_lane_codewords"] = int(kc.spectral_codewords(
        f["runs"].reshape(2 * B, -1), f["n_runs"].reshape(-1)).max())
    rand_B = 1001
    rand_args = kc.spectral_random_inputs(rand_B, seed=7)
    r["random_longest_lane_codewords"] = int(kc.spectral_codewords(rand_args[2], rand_args[3]).max())
    rk, rp = kc.spectral_random_case(rand_B, dev, seed=7)
    r["max_abs_err"] = max(r["max_abs_err"], kc.compare("spectral_decode", rk, rp)["max_abs_err"])
    r["random_ms"] = graph_ms(rk)
    log(f"[kernels] spectral_decode/random: B = {rand_B} {r['random_ms']} ms, bit-exact; longest "
        f"lane {r['longest_lane_codewords']} codewords (random {r['random_longest_lane_codewords']})")
    return r


def phase_compare(wires):
    """The card's slice against the port's plain path on the CPU, on
    the same wire buffers: quant exact, PCM and state >= 100 dB."""
    import torch

    from soundkit_tpu_torch.ops import aac_batch as ab
    from soundkit_tpu_torch.ops import aac_entropy as ae

    def run(device):
        saved, prev = ab.init_state(B, C, device)
        pcms, quants = [], []
        for w in wires:
            buf = torch.from_numpy(w).to(device)
            f = ab.unpack_v4_wire(buf, B)
            quants.append(ae.spectral_decode(
                f["au"], f["spec_bit"].reshape(-1).to(torch.int32),
                f["runs"].reshape(2 * B, -1).to(torch.int32),
                f["n_runs"].reshape(-1).to(torch.int32)).cpu())
            pcm, saved, prev = ab.decode_frame_v4_packed(buf, prev, saved)
            pcms.append(pcm.cpu())
        return torch.stack(pcms), torch.stack(quants), saved.cpu(), prev.cpu()

    t0 = time.perf_counter()
    g_pcm, g_q, g_saved, g_prev = run(torch.device("cuda", 0))
    t1 = time.perf_counter()
    c_pcm, c_q, c_saved, c_prev = run(torch.device("cpu"))
    t2 = time.perf_counter()
    check(torch.equal(g_q, c_q), "card vs CPU: quantized spectra differ")
    check(torch.equal(g_prev, c_prev), "card vs CPU: carried window shapes differ")

    def lane_snr(got, ref):
        # per stream over every frame and channel: [n, B, C, N] -> [B]
        got = got.double().transpose(0, 1).reshape(B, -1)
        ref = ref.double().transpose(0, 1).reshape(B, -1)
        sig = (ref ** 2).sum(1)
        err = ((got - ref) ** 2).sum(1)
        silent = sig == 0
        check(bool((err[silent] == 0).all()), "card vs CPU: output on a silent lane")
        snr = 10 * torch.log10(sig[~silent] / err[~silent].clamp_min(1e-300))
        return snr.min().item(), int((~silent).sum())

    snr_pcm, n_pcm = lane_snr(g_pcm, c_pcm)
    snr_state, n_state = lane_snr(g_saved[None], c_saved[None])
    log(f"[compare] {len(wires)} batches x {B} lanes: quant exact; min lane PCM SNR "
        f"{snr_pcm:.2f} dB over {n_pcm} lanes; min lane state SNR {snr_state:.2f} dB "
        f"over {n_state} lanes (card {t1 - t0:.3f} s incl. warm-up, CPU plain {t2 - t1:.3f} s)")
    check(snr_pcm >= 100.0 and snr_state >= 100.0, "card vs CPU: SNR below 100 dB")
    return dict(min_pcm_snr_db=snr_pcm, min_state_snr_db=snr_state)


def phase_slice(clips):
    """46 batches through the decoder; launch counters reset just before."""
    import torch

    from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
    from soundkit_tpu_torch.ops import aac_batch as ab
    from soundkit_tpu_torch.ops import aac_entropy as ae
    from soundkit_tpu_torch.ops import imdct
    from soundkit_tpu_torch.tools.aac_fixtures import lane_streams

    model = BatchedAacLcDecoder(B, C, device="cuda", timed=True)
    for i, data in enumerate(lane_streams(clips, B, N_BATCHES)):
        model.push(i, data)
    check(model.ready_frames == N_BATCHES, f"ready_frames {model.ready_frames}")

    wrappers = {"spectral_decode": ae.spectral_decode, "tns_filter": ab.tns_filter,
                "imdct_window": imdct.imdct_window,
                "dequant_imdct_window": imdct.dequant_imdct_window}
    for w in wrappers.values():
        w.launches = 0
    times = []
    all_finite = True
    for _ in range(N_BATCHES):
        t0 = time.perf_counter()
        pcm = model.decode_batches(1, device_out=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        all_finite &= bool(torch.isfinite(pcm).all())
    launches = {name: w.launches for name, w in wrappers.items()}

    check(tuple(pcm.shape) == (1, B, C, 1024), f"pcm shape {tuple(pcm.shape)}")
    check(all_finite, "non-finite PCM on the card")
    check(model.v4_batches == N_BATCHES and model.full_wire_batches == 0,
          f"v4 batches {model.v4_batches}, full-wire batches {model.full_wire_batches}")
    for name in ("spectral_decode", "tns_filter", "imdct_window"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    rms = pcm.double().pow(2).mean().sqrt().item()
    check(rms > 1e-4, f"last batch is silent (rms {rms})")

    audio_s = N_BATCHES * B * 1024 / RATE
    total = sum(times)
    srt = sorted(times)
    stages = model.stage_ms()
    res = dict(
        batches=N_BATCHES, v4_batches=model.v4_batches,
        full_wire_batches=model.full_wire_batches,
        xrealtime=audio_s / total, total_s=total,
        batch_ms_median=1e3 * srt[len(srt) // 2], batch_ms_first=1e3 * times[0],
        batch_ms_max=1e3 * srt[-1],
        parse_ms_median=stages["parse"], h2d_ms_median=stages["h2d"],
        step_ms_median=stages["step"], last_batch_rms=rms, launches=launches,
    )
    log(f"[slice] {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# telephony phases
# ---------------------------------------------------------------------------

def _merge_cases(res: dict, decode: list, encode: list) -> dict:
    """One kernel row from its decode and encode cases: times and bounds
    summed per direction (as the imdct row sums its two shapes), errors
    maxed."""
    return dict(
        max_abs_err=max(res[t]["max_abs_err"] for t in decode + encode),
        rel_err=max(res[t]["rel_err"] for t in decode + encode),
        ms=sum(res[t]["ms"] for t in decode), plain_ms=sum(res[t]["plain_ms"] for t in decode),
        bound_ms=sum(res[t]["bound_ms"] for t in decode), bound_by="bytes", library_ms=None,
        encode_ms=sum(res[t]["ms"] for t in encode),
        encode_plain_ms=sum(res[t]["plain_ms"] for t in encode),
        encode_bound_ms=sum(res[t]["bound_ms"] for t in encode),
        cases={t.split("/")[1]: {k: res[t][k] for k in ("ms", "plain_ms", "bound_ms")}
               for t in decode + encode},
    )


def phase_tel_kernels():
    """K3, K6 and K7 against their plain versions on the card at the
    telephony path's shapes (B = 1024, 2048 codes), bit-exact."""
    import torch

    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    N = TEL_CHUNK
    cases = {"g711_decode/decode": kc.g711_case(B, N, dev, seed=11)}
    # bytes each case moves: codes (u8), PCM (int16), the per-step mask
    # (bool), the state in and out (int32 rows of 24 / 70); K3 reads its
    # law and count per lane
    nbytes = {"g711_decode/decode": B * N + 2 * B * 4 + B * N * 2}
    for enc in (False, True):
        for carried in (False, True):
            n = N // 4 if carried else N
            suffix = ("encode" if enc else "decode", "_carried" * carried)
            for bits in (2, 3, 4, 5):
                tag = f"g726_scan/{suffix[0]}_{8 * bits}{suffix[1]}"
                cases[tag] = kc.g726_case(B, n, bits, enc, dev, seed=20 + 2 * bits + enc,
                                          carried=carried)
                nbytes[tag] = B * n + B * n * 2 + B * n + 2 * B * 24 * 4
            tag = f"g722_scan/{suffix[0]}{suffix[1]}"
            cases[tag] = kc.g722_case(B, n, enc, dev, seed=30 + enc, carried=carried)
            nbytes[tag] = B * n + B * 2 * n * 2 + B * n + 2 * B * 70 * 4
    res = {}
    for tag, (kernel, plain) in cases.items():
        name = tag.split("/")[0]
        if name == "g711_decode":
            r = kc.compare(name, kernel, plain)
            r["plain_ms"] = cuda_ms(plain, 20)
        else:
            # the plain scans are Python loops of 2048 steps, host-bound:
            # time the one call that the comparison makes
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

            def timed_plain(plain=plain):
                events[0].record()
                out = plain()
                events[1].record()
                return out

            r = kc.compare(name, kernel, timed_plain)
            r["plain_ms"] = events[0].elapsed_time(events[1])
        r["ms"] = graph_ms(kernel) if name == "g711_decode" else graph_ms(kernel, reps=5, replays=2)
        r.update(bound(nbytes[tag]))
        r["library_ms"] = None
        if name == "g711_decode":
            r["launch_floor_ms"] = graph_ms(kc.g711_launch_floor(B, N, dev))
            # one PyTorch call that computes K3's function: the code table
            # indexed by (law, code), held to K3 on the same codes without counts
            library, k3 = kc.g711_library_case(B, N, dev, seed=11)
            check(torch.equal(library(), k3()), "g711: the table gather differs from K3")
            r["library_ms"] = graph_ms(library)
        log(f"[tel-kernels] {tag}: {r}")
        res[tag] = r

    def scan_row(name: str) -> dict:
        # times from the initial-state cases; the carried cases give their errors
        first = [t for t in res if t.startswith(name + "/") and not t.endswith("_carried")]
        return {
            **_merge_cases(res, [t for t in first if "decode" in t], [t for t in first if "encode" in t]),
            "carried": {t.split("/")[1]: res[t]["max_abs_err"] for t in res
                        if t.startswith(name + "/") and t.endswith("_carried")},
        }

    return {
        "g711_decode": {k: res["g711_decode/decode"][k]
                        for k in ("max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "launch_floor_ms")},
        "g726_scan": scan_row("g726_scan"),
        "g722_scan": scan_row("g722_scan"),
    }


def tel_compare_run(codec: str, device: str) -> dict:
    """The telephony path of one codec on ``device`` over the smoke
    lanes: ``TEL_COMPARE_STEPS`` decoder steps and one encoder step,
    everything returned as numpy. Runs in a worker process for the CPU."""
    import torch

    from soundkit_tpu_torch.models.telephony_batch import (
        BatchedTelephonyDecoder, BatchedTelephonyEncoder)
    from soundkit_tpu_torch.tools import telephony_fixtures as tf

    if device == "cpu":
        torch.set_num_threads(1)  # one worker per codec shares the host's cores
    t0 = time.perf_counter()
    dec = BatchedTelephonyDecoder(codec, B, TEL_CHUNK, device=device)
    for i, data in enumerate(tf.lane_streams(codec, B)):
        dec.push(i, data)
    steps = [dec.decode_step() for _ in range(TEL_COMPARE_STEPS)]
    enc = BatchedTelephonyEncoder(codec, B, TEL_CHUNK, device=device)
    for i, pcm in enumerate(tf.lane_pcm(codec, B)):
        enc.push(i, pcm)
    wire = enc.encode_step()
    return dict(steps=steps, wire=wire,
                dec_state=None if dec.state is None else dec.state.cpu().numpy(),
                enc_state=None if enc.state is None else enc.state.cpu().numpy(),
                seconds=time.perf_counter() - t0)


def phase_tel_compare():
    """Per codec: two full-width decoder steps and one encoder step on
    the card against the port's plain path on the CPU, same pushes. The
    CPU runs go to one spawned worker process per codec, all at once."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from soundkit_tpu_torch.models.telephony_batch import CODECS

    out = {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=len(CODECS), mp_context=ctx) as pool:
        cpu_runs = {codec: pool.submit(tel_compare_run, codec, "cpu") for codec in CODECS}
        for codec in CODECS:
            card = tel_compare_run(codec, "cuda")
            cpu = cpu_runs[codec].result()
            for step, ((g_pcm, g_lens), (c_pcm, c_lens)) in enumerate(zip(card["steps"], cpu["steps"])):
                check(np.array_equal(g_pcm, c_pcm), f"{codec}: card vs CPU PCM differ at step {step}")
                check(np.array_equal(g_lens, c_lens), f"{codec}: lengths differ at step {step}")
                check(np.abs(g_pcm).max() > 0, f"{codec}: silent step {step}")
            check(card["wire"] == cpu["wire"], f"{codec}: card vs CPU encoded bytes differ")
            for key in ("dec_state", "enc_state"):
                check((card[key] is None and cpu[key] is None) or np.array_equal(card[key], cpu[key]),
                      f"{codec}: card vs CPU {key} differs")
            out[codec] = dict(samples=int(sum(lens.sum() for _, lens in card["steps"])),
                              wire_bytes=sum(map(len, card["wire"])),
                              card_s=card["seconds"], cpu_s=cpu["seconds"])
            log(f"[tel-compare] {codec}: {TEL_COMPARE_STEPS} decoder steps and 1 encoder step x {B} "
                f"lanes identical (PCM, lengths, bytes, state); card {card['seconds']:.3f} s, "
                f"CPU plain {cpu['seconds']:.3f} s in its worker")
    return out


def phase_telephony():
    """Every codec's lanes through the decoder until they drain, then
    through the encoder; launch counters reset just before."""
    import torch

    from soundkit_tpu_torch.models.telephony_batch import (
        CODECS, BatchedTelephonyDecoder, BatchedTelephonyEncoder)
    from soundkit_tpu_torch.ops import adpcm, companding, g722
    from soundkit_tpu_torch.tools import telephony_fixtures as tf

    wrappers = {"g711_decode": companding.g711_decode,
                "g726_decode_scan": adpcm.g726_decode_scan,
                "g726_encode_scan": adpcm.g726_encode_scan,
                "g722_decode_scan": g722.g722_decode_scan,
                "g722_encode_scan": g722.g722_encode_scan}
    for w in wrappers.values():
        w.launches = 0
    res = {}
    for codec in CODECS:
        family = codec.split("_")[0]
        dec_w = "g711_decode" if family == "g711" else f"{family}_decode_scan"
        enc_w = None if family == "g711" else f"{family}_encode_scan"
        rate = tf.sample_rate(codec)
        spb = tf.samples_per_byte(codec)

        streams = tf.lane_streams(codec, B)
        model = BatchedTelephonyDecoder(codec, B, TEL_CHUNK, device="cuda", timed=True)
        for i, data in enumerate(streams):
            model.push(i, data)
        codes = [round(len(s) * spb) // model.samples_per_code for s in streams]
        steps = -(-max(codes) // TEL_CHUNK)
        before = wrappers[dec_w].launches
        times, produced = [], 0
        peak = torch.zeros((), dtype=torch.int32, device="cuda")
        for _ in range(steps):
            t0 = time.perf_counter()
            pcm, lens = model.decode_step(device_out=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            produced += int(lens.sum())
            peak = torch.maximum(peak, pcm.abs().max().to(torch.int32))
        launched = wrappers[dec_w].launches - before
        check(launched == steps, f"{codec}: {dec_w} launched {launched} times in {steps} steps")
        check(produced == sum(codes) * model.samples_per_code,
              f"{codec}: produced {produced} samples of {sum(codes) * model.samples_per_code}")
        check(tuple(pcm.shape) == (B, TEL_CHUNK * model.samples_per_code), f"pcm {tuple(pcm.shape)}")
        check(int(peak) > 0, f"{codec}: silent decode")
        stages = model.stage_ms()

        pcms = tf.lane_pcm(codec, B)
        enc = BatchedTelephonyEncoder(codec, B, TEL_CHUNK, device="cuda")
        for i, p in enumerate(pcms):
            enc.push(i, p)
        enc_steps = -(-max(len(p) for p in pcms) // TEL_CHUNK)
        e_before = wrappers[enc_w].launches if enc_w else 0
        t0 = time.perf_counter()
        n_bytes = sum(sum(map(len, enc.encode_step())) for _ in range(enc_steps))
        enc_wall = time.perf_counter() - t0
        want_bytes = sum(round(len(p) / spb) for p in pcms)
        check(n_bytes == want_bytes, f"{codec}: encoded {n_bytes} bytes of {want_bytes}")
        if enc_w:
            e_launched = wrappers[enc_w].launches - e_before
            check(e_launched == enc_steps,
                  f"{codec}: {enc_w} launched {e_launched} times in {enc_steps} steps")

        wall = sum(times)
        srt = sorted(times)
        r = dict(codec=codec, lanes=B, chunk=TEL_CHUNK, steps=steps, rate=rate,
                 xrealtime=produced / rate / wall, total_s=wall,
                 step_ms_median=1e3 * srt[len(srt) // 2], step_ms_max=1e3 * srt[-1],
                 pack_ms_median=stages["pack"], h2d_ms_median=stages["h2d"],
                 device_step_ms_median=stages["step"], samples=produced,
                 enc_steps=enc_steps, enc_xrealtime=sum(map(len, pcms)) / rate / enc_wall,
                 enc_total_s=enc_wall, enc_bytes=n_bytes)
        log(f"[telephony] {json.dumps(r)}")
        res[codec] = r
    launches = {n: w.launches for n, w in wrappers.items()}
    for n, c in launches.items():
        check(c > 0, f"{n} was not launched on the telephony path")
    return res, launches


# ---------------------------------------------------------------------------
# FLAC and fleet phases
# ---------------------------------------------------------------------------

def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def flac_round_pushes(streams, r: int):
    """What the FLAC phase pushes to each lane in round ``r``."""
    return [s[len(s) * r // FLAC_ROUNDS: len(s) * (r + 1) // FLAC_ROUNDS] for s in streams]


def flac_path_wire(dev):
    """The wire of the FLAC phase's first decode, as tensors on ``dev``,
    and its rounds: round 0's pushes, then every ready round exported."""
    from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder
    from soundkit_tpu_torch.tools import flac_fixtures as ff

    model = BatchedFlacDecoder(B, FLAC_STRIDE, device=dev)
    for i, data in enumerate(flac_round_pushes(ff.lane_streams(ff.load_clips(), B), 0)):
        model.push(i, data)
    n = max(model.lane_ready(i) for i in range(B))
    wire = model.export_wire(n)
    check(len(wire.parts[0]) == 0, "a fixture frame left the segment wire")
    return n, tuple(model._to_device(wire.segs))


def phase_flac_kernels():
    """K8 and K9 against their plain versions on the card, bit-exact: on
    the wire of the FLAC phase's first decode (the timed cases), on the
    wire of one round, and on seeded random inputs."""
    import torch

    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    rounds, wire = flac_path_wire(dev)
    words, block_size, valid = wire[0], wire[14], wire[15]
    rows = words.shape[0]
    check(rows == rounds * B, f"flac wire: {rows} rows for {rounds} rounds")
    plane_bytes = rows * 2 * FLAC_STRIDE * 4
    # a row's frame bytes: up to its last non-zero word (a frame ends in its CRC-16)
    cols = torch.arange(1, words.shape[1] + 1, device=dev)
    frame_bytes = 4 * int(((words != 0) * cols).amax(1).sum())
    res = {}
    # K8 reads the frame bytes, the segment table, warm-up and constants, and writes the plane
    res["flac_rice_plane"] = measure(
        "flac_rice_plane", "flac_rice_plane", *kc.flac_rice_case(wire, FLAC_STRIDE),
        nbytes=frame_bytes + nbytes_of(*wire[1:9]) + plane_bytes, plain_reps=1)
    empty = wire[1][:0]
    no_segs = (words, empty, empty, empty, empty, empty, *wire[6:9])
    fill, fill_plain = kc.flac_rice_case(no_segs, FLAC_STRIDE)
    kc.compare("flac_rice_plane", fill, fill_plain)
    res["flac_rice_plane"].update(
        rounds=rounds, rows=rows, segments=int((wire[4] > 0).sum()), codes=int(wire[4].sum()),
        words_per_row=int(words.shape[1]), frame_bytes=frame_bytes, fill_ms=graph_ms(fill))
    # K9 reads each valid lane's block of both channels and the per-row LPC
    # fields, and writes the samples
    resid_bytes = 2 * 4 * int(block_size[valid].sum())
    res["flac_frame"] = measure(
        "flac_frame", "flac_frame", *kc.flac_lpc_case(wire, FLAC_STRIDE),
        nbytes=resid_bytes + nbytes_of(*wire[9:]) + plane_bytes, plain_reps=1)
    res["flac_frame"].update(
        rounds=rounds, rows=rows, valid_rows=int(valid.sum()), residual_bytes=resid_bytes)
    # each kernel's chain floor, estimated from the code (not measured): the
    # longest segment's codes or the longest block's samples, one after another
    floors = {"flac_rice_plane": int(wire[4].max()) * K8_CHAIN_CYCLES,
              "flac_frame": int(block_size[valid].max()) * K9_CHAIN_CYCLES}
    for name in ("flac_rice_plane", "flac_frame"):
        r = res[name]
        log(f"[flac-kernels] {name}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), chain floor {1e3 * floors[name] / SM_CLOCK:.4f} ms (estimated)"
            + (f", fill alone {r['fill_ms']:.4f} ms" if "fill_ms" in r else ""))
    one = kc.flac_fixture_wire(B, 1, dev, FLAC_STRIDE)
    pairs = [(kc.flac_rice_case(one, FLAC_STRIDE), kc.flac_lpc_case(one, FLAC_STRIDE))]
    for seed in (1, 2):
        for wild in (False, True):
            pairs.append((
                kc.flac_rice_random_case(dev, seed=seed, rows=64, n_segs=2000, stride=1280,
                                         wild=wild),
                kc.flac_lpc_random_case(dev, seed=seed, lanes=1001, T=257, wild=wild)))
    for rice_pair, lpc_pair in pairs:
        for name, pair in (("flac_rice_plane", rice_pair), ("flac_frame", lpc_pair)):
            r = kc.compare(name, *pair)
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], r["max_abs_err"])
    log("[flac-kernels] one round of fixture lanes and random inputs (2 seeds, with and "
        "without the parameters no walk emits): bit-exact")
    return res


def flac_compare_run(device: str):
    """Two ``decode_batches`` calls (one round, then two) of a B-lane
    decoder on ``device`` over the smoke lanes, as numpy."""
    from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder
    from soundkit_tpu_torch.tools import flac_fixtures as ff

    model = BatchedFlacDecoder(B, FLAC_STRIDE, device=device)
    for i, data in enumerate(ff.lane_streams(ff.load_clips(), B, 3)):
        model.push(i, data)
    return [model.decode_batches(n) for n in (1, 2)]


def phase_flac_compare():
    import numpy as np

    t0 = time.perf_counter()
    card = flac_compare_run("cuda")
    t1 = time.perf_counter()
    cpu = flac_compare_run("cpu")
    t2 = time.perf_counter()
    for call, ((g_s, g_m), (c_s, c_m)) in enumerate(zip(card, cpu)):
        check(g_s.dtype == np.int32 and g_s.shape == c_s.shape, f"flac call {call}: shapes differ")
        check(np.array_equal(g_s, c_s), f"flac call {call}: card vs CPU samples differ")
        check(len(g_m) == len(c_m) and all(np.array_equal(a, b) for a, b in zip(g_m, c_m)),
              f"flac call {call}: card vs CPU metas differ")
        check(np.count_nonzero(g_s) > 0, f"flac call {call}: silent")
    log(f"[flac-compare] 2 calls (1 and 2 rounds) x {B} lanes identical (samples, metas); "
        f"card {t1 - t0:.3f} s, CPU plain {t2 - t1:.3f} s")
    return dict(card_s=t1 - t0, cpu_s=t2 - t1)


def flac_wrappers():
    from soundkit_tpu_torch.ops import flac_lpc, flac_rice

    return {"flac_rice_plane": flac_rice.flac_rice_plane, "flac_frame": flac_lpc.flac_frame}


def phase_flac(checked_rounds: int):
    """B ragged lanes of the FLAC fixtures through the decoder until
    they drain: FLAC_ROUNDS pushes, a decode after each. The first
    decode must fold ``checked_rounds`` rounds: the shape at which K8 and
    K9 were held against their plain versions."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder
    from soundkit_tpu_torch.tools import flac_fixtures as ff

    clips = ff.load_clips()
    streams = ff.lane_streams(clips, B)
    audio_s = sum(ff.lane_seconds(clips, B))
    model = BatchedFlacDecoder(B, FLAC_STRIDE, device="cuda", timed=True)
    wrappers = flac_wrappers()
    for w in wrappers.values():
        w.launches = 0
    push_s = decode_s = 0.0
    frames = samples = 0
    rounds = []
    peak = torch.zeros((), dtype=torch.int32, device="cuda")
    for r in range(FLAC_ROUNDS):
        t0 = time.perf_counter()
        for i, data in enumerate(flac_round_pushes(streams, r)):
            model.push(i, data)
        t1 = time.perf_counter()
        n = max(model.lane_ready(i) for i in range(B))
        out, metas = model.decode_batches(n, device_out=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        push_s += t1 - t0
        decode_s += t2 - t1
        rounds.append(n)
        blocks = np.stack(metas)[:, :, 0]
        frames += int((blocks > 0).sum())
        samples += int(blocks.sum())
        peak = torch.maximum(peak, out.abs().max())
        check(tuple(out.shape) == (n, B, 2, FLAC_STRIDE) and out.dtype == torch.int32,
              f"flac samples {tuple(out.shape)} {out.dtype}")
    launches = {n: w.launches for n, w in wrappers.items()}
    want_frames = sum(len(ff.lane_frames(clips, i)[1]) for i in range(B))
    check(frames == want_frames, f"flac: decoded {frames} frames of {want_frames}")
    check(all(model.lane_ready(i) == 0 for i in range(B)), "flac: lanes not drained")
    check(rounds[0] == checked_rounds,
          f"flac: the first decode folded {rounds[0]} rounds, the kernels were checked at "
          f"{checked_rounds}")
    check(int(peak) > (1 << 20), f"flac: peak {int(peak)} (the 24-bit lanes are missing)")
    for n, c in launches.items():
        check(c == FLAC_ROUNDS, f"{n} launched {c} times in {FLAC_ROUNDS} decodes")
    stages = model.stage_ms()
    res = dict(lanes=B, stride=FLAC_STRIDE, rounds=rounds, frames=frames, samples=samples,
               audio_s=audio_s, xrealtime=audio_s / (push_s + decode_s), push_s=push_s,
               decode_s=decode_s, xrealtime_decode_only=audio_s / decode_s,
               walk_ms_median_per_push=stages["walk"], export_ms_median=stages["export"],
               h2d_ms_median=stages["h2d"], device_step_ms_median=stages["step"],
               launches=launches)
    log(f"[flac] {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# MP3 phases
# ---------------------------------------------------------------------------

def mp3_round_pushes(streams, r: int):
    """What the MP3 phase pushes to each lane in round ``r``."""
    return [s[len(s) * r // MP3_ROUNDS: len(s) * (r + 1) // MP3_ROUNDS] for s in streams]


def phase_mp3_kernels():
    """K10 against its plain version on the card: on the MP3 path's next
    wire row after MP3_WARM (B = 1024 ragged fixture streams, C = 2, the
    decoder's carried state; the timed case), and on seeded random wires
    of B streams chained over four granules at C = 2 and C = 1 (block
    types -7..8, mixed lanes, invalid lanes and partners, alias
    boundaries outside 0..31, a non-zero starting state)."""
    import torch

    from soundkit_tpu_torch.ops import mp3_synth
    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    rows, overlap, fifo = kc.mp3_fixture_inputs(B, dev, warm=MP3_WARM)
    nbytes, flops = kc.mp3_synth_work(rows, overlap)
    r = measure("mp3_synth", "mp3_synth", *kc.mp3_synth_pair(rows, overlap, fifo),
                nbytes=nbytes, flops=flops, plain_reps=3)
    f = mp3_synth.unpack_mp3_wire(rows[0], B)
    valid = f["valid"][:, :C] != 0
    r.update(lanes=int(valid.numel()), valid_lanes=int(valid.sum()),
             short_lanes=int((f["bt"][:, :C] == 2)[valid].sum()),
             ms_streams=int((f["ms"] != 0).sum()), path_flops=flops)
    rand = {c: kc.compare("mp3_synth", *kc.mp3_synth_random_case(dev, seed=10 + c, streams=B,
                                                                 channels=c, granules=4))
            for c in (2, 1)}
    r.update(path_rel_err=r["rel_err"], random_rel_err=max(x["rel_err"] for x in rand.values()),
             max_abs_err=max(r["max_abs_err"], *(x["max_abs_err"] for x in rand.values())),
             rel_err=max(r["rel_err"], *(x["rel_err"] for x in rand.values())))
    log(f"[mp3-kernels] mp3_synth: path {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms), bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {nbytes} bytes, {flops} FLOP), "
        f"{r['valid_lanes']} of {r['lanes']} lanes valid; max rel err: path "
        f"{r['path_rel_err']:.2e}, random 4 chained granules x {B} streams C = 2 "
        f"{rand[2]['rel_err']:.2e}, C = 1 {rand[1]['rel_err']:.2e} "
        f"(bound {kc.REL_BOUND['mp3_synth']})")
    return {"mp3_synth": r}


def mp3_compare_run(device: str):
    """Two ``decode_batches`` calls (two granules, then three) of a B-lane
    decoder on ``device`` over the smoke lanes: PCM and the carried
    state, as numpy."""
    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.tools import mp3_fixtures as mf

    model = BatchedMp3Decoder(B, C, device=device)
    for i, data in enumerate(mf.lane_streams(mf.load_clips(), B, 4)):
        model.push(i, data)
    pcm = [model.decode_batches(n) for n in (2, 3)]
    return pcm, model._overlap.cpu().numpy(), model._fifo.cpu().numpy()


def phase_mp3_compare():
    """The card's MP3 decoder against the port's plain path on the CPU,
    from the same pushes: PCM >= 100 dB per lane, the carried overlap
    and FIFO within K10's bound of their largest value."""
    import numpy as np

    import torch

    from soundkit_tpu_torch.tools import kernel_check as kc

    t0 = time.perf_counter()
    g_pcm, g_ov, g_ff = mp3_compare_run("cuda")
    t1 = time.perf_counter()
    c_pcm, c_ov, c_ff = mp3_compare_run("cpu")
    t2 = time.perf_counter()
    worst, live = float("inf"), 0
    for call, (g, c) in enumerate(zip(g_pcm, c_pcm)):
        check(g.shape == c.shape == (g.shape[0], B, C, 576), f"mp3 call {call}: shapes differ")
        check(np.isfinite(g).all(), f"mp3 call {call}: non-finite PCM")
    got = np.concatenate(g_pcm).astype(np.float64)
    ref = np.concatenate(c_pcm).astype(np.float64)
    for b in range(B):
        sig, err = (ref[:, b] ** 2).sum(), ((got[:, b] - ref[:, b]) ** 2).sum()
        if sig == 0:
            check(err == 0, f"mp3 lane {b}: output on a silent lane")
            continue
        live += 1
        worst = min(worst, 10 * np.log10(sig / max(err, 1e-300)))
    state_rel = max(np.abs(g_ov - c_ov).max() / np.abs(c_ov).max(),
                    np.abs(g_ff - c_ff).max() / np.abs(c_ff).max())
    log(f"[mp3-compare] 2 calls (2 and 3 granules) x {B} lanes: min lane PCM SNR {worst:.2f} dB "
        f"over {live} lanes; carried state max rel err {state_rel:.2e}; card {t1 - t0:.3f} s, "
        f"CPU plain {t2 - t1:.3f} s")
    check(live > B // 2, f"mp3 compare: only {live} lanes carried sound")
    check(worst >= 100.0, f"mp3 card vs CPU: a lane at {worst:.2f} dB")
    check(state_rel <= kc.REL_BOUND["mp3_synth"], f"mp3 card vs CPU: state off by {state_rel:.2e}")
    # K10's requantize alone: its exp2f / powf against the plain version's on
    # the same (q, e), and the lane SNR each error leaves in the plain synthesis
    drift = kc.mp3_requantize_drift(kc.mp3_compare_rows(B, C), B, C, torch.device("cuda", 0),
                                    card_pcm=np.concatenate(g_pcm))
    log("[mp3-compare] requantize on the card vs the CPU: " + "; ".join(
        f"{k} max {drift[k]['max_ulp']:.2f} ulp, {drift[k]['differ']} of {drift[k]['pairs']} "
        f"differ, min lane SNR {drift[k]['min_lane_snr_db']:.2f} dB" for k in ("exp2f", "powf",
                                                                               "line"))
        + f"; K10 against the plain synthesis of its own lines: min lane SNR "
        f"{drift['after_requantize']['min_lane_snr_db']:.2f} dB (the whole drift "
        f"{drift['card']['min_lane_snr_db']:.2f} dB)")
    check(drift["card"]["min_lane_snr_db"] == worst
          or abs(drift["card"]["min_lane_snr_db"] - worst) < 1e-6,
          "mp3 compare: the drift's rerun of the plain path is not the CPU decoder's")
    return dict(min_pcm_snr_db=worst, lanes=live, state_rel_err=float(state_rel),
                card_s=t1 - t0, cpu_s=t2 - t1, requantize=drift)


def mp3_wrappers():
    from soundkit_tpu_torch.ops import mp3_synth

    return {"mp3_synth": mp3_synth.mp3_granule_packed}


def mp3_step_profile() -> dict:
    """Device operations a granule step runs at B = 1024 (kernels, and
    the collect's copies spread over its granules), and the device time
    a step of the kernels and of the copies in ms, by ``torch.profiler``
    over one 4-granule decode."""
    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.tools import mp3_fixtures as mf

    model = BatchedMp3Decoder(B, C, device="cuda")
    for i, data in enumerate(mf.lane_streams(mf.load_clips(), B, 4)):
        model.push(i, data)
    model.decode_batches(1)
    ops, _ = device_events(lambda: model.decode_batches(4))
    copies = [e for e in ops if e.name.startswith(("Memcpy", "Memset"))]

    def ms(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / 4

    return dict(kernels_per_granule=len(ops) / 4, kernel_ms_per_granule=ms(ops) - ms(copies),
                copy_ms_per_granule=ms(copies))


def phase_mp3():
    """B ragged lanes of the MP3 fixtures through the decoder until they
    drain: MP3_ROUNDS pushes, a decode of every ready granule after
    each; launch counters reset just before."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.codecs.mp3_native import NativeMp3Parser
    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.tools import mp3_fixtures as mf

    clips = mf.load_clips()
    streams = mf.lane_streams(clips, B)
    rates = np.array(mf.lane_rates(clips, B), np.float64)
    model = BatchedMp3Decoder(B, C, device="cuda", timed=True)
    wrappers = mp3_wrappers()
    for w in wrappers.values():
        w.launches = 0
    push_s = decode_s = 0.0
    granules = np.zeros(B, np.int64)
    steps = 0
    peak = torch.zeros((), device="cuda")
    for r in range(MP3_ROUNDS):
        t0 = time.perf_counter()
        for i, data in enumerate(mp3_round_pushes(streams, r)):
            model.push(i, data)
        t1 = time.perf_counter()
        ready = np.array([model.lane_ready(i) for i in range(B)])
        n = int(ready.max())
        pcm = model.decode_batches(n, device_out=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        push_s += t1 - t0
        decode_s += t2 - t1
        granules += ready
        steps += n
        check(tuple(pcm.shape) == (n, B, C, 576), f"mp3 pcm {tuple(pcm.shape)}")
        check(bool(torch.isfinite(pcm).all()), "mp3: non-finite PCM")
        peak = torch.maximum(peak, pcm.abs().max())
    launches = {n: w.launches for n, w in wrappers.items()}
    check(all(model.lane_ready(i) == 0 for i in range(B)), "mp3: lanes not drained")
    check(launches["mp3_synth"] == steps,
          f"mp3_synth launched {launches['mp3_synth']} times in {steps} granule steps")
    check(float(peak) > 0.1, f"mp3: peak {float(peak)} (silent)")
    # every granule a lane's whole stream gives a fresh parser came out
    want = [NativeMp3Parser().push(s) for s in streams]
    check(granules.tolist() == want, f"mp3: decoded {granules.sum()} granules, the streams "
          f"carry {sum(want)}")
    audio_s = float((granules * 576 / rates).sum())
    stages = model.stage_ms()
    res = dict(lanes=B, channels=C, rounds=MP3_ROUNDS, granule_steps=steps,
               granules=int(granules.sum()), granules_in_streams=int(sum(want)), audio_s=audio_s,
               xrealtime=audio_s / (push_s + decode_s), push_s=push_s, decode_s=decode_s,
               xrealtime_decode_only=audio_s / decode_s, parse_ms_median_per_push=stages["parse"],
               pop_ms_median=stages["pop"], h2d_ms_median=stages["h2d"],
               device_step_ms_median=stages["step"], launches=launches)
    prof = mp3_step_profile()
    res.update(device_kernels_per_granule=prof["kernels_per_granule"],
               device_kernel_ms_per_granule=prof["kernel_ms_per_granule"],
               device_copy_ms_per_granule=prof["copy_ms_per_granule"])
    log(f"[mp3] {json.dumps(res)}")
    check(prof["kernels_per_granule"] <= 2,
          f"mp3: {prof['kernels_per_granule']} device kernels a granule step (at most 2)")
    return res


# ---------------------------------------------------------------------------
# Opus CELT phases
# ---------------------------------------------------------------------------

def celt_wrappers():
    from soundkit_tpu_torch.ops import celt_postfilter

    return {"celt_postfilter": celt_postfilter.celt_postfilter}


def k11_chain_floor_ms(comb, valid) -> float:
    """K11's chain floor, estimated from the code: the comb steps of the
    slowest valid stream (``kernel_check.celt_comb_steps``: each region at
    ``min(128, Tmin - 2)`` samples over its taps with gains) at
    K11_STEP_CYCLES, then the de-emphasis memory's four rounds of six scan
    levels at K11_SCAN_CYCLES, at SM_CLOCK."""
    from soundkit_tpu_torch.tools import kernel_check as kc

    steps = kc.celt_comb_steps(comb.cpu().numpy())[valid.cpu().numpy()]
    return 1e3 * (int(steps.max(initial=0)) * K11_STEP_CYCLES + 4 * 6 * K11_SCAN_CYCLES) / SM_CLOCK


def in_turns(first, kernel, reps: int = 20) -> dict:
    """``kernel`` and its first design timed by graph replay in turns:
    first, kernel, kernel, first."""
    turns = [graph_ms(f, reps=reps) for f in (first, kernel, kernel, first)]
    return dict(ms=(turns[1] + turns[2]) / 2, first_ms=(turns[0] + turns[3]) / 2, turns_ms=turns)


def opus_build_info(name: str) -> dict:
    """Registers and spilled bytes of each instance of kernel ``name`` in
    the kernels' build and in the first designs' build (``ptxas -v``)."""
    from soundkit_tpu_torch import _build
    from soundkit_tpu_torch.tools import first_designs as fd

    def pick(so):
        return [dict(registers=b["registers"], spill_bytes=b["spill_stores"] + b["spill_loads"])
                for b in _build.build_info(so, name)]

    return dict(build=pick(_build.kernel_library_path()), first_build=pick(fd.library_path()))


def regs_text(info: dict) -> str:
    return "; ".join(f"{k}: " + ", ".join(f"{b['registers']} registers, {b['spill_bytes']} B "
                                          "spilled" for b in v) for k, v in info.items())


def phase_celt_kernels():
    """K11 against its plain version and its first design on the card: on
    the [celt] path's round after CELT_WARM decoded rounds (B = 1024
    ragged fixture lanes, C = 2, the decoder's carried state; the timed
    case), on seeded random frames of B streams at C = 2 and C = 1
    (periods 15..1022 and the edge periods, all three tapsets, zero and
    non-zero gains, a mix of valid and invalid streams; timed too) and on
    the seeded frames its step widths turn on (zero sets at period 15 beside
    long active ones, the postfilter turning on and off, periods 15 and 1024
    side by side; ``kc.celt_postfilter_schedule_inputs``). Bound 1e-5 of the
    largest plain value on the PCM and each state, and of the first
    design's; invalid streams bit-equal. Timed by graph replay in turns
    with the first design (``tools/first_designs``)."""
    import torch

    from soundkit_tpu_torch.tools import first_designs as fd
    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    bound_rel = kc.REL_BOUND["celt_postfilter"]

    def held(inputs) -> dict:
        kernel, plain = kc.celt_postfilter_pair(inputs)
        r = kc.compare("celt_postfilter", kernel, plain)
        got, first = kernel(), fd.celt_postfilter(*inputs)
        kc.celt_invalid_passthrough(got, inputs)
        rel = max(float((g.double() - f.double()).abs().max() / f.double().abs().max().clamp_min(1e-30))
                  for g, f in zip(got, first))
        check(rel <= bound_rel, f"celt_postfilter: {rel:.3e} from its first design")
        r["first_rel_err"] = rel
        return r

    inputs = kc.celt_fixture_inputs(B, dev, warm=CELT_WARM)
    nbytes, flops = kc.celt_postfilter_work(inputs)
    kernel, plain = kc.celt_postfilter_pair(inputs)
    r = held(inputs)
    r.update(in_turns(lambda: fd.celt_postfilter(*inputs), kernel))
    r["plain_ms"] = cuda_ms(plain, 3)
    r.update(bound(nbytes, flops))
    r["library_ms"] = None
    got, ref = kernel(), plain()
    hist_exact = bool(torch.equal(got[2], ref[2]))
    full, comb, valid = inputs[:3]
    chain_ms = k11_chain_floor_ms(comb, valid)
    rand, sched = {}, {}
    for c in (2, 1):
        rin = tuple(t.to(dev) for t in kc.celt_postfilter_random_inputs(20 + c, streams=B, channels=c))
        rand[c] = held(rin)
        rand[c].update(in_turns(lambda: fd.celt_postfilter(*rin), kc.celt_postfilter_pair(rin)[0]))
        sin = tuple(t.to(dev) for t in kc.celt_postfilter_schedule_inputs(60 + c, streams=B,
                                                                          channels=c))
        sched[c] = held(sin)
    postfilter = int(((comb[:, 2:8] != 0).any(1) | (comb[:, 10:16] != 0).any(1))[valid].sum())
    regs = opus_build_info("celt_postfilter")
    errs = [r, *rand.values(), *sched.values()]
    r.update(streams=B, valid_streams=int(valid.sum()), postfilter_streams=postfilter,
             path_rel_err=r["rel_err"], random_rel_err=max(x["rel_err"] for x in rand.values()),
             schedule_rel_err=max(x["rel_err"] for x in sched.values()),
             random_c2_ms=rand[2]["ms"], random_c2_first_ms=rand[2]["first_ms"],
             random_c1_ms=rand[1]["ms"], random_c1_first_ms=rand[1]["first_ms"],
             first_rel_err=max(x["first_rel_err"] for x in errs), chain_floor_ms=chain_ms,
             share_of_bound=r["bound_ms"] / r["ms"], **regs,
             max_abs_err=max(x["max_abs_err"] for x in errs),
             rel_err=max(x["rel_err"] for x in errs))
    log(f"[celt-kernels] celt_postfilter: path {r['ms']:.4f} ms, first design {r['first_ms']:.4f} "
        f"(turns {' / '.join(f'{t:.4f}' for t in r['turns_ms'])}; plain {r['plain_ms']:.3f} ms), "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {nbytes} bytes, {flops} FLOP; "
        f"{100 * r['share_of_bound']:.1f} %), chain floor ~{chain_ms:.4f} ms (estimated); random "
        f"{B} streams C = 2 {rand[2]['ms']:.4f} (first design {rand[2]['first_ms']:.4f}), C = 1 "
        f"{rand[1]['ms']:.4f} ({rand[1]['first_ms']:.4f}); {r['valid_streams']} of {B} streams "
        f"valid, {postfilter} with the postfilter on; max rel err: path {r['path_rel_err']:.2e} "
        f"(comb and history equal: {hist_exact}), random {r['random_rel_err']:.2e}, schedule "
        f"draws {r['schedule_rel_err']:.2e}, from the first design {r['first_rel_err']:.2e} "
        f"(bound {bound_rel}); invalid streams passed through bit-equal; {regs_text(regs)}")
    return {"celt_postfilter": r}


def celt_compare_run(device: str, wire: str):
    """Two decodes (CELT_WARM rounds, then the rest) of a B-lane CELT
    decoder on ``device`` over CELT_COMPARE_PACKETS packets of the smoke
    lanes: (PCM, lengths) of each, and the carried state, as numpy."""
    from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder
    from soundkit_tpu_torch.tools import opus_fixtures as of

    model = BatchedCeltDecoder(B, C, wire=wire, device=device)
    for i, data in enumerate(of.lane_raw(of.load_clips(), B, CELT_COMPARE_PACKETS)):
        model.push(i, data)
    out = [model.decode_ready(max_packets=n, device_out=True) for n in (CELT_WARM, None)]
    return ([(p.cpu().numpy(), lens) for p, lens in out],
            [t.cpu().numpy() for t in (model._ola, model._hist, model._emph)])


def phase_celt_compare():
    """The card's CELT decoder against the port's plain path on the CPU,
    from the same pushes, on the f32 and the i16 wire: PCM >= 100 dB per
    lane, lengths identical, the carried state within K11's bound."""
    import numpy as np

    from soundkit_tpu_torch.tools import kernel_check as kc

    res = {}
    for wire in ("f32", "i16"):
        t0 = time.perf_counter()
        g_out, g_state = celt_compare_run("cuda", wire)
        t1 = time.perf_counter()
        c_out, c_state = celt_compare_run("cpu", wire)
        t2 = time.perf_counter()
        for (g, gl), (c, cl) in zip(g_out, c_out):
            check(g.shape == c.shape and g.shape[1:] == (B, C, 960), f"celt {wire}: shapes differ")
            check(np.array_equal(gl, cl), f"celt {wire}: lengths differ")
            check(np.isfinite(g).all(), f"celt {wire}: non-finite PCM")
        got = np.concatenate([g for g, _ in g_out]).astype(np.float64)
        ref = np.concatenate([c for c, _ in c_out]).astype(np.float64)
        worst, live = float("inf"), 0
        for b in range(B):
            sig, err = (ref[:, b] ** 2).sum(), ((got[:, b] - ref[:, b]) ** 2).sum()
            if sig == 0:
                check(err == 0, f"celt {wire} lane {b}: output on a silent lane")
                continue
            live += 1
            worst = min(worst, 10 * np.log10(sig / max(err, 1e-300)))
        state_rel = max(float(np.abs(g - c).max() / np.abs(c).max()) for g, c in zip(g_state, c_state))
        log(f"[celt-compare] {wire} wire: 2 decodes ({CELT_WARM} and "
            f"{CELT_COMPARE_PACKETS - CELT_WARM} rounds) x {B} lanes: min lane PCM SNR "
            f"{worst:.2f} dB over {live} lanes; lengths identical; carried state max rel err "
            f"{state_rel:.2e}; card {t1 - t0:.3f} s, CPU plain {t2 - t1:.3f} s")
        check(live == B, f"celt compare: only {live} lanes carried sound")
        check(worst >= 100.0, f"celt {wire} card vs CPU: a lane at {worst:.2f} dB")
        check(state_rel <= kc.REL_BOUND["celt_postfilter"],
              f"celt {wire} card vs CPU: state off by {state_rel:.2e}")
        res[wire] = dict(min_pcm_snr_db=worst, lanes=live, state_rel_err=state_rel,
                         card_s=t1 - t0, cpu_s=t2 - t1)
    return res


def celt_step_profile() -> dict:
    """Device operations a round runs at B = 1024 (the step's kernels,
    and the collect's copies spread over its rounds) and their device
    time a round in ms, by ``torch.profiler`` over one 4-round decode."""
    from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder
    from soundkit_tpu_torch.tools import opus_fixtures as of

    model = BatchedCeltDecoder(B, C, device="cuda")
    for i, data in enumerate(of.lane_raw(of.load_clips(), B, 5)):
        model.push(i, data)
    model.decode_ready(max_packets=1, device_out=True)
    ops, _ = device_events(lambda: model.decode_ready(max_packets=4, device_out=True))
    copies = [e for e in ops if e.name.startswith(("Memcpy", "Memset"))]

    def ms(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / 4

    return dict(ops_per_round=len(ops) / 4, kernel_ms_per_round=ms(ops) - ms(copies),
                copy_ms_per_round=ms(copies), kernel_names=sorted({e.name[:60] for e in ops}))


def phase_celt():
    """B ragged stereo lanes of the Opus fixtures through the CELT decoder
    until they drain: CELT_ROUNDS pushes of the raw-Opus wire, a decode
    of every ready round after each; launch counters reset just before."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder
    from soundkit_tpu_torch.tools import opus_fixtures as of

    clips = of.load_clips()
    streams = of.lane_raw(clips, B)
    packets = np.array([len(of.lane_packets(clips, i)[1]) for i in range(B)])
    pre_skip = np.array([clips[i % len(clips)].pre_skip for i in range(B)])
    model = BatchedCeltDecoder(B, C, device="cuda", timed=True)
    wrappers = celt_wrappers()
    for w in wrappers.values():
        w.launches = 0
    push_s = decode_s = 0.0
    samples = np.zeros(B, np.int64)
    rounds = 0
    peak = torch.zeros((), device="cuda")
    for r in range(CELT_ROUNDS):
        t0 = time.perf_counter()
        for i, data in enumerate(streams):
            model.push(i, data[len(data) * r // CELT_ROUNDS: len(data) * (r + 1) // CELT_ROUNDS])
        t1 = time.perf_counter()
        n = max(model.queued(i) for i in range(B))
        pcm, lens = model.decode_ready(device_out=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        push_s += t1 - t0
        decode_s += t2 - t1
        rounds += n
        samples += lens.sum(axis=0)
        check(tuple(pcm.shape) == (n, B, C, 960), f"celt pcm {tuple(pcm.shape)}")
        check(bool(torch.isfinite(pcm).all()), "celt: non-finite PCM")
        peak = torch.maximum(peak, pcm.abs().max())
    launches = {n: w.launches for n, w in wrappers.items()}
    check(all(model.queued(i) == 0 for i in range(B)), "celt: lanes not drained")
    check(launches["celt_postfilter"] == rounds,
          f"celt_postfilter launched {launches['celt_postfilter']} times in {rounds} rounds")
    check(float(peak) > 0.1, f"celt: peak {float(peak)} (silent)")
    want = np.maximum(packets * 960 - pre_skip, 0)
    check(samples.tolist() == want.tolist(), f"celt: {samples.sum()} samples out, the streams "
          f"carry {want.sum()}")
    audio_s = float(samples.sum()) / RATE
    stages = model.stage_ms()
    res = dict(lanes=B, channels=C, pushes=CELT_ROUNDS, rounds=rounds, packets=int(packets.sum()),
               audio_s=audio_s, xrealtime=audio_s / (push_s + decode_s), push_s=push_s,
               decode_s=decode_s, xrealtime_decode_only=audio_s / decode_s,
               parse_ms_median_per_collect=stages["parse"], h2d_ms_median=stages["h2d"],
               device_step_ms_median=stages["step"], launches=launches,
               k11_launches_per_round=launches["celt_postfilter"] / rounds)
    prof = celt_step_profile()
    res.update(device_ops_per_round=prof["ops_per_round"],
               device_kernel_ms_per_round=prof["kernel_ms_per_round"],
               device_copy_ms_per_round=prof["copy_ms_per_round"])
    log(f"[celt] {json.dumps(res)}")
    log(f"[celt] device operations of a round: {prof['kernel_names']}")
    return res


# ---------------------------------------------------------------------------
# Opus SILK and hybrid phases
# ---------------------------------------------------------------------------

def voice_wrappers():
    from soundkit_tpu_torch.ops import celt_postfilter, silk_synth

    return {"silk_synth": silk_synth.silk_synth, "celt_postfilter": celt_postfilter.celt_postfilter}


def voice_clips(kind: str):
    """The clips of the ``kind`` ('silk' or 'hybrid') phases' lane mix."""
    from soundkit_tpu_torch.tools import opus_fixtures as of

    by_name = {c.name: c for c in of.load_clips(names=of.VOICE_CLIPS)}
    return [by_name[n] for n in (SILK_MIX if kind == "silk" else HYBRID_MIX)]


def voice_model(kind: str, device: str, timed: bool = False, n_packets=None):
    """A B-lane decoder of ``kind`` on ``device`` with the smoke lanes of
    its mix pushed, each configured from its OpusHead (pre-skip, gain),
    and the lanes' packet counts."""
    from soundkit_tpu_torch.models.opus_batch import BatchedHybridDecoder, BatchedSilkDeviceDecoder
    from soundkit_tpu_torch.tools import opus_fixtures as of

    clips = voice_clips(kind)
    cls = BatchedSilkDeviceDecoder if kind == "silk" else BatchedHybridDecoder
    model = cls(B, C, device=device, timed=timed)
    frames = [of.lane_frames(clips, i, n_packets) for i in range(B)]
    for i in range(B):
        clip = clips[i % len(clips)]
        model.configure_lane(i, clip.pre_skip, clip.output_gain)
    return model, frames


def k12_floors_ms(bw: int) -> tuple:
    """K12's chain floor and issue floor, estimated from the code, in ms at
    SM_CLOCK: a row's 4 sfl LPC samples at K12_SAMPLE_CYCLES (one product
    and one add from a sample to the next), and at the instructions the
    LPC thread issues a sample (2 order + 6: the products and adds, the
    residual load, the clip and the store)."""
    from soundkit_tpu_torch.ops import silk_synth as ss

    n = 4 * ss.SFL[bw]
    return (1e3 * n * K12_SAMPLE_CYCLES / SM_CLOCK, 1e3 * n * (2 * ss.ORDER[bw] + 6) / SM_CLOCK)


def phase_silk_kernels():
    """K12 against its plain version and its first design on the card, bit
    for bit: on the [silk] path's WB round after SILK_WARM decoded rounds
    (B = 1024 lanes of the [silk] mix x 2 rows: the WB launch runs over
    every lane; the timed case), on seeded random rounds of B streams at
    each bandwidth, C = 2 and 1 (lags at both ends, voiced and unvoiced
    rows, lead-in, invalid and all-zero lanes; C = 2 timed), and on the
    seeded rounds its schedule turns on (``kc.silk_synth_schedule_inputs``:
    warps of rows with and without lead-in side by side, lags 3, 16 and
    288, gains apart in every subframe). Timed by graph replay in turns
    with the first design (``tools/first_designs``)."""
    import torch

    from soundkit_tpu_torch.tools import first_designs as fd
    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)

    def held(bw: int, inputs) -> dict:
        kernel, plain = kc.silk_synth_pair(bw, inputs)
        r = kc.compare("silk_synth", kernel, plain)
        got, first = kernel(), fd.silk_synth(bw, *inputs)
        check(all(torch.equal(g, f) for g, f in zip(got, first)),
              f"silk_synth: differs from its first design at bandwidth {bw}")
        return r

    inputs = kc.silk_fixture_inputs(B, dev, warm=SILK_WARM, bw=2, names=SILK_MIX)
    nbytes, flops = kc.silk_synth_work(2, inputs)
    kernel, plain = kc.silk_synth_pair(2, inputs)
    r = held(2, inputs)
    r.update(in_turns(lambda: fd.silk_synth(2, *inputs), kernel))
    r["plain_ms"] = cuda_ms(plain, 2)
    r.update(bound(nbytes, flops))
    r["library_ms"] = None
    chain_ms, issue_ms = k12_floors_ms(2)
    rand = {}
    for bw in (0, 1, 2):
        for c in (2, 1):
            rin = tuple(t.to(dev) for t in kc.silk_synth_random_inputs(30 + bw, bw, streams=B,
                                                                      channels=c))
            rand[f"bw{bw}_c{c}"] = held(bw, rin)
            if c == 2:
                rand[f"bw{bw}_c{c}"].update(in_turns(lambda: fd.silk_synth(bw, *rin),
                                                     kc.silk_synth_pair(bw, rin)[0]))
        sin = tuple(t.to(dev) for t in kc.silk_synth_schedule_inputs(50 + bw, bw, streams=B))
        rand[f"schedule_bw{bw}"] = held(bw, sin)
    voiced = int((inputs[4] != 0).sum())
    lead = int((inputs[3] != 0).sum())
    regs = opus_build_info("silk_synth")
    r.update(streams=B, rows=2 * B, voiced_rows=voiced, lead_in_rows=lead, chain_floor_ms=chain_ms,
             issue_floor_ms=issue_ms, share_of_bound=r["bound_ms"] / r["ms"], **regs,
             **{f"random_{n}{k}": rand[f"bw{bw}_c2"][k[1:]] for bw, n in enumerate(("nb", "mb", "wb"))
                for k in ("_ms", "_first_ms")},
             max_abs_err=max(r["max_abs_err"], *(x["max_abs_err"] for x in rand.values())))
    log(f"[silk-kernels] silk_synth: path (WB, {B} streams x 2 rows, {voiced} voiced, {lead} with "
        f"lead-in) {r['ms']:.4f} ms, first design {r['first_ms']:.4f} (turns "
        f"{' / '.join(f'{t:.4f}' for t in r['turns_ms'])}; plain {r['plain_ms']:.3f} ms), bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {nbytes} bytes, {flops} FLOP; "
        f"{100 * r['share_of_bound']:.1f} %), chain floor ~{chain_ms:.4f} ms, issue floor "
        f"~{issue_ms:.4f} ms (estimated); random rounds C = 2, kernel (first design): NB "
        f"{r['random_nb_ms']:.4f} ({r['random_nb_first_ms']:.4f}), MB {r['random_mb_ms']:.4f} "
        f"({r['random_mb_first_ms']:.4f}), WB {r['random_wb_ms']:.4f} "
        f"({r['random_wb_first_ms']:.4f}) ms; bit-exact against the plain version and the first "
        f"design on the path, on random rounds at every bandwidth, C = 2 and 1, and on the "
        f"schedule draws; {regs_text(regs)}")
    return {"silk_synth": r}


def voice_compare_run(kind: str, device: str, packets: int, first: int):
    """Two decodes (``first`` rounds, then the rest) of a B-lane decoder of
    ``kind`` on ``device`` over ``packets`` packets of the smoke lanes:
    (PCM, lengths) of each, and the carried state, as numpy."""
    model, frames = voice_model(kind, device, n_packets=packets)
    for i, fr in enumerate(frames):
        for frame, bw, coded in fr:
            model.push_packet(i, frame, bw, coded)
    out = [model.decode_ready(max_packets=n, device_out=True) for n in (first, None)]
    if kind == "silk":
        state = [t for bw in sorted(model._state) for t in model._state[bw]]
    else:
        state = [*model._silk_state, *model._celt_state]
    return [(p.cpu().numpy(), lens) for p, lens in out], [t.cpu().numpy() for t in state]


def phase_voice_compare(kind: str):
    """The card's SILK (or hybrid) decoder against the port's plain path on
    the CPU, from the same pushes over two decodes: PCM >= 100 dB per lane,
    lengths identical, the carried state within 1e-5 of its largest value
    (K12 is bit-exact; the resample and IMDCT products sum in cuBLAS's
    order, K11 holds 1e-5)."""
    import numpy as np

    packets, first = ((SILK_COMPARE_PACKETS, SILK_WARM) if kind == "silk"
                      else (HYBRID_COMPARE_PACKETS, 8))
    t0 = time.perf_counter()
    g_out, g_state = voice_compare_run(kind, "cuda", packets, first)
    t1 = time.perf_counter()
    c_out, c_state = voice_compare_run(kind, "cpu", packets, first)
    t2 = time.perf_counter()
    for (g, gl), (c, cl) in zip(g_out, c_out):
        check(g.shape == c.shape and g.shape[1:] == (B, C, 960), f"{kind}: shapes differ")
        check(np.array_equal(gl, cl), f"{kind}: lengths differ")
        check(np.isfinite(g).all(), f"{kind}: non-finite PCM")
    got = np.concatenate([g for g, _ in g_out]).astype(np.float64)
    ref = np.concatenate([c for c, _ in c_out]).astype(np.float64)
    worst, live = float("inf"), 0
    for b in range(B):
        sig, err = (ref[:, b] ** 2).sum(), ((got[:, b] - ref[:, b]) ** 2).sum()
        if sig == 0:
            check(err == 0, f"{kind} lane {b}: output on a silent lane")
            continue
        live += 1
        worst = min(worst, 10 * np.log10(sig / max(err, 1e-300)))
    state_rel = max(float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30))
                    for g, c in zip(g_state, c_state))
    log(f"[{kind}-compare] 2 decodes ({first} and {packets - first} rounds) x {B} lanes: min lane "
        f"PCM SNR {worst:.2f} dB over {live} lanes; lengths identical; carried state max rel err "
        f"{state_rel:.2e}; card {t1 - t0:.3f} s, CPU plain {t2 - t1:.3f} s")
    check(live == B, f"{kind} compare: only {live} lanes carried sound")
    check(worst >= 100.0, f"{kind} card vs CPU: a lane at {worst:.2f} dB")
    check(state_rel <= 1e-5, f"{kind} card vs CPU: state off by {state_rel:.2e}")
    return dict(min_pcm_snr_db=worst, lanes=live, state_rel_err=state_rel, card_s=t1 - t0,
                cpu_s=t2 - t1)


def voice_step_profile(kind: str) -> dict:
    """Device operations and their device time, by ``torch.profiler``,
    a round of the SILK decoder (over 4 rounds of the [silk] mix: up to
    three bandwidth groups a round) or a chunk of the hybrid decoder (8
    rounds), at B = 1024."""
    model, frames = voice_model(kind, "cuda", n_packets=12 if kind == "silk" else 24)
    for i, fr in enumerate(frames):
        for frame, bw, coded in fr:
            model.push_packet(i, frame, bw, coded)
    model.decode_ready(max_packets=1 if kind == "silk" else 8, device_out=True)
    steps = 4 if kind == "silk" else 1
    ops, _ = device_events(
        lambda: model.decode_ready(max_packets=4 if kind == "silk" else 8, device_out=True))
    copies = [e for e in ops if e.name.startswith(("Memcpy", "Memset"))]

    def ms(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / steps

    return dict(ops_per_step=len(ops) / steps, kernel_ms_per_step=ms(ops) - ms(copies),
                copy_ms_per_step=ms(copies), kernel_names=sorted({e.name[:60] for e in ops}))


def phase_voice(kind: str):
    """B ragged lanes of the SILK mix (NB / MB / WB, a quarter stereo) or
    of the hybrid mix (SWB mono, FB stereo) through the decoder until they
    drain: SILK_ROUNDS (HYBRID_ROUNDS) pushes of every lane's packets, a
    decode of every ready round after each; launch counters reset just
    before. SILK: K12 once a bandwidth group a round (at most 3). Hybrid:
    K12 and K11 once a round of every chunk of 8. Every valid sample
    out."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.ops import silk_batch as sb

    clips = voice_clips(kind)
    model, frames = voice_model(kind, "cuda", timed=True)
    wrappers = voice_wrappers()
    for w in wrappers.values():
        w.launches = 0
    pushes = SILK_ROUNDS if kind == "silk" else HYBRID_ROUNDS
    push_s = decode_s = 0.0
    samples = np.zeros(B, np.int64)
    rounds = padded = groups = 0
    peak = torch.zeros((), device="cuda")
    for r in range(pushes):
        t0 = time.perf_counter()
        for i, fr in enumerate(frames):
            for frame, bw, coded in fr[len(fr) * r // pushes: len(fr) * (r + 1) // pushes]:
                model.push_packet(i, frame, bw, coded)
        t1 = time.perf_counter()
        n = max(model.lane_ready(i) for i in range(B))
        if kind == "silk":
            # bandwidth groups of each round of this decode (a lane's bandwidth is fixed)
            ready = np.array([model.lane_ready(i) for i in range(B)])
            bws = np.array([model.bw[i] for i in range(B)])
            groups += sum(len(set(bws[ready > k].tolist())) for k in range(n))
        pcm, lens = model.decode_ready(device_out=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        push_s += t1 - t0
        decode_s += t2 - t1
        rounds += n
        padded += -(-n // 8) * 8
        samples += lens.sum(axis=0)
        check(tuple(pcm.shape) == (n, B, C, 960), f"{kind} pcm {tuple(pcm.shape)}")
        check(bool(torch.isfinite(pcm).all()), f"{kind}: non-finite PCM")
        peak = torch.maximum(peak, pcm.abs().max())
    launches = {n: w.launches for n, w in wrappers.items()}
    check(all(model.lane_ready(i) == 0 for i in range(B)), f"{kind}: lanes not drained")
    if kind == "silk":
        check(launches["silk_synth"] == groups and launches["silk_synth"] <= 3 * rounds,
              f"silk_synth launched {launches['silk_synth']} times for {groups} bandwidth groups "
              f"in {rounds} rounds")
        check(launches["celt_postfilter"] == 0, "celt_postfilter launched on SILK lanes")
        lead = np.array([sb.lead_invalid(fr[0][1]) for fr in frames])
        skip = np.array([clips[i % len(clips)].pre_skip for i in range(B)])
    else:
        check(launches["silk_synth"] == padded and launches["celt_postfilter"] == padded,
              f"hybrid: {launches} for {padded} rounds (chunks of 8)")
        lead = np.zeros(B, np.int64)
        skip = np.array([clips[i % len(clips)].pre_skip for i in range(B)])
    check(float(peak) > 0.05, f"{kind}: peak {float(peak)} (silent)")
    packets = np.array([len(fr) for fr in frames])
    want = np.maximum(packets * 960 - lead - skip, 0)
    check(samples.tolist() == want.tolist(), f"{kind}: {samples.sum()} samples out, the streams "
          f"carry {want.sum()}")
    audio_s = float(samples.sum()) / RATE
    stages = model.stage_ms()
    res = dict(lanes=B, channels=C, pushes=pushes, rounds=rounds, packets=int(packets.sum()),
               audio_s=audio_s, xrealtime=audio_s / (push_s + decode_s), push_s=push_s,
               decode_s=decode_s, xrealtime_decode_only=audio_s / decode_s,
               walk_ms_median_per_collect=stages["parse"],
               walk_ms_per_round=stages["parse"] * pushes / rounds,
               h2d_ms_median_per_collect=stages["h2d"], launches=launches)
    if kind == "silk":
        res.update(device_step_ms_median_per_round=stages["step"], bandwidth_groups=groups,
                   k12_launches_per_round=launches["silk_synth"] / rounds)
    else:
        res.update(device_step_ms_median_per_chunk=stages["step"], padded_rounds=padded,
                   k12_launches_per_round=launches["silk_synth"] / padded,
                   k11_launches_per_round=launches["celt_postfilter"] / padded)
    prof = voice_step_profile(kind)
    unit = "round" if kind == "silk" else "chunk"
    res.update({f"device_ops_per_{unit}": prof["ops_per_step"],
                f"device_kernel_ms_per_{unit}": prof["kernel_ms_per_step"],
                f"device_copy_ms_per_{unit}": prof["copy_ms_per_step"]})
    log(f"[{kind}] {json.dumps(res)}")
    log(f"[{kind}] device operations of a {unit}: {prof['kernel_names']}")
    return res


# ---------------------------------------------------------------------------
# Ogg Vorbis phases
# ---------------------------------------------------------------------------

def vorbis_wrappers():
    from soundkit_tpu_torch.ops import vorbis_overlap

    return {"vorbis_overlap": vorbis_overlap.vorbis_overlap}


def phase_vorbis_kernels():
    """K13 against its plain version on the card, bit-exact: on the
    [vorbis] path's round after VORBIS_WARM decoded rounds (B = 1024 ragged
    stereo fixture lanes, the decoder's lap; the timed case), on seeded
    random rounds of B streams at C = 2 and C = 1 (every (previous,
    current) block-size case, random window flags, invalid lanes, a random
    lap) and on a case with n0 == n1."""
    import torch

    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    inputs = kc.vorbis_fixture_inputs(B, dev, warm=VORBIS_WARM)
    nbytes, flops = kc.vorbis_overlap_work(inputs)
    kernel, plain = kc.vorbis_overlap_pair(inputs)
    r = measure("vorbis_overlap", "vorbis_overlap", kernel, plain, nbytes=nbytes, flops=flops)
    # the graph's launches find their 38 MB warm in the 50 MB L2; the same launches with
    # the inputs rotated over four copies find them cold
    copies = [kc.vorbis_overlap_pair(tuple(t.clone() for t in inputs))[0] for _ in range(4)]
    turn = iter(range(1 << 30))
    r["cold_ms"] = graph_ms(lambda: copies[next(turn) % 4]())
    cases = {}
    for c, (n0, n1) in ((2, (256, 2048)), (1, (256, 2048)), (2, (256, 256)), (1, (512, 4096))):
        k, p = kc.vorbis_overlap_random_case(dev, 30 + c, streams=B, channels=c, n0=n0, n1=n1)
        cases[f"C{c}_{n0}_{n1}"] = kc.compare("vorbis_overlap", k, p)
    flags = inputs[3].cpu()
    valid = flags[3] != 0
    r.update(streams=B, valid_streams=int(valid.sum()),
             short_blocks=int((valid & (flags[0] == 0)).sum()),
             random_cases=sorted(cases), max_abs_err=max(r["max_abs_err"],
                                                         *(x["max_abs_err"] for x in cases.values())))
    log(f"[vorbis-kernels] vorbis_overlap: path {r['ms']:.4f} ms, inputs rotated over four "
        f"copies (out of L2) {r['cold_ms']:.4f} ms (plain {r['plain_ms']:.3f} ms), "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {nbytes} bytes, {flops} FLOP); "
        f"{r['valid_streams']} of {B} streams valid, {r['short_blocks']} short blocks; bit-exact "
        f"on the path and on random rounds {sorted(cases)}")
    return {"vorbis_overlap": r}


def vorbis_compare_run(device: str):
    """Two decodes (VORBIS_WARM rounds, then the rest) of a B-lane Vorbis
    decoder on ``device`` over VORBIS_COMPARE_PAGES audio pages of the
    smoke lanes: (PCM [rounds, B, C, 1024], lengths) of each, and the lap,
    as numpy."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder
    from soundkit_tpu_torch.tools import vorbis_fixtures as vf

    model = BatchedVorbisDecoder(B, device=device)
    clips = vf.load_clips(names=vf.STEREO)
    for i, data in enumerate(vf.lane_streams(clips, B, VORBIS_COMPARE_PAGES)):
        model.push(i, data)
    n = max(model.lane_ready(i) for i in range(B))
    out = []
    for k in (VORBIS_WARM, n - VORBIS_WARM):
        pcm, lens = model.decode_batches(k, device_out=True)
        out.append((torch.stack(pcm).cpu().numpy(), lens))
    return out, model._carry.cpu().numpy()


def phase_vorbis_compare():
    """The card's Vorbis decoder against the port's plain path on the CPU,
    from the same pushes: lengths identical, PCM >= 120 dB a lane (or
    identical), the lap within 1e-6 of its largest value."""
    import numpy as np

    t0 = time.perf_counter()
    g_out, g_carry = vorbis_compare_run("cuda")
    t1 = time.perf_counter()
    c_out, c_carry = vorbis_compare_run("cpu")
    t2 = time.perf_counter()
    for (g, gl), (c, cl) in zip(g_out, c_out):
        check(g.shape == c.shape and g.shape[1:] == (B, C, 1024), "vorbis: shapes differ")
        check(np.array_equal(gl, cl), "vorbis: lengths differ")
        check(np.isfinite(g).all(), "vorbis: non-finite PCM")
    got = np.concatenate([g for g, _ in g_out]).astype(np.float64)
    ref = np.concatenate([c for c, _ in c_out]).astype(np.float64)
    worst, live, identical = float("inf"), 0, 0
    for b in range(B):
        sig, err = (ref[:, b] ** 2).sum(), ((got[:, b] - ref[:, b]) ** 2).sum()
        check(sig > 0, f"vorbis lane {b}: silent")
        live += 1
        identical += int(err == 0)
        worst = min(worst, float(10 * np.log10(sig / max(err, 1e-300))))
    carry_rel = float(np.abs(g_carry - c_carry).max() / np.abs(c_carry).max())
    rounds = sum(g.shape[0] for g, _ in g_out)
    log(f"[vorbis-compare] 2 decodes ({VORBIS_WARM} and {rounds - VORBIS_WARM} rounds) x {B} "
        f"lanes: min lane PCM SNR {worst:.2f} dB over {live} lanes ({identical} identical); "
        f"lengths identical; lap max rel err {carry_rel:.2e}; card {t1 - t0:.3f} s, CPU plain "
        f"{t2 - t1:.3f} s")
    check(worst >= 120.0, f"vorbis card vs CPU: a lane at {worst:.2f} dB")
    check(carry_rel <= 1e-6, f"vorbis card vs CPU: lap off by {carry_rel:.2e}")
    return dict(min_pcm_snr_db=worst, lanes=live, identical_lanes=identical, rounds=rounds,
                carry_rel_err=carry_rel, card_s=t1 - t0, cpu_s=t2 - t1)


def vorbis_step_profile() -> dict:
    """Device operations a round runs at B = 1024 (the two IMDCT products,
    K13, the round's copies) and their device time a round in ms, by
    ``torch.profiler`` over one 4-round decode."""
    from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder
    from soundkit_tpu_torch.tools import vorbis_fixtures as vf

    model = BatchedVorbisDecoder(B, device="cuda")
    for i, data in enumerate(vf.lane_streams(vf.load_clips(names=vf.STEREO), B, 1)):
        model.push(i, data)
    model.decode_batches(1, device_out=True)
    ops, _ = device_events(lambda: model.decode_batches(4, device_out=True))
    copies = [e for e in ops if e.name.startswith(("Memcpy", "Memset"))]

    def ms(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / 4

    return dict(ops_per_round=len(ops) / 4, kernel_ms_per_round=ms(ops) - ms(copies),
                copy_ms_per_round=ms(copies), kernel_names=sorted({e.name[:60] for e in ops}))


def phase_vorbis():
    """B ragged stereo lanes of the two 44.1 kHz Vorbis fixtures through
    the decoder until they drain: VORBIS_ROUNDS pushes (the C++ packet
    parse runs in the push), a decode of every ready round after each;
    launch counters reset just before."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder
    from soundkit_tpu_torch.tools import vorbis_fixtures as vf

    clips = vf.load_clips(names=vf.STEREO)
    streams = vf.lane_streams(clips, B)
    want = vf.lane_samples(clips, B)
    model = BatchedVorbisDecoder(B, device="cuda", timed=True)
    wrappers = vorbis_wrappers()
    for w in wrappers.values():
        w.launches = 0
    push_s = decode_s = 0.0
    samples = np.zeros(B, np.int64)
    rounds = packets = 0
    peak = torch.zeros((), device="cuda")
    for r in range(VORBIS_ROUNDS):
        t0 = time.perf_counter()
        for i, data in enumerate(streams):
            model.push(i, data[len(data) * r // VORBIS_ROUNDS: len(data) * (r + 1) // VORBIS_ROUNDS])
        t1 = time.perf_counter()
        ready = [model.lane_ready(i) for i in range(B)]
        n = max(ready)
        pcm, lens = model.decode_batches(n, device_out=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        push_s += t1 - t0
        decode_s += t2 - t1
        rounds += n
        packets += sum(ready)
        samples += lens.sum(axis=0)
        for p in pcm:
            check(tuple(p.shape) == (B, C, 1024), f"vorbis pcm {tuple(p.shape)}")
        out = torch.stack(pcm)
        check(bool(torch.isfinite(out).all()), "vorbis: non-finite PCM")
        peak = torch.maximum(peak, out.abs().max())
    launches = {k: w.launches for k, w in wrappers.items()}
    check(all(model.lane_ready(i) == 0 for i in range(B)), "vorbis: lanes not drained")
    check(launches["vorbis_overlap"] == rounds,
          f"vorbis_overlap launched {launches['vorbis_overlap']} times in {rounds} rounds")
    check(float(peak) > 0.1, f"vorbis: peak {float(peak)} (silent)")
    check(samples.tolist() == want.tolist(), f"vorbis: {samples.sum()} samples out, the streams "
          f"carry {want.sum()}")
    audio_s = float(samples.sum()) / VORBIS_RATE
    stages = model.stage_ms()
    res = dict(lanes=B, channels=C, pushes=VORBIS_ROUNDS, rounds=rounds, packets=packets,
               audio_s=audio_s, xrealtime=audio_s / (push_s + decode_s), push_s=push_s,
               decode_s=decode_s, xrealtime_decode_only=audio_s / decode_s,
               parse_ms_per_push=1e3 * push_s / VORBIS_ROUNDS,
               parse_us_per_packet=1e6 * push_s / packets,
               pack_ms_median_per_collect=stages["pack"], h2d_ms_median_per_round=stages["h2d"],
               device_step_ms_median_per_round=stages["step"], launches=launches,
               k13_launches_per_round=launches["vorbis_overlap"] / rounds)
    prof = vorbis_step_profile()
    res.update(device_ops_per_round=prof["ops_per_round"],
               device_kernel_ms_per_round=prof["kernel_ms_per_round"],
               device_copy_ms_per_round=prof["copy_ms_per_round"])
    log(f"[vorbis] {json.dumps(res)}")
    log(f"[vorbis] device operations of a round: {prof['kernel_names']}")
    return res


def flac_enc_wrappers():
    from soundkit_tpu_torch.ops import flac_analyze

    return {"flac_analyze": flac_analyze.flac_analyze}


def flac_enc_lanes():
    """The [flac-enc] lanes: B lanes of FLAC_ENC_SECONDS s of 16-bit stereo
    44.1 kHz PCM, alternating between the PCM of the stereo16 and
    const_wasted fixtures (decoded by the port's FLAC decoder on the card),
    each from its own offset."""
    from soundkit_tpu_torch.tools import flac_fixtures as ff

    clips = {c.name: c for c in ff.load_clips()}
    pcms = [ff.clip_pcm(clips[name], "cuda") for name in ("stereo16", "const_wasted")]
    return ff.rotated_lanes(pcms, B, int(FLAC_ENC_SECONDS * FLAC_ENC_RATE))


def phase_flac_enc_kernels(lanes):
    """K14 against its plain version on the card, plan rows identical: on
    the wire of [flac-enc]'s first encode_pending (every full block of
    the B lanes' first push; the timed case), on seeded random rows at 16
    and 24 bits, stereo and mono, on the edge rows
    (``kernel_check.flac_analyze_edge_cases``), on one row of 65535
    samples, on 1, 131 and 133 rows, on calls back to back with n_valid
    4096, 1000 and 4096, and at 24-bit full scale; then prints K14's
    build (registers, spills, shared memory, blocks an SM, grid)."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.ops import flac_analyze
    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    x = kc.flac_enc_path_inputs(lanes, lanes[0].shape[1] // FLAC_ENC_PUSHES, dev)
    N = x.shape[-1]
    kernel, plain = kc.flac_analyze_pair(x, N, 16)
    r = kc.compare("flac_analyze", kernel, plain)
    plans = kernel().cpu().numpy()
    r["ms"] = graph_ms(kernel, reps=10, replays=3)
    r["plain_ms"] = cuda_ms(plain, 2)
    work = kc.flac_analyze_work(x, N)
    limit = kc.flac_analyze_bound(work)
    r.update(bound_ms=limit["bound_ms"], bound_by=limit["bound_by"], library_ms=None)
    cases = {}
    for bits in (16, 24):
        for ch in (2, 1):
            xr = kc.flac_analyze_inputs(70 + bits + ch, B, 4096, bits, ch).to(dev)
            cases[f"random_b{bits}_c{ch}"] = kc.compare(
                "flac_analyze", *kc.flac_analyze_pair(xr, 4096, bits, ch))
        for name, xe, n_valid, ch in kc.flac_analyze_edge_cases(bits):
            cases[f"{name}_b{bits}"] = kc.compare(
                "flac_analyze", *kc.flac_analyze_pair(xe.to(dev), n_valid, bits, ch))
        xl = kc.flac_analyze_inputs(bits, 1, 65535, bits).to(dev)
        cases[f"n65535_b{bits}"] = kc.compare(
            "flac_analyze", *kc.flac_analyze_pair(xl, 65535, bits))
    # the persistent grid's strides: fewer rows than blocks, and rows
    # around a multiple of the grid
    for rows in (1, 131, 133):
        xr = kc.flac_analyze_inputs(rows, rows, 4096, 16).to(dev)
        cases[f"rows{rows}"] = kc.compare("flac_analyze", *kc.flac_analyze_pair(xr, 4096, 16))
    # calls back to back, each with the window of its own n_valid
    for i, n_valid in enumerate((4096, 1000, 4096)):
        cases[f"n_valid_{n_valid}_call{i}"] = kc.compare(
            "flac_analyze", *kc.flac_analyze_pair(x[:B], n_valid, 16))
    for ch in (2, 1):
        xf = kc.flac_analyze_full_scale(5, B, 4096, 24, ch).to(dev)
        cases[f"full_scale_b24_c{ch}"] = kc.compare(
            "flac_analyze", *kc.flac_analyze_pair(xf, 4096, 24, ch))
    occ = {"int16": flac_analyze.occupancy(False), "int32": flac_analyze.occupancy(True)}
    assign = {int(a): int(n) for a, n in zip(*np.unique(plans[:, 0], return_counts=True))}
    r.update(rows=int(x.shape[0]), n=N, work=work, bound_parts=limit, occupancy=occ,
             share_of_bound=limit["bound_ms"] / r["ms"], assign_counts=assign,
             lpc_slots=int(plans[:, 1:3].sum()), cases=sorted(cases),
             max_abs_err=max(r["max_abs_err"], *(c["max_abs_err"] for c in cases.values())))
    log(f"[flac-enc-kernels] flac_analyze: path {r['rows']} rows x {N}: {r['ms']:.4f} ms by graph "
        f"replay (plain {r['plain_ms']:.2f} ms), bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
        f"bytes {limit['bytes_ms']:.4f}, float64 {limit['fp64_ms']:.4f}, integer "
        f"{limit['int_ms']:.4f} ms), {100 * r['share_of_bound']:.1f} % of it; plan rows "
        f"identical on the path and on {len(cases)} random and edge cases; assignments "
        f"{assign}, LPC slots {r['lpc_slots']} of {2 * r['rows']}")
    for wire, o in occ.items():
        log(f"[flac-enc-kernels] flac_analyze build, {wire} wire: {o['registers']} registers, "
            f"{o['local_bytes']} B spilled a thread, {o['shared_bytes']} B of shared memory a "
            f"block, {o['blocks_per_sm']} blocks an SM, a persistent grid of {o['grid']}")
    return {"flac_analyze": r}


def phase_flac_enc_compare():
    """An encoder on the card and one on the CPU fed the same pushes
    (FLAC_ENC_COMPARE_LANES lanes of each fixture clip's PCM, each lane
    rotated by its own offset, in two pushes with encode_pending after
    each, then finish_all) give byte-identical streams; every card stream
    decodes on the card to its input bit for bit, and its STREAMINFO
    MD5 is the input's."""
    import numpy as np
    from soundkit_tpu_torch.models.flac_encode_batch import BatchedFlacEncoder
    from soundkit_tpu_torch.tools import flac_fixtures as ff

    res = {}
    for clip in ff.load_clips():
        pcm = ff.clip_pcm(clip, "cuda")
        lanes = ff.rotated_lanes([pcm], FLAC_ENC_COMPARE_LANES, pcm.shape[1])
        half = pcm.shape[1] // 2
        streams, secs = {}, {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            enc = BatchedFlacEncoder(len(lanes), clip.rate, clip.channels, clip.bits,
                                     device=device)
            for lo, hi in ((0, half), (half, None)):
                for i, x in enumerate(lanes):
                    enc.push(i, x[:, lo:hi])
                enc.encode_pending()
            streams[device] = enc.finish_all()
            secs[device] = time.perf_counter() - t0
        check(streams["cuda"] == streams["cpu"], f"flac-enc {clip.name}: card and CPU streams differ")
        decoded = ff.decode_streams(streams["cuda"], "cuda")
        for i, (x, got, stream) in enumerate(zip(lanes, decoded, streams["cuda"])):
            check(got.shape == x.shape and np.array_equal(got, x),
                  f"flac-enc {clip.name} lane {i}: the round trip differs")
            check(ff.streaminfo_md5(stream) == ff.pcm_md5(x, clip.bits),
                  f"flac-enc {clip.name} lane {i}: STREAMINFO MD5 is not the input's")
        nbytes = sum(len(st) for st in streams["cuda"])
        res[clip.name] = dict(lanes=len(lanes), samples=int(pcm.shape[1]), bytes=nbytes,
                              ratio=nbytes / (pcm.size * len(lanes) * clip.bits / 8),
                              card_s=secs["cuda"], cpu_s=secs["cpu"])
        log(f"[flac-enc-compare] {clip.name}: {res[clip.name]}; streams byte-identical, round "
            f"trip bit-exact, MD5 right")
    return res


def phase_flac_enc(lanes):
    """B lanes of [flac-enc] PCM through a timed encoder on the card:
    FLAC_ENC_PUSHES pushes with an encode_pending after each, then
    finish_all; launch counters reset just before. K14 launches once a
    device call (each encode_pending with blocks, each distinct tail
    length); FLAC_ENC_ROUNDTRIP lanes decode back bit-exactly with their
    MD5."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.models.flac_encode_batch import STAGES, BatchedFlacEncoder
    from soundkit_tpu_torch.tools import flac_fixtures as ff

    n = lanes[0].shape[1]
    step = n // FLAC_ENC_PUSHES
    wrappers = flac_enc_wrappers()
    enc = BatchedFlacEncoder(B, int(FLAC_ENC_RATE), 2, 16, device="cuda", timed=True)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    push_s = pending_s = 0.0
    calls = frames = 0
    t_start = time.perf_counter()
    for r in range(FLAC_ENC_PUSHES):
        hi = n if r == FLAC_ENC_PUSHES - 1 else (r + 1) * step
        t0 = time.perf_counter()
        for i, x in enumerate(lanes):
            enc.push(i, x[:, r * step: hi])
        t1 = time.perf_counter()
        made = enc.encode_pending()
        pending_s += time.perf_counter() - t1
        push_s += t1 - t0
        calls += made > 0
        frames += made
    t2 = time.perf_counter()
    streams = enc.finish_all()
    wall = time.perf_counter() - t_start
    finish_s = time.perf_counter() - t2
    launches = {k: w.launches for k, w in wrappers.items()}
    tails = int(n % enc.block_size > 0)  # every lane holds n samples: one tail length
    check(launches["flac_analyze"] == calls + tails,
          f"flac_analyze launched {launches['flac_analyze']} times in {calls} encode_pending "
          f"calls and {tails} tail length")
    check(len(streams) == B and all(st[:4] == b"fLaC" for st in streams), "flac-enc: streams")
    picks = list(range(0, B, B // FLAC_ENC_ROUNDTRIP))
    decoded = ff.decode_streams([streams[i] for i in picks], "cuda")
    for i, got in zip(picks, decoded):
        check(np.array_equal(got, lanes[i]), f"flac-enc lane {i}: the round trip differs")
        check(ff.streaminfo_md5(streams[i]) == ff.pcm_md5(lanes[i], 16),
              f"flac-enc lane {i}: STREAMINFO MD5 is not the input's")
    audio_s = B * n / FLAC_ENC_RATE
    stages = enc.stage_s()
    split = {f"{k}_s": stages[k] for k in STAGES}
    nbytes = sum(len(st) for st in streams)
    res = dict(lanes=B, seconds_per_lane=n / FLAC_ENC_RATE, pushes=FLAC_ENC_PUSHES,
               audio_s=audio_s, wall_s=wall, xrealtime=audio_s / wall, push_s=push_s,
               encode_pending_s=pending_s, finish_all_s=finish_s, frames=frames + B * tails,
               device_calls=stages["calls"], **split,
               other_s=wall - sum(split.values()), launches=launches,
               bytes_out=nbytes, ratio=nbytes / (B * n * 4), roundtrip_lanes=len(picks))
    log(f"[flac-enc] {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# resampler and phase vocoder phases
# ---------------------------------------------------------------------------

def dsp_wrappers():
    from soundkit_tpu_torch.ops import mp3_synth, phase_lock, stretch_ola
    from soundkit_tpu_torch.ops import resample as rs

    return {"mp3_synth": mp3_synth.mp3_granule_packed, "polyphase_fir": rs.polyphase_fir,
            "overlap_add": stretch_ola.overlap_add, "phase_lock": phase_lock.phase_lock}


def k15_occupancy(plan) -> dict:
    """Registers a thread, spilled bytes a thread and resident warps an SM
    of K15's instance for ``plan`` (``skt_resample_occupancy``)."""
    import ctypes

    from soundkit_tpu_torch import _build

    occ = (ctypes.c_int * 3)()
    check(_build.kernels().skt_resample_occupancy(plan.RC, plan.WS, plan.threads, plan.smem, occ) == 0,
          "skt_resample_occupancy failed")
    return dict(registers=occ[0], local_bytes=occ[1], blocks_per_sm=occ[2],
                warps_per_sm=occ[2] * plan.threads // 32)


def k15_timed(x, in_rate: int, out_rate: int, hist=None, reps: int = 20) -> dict:
    """K15 on ``x`` (and ``hist``) held to its plain version and to its
    first design (bit for bit) and timed by graph replay in turns with the
    first design (first, kernel, kernel, first), beside the plain version,
    ``F.conv1d`` (cuDNN, IEEE float32) and the bound of its work
    (``kernel_check.resample_work``); with its launch plan and occupancy."""
    import torch

    from soundkit_tpu_torch.ops import resample as rs
    from soundkit_tpu_torch.tools import first_designs as fd
    from soundkit_tpu_torch.tools import kernel_check as kc

    kernel, plain = kc.resample_pair(x, in_rate, out_rate, hist)
    r = kc.compare("polyphase_fir", kernel, plain)
    _, _, L, M = rs.design_polyphase(in_rate, out_rate)
    rows, n = x.shape
    n_out = rs.out_len(n, L, M)

    def first():
        return fd.polyphase_fir(x, hist, in_rate, out_rate, n_out)

    check(torch.equal(kernel(), first()), f"polyphase_fir {in_rate} -> {out_rate}: differs from "
          "its first design")
    nbytes, flops = kc.resample_work(rows, n, n_out, L, hist is not None)
    turns = [graph_ms(f, reps=reps) for f in (first, kernel, kernel, first)]
    r["ms"] = (turns[1] + turns[2]) / 2
    r["first_ms"] = (turns[0] + turns[3]) / 2
    r["turns_ms"] = turns
    r["plain_ms"] = cuda_ms(plain, 5)
    r["library_ms"] = graph_ms(kc.conv1d_library(x, in_rate, out_rate, hist), reps=reps)
    r.update(bound(nbytes, flops))
    plan = rs.k15_plan(in_rate, out_rate, n_out)
    r.update(rows=rows, n=n, n_out=n_out, L=L, M=M, plan=plan._asdict(), **k15_occupancy(plan),
             first_tile_cycles=fd.tile_cycles(L, M, -(-n_out // L)),
             share_of_bound=r["bound_ms"] / r["ms"], first_share_of_bound=r["bound_ms"] / r["first_ms"])
    return r


def phase_resample_kernels():
    """K15 against its plain version on the card (cuDNN's convolution under
    ``ieee_fp32``) at every pair of COMMON_SAMPLE_RATES and 3000 -> 2000,
    one-shot and from a carried history, and chunked equal to one-shot bit
    for bit; then timed on the [transcode] chunk (B x 28,224 samples with a
    history, 44.1 -> 8 kHz) and on the [stretch] resample (B x 165,375,
    3000 -> 2000), each beside its bound and ``F.conv1d``."""
    import torch

    from soundkit_tpu_torch.ops import resample as rs
    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    sweep = {}
    for a, b in kc.RESAMPLE_PAIRS:
        errs = [kc.compare("polyphase_fir", *kc.resample_case(a, b, RESAMPLE_SWEEP_LANES, dev,
                                                             seed=1, stateful=s))["max_abs_err"]
                for s in (False, True)]
        M = rs.design_polyphase(a, b)[3]
        chunked, one = kc.resample_chunked(kc.resample_rows(3, RESAMPLE_SWEEP_LANES, 12 * M, dev),
                                           a, b, 4 * M)
        check(torch.equal(chunked, one), f"polyphase_fir {a} -> {b}: chunked differs from one-shot")
        sweep[f"{a}->{b}"] = max(errs)
    x = kc.resample_rows(7, B, TRANSCODE_CHUNK_SAMPLES, dev)
    r = k15_timed(x, 44100, 8000, kc.resample_rows(8, B, rs.SINC_LEN - 1, dev))
    chunked, one = kc.resample_chunked(kc.resample_rows(9, B, 3 * TRANSCODE_CHUNK_SAMPLES, dev),
                                       44100, 8000, TRANSCODE_CHUNK_SAMPLES)
    check(torch.equal(chunked, one), "polyphase_fir: the transcode chunks differ from one-shot")
    del x, chunked, one
    stretched = kc.resample_rows(10, B, round(STRETCH_SECONDS * STRETCH_RATE * STRETCH_RATIO
                                              * STRETCH_PITCH), dev)
    sr = k15_timed(stretched, 3000, 2000, reps=10)
    del stretched
    r.update(stretch=sr, pairs=len(sweep), sweep_max_abs_err=max(sweep.values()),
             max_abs_err=max(r["max_abs_err"], sr["max_abs_err"], *sweep.values()))
    log(f"[resample-kernels] polyphase_fir: {len(sweep)} rate pairs x {RESAMPLE_SWEEP_LANES} rows, "
        f"one-shot and carried, within {max(sweep.values()):.3g} of the plain version; chunked "
        f"equals one-shot bit for bit at every pair and on 3 transcode chunks")
    for tag, c in (("transcode chunk", r), ("stretch resample", sr)):
        p = c["plan"]
        log(f"[resample-kernels] polyphase_fir {tag} [{c['rows']}, {c['n']}] -> {c['n_out']} "
            f"(L {c['L']}, M {c['M']}; super-cycle {p['Lq']} / {p['Mq']}, {p['G']} groups, "
            f"{p['RC']} super-cycles a thread, {p['threads']} threads and {p['smem']} B a block; "
            f"{c['registers']} registers, {c['local_bytes']} B spilled, {c['warps_per_sm']} warps "
            f"an SM): {c['ms']:.4f} ms by graph replay ({100 * c['share_of_bound']:.1f} % of its "
            f"bound), the first design {c['first_ms']:.4f} ({100 * c['first_share_of_bound']:.1f} "
            f"%; turns {', '.join(f'{v:.4f}' for v in c['turns_ms'])}), plain "
            f"{c['plain_ms']:.4f}, F.conv1d {c['library_ms']:.4f}, bound {c['bound_ms']:.4f} "
            f"({c['bound_by']}); max|d| {c['max_abs_err']:.3g}, equal to the first design")
    return {"polyphase_fir": r}


def phase_transcode():
    """The MP3 -> 8 kHz µ-law chain at full width: B lanes of the stereo44
    fixture (each the whole clip from its own frame), chunks of 49
    granules through ``BatchedMp3Decoder`` (K10) and the tail (downmix,
    K15's carried-state resample, µ-law), codes on the card until the end.
    The counted run (one push, every whole chunk; launch counters reset
    just before) is held to a continuous one-shot ``resample_np`` of each
    lane's whole decoded mono signal; then TRANSCODE_PASSES timed passes
    as the reference's bench runs them (the parsers re-fed, x realtime of
    the decode and tail, best of the passes)."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.ops import resample as rs
    from soundkit_tpu_torch.tools import mp3_fixtures as mf
    from soundkit_tpu_torch.tools import transcode as tc

    clip = next(c for c in mf.load_clips() if c.name == "stereo44")
    streams = mf.rotated_streams(clip, B)
    wrappers = dsp_wrappers()
    model = BatchedMp3Decoder(B, C, device="cuda")
    for i, s in enumerate(streams):
        model.push(i, s)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    codes, hist, granules, monos = tc.transcode_ready(model, rs.resample_init_state(B),
                                                      keep_mono=True)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    chunks = len(codes)
    check(chunks >= 4, f"transcode: {chunks} chunks of {tc.CHUNK} granules")
    check(launches["mp3_synth"] == granules and launches["polyphase_fir"] == chunks,
          f"transcode: launches {launches} for {granules} granules and {chunks} chunks")
    got = torch.cat(codes, dim=1).cpu().numpy()
    mono = torch.cat(monos, dim=1).cpu().numpy()
    del monos
    t0 = time.perf_counter()
    ref = tc.continuous_codes(mono, got.shape[1])
    ref_s = time.perf_counter() - t0
    check(got.shape == ref.shape == (B, granules * tc.GRANULE * 80 // 441),
          f"transcode codes {got.shape}, reference {ref.shape}")
    differ, off_step = tc.codes_apart(got, ref)
    check(differ <= 1e-4 * got.size and off_step == 0,
          f"transcode: {differ} of {got.size} codes differ, {off_step} by more than a step")
    check(np.abs(mono).max() > 0.1, "transcode: silent PCM")

    tmodel = BatchedMp3Decoder(B, C, device="cuda", timed=True)
    t0 = time.perf_counter()
    for i, s in enumerate(streams):
        tmodel.push(i, s)
    first_push_s = time.perf_counter() - t0
    hist0 = rs.resample_init_state(B)
    warm = tmodel.decode_ready(max_granules=tc.CHUNK, device_out=True)
    merged = warm.permute(1, 2, 0, 3).reshape(B, C, -1)
    tail_ms = cuda_ms(lambda: tc.tail_stage(merged, hist0), 10)
    torch.cuda.synchronize()
    passes = []
    for _ in range(TRANSCODE_PASSES):
        t0 = time.perf_counter()
        for i, s in enumerate(streams):
            tmodel.push(i, s)
        t1 = time.perf_counter()
        pcodes, _, g, _ = tc.transcode_ready(tmodel, hist0)
        last = pcodes[-1].cpu()  # the last chunk's codes back to the host
        wall = time.perf_counter() - t1
        audio_s = g * tc.GRANULE / tc.SRC_RATE * B
        passes.append(dict(granules=g, chunks=len(pcodes), push_s=t1 - t0, wall_s=wall,
                           audio_s=audio_s, xrealtime=audio_s / wall,
                           xrealtime_with_parse=audio_s / (wall + t1 - t0)))
        check(last.dtype == torch.uint8 and last.shape[0] == B, "transcode: codes")
    stages = tmodel.stage_ms()
    best = max(passes, key=lambda p: p["xrealtime"])
    res = dict(lanes=B, chunk_granules=tc.CHUNK, checked_chunks=chunks, checked_granules=granules,
               codes_identical=1 - differ / got.size, codes_differing=differ, codes=int(got.size), reference_s=ref_s, first_push_s=first_push_s,
               passes=passes, xrealtime=best["xrealtime"],
               xrealtime_with_parse=best["xrealtime_with_parse"],
               parse_ms_median_per_push=stages["parse"], pop_ms_median=stages["pop"],
               h2d_ms_median=stages["h2d"], k10_step_ms_median=stages["step"],
               tail_ms=tail_ms, launches=launches)
    log(f"[transcode] {json.dumps(res)}")
    return res


def stretch_lanes():
    """The [stretch] input: B mono lanes of STRETCH_SECONDS at 44.1 kHz on
    the card, from the stereo44 fixture decoded on the card and downmixed,
    lane i from sample 37 i mod (length - lane)."""
    import torch

    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.tools import mp3_fixtures as mf

    clip = next(c for c in mf.load_clips() if c.name == "stereo44")
    model = BatchedMp3Decoder(1, C, device="cuda")
    model.push(0, clip.stream())
    pcm = model.decode_ready(device_out=True)  # [G, 1, C, 576]
    mono = pcm[:, 0].permute(1, 0, 2).reshape(C, -1).mean(dim=0)
    n = int(STRETCH_SECONDS * STRETCH_RATE)
    check(mono.shape[0] > n, f"stretch: the clip has {mono.shape[0]} samples")
    offs = torch.tensor([(37 * i) % (mono.shape[0] - n) for i in range(B)], device=mono.device)
    return mono[offs[:, None] + torch.arange(n, device=mono.device)[None, :]].contiguous()


def phase_stretch_kernels(x):
    """K17 and K16 on the [stretch] path's own tensors (the vocoder at
    time ratio x pitch over ``x``): K17's nearest identical to its plain
    version and to its first design's, its spectrum within 3 ulps of the
    rotation's argument and within 2^-21 of the magnitude of float64 cos /
    sin; K16 bit-exact on the irfft of K17's spectrum against its plain
    version and its first design; both timed by graph replay in turns with
    their first designs, with their byte bounds and builds, K16 beside
    ``F.fold``."""
    import ctypes

    import torch

    from soundkit_tpu_torch import _build
    from soundkit_tpu_torch.ops import phase_lock, stretch_ola
    from soundkit_tpu_torch.ops import stretch as st
    from soundkit_tpu_torch.tools import first_designs as fd
    from soundkit_tpu_torch.tools import kernel_check as kc

    mag, phase, syn, win, hop, target = st.vocoder_analysis(x, STRETCH_RATIO * STRETCH_PITCH)
    r17 = kc.phase_lock_check(mag, phase, syn)
    rows, K = mag.numel() // mag.shape[-1], mag.shape[-1]
    _, near = phase_lock.phase_lock(mag, phase, syn, with_nearest=True)
    first_spec, first_near = fd.phase_lock(mag, phase, syn, with_nearest=True)
    check(torch.equal(near, first_near), "phase_lock: nearest differs from its first design")
    r17["first_max_abs_diff"] = float((phase_lock.phase_lock(mag, phase, syn) - first_spec).abs().max())
    del near, first_spec, first_near
    turns = [graph_ms(f, reps=2, replays=5) for f in (
        lambda: fd.phase_lock(mag, phase, syn), lambda: phase_lock.phase_lock(mag, phase, syn),
        lambda: phase_lock.phase_lock(mag, phase, syn), lambda: fd.phase_lock(mag, phase, syn))]
    r17["ms"] = (turns[1] + turns[2]) / 2
    r17["first_ms"] = (turns[0] + turns[3]) / 2
    r17["turns_ms"] = turns
    r17["plain_ms"] = cuda_ms(lambda: phase_lock.phase_lock_plain(mag, phase, syn), 1)
    occ = (ctypes.c_int * 4)()
    check(_build.kernels().skt_phase_lock_occupancy(K, occ) == 0, "skt_phase_lock_occupancy failed")
    r17.update(bound(kc.phase_lock_work(rows, K)), library_ms=None, rows=rows, K=K,
               syn_abs_max=float(syn.abs().max()), registers=occ[0], local_bytes=occ[1],
               smem=occ[2], warps_per_sm=occ[3] * 8)
    r17["share_of_bound"] = r17["bound_ms"] / r17["ms"]
    r17["first_share_of_bound"] = r17["bound_ms"] / r17["first_ms"]
    spec = phase_lock.phase_lock(mag, phase, syn)
    del mag, phase, syn
    frames = torch.fft.irfft(spec, n=st.FRAME, dim=-1)
    del spec
    B_, T, F = frames.shape
    kernel, plain = kc.stretch_ola_pair(frames, win, hop, target)
    first = lambda: fd.overlap_add(frames, win, hop, target)  # noqa: E731
    r16 = kc.compare("overlap_add", kernel, plain)
    check(torch.equal(kernel(), first()), "overlap_add: differs from its first design")
    turns = [graph_ms(f, reps=10, replays=3) for f in (first, kernel, kernel, first)]
    r16.update(ms=(turns[1] + turns[2]) / 2, first_ms=(turns[0] + turns[3]) / 2, turns_ms=turns)
    r16["plain_ms"] = cuda_ms(plain, 1)
    r16["library_ms"] = graph_ms(kc.fold_library(frames, win, hop, target), reps=3, replays=3)
    V = stretch_ola.k16_vector(F, hop, F // 2, frames.data_ptr(), win.data_ptr())
    occ = (ctypes.c_int * 4)()
    check(_build.kernels().skt_stretch_ola_occupancy(V, occ) == 0,
          "skt_stretch_ola_occupancy failed")
    r16.update(bound(kc.stretch_ola_work(B_, T, F, hop, target)), frames=T, hop=hop,
               target=target, vector=V, registers=occ[0], local_bytes=occ[1],
               smem=occ[2], warps_per_sm=occ[3] * 8, first_build=[
                   dict(registers=b["registers"], spill_bytes=b["spill_stores"] + b["spill_loads"])
                   for b in _build.build_info(fd.library_path(), "stretch_")])
    r16["share_of_bound"] = r16["bound_ms"] / r16["ms"]
    r16["first_share_of_bound"] = r16["bound_ms"] / r16["first_ms"]
    del frames
    torch.cuda.empty_cache()
    log(f"[stretch-kernels] phase_lock [{rows} rows, {K} bins], |syn| up to "
        f"{r17['syn_abs_max']:.4g} rad: nearest identical (and to the first design's), spectrum "
        f"within {r17['max_ulps']:.3f} ulps of the argument (max|d| {r17['max_abs_err']:.3g}) and "
        f"{r17['max_f64_err']:.3g} of the magnitude from float64 cos / sin (bound 2^-21), "
        f"{r17['first_max_abs_diff']:.3g} from the first design; {r17['registers']} registers, "
        f"{r17['local_bytes']} B spilled, {r17['smem']} B shared a block, {r17['warps_per_sm']} "
        f"warps an SM; {r17['ms']:.4f} ms by graph replay ({100 * r17['share_of_bound']:.1f} % "
        f"of its bound), the first design {r17['first_ms']:.4f} "
        f"({100 * r17['first_share_of_bound']:.1f} %; turns "
        f"{', '.join(f'{v:.4f}' for v in r17['turns_ms'])}), plain {r17['plain_ms']:.3f}, bound "
        f"{r17['bound_ms']:.4f} ({r17['bound_by']})")
    log(f"[stretch-kernels] overlap_add [{B_}, {T}, {F}] hop {hop} -> [{B_}, {target}]: bit-exact "
        f"(and to the first design); V {V}, {r16['registers']} registers, "
        f"{r16['local_bytes']} B spilled, {r16['smem']} B shared a block, {r16['warps_per_sm']} "
        f"warps an SM (the first design's two kernels: "
        f"{regs_text({'build': r16['first_build']}).removeprefix('build: ')}); "
        f"{r16['ms']:.4f} ms by graph replay ({100 * r16['share_of_bound']:.1f} % of its bound), "
        f"the first design {r16['first_ms']:.4f} ({100 * r16['first_share_of_bound']:.1f} %; "
        f"turns {', '.join(f'{v:.4f}' for v in r16['turns_ms'])}), plain "
        f"{r16['plain_ms']:.3f}, F.fold {r16['library_ms']:.4f}, bound {r16['bound_ms']:.4f} "
        f"({r16['bound_by']})")
    return {"phase_lock": r17, "overlap_add": r16}


def stretch_profile(x, formant) -> dict:
    """Device time of one pitch shift over ``x`` by ``torch.profiler``,
    split by operation: the FFTs, the cumsum, K15-K17, copies, the rest
    (glue). Sessions repeat until the largest operation count seen has
    been read twice (``PROFILE_SESSIONS``), and the split is the first of
    those two; fails if no two sessions agree on it."""
    from soundkit_tpu_torch.ops import stretch as st

    sessions = []
    least, most = PROFILE_SESSIONS
    for i in range(most):
        sessions.append(device_events(
            lambda: st.pitch_shift_batch_device(x, STRETCH_RATIO, STRETCH_PITCH, formant)))
        counts = [len(ops) for ops, _ in sessions]
        agreed = max(counts) > 0 and counts.count(max(counts)) >= 2
        if agreed and i + 1 >= least:
            break
    check(agreed,
          f"stretch profile: no two of {len(counts)} sessions agree ({counts} device operations)")
    ops, span = next(sn for sn in sessions if len(sn[0]) == max(counts))
    groups = {"fft": ("fft",), "cumsum": ("scan",), "k15_polyphase_fir": ("resample_kernel",),
              "k16_overlap_add": ("stretch_ola_kernel",), "k17_phase_lock": ("phase_lock_kernel",),
              "copies": ("memcpy", "memset")}
    split = {k: 0.0 for k in (*groups, "glue")}
    for e in ops:
        name = e.name.lower()
        key = next((k for k, pats in groups.items() if any(p in name for p in pats)), "glue")
        split[key] += e.time_range.elapsed_us() / 1e3
    return dict(device_ops=len(ops), device_ms=sum(split.values()), span_ms=span,
                profile_sessions=counts, **{f"{k}_ms": v for k, v in split.items()})


def phase_stretch(x):
    """``pitch_shift_batch_device`` at full width: B mono lanes of
    STRETCH_SECONDS, time ratio STRETCH_RATIO, pitch STRETCH_PITCH, with
    ``formant_scale`` None and then 1.0 (the envelope path). Each: the
    counted run (launch counters reset just before: K15, K16 and K17 once
    each), a timed run (x realtime, peak device memory), the device time by
    operation, and four lanes held to the float64 host ``stretch_pitch``
    (40 dB; 25 dB with the formant warp, the JAX tests' bar for it)."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.ops import stretch as st

    wrappers = dsp_wrappers()
    picks = [0, B // 3, 2 * B // 3, B - 1]
    host_x = x[picks].cpu().numpy()
    res = {}
    for name, formant, bar in (("pitch", None, 40.0), ("formant", 1.0, 25.0)):
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        out = st.pitch_shift_batch_device(x, STRETCH_RATIO, STRETCH_PITCH, formant)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        check(all(launches[k] == 1 for k in ("polyphase_fir", "overlap_add", "phase_lock")),
              f"stretch {name}: launches {launches}")
        target = int(round(x.shape[1] * STRETCH_RATIO))
        check(tuple(out.shape) == (B, target) and bool(torch.isfinite(out).all()),
              f"stretch {name}: {tuple(out.shape)}")
        got = out[picks].cpu().numpy()
        del out
        snrs = []
        for j in range(len(picks)):
            ref = st.stretch_pitch(host_x[j:j + 1], STRETCH_RATIO, STRETCH_PITCH, formant)[0]
            snrs.append(float(10 * np.log10(np.mean(ref ** 2) /
                                            max(np.mean((ref - got[j]) ** 2), 1e-30))))
        check(min(snrs) >= bar, f"stretch {name}: {snrs} dB against the host path (bar {bar})")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = st.pitch_shift_batch_device(x, STRETCH_RATIO, STRETCH_PITCH, formant)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del out
        prof = stretch_profile(x, formant)
        audio_s = B * x.shape[1] / STRETCH_RATE
        res[name] = dict(lanes=B, seconds_per_lane=x.shape[1] / STRETCH_RATE,
                         time_ratio=STRETCH_RATIO, pitch_scale=STRETCH_PITCH,
                         formant_scale=formant, audio_s=audio_s, wall_s=wall,
                         xrealtime=audio_s / wall, peak_bytes=peak, snr_db_vs_host=snrs,
                         launches=launches, **prof)
        log(f"[stretch] {name}: {json.dumps(res[name])}")
    return res


class FleetStreams:
    """The streams of the fleet phase: per group, B first-wave streams
    and, for every fourth lane, a second-wave stream that takes the lane
    the first one left. ``data[sid]`` is a stream's bytes, ``kind[sid]``
    its explicit kind (None: detected), ``audio[sid]`` its seconds."""

    def __init__(self, lanes: int):
        from soundkit_tpu_torch.codecs.mp3_native import NativeMp3Parser
        from soundkit_tpu_torch.tools import aac_fixtures as af
        from soundkit_tpu_torch.tools import flac_fixtures as ff
        from soundkit_tpu_torch.tools import mp3_fixtures as mf
        from soundkit_tpu_torch.tools import opus_fixtures as of
        from soundkit_tpu_torch.tools import telephony_fixtures as tf
        from soundkit_tpu_torch.tools import vorbis_fixtures as vf

        self.lanes = lanes
        n2 = lanes // 4
        aac = af.lane_streams(af.load_clips(), lanes + n2, FLEET_AAC_FRAMES)
        clips = ff.load_clips()
        flac = ff.lane_streams(clips, lanes + n2, FLEET_FLAC_FRAMES)
        flac_s = ff.lane_seconds(clips, lanes + n2, FLEET_FLAC_FRAMES)
        tel = [s[:FLEET_TEL_BYTES] for s in tf.lane_streams(FLEET_TEL_KIND, lanes + n2)]
        tel_rate = tf.sample_rate(FLEET_TEL_KIND) / tf.samples_per_byte(FLEET_TEL_KIND)
        mclips = mf.load_clips()
        mp3 = mf.lane_streams(mclips, lanes + n2, FLEET_MP3_FRAMES)
        # a lane's audio: the granules its parser gives, at the lane's rate
        mp3_s = [NativeMp3Parser().push(s) * 576 / r
                 for s, r in zip(mp3, mf.lane_rates(mclips, lanes + n2))]
        # CELT clips and the voice clips (SILK NB / MB / WB / WB stereo, hybrid SWB / FB)
        oclips = of.load_clips() + of.load_clips(names=of.VOICE_CLIPS)
        self.data, self.kind, self.audio, self.group = {}, {}, {}, {}
        self.flac_bits = {f"flac-{j}": ff.lane_frames(clips, j)[0].bits for j in range(lanes + n2)}
        # an Ogg Opus stream as its pieces: the header pages, then a page a packet
        self.opus_pages = {}
        for j in range(lanes + n2):
            clip, idx = of.lane_packets(oclips, j, FLEET_OPUS_PACKETS)
            self.opus_pages[f"opus-{j}"] = [clip.header] + [clip.pages[t] for t in idx]
        # a lane's audio: its packets' samples less the pre-skip (a hybrid lane keeps it, as the
        # reference's does) and the SILK resampler's lead (NB 23)
        opus_s = []
        for j in range(lanes + n2):
            clip, idx = of.lane_packets(oclips, j, FLEET_OPUS_PACKETS)
            cut = {"silk_nb": clip.pre_skip + 23, "hybrid_swb": 0, "hybrid_fb": 0}.get(
                clip.name, clip.pre_skip)
            opus_s.append(max(len(idx) * 960 - cut, 0) / RATE)
        vclips = vf.load_clips(names=vf.STEREO)
        vorbis = vf.lane_streams(vclips, lanes + n2, FLEET_VORBIS_PAGES)
        vorbis_s = vf.lane_samples(vclips, lanes + n2, FLEET_VORBIS_PAGES) / VORBIS_RATE
        for j in range(lanes + n2):
            for g, data, kind, secs in (("aac", aac[j], None, FLEET_AAC_FRAMES * 1024 / RATE),
                                        ("mp3", mp3[j], None, mp3_s[j]),
                                        ("flac", flac[j], None, flac_s[j]),
                                        ("opus", b"".join(self.opus_pages[f"opus-{j}"]), None,
                                         opus_s[j]),
                                        ("vorbis", vorbis[j], None, float(vorbis_s[j])),
                                        (FLEET_TEL_KIND, tel[j], FLEET_TEL_KIND, len(tel[j]) / tel_rate)):
                sid = f"{g}-{j}"
                self.data[sid], self.kind[sid], self.audio[sid], self.group[sid] = data, kind, secs, g

    def wave(self, group: str, second: bool):
        lo, hi = (self.lanes, self.lanes + self.lanes // 4) if second else (0, self.lanes)
        return [f"{group}-{j}" for j in range(lo, hi)]

    def ends_early(self, sid: str) -> bool:
        """First-wave streams of every fourth lane end after round 1,
        all their bytes pushed by then."""
        j = int(sid.rsplit("-", 1)[1])
        return j < self.lanes and j % 4 == 1


def fleet_schedule(fs: "FleetStreams", sid: str, k: int):
    """[(round, share of the stream pushed by the end of that round)]:
    a first-wave stream arrives over all four rounds, one that ends
    early over rounds 0-1, a second-wave stream over rounds 2-3; every
    fifth (stream, round) is a slow producer with half its share, unless
    the round is the stream's last. The stream ends after its last push.
    The first share carries a detected stream past ``MIN_DETECT`` bytes,
    a slow first push does not."""
    j = int(sid.rsplit("-", 1)[1])
    if j >= fs.lanes:
        plan = [(2, 0.6), (3, 1.0)]
    elif fs.ends_early(sid):
        plan = [(0, 0.6), (1, 1.0)]
    else:
        plan = [(0, 0.55), (1, 0.7), (2, 0.85), (3, 1.0)]
    return [(r, share * (0.5 if (k + r) % 5 == 0 and share < 1.0 else 1.0)) for r, share in plan]


def drive_fleet(fleet, fs: "FleetStreams", sids, collect, hook=None):
    """Push ``sids`` by :func:`fleet_schedule` over FLEET_ROUNDS rounds,
    ``collect`` after each and once more at the end; ``hook(r, when)``
    pushes more streams just before ("before") and after ("after") the
    pushes of round r, inside the push time. Returns (push seconds,
    collect seconds, synchronized)."""
    import torch

    plans = {sid: dict(fleet_schedule(fs, sid, k)) for k, sid in enumerate(sids)}
    pos = dict.fromkeys(sids, 0)
    push_s = collect_s = 0.0
    for r in range(FLEET_ROUNDS + 1):
        t0 = time.perf_counter()
        if hook is not None:
            hook(r, "before")
        for sid in sids:
            share = plans[sid].get(r)
            if share is None:
                continue
            data = fs.data[sid]
            end = len(data) if share == 1.0 else max(int(len(data) * share), pos[sid])
            fleet.push(sid, data[pos[sid]: end], kind=fs.kind[sid] if pos[sid] == 0 else None)
            pos[sid] = end
            if share == 1.0:
                fleet.end_stream(sid)
        if hook is not None:
            hook(r, "after")
        t1 = time.perf_counter()
        collect()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        push_s += t1 - t0
        collect_s += t2 - t1
    check(all(pos[sid] == len(fs.data[sid]) for sid in sids), "fleet: a stream was not pushed whole")
    return push_s, collect_s


def bare_outputs(fs: "FleetStreams", seats, group: str, rounds=None, wire: str = "f32"):
    """The streams of ``seats`` ({lane: sid}; AAC's PNS signs depend on
    the lane) through the group's bare model of B lanes on the card:
    {sid: PCM [C, samples]} as the model returns it (f32 for AAC, MP3 and
    Opus, int32 for FLAC, int16 for telephony), and the seconds it took
    (building the model, the pushes, one decode of every round,
    synchronized). ``wire`` is the Opus model's spectral wire.

    ``rounds`` (AAC, Opus and Vorbis) replays a fleet's lockstep rounds:
    per collect (batches decoded, {sid: frames the stream had ready}). The
    AAC step takes an idle lane's previous window shape for 0, as the JAX
    package's does, so a lane that idles in mid-stream windows its next
    frame otherwise than one fed without a gap; the fleet is held to the
    bare model under the same gaps. The Opus model replays the same
    rounds of Ogg pages; the Vorbis model takes each stream whole and
    hands its lanes' parsed packets to the rounds as the fleet's lanes had
    them ready."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
    from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder
    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.models.opus_fleet_model import BatchedOggOpusDecoder
    from soundkit_tpu_torch.models.telephony_batch import TelephonyLaneGroup
    from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder

    t0 = time.perf_counter()
    if group == "aac":
        model = BatchedAacLcDecoder(B, C, device="cuda")
    elif group == "mp3":
        model = BatchedMp3Decoder(B, C, device="cuda")
    elif group == "flac":
        model = BatchedFlacDecoder(B, FLAC_STRIDE, device="cuda")
    elif group == "opus":
        model = BatchedOggOpusDecoder(B, C, celt_wire=wire, device="cuda")
    elif group == "vorbis":
        model = BatchedVorbisDecoder(B, device="cuda")
    else:
        model = TelephonyLaneGroup(group, B, TEL_CHUNK, device="cuda")
    if rounds is not None and group == "opus":
        pages = {sid: list(fs.opus_pages[sid]) for sid in seats.values()}
        parts = {sid: [] for sid in seats.values()}
        for n, ready in rounds:
            for lane, sid in seats.items():
                k = ready.get(sid, 0)
                if k:
                    first = len(pages[sid]) == len(fs.opus_pages[sid])
                    model.push(lane, b"".join(pages[sid][: k + first]))
                    del pages[sid][: k + first]
            pcm, lens = model.decode_batches(n, device_out=True)
            arr = pcm.cpu().numpy()
            for lane, sid in seats.items():
                parts[sid] += [arr[r, lane, :, 960 - lens[r, lane]:]
                               for r in range(ready.get(sid, 0)) if lens[r, lane]]
        check(all(len(p) == 0 for p in pages.values()), "fleet: an Opus stream's pages were not "
              "all collected")
        return {sid: np.concatenate(p, axis=1) for sid, p in parts.items()}, time.perf_counter() - t0
    if rounds is not None and group == "vorbis":
        pending = {}
        for lane, sid in seats.items():
            model.push(lane, fs.data[sid])
            pending[lane], model._lanes[lane].queue = model._lanes[lane].queue, []
        parts = {sid: [] for sid in seats.values()}
        for n, ready in rounds:
            for lane, sid in seats.items():
                k = ready.get(sid, 0)
                model._lanes[lane].queue, pending[lane] = pending[lane][:k], pending[lane][k:]
            out = model.decode_batches(n)
            for lane, sid in seats.items():
                if out[lane].shape[-1]:
                    parts[sid].append(out[lane])
        check(not any(pending.values()), "fleet: a Vorbis stream's packets were not all collected")
        return ({sid: np.concatenate(p, axis=1) for sid, p in parts.items()},
                time.perf_counter() - t0)
    if rounds is not None:
        from soundkit_tpu_torch.tools import aac_fixtures as af

        frames = {sid: af.split_adts(fs.data[sid]) for sid in seats.values()}
        parts = {sid: [] for sid in seats.values()}
        for n, ready in rounds:
            for lane, sid in seats.items():
                k = ready.get(sid, 0)
                model.push(lane, b"".join(frames[sid][:k]))
                del frames[sid][:k]
            arr = model.decode_batches(n)
            for lane, sid in seats.items():
                k = ready.get(sid, 0)
                parts[sid].append(np.transpose(arr[:k, lane], (1, 0, 2)).reshape(C, -1))
        check(not any(frames.values()), "fleet: an AAC stream's frames were not all collected")
        return {sid: np.concatenate(p, axis=1) for sid, p in parts.items()}, time.perf_counter() - t0
    for lane, sid in seats.items():
        model.push(lane, fs.data[sid])
    ready = {lane: model.lane_ready(lane) for lane in seats}
    got = model.decode_batches(max(ready.values()), device_out=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {}
    if group in ("aac", "mp3"):
        arr = got.cpu().numpy()
        for i, sid in seats.items():
            out[sid] = np.transpose(arr[: ready[i], i], (1, 0, 2)).reshape(C, -1)
    elif group == "opus":
        arr, lens = got[0].cpu().numpy(), got[1]
        for i, sid in seats.items():
            out[sid] = np.concatenate([arr[r, i, :, 960 - lens[r, i]:] for r in range(ready[i])],
                                      axis=1)
    elif group == "vorbis":
        arr, lens = torch.stack(got[0]).cpu().numpy(), got[1]
        for i, sid in seats.items():
            out[sid] = np.concatenate([arr[r, i, :, : lens[r, i]] for r in range(ready[i])], axis=1)
    elif group == "flac":
        arr, metas = got[0].cpu().numpy(), got[1]
        for i, sid in seats.items():
            parts = [arr[f, i, : max(int(metas[f][i][1]), 1), : metas[f][i][0]] for f in range(ready[i])]
            out[sid] = np.concatenate(parts, axis=1)
    else:
        arr, lens = got[0].cpu().numpy(), got[1]
        for i, sid in seats.items():
            out[sid] = np.concatenate([arr[r, i, :, : int(lens[r][i])] for r in range(ready[i])], axis=1)
    return out, seconds


def fleet_host_streams(fs: "FleetStreams") -> dict:
    """The [fleet] streams without a lane, {sid: dict(data, kind, pushes,
    expect)}: ``pushes`` [(round, "before" / "after", start, end, ends)],
    ``expect`` "host" (decoded on the host fallback), "refused" (the port
    cannot decode it) or "lane" (a filler seated in a telephony group).

    - FLEET_OVERFLOW streams beyond capacity for each of the six groups,
      the bytes of first-wave streams, pushed whole in the last round,
      when every group's 1024 lanes are taken (the detected ones routed by
      detection, G.722 by its kind);
    - 1024 short G.711 mu-law and G.726-32 fillers and FLEET_OVERFLOW more
      of each (the fallback's K3 and K6), in the last round;
    - 4 WAV and 4 raw-Opus (``opus_raw``) streams;
    - the Ogg Opus streams the group reroutes (``opus_fixtures.reroute_case``):
      each pushed whole with kind "opus" after round 0's pushes, so its
      lane is taken and freed within the push; the hybrid one that starts
      on transition redundancy pushed but its last page then, its lane
      frozen by round 0's collect and freed by the rest of it before
      round 1's pushes; the two heads neither package opens (family 1
      without its channel mapping table, family 0 with three channels)
      refused;
    - a 5.1 and a family-255 multistream Ogg Opus stream
      (``opus_ms_fixtures``: ``surround51``, ``voip255``), each whole
      with kind "opus" after round 0's pushes: its lane taken at the push
      and freed at its head, the stream decoded by the host fallback's
      owned multistream decoder;
    - a 22.05 kHz mono Ogg Vorbis stream with kind "vorbis" after round 0's
      pushes (the group's topology is 44.1 kHz stereo by then);
    - one stream of each owned host codec (FLEET_CODEC_STREAMS) after round
      0's pushes: GSM, G.729 and AMR-NB by their kinds, AIFF-C µ-law (K3 at
      its end), ALAC in MP4, AC-3 and Ogg Speex WB detected;
    - one detected stream of each container (FLEET_CONTAINER_STREAMS) after
      round 0's pushes: M4A AAC (decoded at its end), WebM Opus CELT and
      WebM Vorbis;
    - a 5.1 ADTS and a 5.1 M4A AAC-LC stream (FLEET_AAC_MC_STREAMS), each
      detected after round 0's pushes, decoded by the host fallback's
      owned AAC-LC decoder."""
    import numpy as np

    from soundkit_tpu_torch.core.audio_types import PcmData
    from soundkit_tpu_torch.core.wav import generate_wav_buffer
    from soundkit_tpu_torch.tools import aac_mc_fixtures as amf
    from soundkit_tpu_torch.tools import container_fixtures as cf
    from soundkit_tpu_torch.tools import host_codec_fixtures as hcf
    from soundkit_tpu_torch.tools import opus_fixtures as of
    from soundkit_tpu_torch.tools import opus_ms_fixtures as msf
    from soundkit_tpu_torch.tools import telephony_fixtures as tf
    from soundkit_tpu_torch.tools import vorbis_fixtures as vf

    hs = {}

    def add(sid, data, kind, at, expect, cut=None):
        r, when = at
        pushes = [(r, when, 0, len(data), True)] if cut is None else \
            [(r, when, 0, cut, False), (r + 1, "before", cut, len(data), True)]
        hs[sid] = dict(data=data, kind=kind, pushes=pushes, expect=expect)

    for sid, data in zip((f"wav-host-{i}" for i in range(4)), (
            generate_wav_buffer(PcmData.i16(list(np.stack([x, x[::-1]]))), 16000)
            for x in np.split(np.resize(np.concatenate(tf.pcm_clips(16000)),
                                        int(4 * FLEET_HOST_WAV_SECONDS * 16000)), 4))):
        add(sid, data, None, (0, "after"), "host")
    oclips = of.load_clips()
    for i, data in enumerate(of.lane_raw(oclips, 4, FLEET_OPUS_PACKETS)):
        add(f"opus_raw-host-{i}", data, "opus_raw", (0, "after"), "host")
    for case in of.REROUTE_CASES:
        head, packets, _ = of.reroute_case(case)
        data = of.ogg_stream(head, packets)
        cut = len(data) - len(packets[-1]) - 28 if case == "hybrid_redundancy_start" else None
        add(f"reroute-{case}", data, "opus", (0, "after"),
            "refused" if case in ("mapping_family_1", "three_channels") else "host", cut)
    for name in FLEET_MULTISTREAM:
        add(f"reroute-multistream-{name}", msf.clip_bytes(name), "opus", (0, "after"), "host")
    add("vorbis-topology", vf.load_clips(names=("mono22",))[0].stream(), "vorbis", (0, "after"),
        "host")
    for sid, (clip, kind, seconds) in FLEET_CODEC_STREAMS.items():
        add(sid, hcf.long_stream(clip, seconds)[0], kind, (0, "after"), "host")
    for sid, (case, seconds) in FLEET_CONTAINER_STREAMS.items():
        add(sid, cf.long_stream(case, seconds)[0], None, (0, "after"), "host")
    for sid, (case, seconds) in FLEET_AAC_MC_STREAMS.items():
        add(sid, amf.long_stream(case, seconds)[0], None, (0, "after"), "host")
    for kind in FLEET_FILLERS:
        streams = [s[:FLEET_FILLER_BYTES] for s in tf.lane_streams(kind, B + FLEET_OVERFLOW)]
        for j, data in enumerate(streams):
            add(f"{kind}-{'fill' if j < B else 'host'}-{j}", data, kind, (FLEET_ROUNDS - 1, "after"),
                "lane" if j < B else "host")
    for g in ("aac", "mp3", "flac", "opus", "vorbis", FLEET_TEL_KIND):
        for i in range(FLEET_OVERFLOW):
            src = f"{g}-{i}"
            add(f"{g}-host-{i}", fs.data[src], fs.kind[src], (FLEET_ROUNDS - 1, "after"), "host")
    return hs


def phase_fleet():
    import numpy as np
    import torch

    from soundkit_tpu_torch.codecs.opus import OggOpusDecoder
    from soundkit_tpu_torch.core.audio_pipeline import audio_to_f32_channels
    from soundkit_tpu_torch.core.audio_types import AudioData
    from soundkit_tpu_torch.models import fleet as fleet_mod
    from soundkit_tpu_torch.models.fleet import FleetUnsupported, StreamFleet
    from soundkit_tpu_torch.ops import aac_batch as ab
    from soundkit_tpu_torch.ops import aac_entropy as ae
    from soundkit_tpu_torch.ops import adpcm, companding, g722, imdct

    fs = FleetStreams(B)
    hs = fleet_host_streams(fs)
    groups = ("aac", "mp3", "flac", "opus", "vorbis", FLEET_TEL_KIND)
    first = [sid for g in groups for sid in fs.wave(g, False)]
    second = [sid for g in groups for sid in fs.wave(g, True)]
    wrappers = {"spectral_decode": ae.spectral_decode, "tns_filter": ab.tns_filter,
                "imdct_window": imdct.imdct_window, "g722_scan": g722.g722_decode_scan,
                "g711_decode": companding.g711_decode, "g726_scan": adpcm.g726_decode_scan,
                **flac_wrappers(), **mp3_wrappers(), **voice_wrappers(), **vorbis_wrappers()}
    # the kernels the host fallback launches (K3, K6, K7 and K10 at B = 1)
    fallback_names = ("g711_decode", "g726_scan", "g722_scan", "mp3_synth")
    fallback_launches = dict.fromkeys(fallback_names, 0)
    refused = {}
    host_push_s = {}  # push and end_stream seconds by kind of stream ("aac-host", "reroute", ...)

    def host_hook(r, when):
        """Push the streams of ``hs`` due at (r, when); the launches made
        inside these pushes are the host fallback's (a lane launches
        nothing at a push)."""
        for sid, h in hs.items():
            for rr, ww, lo, hi, ends in h["pushes"]:
                if (rr, ww) != (r, when):
                    continue
                before = {n: wrappers[n].launches for n in fallback_names}
                t0 = time.perf_counter()
                try:
                    fleet.push(sid, h["data"][lo:hi], kind=h["kind"] if lo == 0 else None)
                    if ends:
                        fleet.end_stream(sid)
                except FleetUnsupported as e:
                    refused[sid] = str(e)
                what = sid.rsplit("-", 1)[0]
                host_push_s[what] = host_push_s.get(what, 0.0) + time.perf_counter() - t0
                for n in fallback_names:
                    fallback_launches[n] += wrappers[n].launches - before[n]
                if ends and sid not in refused:
                    where = "lane" if sid in fleet._lanes else \
                        "host" if sid in fleet._fallback or sid in got else "gone"
                    check(where == h["expect"], f"fleet: {sid} went to {where}, not {h['expect']}")

    # mixed: the six groups in one fleet, lanes recycled, every stream checked, and the
    # streams without a lane on the host fallback beside them
    fleet = StreamFleet(capacity_per_group=B, device="cuda")
    got, lane_of, rate_of = {}, {}, {}
    collect_call_s = [0.0]  # seconds in StreamFleet.collect alone
    # per collect with AAC, Opus or Vorbis output: (batches decoded, {sid: frames ready})
    replays = {"aac": [], "opus": [], "vorbis": []}

    def collect_and_fetch():
        # a Vorbis lane's output is host PCM with no lane or frame count: its lane and
        # its packets ready, before the collect
        vorbis = {}
        for sid, ln in fleet._lanes.items():
            if ln.group == "vorbis":
                vorbis[sid] = fleet._groups["vorbis"].lane_ready(ln.index)
                check(lane_of.setdefault(sid, ln.index) == ln.index, f"{sid}: changed lanes")
        if vorbis and max(vorbis.values()):
            replays["vorbis"].append((max(vorbis.values()), vorbis))
        t0 = time.perf_counter()
        recs = fleet.collect(device_out=True)
        torch.cuda.synchronize()
        collect_call_s[0] += time.perf_counter() - t0
        for kind, kind_rounds in replays.items():
            if kind == "vorbis":
                continue
            ready = {sid: rec.frames for sid, rec in recs.items() if rec.kind == kind}
            if ready:
                kind_rounds.append((int(next(recs[sid] for sid in ready).device.shape[0]), ready))
        for sid, rec in recs.items():
            check(rec.rate == fleet.sample_rate(sid) and rec.rate is not None, f"{sid}: rate {rec.rate}")
            check(rate_of.setdefault(sid, rec.rate) == rec.rate, f"{sid}: changed rates")
            pcm = rec.fetch()
            check(pcm.shape[-1] == rec.samples, f"{sid}: {pcm.shape} for {rec.samples} samples")
            check((rec.kind == "host") == (sid in hs and hs[sid]["expect"] == "host"),
                  f"{sid}: a {rec.kind} output")
            if rec.kind not in ("vorbis", "host"):
                check(lane_of.setdefault(sid, rec.lane) == rec.lane, f"{sid}: changed lanes")
            got.setdefault(sid, []).append(pcm)

    for w in wrappers.values():
        w.launches = 0
    push_s, collect_s = drive_fleet(fleet, fs, first + second, collect_and_fetch, host_hook)
    launches = {n: w.launches for n, w in wrappers.items()}
    for n, c in launches.items():
        check(c > 0, f"{n} was not launched by the fleet")
    for n, c in fallback_launches.items():
        check(c > 0, f"fleet: the host fallback launched no {n}")
    check(not fleet._lanes and not fleet._detect and not fleet._ended and not fleet._fallback
          and not fleet._pending_out, "fleet: streams left over after every stream ended and drained")
    for g in groups:
        used = fleet._groups[g]._used
        check(len(used) == B, f"fleet: group {g} used {len(used)} lanes for {B + B // 4} streams")
    check(sorted(refused) == sorted(sid for sid, h in hs.items() if h["expect"] == "refused")
          and all("libavcodec cannot open it either" in m for m in refused.values()),
          f"fleet: refused {refused}")
    # each host stream against its lone decode on the card: the same pipeline fed the
    # same bytes; a rerouted Ogg Opus stream (its lane emitted nothing) against the
    # whole stream through the host decoder, whose float output it replays
    host_audio_s = 0.0
    for sid, h in hs.items():
        if h["expect"] != "host":
            continue
        check(sid in got, f"fleet returned nothing for {sid}")
        pcm = np.concatenate(got[sid], axis=1)
        if sid.startswith("reroute-"):
            d = OggOpusDecoder()
            want = d.decode_f32(h["data"]).reshape(-1, d.channels).T
        else:
            lone = fleet_mod._host_decoder("cuda") if h["kind"] in (None, "vorbis") else \
                fleet_mod._explicit_host_decoder(h["kind"], "cuda")
            outs = lone.process(h["data"]) + lone.process(b"")
            want = np.concatenate([np.stack(audio_to_f32_channels(o)) for o in outs
                                   if isinstance(o, AudioData)], axis=1)
        check(pcm.shape == want.shape and np.array_equal(pcm, want) and np.any(want),
              f"{sid}: the fleet's host PCM {pcm.shape} differs from its lone decode {want.shape}")
        if sid in FLEET_AAC_MC_STREAMS:
            cpu_dec = fleet_mod._host_decoder("cpu")
            outs = cpu_dec.process(h["data"]) + cpu_dec.process(b"")
            cpu = np.concatenate([np.stack(audio_to_f32_channels(o)) for o in outs
                                  if isinstance(o, AudioData)], axis=1)
            check(pcm.shape[0] == 6 and np.array_equal(pcm, cpu),
                  f"{sid}: the fleet's host PCM {pcm.shape} differs from the CPU decode")
        host_audio_s += pcm.shape[1] / rate_of[sid]
    filler_audio_s = sum(np.concatenate(got[sid], axis=1).shape[1] / rate_of[sid]
                         for sid, h in hs.items() if h["expect"] == "lane")

    worst_snr = {"aac": float("inf"), "opus": float("inf"), "vorbis": float("inf")}
    vorbis_identical = 0
    for g in groups:
        # a lane serves several streams in turn (the early enders' lanes go to late
        # arrivals): each bare model seats at most one stream a lane, in its fleet lane
        seatings = []
        for sid in fs.wave(g, False) + fs.wave(g, True):
            check(sid in got, f"fleet returned nothing for {sid}")
            seats = next((s for s in seatings if lane_of[sid] not in s), None)
            if seats is None:
                seatings.append(seats := {})
            seats[lane_of[sid]] = sid
        check(len(seatings) >= 2, f"fleet: no {g} lane was reused")
        for seats in seatings:
            want, _ = bare_outputs(fs, seats, g, replays.get(g))
            for sid in seats.values():
                pcm = np.concatenate(got[sid], axis=1)
                ref = want[sid]
                check(pcm.shape == ref.shape, f"{sid}: fleet {pcm.shape}, bare model {ref.shape}")
                if g in ("aac", "opus", "vorbis"):
                    err = float(((pcm.astype(np.float64) - ref) ** 2).sum())
                    sig = float((ref.astype(np.float64) ** 2).sum())
                    check(sig > 0, f"{sid}: silent")
                    snr = 10 * np.log10(sig / max(err, 1e-300))
                    worst_snr[g] = min(worst_snr[g], float(snr))
                    vorbis_identical += int(g == "vorbis" and err == 0)
                elif g == "mp3":
                    # an idle MP3 lane keeps its state as it was (no window shape to
                    # lose), so a stream fed in rounds decodes as one fed whole
                    check(np.array_equal(pcm, ref), f"{sid}: fleet MP3 PCM differs from the "
                          f"bare model's")
                    check(np.any(ref), f"{sid}: silent")
                else:
                    check(np.array_equal(pcm, ref.astype(np.float32) / 32768.0),
                          f"{sid}: fleet PCM differs from the bare model's")
                    check(np.any(ref), f"{sid}: silent")
    for g, snr in worst_snr.items():
        check(snr >= (120.0 if g == "vorbis" else 100.0),
              f"fleet: {g} stream at {snr:.2f} dB against the bare model")
    audio = sum(fs.audio.values()) + host_audio_s + filler_audio_s

    # the same waves again without the host streams and the fillers: each collect
    # fetched as the checked run fetches it, without the checks
    bare_fleet = StreamFleet(capacity_per_group=B, device="cuda")
    bare_call_s = [0.0]

    def collect_fetch_only():
        t0 = time.perf_counter()
        recs = bare_fleet.collect(device_out=True)
        torch.cuda.synchronize()
        bare_call_s[0] += time.perf_counter() - t0
        for rec in recs.values():
            rec.fetch()

    p0, c0 = drive_fleet(bare_fleet, fs, first + second, collect_fetch_only)
    without = dict(audio_s=sum(fs.audio.values()), push_s=p0, collect_and_fetch_s=c0,
                   collect_call_s=bare_call_s[0], xrealtime=sum(fs.audio.values()) / (p0 + c0))
    n_host = sum(h["expect"] == "host" for h in hs.values())
    mixed = dict(streams=len(first) + len(second), rounds=FLEET_ROUNDS, audio_s=audio,
                 push_s=push_s, collect_and_fetch_s=collect_s, collect_call_s=collect_call_s[0],
                 xrealtime=audio / (push_s + collect_s), min_aac_snr_db=worst_snr["aac"],
                 min_opus_snr_db=worst_snr["opus"], min_vorbis_snr_db=worst_snr["vorbis"],
                 vorbis_identical_streams=int(vorbis_identical), launches=launches,
                 host_streams=n_host, host_audio_s=host_audio_s,
                 fillers=sum(h["expect"] == "lane" for h in hs.values()),
                 filler_audio_s=filler_audio_s, refused=sorted(refused),
                 fallback_launches=fallback_launches, host_push_s=host_push_s,
                 lane_launches={n: c - fallback_launches.get(n, 0) for n, c in launches.items()},
                 without_host_streams=without)
    log(f"[fleet] mixed: {json.dumps(mixed)}")

    # out_bits=16: one collect, against the bare outputs quantized on the host
    f16 = StreamFleet(capacity_per_group=B, out_bits=16, device="cuda")
    sids16 = [sid for g in ("aac", "mp3", "flac", "opus", "vorbis") for sid in fs.wave(g, False)]
    for sid in sids16:
        f16.push(sid, fs.data[sid], kind=fs.kind[sid])
        f16.end_stream(sid)
    out16 = f16.collect(device_out=True)
    for g in ("aac", "mp3", "flac", "opus", "vorbis"):
        # a Vorbis record has no lane (host PCM): its bare model seats the streams in order
        seats = dict(enumerate(fs.wave(g, False))) if g == "vorbis" else \
            {out16[sid].lane: sid for sid in fs.wave(g, False)}
        want, _ = bare_outputs(fs, seats, g, wire="i16")
        for sid in fs.wave(g, False):
            pcm, ref = out16[sid].fetch(), want[sid]
            check(pcm.dtype == np.int16 and pcm.shape == ref.shape, f"{sid}: {pcm.dtype} {pcm.shape}")
            if g in ("aac", "mp3", "opus", "vorbis"):
                q = np.clip(np.round(ref * np.float32(32767.0)), -32768, 32767)
                check(np.abs(pcm - q).max() <= 1, f"{sid}: int16 PCM off by more than 1")
            else:
                shift = fs.flac_bits[sid] - 16
                check(np.array_equal(pcm, np.clip(ref >> shift, -32768, 32767)),
                      f"{sid}: int16 FLAC differs")
    log(f"[fleet] out_bits=16: {len(sids16)} streams, AAC, MP3, Opus (the i16 spectral wire) "
        f"and Vorbis within 1 LSB, FLAC exact (24-bit lanes >> 8)")

    # per group: a fleet serving that group alone, beside the bare model on the same bytes
    by_group = {}
    for g in groups:
        sids, sids2 = fs.wave(g, False), fs.wave(g, True)
        solo = StreamFleet(capacity_per_group=B, device="cuda")
        n_out = [0]

        def collect_only():
            n_out[0] += len(solo.collect(device_out=True))

        p_s, c_s = drive_fleet(solo, fs, sids + sids2, collect_only)
        g_audio = sum(fs.audio[sid] for sid in (*sids, *sids2))
        _, bare_s = bare_outputs(fs, dict(enumerate(sids)), g)
        _, bare2_s = bare_outputs(fs, dict(enumerate(sids2)), g)
        by_group[g] = dict(streams=len(sids) + len(sids2), audio_s=g_audio, push_s=p_s, collect_s=c_s,
                           fleet_xrealtime=g_audio / (p_s + c_s),
                           bare_s=bare_s + bare2_s, bare_xrealtime=g_audio / (bare_s + bare2_s),
                           outputs=n_out[0])
        log(f"[fleet] {g} alone: {json.dumps(by_group[g])}")
    return dict(mixed=mixed, by_group=by_group)


# ---------------------------------------------------------------------------
# the streaming decode pipeline: one stream at a time through DecodePipeline
# ---------------------------------------------------------------------------

PIPE_SECONDS = 60.0       # audio a [pipeline] stream carries, at least
PIPE_CHUNK = 4096         # bytes a send
PIPE_COMPARE_SECONDS = 5.0  # the prefix each stream also decodes on the CPU
# G.722 / G.726 prefix on the CPU, whose plain scans step a code at a time;
# the card holds K6 and K7 at whole sends against segmented plain scans
PIPE_SCAN_COMPARE_CODES = 1000
PIPE_TIMED_SECONDS = 15.0  # the prefix the per-chunk timing hook runs on
PIPE_CONCURRENT = ("mp3", "flac16", "flac24", "g722", "g726_16", "g726_32", "g711_mulaw", "wav")
# the host-decoded Opus and Vorbis streams: ~PIPE_HOST_SECONDS each, the timing hook and the
# CPU compare on their first PIPE_HOST_TIMED_SECONDS (the host code is the same on both)
PIPE_HOST_SECONDS = 10.0
PIPE_HOST_TIMED_SECONDS = 2.5
# the end of a host stream's CPU prefix left out of its compare: the frame the cut splits decodes
# with zero bits past the cut (as a truncated stream's last frame does: MPEG audio Layer I / II)
PIPE_PREFIX_GUARD_SECONDS = 0.25
PIPE_HOST_FORMATS = ("ogg_opus_stereo", "ogg_opus_mono", "ogg_opus_silk_wb", "ogg_opus_hybrid_fb",
                     "opus_raw", "ogg_vorbis", "ogg_opus_51", "adts_51")
# the 5.1 multistream Ogg Opus stream of [pipeline]: this opus_ms_fixtures clip's packets repeated
PIPE_MULTISTREAM_CLIP = "surround51"
# the owned host codecs' streams, {format: (host_codec_fixtures or mpa_fixtures clip, seconds at
# least)}, each the clip's frames, packets or sound data repeated; the timing hook on their first
# PIPE_CODEC_TIMED_SECONDS and the CPU compare whole (PIPE_CODEC_WHOLE_COMPARE and the
# EOF-buffered AIFF and ALAC) or on their first PIPE_HOST_TIMED_SECONDS. The MPEG audio Layer II
# / I streams go to spawn_mp3 (the owned host Layer I / II decoder), G.729 and AMR-NB to
# spawn_g729 / spawn_amr_nb (the owned decoders)
PIPE_CODEC_STREAMS = {
    "gsm": ("gsm_standard", 60.0), "gsm_wav49": ("gsm_wav49", 60.0),
    "aiff_16": ("aiff_16", 60.0), "aifc_ulaw": ("aifc_ulaw", 60.0),
    "aifc_alaw": ("aifc_alaw", 60.0), "alac_caf": ("alac_caf", 20.0),
    "alac_mp4": ("alac_mp4", 20.0), "ac3": ("ac3_stereo", 5.0),
    "speex_nb": ("speex_nb", 5.0), "speex_wb": ("speex_wb", 3.0), "speex_uwb": ("speex_uwb", 2.0),
    "mp2_stereo48": ("l2_48_stereo_192", 60.0), "mp2_lsf_mono": ("l2_lsf22_mono_64", 60.0),
    "mp1_stereo48": ("l1_48_stereo_384", 20.0),
    "g729": ("g729_speech", 60.0), "amr_nb": ("amrnb_switch", 60.0),
}
PIPE_CODEC_TIMED_SECONDS = 2.0
# the codec streams the CPU compare takes whole: the host decodes each in a few seconds or less
PIPE_CODEC_WHOLE_COMPARE = ("gsm", "gsm_wav49", "mp2_stereo48", "mp2_lsf_mono", "mp1_stereo48",
                            "g729", "amr_nb")
# the container streams, {format: (container_fixtures case, seconds at least)}, each the case's
# units repeated in its container; the timing hook and the CPU compare on their first
# PIPE_HOST_TIMED_SECONDS (the EOF-buffered M4A whole)
PIPE_CONTAINER_STREAMS = {
    "m4a_aac": ("m4a_aac", 30.0), "latm": ("latm_8", 30.0), "webm_vorbis": ("webm_vorbis", 10.0),
    "webm_opus_celt": ("webm_opus_celt", 10.0), "webm_opus_silk": ("webm_opus_silk", 20.0),
    "m4a_51": ("m4a_51", PIPE_HOST_SECONDS),
}
PIPE_EOF_FORMATS = ("aiff_16", "aifc_ulaw", "aifc_alaw", "alac_caf", "alac_mp4", "m4a_aac",
                    "m4a_51")
# the 5.1 AAC-LC streams of [pipeline] (aac_mc_fixtures): adts_51 is this clip's units repeated,
# m4a_51 the same units in an MP4; each held to the clip's reference_pcm.npz entries, and m4a_51
# to adts_51's CPU decode (the same units, so the same PCM)
PIPE_AAC_MC_CLIP = "cfg6"
PIPE_CPU_SHARED = {"m4a_51": "adts_51"}


def pipeline_wrappers():
    from soundkit_tpu_torch.ops import adpcm, companding, g722, mp3_synth

    return {"g711_decode": companding.g711_decode,
            "g726_decode_scan": adpcm.g726_decode_scan,
            "g726_encode_scan": adpcm.g726_encode_scan,
            "g722_decode_scan": g722.g722_decode_scan,
            "g722_encode_scan": g722.g722_encode_scan,
            "mp3_synth": mp3_synth.mp3_granule_packed}


def _tiled(x, n: int):
    import numpy as np

    return np.resize(x, n) if x.ndim == 1 else x[:, np.arange(n) % x.shape[1]]


def pipeline_streams() -> tuple:
    """({format: (stream bytes, spawn(device) -> handle, seconds of
    audio)}, {telephony format: the PCM its stream encodes}): every
    format of the pipeline at >= PIPE_SECONDS s. MP3 and AAC-ADTS are
    fixture frames concatenated; FLAC is the fixtures' PCM tiled and
    encoded by BatchedFlacEncoder on the card; the telephony streams are
    the telephony fixtures' PCM tiled and encoded by the streaming
    encoders on the card in PIPE_CHUNK-sample chunks
    (``kernel_check.telephony_stream``); WAV and raw PCM are the
    telephony PCM at 16 kHz, stereo."""
    import numpy as np

    from soundkit_tpu_torch.codecs.g711 import G711Law
    from soundkit_tpu_torch.codecs.g726 import G726Packing, G726Rate
    from soundkit_tpu_torch.core.audio_types import PcmData
    from soundkit_tpu_torch.core.raw_pcm import RawPcmFormat
    from soundkit_tpu_torch.core.wav import generate_wav_buffer
    from soundkit_tpu_torch.models.flac_encode_batch import BatchedFlacEncoder
    from soundkit_tpu_torch.pipeline.decode_pipeline import DecodePipeline as DP
    from soundkit_tpu_torch.tools import aac_fixtures as af
    from soundkit_tpu_torch.tools import flac_fixtures as ff
    from soundkit_tpu_torch.tools import kernel_check as kc
    from soundkit_tpu_torch.tools import mp3_fixtures as mf
    from soundkit_tpu_torch.tools import telephony_fixtures as tf

    assert kc.STREAM_SEND == PIPE_CHUNK
    out = {}
    mp3 = {c.name: c for c in mf.load_clips()}["stereo44"]
    reps = int(np.ceil(PIPE_SECONDS / (sum(mp3.granules) * 576 / mp3.rate)))
    out["mp3"] = (mp3.stream() * reps, DP.spawn, reps * sum(mp3.granules) * 576 / mp3.rate)
    aac = af.load_clips()[0]
    reps = int(np.ceil(PIPE_SECONDS / (len(aac) * 1024 / 48000)))
    out["aac"] = (b"".join(aac) * reps, DP.spawn, reps * len(aac) * 1024 / 48000)

    clips = {c.name: c for c in ff.load_clips()}
    for fmt, name in (("flac16", "stereo16"), ("flac24", "stereo24")):
        clip = clips[name]
        n = int(PIPE_SECONDS * clip.rate)
        pcm = _tiled(ff.clip_pcm(clip, "cuda"), n)
        enc = BatchedFlacEncoder(1, clip.rate, clip.channels, clip.bits, device="cuda")
        enc.push(0, pcm)
        enc.encode_pending()
        out[fmt] = (enc.finish_all()[0], DP.spawn, n / clip.rate)

    pcm8 = _tiled(np.concatenate(tf.pcm_clips(8000)), int(PIPE_SECONDS * 8000))
    pcm16 = _tiled(np.concatenate(tf.pcm_clips(16000)), int(PIPE_SECONDS * 16000))
    sources = {}
    for law, fmt in ((G711Law.MU_LAW, "g711_mulaw"), (G711Law.A_LAW, "g711_alaw")):
        out[fmt] = (kc.telephony_stream(fmt, pcm8, "cuda"),
                    lambda device, law=law: DP.spawn_g711(law, device=device), PIPE_SECONDS)
        sources[fmt] = pcm8
    out["g722"] = (kc.telephony_stream("g722", pcm16, "cuda"),
                   lambda device: DP.spawn_g722(device=device), PIPE_SECONDS)
    sources["g722"] = pcm16
    for kbit in (16, 24, 32, 40):
        rate = G726Rate.from_bitrate(kbit * 1000)
        out[f"g726_{kbit}"] = (
            kc.telephony_stream(f"g726_{kbit}", pcm8, "cuda"),
            lambda device, rate=rate: DP.spawn_g726_with_rate(rate, G726Packing.LEFT,
                                                              device=device),
            PIPE_SECONDS)
        sources[f"g726_{kbit}"] = pcm8
    stereo = np.stack([pcm16, pcm16[::-1]])
    out["wav"] = (generate_wav_buffer(PcmData.i16(list(stereo)), 16000), DP.spawn, PIPE_SECONDS)
    fmt16 = RawPcmFormat.linear16(16000, 2)
    out["raw_pcm"] = (np.ascontiguousarray(stereo.T).astype("<i2").tobytes(),
                      lambda device: DP.spawn_raw_pcm(fmt16, device=device), PIPE_SECONDS)
    out.update(pipeline_host_streams())
    out.update(pipeline_codec_streams())
    out.update(pipeline_container_streams())
    return out, sources


def pipeline_host_streams() -> dict:
    """The Opus and Vorbis streams of [pipeline], each a fixture clip's
    packets repeated to >= PIPE_HOST_SECONDS: Ogg Opus CELT stereo
    (``stereo96``) and mono (``mono64``), SILK WB (``silk_wb``) and hybrid
    FB (``hybrid_fb``), one page a packet; soundkit's raw Opus framing
    (``owned``); Ogg Vorbis (``stereo44``'s headers, then its audio
    packets repeated, a page each); 5.1 multistream Ogg Opus
    (``opus_ms_fixtures``' ``surround51``, four elementary streams on the
    owned multistream decoder); 5.1 ADTS AAC-LC (``aac_mc_fixtures``'
    ``cfg6``, the owned AAC-LC decoder). All detected by
    ``DecodePipeline.spawn``."""
    import numpy as np

    from soundkit_tpu_torch.demux.ogg import build_ogg_page
    from soundkit_tpu_torch.pipeline.decode_pipeline import DecodePipeline as DP
    from soundkit_tpu_torch.tools import opus_fixtures as of
    from soundkit_tpu_torch.tools import vorbis_fixtures as vf

    out = {}
    clips = {c.name: c for c in of.load_clips() + of.load_clips(names=of.VOICE_CLIPS)}
    for fmt, name in (("ogg_opus_stereo", "stereo96"), ("ogg_opus_mono", "mono64"),
                      ("ogg_opus_silk_wb", "silk_wb"), ("ogg_opus_hybrid_fb", "hybrid_fb"),
                      ("opus_raw", "owned")):
        clip = clips[name]
        reps = int(np.ceil(PIPE_HOST_SECONDS * 50 / len(clip.packets)))
        packets = clip.packets * reps
        data = (clip.head + b"".join(struct.pack("<H", len(p)) + p for p in packets)
                if fmt == "opus_raw" else of.ogg_stream(clip.head, packets))
        out[fmt] = (data, DP.spawn, (len(packets) * 960 - clip.pre_skip) / 48000)
    clip = vf.load_clips(names=("stereo44",))[0]
    from soundkit_tpu_torch.demux.ogg import OggPacketizer

    packets = [p for p, _g in OggPacketizer().push(clip.stream())]
    audio = packets[3:]
    samples = vf.lane_samples([clip], 1)[0]
    reps = int(np.ceil(PIPE_HOST_SECONDS * 44100 / samples))
    pages = [build_ogg_page([packets[0]], 9, 0, 0, header_type=2),
             build_ogg_page(packets[1:3], 9, 1, 0)]
    pages += [build_ogg_page([p], 9, 2 + i, 0) for i, p in enumerate(audio * reps)]
    out["ogg_vorbis"] = (b"".join(pages), DP.spawn, reps * samples / 44100)
    from soundkit_tpu_torch.tools import opus_ms_fixtures as msf

    data, audio_s = msf.long_stream(PIPE_MULTISTREAM_CLIP, PIPE_HOST_SECONDS)
    pre_skip = msf.load_index()[PIPE_MULTISTREAM_CLIP]["pre_skip"]
    out["ogg_opus_51"] = (data, DP.spawn, audio_s - pre_skip / 48000)
    from soundkit_tpu_torch.tools import aac_mc_fixtures as amf

    data, audio_s = amf.long_stream(PIPE_AAC_MC_CLIP, PIPE_HOST_SECONDS)
    out["adts_51"] = (data, DP.spawn, audio_s)
    return out


def aac_mc_reference_check(fmt: str, pcm: bytes) -> dict:
    """A 5.1 AAC-LC stream against its clip, as ``aac_mc_fixtures``
    commits it: the stream's int16 PCM over the clip's length within 1
    LSB of the JAX package's own decoder (``pcm_<clip>``), and the clip
    decoded alone by the port's ``AacDecoder`` to float32 against the JAX
    package's libavcodec decode (``libavcodec_<clip>``): the same length,
    each channel's PNS-free SNR >= 125 dB and no PNS-free channel-frame
    under the clip's measured worst less 10 dB (the bars of
    tests/test_torch_aac_multichannel.py)."""
    import numpy as np

    from soundkit_tpu_torch.codecs.aac import AacDecoder
    from soundkit_tpu_torch.tools import aac_mc_fixtures as amf

    clip = PIPE_AAC_MC_CLIP
    ref = amf.reference(clip, "pcm").astype(np.int32)
    head = np.frombuffer(pcm[:2 * ref.size], "<i2").astype(np.int32)
    check(head.size == ref.size, f"[pipeline] {fmt}: {len(pcm)} bytes, shorter than {clip}")
    lsb = int(np.abs(head - ref).max())
    check(lsb <= 1, f"[pipeline] {fmt}: {lsb} LSB from the JAX package's own decode of {clip}")
    got = AacDecoder().decode_f32(amf.clip_bytes(clip)).astype(np.float64)
    av = amf.reference(clip, "libavcodec").astype(np.float64)
    check(got.shape == av.shape, f"[pipeline] {fmt}: {got.size} float32 samples of {clip}, "
          f"libavcodec's {av.size}")
    r = amf.pns_free_snr(got.reshape(-1, 6).T, av.reshape(-1, 6).T,
                         amf.reference(clip, "pns"))
    worst = amf.load_index()[clip]["pns_free"]["worst_db"]
    check(min(r["snr_db"]) >= 125.0 and r["worst_db"] >= worst - 10.0,
          f"[pipeline] {fmt}: PNS-free {r} against libavcodec")
    return dict(vs_jax_max_lsb=lsb, vs_jax_samples_off=int((head != ref).sum()),
                vs_libavcodec_pns_free_snr_db=r["snr_db"],
                vs_libavcodec_pns_free_worst_db=r["worst_db"],
                pns_free_channel_frames=r["channel_frames"])


def multistream_reference_check(pcm: bytes) -> dict:
    """The 5.1 stream against the JAX package's decode of its clip
    (libavcodec), as ``opus_ms_fixtures`` commits it: the stream's int16
    PCM over the clip's length within 1 LSB of the committed float32 PCM
    quantized the same way, and the clip decoded alone by the port's
    ``OggOpusDecoder`` to float32, of the same length, each channel at >=
    104 dB from it (the CELT floor of tests/test_torch_opus_multistream.py)."""
    import numpy as np

    from soundkit_tpu_torch.codecs.avdec import f32_to_i16
    from soundkit_tpu_torch.codecs.opus import OggOpusDecoder
    from soundkit_tpu_torch.tools import opus_ms_fixtures as msf

    clip = PIPE_MULTISTREAM_CLIP
    ref = msf.reference_pcm(clip)
    head = np.frombuffer(pcm[:2 * ref.size], "<i2").astype(np.int32)
    check(head.size == ref.size, f"[pipeline] ogg_opus_51: {len(pcm)} bytes, shorter than {clip}")
    lsb = int(np.abs(head - f32_to_i16(ref).astype(np.int32)).max())
    check(lsb <= 1, f"[pipeline] ogg_opus_51: {lsb} LSB from the JAX package's PCM of {clip}")
    dec = OggOpusDecoder()
    data = msf.clip_bytes(clip)
    got = np.concatenate([dec.decode_f32(data), dec.flush()]).astype(np.float64)
    check(got.shape == ref.shape, f"[pipeline] ogg_opus_51: {got.size} float32 samples of {clip}, "
          f"the JAX package's {ref.size}")
    got, want = got.reshape(-1, 6), ref.astype(np.float64).reshape(-1, 6)
    snr = [float(10 * np.log10(np.sum(want[:, k] ** 2) /
                               max(np.sum((got[:, k] - want[:, k]) ** 2), 1e-300)))
           for k in range(6)]
    check(min(snr) >= 104.0, f"[pipeline] ogg_opus_51: float32 {min(snr):.2f} dB from the JAX "
          "package's PCM")
    return dict(vs_jax_max_lsb=lsb, vs_jax_samples_off=int((head != f32_to_i16(ref)).sum()),
                vs_jax_f32_snr_db=snr)


def pipeline_codec_streams() -> dict:
    """The owned host codecs' streams of [pipeline] (PIPE_CODEC_STREAMS),
    each made by ``host_codec_fixtures.long_stream``: GSM standard and
    WAV49 by ``spawn_gsm``, ALAC in CAF by ``spawn_alac``, the rest (AIFF
    16-bit, AIFF-C µ-law and A-law, ALAC in MP4, AC-3 stereo, Ogg Speex
    NB / WB / UWB) detected by ``DecodePipeline.spawn``; the MPEG audio
    Layer II / I streams (``mpa_fixtures.long_stream``) by ``spawn_mp3``;
    G.729 and AMR-NB by ``spawn_g729`` / ``spawn_amr_nb``."""
    from soundkit_tpu_torch.codecs.telephony import GsmVariant
    from soundkit_tpu_torch.pipeline.decode_pipeline import DecodePipeline as DP
    from soundkit_tpu_torch.tools import host_codec_fixtures as hcf
    from soundkit_tpu_torch.tools import mpa_fixtures

    spawns = {"detect": DP.spawn, "alac": DP.spawn_alac,
              "gsm_standard": lambda device: DP.spawn_gsm(GsmVariant.STANDARD, device=device),
              "gsm_microsoft": lambda device: DP.spawn_gsm(GsmVariant.MICROSOFT, device=device),
              "g729": DP.spawn_g729, "amr_nb": DP.spawn_amr_nb}
    index = hcf.load_index()
    out = {}
    for fmt, (clip, seconds) in PIPE_CODEC_STREAMS.items():
        if clip in mpa_fixtures.SMOKE:
            data, audio_s = mpa_fixtures.long_stream(clip, seconds)
            out[fmt] = (data, DP.spawn_mp3, audio_s)
            continue
        data, audio_s = hcf.long_stream(clip, seconds)
        out[fmt] = (data, spawns[index[clip]["spawn"]], audio_s)
    return out


def pipeline_container_streams() -> dict:
    """The container streams of [pipeline] (PIPE_CONTAINER_STREAMS), each
    made by ``container_fixtures.long_stream``: M4A AAC and the WebM ones
    detected by ``DecodePipeline.spawn``, LOAS/LATM by ``spawn_aac_latm``."""
    from soundkit_tpu_torch.pipeline.decode_pipeline import DecodePipeline as DP
    from soundkit_tpu_torch.tools import container_fixtures as cf

    from soundkit_tpu_torch.tools import aac_mc_fixtures as amf

    out = {}
    for fmt, (case, seconds) in PIPE_CONTAINER_STREAMS.items():
        data, audio_s = (amf if case in amf.CONTAINERS else cf).long_stream(case, seconds)
        if case.startswith("webm_opus"):
            audio_s -= 312 / 48000  # the clips' OpusHead pre-skip
        out[fmt] = (data, DP.spawn_aac_latm if case in cf.LATM else DP.spawn, audio_s)
    return out


def container_reference_check(fmt: str, pcm: bytes) -> dict:
    """A container stream's PCM against the JAX package's owned decode of
    its case, as ``container_fixtures`` records it: the stream's first
    ``pcm_bytes`` bytes (its decode begins with the case's) bit for bit by
    SHA-256, or, for the SILK stream (the port's resampler stands in for
    libswresample), within 1 LSB of the committed int16 PCM of the first
    second."""
    import numpy as np

    from soundkit_tpu_torch.tools import container_fixtures as cf

    case = PIPE_CONTAINER_STREAMS[fmt][0]
    if fmt == "m4a_51":
        return aac_mc_reference_check(fmt, pcm)
    e = cf.load_index()[case]
    head = pcm[:e["pcm_bytes"]]
    check(len(head) == e["pcm_bytes"], f"[pipeline] {fmt}: {len(pcm)} bytes, shorter than its case")
    if case in cf.REFERENCE_PCM:
        ref = cf.reference_pcm(case).astype(np.int32)
        a = np.frombuffer(head, "<i2").astype(np.int32)[:ref.size]
        lsb = int(np.abs(a - ref).max())
        check(lsb <= 1, f"[pipeline] {fmt}: {lsb} LSB from the JAX package's PCM of {case}")
        return dict(vs_jax_max_lsb=lsb, vs_jax_samples_off=int((a != ref).sum()))
    check(cf.sha256(head) == e["sha256"], f"[pipeline] {fmt}: differs from the JAX package's "
          f"decode of {case}")
    return dict(vs_jax="identical")


def codec_reference_check(fmt: str, pcm: bytes) -> dict:
    """A host codec stream's PCM against the JAX package's decode of its
    clip, as ``host_codec_fixtures`` records it: the stream's first
    ``pcm_bytes`` bytes (its decode begins with the clip's) bit for bit
    by SHA-256, or, for the float-decoded AC-3 and Speex, within 1 LSB of
    the committed int16 PCM."""
    import numpy as np

    from soundkit_tpu_torch.tools import celp_fixtures
    from soundkit_tpu_torch.tools import host_codec_fixtures as hcf
    from soundkit_tpu_torch.tools import mpa_fixtures

    clip = PIPE_CODEC_STREAMS[fmt][0]
    if clip in mpa_fixtures.SMOKE:
        return mpa_reference_check(fmt, pcm)
    if clip in celp_fixtures.CLIPS:
        return celp_reference_check(fmt, pcm)
    e = hcf.load_index()[clip]
    head = pcm[:e["pcm_bytes"]]
    check(len(head) == e["pcm_bytes"], f"[pipeline] {fmt}: {len(pcm)} bytes, shorter than its clip")
    if clip in hcf.REFERENCE_PCM:
        a = np.frombuffer(head, "<i2").astype(np.int32)
        lsb = int(np.abs(a - hcf.reference_pcm(clip)).max())
        check(lsb <= 1, f"[pipeline] {fmt}: {lsb} LSB from the JAX package's PCM of {clip}")
        return dict(vs_jax_max_lsb=lsb, vs_jax_samples_off=int((a != hcf.reference_pcm(clip)).sum()))
    check(hcf.sha256(head) == e["sha256"], f"[pipeline] {fmt}: differs from the JAX package's "
          f"decode of {clip}")
    return dict(vs_jax="identical")


def celp_reference_check(fmt: str, pcm: bytes) -> dict:
    """A G.729 or AMR-NB stream against the JAX package's decode of its
    clip (libavcodec on the CPU), as ``host_codec_fixtures`` commits it: the
    stream's int16 PCM over the clip's length (its decode begins with the
    clip's) equal for G.729 (an integer decoder: 0 LSB), at >= 90 dB for
    AMR-NB (a float decoder: the CPU tests' bar), its worst LSB reported."""
    import numpy as np

    from soundkit_tpu_torch.tools import celp_fixtures
    from soundkit_tpu_torch.tools import host_codec_fixtures as hcf

    clip = PIPE_CODEC_STREAMS[fmt][0]
    ref = hcf.reference_pcm(clip).astype(np.int64)
    head = np.frombuffer(pcm[:2 * ref.size], "<i2").astype(np.int64)
    check(head.size == ref.size, f"[pipeline] {fmt}: {len(pcm)} bytes, shorter than its clip")
    lsb = int(np.abs(head - ref).max())
    err = float(np.sum((head - ref).astype(np.float64) ** 2))
    snr = float("inf") if err == 0 else \
        10 * np.log10(float(np.sum(ref.astype(np.float64) ** 2)) / err)
    if celp_fixtures.kind(clip) == "g729":
        check(lsb == 0, f"[pipeline] {fmt}: {lsb} LSB from the JAX package's PCM of {clip}")
    else:
        check(snr >= 90.0, f"[pipeline] {fmt}: {snr:.2f} dB from the JAX package's PCM of {clip}")
    return dict(vs_jax_max_lsb=lsb, vs_jax_samples_off=int((head != ref).sum()),
                vs_jax_i16_snr_db=float(snr))


def mpa_reference_check(fmt: str, pcm: bytes) -> dict:
    """An MPEG audio Layer II / I stream against the JAX package's decode
    of its clip (libavcodec), as ``mpa_fixtures`` commits it: the stream's
    int16 PCM over the clip's length within 1 LSB of the committed float32
    PCM quantized the same way, and the clip decoded alone by the port's
    ``Mp3Decoder`` to float32 at >= 100 dB from it, of the same length."""
    import numpy as np

    from soundkit_tpu_torch.codecs.avdec import f32_to_i16
    from soundkit_tpu_torch.codecs.mp3 import Mp3Decoder
    from soundkit_tpu_torch.tools import mpa_fixtures

    clip = PIPE_CODEC_STREAMS[fmt][0]
    ref = mpa_fixtures.reference_pcm(clip)
    head = np.frombuffer(pcm[:2 * ref.size], "<i2").astype(np.int32)
    check(head.size == ref.size, f"[pipeline] {fmt}: {len(pcm)} bytes, shorter than its clip")
    lsb = int(np.abs(head - f32_to_i16(ref).astype(np.int32)).max())
    check(lsb <= 1, f"[pipeline] {fmt}: {lsb} LSB from the JAX package's PCM of {clip}")
    dec = Mp3Decoder(device="cuda")
    data = mpa_fixtures.clip_bytes(clip)
    got = np.concatenate([dec.decode_f32(data), dec.flush_f32()]).astype(np.float64)
    check(got.shape == ref.shape, f"[pipeline] {fmt}: {got.size} float32 samples of {clip}, "
          f"the JAX package's {ref.size}")
    want = ref.astype(np.float64)
    snr = 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-300))
    check(snr >= 100.0, f"[pipeline] {fmt}: float32 {snr:.2f} dB from the JAX package's PCM")
    return dict(vs_jax_max_lsb=lsb, vs_jax_samples_off=int((head != f32_to_i16(ref)).sum()),
                vs_jax_f32_snr_db=float(snr))


def pipeline_run(spawn, data: bytes, device: str, timed: bool = False):
    """One stream through a threaded pipeline in PIPE_CHUNK-byte sends:
    (outputs, wall s, host s of each chunk's ``process``, device ms of
    each chunk between CUDA events recorded just before and after it).
    The timing hook (``timed``) wraps the handle's ``process``; its two
    event records a chunk are outside the host span but inside the wall,
    so a timed run's wall is not the stream's."""
    import torch

    handle = spawn(device=device)
    walls, events = [], []
    if timed:
        core = handle._core
        process = core.process

        def timed_process(chunk):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            t0 = time.perf_counter()
            outs = process(chunk)
            walls.append(time.perf_counter() - t0)
            stop.record()
            events.append((start, stop))
            return outs

        core.process = timed_process
    t0 = time.perf_counter()
    drained = []
    for i in range(0, len(data), PIPE_CHUNK):
        handle.send_blocking(data[i:i + PIPE_CHUNK], drained)
    handle.send_blocking(b"", drained)
    outs = drained + handle.recv_all(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return outs, wall, walls, [a.elapsed_time(b) for a, b in events]


def _pcm_bytes(outs) -> bytes:
    from soundkit_tpu_torch.core.audio_types import AudioData

    return b"".join(o.data for o in outs if isinstance(o, AudioData))


def _audio_seconds(outs) -> float:
    from soundkit_tpu_torch.core.audio_types import AudioData

    return sum(len(o.data) / (o.bits_per_sample // 8) / o.channel_count / o.sampling_rate
               for o in outs if isinstance(o, AudioData))


def _prefix(fmt: str, data: bytes, seconds: float,
            compare_s: float = PIPE_COMPARE_SECONDS) -> bytes:
    """The first part of a stream the CPU also decodes: ``compare_s`` s of
    it, or PIPE_SCAN_COMPARE_CODES codes of G.722 / G.726."""
    if fmt == "g722":
        return data[:PIPE_SCAN_COMPARE_CODES]
    if fmt.startswith("g726"):  # 1000 codes: whole packing groups at every rate
        return data[:PIPE_SCAN_COMPARE_CODES * (int(fmt[5:]) // 8) // 8]
    cut = int(len(data) * compare_s / seconds)
    return data[:max(cut, 9000)]


def phase_pipeline(card: str):
    """K3, K6, K7 and K10 at B = 1 against their plain versions; each
    format's stream made (the encoders' launches counted alone), the
    first send of each telephony stream against plain scans, then each
    stream through DecodePipeline on the card (the launch counters reset
    just before and read just after), its prefix on the CPU, and eight
    mixed streams at once."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.codecs.mp3 import Mp3Decoder
    from soundkit_tpu_torch.core.audio_types import AudioData
    from soundkit_tpu_torch.pipeline.output_options import DecodeError
    from soundkit_tpu_torch.tools import kernel_check as kc

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    checks = {}
    for name, (kernel, plain) in kc.stream_cases(dev).items():
        checks[name] = kc.compare(name.split("/")[0], kernel, plain)["max_abs_err"]
    rules = kc.stream_rules(dev)
    checks_s = time.perf_counter() - t_phase
    log(f"[pipeline] B = 1 kernel checks: {len(checks)} cases, max |err| "
        f"{max(checks.values())}; rules {sorted(rules)}; {checks_s:.1f} s")

    wrappers = pipeline_wrappers()
    encoders = ("g726_encode_scan", "g722_encode_scan")
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    streams, sources = pipeline_streams()
    make_s = time.perf_counter() - t0
    encoder_launches = {n: wrappers[n].launches for n in encoders}
    for n, c in encoder_launches.items():
        check(c > 0, f"[pipeline] {n} was not launched by the streaming encoders")

    # the first send of each telephony stream, encoded and decoded,
    # against plain scans on the card
    t0 = time.perf_counter()
    for fmt, pcm in sources.items():
        for name, (kernel, plain) in kc.telephony_send_pairs(fmt, pcm, streams[fmt][0],
                                                             dev).items():
            checks[name] = kc.compare(name.split("/")[0], kernel, plain)["max_abs_err"]
    send_checks_s = time.perf_counter() - t0
    log(f"[pipeline] first sends against plain scans: {len(sources)} streams, "
        f"{send_checks_s:.1f} s")

    for w in wrappers.values():
        w.launches = 0
    res, lone = {}, {}
    for fmt, (data, spawn, seconds) in streams.items():
        k3_before = wrappers["g711_decode"].launches
        outs, wall, _, _ = pipeline_run(spawn, data, "cuda")
        k3_launches = wrappers["g711_decode"].launches - k3_before
        errors = [type(o).__name__ for o in outs if isinstance(o, DecodeError)]
        check(not errors, f"[pipeline] {fmt}: errors on a clean stream: {errors}")
        audio = [o for o in outs if isinstance(o, AudioData)]
        check(audio, f"[pipeline] {fmt}: no audio")
        a0 = audio[0]
        got_s = _audio_seconds(audio)
        floor_s = PIPE_HOST_SECONDS if fmt in PIPE_HOST_FORMATS else \
            PIPE_CODEC_STREAMS[fmt][1] if fmt in PIPE_CODEC_STREAMS else \
            PIPE_CONTAINER_STREAMS[fmt][1] if fmt in PIPE_CONTAINER_STREAMS else PIPE_SECONDS
        check(got_s >= 0.99 * seconds and got_s >= floor_s * 0.99,
              f"[pipeline] {fmt}: {got_s:.2f} s of audio out of {seconds:.2f}")
        lone[fmt] = outs
        res[fmt] = dict(audio_s=got_s, bytes=len(data), wall_s=wall, xrealtime=got_s / wall,
                        rate=a0.sampling_rate, channels=a0.channel_count,
                        bits=a0.bits_per_sample)
        if fmt.startswith("aifc"):  # K3 once, at the file's end
            check(k3_launches == 1, f"[pipeline] {fmt}: K3 launched {k3_launches} times")
            res[fmt]["k3_launches"] = k3_launches
    launches = {n: w.launches for n, w in wrappers.items()}
    for n, c in launches.items():
        check((c == 0) if n in encoders else (c > 0),
              f"[pipeline] {n}: {c} launches on the decode path")

    # the per-chunk timing hook, on each stream's first PIPE_TIMED_SECONDS s
    for fmt, (data, spawn, seconds) in streams.items():
        host_head = fmt in PIPE_HOST_FORMATS or fmt in PIPE_CONTAINER_STREAMS
        timed_s = seconds if fmt in PIPE_EOF_FORMATS else \
            PIPE_HOST_TIMED_SECONDS if host_head else \
            PIPE_CODEC_TIMED_SECONDS if fmt in PIPE_CODEC_STREAMS else PIPE_TIMED_SECONDS
        outs, wall, walls, dev_ms = pipeline_run(
            spawn, data[:int(len(data) * timed_s / seconds)], "cuda", timed=True)
        res[fmt].update(timed_chunks=len(walls),
                        chunk_ms_median=1e3 * float(np.median(walls)),
                        device_ms_median=float(np.median(dev_ms)),
                        timed_xrealtime=_audio_seconds(outs) / wall)

    # the CPU path on each stream's prefix (the host-decoded streams' first
    # PIPE_HOST_TIMED_SECONDS: the same host code; the EOF-buffered ones and
    # PIPE_CODEC_WHOLE_COMPARE whole):
    # bit-exact, MP3 within 1 LSB; the reference checks on the card's whole stream
    t0 = time.perf_counter()
    cpu_pcm = {}  # {format: (its CPU PCM, decoded from a prefix cut by bytes)}
    for fmt, (data, spawn, seconds) in streams.items():
        host_stream = fmt in PIPE_HOST_FORMATS or fmt in PIPE_CODEC_STREAMS or \
            fmt in PIPE_CONTAINER_STREAMS
        head = data if fmt in PIPE_EOF_FORMATS or fmt in PIPE_CODEC_WHOLE_COMPARE else \
            _prefix(fmt, data, seconds, PIPE_HOST_TIMED_SECONDS) if host_stream else \
            _prefix(fmt, data, seconds)
        host, cut = cpu_pcm.get(PIPE_CPU_SHARED.get(fmt)) or \
            (_pcm_bytes(pipeline_run(spawn, head, "cpu")[0]), len(head) < len(data))
        if fmt in PIPE_CPU_SHARED.values():
            cpu_pcm[fmt] = (host, cut)
        whole_pcm = _pcm_bytes(lone[fmt])
        card_pcm = whole_pcm[:len(host)]
        check(len(host) > 0 and len(card_pcm) == len(host),
              f"[pipeline] {fmt}: {len(host)} CPU bytes, {len(card_pcm)} card bytes")
        if cut and host_stream:
            r = res[fmt]
            keep = len(host) - int(PIPE_PREFIX_GUARD_SECONDS * r["rate"]) * r["channels"] * \
                (r["bits"] // 8)
            check(keep > 0, f"[pipeline] {fmt}: a CPU prefix of {len(host)} bytes")
            host, card_pcm = host[:keep], card_pcm[:keep]
        if fmt == "mp3":
            a = np.frombuffer(card_pcm, "<i2").astype(np.int32)
            b = np.frombuffer(host, "<i2").astype(np.int32)
            lsb = int(np.abs(a - b).max())
            check(lsb <= 1, f"[pipeline] mp3: int16 {lsb} LSB from the CPU path")
            res[fmt]["int16_max_lsb_vs_cpu"] = lsb
            res[fmt]["int16_samples_off_by_one"] = int((a != b).sum())
        else:
            check(card_pcm == host, f"[pipeline] {fmt}: card and CPU outputs differ")
        if fmt in PIPE_CODEC_STREAMS:
            res[fmt].update(codec_reference_check(fmt, whole_pcm))
        if fmt in PIPE_CONTAINER_STREAMS:
            res[fmt].update(container_reference_check(fmt, whole_pcm))
        if fmt == "ogg_opus_51":
            res[fmt].update(multistream_reference_check(whole_pcm))
        if fmt == "adts_51":
            res[fmt].update(aac_mc_reference_check(fmt, whole_pcm))
        res[fmt]["cpu_compare_bytes"] = len(head)
    head = _prefix("mp3", streams["mp3"][0], streams["mp3"][2])
    f32 = []
    for device in ("cuda", "cpu"):
        d = Mp3Decoder(device=device)
        f32.append(np.concatenate([d.decode_f32(head[i:i + PIPE_CHUNK])
                                   for i in range(0, len(head), PIPE_CHUNK)]).astype(np.float64))
    snr = 10 * np.log10(np.sum(f32[1] ** 2) / max(np.sum((f32[0] - f32[1]) ** 2), 1e-300))
    check(f32[0].shape == f32[1].shape and snr >= 100.0, f"[pipeline] mp3 f32 {snr:.1f} dB")
    res["mp3"]["f32_snr_db_vs_cpu"] = float(snr)
    compare_s = time.perf_counter() - t0

    # eight mixed pipelines at once, each against its lone run
    import threading

    t0 = time.perf_counter()
    got = {}

    def run(fmt):
        data, spawn, _ = streams[fmt]
        got[fmt] = pipeline_run(spawn, data, "cuda")[0]

    threads = [threading.Thread(target=run, args=(fmt,)) for fmt in PIPE_CONCURRENT]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    concurrent_s = time.perf_counter() - t0
    for fmt in PIPE_CONCURRENT:
        check(fmt in got and _pcm_bytes(got[fmt]) == _pcm_bytes(lone[fmt])
              and len(got[fmt]) == len(lone[fmt]),
              f"[pipeline] {fmt}: a concurrent run differs from its lone run")
    audio_s = sum(res[f]["audio_s"] for f in PIPE_CONCURRENT)
    summary = dict(card=card, checks_s=checks_s, make_streams_s=make_s,
                   send_checks_s=send_checks_s, cpu_compare_s=compare_s,
                   concurrent=dict(streams=len(PIPE_CONCURRENT), wall_s=concurrent_s,
                                   aggregate_xrealtime=audio_s / concurrent_s),
                   launches=launches, encoder_launches=encoder_launches,
                   phase_s=time.perf_counter() - t_phase)
    for fmt, r in res.items():
        log(f"[pipeline] {fmt} ({card}): {json.dumps(r)}")
    log(f"[pipeline] {json.dumps(summary)}")
    return dict(formats=res, kernel_checks=checks, rules=rules, **summary)


def phase_containers() -> dict:
    """``simple.AudioTrackDemuxer`` over the MP4, WebM and three-track
    MPEG-TS cases of ``container_fixtures``, in 188-byte pushes and whole:
    each case's bytes equal the index's and its events the JAX package's
    as the index records them (their SHA-256)."""
    from soundkit_tpu_torch.simple import AudioTrackDemuxer
    from soundkit_tpu_torch.tools import container_fixtures as cf

    t_phase = time.perf_counter()
    index = cf.load_index()
    res = {}
    for name in cf.CASES:
        e = index[name]
        data = cf.build(name)
        check(cf.sha256(data) == e["sha256_bytes"], f"[containers] {name}: its bytes differ from "
              "the index's")
        if "events" not in e:  # LOAS: no container for the track demuxer
            continue
        r = dict(bytes=len(data), events=e["events"]["events"])
        for chunk, key in ((188, "chunk188_s"), (0, "whole_s")):
            t0 = time.perf_counter()
            events = cf.demux_events(AudioTrackDemuxer.new_auto(), data, chunk)
            r[key] = time.perf_counter() - t0
            check(cf.events_digest(events) == e["events"],
                  f"[containers] {name}: events in {key[:-2]} pushes differ from the JAX package's")
        r["chunk188_mb_per_s"] = len(data) / 1e6 / r["chunk188_s"]
        res[name] = r
        log(f"[containers] {name}: {json.dumps(r)}")
    summary = dict(n_cases=len(res), phase_s=time.perf_counter() - t_phase)
    log(f"[containers] {json.dumps(summary)}")
    return dict(cases=res, **summary)


# ---------------------------------------------------------------------------
# the encode direction and the SoundKit frame format
# ---------------------------------------------------------------------------

ENC_CLIPS = 8             # distinct seeded stereo clips
ENC_SECONDS = 4.0         # a clip, at 48 kHz
ENC_HYBRID_SECONDS = 1.0  # the one hybrid FB clip (its encoder is Python)
ENC_PY_FRAMES = 10        # frames the native and Python encoders are held equal on
ENC_PUSHES = 4            # ragged pushes of the [encode] fleet, a collect after each
ENC_CPU_PACKETS = 25      # a clip's first packets, decoded on the CPU for the compare (0.5 s)
ENC_OPUS_MIX = (("celt", 512), ("silk", 384), ("hybrid", 128))  # Ogg Opus lanes by encoder
FRAMES_CHUNK = 313        # bytes a push of the [frames] decoder


def encode_clip(k: int, seconds: float = ENC_SECONDS):
    """Clip ``k``: [n, 2] float64 at 48 kHz in [-1, 1], made from seed
    ``k``: a melody of harmonic notes (a new pitch every 250 ms, vibrato),
    a bass line, breath noise and decaying clicks, the right channel its
    own mix of the same parts."""
    import numpy as np

    rng = np.random.default_rng(1000 + k)
    n = int(RATE * seconds)
    t = np.arange(n) / RATE
    note = rng.integers(48, 84, int(np.ceil(seconds * 4)) + 1)
    f0 = 440.0 * 2 ** ((note[(t * 4).astype(int)] - 69) / 12.0) * (1 + 0.004 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / RATE
    melody = sum(np.sin(h * phase) / h ** 1.3 for h in range(1, 9))
    env = 0.6 + 0.4 * np.cos(2 * np.pi * 4 * t) ** 2
    bass = np.sin(2 * np.pi * (55.0 * 2 ** (rng.integers(0, 12) / 12.0)) * t)
    clicks = np.zeros(n)
    for pos in rng.integers(0, n - 2000, 6):
        clicks[pos:pos + 2000] += np.sin(0.35 * np.arange(2000)) * np.exp(-np.arange(2000) / 250.0)
    noise = rng.standard_normal(n)
    left = 0.22 * melody * env + 0.20 * bass + 0.15 * clicks + 0.01 * noise
    right = 0.16 * melody * env + 0.25 * bass + 0.10 * np.roll(clicks, 37) + 0.01 * rng.standard_normal(n)
    return np.clip(np.stack([left, right], axis=1), -0.95, 0.95)


def _i16(x):
    import numpy as np

    return np.clip(np.rint(x * 32767.0), -32768, 32767).astype(np.int16)


def _best_lag_snr_db(src, out, max_lag: int = 1200) -> float:
    """SNR of ``out`` against ``src`` ([n, C] each) at the lag (0..max_lag
    samples of delay) and the gain that fit best, the first channel."""
    import numpy as np

    a = np.asarray(src[:, 0], np.float64)
    b = np.asarray(out[:, 0], np.float64)
    n = min(len(a), len(b)) - max_lag
    corr = np.correlate(b[:n + max_lag], a[:n], mode="valid")[:max_lag + 1]
    lag = int(np.argmax(corr))
    bb = b[lag:lag + n]
    g = float(np.dot(a[:n], bb)) / max(float(np.dot(bb, bb)), 1e-30)
    err = a[:n] - g * bb
    return float(10 * np.log10(np.sum(a[:n] ** 2) / max(np.sum(err ** 2), 1e-30)))


def encode_streams(seconds: float = ENC_SECONDS, n_clips: int = ENC_CLIPS,
                   hybrid_seconds: float = ENC_HYBRID_SECONDS):
    """Every [encode] clip through the port's encoders on the host: Ogg
    Opus CELT (``simple.OpusEncoder``, 64 kbit/s stereo, native), SILK WB
    mono (``encoders.OpusEncoder(mode="voice")``, native, the left
    channel), hybrid FB stereo (one clip of ``hybrid_seconds``, Python
    SILK) and FLAC (``simple.FlacEncoder``, 16-bit stereo, level 5,
    wrapped as ``fLaC`` + STREAMINFO + frames). Returns (streams, timings):
    streams[kind] is a list of dicts (data, source PCM, packets), timings
    each encoder's audio and host seconds."""
    import numpy as np

    from soundkit_tpu_torch import simple
    from soundkit_tpu_torch.codecs import encoders
    from soundkit_tpu_torch.demux.ogg import OggOpusWriter

    clips = [encode_clip(k, seconds) for k in range(n_clips)]
    streams = {"celt": [], "silk": [], "hybrid": [], "flac": []}
    timing = {k: dict(audio_s=0.0, host_s=0.0) for k in streams}

    def ogg(packets, channels):
        w = OggOpusWriter(channels=channels)
        for p in packets:
            w.write_packet(p)
        return w.close()

    for x in clips:
        pcm = _i16(x)
        # CELT: simple.OpusEncoder takes one frame a call (the reference's contract)
        t0 = time.perf_counter()
        enc = simple.OpusEncoder(48000, 2, 64000)
        fs = enc.frame_size
        inter = pcm.reshape(-1)
        packets = []
        for i in range(0, len(pcm) - fs + 1, fs):
            packets += enc.encode_interleaved_i16(inter[2 * i: 2 * (i + fs)])
        packets += enc.flush()
        timing["celt"]["host_s"] += time.perf_counter() - t0
        timing["celt"]["audio_s"] += len(pcm) / RATE
        streams["celt"].append(dict(data=ogg(packets, 2), source=pcm, packets=packets))
        # SILK WB mono
        t0 = time.perf_counter()
        enc = encoders.OpusEncoder(48000, 1, 32000, mode="voice")
        check(enc.backend == "owned-silk" and enc._own._native is not None,
              "[encode] the SILK route is not the native owned encoder")
        packets = enc.encode_i16_packets(pcm[:, 0]) + enc.flush_packets()
        timing["silk"]["host_s"] += time.perf_counter() - t0
        timing["silk"]["audio_s"] += len(pcm) / RATE
        streams["silk"].append(dict(data=ogg(packets, 1), source=pcm[:, :1], packets=packets))
        # FLAC 16-bit stereo, level 5
        t0 = time.perf_counter()
        enc = simple.FlacEncoder(48000, 2, bits_per_sample=16, compression_level=5)
        planar = np.ascontiguousarray(x.T.astype(np.float32)).reshape(-1)
        frames = enc.encode_planar_f32(planar, len(pcm)) + enc.flush()
        head = b"fLaC" + bytes([0x80, 0, 0, 34]) + enc._enc.streaminfo
        timing["flac"]["host_s"] += time.perf_counter() - t0
        timing["flac"]["audio_s"] += len(pcm) / RATE
        # the FLAC source: the encoder's own int conversion of the planar floats
        src = np.clip(np.rint(planar.astype(np.float64) * 32768.0), -32768, 32767)
        streams["flac"].append(dict(data=head + frames, source=src.reshape(2, -1).T.astype(np.int16),
                                    packets=None))
    x = clips[0][: int(RATE * hybrid_seconds)]
    pcm = _i16(x)
    t0 = time.perf_counter()
    enc = encoders.OpusEncoder(48000, 2, 64000, mode="voice", voice_bandwidth="fb")
    check(enc.backend == "owned-hybrid", "[encode] the hybrid route is not the owned encoder")
    packets = enc.encode_i16_packets(pcm.reshape(-1)) + enc.flush_packets()
    timing["hybrid"]["host_s"] += time.perf_counter() - t0
    timing["hybrid"]["audio_s"] += len(pcm) / RATE
    streams["hybrid"].append(dict(data=ogg(packets, 2), source=pcm, packets=packets))
    return streams, timing, clips


def encode_backends_agree(clip) -> dict:
    """The native and the Python (``native=False``) CELT and SILK encoders
    on the first ENC_PY_FRAMES frames of ``clip``: the same bytes (the
    JAX package's own contract, ``tests/test_opus_encoder.py:352``)."""
    from soundkit_tpu_torch.codecs.opus_celt_enc import OVERLAP, OpusCeltEncoder
    from soundkit_tpu_torch.codecs.opus_silk_enc import OpusSilkEncoder

    res = {}
    head = clip[: ENC_PY_FRAMES * 960 + OVERLAP]
    for name, make, x in (("celt", lambda nat: OpusCeltEncoder(2, 64000, native=nat), head),
                          ("silk", lambda nat: OpusSilkEncoder("wb", 32000, 1, native=nat),
                           head[: ENC_PY_FRAMES * 960, :1])):
        got = {}
        for nat in (True, False):
            enc = make(nat)
            check((enc._native is not None) == nat, f"[encode] {name} native={nat} took the other path")
            t0 = time.perf_counter()
            got[nat] = enc.push(x)
            got[f"s{nat}"] = time.perf_counter() - t0
        check(len(got[True]) == ENC_PY_FRAMES and got[True] == got[False],
              f"[encode] {name}: native and Python packets differ ({len(got[True])} / "
              f"{len(got[False])} packets)")
        res[name] = dict(frames=ENC_PY_FRAMES, bytes=sum(map(len, got[True])),
                         native_ms_per_frame=1e3 * got["sTrue"] / ENC_PY_FRAMES,
                         python_ms_per_frame=1e3 * got["sFalse"] / ENC_PY_FRAMES)
    return res


def encode_lanes(streams, lanes: int = B):
    """{sid: (kind, clip index)}: ``lanes`` FLAC streams (clip j mod 8) and
    ``lanes`` Ogg Opus streams in ENC_OPUS_MIX's shares (each clip repeated
    across its kind's lanes)."""
    out = {f"flac-{j}": ("flac", j % len(streams["flac"])) for j in range(lanes)}
    j = 0
    total = sum(share for _, share in ENC_OPUS_MIX)
    for kind, share in ENC_OPUS_MIX:
        for i in range(share * lanes // total):
            out[f"{kind}-{j}"] = (kind, i % len(streams[kind]))
            j += 1
    return out


def drive_encode_fleet(fleet, streams, lanes, collect) -> tuple:
    """Push every stream of ``lanes`` in ENC_PUSHES ragged rounds (stream
    j's cut points move with j; every fifth (stream, round) pushes nothing
    new), ``collect`` after each round; each stream ends with its last
    push. Returns (push seconds, collect seconds)."""
    pos = dict.fromkeys(lanes, 0)
    push_s = collect_s = 0.0
    for r in range(ENC_PUSHES):
        t0 = time.perf_counter()
        for k, (sid, (kind, c)) in enumerate(lanes.items()):
            data = streams[kind][c]["data"]
            last = r == ENC_PUSHES - 1
            if not last and (k + r) % 5 == 0:
                continue
            share = 1.0 if last else (r + 1) / ENC_PUSHES * (0.6 + 0.4 * ((k * 7919) % 101) / 100)
            end = len(data) if last else max(int(len(data) * share), pos[sid])
            fleet.push(sid, data[pos[sid]:end])
            pos[sid] = end
            if last:
                fleet.end_stream(sid)
        t1 = time.perf_counter()
        collect()
        t2 = time.perf_counter()
        push_s += t1 - t0
        collect_s += t2 - t1
    check(all(pos[sid] == len(streams[k][c]["data"]) for sid, (k, c) in lanes.items()),
          "[encode] a stream was not pushed whole")
    return push_s, collect_s


def phase_encode(lanes: int = B, device: str = "cuda", seconds: float = ENC_SECONDS,
                 hybrid_seconds: float = ENC_HYBRID_SECONDS) -> dict:
    """Encode on the host with the port's encoders, then decode on the card
    through one ``StreamFleet``: every FLAC lane equal to its source,
    every Opus lane bit-identical to the other lanes of its clip and
    within the bars of ``tests/test_torch_fleet.py`` of the port's CPU
    decode of the same streams (CELT 100 dB, SILK and hybrid 90 dB),
    K8 / K9 / K11 / K12 launched by the fleet's lanes."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.models.fleet import StreamFleet

    t_phase = time.perf_counter()
    streams, timing, clips = encode_streams(seconds, hybrid_seconds=hybrid_seconds)
    enc = {k: dict(v, xrealtime=v["audio_s"] / v["host_s"]) for k, v in timing.items()}
    log(f"[encode] encoders (host clock): {json.dumps(enc)}")
    agree = encode_backends_agree(clips[0])
    log(f"[encode] native = Python: {json.dumps(agree)}")

    plan = encode_lanes(streams, lanes)
    wrappers = {**flac_wrappers(), **voice_wrappers()}
    fleet = StreamFleet(capacity_per_group=lanes, device=device)
    got = {}

    def collect():
        recs = fleet.collect(device_out=True)
        if device == "cuda":
            torch.cuda.synchronize()
        for sid, rec in recs.items():
            want = "flac" if plan[sid][0] == "flac" else "opus"
            check(rec.kind == want, f"[encode] {sid}: a {rec.kind} output, not {want}")
            pcm = rec.fetch()
            if pcm is not None:
                got.setdefault(sid, []).append(pcm)

    for w in wrappers.values():
        w.launches = 0
    push_s, collect_s = drive_encode_fleet(fleet, streams, plan, collect)
    launches = {n: w.launches for n, w in wrappers.items()}
    for n, c in launches.items():
        check(c > 0, f"[encode] {n} was not launched by the fleet")
    check(not fleet._lanes and not fleet._fallback and not fleet._pending_out,
          "[encode] streams left in the fleet or on its host fallback")

    t_check = time.perf_counter()
    pcm = {sid: np.concatenate(parts, axis=1) for sid, parts in got.items()}
    check(sorted(pcm) == sorted(plan), f"[encode] {len(plan) - len(pcm)} streams returned nothing")
    for sid, (kind, c) in plan.items():
        if kind != "flac":
            continue
        src = streams["flac"][c]["source"]
        check(pcm[sid].shape == (2, len(src)) and np.array_equal(pcm[sid] * 32768.0, src.T),
              f"[encode] {sid}: the FLAC lane's PCM {pcm[sid].shape} differs from its source")
    first = {}
    for sid, (kind, c) in plan.items():
        if kind == "flac":
            continue
        ref = first.setdefault((kind, c), sid)
        check(np.array_equal(pcm[sid], pcm[ref]),
              f"[encode] {sid}: not bit-identical to {ref}, a lane of the same clip")

    # the port's CPU decode of each clip's first ENC_CPU_PACKETS packets (an Ogg stream
    # of them), through a fleet on the CPU: a lane's first samples are theirs alone
    from soundkit_tpu_torch.demux.ogg import OggOpusWriter

    cpu_ids = sorted(first, key=lambda kc: first[kc])
    cpu = StreamFleet(capacity_per_group=len(cpu_ids), device="cpu")
    t0 = time.perf_counter()
    for kind, c in cpu_ids:
        w = OggOpusWriter(channels=1 if kind == "silk" else 2)
        for pkt in streams[kind][c]["packets"][:ENC_CPU_PACKETS]:
            w.write_packet(pkt)
        cpu.push(f"{kind}-{c}", w.close())
        cpu.end_stream(f"{kind}-{c}")
    cref = cpu.collect()
    cpu_s = time.perf_counter() - t0
    snrs = {}
    for kind, c in cpu_ids:
        g, w = pcm[first[(kind, c)]], cref[f"{kind}-{c}"]
        check(g.dtype == w.dtype and g.shape[0] == w.shape[0]
              and w.shape[1] >= ENC_CPU_PACKETS * 960 - 24 and g.shape[1] >= w.shape[1],
              f"[encode] {kind}-{c}: {g.shape} on the card, {w.shape} on the CPU")
        g = g[:, :w.shape[1]]
        bar = 100.0 if kind == "celt" else 90.0
        s_cpu = float(10 * np.log10(np.sum(w.astype(np.float64) ** 2)
                                    / max(np.sum((g.astype(np.float64) - w) ** 2), 1e-300)))
        check(s_cpu >= bar, f"[encode] {kind}-{c}: {s_cpu:.2f} dB against the CPU decode (bar {bar})")
        src = streams[kind][c]["source"].astype(np.float64) / 32768.0
        s_src = _best_lag_snr_db(src, g.T)
        check(np.isfinite(s_src) and np.any(g), f"[encode] {kind}-{c}: silent or non-finite")
        snrs[f"{kind}-{c}"] = dict(vs_cpu_db=min(s_cpu, 999.0), vs_source_db=s_src)
    audio = {k: sum(streams[kind][c]["source"].shape[0] for sid, (kind, c) in plan.items()
                    if (kind == "flac") == (k == "flac")) / RATE for k in ("flac", "opus")}
    res = dict(
        encoders=enc, native_python=agree, streams=len(plan),
        flac_streams=sum(k == "flac" for k, _ in plan.values()),
        opus_streams={kind: sum(k == kind for k, _ in plan.values()) for kind, _ in ENC_OPUS_MIX},
        audio_s=audio, push_s=push_s, collect_and_fetch_s=collect_s,
        fleet_xrealtime=sum(audio.values()) / (push_s + collect_s),
        launches=launches, check_s=time.perf_counter() - t_check, cpu_decode_s=cpu_s,
        min_opus_snr_vs_cpu_db=min(v["vs_cpu_db"] for v in snrs.values()),
        phase_s=time.perf_counter() - t_phase)
    for name, v in snrs.items():
        log(f"[encode] {name}: {json.dumps(v)}")
    log(f"[encode] {json.dumps(res)}")
    res["snr_db"] = snrs
    res["_packets"] = streams["celt"][0]["packets"]
    return res


def phase_frames(packets) -> dict:
    """One clip's Opus packets as v2 frames (``encode_frame``, CRC on)
    through ``simple.SoundKitFrameDecoder`` in FRAMES_CHUNK-byte pushes:
    the payloads equal the packets. Where the ``cryptography`` package is
    installed, encrypted frames (fixed nonces) and the ACE1 seal / open of
    every packet too."""
    import importlib.util

    from soundkit_tpu_torch import simple
    from soundkit_tpu_torch.core.audio_types import EncodingFlag
    from soundkit_tpu_torch.core.frame_header import FLAG_ENCRYPTED, FrameHeaderV2
    from soundkit_tpu_torch.core.frame_stream import encode_frame

    t_phase = time.perf_counter()

    def frames_of(payloads, flags=0):
        return b"".join(encode_frame(FrameHeaderV2(EncodingFlag.OPUS, len(p), 960, 48000, 2, 16,
                                                   id=i, bitrate=64000)
                                     .with_packet_flags(flags).with_packet_crc32(p), p)
                        for i, p in enumerate(payloads))

    def decode(dec, wire):
        out = []
        for i in range(0, len(wire), FRAMES_CHUNK):
            out += dec.push(wire[i:i + FRAMES_CHUNK])
        check(dec.flush() == [], "[frames] the decoder's flush returned frames")
        return out

    t0 = time.perf_counter()
    wire = frames_of(packets)
    frames = decode(simple.SoundKitFrameDecoder(), wire)
    plain_s = time.perf_counter() - t0
    check([f.payload for f in frames] == packets and [f.header.id for f in frames] == list(
        range(len(packets))) and not any(f.encrypted for f in frames),
        "[frames] the payloads differ from the packets")
    res = dict(frames=len(frames), bytes=len(wire), chunk=FRAMES_CHUNK, plain_s=plain_s,
               cryptography=importlib.util.find_spec("cryptography") is not None)
    if res["cryptography"]:
        from soundkit_tpu_torch.core.audio_content_crypto import AudioGroupMetadata
        from soundkit_tpu_torch.core.crypto import ChaCha20Poly1305PacketCipher

        key = "83843157117408337365446905028299378179116700186920144823595584430653437972238"
        cipher = ChaCha20Poly1305PacketCipher.new_from_decimal_key(key)
        t0 = time.perf_counter()
        sealed = [cipher.encrypt_nonce_prefixed(i.to_bytes(12, "big"), p, b"")
                  for i, p in enumerate(packets)]
        frames = decode(simple.SoundKitFrameDecoder(decimal_key=key),
                        frames_of(sealed, FLAG_ENCRYPTED))
        res["encrypted_s"] = time.perf_counter() - t0
        check([f.payload for f in frames] == packets and all(f.encrypted for f in frames)
              and [f.encrypted_payload_size for f in frames] == [len(s) for s in sealed],
              "[frames] the decrypted payloads differ from the packets")
        t0 = time.perf_counter()
        ace = simple.AudioContentCipher(bytes(range(1, 33)))
        for i, p in enumerate(packets):
            aad = AudioGroupMetadata(b"smoke", 1, 1, 7, 960 * i, 48000, 960, 1, 0, 0, 0, 2, 1, 2,
                                     0).associated_data()
            env = ace.seal(7, (i + 1).to_bytes(12, "little"), p, aad)
            check(env[:4] == b"ACE1" and ace.open(7, env, aad) == p,
                  f"[frames] ACE1 packet {i} does not open to itself")
        res["ace1_s"] = time.perf_counter() - t0
    else:
        log("[frames] the cryptography package is not installed: encrypted frames and ACE1 "
            "not run")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[frames] {json.dumps(res)}")
    return res

# ---------------------------------------------------------------------------
# the host Opus models, the batch walks and the two repairs
# ---------------------------------------------------------------------------

LEFT_SILK_ROUNDS = 8       # rounds of the host / device SILK check
# the host / device SILK floor: the JAX package's own pair of decoders reads
# 93.93 dB on the worst 8-round window of the WB clip (an LPC of high gain;
# 95 dB on its corpus clip), the port's 93.94, on the CPU
# (tests/test_torch_opus_host_models.py); 0.5 dB under the reference's
LEFT_SILK_FLOOR_DB = 93.4
LEFT_OPUS_LANES = 16       # BatchedOpusDecoder lanes a kind (CELT, SILK, hybrid)
LEFT_OPUS_PACKETS = 12     # packets a BatchedOpusDecoder lane carries
LEFT_AAC_PARTS = ((3, 4), (3, 6), (6, 6))  # the idle lane: (frames pushed, batches decoded)
LEFT_HYBRID_STREAMS = 16   # hybrid Ogg Opus streams through the fleet
LEFT_HYBRID_PACKETS = 20
LEFT_HYBRID_GAIN_Q8 = -768  # their OpusHeads' output gain (-3 dB); pre-skip 312
LEFT_FLAC_CLIP = "stereo16"
LEFT_FLAC_STRIDE = 4096


def leftover_wrappers():
    from soundkit_tpu_torch.ops import aac_batch as ab
    from soundkit_tpu_torch.ops import aac_entropy as ae
    from soundkit_tpu_torch.ops import celt_postfilter, flac_lpc, flac_rice, imdct, silk_synth

    return {"imdct_window": imdct.imdct_window, "spectral_decode": ae.spectral_decode,
            "tns_filter": ab.tns_filter, "flac_rice_plane": flac_rice.flac_rice_plane,
            "flac_frame": flac_lpc.flac_frame, "celt_postfilter": celt_postfilter.celt_postfilter,
            "silk_synth": silk_synth.silk_synth}


def _clip_frames(clip, start: int, n: int):
    """Packets ``start`` to ``start + n`` of an Opus clip split by their TOC:
    [(frame, TOC bandwidth, coded channels)]."""
    from soundkit_tpu_torch.codecs.opus_core import TOC_ATTRS

    out = []
    for pkt in clip.packets[start: start + n]:
        _, _, stereo, bw, code = TOC_ATTRS[pkt[0]]
        check(code == 0, f"{clip.name}: a packet of code {code}")
        out.append((pkt[1:], bw, 2 if stereo else 1))
    return out


def _masked_lane_snr(got, ref, lengths, start_aligned: bool):
    """Per-lane SNR in dB of ``got`` against ``ref`` ([rounds, lanes, C,
    960]) over each slot's valid samples; inf where they are equal."""
    import numpy as np

    F = got.shape[-1]
    pos = np.arange(F)
    valid = (pos[None, None] < lengths[..., None]) if start_aligned else \
        (pos[None, None] >= F - lengths[..., None])
    m = valid[:, :, None, :]
    sig = ((ref.astype(np.float64) ** 2) * m).sum(axis=(0, 2, 3))
    err = (((got.astype(np.float64) - ref) ** 2) * m).sum(axis=(0, 2, 3))
    with np.errstate(divide="ignore"):
        return 10 * np.log10(sig / err)


def leftovers_silk(lanes: int, device) -> dict:
    """The host ``BatchedSilkDecoder`` (native synthesis, numpy resampler)
    against the device ``BatchedSilkDeviceDecoder`` on ``lanes`` WB lanes
    of the ``[silk]`` clip for LEFT_SILK_ROUNDS rounds, lane i from packet
    7 i (mod the windows), pre-skip taken: lengths identical, every lane at
    LEFT_SILK_FLOOR_DB or better; the lanes under 95 dB are counted."""
    import numpy as np

    from soundkit_tpu_torch.models.opus_batch import BatchedSilkDecoder, BatchedSilkDeviceDecoder
    from soundkit_tpu_torch.tools import opus_fixtures as of

    clip = of.load_clips(names=("silk_wb",))[0]
    n = len(clip.packets) - LEFT_SILK_ROUNDS
    host, dev = BatchedSilkDecoder(lanes, 1), BatchedSilkDeviceDecoder(lanes, 1, device=device)
    for i in range(lanes):
        for m in (host, dev):
            m.configure_lane(i, clip.pre_skip, clip.output_gain)
            for frame, bw, coded in _clip_frames(clip, (7 * i) % n, LEFT_SILK_ROUNDS):
                m.push_packet(i, frame, bw, coded)
    t0 = time.perf_counter()
    hp, hl = host.decode_ready()
    t1 = time.perf_counter()
    dp, dl = dev.decode_ready(device_out=True)
    dp = dp.cpu().numpy()
    t2 = time.perf_counter()
    check(np.array_equal(hl, dl), "[leftovers] SILK: host and device lengths differ")
    check(hl.shape == (LEFT_SILK_ROUNDS, lanes) and hl[0].min() == 960 - clip.pre_skip,
          f"[leftovers] SILK: lengths {hl.shape}, first slot {hl[0].min()}")
    snr = _masked_lane_snr(dp, hp, hl, start_aligned=False)
    worst = float(snr.min())
    check(worst >= LEFT_SILK_FLOOR_DB,
          f"[leftovers] SILK: a lane at {worst:.2f} dB host against device")
    audio_s = float(hl.sum()) / RATE
    return dict(lanes=lanes, rounds=LEFT_SILK_ROUNDS, min_lane_snr_db=worst,
                lanes_under_95_db=int((snr <= 95.0).sum()),
                median_lane_snr_db=float(np.median(snr)),
                host_s=t1 - t0, device_s=t2 - t1, audio_s=audio_s,
                host_xrealtime=audio_s / (t1 - t0), device_xrealtime=audio_s / (t2 - t1))


def leftovers_opus_batch() -> dict:
    """``BatchedOpusDecoder`` on LEFT_OPUS_LANES lanes each of CELT, SILK
    and hybrid clips, every lane bit for bit the streaming
    ``OpusStreamDecoder`` on its bytes."""
    import numpy as np

    from soundkit_tpu_torch.codecs.opus import OpusStreamDecoder
    from soundkit_tpu_torch.models.opus_batch import BatchedOpusDecoder
    from soundkit_tpu_torch.tools import opus_fixtures as of

    by_kind = {"celt": of.load_clips(),
               "silk": of.load_clips(names=("silk_nb", "silk_mb", "silk_wb", "silk_wb_stereo")),
               "hybrid": of.load_clips(names=("hybrid_swb", "hybrid_fb"))}
    lanes = []
    for kind, clips in by_kind.items():
        for j in range(LEFT_OPUS_LANES):
            clip = clips[j % len(clips)]
            start = (5 * j) % (len(clip.packets) - LEFT_OPUS_PACKETS)
            pkts = clip.packets[start: start + LEFT_OPUS_PACKETS]
            raw = clip.head + b"".join(struct.pack("<H", len(p)) + p for p in pkts)
            lanes.append((kind, clip, raw))
    dec = BatchedOpusDecoder(len(lanes), C)
    for b, (_, _, raw) in enumerate(lanes):
        dec.push(b, raw)
    t0 = time.perf_counter()
    pcm, lengths = dec.decode_ready()
    t1 = time.perf_counter()
    check(pcm.shape == (LEFT_OPUS_PACKETS, len(lanes), C, 960), f"opus batch {pcm.shape}")
    for b, (kind, clip, raw) in enumerate(lanes):
        s = OpusStreamDecoder()
        want = np.concatenate([s.decode_f32(raw), s.flush()]).reshape(-1, clip.channels)
        got = np.concatenate([pcm[i, b, :clip.channels, :lengths[i, b]].T
                              for i in range(LEFT_OPUS_PACKETS)])
        check(got.shape == want.shape and np.array_equal(got, want),
              f"[leftovers] BatchedOpusDecoder lane {b} ({kind} {clip.name}) differs from "
              "the streaming decoder")
    t2 = time.perf_counter()
    audio_s = float(lengths.sum()) / RATE
    return dict(lanes=len(lanes), packets=LEFT_OPUS_PACKETS, audio_s=audio_s,
                batch_s=t1 - t0, stream_s=t2 - t1, batch_xrealtime=audio_s / (t1 - t0))


def leftovers_aac_idle(lanes: int, device) -> dict:
    """Lane 0 idles after KBD frames, for one batch and then three, beside
    ``lanes - 1`` lanes that never idle; against the same streams decoded
    gaplessly on ``device``: every lane within the bar ``[compare]`` holds
    the card to against the CPU (100 dB)."""
    import numpy as np

    from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
    from soundkit_tpu_torch.tools import aac_fixtures

    clips = aac_fixtures.load_clips()
    idle = clips[0][10:22]  # KBD-shaped frames
    total = sum(b for _, b in LEFT_AAC_PARTS)
    others = aac_fixtures.lane_streams(clips, lanes, total)
    ragged = BatchedAacLcDecoder(lanes, C, device=device)
    gapless = BatchedAacLcDecoder(lanes, C, device=device)
    for i in range(1, lanes):
        ragged.push(i, others[i])
        gapless.push(i, others[i])
    gapless.push(0, b"".join(idle))
    outs, shapes, pos = [], [], 0
    for n_frames, batches in LEFT_AAC_PARTS:
        ragged.push(0, b"".join(idle[pos: pos + n_frames]))
        pos += n_frames
        outs.append(ragged.decode_batches(batches))
        shapes.append(ragged.state[1][0].cpu().numpy())
    got = np.concatenate(outs)
    want = gapless.decode_batches(total)
    check(all((s == 1).all() for s in shapes[:2]), f"[leftovers] AAC: shapes kept {shapes}")
    live, gone, t = [], [], 0
    for n_frames, batches in LEFT_AAC_PARTS:
        live += list(range(t, t + n_frames))
        gone += list(range(t + n_frames, t + batches))
        t += batches
    check(not got[gone, 0].any(), "[leftovers] AAC: an idle batch gave samples")
    # lane 0's decoded batches against its gapless frames, the other lanes whole
    pairs = [(got[live, 0], want[:len(live), 0])] + [(got[:, i], want[:, i])
                                                     for i in range(1, lanes)]
    sig = np.array([(w.astype(np.float64) ** 2).sum() for _, w in pairs])
    err = np.array([((g.astype(np.float64) - w) ** 2).sum() for g, w in pairs])
    with np.errstate(divide="ignore"):
        snr = 10 * np.log10(sig / err)
    check(bool((sig > 0).all()), "[leftovers] AAC: a silent lane")
    worst = float(snr.min())
    check(worst >= 100.0, f"[leftovers] AAC: a lane at {worst:.2f} dB against its gapless decode")
    return dict(lanes=lanes, batches=total, idle_batches=len(gone), min_lane_snr_db=worst,
                idle_lane_snr_db=float(snr[0]),
                idle_lane_max_abs_err=float(np.abs(pairs[0][0] - pairs[0][1]).max()),
                bit_exact_lanes=int((err == 0).sum()))


def leftovers_hybrid_fleet(device) -> dict:
    """LEFT_HYBRID_STREAMS hybrid Ogg Opus streams whose OpusHeads carry a
    312-sample pre-skip and a LEFT_HYBRID_GAIN_Q8 gain, through a
    ``StreamFleet`` in two pushes with a collect after each: every stream's
    length and samples those of the host ``OggOpusDecoder`` on its bytes,
    at 90 dB and 1 LSB."""
    import numpy as np

    from soundkit_tpu_torch.codecs.opus import OggOpusDecoder
    from soundkit_tpu_torch.models.fleet import StreamFleet
    from soundkit_tpu_torch.tools import opus_fixtures as of

    clips = of.load_clips(names=("hybrid_swb", "hybrid_fb"))
    streams = {}
    for j in range(LEFT_HYBRID_STREAMS):
        clip = clips[j % 2]
        head = clip.head[:16] + struct.pack("<h", LEFT_HYBRID_GAIN_Q8) + clip.head[18:]
        start = (11 * j) % (len(clip.packets) - LEFT_HYBRID_PACKETS)
        streams[f"h{j}"] = (clip, of.ogg_stream(head, clip.packets[start: start + LEFT_HYBRID_PACKETS]))
    fleet = StreamFleet(LEFT_HYBRID_STREAMS, device=device)
    parts = {sid: [] for sid in streams}
    t0 = time.perf_counter()
    for half in range(2):
        for sid, (_, data) in streams.items():
            fleet.push(sid, data[len(data) * half // 2: len(data) * (half + 1) // 2])
            if half:
                fleet.end_stream(sid)
        for sid, pcm in fleet.collect().items():
            parts[sid].append(pcm)
    fleet_s = time.perf_counter() - t0
    check(not fleet._lanes, "[leftovers] hybrid fleet: streams left")
    worst, worst_lsb = float("inf"), 0
    for sid, (clip, data) in streams.items():
        got = np.concatenate(parts[sid], axis=1).T
        if clip.channels == 1:
            check(np.array_equal(got[:, 0], got[:, 1]), f"{sid}: a mono stream's channels differ")
            got = got[:, :1]
        d = OggOpusDecoder()
        want = np.concatenate([d.decode_f32(data), d.flush()]).reshape(-1, clip.channels)
        check(got.shape == want.shape == (LEFT_HYBRID_PACKETS * 960 - clip.pre_skip, clip.channels),
              f"[leftovers] hybrid {sid}: {got.shape} against {want.shape}")
        g, w = got.astype(np.float64), want.astype(np.float64)
        worst = min(worst, 10 * np.log10((w ** 2).sum() / max(((g - w) ** 2).sum(), 1e-300)))
        q = lambda x: np.clip(np.round(x * 32768.0), -32768, 32767)  # noqa: E731
        worst_lsb = max(worst_lsb, int(np.abs(q(g) - q(w)).max()))
    check(worst >= 90.0 and worst_lsb <= 1,
          f"[leftovers] hybrid fleet: {worst:.2f} dB, {worst_lsb} LSB against the host decoder")
    return dict(streams=LEFT_HYBRID_STREAMS, packets=LEFT_HYBRID_PACKETS,
                gain_q8=LEFT_HYBRID_GAIN_Q8, min_snr_db=worst, max_lsb=worst_lsb,
                fleet_s=fleet_s)


def leftovers_flac_segs(device) -> dict:
    """One clip's ``FlacSegsStream`` walk through K8 and K9 on ``device``:
    the plane and the samples bit for bit their plain versions on the same
    tensors, and the samples those of the host FLAC decoder."""
    import numpy as np
    import torch

    from soundkit_tpu_torch.codecs.flac import FlacDecoder, FlacSegsStream
    from soundkit_tpu_torch.ops import flac_lpc, flac_rice
    from soundkit_tpu_torch.tools import flac_fixtures

    clip = flac_fixtures.load_clips()[flac_fixtures.CLIPS.index(LEFT_FLAC_CLIP)]
    data = clip.header + b"".join(clip.frames)
    walk = FlacSegsStream(LEFT_FLAC_STRIDE)
    walk.feed(data)
    items = []
    while (it := walk.next()) is not None:
        items.append(it)
    check(items and all(it[0] == "segs" for it in items), "[leftovers] FLAC: not a segment walk")
    n, S = len(items), LEFT_FLAC_STRIDE
    meta = np.stack([it[1] for it in items])
    xmeta = np.stack([it[4] for it in items])
    W = max(-(-len(it[6]) // 4) for it in items)
    words = np.zeros((n, 4 * W), np.uint8)
    for i, it in enumerate(items):
        words[i, :len(it[6])] = np.frombuffer(it[6], np.uint8)
    words = words.view(">u4").astype(np.uint32).view(np.int32)
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    rice_in = (t(words), *map(t, flac_rice.seg_wire([it[5] for it in items], S)),
               t(np.stack([it[3] for it in items])), t(xmeta[:, [0, 2]]), t(xmeta[:, [1, 3]]))
    plane = flac_rice.flac_rice_plane(*rice_in, S)
    plain_plane = flac_rice.flac_rice_plane_plain(*rice_in, S)
    check(torch.equal(plane, plain_plane), "[leftovers] FLAC: K8 differs from its plain version")
    lpc_in = (t(np.stack([it[2] for it in items])), t(meta[:, [4, 7]]), t(meta[:, [5, 8]]),
              t(meta[:, [6, 9]]), t(meta[:, 2]), t(meta[:, 0]),
              torch.ones(n, dtype=torch.bool, device=device))
    out = flac_lpc.flac_frame(plane, *lpc_in)
    check(torch.equal(out, flac_lpc.flac_frame_plain(plane, *lpc_in)),
          "[leftovers] FLAC: K9 differs from its plain version")
    out = out.cpu().numpy()
    chans = int(meta[0, 1])
    got = np.concatenate([out[i, :chans, :meta[i, 0]] for i in range(n)], axis=1).T.reshape(-1)
    audio = FlacDecoder().add(data)
    want = np.frombuffer(audio.data, "<i2").astype(np.int32)
    check(np.array_equal(got, want), "[leftovers] FLAC: samples differ from the host decoder")
    return dict(clip=LEFT_FLAC_CLIP, frames=n, segments=int(sum(it[5].shape[0] for it in items)),
                samples=int(got.size // chans))


def phase_leftovers(card: str, lanes: int = B, device: str = "cuda") -> dict:
    """The host Opus models, the FLAC segment walk and the two repairs of
    this slice: the host ``BatchedSilkDecoder`` against the device one, the
    per-lane ``BatchedOpusDecoder`` against the streaming decoder, an AAC
    lane idling after a KBD frame (K1, K4, K5) against its gapless decode,
    hybrid streams' pre-skip and gain through a ``StreamFleet`` (K11, K12),
    and a ``FlacSegsStream`` clip through K8 and K9. Launch counters reset
    just before; every kernel of the phase launched on the card."""
    import torch

    dev = torch.device(device)
    wrappers = leftover_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t_phase = time.perf_counter()
    res = {"silk": leftovers_silk(lanes, dev), "opus_batch": leftovers_opus_batch(),
           "aac_idle": leftovers_aac_idle(lanes, dev), "hybrid_fleet": leftovers_hybrid_fleet(dev),
           "flac_segs": leftovers_flac_segs(dev)}
    res["launches"] = {n: w.launches for n, w in wrappers.items()}
    if dev.type == "cuda":
        for n, k in res["launches"].items():
            check(k > 0, f"[leftovers] {n} was not launched")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[leftovers] {card}: {json.dumps(res)}")
    return res


def main() -> int:
    if not (ROOT / "soundkit_tpu_torch").is_dir() or not (ROOT / "tests" / "data" / "torch_port").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    t_start = time.perf_counter()
    phase_s = {}  # the wall seconds of each phase, in order
    marks = [("build", t_start)]

    def enter(name: str) -> str:
        now = time.perf_counter()
        last, since = marks[-1]
        phase_s[last] = phase_s.get(last, 0.0) + now - since
        marks.append((name, now))
        return name

    phase = "build"
    try:
        phase_build()
        phase = enter("card")
        card = phase_card()

        from soundkit_tpu_torch.native import AacHostParser
        from soundkit_tpu_torch.tools.aac_fixtures import batch_aus, clip_aus, load_clips

        clips = load_clips()
        aus = clip_aus(clips)
        parser = AacHostParser(3)  # 48 kHz
        wires = []
        for t in range(N_COMPARE):
            buf, overflow = parser.pack_v4(batch_aus(aus, B, t))
            check(not overflow, f"v4 overflow on smoke batch {t}")
            wires.append(buf)

        phase = enter("kernels")
        kres = phase_kernels(wires[0])
        phase = enter("compare")
        cres = phase_compare(wires)
        phase = enter("slice")
        sres = phase_slice(clips)
        phase = enter("tel-kernels")
        tkres = phase_tel_kernels()
        phase = enter("tel-compare")
        tcres = phase_tel_compare()
        phase = enter("telephony")
        tres, tlaunches = phase_telephony()
        phase = enter("flac-kernels")
        fkres = phase_flac_kernels()
        phase = enter("flac-compare")
        fcres = phase_flac_compare()
        phase = enter("flac")
        fres = phase_flac(fkres["flac_frame"]["rounds"])
        phase = enter("mp3-kernels")
        mkres = phase_mp3_kernels()
        phase = enter("mp3-compare")
        mcres = phase_mp3_compare()
        phase = enter("mp3")
        mres = phase_mp3()
        phase = enter("celt-kernels")
        ckres = phase_celt_kernels()
        phase = enter("celt-compare")
        ccres = phase_celt_compare()
        phase = enter("celt")
        celtres = phase_celt()
        phase = enter("silk-kernels")
        skres = phase_silk_kernels()
        phase = enter("silk-compare")
        scres = phase_voice_compare("silk")
        phase = enter("hybrid-compare")
        hcres = phase_voice_compare("hybrid")
        phase = enter("silk")
        silkres = phase_voice("silk")
        phase = enter("hybrid")
        hybres = phase_voice("hybrid")
        phase = enter("vorbis-kernels")
        vkres = phase_vorbis_kernels()
        phase = enter("vorbis-compare")
        vcres = phase_vorbis_compare()
        phase = enter("vorbis")
        vres = phase_vorbis()
        phase = enter("flac-enc-kernels")
        enc_lanes = flac_enc_lanes()
        ekres = phase_flac_enc_kernels(enc_lanes)
        phase = enter("flac-enc-compare")
        ecres = phase_flac_enc_compare()
        phase = enter("flac-enc")
        eres = phase_flac_enc(enc_lanes)
        phase = enter("resample-kernels")
        rkres = phase_resample_kernels()
        phase = enter("transcode")
        trres = phase_transcode()
        phase = enter("stretch-kernels")
        st_lanes = stretch_lanes()
        stkres = phase_stretch_kernels(st_lanes)
        phase = enter("stretch")
        stres = phase_stretch(st_lanes)
        del st_lanes
        phase = enter("fleet")
        flres = phase_fleet()
        phase = enter("pipeline")
        pres = phase_pipeline(card)
        phase = enter("containers")
        cnres = phase_containers()
        phase = enter("encode")
        enres = phase_encode()
        phase = enter("frames")
        frres = phase_frames(enres.pop("_packets"))
        phase = enter("leftovers")
        lres = phase_leftovers(card)
        enter("report")
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
        return 1

    src = "soundkit_tpu_torch/csrc/"
    # (name, source, TPU function it replaces, on the AAC path)
    rows = [
        ("spectral_decode", "aac_spectral.cu", "soundkit_tpu/ops/aac_entropy.py:156", True),
        ("tns_filter", "tns.cu", "soundkit_tpu/ops/aac_batch.py:218", True),
        ("imdct_window", "imdct_window.cu", "soundkit_tpu/ops/pallas_kernels.py:98", True),
        ("dequant_imdct_window", "imdct_window.cu", "soundkit_tpu/ops/pallas_kernels.py:138", False),
    ]
    kernels = [
        dict(name=n, route="cuda", source=src + s, replaces=r, on_path=on_path,
             launches=sres["launches"][n], launches_per_step=sres["launches"][n] / N_BATCHES,
             **kres[n])
        for n, s, r, on_path in rows
    ]
    tel_rows = [
        ("g711_decode", "g711.cu", "soundkit_tpu/ops/pallas_kernels.py:62", ("g711_decode",)),
        ("g726_scan", "g726.cu", "soundkit_tpu/ops/adpcm.py:369",
         ("g726_decode_scan", "g726_encode_scan")),
        ("g722_scan", "g722.cu", "soundkit_tpu/ops/g722.py:284",
         ("g722_decode_scan", "g722_encode_scan")),
    ]
    # decoder steps of the kernel's codecs, and encoder steps where it encodes too
    steps = {n: sum(r["steps"] + (r["enc_steps"] if n != "g711_decode" else 0)
                    for codec, r in tres.items() if codec.startswith(n.split("_")[0]))
             for n, *_ in tel_rows}
    kernels += [
        dict(name=n, route="cuda", source=src + s, replaces=r, on_path=True,
             launches=sum(tlaunches[w] for w in ws),
             launches_per_step=sum(tlaunches[w] for w in ws) / steps[n],
             launches_by_wrapper={w: tlaunches[w] for w in ws}, **tkres[n])
        for n, s, r, ws in tel_rows
    ]
    flac_rows = [
        ("flac_rice_plane", "flac_rice.cu", "soundkit_tpu/ops/flac_rice.py:127"),
        ("flac_frame", "flac_lpc.cu", "soundkit_tpu/ops/flac_lpc.py:36"),
    ]
    kernels += [
        dict(name=n, route="cuda", source=src + s, replaces=r, on_path=True,
             launches=fres["launches"][n], launches_per_step=fres["launches"][n] / FLAC_ROUNDS,
             **fkres[n])
        for n, s, r in flac_rows
    ]
    kernels.append(dict(
        name="mp3_synth", route="cuda", source=src + "mp3_synth.cu",
        replaces="soundkit_tpu/ops/mp3_batch.py:320", on_path=True,
        launches=mres["launches"]["mp3_synth"],
        launches_per_step=mres["launches"]["mp3_synth"] / mres["granule_steps"],
        **mkres["mp3_synth"]))
    kernels.append(dict(
        name="celt_postfilter", route="cuda", source=src + "celt_postfilter.cu",
        replaces="soundkit_tpu/ops/celt_batch.py:108", on_path=True,
        launches=celtres["launches"]["celt_postfilter"],
        launches_per_step=celtres["k11_launches_per_round"],
        hybrid_launches=hybres["launches"]["celt_postfilter"], **ckres["celt_postfilter"]))
    kernels.append(dict(
        name="silk_synth", route="cuda", source=src + "silk_synth.cu",
        replaces="soundkit_tpu/ops/silk_batch.py:141", on_path=True,
        launches=silkres["launches"]["silk_synth"] + hybres["launches"]["silk_synth"],
        launches_by_phase={"silk": silkres["launches"]["silk_synth"],
                           "hybrid": hybres["launches"]["silk_synth"]},
        launches_per_step=silkres["k12_launches_per_round"], **skres["silk_synth"]))
    kernels.append(dict(
        name="vorbis_overlap", route="cuda", source=src + "vorbis_overlap.cu",
        replaces="soundkit_tpu/ops/vorbis_batch.py:102", on_path=True,
        launches=vres["launches"]["vorbis_overlap"],
        launches_per_step=vres["k13_launches_per_round"], **vkres["vorbis_overlap"]))
    kernels.append(dict(
        name="flac_analyze", route="cuda", source=src + "flac_analyze.cu",
        replaces="soundkit_tpu/ops/flac_enc_batch.py:62", on_path=True,
        launches=eres["launches"]["flac_analyze"],
        launches_per_step=eres["launches"]["flac_analyze"] / eres["device_calls"],
        **ekres["flac_analyze"]))
    stretch_launches = {k: sum(r["launches"][k] for r in stres.values())
                        for k in ("polyphase_fir", "overlap_add", "phase_lock")}
    kernels.append(dict(
        name="polyphase_fir", route="cuda", source=src + "resample.cu",
        replaces="soundkit_tpu/ops/resample.py:154", on_path=True,
        launches=trres["launches"]["polyphase_fir"] + stretch_launches["polyphase_fir"],
        launches_by_phase={"transcode": trres["launches"]["polyphase_fir"],
                           "stretch": stretch_launches["polyphase_fir"]},
        launches_per_step=trres["launches"]["polyphase_fir"] / trres["checked_chunks"],
        **rkres["polyphase_fir"]))
    kernels.append(dict(
        name="overlap_add", route="cuda", source=src + "stretch_ola.cu",
        replaces="soundkit_tpu/ops/stretch.py:294", on_path=True,
        launches=stretch_launches["overlap_add"],
        launches_per_step=stretch_launches["overlap_add"] / len(stres), **stkres["overlap_add"]))
    kernels.append(dict(
        name="phase_lock", route="cuda", source=src + "phase_lock.cu",
        replaces="soundkit_tpu/ops/stretch.py:262", on_path=True,
        launches=stretch_launches["phase_lock"],
        launches_per_step=stretch_launches["phase_lock"] / len(stres), **stkres["phase_lock"]))
    for k in kernels:
        k["fleet_launches"] = flres["mixed"]["lane_launches"].get(k["name"], 0)
        if k["name"] in flres["mixed"]["fallback_launches"]:
            k["fleet_fallback_launches"] = flres["mixed"]["fallback_launches"][k["name"]]
    # the [encode] fleet's launches: FLAC lanes (K8, K9), Opus lanes (K11, K12)
    for k in kernels:
        if k["name"] in enres["launches"]:
            k["encode_launches"] = enres["launches"][k["name"]]
    # the [leftovers] phase's launches: the idle AAC lane (K1, K4, K5), the
    # SILK decoders (K12), the hybrid fleet (K11, K12), the FLAC walk (K8, K9)
    for k in kernels:
        if k["name"] in lres["launches"]:
            k["leftovers_launches"] = lres["launches"][k["name"]]
    # DecodePipeline only decodes; the encoders that built its telephony
    # streams are counted apart
    pipe_by_row = {"g711_decode": ("g711_decode", None),
                   "g726_scan": ("g726_decode_scan", "g726_encode_scan"),
                   "g722_scan": ("g722_decode_scan", "g722_encode_scan"),
                   "mp3_synth": ("mp3_synth", None)}
    for k in kernels:
        if k["name"] in pipe_by_row:
            dec, enc = pipe_by_row[k["name"]]
            k["pipeline_launches"] = pres["launches"][dec]
            if dec == "g711_decode":  # of which the AIFF-C streams' (one at each file's end)
                k["pipeline_aifc_launches"] = sum(
                    r.get("k3_launches", 0) for r in pres["formats"].values())
            if enc:
                k["stream_encoder_launches"] = pres["encoder_launches"][enc]
    log(json.dumps({"slice": sres, "compare": cres, "telephony": tres,
                    "telephony_compare": tcres, "flac": fres, "flac_compare": fcres,
                    "mp3": mres, "mp3_compare": mcres, "celt": celtres, "celt_compare": ccres,
                    "silk": silkres, "silk_compare": scres, "hybrid": hybres,
                    "hybrid_compare": hcres, "vorbis": vres, "vorbis_compare": vcres,
                    "flac_enc": eres, "flac_enc_compare": ecres,
                    "transcode": trres, "stretch": stres,
                    "fleet": flres, "pipeline": pres, "containers": cnres,
                    "encode": enres, "frames": frres, "leftovers": lres,
                    "phase_wall_s": phase_s, "wall_s": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
