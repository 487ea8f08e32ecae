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
over the six decoders (1024 lanes a group). Phases:

a. build the CUDA kernels (one ``nvcc`` a source, all started together),
   the host parser, the FLAC walk, the MP3 parser, the Opus parse (CELT,
   SILK, hybrid glue), the Vorbis packet parse and the FLAC frame packer
   from the checkout;
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
   plain version on the card on the CELT path's next round (1024 ragged
   fixture lanes, C = 2, after three decoded rounds, with the decoder's
   carried state; the timed case), and on seeded random frames of 1024
   streams at C = 2 and C = 1 (periods 15..1022 and the edge periods,
   all three tapsets, zero and non-zero gains, invalid streams); bound
   1e-5 of the largest plain value on the PCM and each state, invalid
   streams bit-equal; beside the bound, on the log line only, the chain
   floor estimated from the code;
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
   round) against its plain version on the card, bit-exact: on the
   [silk] path's WB round after three decoded rounds (1024 lanes of the
   [silk] mix x 2 rows, with the decoder's carried state; the timed
   case), and on seeded random rounds of 1024 streams at NB, MB and WB,
   C = 2 and 1 (lags at both ends of the range, voiced and unvoiced rows,
   lead-in, invalid and all-zero lanes); beside the bound, the chain
   floor and the issue floor of the LPC recursion, estimated;
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
   beside its bound and ``F.conv1d``;
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
   ``nearest`` identical to the plain version's and its spectrum within 3
   ulps of the rotation's argument, and K16 (``overlap_add``) bit-exact on
   the irfft of K17's spectrum; both timed by graph replay with their byte
   bounds, K16 beside ``F.fold``;
dd. stretch: ``pitch_shift_batch_device`` over 1024 mono lanes of 2 s at
   44.1 kHz (the stereo44 fixture decoded on the card and downmixed, lane
   i from its own offset), time ratio 1.25, pitch 1.5, with
   ``formant_scale`` None and 1.0: K15, K16 and K17 once a call, four
   lanes held to the float64 host ``stretch_pitch`` (40 dB; 25 dB with
   the formant warp), x realtime, peak device memory and the device time
   by operation (``torch.profiler``: FFTs, cumsum, K15-K17, glue); one
   ``[stretch]`` line each;
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
   100 dB and Vorbis >= 120 dB under the same rounds), refused streams
   (a 22.05 kHz mono Ogg Vorbis stream after the group's topology is
   fixed, GSM, an Ogg Opus SILK stream that switches from NB to WB) must
   raise ``FleetUnsupported``, and every kernel of the six groups must
   have launched; then an ``out_bits=16`` collect against the quantized
   bare output (Opus CELT on the i16 spectral wire), and per group a
   fleet serving that group alone, its x realtime beside the bare model's
   on the same bytes; one ``[fleet]`` line;
ff. print the kernels' JSON line (all seventeen kernels, K2 with no
   launch: it is not on a path), then the result line.

Any failed phase exits non-zero before the result line. Without a
CUDA device, or outside a checkout of the repository, it exits 1
without a result.
"""
from __future__ import annotations

import json
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
K11_EM_CYCLES = 8      # dependent cycles a block of the de-emphasis memory (a multiply, an add)
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
    from soundkit_tpu_torch import _build

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
    _build.kernels()
    log(f"[build] kernels {kpath.relative_to(ROOT)} in {t1 - t0:.3f} s; "
        f"parser {ppath.relative_to(ROOT)} in {t2 - t1:.3f} s; "
        f"FLAC walk {fpath.relative_to(ROOT)} in {t3 - t2:.3f} s; "
        f"MP3 parser {mpath.relative_to(ROOT)} in {t4 - t3:.3f} s; "
        f"Opus parse {cpath.relative_to(ROOT)} in {t5 - t4:.3f} s; "
        f"Vorbis parse {vpath.relative_to(ROOT)} in {t6 - t5:.3f} s; "
        f"FLAC packer {epath.relative_to(ROOT)} in {t7 - t6:.3f} s")
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
    return dict(min_pcm_snr_db=worst, lanes=live, state_rel_err=float(state_rel),
                card_s=t1 - t0, cpu_s=t2 - t1)


def mp3_wrappers():
    from soundkit_tpu_torch.ops import mp3_synth

    return {"mp3_synth": mp3_synth.mp3_granule_packed}


def mp3_step_profile() -> dict:
    """Device operations a granule step runs at B = 1024 (kernels, and
    the collect's copies spread over its granules), and the device time
    a step of the kernels and of the copies in ms, by ``torch.profiler``
    over one 4-granule decode."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.tools import mp3_fixtures as mf

    model = BatchedMp3Decoder(B, C, device="cuda")
    for i, data in enumerate(mf.lane_streams(mf.load_clips(), B, 4)):
        model.push(i, data)
    model.decode_batches(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_batches(4)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
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
    slowest valid stream (``min(32, Tmin - 2)`` samples a step) at
    K11_STEP_CYCLES, then the 120 blocks of the de-emphasis memory at
    K11_EM_CYCLES, at SM_CLOCK."""
    import torch

    periods = comb[:, [0, 1, 8, 9]].cpu().to(torch.int32).clamp(15, 1024)
    step = (periods.min(dim=1).values - 2).clamp(max=32)[valid.cpu()]
    steps = int((-(-960 // step)).max()) if step.numel() else 0
    return 1e3 * (steps * K11_STEP_CYCLES + 120 * K11_EM_CYCLES) / SM_CLOCK


def phase_celt_kernels():
    """K11 against its plain version on the card: on the [celt] path's
    round after CELT_WARM decoded rounds (B = 1024 ragged fixture lanes,
    C = 2, the decoder's carried state; the timed case), and on seeded
    random frames of B streams at C = 2 and C = 1 (periods 15..1022 and
    the edge periods, all three tapsets, zero and non-zero gains, a mix
    of valid and invalid streams). Bound 1e-5 of the largest plain value
    on the PCM and each state; invalid streams bit-equal."""
    import torch

    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    inputs = kc.celt_fixture_inputs(B, dev, warm=CELT_WARM)
    nbytes, flops = kc.celt_postfilter_work(inputs)
    kernel, plain = kc.celt_postfilter_pair(inputs)
    r = measure("celt_postfilter", "celt_postfilter", kernel, plain, nbytes=nbytes, flops=flops,
                plain_reps=3)
    got, ref = kernel(), plain()
    kc.celt_invalid_passthrough(got, inputs)
    hist_exact = bool(torch.equal(got[2], ref[2]))
    full, comb, valid = inputs[:3]
    chain_ms = k11_chain_floor_ms(comb, valid)
    rand = {}
    for c in (2, 1):
        rin = tuple(t.to(dev) for t in kc.celt_postfilter_random_inputs(20 + c, streams=B, channels=c))
        k, p = kc.celt_postfilter_pair(rin)
        rand[c] = kc.compare("celt_postfilter", k, p)
        kc.celt_invalid_passthrough(k(), rin)
    postfilter = int(((comb[:, 2:8] != 0).any(1) | (comb[:, 10:16] != 0).any(1))[valid].sum())
    r.update(streams=B, valid_streams=int(valid.sum()), postfilter_streams=postfilter,
             path_rel_err=r["rel_err"], random_rel_err=max(x["rel_err"] for x in rand.values()),
             max_abs_err=max(r["max_abs_err"], *(x["max_abs_err"] for x in rand.values())),
             rel_err=max(r["rel_err"], *(x["rel_err"] for x in rand.values())))
    log(f"[celt-kernels] celt_postfilter: path {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms), "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {nbytes} bytes, {flops} FLOP), chain "
        f"floor ~{chain_ms:.4f} ms (estimated); {r['valid_streams']} of {B} streams valid, "
        f"{postfilter} with the postfilter on; max rel err: path {r['path_rel_err']:.2e} (comb "
        f"and history bit-exact: {hist_exact}), random {B} streams C = 2 {rand[2]['rel_err']:.2e}, "
        f"C = 1 {rand[1]['rel_err']:.2e} (bound {kc.REL_BOUND['celt_postfilter']}); invalid "
        f"streams passed through bit-equal")
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
    import torch
    from torch.profiler import ProfilerActivity, profile

    from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder
    from soundkit_tpu_torch.tools import opus_fixtures as of

    model = BatchedCeltDecoder(B, C, device="cuda")
    for i, data in enumerate(of.lane_raw(of.load_clips(), B, 5)):
        model.push(i, data)
    model.decode_ready(max_packets=1, device_out=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_ready(max_packets=4, device_out=True)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
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
    """K12 against its plain version on the card, bit-exact: on the
    [silk] path's WB round after SILK_WARM decoded rounds (B = 1024
    lanes of the [silk] mix x 2 rows: the WB launch runs over every lane;
    the timed case), and on seeded random rounds of B streams at each
    bandwidth, C = 2 and 1 (lags at both ends, voiced and unvoiced rows,
    lead-in, invalid and all-zero lanes)."""
    import torch

    from soundkit_tpu_torch.tools import kernel_check as kc

    dev = torch.device("cuda", 0)
    inputs = kc.silk_fixture_inputs(B, dev, warm=SILK_WARM, bw=2, names=SILK_MIX)
    nbytes, flops = kc.silk_synth_work(2, inputs)
    kernel, plain = kc.silk_synth_pair(2, inputs)
    r = measure("silk_synth", "silk_synth", kernel, plain, nbytes=nbytes, flops=flops, plain_reps=2)
    chain_ms, issue_ms = k12_floors_ms(2)
    rand = {}
    for bw in (0, 1, 2):
        for c in (2, 1):
            k, p = kc.silk_synth_random_case(dev, 30 + bw, bw, streams=B, channels=c)
            rand[f"bw{bw}_c{c}"] = kc.compare("silk_synth", k, p)
        k, _ = kc.silk_synth_random_case(dev, 30 + bw, bw, streams=B, channels=2)
        rand[f"bw{bw}_ms"] = graph_ms(k)
    voiced = int((inputs[4] != 0).sum())
    r.update(streams=B, rows=2 * B, voiced_rows=voiced, chain_floor_ms=chain_ms,
             issue_floor_ms=issue_ms, random_nb_ms=rand["bw0_ms"], random_mb_ms=rand["bw1_ms"],
             random_wb_ms=rand["bw2_ms"],
             max_abs_err=max(r["max_abs_err"], *(x["max_abs_err"] for k_, x in rand.items()
                                                 if not k_.endswith("_ms"))))
    log(f"[silk-kernels] silk_synth: path (WB, {B} streams x 2 rows, {voiced} voiced) "
        f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms), bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}; {nbytes} bytes, {flops} FLOP), chain floor ~{chain_ms:.4f} ms, issue "
        f"floor ~{issue_ms:.4f} ms (estimated); random rounds NB {rand['bw0_ms']:.4f}, MB "
        f"{rand['bw1_ms']:.4f}, WB {rand['bw2_ms']:.4f} ms; bit-exact on the path and on random "
        f"rounds at every bandwidth, C = 2 and 1")
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
    import torch
    from torch.profiler import ProfilerActivity, profile

    model, frames = voice_model(kind, "cuda", n_packets=12 if kind == "silk" else 24)
    for i, fr in enumerate(frames):
        for frame, bw, coded in fr:
            model.push_packet(i, frame, bw, coded)
    model.decode_ready(max_packets=1 if kind == "silk" else 8, device_out=True)
    torch.cuda.synchronize()
    steps = 4 if kind == "silk" else 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_ready(max_packets=4 if kind == "silk" else 8, device_out=True)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
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
    import torch
    from torch.profiler import ProfilerActivity, profile

    from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder
    from soundkit_tpu_torch.tools import vorbis_fixtures as vf

    model = BatchedVorbisDecoder(B, device="cuda")
    for i, data in enumerate(vf.lane_streams(vf.load_clips(names=vf.STEREO), B, 1)):
        model.push(i, data)
    model.decode_batches(1, device_out=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_batches(4, device_out=True)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
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


def k15_timed(x, in_rate: int, out_rate: int, hist=None, reps: int = 20) -> dict:
    """K15 on ``x`` (and ``hist``) held to its plain version and timed by
    graph replay, beside the plain version, ``F.conv1d`` (cuDNN, IEEE
    float32) and the bound of its work (``kernel_check.resample_work``)."""
    from soundkit_tpu_torch.ops import resample as rs
    from soundkit_tpu_torch.tools import kernel_check as kc

    kernel, plain = kc.resample_pair(x, in_rate, out_rate, hist)
    r = kc.compare("polyphase_fir", kernel, plain)
    _, _, L, M = rs.design_polyphase(in_rate, out_rate)
    rows, n = x.shape
    n_out = rs.out_len(n, L, M)
    nbytes, flops = kc.resample_work(rows, n, n_out, L, hist is not None)
    r["ms"] = graph_ms(kernel, reps=reps)
    r["plain_ms"] = cuda_ms(plain, 5)
    r["library_ms"] = graph_ms(kc.conv1d_library(x, in_rate, out_rate, hist), reps=reps)
    r.update(bound(nbytes, flops))
    r.update(rows=rows, n=n, n_out=n_out, L=L, M=M, tile_cycles=rs.tile_cycles(L, M, -(-n_out // L)),
             share_of_bound=r["bound_ms"] / r["ms"])
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
        log(f"[resample-kernels] polyphase_fir {tag} [{c['rows']}, {c['n']}] -> {c['n_out']} "
            f"(L {c['L']}, M {c['M']}, {c['tile_cycles']} cycles a block): {c['ms']:.4f} ms by "
            f"graph replay, plain {c['plain_ms']:.4f}, F.conv1d {c['library_ms']:.4f}, bound "
            f"{c['bound_ms']:.4f} ({c['bound_by']}), {100 * c['share_of_bound']:.1f} % of it; "
            f"max|d| {c['max_abs_err']:.3g}")
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
    version and its spectrum within 3 ulps of the rotation's argument; K16
    bit-exact on the irfft of K17's spectrum; both timed by graph replay,
    with their byte bounds, K16 beside ``F.fold``."""
    import torch

    from soundkit_tpu_torch.ops import phase_lock
    from soundkit_tpu_torch.ops import stretch as st
    from soundkit_tpu_torch.tools import kernel_check as kc

    mag, phase, syn, win, hop, target = st.vocoder_analysis(x, STRETCH_RATIO * STRETCH_PITCH)
    r17 = kc.phase_lock_check(mag, phase, syn)
    rows, K = mag.numel() // mag.shape[-1], mag.shape[-1]
    r17["ms"] = graph_ms(lambda: phase_lock.phase_lock(mag, phase, syn), reps=2, replays=5)
    r17["plain_ms"] = cuda_ms(lambda: phase_lock.phase_lock_plain(mag, phase, syn), 1)
    r17.update(bound(kc.phase_lock_work(rows, K)), library_ms=None, rows=rows, K=K,
               syn_abs_max=float(syn.abs().max()))
    r17["share_of_bound"] = r17["bound_ms"] / r17["ms"]
    spec = phase_lock.phase_lock(mag, phase, syn)
    del mag, phase, syn
    frames = torch.fft.irfft(spec, n=st.FRAME, dim=-1)
    del spec
    B_, T, F = frames.shape
    kernel, plain = kc.stretch_ola_pair(frames, win, hop, target)
    r16 = kc.compare("overlap_add", kernel, plain)
    r16["ms"] = graph_ms(kernel, reps=10, replays=3)
    r16["plain_ms"] = cuda_ms(plain, 1)
    r16["library_ms"] = graph_ms(kc.fold_library(frames, win, hop, target), reps=3, replays=3)
    r16.update(bound(kc.stretch_ola_work(B_, T, F, hop, target)), frames=T, hop=hop,
               target=target)
    r16["share_of_bound"] = r16["bound_ms"] / r16["ms"]
    del frames
    torch.cuda.empty_cache()
    log(f"[stretch-kernels] phase_lock [{rows} rows, {K} bins], |syn| up to "
        f"{r17['syn_abs_max']:.4g} rad: nearest identical, spectrum within "
        f"{r17['max_ulps']:.3f} ulps of the argument (max|d| {r17['max_abs_err']:.3g}); "
        f"{r17['ms']:.4f} ms by graph replay, plain {r17['plain_ms']:.3f}, bound "
        f"{r17['bound_ms']:.4f} ({r17['bound_by']}), {100 * r17['share_of_bound']:.1f} % of it")
    log(f"[stretch-kernels] overlap_add [{B_}, {T}, {F}] hop {hop} -> [{B_}, {target}]: bit-exact; "
        f"{r16['ms']:.4f} ms by graph replay, plain {r16['plain_ms']:.3f}, F.fold "
        f"{r16['library_ms']:.4f}, bound {r16['bound_ms']:.4f} ({r16['bound_by']}), "
        f"{100 * r16['share_of_bound']:.1f} % of it")
    return {"phase_lock": r17, "overlap_add": r16}


def stretch_profile(x, formant) -> dict:
    """Device time of one pitch shift over ``x`` by ``torch.profiler``,
    split by operation: the FFTs, the cumsum, K15-K17, copies, the rest
    (glue)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from soundkit_tpu_torch.ops import stretch as st

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        st.pitch_shift_batch_device(x, STRETCH_RATIO, STRETCH_PITCH, formant)
        torch.cuda.synchronize()
    groups = {"fft": ("fft",), "cumsum": ("scan",), "k15_polyphase_fir": ("resample_kernel",),
              "k16_overlap_add": ("stretch_ola_kernel",), "k17_phase_lock": ("phase_lock_kernel",),
              "copies": ("memcpy", "memset")}
    split = {k: 0.0 for k in (*groups, "glue")}
    count = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        count += 1
        name = e.name.lower()
        key = next((k for k, pats in groups.items() if any(p in name for p in pats)), "glue")
        split[key] += e.time_range.elapsed_us() / 1e3
    return dict(device_ops=count, device_ms=sum(split.values()),
                **{f"{k}_ms": v for k, v in split.items()})


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


def drive_fleet(fleet, fs: "FleetStreams", sids, collect):
    """Push ``sids`` by :func:`fleet_schedule` over FLEET_ROUNDS rounds,
    ``collect`` after each and once more at the end. Returns (push
    seconds, collect seconds, synchronized)."""
    import torch

    plans = {sid: dict(fleet_schedule(fs, sid, k)) for k, sid in enumerate(sids)}
    pos = dict.fromkeys(sids, 0)
    push_s = collect_s = 0.0
    for r in range(FLEET_ROUNDS + 1):
        t0 = time.perf_counter()
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


def phase_fleet():
    import numpy as np
    import torch

    from soundkit_tpu_torch.models.fleet import FleetUnsupported, StreamFleet
    from soundkit_tpu_torch.ops import aac_batch as ab
    from soundkit_tpu_torch.tools import opus_fixtures as of
    from soundkit_tpu_torch.tools import vorbis_fixtures as vf
    from soundkit_tpu_torch.ops import aac_entropy as ae
    from soundkit_tpu_torch.ops import g722, imdct

    fs = FleetStreams(B)
    groups = ("aac", "mp3", "flac", "opus", "vorbis", FLEET_TEL_KIND)
    first = [sid for g in groups for sid in fs.wave(g, False)]
    second = [sid for g in groups for sid in fs.wave(g, True)]
    wrappers = {"spectral_decode": ae.spectral_decode, "tns_filter": ab.tns_filter,
                "imdct_window": imdct.imdct_window, "g722_scan": g722.g722_decode_scan,
                **flac_wrappers(), **mp3_wrappers(), **voice_wrappers(), **vorbis_wrappers()}

    # mixed: all three groups in one fleet, lanes recycled, every stream checked
    fleet = StreamFleet(capacity_per_group=B, device="cuda")
    got, lane_of = {}, {}
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
        recs = fleet.collect(device_out=True)
        for kind, kind_rounds in replays.items():
            if kind == "vorbis":
                continue
            ready = {sid: rec.frames for sid, rec in recs.items() if rec.kind == kind}
            if ready:
                kind_rounds.append((int(next(recs[sid] for sid in ready).device.shape[0]), ready))
        for sid, rec in recs.items():
            check(rec.rate == fleet.sample_rate(sid) and rec.rate is not None, f"{sid}: rate {rec.rate}")
            pcm = rec.fetch()
            check(pcm.shape[-1] == rec.samples, f"{sid}: {pcm.shape} for {rec.samples} samples")
            if rec.kind != "vorbis":
                check(lane_of.setdefault(sid, rec.lane) == rec.lane, f"{sid}: changed lanes")
            got.setdefault(sid, []).append(pcm)

    for w in wrappers.values():
        w.launches = 0
    push_s, collect_s = drive_fleet(fleet, fs, first + second, collect_and_fetch)
    launches = {n: w.launches for n, w in wrappers.items()}
    for n, c in launches.items():
        check(c > 0, f"{n} was not launched by the fleet")
    check(not fleet._lanes and not fleet._detect and not fleet._ended,
          "fleet: streams left over after every stream ended and drained")
    for g in groups:
        used = fleet._groups[g]._used
        check(len(used) == B, f"fleet: group {g} used {len(used)} lanes for {B + B // 4} streams")
    # an Ogg Vorbis stream of another topology than the group's (22.05 kHz mono)
    mono = vf.load_clips(names=("mono22",))[0].stream()
    try:
        fleet.push("refused", mono)
        check(False, "fleet: an Ogg Vorbis stream of another topology was not refused")
    except FleetUnsupported as e:
        check("kind 'vorbis'" in str(e) and "topology (512, 1024, 1)" in str(e) and e.raw == mono,
              f"fleet: refusal does not name it: {e}")
    try:
        fleet.push("refused", b"\x00" * 64, kind="gsm")
        check(False, "fleet: a GSM stream was not refused")
    except FleetUnsupported:
        pass
    # an Ogg Opus SILK stream that switches from NB to WB in mid-stream (the reference
    # reroutes it to its host decoder)
    voice = {c.name: c for c in of.load_clips(names=of.VOICE_CLIPS)}
    switch = voice["silk_nb"].packets[:4] + voice["silk_wb"].packets[4:6]
    try:
        fleet.push("refused", voice["silk_nb"].header + b"".join(
            b"OggS" + bytes(22) + bytes([1, len(pkt)]) + pkt for pkt in switch))
        fleet.end_stream("refused")
        check(False, "fleet: an Ogg Opus SILK bandwidth switch was not refused")
    except FleetUnsupported as e:
        check("kind 'opus'" in str(e) and "silk bandwidth switch" in str(e),
              f"fleet: refusal does not name it: {e}")
    check(not fleet._lanes and not fleet._detect and not fleet._ended,
          "fleet: the refused stream was not forgotten")

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
    audio = sum(fs.audio.values())
    mixed = dict(streams=len(first) + len(second), rounds=FLEET_ROUNDS, audio_s=audio,
                 push_s=push_s, collect_and_fetch_s=collect_s,
                 xrealtime=audio / (push_s + collect_s), min_aac_snr_db=worst_snr["aac"],
                 min_opus_snr_db=worst_snr["opus"], min_vorbis_snr_db=worst_snr["vorbis"],
                 vorbis_identical_streams=int(vorbis_identical), launches=launches)
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
    phase = "build"
    try:
        phase_build()
        phase = "card"
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

        phase = "kernels"
        kres = phase_kernels(wires[0])
        phase = "compare"
        cres = phase_compare(wires)
        phase = "slice"
        sres = phase_slice(clips)
        phase = "tel-kernels"
        tkres = phase_tel_kernels()
        phase = "tel-compare"
        tcres = phase_tel_compare()
        phase = "telephony"
        tres, tlaunches = phase_telephony()
        phase = "flac-kernels"
        fkres = phase_flac_kernels()
        phase = "flac-compare"
        fcres = phase_flac_compare()
        phase = "flac"
        fres = phase_flac(fkres["flac_frame"]["rounds"])
        phase = "mp3-kernels"
        mkres = phase_mp3_kernels()
        phase = "mp3-compare"
        mcres = phase_mp3_compare()
        phase = "mp3"
        mres = phase_mp3()
        phase = "celt-kernels"
        ckres = phase_celt_kernels()
        phase = "celt-compare"
        ccres = phase_celt_compare()
        phase = "celt"
        celtres = phase_celt()
        phase = "silk-kernels"
        skres = phase_silk_kernels()
        phase = "silk-compare"
        scres = phase_voice_compare("silk")
        phase = "hybrid-compare"
        hcres = phase_voice_compare("hybrid")
        phase = "silk"
        silkres = phase_voice("silk")
        phase = "hybrid"
        hybres = phase_voice("hybrid")
        phase = "vorbis-kernels"
        vkres = phase_vorbis_kernels()
        phase = "vorbis-compare"
        vcres = phase_vorbis_compare()
        phase = "vorbis"
        vres = phase_vorbis()
        phase = "flac-enc-kernels"
        enc_lanes = flac_enc_lanes()
        ekres = phase_flac_enc_kernels(enc_lanes)
        phase = "flac-enc-compare"
        ecres = phase_flac_enc_compare()
        phase = "flac-enc"
        eres = phase_flac_enc(enc_lanes)
        phase = "resample-kernels"
        rkres = phase_resample_kernels()
        phase = "transcode"
        trres = phase_transcode()
        phase = "stretch-kernels"
        st_lanes = stretch_lanes()
        stkres = phase_stretch_kernels(st_lanes)
        phase = "stretch"
        stres = phase_stretch(st_lanes)
        del st_lanes
        phase = "fleet"
        flres = phase_fleet()
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
        k["fleet_launches"] = flres["mixed"]["launches"].get(k["name"], 0)
    log(json.dumps({"slice": sres, "compare": cres, "telephony": tres,
                    "telephony_compare": tcres, "flac": fres, "flac_compare": fcres,
                    "mp3": mres, "mp3_compare": mcres, "celt": celtres, "celt_compare": ccres,
                    "silk": silkres, "silk_compare": scres, "hybrid": hybres,
                    "hybrid_compare": hcres, "vorbis": vres, "vorbis_compare": vcres,
                    "flac_enc": eres, "flac_enc_compare": ecres,
                    "transcode": trres, "stretch": stres,
                    "fleet": flres,
                    "wall_s": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
