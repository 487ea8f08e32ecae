"""The port's host Opus batch models against the JAX package's and the
port's own decoders, on the in-repo Opus fixtures (tests/data/torch_port/opus).

``BatchedSilkDecoder`` (native synthesis a round, each lane resampled on
the host): against the JAX class on the same packets, slot lengths
identical and 90 dB / 1 LSB per lane, the bar PR 21 set for the port's
numpy resampler where the JAX package runs libswresample; against the
port's ``BatchedSilkDeviceDecoder`` on its CPU path, lengths identical and
above 95 dB per lane, the JAX package's own bar between the two
(``tests/test_silk_device.py``), with an idle round and a recycled lane.

``BatchedOpusDecoder`` (one owned ``_OpusCore`` a lane): bit for bit the
port's streaming ``OpusStreamDecoder`` on the same raw-Opus bytes; against
the JAX class, which opens libavcodec, lengths identical and at or above
the floors ``tests/test_torch_container_decode.py`` sets for WebM Opus
(CELT 104, SILK 84, hybrid 58 dB)."""
import struct

import numpy as np
import pytest

from soundkit_tpu.models.opus_batch import BatchedOpusDecoder as JaxOpus
from soundkit_tpu.models.opus_batch import BatchedSilkDecoder as JaxSilkHost
from soundkit_tpu_torch.codecs import opus
from soundkit_tpu_torch.models import BatchedOpusDecoder as ExportedOpus
from soundkit_tpu_torch.models.opus_batch import (
    BatchedOpusDecoder,
    BatchedSilkDecoder,
    BatchedSilkDeviceDecoder,
)
from soundkit_tpu_torch.pipeline.output_options import UnsupportedFormat
from soundkit_tpu_torch.tools import opus_fixtures

from torch_port_helpers import libopus, libopus_decode, snr_db

VOICE = {c.name: c for c in opus_fixtures.load_clips(names=opus_fixtures.VOICE_CLIPS)}
CELT = {c.name: c for c in opus_fixtures.load_clips()}
CLIPS = {**CELT, **VOICE}


def lane_stream(pcm, lengths, b, start_aligned):
    """Lane ``b``'s valid samples, slot after slot, as [n, C] float64."""
    F = pcm.shape[-1]
    parts = []
    for i in range(pcm.shape[0]):
        m = int(lengths[i, b])
        if m:
            s = pcm[i, b, :, :m] if start_aligned else pcm[i, b, :, F - m:]
            parts.append(np.asarray(s, np.float64).T)
    return np.concatenate(parts) if parts else np.zeros((0, pcm.shape[2]))


def held_at_90_db_and_1_lsb(got, want):
    assert got.shape == want.shape
    assert snr_db(got, want) >= 90
    q = lambda x: np.clip(np.round(x * 32768.0), -32768, 32767)  # noqa: E731
    assert np.abs(q(got) - q(want)).max() <= 1


# ---------------------------------------------------------------------------
# BatchedSilkDecoder
# ---------------------------------------------------------------------------

SILK_LANES = ("silk_nb", "silk_mb", "silk_wb", "silk_wb_stereo")


def push_silk(models, frames):
    for m in models:
        for b, fr in enumerate(frames):
            for frame, bw, coded in fr:
                m.push_packet(b, frame, bw, coded)


def test_host_silk_decoder_matches_jax():
    """Eight ragged stereo lanes, two of each SILK clip (NB, MB with an
    OpusHead gain, WB, WB stereo), the first four with their heads'
    pre-skip and gain; a bounded collect, a second push, a lane recycled
    onto another clip, and the rest."""
    clips = [VOICE[n] for n in SILK_LANES] * 2
    frames = [opus_fixtures.lane_frames(clips, b, 16 - b) for b in range(8)]
    port, ref = BatchedSilkDecoder(8, 2), JaxSilkHost(8, 2)
    for m in (port, ref):
        for b in range(4):
            m.configure_lane(b, clips[b].pre_skip, clips[b].output_gain)
    push_silk((port, ref), [f[: len(f) // 2] for f in frames])
    collects = [(port.decode_ready(max_packets=5), ref.decode_ready(max_packets=5))]
    push_silk((port, ref), [f[len(f) // 2:] for f in frames])
    for m in (port, ref):
        m.reset_lane(5)
        for frame, bw, coded in opus_fixtures.lane_frames(clips, 3, 6):
            m.push_packet(5, frame, bw, coded)
    collects.append((port.decode_ready(), ref.decode_ready()))
    for (g, gl), (w, wl) in collects:
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype == np.float32
        assert g.shape == w.shape
        np.testing.assert_array_equal(gl, wl)
        for b in range(8):
            held_at_90_db_and_1_lsb(g[:, b], w[:, b])
    # NB: the first slot is short by the resampler's lead (24) and the pre-skip
    assert collects[0][0][1][0, 0] == 960 - 24 - 312 and port.lane_ready(0) == 0


def test_host_silk_decoder_matches_the_device_decoder():
    """WB voice through the host decoder and the device decoder's CPU path,
    four mono lanes, including an idle round for lane 1 and lane 2
    recycled onto another stream position (the pattern of
    ``tests/test_silk_device.py``): identical slot lengths, > 95 dB a lane
    over its whole output."""
    frames = [f for f, _, _ in opus_fixtures.lane_frames([VOICE["silk_wb"]], 0)]
    B = 4
    host, dev = BatchedSilkDecoder(B, channels=1), BatchedSilkDeviceDecoder(B, 1, device="cpu")
    for m in (host, dev):
        for b in range(B):
            m.push_packet(b, frames[b], 2, 1)
    outs = [(host.decode_ready(), dev.decode_ready())]
    for m in (host, dev):
        m.reset_lane(2)
    for r in range(1, 9):
        for b in range(B):
            if b == 1 and r == 4:
                continue  # an idle round for lane 1
            for m in (host, dev):
                m.push_packet(b, frames[(r + 5 * b) % len(frames)], 2, 1)
        outs.append((host.decode_ready(), dev.decode_ready()))
    hp = np.concatenate([h[0] for h, _ in outs])
    hl = np.concatenate([h[1] for h, _ in outs])
    dp = np.concatenate([d[0] for _, d in outs])
    dl = np.concatenate([d[1] for _, d in outs])
    np.testing.assert_array_equal(hl, dl)
    assert (hl[4:5, 1] == 0).all() and hl.shape == (9, B)
    for b in range(B):
        h, d = lane_stream(hp, hl, b, False), lane_stream(dp, dl, b, False)
        assert h.shape == d.shape and h.shape[0] > 0
        assert snr_db(d, h) > 95, f"lane {b}"


def windows_snr(host_cls, device_cls, clip, rounds):
    """Host against device decoder, one lane for every ``rounds``-packet
    window of ``clip``, pre-skip taken: (lengths, per-lane SNR in dB over
    the valid samples)."""
    from soundkit_tpu_torch.codecs.opus_core import TOC_ATTRS

    n = len(clip.packets) - rounds
    host, dev = host_cls(n, 1), device_cls(n, 1)
    for i in range(n):
        for m in (host, dev):
            m.configure_lane(i, clip.pre_skip, clip.output_gain)
            for pkt in clip.packets[i: i + rounds]:
                m.push_packet(i, pkt[1:], TOC_ATTRS[pkt[0]][3], 1)
    (hp, hl), (dp, dl) = host.decode_ready(), dev.decode_ready()
    np.testing.assert_array_equal(hl, dl)
    valid = np.arange(960)[None, None] >= 960 - hl[..., None]
    sig = (np.asarray(hp, np.float64)[:, :, 0] ** 2 * valid).sum(axis=(0, 2))
    err = ((np.asarray(dp, np.float64)[:, :, 0] - hp[:, :, 0]) ** 2 * valid).sum(axis=(0, 2))
    return hl, 10 * np.log10(sig / err)


def test_host_and_device_silk_decoders_on_every_8_round_window():
    """Every 8-round window of the WB clip (142 lanes, the windows the
    ``[leftovers]`` phase of ``chip_smoke.py`` serves at 1024 lanes): the
    port's host and device decoders give identical lengths, and their worst
    window lies no further apart than the JAX package's own host and
    device decoders' worst, less 0.5 dB (window by window the two
    float32 paths round apart by a few dB, either way). On a few windows (an LPC of high gain)
    the two float32-against-float64 pairs read below the 95 dB the JAX
    package holds on its corpus clip: here the reference's pair reads
    93.93 dB on its worst window, the port's 93.94, so the phase holds
    every lane at 93.4 dB (``LEFT_SILK_FLOOR_DB``)."""
    import chip_smoke
    from soundkit_tpu.models.opus_batch import BatchedSilkDeviceDecoder as JaxSilkDevice

    clip = VOICE["silk_wb"]
    lengths, port = windows_snr(BatchedSilkDecoder,
                                lambda n, c: BatchedSilkDeviceDecoder(n, c, device="cpu"), clip, 8)
    jax_lengths, ref = windows_snr(JaxSilkHost, JaxSilkDevice, clip, 8)
    np.testing.assert_array_equal(lengths, jax_lengths)
    assert port.min() >= ref.min() - 0.5
    assert ref.min() < 95 and port.min() >= chip_smoke.LEFT_SILK_FLOOR_DB + 0.5
    assert np.median(port) > 99 and np.median(ref) > 99


# ---------------------------------------------------------------------------
# BatchedOpusDecoder
# ---------------------------------------------------------------------------

# (clip, packets, start) a lane: CELT stereo, mono in a stereo lane, a head
# gain and the owned encoder's stream; SILK NB, MB and stereo WB; hybrid SWB and FB
OPUS_LANES = [("stereo96", 20, 0), ("mono64", 16, 9), ("gain", 18, 4), ("owned", 12, 30),
              ("silk_nb", 16, 0), ("silk_mb", 14, 40), ("silk_wb_stereo", 18, 7),
              ("hybrid_swb", 12, 3), ("hybrid_fb", 14, 20)]
KIND = {"stereo96": "celt", "mono64": "celt", "gain": "celt", "owned": "celt",
        "silk_nb": "silk", "silk_mb": "silk", "silk_wb": "silk", "silk_wb_stereo": "silk",
        "hybrid_swb": "hybrid", "hybrid_fb": "hybrid"}
# tests/test_torch_container_decode.py's floors for WebM Opus against libavcodec
LIBAVCODEC_FLOOR_DB = {"celt": 104.0, "silk": 84.0, "hybrid": 58.0}


def raw_lane(name, n, start, head=True):
    clip = CLIPS[name]
    pkts = clip.packets[start: start + n]
    return (clip.head if head else b"") + b"".join(struct.pack("<H", len(p)) + p for p in pkts)


@pytest.fixture(scope="module")
def opus_collects():
    """The port's and the JAX decoder's collects over OPUS_LANES, pushed in
    odd chunks, decoded in two collects (the first bounded)."""
    B = len(OPUS_LANES)
    port, ref = BatchedOpusDecoder(B, 2), JaxOpus(B, 2)
    for b, (name, n, start) in enumerate(OPUS_LANES):
        data = raw_lane(name, n, start)
        for m in (port, ref):
            for k in range(0, len(data), 333):
                m.push(b, data[k: k + 333])
    assert port.ready_packets == ref.ready_packets == 12
    collects = [(port.decode_ready(max_packets=5), ref.decode_ready(max_packets=5)),
                (port.decode_ready(), ref.decode_ready())]
    assert port.ready_packets == 0
    return collects


def test_opus_batch_equals_the_streaming_decoder(opus_collects):
    """Every lane's valid samples equal, bit for bit, the port's streaming
    ``OpusStreamDecoder`` fed the same raw-Opus bytes (12 packets: the
    lockstep decode stops at the shortest lane); a mono head fills
    channel 0 of its stereo lane."""
    pcm = np.concatenate([g[0] for g, _ in opus_collects])
    lengths = np.concatenate([g[1] for g, _ in opus_collects])
    assert pcm.dtype == np.float32 and pcm.shape == (12, len(OPUS_LANES), 2, 960)
    for b, (name, _, start) in enumerate(OPUS_LANES):
        dec = opus.OpusStreamDecoder()
        want = np.concatenate([dec.decode_f32(raw_lane(name, 12, start)), dec.flush()])
        ch = CLIPS[name].channels
        want = want.reshape(-1, ch)
        got = lane_stream(pcm, lengths, b, True)
        np.testing.assert_array_equal(got[:, :ch].astype(np.float32), want, err_msg=name)
        if ch == 1:
            assert not got[:, 1].any()
        assert lengths[0, b] == 960 - CLIPS[name].pre_skip - (24 if name == "silk_nb" else 0)


def test_opus_batch_departs_from_libavcodec_within_the_webm_floors(opus_collects):
    """Against the JAX class's libavcodec decode of the same lanes:
    identical slot lengths, and each lane at or above its kind's floor but
    ``silk_mb``, which the owned decoder (the JAX package's and the
    port's alike) decodes apart from libavcodec on its voiced stretches
    (20.2-34.5 dB over 16-40 packets from packets 0, 7 and 40): that lane
    is held to the JAX package's owned streaming decoder instead, at 90 dB
    / 1 LSB. The departure is libavcodec's: at the internal rate the owned
    SILK core follows libopus on this clip as it does at NB and WB (56.42
    dB at lag -8, every packet 47.42-64.11 dB;
    :func:`test_silk_lanes_follow_libopus_at_the_internal_rate`)."""
    from soundkit_tpu.codecs import opus as jax_opus

    for (g, gl), (w, wl) in opus_collects:
        np.testing.assert_array_equal(gl, wl)
        assert g.shape == w.shape
    g = np.concatenate([g for (g, _), _ in opus_collects])
    w = np.concatenate([w for _, (w, _) in opus_collects])
    for b, (name, _, start) in enumerate(OPUS_LANES):
        if name != "silk_mb":
            assert snr_db(g[:, b], w[:, b]) >= LIBAVCODEC_FLOOR_DB[KIND[name]], name
            continue
        assert snr_db(g[:, b], w[:, b]) < 40
        lengths = np.concatenate([gl for (_, gl), _ in opus_collects])
        dec = jax_opus.OpusStreamDecoder()
        owned = np.concatenate([dec.decode_f32(raw_lane(name, 12, start)), dec.flush()])
        held_at_90_db_and_1_lsb(lane_stream(g, lengths, b, True)[:, :1], owned.reshape(-1, 1))


# (internal rate, bandwidth, libopus's lag in samples, dB floor over the clip,
# dB floor a packet) a SILK lane; measured 60.55 / 56.42 / 49.30 dB over the
# clip, 49.03-66.00 / 47.42-64.11 / 44.13-59.63 dB a packet
SILK_ORACLE = {"silk_nb": (8000, 0, -3, 58.0, 47.0), "silk_mb": (12000, 1, -8, 54.0, 45.0),
               "silk_wb": (16000, 2, -11, 47.0, 42.0)}


@pytest.mark.skipif(libopus() is None, reason="libopus.so.0 is not on this machine")
@pytest.mark.parametrize("name", sorted(SILK_ORACLE))
def test_silk_lanes_follow_libopus_at_the_internal_rate(name):
    """The owned SILK core (the port's native SILK decode, which its
    streaming and batch decoders run) against libopus decoding the same
    packets at the SILK internal rate, where libopus's output is its SILK
    core's: the best lag within 30 samples is libopus's delay, and the
    clip and every packet read at or above their floors. libopus codes
    SILK in 16-bit fixed point, which caps the agreement."""
    from soundkit_tpu_torch.codecs.silk_native import NativeSilkDecoder

    rate, bw, lag, clip_floor, packet_floor = SILK_ORACLE[name]
    packets = VOICE[name].packets
    core = NativeSilkDecoder()
    own = np.concatenate([core.decode_superframe(p[1:], bw, 1, 20)[0] for p in packets])[:, 0]
    ref = libopus_decode(packets, rate, 1)[:, 0]

    def lagged(k):
        a, b = own[max(0, k):], ref[max(0, -k):]
        n = min(len(a), len(b))
        return a[:n], b[:n]

    best = max(range(-30, 31), key=lambda k: snr_db(*lagged(k)))
    assert best == lag
    a, b = lagged(lag)
    assert snr_db(a, b) >= clip_floor
    frame = rate // 50
    for i in range(len(a) // frame):
        seg = slice(i * frame, (i + 1) * frame)
        if np.any(b[seg]):
            assert snr_db(a[seg], b[seg]) >= packet_floor, i


@pytest.mark.parametrize("name", ["stereo96", "silk_wb", "hybrid_fb"])
def test_opus_batch_on_the_webm_cases_reads_the_webm_figures(name):
    """The three clips the WebM Opus floors were measured on, their first
    100 packets from a lane of their own: at or above the floor against
    the JAX class's libavcodec decode, lengths identical (both take the
    OpusHead's pre-skip off the first slot)."""
    port, ref = BatchedOpusDecoder(1, 2), JaxOpus(1, 2)
    for m in (port, ref):
        m.push(0, raw_lane(name, 100, 0))
    (g, gl), (w, wl) = port.decode_ready(), ref.decode_ready()
    np.testing.assert_array_equal(gl, wl)
    assert gl[0, 0] == 960 - 312 and g.shape == w.shape == (100, 1, 2, 960)
    assert snr_db(g, w) >= LIBAVCODEC_FLOOR_DB[KIND[name]]


def test_opus_batch_without_a_head_and_the_multistream_departure():
    """A bare packet wire (no OpusHead) takes the default head: no pre-skip,
    the lane's channels; a multistream head raises ``UnsupportedFormat`` at
    the lane's first decode: the wire's 19 head bytes hold no channel
    mapping table, and the JAX class fails there too
    (:func:`test_opus_batch_multistream_heads_fail_in_both_packages`)."""
    assert ExportedOpus is BatchedOpusDecoder
    dec = BatchedOpusDecoder(1, 2)
    dec.push(0, raw_lane("stereo96", 3, 0, head=False))
    pcm, lengths = dec.decode_ready()
    assert lengths.tolist() == [[960], [960], [960]]
    stream = opus.OpusStreamDecoder()
    want = np.concatenate([stream.decode_f32(raw_lane("stereo96", 3, 0).replace(
        CLIPS["stereo96"].head, CLIPS["stereo96"].head[:10] + b"\0\0" + CLIPS["stereo96"].head[12:]))])
    np.testing.assert_array_equal(lane_stream(pcm, lengths, 0, True).astype(np.float32),
                                  want.reshape(-1, 2))
    family1 = CLIPS["stereo96"].head[:18] + b"\x01"
    dec = BatchedOpusDecoder(1, 2)
    dec.push(0, family1 + raw_lane("stereo96", 2, 0, head=False))
    with pytest.raises(UnsupportedFormat, match="no channel mapping table.*cannot open it either"):
        dec.decode_ready()


@pytest.mark.parametrize("what", ["mapping_family_1", "three_channels", "family_255"])
def test_opus_batch_multistream_heads_fail_in_both_packages(what):
    """Each raw-wire lane head that is not one elementary stream fails at
    the lane's first decode in both packages: the JAX class keeps 19 head
    bytes, which libavcodec will not open without their table
    (``AvDecodeError``), and the port's raises ``UnsupportedFormat``."""
    from soundkit_tpu.codecs.avdec import AvDecodeError

    head = CLIPS["stereo96"].head
    head = {"mapping_family_1": head[:18] + b"\x01",
            "three_channels": head[:9] + b"\x03" + head[10:],
            "family_255": head[:18] + b"\xff"}[what]
    port, ref = BatchedOpusDecoder(1, 2), JaxOpus(1, 2)
    for m in (port, ref):
        m.push(0, head + raw_lane("stereo96", 2, 0, head=False))
    with pytest.raises(AvDecodeError):
        ref.decode_ready()
    with pytest.raises(UnsupportedFormat, match="19 head bytes hold no channel mapping table"):
        port.decode_ready()
