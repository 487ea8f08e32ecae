"""Port parity of the serving runtime: soundkit_tpu_torch's StreamFleet
against the JAX package's on the CPU, driven by the same pushes over the
committed AAC, MP3, FLAC, Ogg Opus, Ogg Vorbis and telephony fixtures.
Collect by collect: the same key sets, dtypes, shapes and sample rates;
FLAC and telephony PCM bit-exact; AAC, MP3 and Opus CELT PCM at 100 dB or
better per collect as f32 (the bar of ``test_torch_aac_lc_model.py``) and
within 1 LSB as int16; Ogg Opus SILK and hybrid streams (ids ``v*``) at
90 dB as f32, the bar of ``test_torch_silk_model.py`` (two float32
syntheses of an LPC of high gain); Ogg Vorbis streams (ids ``w*``) within
2e-6 as f32 (the bar of ``test_torch_vorbis_model.py``). Streams without a
lane decode on both fleets' host fallbacks (ids ``x*`` bit-exact, ids
``y*`` within 1 LSB: an MP3 stream through K10's plain version, or a
SILK decode through the port's resampler); the streams the port cannot
decode raise ``FleetUnsupported``, one test per case."""
import struct

import numpy as np
import pytest
import torch

from soundkit_tpu.codecs.avdec import AvDecodeError
from soundkit_tpu.models import telephony_batch as jax_tel
from soundkit_tpu.models.fleet import StreamFleet as JaxFleet
from soundkit_tpu_torch.models import fleet as fleet_mod
from soundkit_tpu_torch.models import telephony_batch as port_tel
from soundkit_tpu_torch.models.fleet import (
    HOST_KINDS,
    MIN_DETECT,
    TELEPHONY_KINDS,
    FleetLaneOutput,
    FleetUnsupported,
    StreamFleet,
)
from soundkit_tpu_torch.tools import (aac_fixtures, container_fixtures, flac_fixtures,
                                      host_codec_fixtures, mp3_fixtures, opus_fixtures,
                                      telephony_fixtures, vorbis_fixtures)
from torch_port_helpers import REROUTE_CASES, flac_clip_pcm, ogg_opus, opus_reroute_case, snr_db


CHUNK = 256  # codes a telephony round, in both fleets (they build their groups at 2048)
CAP = 4      # lanes a group wherever a test does not need another number: one set of JAX programs


@pytest.fixture(autouse=True)
def small_telephony_rounds(monkeypatch):
    """Both fleets build ``TelephonyLaneGroup(kind, capacity)`` with the
    default chunk of 2048 codes; here the default is ``CHUNK``, which
    keeps the scans of a collect short."""
    for mod in (jax_tel, port_tel):
        init = mod.TelephonyLaneGroup.__init__
        monkeypatch.setattr(
            mod.TelephonyLaneGroup, "__init__",
            lambda self, codec, capacity, chunk_codes=CHUNK, _init=init, **kw:
                _init(self, codec, capacity, chunk_codes, **kw))


def aac_stream(clip: int, start: int, n: int) -> bytes:
    return b"".join(aac_fixtures.load_clips()[clip][start: start + n])


def flac_stream(clip: int, frames=None) -> bytes:
    c = flac_fixtures.load_clips()[clip]
    return c.header + b"".join(c.frames[:frames])


def mp3_stream(clip: int, start: int = 0, n=None) -> bytes:
    frames = mp3_fixtures.load_clips()[clip].frames
    return b"".join(frames[start: None if n is None else start + n])


def tel_stream(kind: str, lane: int, n: int) -> bytes:
    return telephony_fixtures.lane_streams(kind, lane + 1)[lane][:n]


def opus_stream(lane: int, n: int) -> bytes:
    """Smoke lane ``lane`` of the Ogg Opus fixtures (clip ``lane mod 4``),
    ``n`` packets."""
    return opus_fixtures.lane_streams(opus_fixtures.load_clips(), lane + 1, n)[lane]


def voice_stream(name: str, lane: int, n: int) -> bytes:
    """Smoke lane ``lane`` of an Ogg Opus voice fixture (SILK or hybrid),
    ``n`` packets."""
    clip = opus_fixtures.load_clips(names=(name,))
    return opus_fixtures.lane_streams(clip * (lane + 1), lane + 1, n)[lane]


def vorbis_stream(lane: int, n_pages=None, names=vorbis_fixtures.STEREO) -> bytes:
    """Lane ``lane`` of the Ogg Vorbis fixtures ``names`` (the stereo
    44.1 kHz clips by default), at most ``n_pages`` audio pages."""
    clips = vorbis_fixtures.load_clips(names=names)
    return vorbis_fixtures.lane_streams(clips, lane + 1, n_pages)[lane]


class Pair:
    """The port's fleet and the JAX package's, driven together. Stream
    ids start with their group's letter: a (AAC), m (MP3), f (FLAC), o
    (Ogg Opus), v (Ogg Opus voice), w (Ogg Vorbis), t (telephony)."""

    def __init__(self, capacity=CAP, out_bits=32):
        self.port = StreamFleet(capacity, out_bits=out_bits, device="cpu")
        self.ref = JaxFleet(capacity, out_bits=out_bits)
        self.out_bits = out_bits
        self._head = {}  # sid -> [pre-skip left, gain] of a hybrid stream

    def hybrid(self, sid, clip):
        """Hold ``sid``, a hybrid Ogg Opus stream of fixture ``clip``, to the
        JAX fleet's output with its OpusHead's pre-skip and gain applied:
        the port's hybrid engine takes them (its stated departure,
        ``models/opus_fleet_model.py``), the JAX package's does not."""
        c = opus_fixtures.load_clips(names=(clip,))[0]
        self._head[sid] = [c.pre_skip, 10.0 ** (c.output_gain / 5120.0)]

    def push(self, sid, data, kind=None):
        for f in (self.port, self.ref):
            f.push(sid, data, kind=kind)

    def end(self, *sids):
        for sid in sids:
            for f in (self.port, self.ref):
                f.end_stream(sid)

    def rates(self, *sids):
        got = [self.port.sample_rate(s) for s in sids]
        assert got == [self.ref.sample_rate(s) for s in sids]
        return got

    def collect(self, device_out=False):
        """One collect of both fleets, compared; returns the port's PCM
        by stream (fetched, in ``device_out`` mode)."""
        got = self.port.collect(device_out=device_out)
        want = self.ref.collect(device_out=device_out)
        assert sorted(got) == sorted(want)
        out = {}
        for sid in got:
            g, w = got[sid], want[sid]
            trim = 0
            if sid in self._head:
                trim = min(self._head[sid][0], w.samples if device_out else np.shape(w)[-1])
                self._head[sid][0] -= trim
            if device_out:
                assert isinstance(g, FleetLaneOutput)
                assert (g.kind, g.samples + trim, g.rate, g.lane, g.frames, g.out_bits) == \
                    (w.kind, w.samples, w.rate, w.lane, w.frames, w.out_bits), sid
                # a Vorbis lane's ragged PCM and a host stream's are made on the host
                if g.kind in ("vorbis", "host"):
                    assert isinstance(g.host, np.ndarray) and g.device is None
                else:
                    assert isinstance(g.device, torch.Tensor)
                g, w = g.fetch(), w.fetch()
                assert g.shape[-1] == got[sid].samples
            w = np.asarray(w)
            if sid in self._head:
                assert w.dtype == np.float32  # the gain is applied to float PCM here
                w = w[..., trim:] * np.float32(self._head[sid][1])
            assert g.dtype == w.dtype and g.shape == w.shape, (sid, g.dtype, w.dtype, g.shape, w.shape)
            if sid.startswith("y"):
                lsb = 1 if g.dtype == np.int16 else 1.0001 / 32768
                assert np.abs(g.astype(np.float64) - w).max() <= lsb, sid
            elif not sid.startswith(("a", "m", "o", "v", "w")):
                np.testing.assert_array_equal(g, w, err_msg=sid)
            elif g.dtype == np.int16:
                assert np.abs(g.astype(np.int32) - w).max() <= 1, sid
            elif sid.startswith("w"):
                np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=sid)
            elif np.any(w):
                assert snr_db(g, w) >= (90 if sid.startswith("v") else 100), sid
            else:
                assert not np.any(g), sid
            out[sid] = g
        return out


STREAMS = {
    # sid: (bytes, explicit kind, rate)
    "a0": (aac_stream(1, 8, 9), None, 48000),
    "a1": (aac_stream(4, 30, 5), None, 48000),
    "m0": (mp3_stream(0, 0, 60), None, 44100),
    "m1": (mp3_stream(3), "mp3", 16000),
    "f0": (flac_stream(0, 3), None, 44100),
    "f1": (flac_stream(1, 2), None, 48000),
    "f2": (flac_stream(2, 4), None, 16000),
    "f3": (flac_stream(3, 3), "flac", 44100),
    "o0": (opus_stream(0, 30), None, 48000),     # stereo, libopus, pre-skip 312
    "o1": (opus_stream(5, 24), "opus", 48000),   # mono in a stereo lane
    "o2": (opus_stream(3, 20), None, 48000),     # an OpusHead output gain
    # the ADPCM streams are short: their plain scans are Python loops over the codes
    "t0": (tel_stream("g722", 0, 700), "g722", 16000),
    "t1": (tel_stream("g722", 1, 150), "g722", 16000),
    "t2": (tel_stream("g726_32", 2, 300), "g726_32", 8000),
    "t3": (tel_stream("g711_alaw", 3, 3000), "g711_alaw", 8000),
}


@pytest.mark.parametrize("out_bits,device_out", [(32, False), (16, True), (32, True), (16, False)])
def test_mixed_ragged_routing_matches_jax(out_bits, device_out):
    """Fifteen streams over seven groups, pushed in three ragged rounds
    with a collect after each; autodetected and explicit kinds; some
    streams end early, all end at last."""
    pair = Pair(CAP, out_bits)
    pos = {sid: 0 for sid in STREAMS}
    shares = {"a0": (0.2, 0.7, 1), "a1": (1, 1, 1), "m0": (0.4, 0.8, 1), "m1": (0.5, 0.5, 1),
              "f0": (0.5, 0.5, 1), "f1": (0.1, 1, 1),
              "f2": (0.3, 0.6, 1), "f3": (0.6, 1, 1), "t0": (0.3, 0.8, 1), "t1": (1, 1, 1),
              "t2": (0.01, 0.5, 1), "t3": (0.5, 0.5, 1), "o0": (0.3, 0.95, 1),
              "o1": (0.5, 0.5, 1), "o2": (1, 1, 1)}
    seen = {sid: 0 for sid in STREAMS}
    dtypes = set()
    for rnd in range(3):
        for sid, (data, kind, _) in STREAMS.items():
            end = int(len(data) * shares[sid][rnd])
            if end > pos[sid] or rnd == 0:
                pair.push(sid, data[pos[sid]: end], kind=kind if pos[sid] == 0 and rnd == 0 else None)
            pos[sid] = max(pos[sid], end)
        if rnd == 1:
            pair.end("a1", "t1", "f3", "o2")
        if rnd == 2:
            pair.end(*STREAMS)
        for sid, pcm in pair.collect(device_out).items():
            seen[sid] += pcm.shape[-1]
            dtypes.add((sid[0], pcm.dtype))
            assert pair.rates(sid) == [STREAMS[sid][2]]
    pair.collect(device_out)  # drains what the last round left, then recycles
    assert all(n > 0 for n in seen.values()), seen
    assert seen["a0"] == 9 * 1024 and seen["f1"] == 2 * 4096 and seen["t0"] == 2 * 700
    assert seen["m0"] == 60 * 2 * 576 and seen["m1"] == 58 * 576
    assert seen["o0"] == 30 * 960 - 312 and seen["o1"] == 24 * 960 - 312
    want = np.dtype(np.int16 if out_bits == 16 else np.float32)
    assert dtypes == {("a", want), ("m", want), ("f", want), ("t", want), ("o", want)}
    for f in (pair.port, pair.ref):
        assert not f._lanes and not f._detect and not f._ended


@pytest.mark.parametrize("out_bits", [32, 16])
def test_device_out_is_bit_identical_to_the_fetching_mode(out_bits):
    """Two fleets of the port, the same pushes: the same key set, and
    ``fetch()`` gives the arrays that the fetching mode returns; the
    lanes of a group share one fetch."""
    fleets = [StreamFleet(CAP, out_bits=out_bits, device="cpu") for _ in range(2)]
    for f in fleets:
        for sid, (data, kind, _) in STREAMS.items():
            f.push(sid, data[: len(data) // 2],
                   kind=kind or {"a": "aac", "o": "opus"}.get(sid[0]))
        f.push("t9", b"", kind="g722")  # a telephony lane with nothing to say
    fetched = fleets[0].collect()
    resident = fleets[1].collect(device_out=True)
    assert sorted(fetched) == sorted(resident) and "t9" not in fetched
    for sid, rec in resident.items():
        pcm = rec.fetch()
        assert pcm.dtype == fetched[sid].dtype
        np.testing.assert_array_equal(pcm, fetched[sid])
        assert rec.samples == pcm.shape[-1] and rec.rate == STREAMS[sid][2]
    caches = {id(rec._cache) for rec in resident.values()}
    assert len(caches) == 7  # aac, mp3, flac, opus, g722, g726_32, g711_alaw
    assert resident["f0"]._cache is resident["f2"]._cache and "arr" in resident["f0"]._cache
    assert resident["o0"]._cache is resident["o1"]._cache


def test_fleet_lane_recycling_resets_state():
    """A second AAC stream takes the lane the first one left (the free
    list hands out the lane released last), and decodes as in a fresh
    fleet: the overlap state was cleared."""
    pair = Pair()
    pair.push("a0", aac_stream(0, 10, 9))
    pair.end("a0")
    first = pair.collect()["a0"]
    assert first.shape == (2, 9 * 1024) and not pair.port._lanes
    pair.push("a1", aac_stream(3, 40, 9))
    pair.end("a1")
    assert pair.port._lanes["a1"].index == pair.ref._lanes["a1"].index == CAP - 1
    again = pair.collect()["a1"]
    fresh = StreamFleet(CAP, device="cpu")
    fresh.push("x", aac_stream(3, 40, 9))
    fresh.end_stream("x")
    np.testing.assert_array_equal(again, fresh.collect()["x"])
    assert pair.port._groups["aac"]._model.v4_batches == 18


def test_fleet_telephony_lanes_recycle_and_state_reset():
    """The same for a G.726 lane: the ADPCM state row goes back to the
    initial state when the lane takes its next stream."""
    pair = Pair()
    pair.push("t0", tel_stream("g726_32", 0, 300), kind="g726_32")
    pair.end("t0")
    assert pair.collect()["t0"].shape == (1, 600)
    second = tel_stream("g726_32", 4, 300)
    pair.push("t1", second, kind="g726_32")
    assert pair.port._lanes["t1"].index == pair.ref._lanes["t1"].index == CAP - 1
    pair.end("t1")
    again = pair.collect()["t1"]
    fresh = StreamFleet(CAP, device="cpu")
    fresh.push("x", second, kind="g726_32")
    np.testing.assert_array_equal(again, fresh.collect()["x"])
    # and it would differ from a lane that kept its state
    kept = StreamFleet(CAP, device="cpu")
    kept.push("x", tel_stream("g726_32", 0, 300) + second, kind="g726_32")
    assert not np.array_equal(again, kept.collect()["x"][:, 600:])


def test_sample_rates_per_stream_and_their_one_collect_retention():
    pair = Pair()
    assert pair.rates("f0", "nobody") == [None, None]
    pair.push("f0", flac_stream(1, 1)[:20])      # the marker, not yet STREAMINFO: no lane yet
    pair.push("f1", flac_stream(2, 1), kind="flac")
    pair.push("a0", aac_stream(2, 0, 3))         # under MIN_DETECT: not routed yet
    pair.push("t0", tel_stream("g722", 0, 100), kind="g722")
    assert pair.rates("f0", "f1", "a0", "t0") == [None, 16000, None, 16000]
    pair.end("f0", "f1", "a0", "t0")             # f0 and a0 are detected and seated now
    assert pair.rates("f0", "a0") == [None, 48000]
    assert sorted(pair.collect()) == ["a0", "f1", "t0"]  # f0 had no whole frame; all four retire
    assert pair.rates("f0", "f1", "a0", "t0") == [None, 16000, 48000, 16000], \
        "kept for the collect that returned the PCM"
    assert pair.collect() == {}
    assert pair.rates("f0", "f1", "a0", "t0") == [None] * 4
    for f in (pair.port, pair.ref):
        assert not f._rates and not f._retired and not f._lanes and not f._ended


def test_out_bits_16_downshifts_24_bit_flac():
    """A 24-bit lane scales by an arithmetic >> 8 and does not saturate;
    a 16-bit lane beside it stays exact."""
    pair = Pair(out_bits=16)
    pair.push("f24", flac_stream(1))
    pair.push("f16", flac_stream(0, 2))
    pair.end("f24", "f16")
    out = pair.collect()
    pcm24 = flac_clip_pcm("stereo24")
    assert np.abs(pcm24).max() > (1 << 20)
    assert out["f24"].dtype == np.int16 and out["f24"].shape == pcm24.shape
    np.testing.assert_array_equal(out["f24"], np.clip(pcm24 >> 8, -32768, 32767))
    np.testing.assert_array_equal(out["f16"], flac_clip_pcm("stereo16")[:, : 2 * 4096])
    # the f32 mode scales every lane by 1 / 32768
    pair32 = Pair()
    pair32.push("f24", flac_stream(1, 1))
    pair32.end("f24")
    np.testing.assert_array_equal(pair32.collect()["f24"],
                                  pcm24[:, :4096].astype(np.float32) / 32768.0)


def test_mono_flac_lane_returns_one_channel():
    pair = Pair()
    pair.push("f0", flac_stream(2, 2))
    pair.end("f0")
    out = pair.collect()["f0"]
    assert out.shape == (1, 2 * 4096) and out.dtype == np.float32
    np.testing.assert_array_equal(out, flac_clip_pcm("mono16")[:, : 2 * 4096].astype(np.float32) / 32768)


def test_mono_mp3_lane_returns_a_silent_second_channel():
    """A mono stream in the stereo MP3 group: its second channel is
    invalid on the wire, so it decodes as zeros, in both fleets."""
    pair = Pair()
    pair.push("m0", mp3_stream(4))  # 8 kHz mono, MPEG-2.5
    pair.end("m0")
    out = pair.collect()["m0"]
    assert out.shape == (2, 30 * 576) and out.dtype == np.float32
    assert np.abs(out[0]).max() > 0.01 and not out[1].any()
    assert pair.rates("m0") == [8000]  # retired, its rate kept for one collect


def test_mp3_lane_recycling_resets_state():
    """A second MP3 stream takes the lane the first one left and decodes
    as in a fresh fleet: the parser, overlap and FIFO were cleared."""
    pair = Pair()
    pair.push("m0", mp3_stream(2, 0, 12), kind="mp3")
    pair.end("m0")
    assert pair.collect()["m0"].shape == (2, 12 * 576) and not pair.port._lanes
    second = mp3_stream(1, 0, 10)
    pair.push("m1", second, kind="mp3")
    pair.end("m1")
    assert pair.port._lanes["m1"].index == pair.ref._lanes["m1"].index == CAP - 1
    again = pair.collect()["m1"]
    fresh = StreamFleet(CAP, device="cpu")
    fresh.push("x", second, kind="mp3")
    np.testing.assert_array_equal(again, fresh.collect()["x"])
    assert again.shape == (2, 20 * 576)
    # and it would differ from a lane that kept its FIFO and overlap
    kept = fleet_mod.StreamFleet(CAP, device="cpu")
    kept.push("x", mp3_stream(2, 0, 12) + second, kind="mp3")
    assert not np.array_equal(again, kept.collect()["x"][:, 12 * 576:])


def test_explicit_mp3_kind_joins_the_mp3_group():
    """The explicit kind ``mp3`` (refused before the group was ported)
    seats the stream with its buffered bytes, as detection would."""
    pair = Pair()
    data = mp3_stream(1, 0, 6)
    pair.push("m0", data[:100])               # buffered for detection
    pair.push("m0", data[100:], kind="mp3")   # routed now, with the buffered bytes
    for f in (pair.port, pair.ref):
        assert f._lanes["m0"].group == "mp3" and not f._detect
    assert pair.collect()["m0"].shape == (2, 12 * 576)
    assert pair.rates("m0") == [48000]


def test_opus_lane_recycling_resets_state():
    """A second Ogg Opus stream takes the lane the first one left and
    decodes as in a fresh fleet: the demuxer, the parse state, the
    overlap, comb history and de-emphasis memory were cleared."""
    pair = Pair()
    pair.push("o0", opus_stream(0, 14))
    pair.end("o0")
    assert pair.collect()["o0"].shape == (2, 14 * 960 - 312) and not pair.port._lanes
    second = opus_stream(6, 12)  # the owned encoder's clip: pre-skip 0
    pair.push("o1", second)
    pair.end("o1")
    assert pair.port._lanes["o1"].index == pair.ref._lanes["o1"].index == CAP - 1
    again = pair.collect()["o1"]
    fresh = StreamFleet(CAP, device="cpu")
    fresh.push("x", second)
    fresh.end_stream("x")
    np.testing.assert_array_equal(again, fresh.collect()["x"])
    assert again.shape == (2, 12 * 960)
    # and it would differ from a lane that kept its state
    model = pair.port._groups["opus"]._model
    assert model._celt.queued(CAP - 1) == 0 and model.lane_sample_rate(CAP - 1) == 48000


@pytest.mark.parametrize("device_out", [False, True])
def test_silk_and_hybrid_opus_lanes_match_jax(device_out):
    """SILK (NB, MB with an OpusHead gain, WB stereo) and hybrid (SWB,
    FB) Ogg Opus streams served in the ``opus`` group beside a CELT one,
    pushed in two ragged rounds with a collect after each; then lanes
    recycled across kinds (a CELT lane to a SILK stream, a SILK lane to a
    hybrid one, a hybrid lane to a CELT one), collect by collect against
    the JAX fleet. The hybrid streams (v3, v4, v6) take their OpusHead's
    pre-skip and gain, the port's stated departure (``Pair.hybrid``)."""
    pair = Pair(8)
    first = {"v0": voice_stream("silk_nb", 0, 20), "v1": voice_stream("silk_mb", 1, 16),
             "v2": voice_stream("silk_wb_stereo", 2, 22), "v3": voice_stream("hybrid_swb", 3, 14),
             "v4": voice_stream("hybrid_fb", 0, 19), "o0": opus_stream(0, 12)}
    for sid, clip in (("v3", "hybrid_swb"), ("v4", "hybrid_fb"), ("v6", "hybrid_fb")):
        pair.hybrid(sid, clip)
    for rnd in range(2):
        for sid, data in first.items():
            pair.push(sid, data[len(data) * rnd // 2: len(data) * (rnd + 1) // 2],
                      kind=None if rnd else "opus")
        if rnd:
            pair.end(*first)
        out = pair.collect(device_out)
        assert sorted(out) == sorted(first)
    pair.collect(device_out)  # drains and recycles
    group = pair.port._groups["opus"]._model
    lanes = {sid: pair.port._lanes.get(sid) for sid in first}
    assert not any(lanes.values())
    second = {"v5": voice_stream("silk_wb", 4, 12), "v6": voice_stream("hybrid_fb", 5, 11),
              "o1": opus_stream(6, 10), "v7": voice_stream("silk_nb", 7, 9)}
    for sid, data in second.items():
        pair.push(sid, data, kind="opus")
        pair.end(sid)
    kinds = {sid: group._kind[pair.port._lanes[sid].index] for sid in second}
    assert kinds == {"v5": "silk", "v6": "hybrid", "o1": "celt", "v7": "silk"}
    got = pair.collect(device_out)
    assert sorted(got) == sorted(second)
    assert got["v7"].shape == (2, 9 * 960 - 312 - 23)  # NB: the resampler's lead
    assert got["v6"].shape == (2, 11 * 960 - 312)  # hybrid: the OpusHead's pre-skip is taken


def test_explicit_opus_kind_joins_the_opus_group():
    """The explicit kind ``opus`` (refused before the group was ported)
    seats an Ogg Opus stream with its buffered bytes, as detection would."""
    pair = Pair()
    data = opus_stream(1, 10)
    pair.push("o0", data[:100])                # buffered for detection
    pair.push("o0", data[100:], kind="opus")   # routed now, with the buffered bytes
    for f in (pair.port, pair.ref):
        assert f._lanes["o0"].group == "opus" and not f._detect
    assert pair.collect()["o0"].shape == (2, 10 * 960 - 312)
    assert pair.rates("o0") == [48000]


VORBIS_MIX = {
    # sid: (bytes, explicit kind, rate, shares of the stream pushed by the end of each round)
    "w0": (vorbis_stream(0, 4), None, 44100, (0.2, 0.7, 1)),
    "w1": (vorbis_stream(1), "vorbis", 44100, (0.5, 0.5, 1)),
    "w2": (vorbis_stream(2, 2), None, 44100, (1, 1, 1)),
    "w3": (vorbis_stream(7, 3), None, 44100, (0.01, 0.6, 1)),
    "a0": (aac_stream(2, 4, 6), None, 48000, (0.5, 1, 1)),
    "o0": (opus_stream(1, 14), None, 48000, (0.3, 0.9, 1)),
}


@pytest.mark.parametrize("out_bits,device_out", [(32, False), (16, True), (32, True), (16, False)])
def test_mixed_ragged_fleet_with_vorbis_lanes_matches_jax(out_bits, device_out):
    """Four Ogg Vorbis streams (detected and explicit) beside an AAC and an
    Ogg Opus stream, pushed in three ragged rounds with a collect after
    each, one Vorbis stream ended early; collect by collect against the
    JAX fleet, then every Vorbis stream's whole output against a bare
    model fed the same bytes."""
    from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder

    pair = Pair(CAP, out_bits)
    pos = dict.fromkeys(VORBIS_MIX, 0)
    got = {sid: [] for sid in VORBIS_MIX}
    for rnd in range(3):
        for sid, (data, kind, _, shares) in VORBIS_MIX.items():
            end = int(len(data) * shares[rnd])
            if end > pos[sid] or rnd == 0:
                pair.push(sid, data[pos[sid]: end], kind=kind if rnd == 0 else None)
            pos[sid] = max(pos[sid], end)
        if rnd == 1:
            pair.end("w2")
        if rnd == 2:
            pair.end(*VORBIS_MIX)
        for sid, pcm in pair.collect(device_out).items():
            got[sid].append(pcm)
            assert pair.rates(sid) == [VORBIS_MIX[sid][2]]
    got_last = pair.collect(device_out)
    for sid, pcm in got_last.items():
        got[sid].append(pcm)
    for f in (pair.port, pair.ref):
        assert not f._lanes and not f._detect and not f._ended and not f._pretopo
    for sid in ("w0", "w1", "w2", "w3"):
        bare = BatchedVorbisDecoder(1, device="cpu")
        bare.push(0, VORBIS_MIX[sid][0])
        want = bare.decode_batches(bare.lane_ready(0))[0].astype(np.float32)
        pcm = np.concatenate(got[sid], axis=1)
        if out_bits == 16:
            want = np.clip(np.round(want * 32767.0), -32768, 32767).astype(np.int16)
        np.testing.assert_array_equal(pcm, want, err_msg=sid)
        assert pcm.shape[1] > 4096


def test_vorbis_lane_recycling_resets_state():
    """A second Ogg Vorbis stream takes the lane the first one left and
    decodes as in a fresh fleet: the packetizer, the headers, the lap and
    the carried block flag were cleared."""
    pair = Pair()
    pair.push("w0", vorbis_stream(0, 3))
    pair.end("w0")
    first = pair.collect()["w0"]
    assert first.shape[0] == 2 and not pair.port._lanes
    second = vorbis_stream(5, 2)
    pair.push("w1", second)
    pair.end("w1")
    assert pair.port._lanes["w1"].index == pair.ref._lanes["w1"].index == CAP - 1
    again = pair.collect()["w1"]
    fresh = StreamFleet(CAP, device="cpu")
    fresh.push("x", second)
    fresh.end_stream("x")
    np.testing.assert_array_equal(again, fresh.collect()["x"])
    model = pair.port._groups["vorbis"]._model
    assert model.lane_ready(CAP - 1) == 0 and model.lane_sample_rate(CAP - 1) == 44100


def test_explicit_vorbis_kind_joins_the_vorbis_group():
    """The explicit kind ``vorbis`` (refused before the group was ported)
    seats an Ogg Vorbis stream with its buffered bytes, as detection
    would."""
    pair = Pair()
    data = vorbis_stream(3, 2)
    pair.push("w0", data[:100])                  # buffered for detection
    pair.push("w0", data[100:], kind="vorbis")   # routed now, with the buffered bytes
    pair.end("w0")
    for f in (pair.port, pair.ref):
        assert f._lanes["w0"].group == "vorbis" and not f._detect
    assert pair.collect()["w0"].shape[0] == 2
    assert pair.rates("w0") == [44100]


def test_bounded_bookkeeping_after_a_churn_of_streams():
    """Thirty streams through two lanes a group: afterwards the fleet
    remembers none of them."""
    port = StreamFleet(2, device="cpu")
    produced = 0
    for i in range(10):
        port.push(f"a{i}", aac_stream(i % 6, i, 2))
        port.push(f"f{i}", flac_stream(i % 4, 1))
        port.push(f"t{i}", tel_stream("g711_mulaw", i, 500), kind="g711_mulaw")
        for sid in (f"a{i}", f"f{i}", f"t{i}"):
            port.end_stream(sid)
        if i % 2:
            produced += len(port.collect())
    port.end_stream("never pushed")
    port.collect()
    assert produced == 30
    assert not (port._lanes or port._detect or port._ended or port._rates or port._retired)
    for kind in ("aac", "flac", "g711_mulaw"):
        g = port._groups[kind]
        assert sorted(g._free) == [0, 1] and g._used == {0, 1}


def test_autodetect_waits_for_min_detect_bytes_or_the_end():
    port = StreamFleet(2, device="cpu")
    data = flac_stream(0, 2)
    assert len(data) > MIN_DETECT
    port.push("f0", data[: MIN_DETECT - 1])
    assert "f0" in port._detect and not port._lanes
    port.push("f0", data[MIN_DETECT - 1: MIN_DETECT])
    assert port._lanes["f0"].group == "flac" and "f0" not in port._detect
    port.push("a0", aac_stream(0, 0, 2))
    assert "a0" in port._detect
    port.end_stream("a0")
    assert port._lanes["a0"].group == "aac"
    port.push("f0", data[MIN_DETECT:])
    out = port.collect()
    assert out["f0"].shape == (2, 2 * 4096) and out["a0"].shape == (2, 2 * 1024)


def test_explicit_kind_skips_detection_and_joins_buffered_bytes():
    pair = Pair()
    data = aac_stream(5, 3, 4)
    pair.push("a0", data[:50])                 # buffered for detection
    pair.push("a0", data[50:], kind="aac")     # routed now, with the buffered bytes
    for f in (pair.port, pair.ref):
        assert f._lanes["a0"].group == "aac" and not f._detect
    assert pair.collect()["a0"].shape == (2, 4 * 1024)


def test_collect_issues_every_group_before_it_fetches(monkeypatch):
    port = StreamFleet(2, device="cpu")
    events = []
    for sid, (data, kind, _) in STREAMS.items():
        if sid in ("a0", "f0", "t0", "t2"):
            port.push(sid, data, kind=kind or ("aac" if sid == "a0" else None))
    real_decode, real_fetch = fleet_mod._BatchedGroup.decode, fleet_mod._fetch
    monkeypatch.setattr(fleet_mod._BatchedGroup, "decode",
                        lambda self, n: events.append(("decode", self.kind)) or real_decode(self, n))
    monkeypatch.setattr(fleet_mod, "_fetch", lambda dev: events.append(("fetch",)) or real_fetch(dev))
    assert len(port.collect()) == 4
    assert [e[0] for e in events] == ["decode"] * 4 + ["fetch"] * 4
    assert {e[1] for e in events[:4]} == {"aac", "flac", "g722", "g726_32"}


def test_quantizers_round_half_to_even_then_clip():
    x = torch.tensor([0.5 / 32767, 1.5 / 32767, -0.5 / 32767, 2.0, -2.0, 2.5 / 32767])
    assert fleet_mod._quantize_f32(x).tolist() == [0, 2, 0, 32767, -32768, 2]
    s = torch.tensor([[[[-1, 70000 * 256, -70000 * 256, 255, -256]]]], dtype=torch.int32)
    assert fleet_mod._quantize_i32(s, torch.tensor([[8]], dtype=torch.int32)).tolist() == \
        [[[[-1, 32767, -32768, 0, -1]]]]
    assert fleet_mod._quantize_i32(s, torch.tensor([[0]], dtype=torch.int32)).tolist() == \
        [[[[-1, 32767, -32768, 255, -256]]]]


def test_unknown_explicit_kind_is_a_plain_value_error():
    pair = Pair()
    for f in (pair.port, pair.ref):
        with pytest.raises(ValueError, match="unknown explicit kind 'pcm'") as e:
            f.push("s", b"abc", kind="pcm")
        assert not isinstance(e.value, FleetUnsupported)
    assert not pair.port._ended and not pair.port._lanes
    with pytest.raises(ValueError, match="out_bits"):
        StreamFleet(1, out_bits=24, device="cpu")


def test_kind_tables_equal_the_jax_package():
    from soundkit_tpu.models import fleet as jax_fleet

    assert TELEPHONY_KINDS == jax_fleet.TELEPHONY_KINDS
    assert HOST_KINDS == jax_fleet.HOST_KINDS
    assert MIN_DETECT == jax_fleet.MIN_DETECT


def test_default_device_is_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamFleet(2)


# ---------------------------------------------------------------------------
# the host fallback: streams without a lane decode beside the groups
# ---------------------------------------------------------------------------

def _wav(seconds: float, rate: int = 16000) -> bytes:
    from soundkit_tpu_torch.core.audio_types import PcmData
    from soundkit_tpu_torch.core.wav import generate_wav_buffer

    rng = np.random.default_rng(21)
    t = np.arange(int(seconds * rate)) / rate
    left = 11000 * np.sin(2 * np.pi * 330 * t) + rng.normal(0, 400, t.size)
    right = 7000 * np.sin(2 * np.pi * 550 * t)
    return generate_wav_buffer(PcmData.i16([left.astype(np.int16), right.astype(np.int16)]), rate)


DETECTED_WITHOUT_A_GROUP = {
    "webm": b"\x1a\x45\xdf\xa3" + bytes(60),
    "wav": _wav(0.1),   # less than MIN_DETECT bytes: routed at its end
    "m4a": bytes(4) + b"ftypM4A " + bytes(20),
    "unknown": bytes(range(1, 64)),
}


def assert_forgotten(fleet, sid):
    for book in (fleet._lanes, fleet._detect, fleet._ended, fleet._fallback, fleet._pending_out):
        assert sid not in book
    assert fleet.sample_rate(sid) is None and sid not in fleet.collect()


def assert_retired(pair, sid):
    """One more collect: the drained host stream is forgotten by both."""
    pair.collect()
    for f in (pair.port, pair.ref):
        assert sid not in f._fallback and sid not in f._ended and sid not in f._pending_out


@pytest.mark.parametrize("name", DETECTED_WITHOUT_A_GROUP)
def test_refuses_a_detected_format_without_a_group_at_end_stream(name):
    """A short stream routed at its end (the name is the earlier slices':
    only what the port cannot decode is refused now): WAV decodes on the
    host; undetected bytes, a bare WebM header and a bare M4A header (whose
    MP4 walk fails) give no PCM, as in the JAX package. Whole M4A and WebM
    streams decode (``test_container_streams_decode_beside_the_lanes``)."""
    data = DETECTED_WITHOUT_A_GROUP[name]
    pair = Pair()
    pair.push("xs", data)
    pair.end("xs")
    for f in (pair.port, pair.ref):
        assert "xs" in f._fallback and "xs" not in f._lanes
    out = pair.collect()
    if name == "wav":
        assert out["xs"].shape == (2, 1600) and pair.rates("xs") == [16000]
    else:
        assert "xs" not in out
    assert_retired(pair, "xs")


@pytest.mark.parametrize("name", ["wav"])
def test_refuses_a_detected_format_without_a_group_at_the_routing_push(name):
    data = _wav(1.0)
    pair = Pair()
    pair.push("xs", data[:MIN_DETECT - 1])
    assert "xs" in pair.port._detect
    pair.push("xs", data[MIN_DETECT - 1:MIN_DETECT + 5000])
    assert "xs" in pair.port._fallback
    first = pair.collect()["xs"]
    pair.push("xs", data[MIN_DETECT + 5000:])
    pair.end("xs")
    second = pair.collect()["xs"]
    assert first.shape[1] + second.shape[1] == 16000 and pair.rates("xs") == [16000]
    assert_retired(pair, "xs")


@pytest.mark.parametrize("kind", HOST_KINDS)
def test_refuses_an_explicit_kind_without_a_group(kind):
    """Every explicit host kind decodes on the host, joined to the bytes
    buffered before its kind came, equal to the JAX fleet's collects (the
    name is the earlier slices': amr_nb and g729 were refused before the
    owned decoders took libavcodec's place)."""
    if kind in ("gsm", "amr_nb", "g729"):
        clip = {"gsm": "gsm_standard", "amr_nb": "amrnb_switch", "g729": "g729_speech"}[kind]
        data = host_codec_fixtures.clip_bytes(clip)
        pair = Pair()
        pair.push("xs", data[:33])
        pair.push("xs", data[33:1000], kind=kind)
        assert "xs" in pair.port._fallback
        first = pair.collect()["xs"]
        pair.push("xs", data[1000:])
        pair.end("xs")
        second = pair.collect()["xs"]
        total = host_codec_fixtures.load_index()[clip]["pcm_bytes"] // 2
        assert first.shape[0] == 1 and first.shape[1] + second.shape[1] == total
        assert pair.rates("xs") == [8000]
        assert_retired(pair, "xs")
        return
    raw = opus_fixtures.lane_raw(opus_fixtures.load_clips(), 1, 30)[0]
    pair = Pair()
    pair.push("xs", raw[:10])
    pair.push("xs", raw[10:2000], kind="opus_raw")
    assert "xs" in pair.port._fallback
    first = pair.collect()["xs"]
    pair.push("xs", raw[2000:])
    pair.end("xs")
    second = pair.collect()["xs"]
    assert first.shape[0] == 2 and first.shape[1] + second.shape[1] == 30 * 960 - 312
    assert pair.rates("xs") == [48000]
    assert_retired(pair, "xs")


FULL_GROUP_STREAMS = {
    # kind: (lane id, overflow ids: x exact, y within 1 LSB)
    "aac": ("a0", "x"), "flac": ("f0", "x"), "g722": ("t0", "x"), "vorbis": ("w0", "x"),
    "mp3": ("m0", "y"), "opus": ("o0", "x"),
}


@pytest.mark.parametrize("kind", FULL_GROUP_STREAMS)
def test_refuses_a_stream_whose_group_is_full(kind):
    """Explicit and detected alike: the stream that finds its group full
    decodes on the host beside the seated one, which is not disturbed,
    and the lane serves the next stream once it is free."""
    data = {"aac": aac_stream(0, 0, 3), "flac": flac_stream(2, 2),
            "g722": tel_stream("g722", 0, 600), "vorbis": vorbis_stream(1, 3),
            "mp3": mp3_stream(0, 0, 40), "opus": opus_stream(0, 25)}[kind]
    lane_id, host = FULL_GROUP_STREAMS[kind]
    pair = Pair(1)
    pair.push(lane_id, data, kind=kind)
    pair.push(f"{host}2", data, kind=kind)
    ids = [lane_id, f"{host}2"]
    if kind != "g722":  # detected from its bytes: at MIN_DETECT bytes, or at the end
        pair.push(f"{host}3", data)
        ids.append(f"{host}3")
    pair.end(*ids)
    for f in (pair.port, pair.ref):
        assert sorted(f._fallback) == sorted(ids[1:])
    out = pair.collect()
    assert sorted(out) == sorted(ids)
    for sid in ids[1:]:
        assert out[sid].shape == out[lane_id].shape, sid
    assert pair.rates(*ids) == pair.rates(lane_id) * len(ids)
    for sid in ids[1:]:
        assert_retired(pair, sid)
    pair.push(f"{lane_id[0]}4", data, kind=kind)
    np.testing.assert_array_equal(pair.collect()[f"{lane_id[0]}4"], out[lane_id])


# reroutes whose host decode runs SILK (the port's resampler): within 1 LSB
LOSSY_REROUTES = ("silk_bandwidth_switch", "mode_switch", "hybrid_redundancy_start")
MULTISTREAM_REROUTES = ("mapping_family_1", "three_channels")


@pytest.mark.parametrize("case", REROUTE_CASES)
def test_refuses_an_opus_lane_the_reference_reroutes(case):
    """An Ogg Opus stream its group hands to the host (a SILK bandwidth
    switch, a 10 ms CELT packet, a code-3 multi-frame packet, a mid-stream
    mode switch, a hybrid stream that starts on transition redundancy) is
    moved at the push that brings the packet (the hybrid one at the push
    after the collect that froze its lane) to a host decoder seeded from
    the lane's packet tail, and decodes on as the JAX package's; its lane
    is reset and freed. A head neither package opens (mapping family 1
    without its channel mapping table, family 0 with three channels) is
    refused at the push that brings it, where the JAX fleet fails to open
    it. A stream of less than a page seats a lane at its end."""
    head, packets, msg = opus_reroute_case(opus_fixtures.load_clips(), case)
    data = ogg_opus(head, packets)
    sid = "ys" if case in LOSSY_REROUTES else "xs"
    pair = Pair(2)
    fleets = (pair.port, pair.ref)
    for f in fleets:
        f.push("o0", opus_stream(2, 12))
    if case == "hybrid_redundancy_start":
        # the walk freezes the lane at the collect; the next push reroutes
        cut = len(data) - len(packets[-1]) - 28  # the last packet's page
        pair.push(sid, data[:cut], kind="opus")
        lane = pair.port._lanes[sid].index
        assert sid not in pair.collect()
        rest = data[cut:]
    else:
        for f in fleets:
            f.push(sid, data[:40])  # most of the OpusHead page: seated at the end, no head yet
            f.end_stream(sid)
        lane = pair.port._lanes[sid].index
        rest = data[40:]
    group = pair.port._groups["opus"]
    if case in MULTISTREAM_REROUTES:
        with pytest.raises(FleetUnsupported, match=f"'{sid}'.*kind 'opus'.*OpusHead of mapping "
                                                   "family.*libavcodec cannot open it either"):
            pair.port.push(sid, rest)
        assert_forgotten(pair.port, sid)
        with pytest.raises(AvDecodeError):
            pair.ref.push(sid, rest)
    else:
        pair.push(sid, rest)
        for f in (pair.port, pair.ref):
            assert sid in f._fallback and sid not in f._lanes
    assert lane in group._free and lane not in group._used
    assert group._model.lane_ready(lane) == 0 and group._model.lane_sample_rate(lane) is None
    assert not group._model._tail[lane] and group._model._emitted[lane] == 0
    if case not in MULTISTREAM_REROUTES:
        pair.end("o0", sid)
        out = pair.collect()
        assert out[sid].shape[0] == 2 and out[sid].shape[1] > 0
        assert out["o0"].shape == (2, 12 * 960)
        assert_retired(pair, sid)


@pytest.mark.parametrize("split", [False, True])
def test_refuses_a_vorbis_stream_of_another_topology(split):
    """A 22.05 kHz mono Ogg Vorbis stream after the group's topology was
    fixed by a 44.1 kHz stereo one moves to the host at the push that
    completes its headers (whole, or after a first push of part of its
    header pages), replayed from its bytes so far; its lane is reset and
    freed, and the seated stream decodes as alone."""
    seated = vorbis_stream(0, 2)
    mono = vorbis_fixtures.load_clips(names=("mono22",))[0].stream()
    pair = Pair(2)
    pair.push("w0", seated)
    cut = 3000 if split else 0
    if split:
        pair.push("xs", mono[:cut], kind="vorbis")  # the identification page: no topology yet
        lane = pair.port._lanes["xs"].index
        assert bytes(pair.port._pretopo["xs"]) == mono[:cut]
    else:
        lane = 0
    pair.push("xs", mono[cut:], kind=None if split else "vorbis")
    for f in (pair.port, pair.ref):
        assert "xs" in f._fallback and "xs" not in f._lanes and "xs" not in f._pretopo
    group = pair.port._groups["vorbis"]
    assert lane in group._free and lane not in group._used
    assert group._model.lane_ready(lane) == 0 and not group._model.lane_configured(lane)
    pair.end("w0", "xs")
    out = pair.collect()
    assert sorted(out) == ["w0", "xs"] and out["xs"].shape[0] == 1
    assert pair.rates("w0", "xs") == [44100, 22050]
    alone = StreamFleet(2, device="cpu")
    alone.push("w0", seated)
    alone.end_stream("w0")
    np.testing.assert_array_equal(out["w0"], alone.collect()["w0"])
    assert_retired(pair, "xs")


@pytest.mark.parametrize("out_bits,device_out", [(16, True), (32, True), (16, False)])
def test_host_streams_in_every_output_mode(out_bits, device_out):
    """Host streams beside lanes under int16 output and device-resident
    collects: a WAV stream, a G.722 overflow stream and an Opus reroute."""
    pair = Pair(1, out_bits)
    head, packets, _ = opus_reroute_case(opus_fixtures.load_clips(), "ten_ms_celt")
    pair.push("t0", tel_stream("g722", 0, 600), kind="g722")
    pair.push("x1", tel_stream("g722", 1, 500), kind="g722")
    pair.push("x2", _wav(0.6))
    pair.push("x3", ogg_opus(head, packets), kind="opus")
    for f in (pair.port, pair.ref):
        assert sorted(f._fallback) == ["x1", "x2", "x3"]
    first = pair.collect(device_out)
    assert sorted(first) == ["t0", "x1", "x2", "x3"]
    pair.end("t0", "x1", "x2", "x3")
    pair.collect(device_out)
    assert_retired(pair, "x2")


def test_refused_streams_never_reach_the_jax_pipeline():
    """Every host stream decodes through the port's pipeline (never the
    JAX package's) on the fleet's device, and a refused stream builds no
    decoder."""
    from soundkit_tpu_torch.models.opus_fleet_model import _OpusTailFallback
    from soundkit_tpu_torch.pipeline.decode_pipeline import StreamDecoder

    port = StreamFleet(1, device="cpu")
    raw = opus_fixtures.lane_raw(opus_fixtures.load_clips(), 1, 4)[0]
    head, packets, _ = opus_reroute_case(opus_fixtures.load_clips(), "code3_multiframe")
    port.push("t0", tel_stream("g711_alaw", 0, 300), kind="g711_alaw")
    port.push("g", tel_stream("g711_alaw", 1, 300), kind="g711_alaw")
    port.push("r", raw, kind="opus_raw")
    port.push("w", _wav(0.6))
    port.push("o", ogg_opus(head, packets), kind="opus")
    assert sorted(port._fallback) == ["g", "o", "r", "w"]
    for sid in "grw":
        dec = port._fallback[sid]
        assert isinstance(dec, StreamDecoder) and dec.device == torch.device("cpu"), sid
    assert isinstance(port._fallback["o"], _OpusTailFallback)
    # a gsm stream decodes on the port's pipeline too (refused before its codec was ported)
    port.push("s1", host_codec_fixtures.clip_bytes("gsm_standard")[:330], kind="gsm")
    assert isinstance(port._fallback["s1"], StreamDecoder)
    assert port._fallback["s1"].device == torch.device("cpu")
    # amr_nb and g729 streams too (refused before the owned decoders came)
    for sid, kind in (("s2", "amr_nb"), ("s3", "g729")):
        port.push(sid, b"\x00" * 40, kind=kind)
        assert isinstance(port._fallback[sid], StreamDecoder)
        assert port._fallback[sid].device == torch.device("cpu")
    # an M4A whose AAC track the owned decoder refuses, at its end: stereo
    # units under a 5.1 config (libavcodec gives no samples for it either)
    _asc, aus = container_fixtures.aac_units("chords", 4)
    port.push("s4", host_codec_fixtures.mux_mp4("aac", bytes([0x11, 0xB0]), aus, 48000, 6, 1024))
    assert "s4" in port._detect
    with pytest.raises(FleetUnsupported,
                       match="'s4'.*host stream.*elements CPE in an access unit of channel "
                             "configuration 6"):
        port.end_stream("s4")
    assert sorted(port._fallback) == ["g", "o", "r", "s1", "s2", "s3", "w"]
    src = open(fleet_mod.__file__).read()
    assert "from soundkit_tpu." not in src and "import soundkit_tpu." not in src


def test_raw_opus_multistream_head_is_refused_at_the_push_that_completes_it():
    """A raw-Opus stream whose OpusHead is multistream is refused once its
    19 head bytes are in, not handed on as an error the fleet drops: the
    raw framing's head never holds a channel mapping table, so the JAX
    package's libavcodec cannot open it either."""
    clip = opus_fixtures.load_clips()[0]
    raw = clip.head[:18] + b"\x01" + struct.pack("<H", len(clip.packets[0])) + clip.packets[0]
    port = StreamFleet(2, device="cpu")
    port.push("r", raw[:12], kind="opus_raw")
    assert "r" in port._fallback
    with pytest.raises(FleetUnsupported, match="'r'.*host stream.*no whole channel mapping table"):
        port.push("r", raw[12:])
    assert_forgotten(port, "r")


@pytest.mark.parametrize("name", ["surround51", "voip255"])
def test_multistream_ogg_opus_streams_decode_on_the_host_fallback(name):
    """A multistream Ogg Opus stream (5.1 by the surround encoder; family
    255 with a silent and a copied channel), routed to the Opus group by
    its kind, seats an Opus lane, is moved at
    the push that brings its head, before any packet is decoded, to the
    host fallback's owned multistream decoder, and gives over the same
    pushes what the JAX fleet gives (libavcodec there): the same collects,
    lengths and channels, each channel at the floors of
    ``tests/test_torch_opus_multistream.py``, and bit for bit the port's
    streaming decode of the stream."""
    from soundkit_tpu_torch.codecs.opus import OggOpusDecoder
    from soundkit_tpu_torch.codecs.opus_multistream import _MultistreamCore
    from soundkit_tpu_torch.tools import opus_ms_fixtures

    from torch_port_helpers import opus_ms_stream_kinds

    floor = {"celt": 104.0, "silk": 84.0, "hybrid": 35.0}
    data = opus_ms_fixtures.clip_bytes(name)
    head, packets = opus_ms_fixtures.head_and_packets(name)
    port, ref = StreamFleet(2, device="cpu"), JaxFleet(2)
    got, want = [], []
    cuts = [0, 300, 3000, len(data) // 2, len(data)]
    for f in (port, ref):
        f.push("o0", opus_stream(2, 12))
    for i, (a, b) in enumerate(zip(cuts, cuts[1:])):
        for f in (port, ref):
            f.push("k", data[a:b], kind="opus" if i == 0 else None)
            if b == len(data):
                f.end_stream("k")
        if i == 0:
            assert "k" in port._fallback and "k" not in port._lanes
            assert isinstance(port._fallback["k"]._core, _MultistreamCore)
            assert port._groups["opus"]._model._emitted == [0, 0]
        g, w = port.collect(), ref.collect()
        assert sorted(g) == sorted(w)
        if "k" in w:
            assert g["k"].shape == w["k"].shape and g["k"].shape[0] == head[9]
            got.append(g["k"])
            want.append(w["k"])
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    for k, kind in enumerate(opus_ms_stream_kinds(head, packets)):
        if kind:
            assert snr_db(got[k], want[k]) >= floor[kind], (k, kind)
    dec = OggOpusDecoder()
    own = np.concatenate([dec.decode_f32(data), dec.flush()]).reshape(-1, head[9]).T
    np.testing.assert_array_equal(got, own)


# detected (AIFF / AIFF-C, ALAC in MP4, AC-3, Ogg Speex) and explicit (gsm) host
# streams of the owned host codecs, beside a telephony lane
HOST_CODEC_STREAMS = {"x-gsm": ("gsm_standard", "gsm"), "x-ac3": ("ac3_stereo", None),
                      "x-ac3-51": ("ac3_51", None), "x-speex": ("speex_wb", None),
                      "x-speex-stereo": ("speex_nb_stereo", None), "x-alac": ("alac_mp4", None),
                      "x-aifc-ulaw": ("aifc_ulaw", None), "x-aiff-24": ("aiff_24", None),
                      "x-aifc-fl64": ("aifc_fl64", None), "x-g729": ("g729_speech", "g729"),
                      "x-amr": ("amrnb_switch", "amr_nb")}


def _lone_decode(data: bytes) -> np.ndarray:
    """A stream's PCM [C, n] from the port's own ``StreamDecoder``, fed whole."""
    from soundkit_tpu_torch.core.audio_pipeline import audio_to_f32_channels
    from soundkit_tpu_torch.core.audio_types import AudioData
    from soundkit_tpu_torch.pipeline.decode_pipeline import StreamDecoder

    dec = StreamDecoder(device="cpu")
    outs = dec.process(data) + dec.process(b"")
    assert outs and all(isinstance(o, AudioData) for o in outs)
    return np.concatenate([np.stack(audio_to_f32_channels(o)) for o in outs], axis=1)


def test_container_streams_decode_beside_the_lanes():
    """Detected M4A AAC and WebM (Opus CELT, SILK, hybrid and Vorbis)
    streams decode on the host fallback beside a G.711 lane, pushed in two
    parts with a collect between (the M4A at its end, as it buffers to
    EOF): each equals its lone ``StreamDecoder`` decode. The WebM Vorbis
    stream also equals the JAX fleet's (the same code); the others
    decode through libavcodec in the JAX fleet, a stated departure
    (``tests/test_torch_container_decode.py``)."""
    vorbis = container_fixtures.build("webm_vorbis")
    pair = Pair()
    pair.push("t0", tel_stream("g711_alaw", 0, 800), kind="g711_alaw")
    pair.push("x-webm-vorbis", vorbis[:len(vorbis) // 2])
    first = pair.collect()
    pair.push("x-webm-vorbis", vorbis[len(vorbis) // 2:])
    pair.end("t0", "x-webm-vorbis")
    second = pair.collect()
    got = np.concatenate([o["x-webm-vorbis"] for o in (first, second)], axis=1)
    np.testing.assert_array_equal(got, _lone_decode(vorbis))
    assert pair.rates("x-webm-vorbis") == [44100]
    assert_retired(pair, "x-webm-vorbis")

    names = ("m4a_aac", "webm_opus_celt", "webm_opus_silk", "webm_opus_hybrid")
    data = {n: container_fixtures.build(n) for n in names}
    port = StreamFleet(CAP, device="cpu")
    port.push("t0", tel_stream("g711_alaw", 0, 800), kind="g711_alaw")
    for n in names:
        port.push(n, data[n][:len(data[n]) // 2])
    first = port.collect()
    assert "m4a_aac" not in first
    for n in names:
        port.push(n, data[n][len(data[n]) // 2:])
        port.end_stream(n)
    assert set(names) <= set(port._fallback) and not set(names) & set(port._lanes)
    second = port.collect()
    for n in names:
        pcm = np.concatenate([o[n] for o in (first, second) if n in o], axis=1)
        want = _lone_decode(data[n])
        e = container_fixtures.load_index()[n]
        assert pcm.shape == want.shape == (e["channels"], e["pcm_bytes"] // 2 // e["channels"])
        np.testing.assert_array_equal(pcm, want, err_msg=n)
        assert port.sample_rate(n) == e["rate"]


def test_host_codec_streams_decode_beside_the_lanes():
    """Each owned host codec's stream decodes on both fleets' host
    fallbacks, bit for bit, pushed in two parts with collects between
    (an AIFF or ALAC file decodes at its end); the G.711 lane beside
    them matches as ever."""
    pair = Pair()
    data = {sid: host_codec_fixtures.clip_bytes(name) for sid, (name, _k) in HOST_CODEC_STREAMS.items()}
    pair.push("t0", tel_stream("g711_alaw", 0, 800), kind="g711_alaw")
    for sid, (_name, kind) in HOST_CODEC_STREAMS.items():
        pair.push(sid, data[sid][:len(data[sid]) // 2], kind=kind)
    first = pair.collect()
    for sid in HOST_CODEC_STREAMS:
        pair.push(sid, data[sid][len(data[sid]) // 2:])
    pair.end("t0", *HOST_CODEC_STREAMS)
    second = pair.collect()
    index = host_codec_fixtures.load_index()
    for sid, (name, _kind) in HOST_CODEC_STREAMS.items():
        e = index[name]
        assert sid in pair.port._fallback or sid in second, sid
        pcm = np.concatenate([o[sid] for o in (first, second) if sid in o], axis=1)
        assert pcm.shape == (e["channels"], round(e["seconds"] * e["rate"])), (sid, pcm.shape)
        assert np.any(pcm), sid  # (both fleets scale 24-bit AIFF PCM by 2^-31)
        assert pair.rates(sid) == [e["rate"]]
    assert "t0" in first and set(HOST_CODEC_STREAMS) <= set(second)
    for sid in HOST_CODEC_STREAMS:
        assert_retired(pair, sid)

