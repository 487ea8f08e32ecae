"""Port parity of the serving runtime: soundkit_tpu_torch's StreamFleet
against the JAX package's on the CPU, driven by the same pushes over the
committed AAC, MP3, FLAC, Ogg Opus, Ogg Vorbis and telephony fixtures.
Collect by collect: the same key sets, dtypes, shapes and sample rates;
FLAC and telephony PCM bit-exact; AAC, MP3 and Opus CELT PCM at 100 dB or
better per collect as f32 (the bar of ``test_torch_aac_lc_model.py``) and
within 1 LSB as int16; Ogg Opus SILK and hybrid streams (ids ``v*``) at
90 dB as f32, the bar of ``test_torch_silk_model.py`` (two float32
syntheses of an LPC of high gain); Ogg Vorbis streams (ids ``w*``) within
2e-6 as f32 (the bar of ``test_torch_vorbis_model.py``). The streams the
JAX fleet hands to its host fallback raise ``FleetUnsupported`` here, one
test per case."""
import numpy as np
import pytest
import torch

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
from soundkit_tpu_torch.tools import (aac_fixtures, flac_fixtures, mp3_fixtures, opus_fixtures,
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
            if device_out:
                assert isinstance(g, FleetLaneOutput)
                assert (g.kind, g.samples, g.rate, g.lane, g.frames, g.out_bits) == \
                    (w.kind, w.samples, w.rate, w.lane, w.frames, w.out_bits), sid
                # a Vorbis lane's ragged PCM is made on the host
                if g.kind == "vorbis":
                    assert isinstance(g.host, np.ndarray) and g.device is None
                else:
                    assert isinstance(g.device, torch.Tensor)
                g, w = g.fetch(), w.fetch()
                assert g.shape[-1] == got[sid].samples
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (sid, g.dtype, w.dtype, g.shape, w.shape)
            if not sid.startswith(("a", "m", "o", "v", "w")):
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
    the JAX fleet."""
    pair = Pair(8)
    first = {"v0": voice_stream("silk_nb", 0, 20), "v1": voice_stream("silk_mb", 1, 16),
             "v2": voice_stream("silk_wb_stereo", 2, 22), "v3": voice_stream("hybrid_swb", 3, 14),
             "v4": voice_stream("hybrid_fb", 0, 19), "o0": opus_stream(0, 12)}
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
    assert got["v6"].shape == (2, 11 * 960)  # hybrid: the OpusHead's pre-skip is not taken


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


@pytest.mark.parametrize("split", [False, True])
def test_refuses_a_vorbis_stream_of_another_topology(split):
    """A 22.05 kHz mono Ogg Vorbis stream after the group's topology was
    fixed by a 44.1 kHz stereo one raises at the push that completes its
    headers (whole, or after a first push of part of its header pages);
    the refusal carries the stream's bytes so far, its lane is reset and
    freed, the stream forgotten, and the seated stream decodes as alone."""
    seated = vorbis_stream(0, 2)
    mono = vorbis_fixtures.load_clips(names=("mono22",))[0].stream()
    port = StreamFleet(2, device="cpu")
    port.push("ok", seated)
    cut = 3000 if split else 0
    if split:
        port.push("s", mono[:cut], kind="vorbis")  # the identification page: no topology yet
        lane = port._lanes["s"].index
        assert bytes(port._pretopo["s"]) == mono[:cut]
    else:
        lane = 0
    with pytest.raises(FleetUnsupported, match=r"'s'.*kind 'vorbis'.*topology \(512, 1024, 1\) "
                                               r"!= model topology \(256, 2048, 2\).*reroutes") as e:
        port.push("s", mono[cut:], kind=None if split else "vorbis")
    assert e.value.raw == mono
    for book in (port._lanes, port._detect, port._ended, port._pretopo):
        assert "s" not in book
    assert port.sample_rate("s") is None and "ok" not in port._pretopo
    group = port._groups["vorbis"]
    assert lane in group._free and lane not in group._used
    assert group._model.lane_ready(lane) == 0 and not group._model.lane_configured(lane)
    port.end_stream("ok")
    alone = StreamFleet(2, device="cpu")
    alone.push("ok", seated)
    alone.end_stream("ok")
    out = port.collect()
    assert sorted(out) == ["ok"]
    np.testing.assert_array_equal(out["ok"], alone.collect()["ok"])


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
# what the reference sends to its host fallback
# ---------------------------------------------------------------------------

def _ogg_first_page(payload: bytes) -> bytes:
    return b"OggS" + bytes(22) + b"\x01" + bytes([len(payload)]) + payload


DETECTED_WITHOUT_A_GROUP = {
    "webm": b"\x1a\x45\xdf\xa3" + bytes(60),
    "wav": b"RIFF" + bytes(4) + b"WAVEfmt " + bytes(40),
    "m4a": bytes(4) + b"ftypM4A " + bytes(20),
    "unknown": bytes(range(1, 64)),
}


def assert_forgotten(fleet, sid):
    assert sid not in fleet._lanes and sid not in fleet._detect and sid not in fleet._ended
    assert fleet.sample_rate(sid) is None and sid not in fleet.collect()


@pytest.mark.parametrize("name", DETECTED_WITHOUT_A_GROUP)
def test_refuses_a_detected_format_without_a_group_at_end_stream(name):
    port = StreamFleet(2, device="cpu")
    port.push("s", DETECTED_WITHOUT_A_GROUP[name])
    with pytest.raises(FleetUnsupported, match=f"'s'.*detected format '{name}'.*no batched group"):
        port.end_stream("s")
    assert_forgotten(port, "s")


@pytest.mark.parametrize("name", ["wav"])
def test_refuses_a_detected_format_without_a_group_at_the_routing_push(name):
    port = StreamFleet(2, device="cpu")
    data = DETECTED_WITHOUT_A_GROUP[name] + bytes(MIN_DETECT)
    port.push("s", data[:MIN_DETECT - 1])
    with pytest.raises(FleetUnsupported, match=f"detected format '{name}'"):
        port.push("s", data[MIN_DETECT - 1:])
    assert_forgotten(port, "s")


@pytest.mark.parametrize("kind", HOST_KINDS)
def test_refuses_an_explicit_kind_without_a_group(kind):
    port = StreamFleet(2, device="cpu")
    port.push("s", b"early bytes")
    with pytest.raises(FleetUnsupported, match=f"kind '{kind}'.*no batched group"):
        port.push("s", b"\x00" * 33, kind=kind)
    assert_forgotten(port, "s")


@pytest.mark.parametrize("kind", ["aac", "flac", "g722", "vorbis"])
def test_refuses_a_stream_whose_group_is_full(kind):
    """Explicit and detected alike; the seated stream is not disturbed,
    and the lane serves the next stream once it is free."""
    data = {"aac": aac_stream(0, 0, 3), "flac": flac_stream(2, 2),
            "g722": tel_stream("g722", 0, 600), "vorbis": vorbis_stream(1, 3)}[kind]
    port = StreamFleet(1, device="cpu")
    port.push("first", data, kind=kind)
    with pytest.raises(FleetUnsupported, match=f"'second'.*kind '{kind}'.*group is full \\(1 lanes\\)"):
        port.push("second", data, kind=kind)
    if kind != "g722":  # detected from its bytes: at MIN_DETECT bytes, or at the end
        with pytest.raises(FleetUnsupported, match="'third'.*group is full"):
            port.push("third", data)
            port.end_stream("third")
    port.end_stream("first")
    out = port.collect()
    assert sorted(out) == ["first"]
    assert_forgotten(port, "second")
    assert_forgotten(port, "third")
    port.push("fourth", data, kind=kind)
    np.testing.assert_array_equal(port.collect()["fourth"], out["first"])


@pytest.mark.parametrize("case", REROUTE_CASES)
def test_refuses_an_opus_lane_the_reference_reroutes(case):
    """An Ogg Opus stream that the JAX package's group hands to its host
    decoder (a SILK bandwidth switch, a 10 ms CELT packet, a code-3
    multi-frame packet, mapping family 1, three channels, a mid-stream
    mode switch) raises at the push that brings the head or the packet,
    a hybrid stream that starts on transition redundancy at the push
    after the collect that froze its lane;
    its lane is reset and freed, the stream forgotten, and the next Opus
    stream takes the lane and decodes. A stream of less than a page seats
    a lane at its end."""
    head, packets, msg = opus_reroute_case(opus_fixtures.load_clips(), case)
    data = ogg_opus(head, packets)
    port = StreamFleet(2, device="cpu")
    port.push("ok", opus_stream(2, 12))
    if case == "hybrid_redundancy_start":
        # the walk freezes the lane at the collect; the next push raises
        cut = len(data) - len(packets[-1]) - 28  # the last packet's page
        port.push("s", data[:cut], kind="opus")
        lane = port._lanes["s"].index
        assert "s" not in port.collect()
        rest = data[cut:]
    else:
        port.push("s", data[:40])  # most of the OpusHead page: seated at the end, no head yet
        port.end_stream("s")
        lane = port._lanes["s"].index
        rest = data[40:]
    with pytest.raises(FleetUnsupported, match=f"'s'.*kind 'opus'.*{msg}.*reroutes"):
        port.push("s", rest)
    assert_forgotten(port, "s")
    group = port._groups["opus"]
    assert lane in group._free and lane not in group._used
    assert group._model.lane_ready(lane) == 0 and group._model.lane_sample_rate(lane) is None
    port.end_stream("ok")
    assert port.collect()["ok"].shape == (2, 12 * 960)


def test_refused_streams_never_reach_the_jax_pipeline():
    """The port's fleet module names no host decoder at all."""
    src = open(fleet_mod.__file__).read()
    assert "StreamDecoder" not in src and "decode_pipeline" not in src
