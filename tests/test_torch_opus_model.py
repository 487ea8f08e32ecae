"""Port parity of the batched Opus CELT decoder and the Ogg Opus group:
soundkit_tpu_torch's ``BatchedCeltDecoder(device="cpu")`` and
``BatchedOggOpusDecoder(device="cpu")`` against the JAX package's on the
committed Ogg Opus fixtures (tests/data/torch_port/opus: libopus clips
with the comb postfilter and transient frames, pre-skip 312, a mono clip
in stereo lanes, an owned-encoder clip with pre-skip 0, a clip with an
OpusHead output gain), from the same pushes, on both spectral wires: per
lane the same slot lengths, integer for integer, and PCM at 100 dB or
better (float32 sums in another order; the AAC bar), the carried state
within 1e-5 of its largest value; and at 90 dB or better against the JAX
package's host ``OpusStreamDecoder``, the bar of its own batched-CELT
test. The lanes the JAX package's group reroutes to its host decoder
raise ``OpusLaneUnsupported`` here, one case each (the group's SILK and
hybrid lanes are held in tests/test_torch_silk_model.py)."""
import struct

import numpy as np
import pytest

from soundkit_tpu.models.opus_batch import BatchedCeltDecoder as JaxCelt
from soundkit_tpu.models.opus_fleet_model import BatchedOggOpusDecoder as JaxOgg
from soundkit_tpu_torch.codecs.opus_core import OpusUnsupported
from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder
from soundkit_tpu_torch.models.opus_fleet_model import (
    BatchedOggOpusDecoder,
    OpusLaneUnsupported,
)
from soundkit_tpu_torch.tools import opus_fixtures
from torch_port_helpers import REROUTE_CASES, lane_snrs, ogg_opus, opus_reroute_case, snr_db

B = 8  # two lanes of each clip, ragged starts


@pytest.fixture(scope="module")
def clips():
    return opus_fixtures.load_clips()


def assert_states_close(port, ref):
    for got, want in ((port._ola, ref._ola), (port._hist, ref._hist), (port._emph, ref._emph)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def assert_collects_match(got, want):
    (g, gl), (w, wl) = got, want
    g = g.numpy() if hasattr(g, "numpy") else g
    w = np.asarray(w)
    np.testing.assert_array_equal(gl, wl)
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    assert lane_snrs(g, w, lane_axis=1).min() >= 100


@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_ragged_lanes_match_jax_collect_by_collect(clips, wire):
    """Raw-Opus lanes pushed in two parts, three collects (the middle one
    bounded), the last one draining every lane while the short ones idle
    with frozen state; host output (valid samples at the START)."""
    raws = [opus_fixtures.lane_raw(clips, B, 40 - 4 * i)[i] for i in range(B)]
    raws[5] = raws[5][: len(raws[5]) // 3]  # a short lane that idles
    port, ref = BatchedCeltDecoder(B, 2, wire=wire, device="cpu"), JaxCelt(B, 2, wire=wire)
    cuts = [len(r) * 2 // 5 for r in raws]
    for m in (port, ref):
        for i, r in enumerate(raws):
            m.push(i, r[: cuts[i]])
    assert [port.queued(i) for i in range(B)] == [ref.queued(i) for i in range(B)]
    assert_collects_match(port.decode_ready(max_packets=6), ref.decode_ready(max_packets=6))
    for m in (port, ref):
        for i, r in enumerate(raws):
            m.push(i, r[cuts[i]:])
    assert_collects_match(port.decode_ready(max_packets=9), ref.decode_ready(max_packets=9))
    counts = [port.queued(i) for i in range(B)]
    assert counts == [ref.queued(i) for i in range(B)] and len(set(counts)) > 2
    got, want = port.decode_ready(), ref.decode_ready()
    assert_collects_match(got, want)
    assert port.ready_packets == 0 and got[0].shape[0] == max(counts)
    assert_states_close(port, ref)


@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_push_forms_and_device_out_match_jax(clips, wire):
    """The same stream fed as the raw-Opus wire in odd chunks, packet by
    packet (``configure_lane`` for the head) and as TOC-split frames: the
    same slots; ``device_out`` gives a tensor with the valid samples at
    the END of each slot, equal to the host convention's slots shifted."""
    clip = clips[0]
    packets = clip.packets[:30]
    raw = clip.head + b"".join(struct.pack("<H", len(p)) + p for p in packets)
    port = BatchedCeltDecoder(3, 2, wire=wire, device="cpu")
    ref = JaxCelt(3, 2, wire=wire)
    for m in (port, ref):
        for i in range(0, len(raw), 37):
            m.push(0, raw[i: i + 37])
        m.configure_lane(1, clip.pre_skip, clip.output_gain)
        for p in packets:
            m.push_packet(1, p)
        m.configure_lane(2, clip.pre_skip, clip.output_gain)
        for p in packets:
            frame, end, coded = m._frame_of(p)
            m.push_frame(2, frame, end, coded)
    assert [port.queued(i) for i in range(3)] == [30, 30, 30]
    dev, dev_len = port.decode_ready(device_out=True)
    want, want_len = ref.decode_ready(device_out=True)
    np.testing.assert_array_equal(dev_len, want_len)
    assert dev_len[0, 0] == 960 - clip.pre_skip and (dev_len[1:] == 960).all()
    assert lane_snrs(dev.numpy(), np.asarray(want), lane_axis=1).min() >= 100
    np.testing.assert_array_equal(dev[:, 0], dev[:, 1])
    np.testing.assert_array_equal(dev[:, 0], dev[:, 2])
    # the host convention: the same valid samples at the START
    host = BatchedCeltDecoder(1, 2, wire=wire, device="cpu")
    host.push(0, raw)
    pcm, lens = host.decode_ready()
    np.testing.assert_array_equal(lens[:, 0], dev_len[:, 0])
    for i in range(30):
        k = int(lens[i, 0])
        np.testing.assert_array_equal(pcm[i, 0, :, :k], dev.numpy()[i, 0, :, 960 - k:])
        assert not pcm[i, 0, :, k:].any()


@pytest.mark.parametrize("name", ["owned", "gain", "mono64"])
def test_pre_skip_gain_and_mono_lanes_match_jax(clips, name):
    """The owned encoder's clip (pre-skip 0, no postfilter), the clip with
    an OpusHead output gain (folded into the spectra, or into the scales
    on the int16 wire) and the mono clip in stereo lanes (the parse
    duplicates the channel), on both wires."""
    clip = clips[opus_fixtures.CLIPS.index(name)]
    raw = clip.head + b"".join(struct.pack("<H", len(p)) + p for p in clip.packets[:25])
    for wire in ("f32", "i16"):
        port, ref = BatchedCeltDecoder(2, 2, wire=wire, device="cpu"), JaxCelt(2, 2, wire=wire)
        for m in (port, ref):
            m.push(0, raw)
            m.push(1, raw[: len(raw) // 2])
        got, want = port.decode_ready(), ref.decode_ready()
        assert_collects_match(got, want)
        assert got[1][0, 0] == 960 - clip.pre_skip
        if name == "mono64":
            np.testing.assert_array_equal(got[0][:, :, 0], got[0][:, :, 1])
        assert_states_close(port, ref)


def test_reset_lane_matches_jax(clips):
    raws = opus_fixtures.lane_raw(clips, 4, 12)
    port, ref = BatchedCeltDecoder(4, 2, device="cpu"), JaxCelt(4, 2)
    for m in (port, ref):
        for i, r in enumerate(raws):
            m.push(i, r)
        m.decode_ready(max_packets=5)
        m.reset_lane(1)
        m.reset_lane(3)
        assert m.queued(1) == 0
        m.push(1, raws[2])
    got, want = port.decode_ready(), ref.decode_ready()
    assert_collects_match(got, want)
    assert not got[0][:, 3].any()
    # lane 1 now decodes lane 2's stream from a clean state: as a fresh decoder's lane
    fresh = BatchedCeltDecoder(1, 2, device="cpu")
    fresh.push(0, raws[2])
    pcm, lens = fresh.decode_ready()
    np.testing.assert_array_equal(got[1][:, 1], lens[:, 0])
    np.testing.assert_array_equal(got[0][:, 1], pcm[:, 0])


@pytest.mark.parametrize("name", ["stereo96", "mono64", "owned"])
def test_decode_against_the_host_decoder(clips, name):
    """The whole clip through the port's decoder against the JAX
    package's host ``OpusStreamDecoder`` (its own single-stream CELT
    synthesis in float64)."""
    from soundkit_tpu.codecs.opus import OpusStreamDecoder

    clip = clips[opus_fixtures.CLIPS.index(name)]
    raw = clip.head + b"".join(struct.pack("<H", len(p)) + p for p in clip.packets)
    ref = OpusStreamDecoder().decode_f32(raw).reshape(-1, clip.channels).T.astype(np.float64)
    model = BatchedCeltDecoder(1, clip.channels, device="cpu")
    model.push(0, raw)
    pcm, lens = model.decode_ready()
    got = np.concatenate([pcm[i, 0, :, : lens[i, 0]] for i in range(len(lens))], axis=1)
    assert got.shape == ref.shape
    for ch in range(clip.channels):
        assert snr_db(got[ch], ref[ch]) >= 90, (name, ch)


def test_a_failed_parse_and_unservable_packets_raise(clips):
    model = BatchedCeltDecoder(2, 1, device="cpu")
    with pytest.raises(OpusUnsupported, match="stereo packet in a mono lane"):
        model.push_packet(0, clips[0].packets[0])
    silk = bytes([(1 << 3) | 0]) + bytes(20)  # SILK NB 20 ms
    with pytest.raises(OpusUnsupported, match="single-frame 20 ms CELT"):
        model.push_packet(0, silk)
    model.push_frame(1, clips[1].packets[0][1:], 21, 3)  # three coded channels: the parse fails
    with pytest.raises(OpusUnsupported, match="native celt parse failed on lane 1"):
        model.decode_ready()
    with pytest.raises(ValueError, match="wire"):
        BatchedCeltDecoder(1, 2, wire="i8", device="cpu")


# ---------------------------------------------------------------------------
# the Ogg Opus group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_ogg_group_matches_jax(clips, wire):
    """Ogg lanes of every clip pushed in odd chunks over two collects; the
    group's slots (valid at the END with ``device_out``, at the START
    otherwise) against the JAX package's group."""
    streams = opus_fixtures.lane_streams(clips, B, 30)
    port = BatchedOggOpusDecoder(B, 2, celt_wire=wire, device="cpu")
    ref = JaxOgg(B, 2, celt_wire=wire)
    assert ref._silk is not None and ref._hyb is not None  # the JAX group is whole here
    for half, device_out in ((0, True), (1, False)):
        for m in (port, ref):
            for i, s in enumerate(streams):
                part = s[: len(s) // 2] if half == 0 else s[len(s) // 2:]
                for k in range(0, len(part), 1000):
                    m.push(i, part[k: k + 1000])
        assert [port.lane_ready(i) for i in range(B)] == [ref.lane_ready(i) for i in range(B)]
        n = max(port.lane_ready(i) for i in range(B))
        assert_collects_match(port.decode_batches(n, device_out), ref.decode_batches(n, device_out))
    assert [port.lane_sample_rate(i) for i in range(B)] == [48000] * B
    port.reset_lane(3)
    assert port.lane_sample_rate(3) is None and port.lane_ready(3) == 0


@pytest.mark.parametrize("case", REROUTE_CASES)
def test_lanes_the_reference_reroutes_raise(clips, case):
    """Each lane the JAX package's group hands to its host decoder raises
    ``OpusLaneUnsupported`` out of the port's ``push``, and the JAX group
    raises its own for the same bytes: at the push that brings the head
    or the packet, or, for a hybrid stream that starts on a transition-
    redundancy packet, at the push after the decode that froze the lane."""
    from soundkit_tpu.models.opus_fleet_model import OpusLaneUnsupported as JaxUnsupported

    head, packets, msg = opus_reroute_case(clips, case)
    data = ogg_opus(head, packets)
    port = BatchedOggOpusDecoder(2, 2, device="cpu")
    ref = JaxOgg(2, 2)
    if case == "hybrid_redundancy_start":
        cut = len(data) - len(packets[-1]) - 28  # the last packet's page
        for m in (port, ref):
            m.push(0, data[:cut])
        assert port.lane_ready(0) == len(packets) - 1
        _, lens = port.decode_batches(len(packets) - 1)
        ref.decode_batches(len(packets) - 1)
        assert lens[:, 0].sum() == 0
        data = data[cut:]
    port.push(1, opus_fixtures.lane_streams(clips, 1, 4)[0])  # a lane beside it
    with pytest.raises(OpusLaneUnsupported, match=msg) as got:
        port.push(0, data)
    with pytest.raises(JaxUnsupported, match=msg) as want:
        ref.push(0, data)
    # the replay that seeds the fleet's host decoder: the same tail and accounting
    g, w = got.value.replay, want.value.replay
    assert g.keys() == w.keys()
    assert g["head"].raw == w["head"].raw and g["tail"] == w["tail"] and g["pending"] == w["pending"]
    assert (g["dropped"], g["emitted"]) == (w["dropped"], w["emitted"])
    port.reset_lane(0)
    assert port.lane_ready(0) == 0 and port.lane_ready(1) == 4
    pcm, lens = port.decode_batches(4)
    assert lens[:, 0].sum() == 0 and (lens[:, 1] > 0).all()


def test_reroute_tail_stays_bounded_as_in_the_jax_package(clips):
    """A lane keeps its undecoded queue and TAIL_KEEP decoded packets, and
    counts the samples it delivered and the 48 kHz samples it trimmed, as
    the JAX package's group does, collect by collect."""
    clip = clips[1]
    data = ogg_opus(clip.head, (clip.packets * 2)[:220])
    port, ref = BatchedOggOpusDecoder(2, 2, device="cpu"), JaxOgg(2, 2)
    assert port.TAIL_KEEP == ref.TAIL_KEEP == 96
    cuts = [0, len(data) // 3, 2 * len(data) // 3, len(data)]
    for a, b in zip(cuts, cuts[1:]):
        for m in (port, ref):
            m.push(0, data[a:b])
            m.decode_batches(m.lane_ready(0) - 10)
        assert port._tail[0] == ref._tail[0]
        assert (port._tail_dropped[0], port._emitted[0]) == (ref._tail_dropped[0], ref._emitted[0])
    assert port._tail_dropped[0] > 0 and len(port._tail[0]) == 10 + 96
    assert port.lane_configured(0) and not port.lane_configured(1)
    port.reset_lane(0)
    assert (port._tail[0], port._tail_dropped[0], port._emitted[0]) == ([], 0, 0)
