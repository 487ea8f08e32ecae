"""Port parity of the batched SILK and hybrid Opus decoders and of the Ogg
Opus group with all three engines: soundkit_tpu_torch's
``BatchedSilkDeviceDecoder``, ``BatchedHybridDecoder`` and
``BatchedOggOpusDecoder`` (``device="cpu"``) against the JAX package's,
from the same pushes of the committed voice fixtures
(tests/data/torch_port/opus: libopus SILK NB / MB / WB mono, SILK WB
stereo with mono-coded and mid-only frames, hybrid SWB mono and FB
stereo), and against the JAX package's host decoders.

Bars: slot lengths identical, integer for integer. Against the host
decoders (the per-stream oracle of tests/test_silk_device.py, the JAX
package's native SILK decoder and libswresample; its Ogg Opus host
decoder for hybrid), 95 dB per channel over whole clips: the bar the JAX
package holds its own float32 serving path to. Against the JAX batched
decoders, 90 dB per lane: both decode in float32, and each lies 97-103
dB from the host decoders on these clips (the JAX decoders 96.8-102.1,
the port 98.1-103.0, measured on whole clips: an LPC of high gain
amplifies the rounding of its sums), so the two lie 94-100 dB apart;
tests/test_torch_silk_ops.py holds the two packages' synthesis to 1e-9
of its largest value in float64."""
import numpy as np
import pytest

from soundkit_tpu.models.opus_batch import BatchedHybridDecoder as JaxHybrid
from soundkit_tpu.models.opus_batch import BatchedSilkDeviceDecoder as JaxSilk
from soundkit_tpu.models.opus_fleet_model import BatchedOggOpusDecoder as JaxOgg
from soundkit_tpu_torch.models import opus_batch
from soundkit_tpu_torch.models.opus_batch import BatchedHybridDecoder, BatchedSilkDeviceDecoder
from soundkit_tpu_torch.models.opus_fleet_model import BatchedOggOpusDecoder, OpusLaneUnsupported
from soundkit_tpu_torch.tools import opus_fixtures
from torch_port_helpers import hybrid_redundancy_packets, lane_snrs, ogg_opus, snr_db

SNR = 90          # against the JAX batched decoders
ORACLE_SNR = 95   # against the host decoders


@pytest.fixture(scope="module")
def voice():
    return {c.name: c for c in opus_fixtures.load_clips(names=opus_fixtures.VOICE_CLIPS)}


def assert_collects_match(got, want, snr=SNR):
    (g, gl), (w, wl) = got, want
    g = g.numpy() if hasattr(g, "numpy") else g
    w = np.asarray(w)
    np.testing.assert_array_equal(gl, wl)
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    assert lane_snrs(g, w, lane_axis=1).min() >= snr


def push_lanes(models, clips, frames, configure=()):
    for m in models:
        for b in configure:
            m.configure_lane(b, clips[b].pre_skip, clips[b].output_gain)
        for b, fr in enumerate(frames):
            for frame, bw, coded in fr:
                m.push_packet(b, frame, bw, coded)


def test_silk_lanes_match_jax_collect_by_collect(voice):
    """Eight ragged stereo lanes, two of each SILK clip (NB, MB with an
    OpusHead gain, WB, WB stereo), the first four with their OpusHead's
    pre-skip and gain; a bounded collect, a second push, a lane recycled
    onto another clip, and the rest; host slots and ``device_out`` alike
    (valid samples at the END)."""
    names = ("silk_nb", "silk_mb", "silk_wb", "silk_wb_stereo")
    clips = [voice[n] for n in names] * 2
    frames = [opus_fixtures.lane_frames(clips, b, 40 - 3 * b) for b in range(8)]
    port, ref = BatchedSilkDeviceDecoder(8, 2, device="cpu"), JaxSilk(8, 2)
    push_lanes((port, ref), clips, [f[: len(f) // 2] for f in frames], configure=range(4))
    assert [port.lane_ready(b) for b in range(8)] == [ref.lane_ready(b) for b in range(8)]
    assert_collects_match(port.decode_ready(max_packets=7), ref.decode_ready(max_packets=7))
    push_lanes((port, ref), clips, [f[len(f) // 2:] for f in frames])
    for m in (port, ref):
        m.reset_lane(5)
        for frame, bw, coded in opus_fixtures.lane_frames(clips, 3, 12):
            m.push_packet(5, frame, bw, coded)
    got = port.decode_ready(max_packets=9, device_out=True)
    assert_collects_match((got[0].numpy(), got[1]), ref.decode_ready(max_packets=9))
    got, want = port.decode_ready(), ref.decode_ready()
    assert_collects_match(got, want)
    assert port.lane_ready(0) == 0 and len({len(f) for f in frames}) > 4
    for bw in port._state:
        for g, w in zip(port._state[bw], ref._state[bw]):
            assert g.shape == np.asarray(w).shape


def test_silk_lengths_follow_the_lead_and_the_pre_skip(voice):
    port = BatchedSilkDeviceDecoder(3, 2, device="cpu")
    for b, name in enumerate(("silk_nb", "silk_mb", "silk_wb")):
        clip = voice[name]
        port.configure_lane(b, 100 * b, 0)
        for frame, bw, coded in opus_fixtures.lane_frames([clip], 0, 4):
            port.push_packet(b, frame, bw, coded)
    _, lens = port.decode_ready()
    np.testing.assert_array_equal(lens[0], [960 - 23, 960 - 100, 960 - 200])
    assert (lens[1:] == 960).all()


@pytest.mark.parametrize("name,channels", [("silk_nb", 1), ("silk_mb", 1),
                                           ("silk_wb_stereo", 2)])
def test_silk_lane_against_the_host_oracle(voice, name, channels):
    """One lane of a whole clip against ``tests/test_silk_device.py``'s
    per-stream host oracle (the JAX package's native SILK decoder and its
    libswresample resampler), which has no pre-skip: the port's first
    slot is short by the resampler's lead, as the JAX model's is."""
    from test_silk_device import _oracle_stream

    clip = voice[name]
    fr = opus_fixtures.lane_frames([clip], 0)
    model = BatchedSilkDeviceDecoder(1, channels, device="cpu")
    for frame, bw, coded in fr:
        model.push_packet(0, frame, bw, coded)
    pcm, lens = model.decode_ready()
    got = np.concatenate([pcm[i, 0, :, 960 - lens[i, 0]:] for i in range(len(lens))], axis=1).T
    ref = _oracle_stream([f for f, _, _ in fr], fr[0][1], [c for _, _, c in fr])
    m = min(len(ref), len(got))
    assert m >= len(fr) * 960 - 24
    for ch in range(channels):
        assert snr_db(got[:m, ch], ref[:m, ch]) >= ORACLE_SNR, (name, ch)


def hybrid_lanes(voice, B, n=None):
    clips = [voice["hybrid_swb"], voice["hybrid_fb"]]
    return clips, [opus_fixtures.lane_frames(clips, b, n if n is None else n - 2 * b)
                   for b in range(B)]


def test_hybrid_lanes_match_jax_collect_by_collect(voice):
    """Six ragged lanes of the SWB mono and FB stereo clips, one with a
    pre-skip and a gain set on the decoder; a collect of 11 rounds (a
    chunk of 8 and a padded one), a recycled lane, and the rest."""
    clips, frames = hybrid_lanes(voice, 6, 30)
    port, ref = BatchedHybridDecoder(6, 2, device="cpu"), JaxHybrid(6, 2)
    for m in (port, ref):
        m.configure_lane(2, 500, -300)
    push_lanes((port, ref), clips, frames)
    first = port.decode_ready(max_packets=11)
    assert_collects_match(first, ref.decode_ready(max_packets=11))
    assert first[1][0, 2] == 960 - 500 and first[1][0, 0] == 960
    for m in (port, ref):
        m.reset_lane(1)
        for frame, bw, coded in opus_fixtures.lane_frames(clips, 4, 9):
            m.push_packet(1, frame, bw, coded)
    got = port.decode_ready(device_out=True)
    assert_collects_match((got[0].numpy(), got[1]), ref.decode_ready())
    for g, w in zip((*port._silk_state, *port._celt_state), (*ref._silk_state, *ref._celt_state)):
        assert g.shape == np.asarray(w).shape


@pytest.mark.parametrize("name", ["hybrid_swb", "hybrid_fb"])
def test_hybrid_lane_against_the_host_decoder(voice, name):
    """A whole hybrid clip, with its OpusHead's pre-skip set on the
    decoder, against the JAX package's host ``OggOpusDecoder``."""
    from soundkit_tpu.codecs.opus import OggOpusDecoder

    clip = voice[name]
    ref = OggOpusDecoder().decode_f32(clip.stream()).reshape(-1, clip.channels).T
    model = BatchedHybridDecoder(1, clip.channels, device="cpu")
    model.configure_lane(0, clip.pre_skip, clip.output_gain)
    for frame, bw, coded in opus_fixtures.lane_frames([clip], 0):
        model.push_packet(0, frame, bw, coded)
    pcm, lens = model.decode_ready()
    got = np.concatenate([pcm[i, 0, :, 960 - lens[i, 0]:] for i in range(len(lens))], axis=1)
    assert got.shape == ref.shape
    for ch in range(clip.channels):
        assert snr_db(got[ch], ref[ch]) >= ORACLE_SNR, (name, ch)


def test_hybrid_int16_overflow_rebuilds_the_wire_without_a_second_walk(voice):
    """The JAX regression ``test_hybrid_exc_overflow_fallback_matches_packed_path``:
    a walk that reports an int16 excitation overflow makes the decoder
    rebuild the float32 wire from the planes already walked (the SILK
    parameters are delta-coded across frames, so the lanes must not be
    walked twice); the decode equals the int16 wire's."""
    clips, frames = hybrid_lanes(voice, 2, 20)

    def run(force):
        dec = BatchedHybridDecoder(2, 2, device="cpu")
        walks = []
        if force:
            orig = dec._silk.hybrid_parse_rounds_packed

            def flagged(celt, buf, base, plens, ends, coded, wire, offs, exc_f64, **k):
                _, n, ok, red = orig(celt, buf, base, plens, ends, coded, wire, offs, exc_f64,
                                     **k)
                walks.append(plens.shape)
                v = opus_batch._wire_views(wire, plens.shape[1], plens.shape[0], 2, True)
                np.copyto(exc_f64, v["exc"].astype(np.float64) * (1.0 / opus_batch._EXC_Q))
                return 1, n, ok, red

            dec._silk.hybrid_parse_rounds_packed = flagged
        push_lanes((dec,), clips, frames)
        pcm, lens = dec.decode_ready()
        return pcm, lens, walks

    a, al, _ = run(False)
    b, bl, walks = run(True)
    assert len(walks) == 3  # 20 rounds: three chunks of 8, each walked once
    np.testing.assert_array_equal(al, bl)
    np.testing.assert_array_equal(a, b)
    assert al.sum() > 0


def test_hybrid_stream_that_starts_on_redundancy_freezes_its_lane(voice):
    """A lane whose first packet carries transition redundancy is frozen
    by the walk (no output, ``lane_error``), as the JAX decoder's; the
    lane beside it decodes."""
    clips, frames = hybrid_lanes(voice, 2, 12)
    red = hybrid_redundancy_packets(5)
    port, ref = BatchedHybridDecoder(2, 2, device="cpu"), JaxHybrid(2, 2)
    from soundkit_tpu_torch.codecs.opus_core import parse_packet

    for m in (port, ref):
        for frame, bw, coded in frames[1]:
            m.push_packet(1, frame, bw, coded)
        for pkt in red:
            toc, fr = parse_packet(pkt)
            m.push_packet(0, fr[0], toc.bandwidth, 2 if toc.stereo else 1)
    got, want = port.decode_ready(), ref.decode_ready()
    assert_collects_match(got, want)
    assert port.lane_error(0) == ref.lane_error(0) == "hybrid transition redundancy"
    assert got[1][:, 0].sum() == 0 and (got[1][:, 1] > 0).all()
    assert port.lane_ready(0) == 0


# ---------------------------------------------------------------------------
# the Ogg Opus group with its three engines
# ---------------------------------------------------------------------------

def with_head(collect, lanes, skip, gain):
    """The JAX group's collect (slots [n, B, C, 960] with the valid samples
    at the END, lengths [n, B]) with an OpusHead's pre-skip and gain
    applied to ``lanes``, as the port's hybrid engine applies them: the
    gain scales the lane's slots, the pre-skip comes off its first valid
    samples. ``skip`` holds what is left of each lane's pre-skip and is
    updated."""
    pcm, lengths = np.array(collect[0]), np.array(collect[1])
    for b in lanes:
        pcm[:, b] *= np.float32(gain[b])
        for i in range(lengths.shape[0]):
            k = min(skip[b], int(lengths[i, b]))
            skip[b] -= k
            lengths[i, b] -= k
    return pcm, lengths


def test_ogg_group_serves_celt_silk_and_hybrid_lanes_like_jax(voice):
    """Eight Ogg lanes, CELT, SILK (NB, MB, WB stereo) and hybrid (SWB,
    FB), pushed in odd chunks over three collects (``device_out`` and
    host slots), a lane recycled from CELT to SILK; per collect the JAX
    group's slots and lengths. A hybrid lane takes its OpusHead's pre-skip
    and gain, where the reference's ignores them (its ``push`` configures
    only the CELT and SILK engines from the head,
    ``soundkit_tpu/models/opus_fleet_model.py:247-253``): the port's
    stated departure, so the hybrid lanes are held to the JAX group's
    slots with the head's pre-skip and gain applied to them."""
    celt = opus_fixtures.load_clips()
    clips = [celt[0], voice["silk_nb"], voice["silk_mb"], voice["silk_wb_stereo"],
             voice["hybrid_swb"], voice["hybrid_fb"], celt[3], voice["silk_wb"]]
    streams = [opus_fixtures.lane_streams(clips, b + 1, 24 - b)[b] for b in range(8)]
    port, ref = BatchedOggOpusDecoder(8, 2, device="cpu"), JaxOgg(8, 2)
    hybrid = (4, 5)
    skip = {b: clips[b].pre_skip for b in hybrid}
    gain = {b: 10.0 ** (clips[b].output_gain / 5120.0) for b in hybrid}
    totals = np.zeros((2, 8), np.int64)
    for third, device_out in ((0, True), (1, False), (2, True)):
        for m in (port, ref):
            for b, s in enumerate(streams):
                part = s[len(s) * third // 3: len(s) * (third + 1) // 3]
                for k in range(0, len(part), 700):
                    m.push(b, part[k: k + 700])
            if third == 1:
                m.reset_lane(0)
                m.push(0, opus_fixtures.lane_streams([voice["silk_wb"]], 1, 10)[0])
        if third == 1:
            streams[0] = b""  # the lane now plays the SILK stream
        assert [port.lane_ready(b) for b in range(8)] == [ref.lane_ready(b) for b in range(8)]
        assert port._kind == ref._kind
        n = max(port.lane_ready(b) for b in range(8))
        got = port.decode_batches(n, device_out)
        want = ref.decode_batches(n, device_out)
        if device_out:
            got = (got[0].numpy(), got[1])
        totals += [got[1].sum(axis=0), np.asarray(want[1]).sum(axis=0)]
        assert_collects_match(got, with_head(want, hybrid, skip, gain))
    assert port._kind == ["silk", "silk", "silk", "silk", "hybrid", "hybrid", "celt", "silk"]
    # the hybrid lanes came out shorter than the reference's by their
    # heads' pre-skip (312), scaled by their heads' gain; every other lane
    # as long as the reference's
    assert [clips[b].pre_skip for b in hybrid] == [312, 312]
    np.testing.assert_array_equal(totals[0], totals[1] - [0, 0, 0, 0, 312, 312, 0, 0])
    assert port._hyb._gain[4] == np.float32(gain[4]) and port._silk._gain[2] != 1.0


def test_ogg_group_refuses_a_frozen_hybrid_lane_at_its_next_push(voice):
    head = voice["hybrid_fb"].head
    data = ogg_opus(head, hybrid_redundancy_packets(6))
    cut = len(data) - 300
    port, ref = BatchedOggOpusDecoder(2, 2, device="cpu"), JaxOgg(2, 2)
    for m in (port, ref):
        m.push(0, data[:cut])
        m.decode_batches(8)
    with pytest.raises(OpusLaneUnsupported, match="hybrid transition redundancy"):
        port.push(0, data[cut:])
    from soundkit_tpu.models.opus_fleet_model import OpusLaneUnsupported as JaxUnsupported

    with pytest.raises(JaxUnsupported, match="hybrid transition redundancy"):
        ref.push(0, data[cut:])
