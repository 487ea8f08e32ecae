"""Port parity of the batched MP3 decoder: soundkit_tpu_torch's
``BatchedMp3Decoder(device="cpu")`` against the JAX package's on the
committed MP3 fixtures (tests/data/torch_port/mp3), from the same
pushes: per lane the same granule counts and sample rates, PCM at 100
dB or better (float32 sums in another order; the AAC bar), the carried
overlap and FIFO within 1e-5 of their largest value; and at 90 dB or
better against the JAX package's numpy reference decode (``Mp3Synth``
over the pure-Python parser), the bar of ``tests/test_mp3_native.py``."""
import numpy as np
import pytest

from soundkit_tpu.codecs.mp3_native import Mp3NativeDecoder
from soundkit_tpu.models.mp3_batch_model import BatchedMp3Decoder as JaxDecoder
from soundkit_tpu.ops.mp3_dsp import Mp3Synth
from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
from soundkit_tpu_torch.tools import mp3_fixtures
from torch_port_helpers import lane_snrs, snr_db

B = 10  # two lanes of each clip, ragged starts and lengths


@pytest.fixture(scope="module")
def lanes():
    clips = mp3_fixtures.load_clips()
    return mp3_fixtures.lane_streams(clips, B, 40), mp3_fixtures.lane_rates(clips, B)


def assert_states_close(port, ref):
    for got, want in ((port._overlap.numpy(), np.asarray(ref._overlap)),
                      (port._fifo.numpy(), np.asarray(ref._fifo))):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_ragged_lanes_match_jax_collect_by_collect(lanes):
    """Two pushes a lane and three collects (the last one drains every
    lane, the short ones idle with frozen state)."""
    streams, rates = lanes
    port, ref = BatchedMp3Decoder(B, device="cpu"), JaxDecoder(B)
    cuts = [len(s) * 2 // 5 for s in streams]
    for m in (port, ref):
        for i, s in enumerate(streams):
            m.push(i, s[: cuts[i]])
    assert [port.lane_ready(i) for i in range(B)] == [ref.lane_ready(i) for i in range(B)]
    got, want = [port.decode_batches(4)], [np.asarray(ref.decode_batches(4))]
    for m in (port, ref):
        for i, s in enumerate(streams):
            m.push(i, s[cuts[i]:])
    counts = [port.lane_ready(i) for i in range(B)]
    assert counts == [ref.lane_ready(i) for i in range(B)] and len(set(counts)) > 2
    for n in (5, max(counts)):
        got.append(port.decode_batches(n))
        want.append(np.asarray(ref.decode_batches(n)))
    assert all(port.lane_ready(i) == 0 for i in range(B))
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape == (4 + 5 + max(counts), B, 2, 576) and got.dtype == np.float32
    assert lane_snrs(got, want, lane_axis=1).min() >= 100
    assert_states_close(port, ref)
    assert [port.lane_sample_rate(i) for i in range(B)] == \
        [ref.lane_sample_rate(i) for i in range(B)] == rates
    assert port.sample_rate == ref.sample_rate == rates[0]
    # mono lanes (clips 3 and 4): the second channel is silent
    assert not got[:, 3::5, 1].any() and not got[:, 4::5, 1].any()


def test_reset_lane_and_decode_ready_match_jax(lanes):
    streams, _ = lanes
    port, ref = BatchedMp3Decoder(B, device="cpu"), JaxDecoder(B)
    for m in (port, ref):
        for i, s in enumerate(streams):
            m.push(i, s)
        m.decode_batches(3)
        m.reset_lane(2)
        m.reset_lane(7)
        assert m.lane_ready(2) == 0 and m.lane_sample_rate(7) is None
        m.push(2, streams[6])
    assert port.ready_granules == ref.ready_granules == 0
    assert port.decode_ready().shape == (0, B, 2, 576)
    n = port.lane_ready(2)
    got, want = port.decode_batches(n), np.asarray(ref.decode_batches(n))
    assert lane_snrs(got, want, lane_axis=1).min() >= 100
    assert not got[:, 7].any()
    assert_states_close(port, ref)
    # lane 2 now decodes stream 6 from a clean state: as lane 0 of a fresh decoder
    fresh = BatchedMp3Decoder(1, device="cpu")
    fresh.push(0, streams[6])
    np.testing.assert_array_equal(got[:, 2], fresh.decode_batches(n)[:, 0])


def test_decode_multi_matches_jax_and_decode_batches(lanes):
    streams, _ = lanes
    port, ref, steps = (BatchedMp3Decoder(B, device="cpu"), JaxDecoder(B),
                        BatchedMp3Decoder(B, device="cpu"))
    for m in (port, ref, steps):
        for i, s in enumerate(streams):
            m.push(i, s)
    got, want = port.decode_multi(6), np.asarray(ref.decode_multi(6))
    assert got.shape == (6, B, 2, 576)
    assert lane_snrs(got, want, lane_axis=1).min() >= 100
    np.testing.assert_array_equal(got, steps.decode_batches(6))
    assert [port.lane_ready(i) for i in range(B)] == [ref.lane_ready(i) for i in range(B)]


@pytest.mark.parametrize("clip", mp3_fixtures.CLIPS)
def test_decode_against_the_numpy_reference(clip):
    """The whole clip through the port's decoder against the JAX
    package's numpy ``Mp3Synth`` over its pure-Python parser."""
    c = mp3_fixtures.load_clips()[mp3_fixtures.CLIPS.index(clip)]
    data = b"".join(c.frames[:24])
    synth = Mp3Synth()
    ref = np.concatenate([synth.process_frame(f) for f in Mp3NativeDecoder().push(data)], axis=1)
    model = BatchedMp3Decoder(1, c.channels, device="cpu")
    model.push(0, data)
    pcm = model.decode_ready()  # [granules, 1, C, 576]
    got = np.transpose(pcm[:, 0], (1, 0, 2)).reshape(c.channels, -1)
    assert got.shape == ref.shape == (c.channels, 24 * c.granules[0] * 576)
    for ch in range(c.channels):
        assert snr_db(got[ch], ref[ch]) >= 90, (clip, ch)
