"""Port parity of the batched Ogg Vorbis decoder: soundkit_tpu_torch's
``BatchedVorbisDecoder`` against the JAX package's on the CPU, over the
committed fixtures (``tests/data/torch_port/vorbis``). Lengths identical;
PCM within 2e-6 absolute, the JAX package's own bar for its batched
decoder against the single-stream one (``tests/test_vorbis.py``); the
device-resident mode equal to the fetching mode. The floor0 fixture takes
the Python packet path; the C++ parse's spectra equal the Python
decoder's within 1e-9."""
import numpy as np
import pytest
import torch

from soundkit_tpu.models.vorbis_batch import BatchedVorbisDecoder as JaxDecoder
from soundkit_tpu_torch.codecs.vorbis_core import VorbisSetup, cached_setup
from soundkit_tpu_torch.codecs.vorbis_native import NativeVorbisParser
from soundkit_tpu_torch.demux.ogg import OggPacketizer
from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder, TopologyMismatch
from soundkit_tpu_torch.tools import vorbis_fixtures as vf

BAR = 2e-6
CHUNKS = (313, 1024, 4096)


def push_ragged(models, streams, lagging: int = None):
    """Push ``streams`` into every model, lane b in chunks of
    ``CHUNKS[b mod 3]`` bytes; lane ``lagging`` gets half its stream."""
    for b, data in enumerate(streams):
        feed = data[: len(data) // 2] if b == lagging else data
        step = CHUNKS[b % len(CHUNKS)]
        for i in range(0, len(feed), step):
            for m in models:
                m.push(b, feed[i: i + step])


def assert_lanes_match(got, want, full_scale: float = 1.0):
    """Lane by lane: the same shapes, PCM within ``BAR * full_scale``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.size:
            np.testing.assert_allclose(g, w, rtol=0, atol=BAR * full_scale)


@pytest.mark.parametrize("names,lanes", [(vf.STEREO, 4), (("mono22",), 3)])
def test_model_matches_jax_over_ragged_lanes(names, lanes):
    """Ragged chunk sizes and a lagging lane, decoded in two calls (the
    lap and the flags carry across them): every lane's PCM as the JAX
    decoder's; the lagging lane decodes less."""
    clips = vf.load_clips(names=names)
    streams = vf.lane_streams(clips, lanes)
    port, ref = BatchedVorbisDecoder(lanes, device="cpu"), JaxDecoder(lanes)
    push_ragged((port, ref), streams, lagging=lanes - 1)
    n = max(port.lane_ready(b) for b in range(lanes))
    assert n == max(ref.lane_ready(b) for b in range(lanes)) > 20
    total = [np.zeros((clips[0].channels, 0))] * lanes
    for k in (7, n - 7):
        got, want = port.decode_batches(k), ref.decode_batches(k)
        assert_lanes_match(got, want)
        total = [np.concatenate([t, g], axis=1) for t, g in zip(total, got)]
    assert all(port.lane_ready(b) == 0 for b in range(lanes))
    assert total[-1].shape[1] < total[0].shape[1] and np.abs(total[0]).max() > 0.1
    rate = clips[0].rate
    assert [port.lane_sample_rate(b) for b in range(lanes)] == [rate] * lanes


def test_device_out_equals_the_fetching_mode():
    clips = vf.load_clips(names=vf.STEREO)
    streams = vf.lane_streams(clips, 5, 3)
    a, b = BatchedVorbisDecoder(5, device="cpu"), BatchedVorbisDecoder(5, device="cpu")
    push_ragged((a, b), streams, lagging=4)
    n = max(a.lane_ready(i) for i in range(5))
    fetched = a.decode_batches(n)
    outs, lens = b.decode_batches(n, device_out=True)
    assert len(outs) == n and lens.shape == (n, 5) and lens.dtype == np.int32
    assert all(isinstance(o, torch.Tensor) and o.shape == (5, 2, 1024) for o in outs)
    for lane in range(5):
        parts = [outs[r][lane, :, : lens[r, lane]].numpy() for r in range(n)]
        np.testing.assert_array_equal(np.concatenate(parts, axis=1), fetched[lane])
    # the reference's lengths: 0 on a lane's first packet and when idle, then d
    ref = JaxDecoder(5)
    push_ragged((ref,), streams, lagging=4)
    np.testing.assert_array_equal(lens, ref.decode_batches(n, device_out=True)[1])


def test_floor0_stream_takes_the_python_packet_path():
    """The crafted floor0 stream (n0 == n1 == 256) decodes on the Python
    packet path in both packages, in two lanes with different chunking.
    Its crafted amplitudes reach ~3e8, far past audio's full scale of 1,
    so the bar is 2e-6 of the stream's own largest value."""
    clip = vf.load_clips(names=("floor0",))[0]
    data = clip.stream()
    port, ref = BatchedVorbisDecoder(2, device="cpu"), JaxDecoder(2)
    push_ragged((port, ref), [data, data])
    assert isinstance(port._lanes[0].parser, VorbisSetup)
    assert port._topology == (256, 256, 1)
    n = port.ready_frames
    assert n == len(clip.pages)
    got, want = port.decode_batches(n), ref.decode_batches(n)
    assert_lanes_match(got, want, full_scale=float(np.abs(want[0]).max()))
    assert got[0].shape == (1, (n - 1) * 128) and np.abs(got[0]).max() > 0
    np.testing.assert_array_equal(got[0], got[1])


def test_reset_lane_zeroes_the_lap_and_starts_clean():
    """After ``reset_lane`` the lane's lap is zero, its flag long, and a
    new stream in it decodes as in a fresh decoder."""
    clips = vf.load_clips(names=vf.STEREO)
    streams = vf.lane_streams(clips, 4, 2)
    model = BatchedVorbisDecoder(2, device="cpu")
    for b in range(2):
        model.push(b, streams[b])
    model.decode_batches(10)
    assert model._carry[1].abs().max() > 0
    model.reset_lane(1)
    assert not model._carry[1].any() and model._cflag[1] == 1 and not model.lane_configured(1)
    assert model._carry[0].abs().max() > 0
    model.push(1, streams[3])
    fresh = BatchedVorbisDecoder(2, device="cpu")
    fresh.push(1, streams[3])
    n = model.lane_ready(1)
    got = model.decode_batches(n)[1]
    want = fresh.decode_batches(n)[1]
    np.testing.assert_array_equal(got, want)


def test_topology_mismatch_raises_and_leaves_the_lane_clean():
    stereo, mono = vf.load_clips(names=("stereo44", "mono22"))
    model = BatchedVorbisDecoder(2, device="cpu")
    model.push(0, stereo.stream())
    with pytest.raises(TopologyMismatch, match=r"lane 1 topology \(512, 1024, 1\) != model "
                                               r"topology \(256, 2048, 2\)"):
        model.push(1, mono.stream())
    assert not model.lane_configured(1) and model.lane_ready(1) == 0
    assert model.lane_sample_rate(1) is None
    model.reset_lane(1)
    model.push(1, stereo.stream())
    assert model.lane_configured(1) and model.lane_ready(1) == model.lane_ready(0)


def test_no_topology_yet_decodes_nothing():
    model = BatchedVorbisDecoder(3, device="cpu")
    assert [o.shape for o in model.decode_batches(2)] == [(0, 0)] * 3
    outs, lens = model.decode_batches(2, device_out=True)
    assert outs == [] and lens.shape == (0, 3)


def test_default_device_is_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchedVorbisDecoder(2)


@pytest.mark.parametrize("name", ["stereo44", "stereo44b", "mono22"])
def test_native_parser_spectra_equal_the_python_decoder(name):
    """Every audio packet of a fixture through the port's C++ parse and
    through ``VorbisSetup.decode_packet_spectrum``: the same block size and
    window flags, spectra within 1e-9 of the packet's largest value."""
    packets = [p for p, _ in OggPacketizer().push(vf.load_clips(names=(name,))[0].stream())]
    setup = cached_setup(packets[0], packets[2])
    native = NativeVorbisParser(setup)
    worst = 0.0
    for p in packets[3:]:
        a, b = native.decode_packet_spectrum(p), setup.decode_packet_spectrum(p)
        assert (a.n, a.prev_flag, a.next_flag) == (b.n, b.prev_flag, b.next_flag)
        assert a.spectrum.shape == b.spectrum.shape
        scale = max(np.abs(b.spectrum).max(), 1e-30)
        worst = max(worst, np.abs(a.spectrum - b.spectrum).max() / scale)
    assert worst <= 1e-9


def test_lane_samples_counts_what_the_decoder_gives():
    """``vorbis_fixtures.lane_samples`` (the count ``chip_smoke.py`` holds
    its lanes to) from the packets' modes alone equals the decoded length
    of every lane, shortened lanes and wrapped ones among them."""
    clips = vf.load_clips(names=vf.STEREO)
    want = vf.lane_samples(clips, 14, 5)
    model = BatchedVorbisDecoder(14, device="cpu")
    for i, data in enumerate(vf.lane_streams(clips, 14, 5)):
        model.push(i, data)
    got = model.decode_batches(max(model.lane_ready(i) for i in range(14)))
    assert [g.shape[1] for g in got] == want.tolist() and len(set(want.tolist())) > 3
