"""Port parity: soundkit_tpu_torch's BatchedFlacDecoder against the JAX
package's on the CPU, on the committed FLAC fixtures: samples bit-exact
and ``metas`` equal, on ragged chunked pushes, after ``reset_lane`` and
through the forced residual-plane fallback."""
import numpy as np
import pytest
import torch

from soundkit_tpu.codecs.flac import FlacError as JaxFlacError
from soundkit_tpu.models.flac_batch import BatchedFlacDecoder as JaxDecoder
from soundkit_tpu_torch.codecs.flac import FlacError
from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder
from soundkit_tpu_torch.tools import flac_fixtures as fx
from torch_port_helpers import flac_clip_pcm

B = 5


def both(num_streams=B, stride=4608):
    return BatchedFlacDecoder(num_streams, stride, device="cpu"), JaxDecoder(num_streams, stride)


def assert_same(got, want):
    (g_s, g_m), (w_s, w_m) = got, want
    assert g_s.dtype == np.int32 and g_s.shape == np.asarray(w_s).shape
    np.testing.assert_array_equal(g_s, np.asarray(w_s))
    assert len(g_m) == len(w_m)
    for a, b in zip(g_m, w_m):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_matches_jax_on_ragged_chunked_pushes():
    """Five lanes of four clips (16- and 24-bit, mono, wasted bits),
    pushed in odd-sized chunks between three decodes."""
    streams = fx.lane_streams(fx.load_clips(), B, 6)
    port, ref = both()
    pos = [0] * B
    total = 0
    for step, share in enumerate((0.3, 0.4, 1.0)):
        for i, s in enumerate(streams):
            end = len(s) if share == 1.0 else int(len(s) * share) + 37 * i
            for a in range(pos[i], end, 999 + 13 * i):
                for m in (port, ref):
                    m.push(i, s[a: min(a + 999 + 13 * i, end)])
            pos[i] = max(pos[i], end)
        ready = [port.lane_ready(i) for i in range(B)]
        assert ready == [ref.lane_ready(i) for i in range(B)]
        assert port.ready_frames == ref.ready_frames == min(ready)
        n = max(ready)
        got = port.decode_batches(n)
        assert_same(got, ref.decode_batches(n))
        total += n
        assert [port.lane_ready(i) for i in range(B)] == [0] * B
    assert total >= 6 and np.count_nonzero(got[0]) > 0


@pytest.mark.parametrize("name", fx.CLIPS)
def test_decodes_each_fixture_to_its_source_pcm(name):
    """Lossless: the decoded samples are the samples that were encoded."""
    clip = fx.load_clips()[fx.CLIPS.index(name)]
    port, ref = both(1)
    for m in (port, ref):
        m.push(0, clip.stream())
    assert port.lane_sample_rate(0) == ref.lane_sample_rate(0) == clip.rate
    got = port.decode_ready()
    assert_same(got, ref.decode_ready())
    samples, metas = got
    assert [int(m[0][0]) for m in metas] == clip.blocks
    assert all(int(m[0][1]) == clip.channels and int(m[0][3]) == clip.bits for m in metas)
    pcm = np.concatenate([samples[f, 0, :clip.channels, :metas[f][0][0]]
                          for f in range(len(metas))], axis=1)
    np.testing.assert_array_equal(pcm, flac_clip_pcm(name))


def test_reset_lane_gives_a_fresh_decoder():
    clips = fx.load_clips()
    port, ref = both(2)
    for m in (port, ref):
        m.push(0, clips[0].stream()[:30000])   # ends inside a frame
        m.push(1, clips[2].stream())
    assert_same(port.decode_batches(2), ref.decode_batches(2))
    for m in (port, ref):
        m.reset_lane(0)
    assert port.lane_ready(0) == 0 and port.lane_sample_rate(0) is None
    assert ref.lane_sample_rate(0) is None
    for m in (port, ref):
        m.push(0, clips[1].stream())
    assert port.lane_sample_rate(0) == 48000 and port.lane_sample_rate(1) == 16000
    got = port.decode_batches(3)
    assert_same(got, ref.decode_batches(3))
    fresh = BatchedFlacDecoder(1, device="cpu")
    fresh.push(0, clips[1].stream())
    np.testing.assert_array_equal(got[0][:, 0], fresh.decode_batches(3)[0][:, 0])


def test_parts_fallback_merges_with_segment_frames():
    """A small ``seg_cap`` sends lanes 0-2 through the residual-plane
    wire and the second K9 call; lanes 3-4 ride the segment wire in the
    same rounds."""
    streams = fx.lane_streams(fx.load_clips(), B, 3)
    port, ref = both()
    probe = BatchedFlacDecoder(B, device="cpu")
    plain = BatchedFlacDecoder(B, device="cpu")
    for m in (port, ref, probe):
        m.seg_cap = 20
    for i, s in enumerate(streams):
        if i == 3:
            for m in (port, ref, probe):
                m.seg_cap = 8192
        for m in (port, ref, probe, plain):
            m.push(i, s)
    slots = probe.export_wire(3).parts[0]
    assert sorted(slots.tolist()) == [r * B + b for r in range(3) for b in range(3)]
    got = port.decode_batches(3)
    assert_same(got, ref.decode_batches(3))
    assert_same(got, plain.decode_batches(3))  # the same samples by either wire


def test_per_lane_sample_rates_and_none_before_the_header():
    port, ref = both(4)
    clips = fx.load_clips()
    assert [port.lane_sample_rate(i) for i in range(4)] == [None] * 4
    for m in (port, ref):
        m.push(0, clips[0].stream()[:3])  # not even the marker yet
        for i in (1, 2, 3):
            m.push(i, clips[i].stream()[:200])
    want = [ref.lane_sample_rate(i) for i in range(4)]
    assert [port.lane_sample_rate(i) for i in range(4)] == want == [None, 48000, 16000, 44100]


def test_decode_ready_is_bounded_by_the_least_ready_lane():
    port, ref = both(2)
    clips = fx.load_clips()
    for m in (port, ref):
        m.push(0, clips[2].stream())
        m.push(1, clips[3].stream()[:12000])
    assert port.ready_frames == ref.ready_frames > 0
    assert_same(port.decode_ready(max_frames=1), ref.decode_ready(max_frames=1))
    assert_same(port.decode_ready(), ref.decode_ready())
    empty, metas = port.decode_batches(0)
    assert empty.shape == (0, 2, 2, 4608) and empty.dtype == np.int32 and metas == []


def test_device_out_returns_the_same_samples_as_a_tensor():
    a, b = BatchedFlacDecoder(2, device="cpu"), BatchedFlacDecoder(2, device="cpu")
    for m in (a, b):
        for i, s in enumerate(fx.lane_streams(fx.load_clips(), 2, 2)):
            m.push(i, s)
    dev, metas = a.decode_batches(2, device_out=True)
    host, metas_b = b.decode_batches(2)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy(), host)
    assert all(np.array_equal(x, y) for x, y in zip(metas, metas_b))


def test_small_stride_and_bad_streams_raise_like_the_jax_decoder():
    clip = fx.load_clips()[2]
    port, ref = both(1, stride=64)
    with pytest.raises(FlacError) as e_port:
        port.push(0, clip.stream())
    with pytest.raises(JaxFlacError) as e_ref:
        ref.push(0, clip.stream())
    assert str(e_port.value) == str(e_ref.value) == "frame fits neither wire"
    port, ref = both(1)
    bad = clip.header + bytes([0xFF, 0xF8, 0xFF, 0xFF]) + clip.frames[0][4:]
    errors = []
    for m, err in ((port, FlacError), (ref, JaxFlacError)):
        try:
            m.push(0, bad)
            errors.append(None)
        except err as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert port.lane_ready(0) == ref.lane_ready(0)


def test_timed_needs_cuda_and_the_default_device_is_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        BatchedFlacDecoder(2, device="cpu", timed=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchedFlacDecoder(2)


def test_fixture_lanes_are_ragged_whole_frames():
    clips = fx.load_clips()
    streams = fx.lane_streams(clips, 64)
    secs = fx.lane_seconds(clips, 64)
    assert len(set(streams)) >= 48
    for i, s in enumerate(streams):
        clip, idx = fx.lane_frames(clips, i)
        assert s.startswith(b"fLaC") and len(s) == len(clip.header) + sum(len(clip.frames[t]) for t in idx)
    assert sum(len(fx.lane_frames(clips, i)[1]) < len(clips[i % 4].frames) for i in range(64)) == 16
    assert 0 < min(secs) < max(secs) == 2.0
    assert all(f[:2] == b"\xff\xf8" for c in clips for f in c.frames)
    assert sum(len(c.stream()) for c in clips) < 1_000_000
