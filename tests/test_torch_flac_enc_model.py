"""The port's batched FLAC encoder against the JAX package's.

``models.flac_encode_batch.BatchedFlacEncoder(device="cpu")`` and the JAX
``BatchedFlacEncoder`` are fed the same pushes of the fixtures' PCM (the
port's decode of the committed clips; 4 lanes of at most 40,000
samples, each lane rotated and cut to its own length): the streams must be
byte-identical, stepwise and pending, with batched tails and host tails,
mono and 24-bit. The streams decode bit-exactly through the port's
``BatchedFlacDecoder`` with their STREAMINFO MD5, and the port's native
packer writes the same frames as the per-frame oracle
``_write_from_plan``.
"""
import functools

import numpy as np
import pytest
import torch

from soundkit_tpu.models.flac_encode_batch import BatchedFlacEncoder as JaxEncoder
from soundkit_tpu_torch.codecs.flac_encode import FlacFrameEncoder
from soundkit_tpu_torch.models.flac_encode_batch import BatchedFlacEncoder
from soundkit_tpu_torch.ops import flac_analyze as k14
from soundkit_tpu_torch.ops import flac_enc_batch as enc
from soundkit_tpu_torch.tools import flac_fixtures as ff
from soundkit_tpu_torch.tools import kernel_check as kc


@functools.lru_cache(maxsize=None)
def _clip(name: str):
    clip = {c.name: c for c in ff.load_clips()}[name]
    return clip, ff.clip_pcm(clip, "cpu")


def _lanes(name: str):
    """Four lanes of a clip's PCM from their own offsets, of 40,000,
    40,000, 36,869 (4096 x 9 + 5: a tail of five, padded to 16) and 36,869
    samples: every full block, two tail lengths and the repeat pad. The
    same lengths for every clip, so that the JAX encoder compiles its
    analysis for few shapes."""
    clip, pcm = _clip(name)
    lanes = ff.rotated_lanes([pcm], 4, 40000)
    return clip, [x[:, :m] for x, m in zip(lanes, (40000, 40000, 36869, 36869))]


def _encode(cls, clip, lanes, mode: str, **kw):
    """Three pushes a lane (uneven cuts); ``pending``: encode_pending after
    each, then finish_all; ``stepwise``: encode_step until no lane has a
    block, then finish (the host planner's tails) lane by lane."""
    m = cls(len(lanes), clip.rate, clip.channels, clip.bits, **kw)
    for lo, hi in ((0, 5000), (5000, 23000), (23000, None)):
        for i, x in enumerate(lanes):
            m.push(i, x[:, lo:hi])
        if mode == "pending":
            m.encode_pending()
    if mode == "pending":
        return m.finish_all()
    while m.encode_step():
        pass
    return [m.finish(i) for i in range(len(lanes))]


CASES = [("pending", "stereo16"), ("pending", "mono16"), ("pending", "stereo24"),
         ("stepwise", "const_wasted"), ("stepwise", "mono16")]


@pytest.mark.parametrize("mode,name", CASES)
def test_streams_equal_the_jax_encoder(mode, name):
    clip, lanes = _lanes(name)
    got = _encode(BatchedFlacEncoder, clip, lanes, mode, device="cpu")
    want = _encode(JaxEncoder, clip, lanes, mode)
    assert [len(s) for s in got] == [len(s) for s in want]
    assert got == want


@pytest.mark.parametrize("mode,name", CASES)
def test_streams_round_trip_through_the_port_decoder(mode, name):
    """Every lane decodes to its PCM bit for bit (a tail under 16 samples
    comes back padded with its last sample, as the encoder hashed it),
    and the STREAMINFO MD5 is that of the samples the decoder gives."""
    clip, lanes = _lanes(name)
    streams = _encode(BatchedFlacEncoder, clip, lanes, mode, device="cpu")
    for x, got, stream in zip(lanes, ff.decode_streams(streams, "cpu"), streams):
        n = x.shape[1]
        pad = (16 - n % 4096) if n % 4096 < 16 else 0
        assert got.shape == (clip.channels, n + pad)
        np.testing.assert_array_equal(got[:, :n], x)
        assert (got[:, n:] == x[:, -1:]).all()
        assert ff.streaminfo_md5(stream) == ff.pcm_md5(got, clip.bits)


@pytest.mark.parametrize("bits,channels", [(16, 2), (24, 2), (16, 1)])
def test_native_packer_equals_write_from_plan(bits, channels):
    """The plans of ``flac_analyze_plain`` (seeded rows of every kind)
    packed by the native packer in one call (residuals recomputed) and
    frame by frame by ``_write_from_plan`` (the plain version's residuals,
    the host writer) give the same bytes."""
    x = kc.flac_analyze_inputs(bits + channels, 12, 4096, bits, channels)
    assign, kind, order, shift, qlp, res = (t.numpy() for t in
                                            enc.flac_analyze_plain(x, 4096, bits, channels))
    m = BatchedFlacEncoder(1, 48000, channels, bits, device="cpu")
    frames = m._pack_frames([0] * len(x), x.numpy(), assign, kind, order, shift, qlp)
    oracle = FlacFrameEncoder(48000, channels, bits)
    for j, frame in enumerate(frames):
        block = x[j, :channels].numpy().astype(np.int64)
        want = m._write_from_plan(oracle, block, int(assign[j]), kind[j], order[j], shift[j],
                                  qlp[j], res[j])
        assert frame == want, j
    assert len(set(assign.tolist())) >= (3 if channels == 2 else 1)


def test_encoder_on_the_cpu_launches_nothing_and_times_only_on_the_card():
    """The CPU encoder takes the plain version (no K14 launch); a timed
    encoder needs CUDA (K14 is timed by CUDA events)."""
    clip, lanes = _lanes("stereo16")
    before = k14.flac_analyze.launches
    _encode(BatchedFlacEncoder, clip, lanes[:2], "pending", device="cpu")
    assert k14.flac_analyze.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        BatchedFlacEncoder(2, 44100, 2, device="cpu", timed=True)
    with pytest.raises(ValueError, match="timed"):
        BatchedFlacEncoder(2, 44100, 2, device="cpu").stage_s()
    with pytest.raises(ValueError):
        BatchedFlacEncoder(2, 44100, 3, device="cpu")
    assert torch.from_numpy(lanes[0]).dtype == torch.int64
