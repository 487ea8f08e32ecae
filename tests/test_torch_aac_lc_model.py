"""Port parity: soundkit_tpu_torch's BatchedAacLcDecoder against the
JAX package's, on the same ADTS streams over the v4 wire.

The fixtures are v4-clean, so the JAX model takes its v4 path for
every batch too (its v3 fallback draws PNS signs on the host and would
differ by design). PCM and carried state >= 100 dB per lane."""
import numpy as np
import pytest

from soundkit_tpu.models.aac_lc_batch import BatchedAacLcDecoder as JaxDecoder
from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder, state_from_jax
from soundkit_tpu_torch.tools.aac_fixtures import load_clips

from torch_port_helpers import lane_snrs, snr_db

B = 4


def _stream(clip: int, start: int, n: int) -> bytes:
    frames = load_clips()[clip]
    return b"".join(frames[start : start + n])


def _assert_close(got, ref):
    # [frames, B, C, N]: one SNR per lane over every frame and channel
    assert lane_snrs(got, ref, 1).min() >= 100


def test_model_matches_jax_with_ragged_lane_and_reset():
    port = BatchedAacLcDecoder(B, 2, device="cpu")
    ref = JaxDecoder(B, 2)
    # lane 3 is ragged: two AUs, then silence with its state frozen
    streams = [_stream(1, 8, 4), _stream(3, 1, 4), _stream(4, 5, 4), _stream(2, 22, 2)]
    for m in (port, ref):
        for i, s in enumerate(streams):
            m.push(i, s)
    assert port.ready_frames == 2 and port.lane_ready(0) == 4
    assert port.lane_sample_rate(0) == 48000
    _assert_close(port.decode_batches(3), ref.decode_batches(3))
    for m in (port, ref):
        m.reset_lane(1)
        m.push(1, _stream(5, 111, 2))
    _assert_close(port.decode_batches(1), ref.decode_batches(1))
    _assert_close(port.state[0].numpy()[None], np.asarray(ref._saved)[None])
    # window shapes: the reference's on lanes 0-2, which decoded the last
    # batch; lane 3, idle since its two AUs, keeps the shape of its last
    # frame (the port's stated departure, ``ops/aac_batch.py``), the one a
    # decoder fed only those two AUs ends on, where the reference takes
    # the idle wire's
    want = np.asarray(ref._prev_shape).copy()
    alone = JaxDecoder(B, 2)
    alone.push(3, streams[3])
    alone.decode_batches(2)
    want[3] = np.asarray(alone._prev_shape)[3]
    assert (want[3] != np.asarray(ref._prev_shape)[3]).any()
    np.testing.assert_array_equal(port.state[1].numpy(), want)
    assert (port.v4_batches, port.full_wire_batches) == (4, 0)


def test_state_from_jax_continues_the_streams():
    """Two batches in JAX, the carried state handed to the port, two
    more batches in both."""
    ref = JaxDecoder(B, 2)
    starts = [(0, 30), (1, 12), (3, 15), (5, 79)]
    for i, (clip, start) in enumerate(starts):
        ref.push(i, _stream(clip, start, 4))
    ref.decode_batches(2)
    port = BatchedAacLcDecoder(B, 2, device="cpu")
    port.set_state(*state_from_jax(np.asarray(ref._saved), np.asarray(ref._prev_shape), "cpu"))
    for i, (clip, start) in enumerate(starts):
        port.push(i, _stream(clip, start + 2, 2))
    _assert_close(port.decode_batches(2), ref.decode_batches(2))
    assert port.v4_batches == 2


def _with_rate(frame: bytes, sr_index: int) -> bytes:
    """An ADTS frame with its sampling-frequency index rewritten."""
    b = bytearray(frame)
    b[2] = (b[2] & 0xC3) | (sr_index << 2)
    return bytes(b)


def test_mixed_rate_batch_takes_the_full_wire():
    """Lanes at two sample rates go through the full wire, which on
    PNS-free AUs (PNS signs are drawn per wire) equals the v4 path;
    44.1 and 48 kHz share their band tables."""
    clips = load_clips()
    lane0 = b"".join(clips[1][i] for i in (22, 23, 25))
    lane1 = [clips[4][i] for i in (37, 38, 39)]
    mixed = BatchedAacLcDecoder(2, 2, device="cpu")
    single = BatchedAacLcDecoder(2, 2, device="cpu")
    mixed.push(0, lane0)
    mixed.push(1, b"".join(_with_rate(f, 4) for f in lane1))
    single.push(0, lane0)
    single.push(1, b"".join(lane1))
    assert mixed.lane_sample_rate(1) == 44100
    _assert_close(mixed.decode_batches(3), single.decode_batches(3))
    assert (mixed.full_wire_batches, mixed.v4_batches) == (3, 0)
    assert (single.full_wire_batches, single.v4_batches) == (0, 3)



def _ragged_and_gapless(make, streams, parts):
    """Lane 0 pushed in ``parts`` ((frames, batches): a push of that many
    frames, then a decode of that many batches), the other lanes whole at
    the start; and the same streams pushed whole into a second decoder.
    Returns the ragged decoder's batches, the gapless decoder's, and the
    ragged decoder's carried window shapes after each decode."""
    ragged, gapless = make(len(streams)), make(len(streams))
    for i, s in enumerate(streams[1:], 1):
        for m in (ragged, gapless):
            m.push(i, b"".join(s))
    gapless.push(0, b"".join(streams[0]))
    outs, shapes, pos = [], [], 0
    for n_frames, batches in parts:
        ragged.push(0, b"".join(streams[0][pos: pos + n_frames]))
        pos += n_frames
        outs.append(np.asarray(ragged.decode_batches(batches)))
        shapes.append(np.array(ragged.state[1] if hasattr(ragged, "state") else ragged._prev_shape))
    total = sum(b for _, b in parts)
    return np.concatenate(outs), np.asarray(gapless.decode_batches(total)), shapes


# lane 0: three frames and one idle batch, three frames and three idle
# batches, then six frames; the other lanes decode all 16 batches
IDLE_PARTS = ((3, 4), (3, 6), (6, 6))
IDLE_BATCHES = [3, 7, 8, 9]
LIVE_BATCHES = [i for i in range(16) if i not in IDLE_BATCHES]


def _idle_streams():
    # clip 0 is KBD-shaped on 187 of its 189 frames
    frames = load_clips()
    return [frames[0][10:22], frames[1][40:56], frames[3][60:76], frames[5][5:21]]


def _assert_idle_lane_is_gapless(got, gapless, shapes):
    # the idle batches went by on a KBD shape, kept
    assert (shapes[0][0] == 1).all() and (shapes[1][0] == 1).all()
    assert not got[IDLE_BATCHES, 0].any()
    np.testing.assert_array_equal(got[LIVE_BATCHES, 0], gapless[:12, 0])


def test_idle_lane_keeps_its_window_shape():
    """A lane that idles after a KBD frame, for one batch and then for
    three, and resumes, decodes bit for bit as the same lane fed
    gaplessly, and the lanes that never idle bit for bit as in the
    gapless decoder. The reference takes the idle wire's (sine) shape
    instead, so its ragged lane lies far from its own gapless decode: the
    port's stated departure (``ops/aac_batch.py``)."""
    streams = _idle_streams()
    got, gapless, shapes = _ragged_and_gapless(
        lambda n: BatchedAacLcDecoder(n, 2, device="cpu"), streams, IDLE_PARTS)
    _assert_idle_lane_is_gapless(got, gapless, shapes)
    np.testing.assert_array_equal(got[:, 1:], gapless[:, 1:])
    ref, ref_gapless, _ = _ragged_and_gapless(lambda n: JaxDecoder(n, 2), streams, IDLE_PARTS)
    # the lanes that never idle, and lane 0 against the reference's
    # gapless decode, at the bar this file holds the port to
    _assert_close(got[:, 1:], ref[:, 1:])
    _assert_close(got[LIVE_BATCHES][:, :1], ref_gapless[:12, :1])
    # the reference's ragged lane departs from its gapless decode
    assert snr_db(ref[LIVE_BATCHES, 0], ref_gapless[:12, 0]) < 60


def test_idle_lane_keeps_its_window_shape_on_the_full_wire(monkeypatch):
    """The same ragged lane through the full wire (the route of a batch
    that overflows the v4 wire or mixes rates), alone in its decoder: bit
    for bit its gapless decode. (The full wire's plain path is not bit
    for bit across batch contents, so the lane is alone here.)"""
    from soundkit_tpu_torch import native

    pack = native.AacHostParser.pack_v4
    monkeypatch.setattr(native.AacHostParser, "pack_v4",
                        lambda self, aus: (pack(self, aus)[0], True))
    make = lambda n: BatchedAacLcDecoder(n, 2, device="cpu")  # noqa: E731
    got, gapless, shapes = _ragged_and_gapless(make, _idle_streams()[:1], IDLE_PARTS)
    _assert_idle_lane_is_gapless(got, gapless, shapes)
