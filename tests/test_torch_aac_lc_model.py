"""Port parity: soundkit_tpu_torch's BatchedAacLcDecoder against the
JAX package's, on the same ADTS streams over the v4 wire.

The fixtures are v4-clean, so the JAX model takes its v4 path for
every batch too (its v3 fallback draws PNS signs on the host and would
differ by design). PCM and carried state >= 100 dB per lane."""
import numpy as np

from soundkit_tpu.models.aac_lc_batch import BatchedAacLcDecoder as JaxDecoder
from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder, state_from_jax
from soundkit_tpu_torch.tools.aac_fixtures import load_clips

from torch_port_helpers import lane_snrs

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
    np.testing.assert_array_equal(port.state[1].numpy(), np.asarray(ref._prev_shape))
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
