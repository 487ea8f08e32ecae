"""Port parity: soundkit_tpu_torch's BatchedTelephonyDecoder,
TelephonyLaneGroup and BatchedTelephonyEncoder against the JAX
package's on the CPU, bit-exact (PCM, lengths, wire bytes and carried
state), on ragged pushes of the committed telephony fixtures."""
import numpy as np
import pytest
import torch

from soundkit_tpu.models import telephony_batch as jax_tel
from soundkit_tpu_torch.models import telephony_batch as tel
from soundkit_tpu_torch.tools import telephony_fixtures as fx
from torch_port_helpers import generate_telephony_fixtures

B = 8
CHUNK = 256
CODECS = tel.CODECS


def _assert_state(port, ref):
    if ref._state is None:
        assert port.state is None
    else:
        assert torch.equal(port.state, tel.state_from_jax(ref._state, "cpu"))


# first push per lane: empty, one byte, odd counts, a partial G.726
# group, more than a chunk; the rest of each stream arrives between steps
FIRST = (0, 1, 301, 7, 700, 256, 2, 1000)


@pytest.mark.parametrize("codec", CODECS)
def test_decoder_matches_jax_on_ragged_pushes(codec):
    streams = fx.lane_streams(codec, B)
    port = tel.BatchedTelephonyDecoder(codec, B, CHUNK, device="cpu")
    ref = jax_tel.BatchedTelephonyDecoder(codec, B, CHUNK)
    pos = list(FIRST)
    for m in (port, ref):
        for i, s in enumerate(streams):
            m.push(i, s[: pos[i]])
    for step in range(3):
        got, got_lens = port.decode_step()
        want, want_lens = ref.decode_step()
        assert got.dtype == np.int16 and got.shape == (B, CHUNK * port.samples_per_code)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got_lens, want_lens)
        _assert_state(port, ref)
        for i, s in enumerate(streams):  # ragged arrivals between steps
            n = (97 * (i + 1) * (step + 1)) % 611
            for m in (port, ref):
                m.push(i, s[pos[i]: pos[i] + n])
            pos[i] += n
    assert sum(int(x) for x in got_lens) > 0


@pytest.mark.parametrize("codec", ["g722", "g726_16"])
def test_decoder_continues_a_jax_decoders_streams(codec):
    """One step in JAX, its carried state and unread bytes handed to the
    port (state_from_jax, set_state), the next step in both."""
    streams = fx.lane_streams(codec, B)
    ref = jax_tel.BatchedTelephonyDecoder(codec, B, CHUNK)
    for i, s in enumerate(streams):
        ref.push(i, s[: 100 + 211 * i])
    ref.decode_step()
    port = tel.BatchedTelephonyDecoder(codec, B, CHUNK, device="cpu")
    port.set_state(tel.state_from_jax(ref._state, "cpu"))
    for i in range(B):
        port.push(i, bytes(ref._queues[i]))
    (got, got_lens), (want, want_lens) = port.decode_step(), ref.decode_step()
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_lens, want_lens)
    assert np.count_nonzero(got) > 0
    _assert_state(port, ref)


@pytest.mark.parametrize("codec", ["g711_alaw", "g722", "g726_24"])
def test_lane_group_matches_jax_with_reset(codec):
    streams = fx.lane_streams(codec, B)
    port = tel.TelephonyLaneGroup(codec, B, CHUNK, device="cpu")
    ref = jax_tel.TelephonyLaneGroup(codec, B, CHUNK)
    for m in (port, ref):
        for i, s in enumerate(streams):
            m.push(i, s[: 150 * (i + 1)])
    assert [port.lane_ready(i) for i in range(B)] == [ref.lane_ready(i) for i in range(B)]
    assert port.lane_sample_rate(0) == ref.lane_sample_rate(0) == fx.sample_rate(codec)
    got, got_lens = port.decode_batches(2)
    want, want_lens = ref.decode_batches(2)
    S = CHUNK * (2 if codec == "g722" else 1)
    assert got.shape == (2, B, 1, S)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(np.stack(got_lens), np.stack(want_lens))
    for m in (port, ref):  # recycle lane 5 mid-stream for another clip
        m.reset_lane(5)
        m.push(5, streams[2][:400])
    assert port.lane_ready(5) == ref.lane_ready(5)
    got, _ = port.decode_batches(1)
    want, _ = ref.decode_batches(1)
    np.testing.assert_array_equal(got, np.asarray(want))
    _assert_state(port._dec, ref._dec)
    empty, lens = port.decode_batches(0)
    assert empty.shape == (0, B, 1, S) and lens == []


@pytest.mark.parametrize("codec", CODECS)
def test_encoder_matches_jax(codec):
    pcm = fx.lane_pcm(codec, B)
    port = tel.BatchedTelephonyEncoder(codec, B, CHUNK, device="cpu")
    ref = jax_tel.BatchedTelephonyEncoder(codec, B, CHUNK)
    for m in (port, ref):  # ragged: empty, one sample, odd counts, partial groups
        for i, p in enumerate(pcm):
            m.push(i, p[: (0, 1, 3, 255, 257, 600, 5, 1000)[i]])
    for _ in range(3):
        got, want = port.encode_step(), ref.encode_step()
        assert got == want
    _assert_state(port, ref)
    assert sum(map(len, got)) > 0


def test_fixtures_equal_a_regeneration(tmp_path):
    fresh = generate_telephony_fixtures(tmp_path)
    for codec in CODECS:
        assert fx.load_clips(codec) == fresh[codec], codec


def test_lane_streams_are_distinct_whole_groups_and_ragged():
    streams = fx.lane_streams("g726_24", 64)
    assert len(set(streams)) == 64
    assert all(len(s) % 3 == 0 for s in streams)  # whole 3-byte packing groups
    full = len(fx.load_clips("g726_24")[0])
    assert sum(len(s) < full for s in streams) == 16
    pcm = fx.lane_pcm("g722", 64)
    assert all(len(p) % 2 == 0 for p in pcm) and len({p.tobytes() for p in pcm}) == 64
