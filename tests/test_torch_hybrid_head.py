"""A hybrid Opus lane of the port's fleet takes its OpusHead's pre-skip and
output gain (a stated departure: the JAX package's fleet configures only
its CELT and SILK engines from the head, so its hybrid lanes keep their
first pre-skip samples and ignore the gain). A hybrid Ogg Opus stream with
a 312-sample pre-skip and a non-zero gain, served by ``StreamFleet`` on
the CPU, gives the samples and the length of the port's streaming decoder
(``codecs/opus.OggOpusDecoder``) on the same bytes, at the bar PR 21 set
for hybrid streams: 90 dB and 1 LSB (the fleet synthesizes in float32 and
resamples with its probed FIR, the streaming decoder in the owned Python
decoder)."""
import struct

import numpy as np
import pytest

from soundkit_tpu_torch.codecs import opus
from soundkit_tpu_torch.models.fleet import StreamFleet
from soundkit_tpu_torch.tools import opus_fixtures

from torch_port_helpers import ogg_opus, snr_db


def with_gain(head: bytes, gain_q8: int) -> bytes:
    return head[:16] + struct.pack("<h", gain_q8) + head[18:]


@pytest.mark.parametrize("clip,gain_q8,n", [("hybrid_fb", -768, 20), ("hybrid_swb", 1000, 14)])
def test_fleet_hybrid_lane_takes_its_heads_pre_skip_and_gain(clip, gain_q8, n):
    c = opus_fixtures.load_clips(names=(clip,))[0]
    assert c.pre_skip == 312
    data = ogg_opus(with_gain(c.head, gain_q8), c.packets[:n])
    fleet = StreamFleet(4, device="cpu")
    fleet.push("h", data[: len(data) // 2])
    parts = [fleet.collect().get("h")]
    fleet.push("h", data[len(data) // 2:])
    fleet.end_stream("h")
    parts.append(fleet.collect()["h"])
    model = fleet._groups["opus"]._model
    assert model._kind.count("hybrid") == 1
    got = np.concatenate([p for p in parts if p is not None], axis=1).T  # [n, C]
    dec = opus.OggOpusDecoder()
    want = np.concatenate([dec.decode_f32(data), dec.flush()]).reshape(-1, c.channels)
    if c.channels == 1:  # a mono stream fills both channels of the stereo group
        np.testing.assert_array_equal(got[:, 0], got[:, 1])
        got = got[:, :1]
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (n * 960 - 312, c.channels)
    assert snr_db(got, want) >= 90
    q = lambda x: np.clip(np.round(x.astype(np.float64) * 32768.0), -32768, 32767)  # noqa: E731
    assert np.abs(q(got) - q(want)).max() <= 1
    # the gain acts: the same stream with a zero gain is louder or softer by it
    plain = opus.OggOpusDecoder()
    ref = np.concatenate([plain.decode_f32(ogg_opus(c.head, c.packets[:n])), plain.flush()])
    ratio = np.sqrt((want.astype(np.float64) ** 2).sum() / (ref.astype(np.float64) ** 2).sum())
    assert ratio == pytest.approx(10.0 ** (gain_q8 / 5120.0), rel=1e-5)
