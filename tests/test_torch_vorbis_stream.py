"""Port parity of the streaming Ogg Vorbis decoders (``codecs/vorbis.py``
over the port's ``vorbis_core``) against the JAX package's on the CPU:
``VorbisDecoder`` fed the fixtures of ``tests/data/torch_port/vorbis`` in
4096- and 313-byte chunks and ``VorbisPacketDecoder`` on their packets,
bit-exact (the same host code), the crafted floor 0 stream included. The
JAX package keeps libavcodec as the escape hatch for a setup its core
rejects (``VorbisUnsupported``, which no stream raises today); the port
raises ``UnsupportedFormat`` there, shown by making both cores reject."""
from pathlib import Path

import numpy as np
import pytest

from soundkit_tpu.codecs import vorbis as jax_vorbis
from soundkit_tpu.demux.ogg import OggPacketizer
from soundkit_tpu_torch.codecs import vorbis
from soundkit_tpu_torch.codecs.vorbis_core import VorbisUnsupported
from soundkit_tpu_torch.pipeline.output_options import UnsupportedFormat

DATA = Path(__file__).resolve().parent / "data" / "torch_port" / "vorbis"
def _data(name: str) -> bytes:
    return (DATA / f"{name}.ogg").read_bytes()


def _packets(data: bytes):
    return [p for p, _g in OggPacketizer().push(data)]


def _decode(dec, data: bytes, chunk: int) -> np.ndarray:
    outs = [dec.decode_f32(data[i:i + chunk]) for i in range(0, len(data), chunk)]
    return np.concatenate(outs + [dec.flush()])


@pytest.mark.parametrize("name,chunk", [("stereo44", 4096), ("stereo44b", 313), ("mono22", 4096),
                                        ("mono22", 313), ("floor0", 4096), ("floor0", 313)])
def test_vorbis_decoder_matches_jax(name, chunk):
    data = _data(name)
    port, ref = vorbis.VorbisDecoder(), jax_vorbis.VorbisDecoder()
    got, want = _decode(port, data, chunk), _decode(ref, data, chunk)
    assert got.dtype == want.dtype == np.float32 and got.size > 0
    np.testing.assert_array_equal(got, want)
    assert (port.sample_rate, port.channels) == (ref.sample_rate, ref.channels)
    assert ref._av is None  # the JAX package decodes every fixture in its own core


@pytest.mark.parametrize("name", ["stereo44b", "mono22", "floor0"])
def test_vorbis_packet_decoder_matches_jax(name):
    pkts = _packets(_data(name))
    port, ref = vorbis.VorbisPacketDecoder(pkts[:3]), jax_vorbis.VorbisPacketDecoder(pkts[:3])
    assert (port.sample_rate, port.channels) == (ref.sample_rate, ref.channels)
    for p in pkts[3:]:
        np.testing.assert_array_equal(port.decode_packet_f32(p), ref.decode_packet_f32(p))
    assert port.flush().size == ref.flush().size == 0


def test_i16_and_xiph_extradata_match_jax():
    data = _data("mono22")
    np.testing.assert_array_equal(vorbis.VorbisDecoder().decode_i16(data),
                                  jax_vorbis.VorbisDecoder().decode_i16(data))
    heads = _packets(data)[:3]
    extra = vorbis.xiph_extradata(heads)
    assert extra == jax_vorbis.xiph_extradata(heads)
    assert vorbis.split_xiph_extradata(extra) == heads


def test_a_setup_the_core_rejects_raises_unsupported_format(monkeypatch):
    """Where ``cached_setup`` rejects a setup the JAX package opens
    libavcodec (its ``_av``); the port raises ``UnsupportedFormat``, in
    both decoders and, as data, through the pipeline."""
    from soundkit_tpu_torch.pipeline.decode_pipeline import StreamDecoder

    def reject(*args):
        raise VorbisUnsupported("rejected setup")

    monkeypatch.setattr(vorbis, "cached_setup", reject)
    monkeypatch.setattr(jax_vorbis, "cached_setup",
                        lambda *a: (_ for _ in ()).throw(jax_vorbis.VorbisUnsupported("x")))
    data = _data("stereo44")
    ref = jax_vorbis.VorbisDecoder()
    assert ref.decode_f32(data).size > 0 and ref._av is not None
    with pytest.raises(UnsupportedFormat, match="rejected setup.*libavcodec"):
        vorbis.VorbisDecoder().decode_f32(data)
    with pytest.raises(UnsupportedFormat, match="libavcodec"):
        vorbis.VorbisPacketDecoder(_packets(data)[:3])
    outs = StreamDecoder(device="cpu").process(data)
    assert [type(o).__name__ for o in outs] == ["UnsupportedFormat"]
