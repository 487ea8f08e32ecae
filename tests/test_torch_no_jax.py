"""The port stands without JAX and without the JAX package, picks no
device for the caller, and routes CPU tensors (only those) to the plain
versions."""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
from soundkit_tpu_torch.models.telephony_batch import BatchedTelephonyDecoder, BatchedTelephonyEncoder
from soundkit_tpu_torch.ops import aac_batch, aac_entropy, adpcm, companding, g722, imdct
from soundkit_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "soundkit_tpu_torch"

_NO_JAX_DECODE = r"""
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name in ("jax", "soundkit_tpu") or name.startswith(("jax.", "jaxlib", "soundkit_tpu.")):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, _Block())
import numpy as np
from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
from soundkit_tpu_torch.tools.aac_fixtures import load_clips, lane_streams
m = BatchedAacLcDecoder(2, 2, device="cpu")
for i, s in enumerate(lane_streams(load_clips(), 2, 2)):
    m.push(i, s)
pcm = m.decode_batches(2)
assert pcm.shape == (2, 2, 2, 1024) and np.isfinite(pcm).all() and np.abs(pcm).max() > 0
assert m.v4_batches == 2
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("decoded without jax")
"""


_NO_JAX_TELEPHONY = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
from soundkit_tpu_torch.models.telephony_batch import BatchedTelephonyDecoder, BatchedTelephonyEncoder
from soundkit_tpu_torch.tools.telephony_fixtures import lane_pcm, lane_streams
for codec in ("g711_alaw", "g722", "g726_24"):
    d = BatchedTelephonyDecoder(codec, 3, 64, device="cpu")
    for i, s in enumerate(lane_streams(codec, 3)):
        d.push(i, s)
    pcm, lens = d.decode_step()
    assert pcm.shape == (3, 64 * d.samples_per_code) and np.abs(pcm).max() > 0 and lens.min() > 0
    e = BatchedTelephonyEncoder(codec, 3, 64, device="cpu")
    for i, p in enumerate(lane_pcm(codec, 3)):
        e.push(i, p)
    assert all(len(b) > 0 for b in e.encode_step())
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("telephony without jax")
"""


_NO_JAX_FLEET = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
from soundkit_tpu_torch.models.fleet import FleetUnsupported, StreamFleet
from soundkit_tpu_torch.tools import aac_fixtures, flac_fixtures, telephony_fixtures
fleet = StreamFleet(2, device="cpu")
fleet.push("a", aac_fixtures.lane_streams(aac_fixtures.load_clips(), 1, 2)[0])
fleet.push("f", flac_fixtures.lane_streams(flac_fixtures.load_clips(), 2, 1)[1])
fleet.push("t", telephony_fixtures.lane_streams("g711_mulaw", 1)[0][:500], kind="g711_mulaw")
for sid in "aft":
    fleet.end_stream(sid)
out = fleet.collect()
assert out["a"].shape == (2, 2048) and out["f"].shape == (2, 4096) and out["t"].shape == (1, 500)
assert all(np.isfinite(v).all() and np.abs(v).max() > 0 for v in out.values())
from soundkit_tpu_torch.tools import vorbis_fixtures
fleet.push("v", vorbis_fixtures.lane_streams(vorbis_fixtures.load_clips(), 1, 2)[0])
fleet.end_stream("v")
pcm = fleet.collect()["v"]
assert pcm.shape[0] == 2 and pcm.shape[1] > 4096 and np.isfinite(pcm).all() and np.abs(pcm).max() > 0.01
from soundkit_tpu_torch.tools import celp_fixtures
from soundkit_tpu_torch.tools import host_codec_fixtures as hcf
for sid, clip in (("amr", "amrnb_switch"), ("g729", "g729_speech")):
    fleet.push(sid, hcf.clip_bytes(clip), kind=celp_fixtures.kind(clip))
    fleet.end_stream(sid)
    got = fleet.collect()[sid]
    ref = hcf.reference_pcm(clip)
    assert got.shape == (1, len(ref)), (sid, got.shape)
    assert np.array_equal(np.round(got[0] * 32768).astype(np.int64), ref.astype(np.int64)), sid
from soundkit_tpu_torch.tools import host_codec_fixtures
fleet.push("gsm", host_codec_fixtures.clip_bytes("gsm_standard"), kind="gsm")
fleet.end_stream("gsm")
assert fleet.collect()["gsm"].shape == (1, 16000)
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("fleet without jax")
"""


_NO_JAX_MP3 = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
from soundkit_tpu_torch.models.fleet import StreamFleet
from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
from soundkit_tpu_torch.tools import mp3_fixtures
clips = mp3_fixtures.load_clips()
m = BatchedMp3Decoder(3, device="cpu")
for i, s in enumerate(mp3_fixtures.lane_streams(clips, 3, 8)):
    m.push(i, s)
pcm = m.decode_batches(max(m.lane_ready(i) for i in range(3)))
assert pcm.shape == (16, 3, 2, 576) and np.isfinite(pcm).all() and np.abs(pcm).max() > 0.01
assert [m.lane_sample_rate(i) for i in range(3)] == [44100, 48000, 22050]
fleet = StreamFleet(2, device="cpu")
fleet.push("m", clips[4].stream())
fleet.end_stream("m")
out = fleet.collect()["m"]
assert out.shape == (2, 30 * 576) and np.abs(out[0]).max() > 0.01 and not out[1].any()
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("mp3 without jax")
"""


_NO_JAX_OPUS = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
from soundkit_tpu_torch.models.fleet import FleetUnsupported, StreamFleet
from soundkit_tpu_torch.models.opus_batch import BatchedCeltDecoder
from soundkit_tpu_torch.tools import opus_fixtures
clips = opus_fixtures.load_clips()
m = BatchedCeltDecoder(2, 2, wire="i16", device="cpu")
for i, s in enumerate(opus_fixtures.lane_raw(clips, 2, 6)):
    m.push(i, s)
pcm, lens = m.decode_ready()
assert pcm.shape == (6, 2, 2, 960) and np.isfinite(pcm).all() and np.abs(pcm).max() > 0.01
assert lens[0].tolist() == [648, 648] and (lens[1:] == 960).all()
fleet = StreamFleet(2, device="cpu")
for i, s in enumerate(opus_fixtures.lane_streams(clips, 3, 8)[1:]):
    fleet.push(f"o{i}", s)
    fleet.end_stream(f"o{i}")
out = fleet.collect()
assert out["o0"].shape == (2, 8 * 960 - 312) and out["o1"].shape == (2, 8 * 960)
assert all(np.isfinite(v).all() and np.abs(v).max() > 0.01 for v in out.values())
from soundkit_tpu_torch.models.opus_batch import BatchedHybridDecoder, BatchedSilkDeviceDecoder
voice = {c.name: c for c in opus_fixtures.load_clips(names=opus_fixtures.VOICE_CLIPS)}
for cls, names in ((BatchedSilkDeviceDecoder, ("silk_nb", "silk_wb_stereo")),
                   (BatchedHybridDecoder, ("hybrid_swb", "hybrid_fb"))):
    m = cls(2, 2, device="cpu")
    for b, name in enumerate(names):
        for frame, bw, coded in opus_fixtures.lane_frames([voice[name]], 0, 5):
            m.push_packet(b, frame, bw, coded)
    pcm, lens = m.decode_ready()
    assert pcm.shape == (5, 2, 2, 960) and np.isfinite(pcm).all() and np.abs(pcm).max() > 0.01
    assert lens.sum() == 10 * 960 - (23 if cls is BatchedSilkDeviceDecoder else 0)
for sid, name in (("v0", "silk_mb"), ("v1", "hybrid_fb")):
    fleet.push(sid, opus_fixtures.lane_streams([voice[name]], 1, 6)[0], kind="opus")
    fleet.end_stream(sid)
out = fleet.collect()
# the hybrid stream takes its OpusHead's pre-skip too (the port's stated departure)
assert out["v0"].shape == (2, 6 * 960 - 312) and out["v1"].shape == (2, 6 * 960 - 312)
switch = voice["silk_nb"].packets[:3] + voice["silk_wb"].packets[3:5]
fleet.push("s", voice["silk_nb"].header + b"".join(
    b"OggS" + bytes(22) + bytes([1, len(p)]) + p for p in switch), kind="opus")
assert "s" in fleet._fallback  # the SILK bandwidth switch moved it to the host
fleet.end_stream("s")
out = fleet.collect()["s"]
assert out.shape == (1, 5 * 960 - 312) and np.isfinite(out).all() and np.abs(out).max() > 0.01
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("opus without jax")
"""


_NO_JAX_FLAC_ENC = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
from soundkit_tpu_torch.models.flac_encode_batch import BatchedFlacEncoder
from soundkit_tpu_torch.tools import flac_fixtures as ff
clip = ff.load_clips()[3]
lanes = ff.rotated_lanes([ff.clip_pcm(clip, "cpu")], 2, 9000)
enc = BatchedFlacEncoder(2, clip.rate, clip.channels, clip.bits, device="cpu")
for i, x in enumerate(lanes):
    enc.push(i, x)
assert enc.encode_pending() == 4
streams = enc.finish_all()
for x, got, s in zip(lanes, ff.decode_streams(streams, "cpu"), streams):
    assert np.array_equal(got, x) and ff.streaminfo_md5(s) == ff.pcm_md5(x, clip.bits)
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("flac encode without jax")
"""


_NO_JAX_DSP = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
import torch
import soundkit_tpu_torch.core
from soundkit_tpu_torch.core.audio_pipeline import downsample_audio
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.ops import resample as rs
from soundkit_tpu_torch.ops import stretch as st
from soundkit_tpu_torch.pipeline.resampler import StreamingResampler
from soundkit_tpu_torch import stretch
x = torch.from_numpy(np.sin(np.arange(2 * 4410, dtype=np.float32) * 0.05).reshape(2, 4410))
one = rs.resample(x, 44100, 8000)
h = rs.resample_init_state(2, "cpu")
a, h = rs.resample_stateful(x[:, :2205].contiguous(), h, 44100, 8000)
b, h = rs.resample_stateful(x[:, 2205:].contiguous(), h, 44100, 8000)
assert one.shape == (2, 800) and torch.equal(torch.cat([a, b], 1), one)
sr = StreamingResampler(44100, 8000, 2)
assert np.array_equal(sr.process(x.numpy()), rs.resample_np(x.numpy(), 44100, 8000))
audio = AudioData(16, 1, 44100, (x[0].numpy() * 9000).astype("<i2").tobytes(),
                  EncodingFlag.PCM_SIGNED, Endianness.LITTLE)
assert downsample_audio(audio, 8000)[0].shape == (800,)
y = st.pitch_shift_batch_device(x, 1.25, 1.5)
assert y.shape == (2, 5512) and torch.isfinite(y).all() and y.abs().max() > 0.1
cfg = stretch.OfflineStretchConfig.recommended_for_music(44100, 1).with_time_ratio(1.5)
assert abs(stretch.stretch_audio_data(audio, cfg).frame_count - 6615) <= 2
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("dsp without jax")
"""


_NO_JAX_PIPELINE = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
from pathlib import Path
from soundkit_tpu_torch.codecs.g711 import G711Law
from soundkit_tpu_torch.codecs.g726 import G726Packing, G726Rate
from soundkit_tpu_torch.core.audio_types import AudioData, PcmData
from soundkit_tpu_torch.core.raw_pcm import RawPcmFormat
from soundkit_tpu_torch.core.wav import generate_wav_buffer
from soundkit_tpu_torch.pipeline.decode_pipeline import DecodePipeline
from soundkit_tpu_torch.tools import telephony_fixtures as tfx
data = Path("tests/data/torch_port")
pcm = (np.sin(np.arange(9000) * 0.03) * 8000).astype(np.int16)
streams = {
    "wav": (DecodePipeline.spawn, generate_wav_buffer(PcmData.i16([pcm, pcm]), 16000)),
    "flac": (DecodePipeline.spawn, (data / "flac" / "mono16.flac").read_bytes()),
    "mp3": (DecodePipeline.spawn, (data / "mp3" / "mono8.mp3").read_bytes()),
    "aac": (DecodePipeline.spawn, (data / "drums.aac").read_bytes()[:20000]),
    "raw_pcm": (lambda device: DecodePipeline.spawn_raw_pcm(RawPcmFormat.linear16(8000, 1),
                                                            device=device), pcm.tobytes()),
    "g711": (lambda device: DecodePipeline.spawn_g711(G711Law.A_LAW, device=device),
             tfx.load_clips("g711_alaw")[0][:800]),
    "g722": (lambda device: DecodePipeline.spawn_g722(device=device),
             tfx.load_clips("g722")[0][:100]),
    "g726": (lambda device: DecodePipeline.spawn_g726_with_rate(
        G726Rate.RATE_24000, G726Packing.LEFT, device=device), tfx.load_clips("g726_24")[0][:90]),
}
for name, (spawn, stream) in streams.items():
    h = spawn(device="cpu")
    for i in range(0, len(stream), 4096):
        h.send_blocking(stream[i:i + 4096])
    h.send_blocking(b"")
    outs = h.recv_all()
    assert outs and all(isinstance(o, AudioData) for o in outs), (name, outs)
    x = np.frombuffer(b"".join(o.data for o in outs), "<i2")
    assert len(x) > 100 and np.abs(x).max() > 0, name
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("pipeline without jax")
"""


_NO_JAX_STREAMS = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
from soundkit_tpu_torch.core.audio_types import AudioData
from soundkit_tpu_torch.models.fleet import StreamFleet
from soundkit_tpu_torch.pipeline.decode_pipeline import StreamDecoder
from soundkit_tpu_torch.tools import opus_fixtures, vorbis_fixtures
clips = opus_fixtures.load_clips()
voice = opus_fixtures.load_clips(names=("silk_wb",))
streams = {"ogg_opus": clips[0].stream(), "silk": voice[0].stream(),
           "opus_raw": opus_fixtures.lane_raw(clips, 2, 20)[1],
           "vorbis": vorbis_fixtures.load_clips(names=("mono22",))[0].stream()}
for name, data in streams.items():
    dec = StreamDecoder(device="cpu")
    outs = [o for i in range(0, len(data), 4096) for o in dec.process(data[i:i + 4096])]
    outs += dec.process(b"")
    assert outs and all(isinstance(o, AudioData) for o in outs), (name, outs)
    x = np.frombuffer(b"".join(o.data for o in outs), "<i2")
    assert len(x) > 1000 and np.abs(x).max() > 100, name
fleet = StreamFleet(1, device="cpu")
lanes = opus_fixtures.lane_streams(clips, 2, 10)
fleet.push("lane", lanes[0], kind="opus")
fleet.push("overflow", lanes[1], kind="opus")
assert "overflow" in fleet._fallback
for sid in ("lane", "overflow"):
    fleet.end_stream(sid)
out = fleet.collect()
# a host stream keeps its own channel count: the mono clip decodes to one plane
assert out["lane"].shape == (2, 10 * 960 - 312) and out["overflow"].shape == (1, 10 * 960 - 312)
assert np.abs(out["overflow"]).max() > 0.01
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("streams without jax")
"""


_NO_JAX_HOST_CODECS = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
from soundkit_tpu_torch.codecs.telephony import GsmVariant
from soundkit_tpu_torch.core.audio_types import AudioData
from soundkit_tpu_torch.pipeline.decode_pipeline import DecodePipeline
from soundkit_tpu_torch.tools import host_codec_fixtures as hcf
spawns = {"detect": DecodePipeline.spawn, "alac": DecodePipeline.spawn_alac,
          "gsm_standard": lambda device: DecodePipeline.spawn_gsm(device=device),
          "gsm_microsoft": lambda device: DecodePipeline.spawn_gsm(GsmVariant.MICROSOFT,
                                                                   device=device)}
index = hcf.load_index()
for name in ("gsm_standard", "gsm_wav49", "ac3_stereo", "speex_nb", "speex_wb", "speex_uwb",
             "alac_caf", "alac_mp4", "aiff_16", "aifc_ulaw", "aifc_alaw"):
    data, e = hcf.clip_bytes(name), index[name]
    h = spawns[e["spawn"]](device="cpu")
    for i in range(0, len(data), 4096):
        h.send_blocking(data[i:i + 4096])
    h.send_blocking(b"")
    outs = h.recv_all()
    assert outs and all(isinstance(o, AudioData) for o in outs), (name, outs)
    assert hcf.sha256(b"".join(o.data for o in outs)) == e["sha256"], name
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("host codecs without jax")
"""


_NO_JAX_CONTAINERS = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
from soundkit_tpu_torch.core.audio_types import AudioData
from soundkit_tpu_torch.models.fleet import StreamFleet
from soundkit_tpu_torch.pipeline.decode_pipeline import DecodePipeline
from soundkit_tpu_torch.simple import AudioTrackDemuxer
from soundkit_tpu_torch.tools import container_fixtures as cf
index = cf.load_index()
for name in cf.CASES:
    data, e = cf.build(name), index[name]
    assert cf.sha256(data) == e["sha256_bytes"], name
    if "events" in e:
        for chunk in (188, 0):
            events = cf.demux_events(AudioTrackDemuxer.new_auto(), data, chunk)
            assert cf.events_digest(events) == e["events"], name
    if name not in cf.DECODED:
        continue
    spawn = DecodePipeline.spawn_aac_latm if e["spawn"] == "latm" else DecodePipeline.spawn
    h = spawn(device="cpu")
    for i in range(0, len(data), 4096):
        h.send_blocking(data[i:i + 4096])
    h.send_blocking(b"")
    outs = h.recv_all()
    assert outs and all(isinstance(o, AudioData) for o in outs), (name, outs)
    pcm = b"".join(o.data for o in outs)
    if name in cf.REFERENCE_PCM:
        a = np.frombuffer(pcm, "<i2").astype(np.int32)[:48000]
        assert len(pcm) == e["pcm_bytes"] and np.abs(a - cf.reference_pcm(name)).max() <= 1, name
    elif name != "webm_opus_hybrid":
        assert (len(pcm), cf.sha256(pcm)) == (e["pcm_bytes"], e["sha256"]), name
fleet = StreamFleet(1, device="cpu")
fleet.push("m4a", cf.build("m4a_aac"))
fleet.end_stream("m4a")
assert fleet.collect()["m4a"].shape == (2, 40 * 1024)
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("containers without jax")
"""


_NO_JAX_LEFTOVERS = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
import soundkit_tpu_torch.models as models
from soundkit_tpu_torch.codecs.flac import FlacPartsStream, FlacSegsStream
from soundkit_tpu_torch.codecs.silk_native import NativeSilkBatch
from soundkit_tpu_torch.models.opus_batch import BatchedOpusDecoder, BatchedSilkDecoder
from soundkit_tpu_torch.tools import flac_fixtures, opus_fixtures
from soundkit_tpu_torch.utils import quality, test_utils, waveform
assert len(models.__all__) == 7 and models.BatchedOpusDecoder is BatchedOpusDecoder
raw = opus_fixtures.lane_raw(opus_fixtures.load_clips(), 2, 3)
dec = BatchedOpusDecoder(2, 2)
for i, r in enumerate(raw):
    dec.push(i, r)
pcm, lengths = dec.decode_ready()
assert pcm.shape == (3, 2, 2, 960) and lengths[0, 0] == 648 and np.abs(pcm).max() > 0
voice = opus_fixtures.load_clips(names=("silk_wb",))
host = BatchedSilkDecoder(1, 1)
for frame, bw, coded in opus_fixtures.lane_frames(voice, 0, 3):
    host.push_packet(0, frame, bw, coded)
pcm, lengths = host.decode_ready()
assert pcm.shape == (3, 1, 1, 960) and lengths.sum() == 3 * 960 and np.abs(pcm).max() > 0
frames = [f for f, _, _ in opus_fixtures.lane_frames(voice, 0, 1)]
out, n, info = NativeSilkBatch(1, 1).decode_many(frames, [2], [1], [20], [1])
assert n[0] == 320 and np.abs(out).max() > 0
clip = flac_fixtures.load_clips()[0]
for walk, step in ((FlacPartsStream(4096), "next_parts"), (FlacSegsStream(4096), "next")):
    walk.feed(clip.header + clip.frames[0] + clip.frames[1])
    assert getattr(walk, step)() is not None
x = np.sin(np.arange(4800) * 0.05).astype(np.float32)
assert quality.QualityComparison.compare(x, x).passes_default_thresholds()
assert test_utils.DecodeResult.new((x * 9000).astype(np.int16), 48000, 1).sample_count == 4800
assert len(waveform.render_waveform(waveform.waveform_peaks(x))) == 8
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("leftovers without jax")
"""


_NO_JAX_AAC_MC = _NO_JAX_DECODE.split("import numpy as np")[0] + r"""
import numpy as np
from soundkit_tpu_torch.codecs.aac import AacDecoder
from soundkit_tpu_torch.models.fleet import StreamFleet
from soundkit_tpu_torch.pipeline.decode_pipeline import DecodePipeline
from soundkit_tpu_torch.tools import aac_mc_fixtures as amf
for name in amf.CLIPS:
    dec = AacDecoder()
    pcm = dec.decode_i16(amf.clip_bytes(name))
    assert np.array_equal(pcm, amf.reference(name, "pcm")), name
h = DecodePipeline.spawn(device="cpu")
h.send_blocking(amf.build("m4a_51"))
h.send_blocking(b"")
outs = h.recv_all()
assert np.array_equal(np.frombuffer(b"".join(o.data for o in outs), "<i2"), amf.reference("cfg6", "pcm"))
fleet = StreamFleet(1, device="cpu")
fleet.push("a", amf.clip_bytes("cfg6"), kind="aac")
fleet.end_stream("a")
assert fleet.collect()["a"].shape == (6, 48 * 1024)
assert not any(k in ("jax", "soundkit_tpu") or k.startswith(("jax.", "soundkit_tpu.")) for k in sys.modules)
print("multichannel aac without jax")
"""


_NO_JAX_ENCODE = r"""
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name in ("jax", "soundkit_tpu", "cryptography") or name.startswith(
                ("jax.", "jaxlib", "soundkit_tpu.", "cryptography.")):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, _Block())
import numpy as np
from soundkit_tpu_torch import simple
from soundkit_tpu_torch.codecs import encoders, opus_celt_enc, opus_silk_enc
from soundkit_tpu_torch.core import audio_content_crypto, audio_packet, crypto, frame_header
from soundkit_tpu_torch.core.audio_types import EncodingFlag
from soundkit_tpu_torch.core.frame_stream import encode_frame
from soundkit_tpu_torch.demux.ogg import OggOpusWriter
t = np.arange(9600)
x = 0.3 * np.sin(0.03 * t)
pkts = opus_celt_enc.OpusCeltEncoder(2, 64000).push(np.stack([x, x], 1))
assert len(pkts) == 9 and opus_celt_enc.OpusCeltEncoder(1, 64000)._native is not None
voice = opus_silk_enc.OpusSilkEncoder("wb", 24000, 1)
assert voice._native is not None and len(voice.push(x[:, None])) == 10
flac = simple.FlacEncoder(48000, 2).encode_planar_f32(np.concatenate([x, x]).astype(np.float32), 9600)
assert flac[:2] == b"\xff\xf8"
w = OggOpusWriter(2)
for p in pkts:
    w.write_packet(p)
assert w.close()[:4] == b"OggS"
wire = b"".join(encode_frame(frame_header.FrameHeaderV2(EncodingFlag.OPUS, len(p), 960, 48000, 2, 0)
                             .with_packet_crc32(p), p) for p in pkts)
dec = simple.SoundKitFrameDecoder()
assert [f.payload for f in dec.push(wire)] == pkts and dec.flush() == []
assert len(crypto.key_from_decimal("12345")) == 32
for make in (lambda: crypto.ChaCha20Poly1305PacketCipher(bytes(range(32))),
             lambda: simple.SoundKitFrameDecoder("12345"),
             lambda: simple.AudioContentCipher(bytes(range(32))),
             lambda: simple.AudioContentKeyUnwrapper(bytes(range(1, 33)))):
    try:
        make()
        raise AssertionError("a cipher was made without cryptography")
    except ImportError as e:
        assert "'cryptography' package" in str(e), e
assert not any(k in ("jax", "soundkit_tpu", "cryptography")
               or k.startswith(("jax.", "soundkit_tpu.", "cryptography.")) for k in sys.modules)
print("encoders without jax or cryptography")
"""


@pytest.mark.parametrize("script,said", [(_NO_JAX_DECODE, "decoded without jax"),
                                         (_NO_JAX_TELEPHONY, "telephony without jax"),
                                         (_NO_JAX_FLEET, "fleet without jax"),
                                         (_NO_JAX_MP3, "mp3 without jax"),
                                         (_NO_JAX_OPUS, "opus without jax"),
                                         (_NO_JAX_FLAC_ENC, "flac encode without jax"),
                                         (_NO_JAX_DSP, "dsp without jax"),
                                         (_NO_JAX_PIPELINE, "pipeline without jax"),
                                         (_NO_JAX_STREAMS, "streams without jax"),
                                         (_NO_JAX_HOST_CODECS, "host codecs without jax"),
                                         (_NO_JAX_CONTAINERS, "containers without jax"),
                                         (_NO_JAX_AAC_MC, "multichannel aac without jax"),
                                         (_NO_JAX_LEFTOVERS, "leftovers without jax"),
                                         (_NO_JAX_ENCODE, "encoders without jax or cryptography")])
def test_port_runs_on_cpu_with_jax_blocked(script, said):
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert said in proc.stdout


def test_no_port_source_imports_jax():
    """Neither JAX nor the JAX package, anywhere in the port, and the
    build reads no file of the JAX package's tree."""
    pat = re.compile(r"^\s*(import jax|from jax|(import|from) soundkit_tpu\b(?!_))", re.M)
    offenders = [str(p) for p in PORT.rglob("*.py") if pat.search(p.read_text())]
    assert not offenders
    build = (PORT / "_build.py").read_text()
    assert not re.search(r"soundkit_tpu/|\"soundkit_tpu\"", build)


@pytest.mark.parametrize("path", ["chip_smoke.py", "tests/test_torch_cuda_kernels.py",
                                  "soundkit_tpu_torch/tools/profile_step.py"])
def test_gpu_entry_points_import_only_the_port(path):
    """What runs on the card imports neither JAX nor the JAX package:
    the port carries its own copies of the host modules it needs."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|soundkit_tpu)\b", re.M)
    assert not pat.findall((REPO / path).read_text())


def test_timed_decoder_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        BatchedAacLcDecoder(2, 2, device="cpu", timed=True)
    with pytest.raises(ValueError, match="CUDA"):
        BatchedTelephonyDecoder("g722", 2, device="cpu", timed=True)
    from soundkit_tpu_torch.models.opus_batch import (BatchedCeltDecoder, BatchedHybridDecoder,
                                                      BatchedSilkDeviceDecoder)

    for cls in (BatchedCeltDecoder, BatchedSilkDeviceDecoder, BatchedHybridDecoder):
        with pytest.raises(ValueError, match="CUDA"):
            cls(2, 2, device="cpu", timed=True)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        BatchedAacLcDecoder(2, 2, device="cuda")
    with pytest.raises(RuntimeError):
        BatchedTelephonyDecoder("g726_32", 2, device="cuda")
    with pytest.raises(RuntimeError):
        BatchedTelephonyEncoder("g711_mulaw", 2, device="cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only CPU tensors reach the plain versions; anything else must
    launch a kernel or raise."""
    meta = torch.empty((16, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        imdct.imdct_window(meta, imdct.ImdctBasis(meta, meta), meta,
                           torch.empty(16, dtype=torch.int32, device="meta"))
    counts = (imdct.imdct_window.launches, aac_entropy.spectral_decode.launches,
              aac_batch.tns_filter.launches)
    coef = torch.randn((1, 2, 1024))
    perm = torch.arange(1024, dtype=torch.int32).expand(1, 2, 1024).contiguous()
    filt = torch.full((1, 2, 1024), -1, dtype=torch.int32)
    out = aac_batch.tns_filter(coef, perm, filt, torch.zeros((1, 2, 8, 20)))
    assert torch.equal(out, coef)
    assert counts == (imdct.imdct_window.launches, aac_entropy.spectral_decode.launches,
                      aac_batch.tns_filter.launches)


def test_telephony_wrappers_refuse_meta_tensors():
    """The telephony wrappers raise for a tensor that is neither on the
    CPU nor on a CUDA device, and count no launch."""
    def counts():
        return (companding.g711_decode.launches, adpcm.g726_decode_scan.launches,
                adpcm.g726_encode_scan.launches, g722.g722_decode_scan.launches,
                g722.g722_encode_scan.launches)

    before = counts()
    codes = torch.empty((4, 16), dtype=torch.uint8, device="meta")
    pcm = torch.empty((4, 16), dtype=torch.int16, device="meta")
    i32 = torch.empty(4, dtype=torch.int32, device="meta")
    calls = [
        lambda: companding.g711_decode(codes, i32, i32),
        lambda: adpcm.g726_decode_scan(codes, adpcm.g726_init_state(4, "meta"), 4),
        lambda: adpcm.g726_encode_scan(pcm, adpcm.g726_init_state(4, "meta"), 4),
        lambda: g722.g722_decode_scan(codes, g722.g722_init_state(4, "meta")),
        lambda: g722.g722_encode_scan(pcm, g722.g722_init_state(4, "meta")),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert counts() == before


def test_mp3_synth_refuses_meta_tensors():
    """K10's wrapper raises for tensors neither on the CPU nor on a CUDA
    device, and counts no launch."""
    from soundkit_tpu_torch.ops import mp3_synth

    before = mp3_synth.mp3_granule_packed.launches
    wire = torch.empty(mp3_synth.mp3_wire_layout(4)[1], dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        mp3_synth.mp3_granule_packed(wire, torch.empty((4, 2, 32, 18), device="meta"),
                                     torch.empty((4, 2, 1024), device="meta"))
    assert mp3_synth.mp3_granule_packed.launches == before


def test_celt_postfilter_refuses_meta_tensors():
    """K11's wrapper raises for tensors neither on the CPU nor on a CUDA
    device, and counts no launch."""
    from soundkit_tpu_torch.ops import celt_postfilter

    before = celt_postfilter.celt_postfilter.launches
    meta = [torch.empty(s, device="meta") for s in ((4, 2, 1080), (4, 16))]
    valid = torch.empty(4, dtype=torch.bool, device="meta")
    state = [torch.empty(s, device="meta") for s in ((4, 2, 120), (4, 2, 1200), (4, 2))]
    with pytest.raises(ValueError, match="CUDA device"):
        celt_postfilter.celt_postfilter(*meta, valid, *state)
    assert celt_postfilter.celt_postfilter.launches == before


SILK_SHAPES = dict(exc=(4, 2, 320), gains=(4, 2, 4), coef=(4, 2, 2, 16), has_leadin=(4, 2),
                   voiced=(4, 2), lags=(4, 2, 4), ltp=(4, 2, 4, 5), ltpscale=(4, 2),
                   out_hist=(4, 2, 322), lpch_tail=(4, 2, 16))


def _silk_args(device, strided=None):
    args = []
    for name, shape in SILK_SHAPES.items():
        dtype = torch.int32 if name in ("has_leadin", "voiced", "lags") else torch.float32
        if name == strided:
            t = torch.empty((*shape, 2), dtype=dtype, device=device)[..., 0]
            assert t.shape == shape and not t.is_contiguous()
        else:
            t = torch.empty(shape, dtype=dtype, device=device)
        args.append(t)
    return args


def test_silk_synth_refuses_meta_tensors():
    """K12's wrapper raises for tensors neither on the CPU nor on a CUDA
    device, and counts no launch."""
    from soundkit_tpu_torch.ops import silk_synth

    before = silk_synth.silk_synth.launches
    with pytest.raises(ValueError, match="CUDA device"):
        silk_synth.silk_synth(2, *_silk_args("meta"))
    assert silk_synth.silk_synth.launches == before


@pytest.mark.parametrize("strided", list(SILK_SHAPES))
def test_silk_synth_refuses_a_strided_input(strided):
    """K12 indexes its rows as if packed: a view of the right shape but
    not contiguous is refused before any launch, whichever input it is."""
    from soundkit_tpu_torch.ops import silk_synth

    before = silk_synth.silk_synth.launches
    with pytest.raises(ValueError, match="non-contiguous"):
        silk_synth.silk_synth(2, *_silk_args("meta", strided))
    assert silk_synth.silk_synth.launches == before


CELT_INPUTS = ("full", "comb", "valid", "ola", "hist", "emph", "pcm_out")


@pytest.mark.parametrize("strided", CELT_INPUTS)
def test_celt_postfilter_refuses_a_strided_input(strided):
    """K11 indexes its rows as if packed: a view of the right shape but
    not contiguous (every other element of a wider tensor) is
    refused before any launch, whichever input it is."""
    from soundkit_tpu_torch.ops import celt_postfilter

    B, C = 4, 2
    shapes = dict(full=(B, C, 1080), comb=(B, 16), valid=(B,), ola=(B, C, 120),
                  hist=(B, C, 1200), emph=(B, C), pcm_out=(B, C, 960))
    args = {}
    for name, shape in shapes.items():
        dtype = torch.bool if name == "valid" else torch.float32
        if name == strided:
            args[name] = torch.empty((*shape, 2), dtype=dtype, device="meta")[..., 0]
            assert args[name].shape == shape and not args[name].is_contiguous()
        else:
            args[name] = torch.empty(shape, dtype=dtype, device="meta")
    before = celt_postfilter.celt_postfilter.launches
    with pytest.raises(ValueError, match="non-contiguous"):
        celt_postfilter.celt_postfilter(*(args[k] for k in CELT_INPUTS[:-1]),
                                        pcm_out=args["pcm_out"])
    assert celt_postfilter.celt_postfilter.launches == before


def test_build_rebuilds_when_a_header_changes(tmp_path, monkeypatch):
    """A library is keyed by its sources and the headers passed as
    ``deps`` (the kernel library passes ``csrc/*.cuh``): the same inputs
    reuse the build, an edited header gives a new one."""
    import ctypes

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    src, hdr = tmp_path / "a.cpp", tmp_path / "a.h"
    src.write_text('#include "a.h"\nextern "C" int skt_a() { return A; }\n')
    hdr.write_text("#define A 3\n")
    flags = (*_build.GXX_FLAGS, f"-I{tmp_path}")
    gxx = shutil.which("g++")
    first = _build._build("hdr", gxx, flags, [src], [hdr])
    assert _build._build("hdr", gxx, flags, [src], [hdr]) == first
    hdr.write_text("#define A 4\n")
    second = _build._build("hdr", gxx, flags, [src], [hdr])
    assert second != first
    assert (ctypes.CDLL(str(first)).skt_a(), ctypes.CDLL(str(second)).skt_a()) == (3, 4)


def test_entry_points_default_to_cuda():
    """Each model class and each ``*_init_state`` helper runs on the card
    unless the caller names the CPU: called without a device it asks for
    CUDA, and raises where there is none, never building on the CPU."""
    import inspect

    from soundkit_tpu_torch.models.telephony_batch import TelephonyLaneGroup

    from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder
    from soundkit_tpu_torch.models.flac_encode_batch import BatchedFlacEncoder
    from soundkit_tpu_torch.models.fleet import StreamFleet
    from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder
    from soundkit_tpu_torch.models.opus_batch import (BatchedCeltDecoder, BatchedHybridDecoder,
                                                      BatchedSilkDeviceDecoder)
    from soundkit_tpu_torch.models.opus_fleet_model import BatchedOggOpusDecoder
    from soundkit_tpu_torch.ops import mp3_batch, silk_batch
    from soundkit_tpu_torch.ops import resample as rs

    calls = {
        rs.resample_init_state: lambda: rs.resample_init_state(2),
        BatchedCeltDecoder: lambda: BatchedCeltDecoder(2, 2),
        BatchedSilkDeviceDecoder: lambda: BatchedSilkDeviceDecoder(2, 2),
        BatchedHybridDecoder: lambda: BatchedHybridDecoder(2, 2),
        silk_batch.init_state: lambda: silk_batch.init_state(2, 2),
        BatchedOggOpusDecoder: lambda: BatchedOggOpusDecoder(2),
        BatchedFlacDecoder: lambda: BatchedFlacDecoder(2),
        BatchedFlacEncoder: lambda: BatchedFlacEncoder(2, 44100, 2),
        BatchedMp3Decoder: lambda: BatchedMp3Decoder(2),
        mp3_batch.init_state: lambda: mp3_batch.init_state(2),
        StreamFleet: lambda: StreamFleet(2),
        BatchedAacLcDecoder: lambda: BatchedAacLcDecoder(2, 2),
        BatchedTelephonyDecoder: lambda: BatchedTelephonyDecoder("g726_32", 2),
        TelephonyLaneGroup: lambda: TelephonyLaneGroup("g722", 2),
        BatchedTelephonyEncoder: lambda: BatchedTelephonyEncoder("g711_mulaw", 2),
        adpcm.g726_init_state: lambda: adpcm.g726_init_state(2),
        g722.g722_init_state: lambda: g722.g722_init_state(2),
    }
    for fn, call in calls.items():
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    assert adpcm.g726_init_state(2, "cpu").device.type == "cpu"


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("nvcc is installed")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.kernel_library_path()


def test_build_failure_carries_compiler_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(_build.BuildError, match="bad.cpp"):
        _build._build("bad", shutil.which("g++"), _build.GXX_FLAGS, [bad], [])


def test_vorbis_overlap_refuses_meta_tensors():
    """K13's wrapper raises for tensors neither on the CPU nor on a CUDA
    device, and counts no launch; the Vorbis decoder times only on the
    card."""
    from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder
    from soundkit_tpu_torch.ops import vorbis_overlap

    before = vorbis_overlap.vorbis_overlap.launches
    meta = [torch.empty(s, device="meta") for s in ((4, 2, 2048), (4, 2, 256), (5, 2048))]
    flags = torch.empty((5, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        vorbis_overlap.vorbis_overlap(*meta, flags, torch.empty((4, 2, 1024), device="meta"))
    assert vorbis_overlap.vorbis_overlap.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        BatchedVorbisDecoder(2, device="cpu", timed=True)


def test_dsp_wrappers_refuse_meta_tensors():
    """K15, K16 and K17's wrappers raise for tensors neither on the CPU nor
    on a CUDA device, and count no launch."""
    from soundkit_tpu_torch.ops import phase_lock, stretch_ola
    from soundkit_tpu_torch.ops import resample as rs

    def counts():
        return (rs.polyphase_fir.launches, stretch_ola.overlap_add.launches,
                phase_lock.phase_lock.launches)

    before = counts()
    meta = torch.empty((2, 441 * 4), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        rs.resample(meta, 44100, 8000)
    with pytest.raises(ValueError, match="CUDA device"):
        rs.resample_stateful(meta, torch.empty((2, 255), device="meta"), 44100, 8000)
    with pytest.raises(ValueError, match="CUDA device"):
        stretch_ola.overlap_add(torch.empty((2, 3, 2048), device="meta"),
                                torch.empty(2048, device="meta"), 960, 100)
    spec = torch.empty((2, 3, 1025), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        phase_lock.phase_lock(spec, spec, spec)
    assert counts() == before
