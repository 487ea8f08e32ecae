"""StreamFleet, the multi-stream serving runtime (counterpart of
``soundkit_tpu/models/fleet.py``).

Each arriving byte stream is routed, after format detection or by its
explicit kind, into a fixed-capacity batched lane group for its codec:
AAC-LC, MP3, FLAC, Ogg Vorbis, Ogg Opus (CELT, SILK and hybrid lanes), or
one of the seven telephony kinds.
All groups decode in lockstep device batches, and the fleet returns
per-stream PCM. Lanes are
recycled when a stream ends, so a long-running fleet serves an unbounded
sequence of streams with bounded device state.

Ragged arrival is first-class: a group decodes ``max(lane_ready)``
batches per collect; lanes with no data decode as silence with frozen
state (the models' validity masks), and the fleet slices each stream's
true output by its per-lane produced count. The Vorbis group's output is
ragged host PCM (a packet's length depends on its neighbours' block
sizes), carried in ``FleetLaneOutput.host``.

A stream without a lane decodes beside the groups on a per-stream host
fallback, as in the JAX package: a ``pipeline.decode_pipeline.StreamDecoder``
on the fleet's ``device`` (its telephony and MP3 codecs launch K3, K6, K7
and K10 at B = 1 there), whose PCM ``collect`` returns with the lanes'.
These streams take it:

- a detected format without a batched group (WAV, AIFF / AIFF-C, M4A
  with an AAC or ALAC track, WebM with an Opus or Vorbis track, AC-3, Ogg
  Speex), and bytes that detection cannot name (which decode to nothing,
  as in the JAX package);
- the explicit kinds ``opus_raw`` (soundkit's raw Opus framing), ``gsm``
  (GSM 06.10, standard framing), ``amr_nb`` and ``g729`` (the owned AMR-NB
  and G.729 decoders, where the JAX package's fleet opens libavcodec);
- any stream whose group is full, detected or of an explicit kind;
- an Ogg Vorbis stream whose headers disagree with the topology of the
  group (``models/vorbis_batch.TopologyMismatch``), replayed from its
  bytes so far (the fleet keeps a Vorbis stream's bytes only until its
  headers parse);
- an ADTS stream of channel configuration 3-7 (5.1, 7.1 and the like),
  detected or of the explicit kind ``aac``: the AAC model raises
  ``TopologyMismatch`` at the push that completes its first frame, and
  the stream is replayed from its bytes so far into the owned host
  decoder (``codecs/aac.AacDecoder``, all its channels in libavcodec's
  order). The JAX fleet seats it in a stereo lane, which decodes its
  first element alone (the centre of a 5.1 stream, the second channel
  silent): a stated departure;
- an Ogg Opus stream that its group reroutes
  (``models/opus_fleet_model.OpusLaneUnsupported``: a packet that is not a
  single 20 ms frame, a mid-stream mode or SILK bandwidth switch, a hybrid
  lane frozen by its walk), seeded from the lane's bounded packet tail
  (``opus_fleet_model._OpusTailFallback``); and a multistream Ogg Opus
  stream (5.1, 7.1, ambisonics: mapping family 1, 2 or 255), rerouted at
  the push that brings its head, before any packet is decoded, to the
  owned multistream decoder (``codecs/opus_multistream``), where the JAX
  package's fleet opens libavcodec.

A host stream reports the rate of its decoder's last output (a telephony
overflow stream its codec's rate from the start). AIFF and M4A (AAC or
ALAC) decode at the stream's end (their decoders buffer the whole file),
an AIFF-C file's µ-law / A-law through K3 on the fleet's device. An M4A
AAC track and a WebM Opus track decode through the owned AAC-LC and Opus
decoders, where the JAX package's fleet opens libavcodec (a stated
departure).

Streams this fleet refuses: what the port cannot decode at all raises
:class:`FleetUnsupported` at the ``push`` or ``end_stream`` that routes
it, and the fleet forgets it:

- an Opus stream whose OpusHead neither package opens (family 0 beyond
  two channels, family 3 and up, a channel mapping table missing or out
  of range; the JAX package's libavcodec refuses it too): an Ogg Opus
  stream at the push that brings its head, a raw one (whose 19-byte head
  never holds a table, so any multistream head) at the push that
  completes it;
- any host stream whose decoder finds a format the port does not decode
  (``UnsupportedFormat``: an Ogg Speex header outside the owned modes, a
  WebM OpusHead neither package opens, an HE-AAC M4A AAC track or one of
  a program config element at the stream's end, an ADTS stream of
  channel configuration 0 or beyond 7).

An explicit kind that is none of these names raises a plain
``ValueError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from soundkit_tpu_torch.demux.detect import AudioType, detect_audio
from soundkit_tpu_torch.models.opus_fleet_model import OpusLaneUnsupported
from soundkit_tpu_torch.models.vorbis_batch import TopologyMismatch
from soundkit_tpu_torch.utils.device import resolve_device

MIN_DETECT = 8192

#: headerless telephony codecs served by batched groups via explicit-kind
#: ingest (``push(sid, data, kind=...)``)
TELEPHONY_KINDS = (
    "g711_mulaw", "g711_alaw", "g722",
    "g726_16", "g726_24", "g726_32", "g726_40",
)

#: headerless kinds served by per-stream host pipelines through the same
#: explicit-kind ingest
HOST_KINDS = ("gsm", "amr_nb", "g729", "opus_raw")

#: groups with a batched model in the port, beside the telephony kinds
BATCHED_KINDS = ("aac", "mp3", "flac", "vorbis", "opus")

_DETECTED = {
    AudioType.AAC: "aac",
    AudioType.MP3: "mp3",
    AudioType.FLAC: "flac",
    AudioType.OGG_VORBIS: "vorbis",
    AudioType.OGG_OPUS: "opus",
}


class FleetUnsupported(ValueError):
    """A stream the port cannot decode: one the JAX package's fleet
    decodes through libavcodec, or an OpusHead neither package opens."""


@dataclass
class _Lane:
    group: str
    index: int
    produced: int = 0  # batches decoded for this lane so far


def _host_decoder(device):
    """A self-detecting host decoder: container formats, undetected bytes."""
    from soundkit_tpu_torch.pipeline.decode_pipeline import StreamDecoder

    return StreamDecoder(device=device)


def _explicit_host_decoder(kind: str, device):
    """Per-stream host decoder for an explicit kind: ``gsm``, ``amr_nb``,
    ``g729``, ``opus_raw``, or a telephony/batched kind whose group is
    full (overflow streams keep decoding, just without batching), its
    kernels on ``device``."""
    from soundkit_tpu_torch.pipeline.decode_pipeline import DecodeOptions, StreamDecoder

    if kind == "gsm":
        from soundkit_tpu_torch.codecs.telephony import GsmVariant, make_gsm_adapter

        return StreamDecoder(DecodeOptions(), make_gsm_adapter(GsmVariant.STANDARD), device)
    if kind == "amr_nb":
        from soundkit_tpu_torch.codecs.telephony import make_amr_adapter

        return StreamDecoder(DecodeOptions(), make_amr_adapter(), device)
    if kind == "g729":
        from soundkit_tpu_torch.codecs.telephony import make_g729_adapter

        return StreamDecoder(DecodeOptions(), make_g729_adapter(), device)
    if kind == "opus_raw":
        from soundkit_tpu_torch.codecs.containers import make_opus_stream_adapter

        return StreamDecoder(DecodeOptions(), make_opus_stream_adapter(), device)
    if kind not in TELEPHONY_KINDS:
        return _host_decoder(device)  # container formats self-detect
    from soundkit_tpu_torch.codecs.g711 import G711Law
    from soundkit_tpu_torch.codecs.g726 import G726Packing, G726Rate
    from soundkit_tpu_torch.pipeline.decode_pipeline import G711Adapter, G722Adapter, G726Adapter

    if kind.startswith("g711"):
        law = G711Law.A_LAW if kind.endswith("alaw") else G711Law.MU_LAW
        return StreamDecoder(DecodeOptions(), G711Adapter(law, 8000, 1, device), device)
    if kind == "g722":
        return StreamDecoder(DecodeOptions(), G722Adapter(device), device)
    rate = {
        "g726_16": G726Rate.RATE_16000, "g726_24": G726Rate.RATE_24000,
        "g726_32": G726Rate.RATE_32000, "g726_40": G726Rate.RATE_40000,
    }[kind]
    return StreamDecoder(DecodeOptions(), G726Adapter(rate, G726Packing.LEFT, device), device)


def _slice_lane_host(kind, arr, lane, k, meta, out_bits):
    """Slice one lane's valid PCM out of a fetched group batch.

    ``arr`` is the host copy of the staged [n, B, ...] group output;
    returns [C, samples] (or None when an opus or telephony lane
    produced nothing). Shared by the fetching ``collect()`` and the
    device-resident ``FleetLaneOutput.fetch()`` so both modes are
    bit-identical."""
    if kind == "opus":
        parts = []
        for r in range(k):
            m = int(meta[r][lane])
            if m > 0:
                parts.append(arr[r, lane, :, arr.shape[-1] - m:])  # valid at the END
        return np.concatenate(parts, axis=1) if parts else None
    if kind == "flac":
        parts = []
        for f in range(k):
            mt = meta[f][lane]
            ch = max(int(mt[1]), 1)
            sl = arr[f, lane, :ch, : mt[0]]
            if out_bits == 16:
                parts.append(sl)  # already exact int16
            else:
                parts.append(sl.astype(np.float32) / 32768.0)
        return np.concatenate(parts, axis=1)
    if kind in TELEPHONY_KINDS:
        parts = []
        for r in range(k):
            m = int(meta[r][lane])
            if m > 0:
                sl = arr[r, lane, :, :m]  # i16-native, valid at START
                parts.append(sl if out_bits == 16
                             else sl.astype(np.float32) / 32768.0)
        return np.concatenate(parts, axis=1) if parts else None
    lanes = arr[:k, lane]  # [k, C, S]
    return np.transpose(lanes, (1, 0, 2)).reshape(lanes.shape[1], -1)


def _fetch(dev: torch.Tensor) -> np.ndarray:
    return dev.cpu().numpy()


@dataclass
class FleetLaneOutput:
    """One stream's newly produced PCM, left on the device.

    Returned by ``StreamFleet.collect(device_out=True)``, for a consumer
    that keeps its post-processing on the device and so never pays the
    fetch. ``device`` is the group's staged [n, B, ...] batch (shared by
    every lane of the group); ``samples`` counts this stream's valid
    samples per channel without any transfer. ``fetch()`` materialises
    the host PCM, bit-identical to plain ``collect()`` (one shared fetch
    per group). A Vorbis stream's ragged PCM is made on the host and
    carried in ``host``."""

    kind: str
    samples: int
    rate: Optional[int]
    device: object = None
    lane: int = -1
    frames: int = 0
    meta: object = None
    out_bits: int = 32
    host: Optional[np.ndarray] = None
    _cache: Optional[dict] = None

    def fetch(self) -> Optional[np.ndarray]:
        if self.host is not None:
            return self.host
        if self._cache is None:
            self._cache = {}
        if "arr" not in self._cache:
            self._cache["arr"] = _fetch(self.device)
        return _slice_lane_host(
            self.kind, self._cache["arr"], self.lane, self.frames,
            self.meta, self.out_bits,
        )


class _BatchedGroup:
    """Wraps one batched model with lane allocation/recycling."""

    def __init__(self, kind: str, capacity: int, channels: int, device, out_bits: int = 32):
        self.kind = kind
        self.capacity = capacity
        self.channels = channels
        self.device = device
        self.out_bits = out_bits
        self._free = list(range(capacity))
        self._used: set = set()  # lanes that have hosted a stream
        self._model = None  # built lazily

    def _ensure(self):
        if self._model is not None:
            return self._model
        if self.kind == "aac":
            from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder

            self._model = BatchedAacLcDecoder(self.capacity, self.channels, device=self.device)
        elif self.kind == "mp3":
            from soundkit_tpu_torch.models.mp3_batch_model import BatchedMp3Decoder

            self._model = BatchedMp3Decoder(self.capacity, self.channels, device=self.device)
        elif self.kind == "flac":
            from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder

            self._model = BatchedFlacDecoder(self.capacity, device=self.device)
        elif self.kind == "vorbis":
            from soundkit_tpu_torch.models.vorbis_batch import BatchedVorbisDecoder

            self._model = BatchedVorbisDecoder(self.capacity, device=self.device)
        elif self.kind == "opus":
            from soundkit_tpu_torch.models.opus_fleet_model import BatchedOggOpusDecoder

            # 16-bit output rides the int16 CELT wire; f32 output the exact f32 wire
            self._model = BatchedOggOpusDecoder(
                self.capacity, self.channels, device=self.device,
                celt_wire="i16" if self.out_bits == 16 else "f32")
        elif self.kind in TELEPHONY_KINDS:
            from soundkit_tpu_torch.models.telephony_batch import TelephonyLaneGroup

            self._model = TelephonyLaneGroup(self.kind, self.capacity, device=self.device)
        else:
            raise ValueError(self.kind)
        return self._model

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        lane = self._free.pop()
        # clear the previous occupant; fresh lanes skip it (a model
        # starts zeroed, and a per-lane reset is device work each)
        if self._model is not None and lane in self._used:
            self._model.reset_lane(lane)
        self._used.add(lane)
        return lane

    def release(self, lane: int) -> None:
        self._free.append(lane)

    def drop(self, lane: int) -> None:
        """Reset the lane now and free it (a refused stream's lane)."""
        self._model.reset_lane(lane)
        self._used.discard(lane)
        self.release(lane)

    def push(self, lane: int, data: bytes) -> None:
        self._ensure().push(lane, data)

    def lane_ready(self, lane: int) -> int:
        return self._ensure().lane_ready(lane)

    def lane_configured(self, lane: int) -> bool:
        """True once the lane can no longer reject the stream (the Vorbis
        model's per-group topology, the AAC model's channel
        configuration)."""
        m = self._ensure()
        fn = getattr(m, "lane_configured", None)
        return True if fn is None else fn(lane)

    def lane_sample_rate(self, lane: int) -> Optional[int]:
        if self._model is None:
            return None
        return self._model.lane_sample_rate(lane)

    def decode(self, n: int):
        if self.kind == "vorbis":
            return self._ensure().decode_batches(n)  # ragged host lists
        return self._ensure().decode_batches(n, device_out=True)


def _quantize_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 PCM in [-1, 1] to int16 by the *32767 out-scale, rounding
    half to even, then clipping."""
    return torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(torch.int16)


def _quantize_i32(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """int32 FLAC samples [n, B, C, S] to int16 with an arithmetic
    downshift per (frame, lane): exact for 16-bit streams (shift 0),
    ``>> 8`` for 24-bit lanes; then clipping."""
    return torch.clamp(x >> shift[:, :, None, None], -32768, 32767).to(torch.int16)


class StreamFleet:
    """Route detected streams into batched codec groups.

    - ``push(stream_id, data)``: buffer until detection (8 KiB or
      ``end_stream``), then feed the stream's lane.
    - ``end_stream(stream_id)``: EOF; triggers detection for small
      streams, flushes host streams, and recycles the lane at the next
      ``collect`` that finds it drained.
    - ``collect()``: decode all groups in lockstep batches and return
      ``{stream_id: PCM [C, samples]}`` newly produced since the last
      collect.

    The groups and the host streams' decoders run on ``device`` ('cuda',
    the default, or 'cpu'). The module's docstring lists the streams that
    decode on the host and those that raise :class:`FleetUnsupported`.
    """

    def __init__(self, capacity_per_group: int = 16, channels: int = 2,
                 out_bits: int = 32, *, device="cuda"):
        """``out_bits=16`` quantizes PCM to int16 on the device before
        the fetch (half the bytes): f32 groups by the *32767 out-scale,
        FLAC by a per-lane downshift to 16 bits (16-bit lanes are
        bit-exact). ``out_bits=32`` returns f32 planes (the default).
        Telephony groups are int16 on the device in both modes. The Opus
        group rides the int16 spectral wire (per-band scales) under
        ``out_bits=16`` and the exact float32 wire otherwise."""
        if out_bits not in (16, 32):
            raise ValueError("out_bits must be 16 or 32")
        self.device = resolve_device(device)
        self.out_bits = out_bits
        self.channels = channels
        self._cap = capacity_per_group
        # telephony groups are added at their first stream
        self._groups: Dict[str, _BatchedGroup] = {
            k: _BatchedGroup(k, capacity_per_group, channels, self.device, out_bits)
            for k in BATCHED_KINDS
        }
        self._lanes: Dict[str, _Lane] = {}
        self._detect: Dict[str, bytearray] = {}
        # raw bytes of lane streams whose group can still reject them
        # (Vorbis topology, confirmed only at header parse), kept so a
        # rejected stream can be replayed into a host fallback
        self._pretopo: Dict[str, bytearray] = {}
        self._fallback: Dict[str, object] = {}
        self._ended: Dict[str, bool] = {}
        self._pending_out: Dict[str, List[np.ndarray]] = {}
        self._rates: Dict[str, int] = {}  # last known rate per stream
        self._retired: List[str] = []  # recycled last collect; rates
        # kept one extra collect-cycle so callers can still query the
        # rate of PCM they just received, then purged (bounded state)

    # -- ingest -----------------------------------------------------------

    def push(self, stream_id: str, data: bytes,
             kind: Optional[str] = None) -> None:
        """Feed stream bytes.  ``kind`` is the explicit-kind ingest for
        headerless formats autodetect cannot route: one of
        :data:`TELEPHONY_KINDS` (G.726 kinds assume left-justified
        packing), or a batched group name ("aac", "mp3", "flac", "vorbis",
        "opus") to skip detection, or ``opus_raw`` (soundkit's raw Opus
        framing, a host stream). Only the first push of a stream may carry
        ``kind``."""
        self._ended.setdefault(stream_id, False)
        if stream_id in self._lanes:
            self._push_lane(stream_id, data)
            return
        if stream_id in self._fallback:
            self._feed_fallback(stream_id, data)
            return
        if kind is not None:
            buf = bytes(self._detect.pop(stream_id, b"")) + data
            self._route_explicit(stream_id, kind, buf)
            return
        buf = self._detect.setdefault(stream_id, bytearray())
        buf.extend(data)
        if len(buf) >= MIN_DETECT:
            self._route(stream_id)

    def end_stream(self, stream_id: str) -> None:
        if stream_id in self._detect:
            self._route(stream_id)
        self._ended[stream_id] = True
        if stream_id in self._fallback:
            self._feed_fallback(stream_id, b"")

    def _refuse(self, stream_id: str, what: str, reason: str):
        """Forget the stream and raise :class:`FleetUnsupported`."""
        for book in (self._detect, self._ended, self._pretopo, self._fallback,
                     self._pending_out, self._rates):
            book.pop(stream_id, None)
        raise FleetUnsupported(f"stream {stream_id!r}: {what}: {reason}; the port cannot decode it")

    def _seat(self, stream_id: str, kind: str, buf: bytes) -> bool:
        """Give the stream a lane of its group and feed it ``buf``; False
        when the group is full."""
        group = self._groups.get(kind)
        if group is None:
            group = _BatchedGroup(kind, self._cap, self.channels, self.device, self.out_bits)
            self._groups[kind] = group
        lane_idx = group.alloc()
        if lane_idx is None:
            return False
        self._lanes[stream_id] = _Lane(kind, lane_idx)
        if kind in ("vorbis", "aac"):
            # raw bytes retained only while the group can still reject
            # the stream (until its headers parse, or an AAC stream's
            # first ADTS header); opus lanes reroute from their own
            # bounded packet tail, so the fleet retains nothing for them
            self._pretopo[stream_id] = bytearray()
        if buf:
            self._push_lane(stream_id, buf)
        return True

    def _push_lane(self, stream_id: str, data: bytes) -> None:
        """Feed a seated stream; if its group rejects it (a Vorbis topology
        mismatch, an ADTS stream beyond stereo, an Opus reroute), reset and
        free the lane and move the stream to a host fallback."""
        ln = self._lanes[stream_id]
        group = self._groups[ln.group]
        pre = self._pretopo.get(stream_id)
        if pre is not None:
            pre.extend(data)
        try:
            group.push(ln.index, data)
        except (TopologyMismatch, OpusLaneUnsupported) as e:
            group.drop(ln.index)
            del self._lanes[stream_id]
            replay = getattr(e, "replay", None)
            if replay is not None:
                # opus reroute: seed a single-stream decoder from the
                # lane's bounded packet tail and drain the current push's
                # unprocessed packets now
                from soundkit_tpu_torch.models.opus_fleet_model import _OpusTailFallback
                from soundkit_tpu_torch.pipeline.output_options import UnsupportedFormat

                try:
                    fallback = _OpusTailFallback(**replay)
                except UnsupportedFormat as refused:
                    # an OpusHead neither package opens
                    self._refuse(stream_id, f"kind {ln.group!r}", str(refused))
                self._pretopo.pop(stream_id, None)
                self._fallback[stream_id] = fallback
                self._feed_fallback(stream_id, b"")
            else:
                raw = bytes(self._pretopo.pop(stream_id, data))
                self._fallback[stream_id] = _host_decoder(self.device)
                self._feed_fallback(stream_id, raw)
            if self._ended.get(stream_id):
                self._feed_fallback(stream_id, b"")
            return
        if pre is not None and group.lane_configured(ln.index):
            del self._pretopo[stream_id]

    def _route(self, stream_id: str) -> None:
        buf = bytes(self._detect.pop(stream_id, b""))
        kind = _DETECTED.get(detect_audio(buf))
        if kind is not None and self._seat(stream_id, kind, buf):
            return
        # no group for the format, or its group is full: a host stream
        self._fallback[stream_id] = _host_decoder(self.device)
        self._feed_fallback(stream_id, buf)

    def _route_explicit(self, stream_id: str, kind: str,
                        buf: bytes) -> None:
        """Route a stream into a named group, bypassing detection.
        Telephony groups build lazily (most fleets serve none); a full
        group overflows to the matching per-stream host decoder."""
        if kind not in HOST_KINDS and kind not in TELEPHONY_KINDS and kind not in BATCHED_KINDS:
            self._ended.pop(stream_id, None)
            raise ValueError(f"unknown explicit kind {kind!r}")
        if kind not in HOST_KINDS and self._seat(stream_id, kind, buf):
            return
        self._fallback[stream_id] = _explicit_host_decoder(kind, self.device)
        if kind in TELEPHONY_KINDS:
            self._rates[stream_id] = 16000 if kind == "g722" else 8000
        self._feed_fallback(stream_id, buf)

    def _feed_fallback(self, stream_id: str, data: bytes) -> None:
        """Feed a host stream and keep its PCM for the next ``collect``;
        a format the port does not decode refuses the stream."""
        from soundkit_tpu_torch.core.audio_pipeline import audio_to_f32_channels
        from soundkit_tpu_torch.core.audio_types import AudioData
        from soundkit_tpu_torch.pipeline.output_options import UnsupportedFormat

        outs = self._fallback[stream_id].process(data)
        for o in outs:
            if isinstance(o, UnsupportedFormat):
                self._refuse(stream_id, "host stream", str(o))
        audio = [o for o in outs if isinstance(o, AudioData)]
        if audio:
            self._rates[stream_id] = audio[-1].sampling_rate
            self._pending_out.setdefault(stream_id, []).extend(
                np.stack(audio_to_f32_channels(o)) for o in audio)

    def sample_rate(self, stream_id: str) -> Optional[int]:
        """Per-stream sample rate: a lane stream reports its own lane's
        rate (mixed-rate groups surface each lane's true rate), a host
        stream its decoder's last output rate. None until the stream's
        first header has parsed; a stream recycled by the last collect
        keeps its rate until the next one."""
        ln = self._lanes.get(stream_id)
        if ln is not None:
            return self._groups[ln.group].lane_sample_rate(ln.index)
        return self._rates.get(stream_id)

    # -- decode -----------------------------------------------------------

    def _host_out(self, pcm: np.ndarray) -> np.ndarray:
        """Match the device-side int16 quantization for host-produced
        planes (the Vorbis group's ragged output, host streams)."""
        if self.out_bits == 16:
            return np.clip(np.round(pcm * 32767.0), -32768, 32767).astype(np.int16)
        return pcm

    def collect(self, device_out: bool = False):
        """Decode every group and return newly produced PCM per stream.

        Two-phase: every group's device work is issued first, then the
        outputs are fetched, so no group's compute waits behind another
        group's transfer.  With ``out_bits=16`` the quantization to
        int16 happens on the device before the fetch.

        ``device_out=True`` skips the fetch and returns
        ``{stream_id: FleetLaneOutput}`` with each lane group's PCM left
        on the device; otherwise returns
        ``{stream_id: np.ndarray [C, samples]}``."""
        out: Dict[str, object] = {}
        for sid in self._retired:
            self._rates.pop(sid, None)
        self._retired = []

        staged = []  # (kind, active, ready_before, n, dev, metas)
        for kind, group in self._groups.items():
            active = {
                sid: ln for sid, ln in self._lanes.items() if ln.group == kind
            }
            if not active:
                continue
            n = max(group.lane_ready(ln.index) for ln in active.values())
            if n == 0:
                continue
            ready_before = {
                sid: group.lane_ready(ln.index) for sid, ln in active.items()
            }
            if kind == "vorbis":
                # ragged per-lane PCM on the host (a packet's output length
                # varies with the neighbouring block sizes)
                per_lane = group.decode(n)
                for sid, ln in active.items():
                    pcm = per_lane[ln.index]
                    if pcm.shape[-1]:
                        hostpcm = self._host_out(pcm.astype(np.float32))
                        if device_out:
                            out[sid] = FleetLaneOutput(
                                kind="vorbis", samples=hostpcm.shape[-1],
                                rate=self.sample_rate(sid), host=hostpcm,
                            )
                        else:
                            out[sid] = hostpcm
                        ln.produced += 1
                continue
            if kind in TELEPHONY_KINDS:
                # i16-native scans: the staged batch is int16 in both
                # output modes (f32 conversion, when asked for, happens
                # host-side after the fetch)
                pcm, lengths = group.decode(n)
                if pcm.shape[0] == 0:
                    continue
                staged.append((kind, active, ready_before, n, pcm, lengths))
            elif kind == "opus":
                # [n, B, C, 960] f32, valid samples at the END of a slot
                pcm, lengths = group.decode(n)
                if pcm.shape[0] == 0:
                    continue
                if self.out_bits == 16:
                    pcm = _quantize_f32(pcm)
                staged.append((kind, active, ready_before, n, pcm, lengths))
            elif kind == "flac":
                samples, metas = group.decode(n)
                if self.out_bits == 16:
                    # per-(frame, lane) downshift: lanes over 16 bits
                    # scale (arithmetic >> 8 for 24 bits), not clip;
                    # issued here, in phase 1
                    shf = np.stack([np.maximum(metas[f][:, 3] - 16, 0) for f in range(n)])
                    samples = _quantize_i32(
                        samples, torch.from_numpy(shf.astype(np.int32)).to(samples.device))
                staged.append((kind, active, ready_before, n, samples, metas))
            else:
                pcm = group.decode(n)  # [n, B, C, S] f32 (AAC, MP3)
                if pcm.shape[0] == 0:
                    continue
                if self.out_bits == 16:
                    pcm = _quantize_f32(pcm)
                staged.append((kind, active, ready_before, n, pcm, None))

        for kind, active, ready_before, n, dev, metas in staged:
            if device_out:
                cache: dict = {}
                for sid, ln in active.items():
                    k = min(ready_before[sid], n)
                    if k == 0:
                        continue
                    if kind == "opus" or kind in TELEPHONY_KINDS:
                        cnt = sum(int(metas[r][ln.index]) for r in range(k))
                    elif kind == "flac":
                        cnt = sum(
                            int(metas[f][ln.index][0]) for f in range(k)
                        )
                    else:
                        cnt = k * int(dev.shape[-1])
                    rec = FleetLaneOutput(
                        kind=kind, samples=cnt, rate=self.sample_rate(sid),
                        device=dev, lane=ln.index, frames=k, meta=metas,
                        out_bits=self.out_bits, _cache=cache,
                    )
                    # match plain collect()'s key set: opus and telephony
                    # lanes that produced nothing are skipped there (slice
                    # returns None), every other kind emits (flac can
                    # emit a zero-length array)
                    if cnt > 0 or (kind != "opus" and kind not in TELEPHONY_KINDS):
                        out[sid] = rec
                    ln.produced += k
                continue
            arr = _fetch(dev)
            for sid, ln in active.items():
                k = min(ready_before[sid], n)
                if k == 0:
                    continue
                pcm = _slice_lane_host(
                    kind, arr, ln.index, k, metas, self.out_bits
                )
                if pcm is not None:
                    out[sid] = pcm
                ln.produced += k

        # host streams: whatever their decoders produced
        for sid, parts in list(self._pending_out.items()):
            if parts:
                maxc = max(p.shape[0] for p in parts)
                padded = [np.pad(p, ((0, maxc - p.shape[0]), (0, 0))) for p in parts]
                pcm = self._host_out(np.concatenate(padded, axis=1))
                if device_out:
                    out[sid] = FleetLaneOutput(kind="host", samples=pcm.shape[-1],
                                               rate=self._rates.get(sid), host=pcm)
                else:
                    out[sid] = pcm
                self._pending_out[sid] = []

        # recycle lanes of ended, fully drained streams, and drop all
        # bookkeeping so a long-running fleet has bounded state
        for sid in [s for s, e in self._ended.items() if e]:
            ln = self._lanes.get(sid)
            if ln is not None:
                if self._groups[ln.group].lane_ready(ln.index) == 0:
                    rate = self._groups[ln.group].lane_sample_rate(ln.index)
                    if rate is not None:
                        self._rates[sid] = rate
                    self._retired.append(sid)
                    self._groups[ln.group].release(ln.index)
                    del self._lanes[sid]
                    del self._ended[sid]
                    self._pretopo.pop(sid, None)
            elif sid in self._fallback:
                if not self._pending_out.get(sid):
                    del self._fallback[sid]
                    self._pending_out.pop(sid, None)
                    self._retired.append(sid)
                    del self._ended[sid]
            elif sid not in self._detect:
                del self._ended[sid]
        return out
