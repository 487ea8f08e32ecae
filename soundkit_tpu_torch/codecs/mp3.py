"""MP3 streaming decoder (counterpart of ``soundkit_tpu/codecs/mp3.py``).

``Mp3Decoder`` takes bytes in chunks of any size and returns
interleaved float32 PCM (``decode_f32``) or int16 (``decode_i16``); the
sample rate and channel count are those of the last decoded granule.
The C++ parser (``NativeMp3Parser``: frame sync, bit reservoir,
scalefactors, Huffman, short-block reorder) queues compact granules;
each chunk pops its granules into rows of K10's packed wire
(``mp3_native.pop_wire_rounds`` at B = 1, the batched decoder's packer),
copies them to the decoder's device at once, launches K10
(``ops.mp3_synth.mp3_granule_packed``) once a granule, chained on the
stream with the overlap ``[1, 2, 32, 18]`` and the FIFO ``[1, 2, 1024]``
carried on the device, and copies the chunk's PCM back once. A mono
granule is a lane with its second channel invalid, which keeps that
channel's state.

The JAX package hands three shapes to libavcodec: MPEG Layer I and II
streams (found by ``_sniff_layer`` before any output), ``backend="av"``
and the ``SKT_MP3_AV`` environment variable. The port builds no FFmpeg.
Where ``_sniff_layer`` finds Layer I or II, the decoder commits to the
owned host decoder ``codecs.mpa_layer12.MpaLayer12Decoder`` and replays
the sniffed bytes through it, where the JAX package replays them into
libavcodec; it emits each frame once its last byte is in, as
libavcodec's parser does. ``backend="av"`` raises ``UnsupportedFormat``,
and ``SKT_MP3_AV`` is not read.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np
import torch

from soundkit_tpu_torch.codecs.avdec import f32_to_i16
from soundkit_tpu_torch.codecs.mp3_native import NativeMp3Parser, pop_wire_rounds
from soundkit_tpu_torch.codecs.mpa_layer12 import MpaLayer12Decoder
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.ops import mp3_batch as mb
from soundkit_tpu_torch.ops.mp3_synth import mp3_wire_layout
from soundkit_tpu_torch.pipeline.output_options import UnsupportedFormat
from soundkit_tpu_torch.utils.device import resolve_device

# how many bytes to scan for a non-Layer-III sync before committing to
# the owned parser (ID3v2 tags can front-load ~100 KB of junk)
_SNIFF_LIMIT = 256 * 1024


def _sniff_layer(buf: bytes) -> Optional[int]:
    """First plausible MPEG audio header's layer (1/2/3), else None."""
    for i in range(len(buf) - 3):
        if buf[i] != 0xFF or (buf[i + 1] & 0xE0) != 0xE0:
            continue
        version = (buf[i + 1] >> 3) & 3
        layer_bits = (buf[i + 1] >> 1) & 3
        bitrate_idx = (buf[i + 2] >> 4) & 0xF
        sr_idx = (buf[i + 2] >> 2) & 3
        if version == 1 or layer_bits == 0:
            continue
        if bitrate_idx in (0, 15) or sr_idx == 3:
            continue
        return {1: 3, 2: 2, 3: 1}[layer_bits]  # bits -> layer number
    return None


class Mp3Decoder:
    def __init__(self, backend: str = "owned", device="cuda") -> None:
        if backend != "owned":
            raise UnsupportedFormat(
                f"MP3 backend {backend!r}: only the owned Layer III decoder is ported "
                "(no libavcodec)")
        self.device = resolve_device(device)
        self._parser = NativeMp3Parser()
        self._handles = (ctypes.c_void_p * 1)(self._parser._h)
        self._valid_off = {name: off for name, off, _, _ in mp3_wire_layout(1)[0]}["valid"]
        self._rate = 0
        self._channels = 0
        self._state = None  # (overlap [1,2,32,18], fifo [1,2,1024]) on the device
        self._sniff = b""  # bytes sniffed until granules flow
        self._mpa: Optional[MpaLayer12Decoder] = None  # a Layer I / II stream

    @property
    def sample_rate(self) -> Optional[int]:
        if self._mpa is not None:
            return self._mpa.rate or None
        return self._rate or None

    @property
    def channels(self) -> Optional[int]:
        if self._mpa is not None:
            return self._mpa.channels or None
        return self._channels or None

    def _synth(self, n: int) -> np.ndarray:
        """Pop ``n`` queued granules and decode them on the device ->
        interleaved f32 samples."""
        wire, rate, popped = pop_wire_rounds(self._parser._lib, self._handles, 1, n)
        n = int(popped[0])
        if n == 0:
            return np.zeros(0, np.float32)
        if self._state is None:
            self._state = mb.init_state(1, 2, self.device)
        d_wire = torch.from_numpy(wire[:n]).to(self.device)
        pcm = torch.empty((n, 1, 2, 576), dtype=torch.float32, device=self.device)
        ov, ff = self._state
        for g in range(n):
            _, ov, ff = mb.mp3_granule_device_compact_packed(d_wire[g], ov, ff, pcm_out=pcm[g])
        self._state = (ov, ff)
        out = pcm[:, 0].cpu().numpy()  # [n, 2, 576]: the chunk's one copy back
        nch = wire[:n, self._valid_off + 1].astype(np.int32) + 1
        self._rate = int(rate[0])
        self._channels = int(nch[-1])
        return np.concatenate([out[g].T.reshape(-1) if nch[g] == 2 else out[g, 0]
                               for g in range(n)])

    def decode_f32(self, data: bytes) -> np.ndarray:
        """Interleaved f32."""
        if self._mpa is not None:
            return self._mpa.push(data)
        # layer sniff: the Layer III parser takes Layer III only; a Layer
        # I/II stream goes, with its sniffed bytes replayed, to the owned
        # Layer I / II decoder before any output
        if self._sniff is not None:
            self._sniff += bytes(data)
            layer = _sniff_layer(self._sniff)
            if layer is not None and layer != 3:
                replay, self._sniff, self._parser = self._sniff, None, None
                self._mpa = MpaLayer12Decoder()
                return self._mpa.push(replay)
        queued = self._parser.push(data)
        if queued == 0:
            return np.zeros(0, np.float32)
        self._sniff = None  # committed: granules are flowing
        return self._synth(queued).astype(np.float32)

    def decode_i16(self, data: bytes) -> np.ndarray:
        return f32_to_i16(self.decode_f32(data))

    def flush_f32(self) -> np.ndarray:
        if self._mpa is not None:
            return self._mpa.flush()
        # the parser emits every completed granule eagerly; a trailing
        # partial frame has nothing decodable left
        return np.zeros(0, np.float32)


class Mp3Adapter:
    """StreamingDecoder for the pipeline (emits i16 AudioData)."""

    def __init__(self, device="cuda") -> None:
        self._dec = Mp3Decoder(device=device)

    def _emit(self, pcm16: np.ndarray) -> List[AudioData]:
        if len(pcm16) == 0 or not self._dec.sample_rate:
            return []
        return [
            AudioData(
                bits_per_sample=16,
                channel_count=self._dec.channels,
                sampling_rate=self._dec.sample_rate,
                data=pcm16.astype("<i2").tobytes(),
                audio_format=EncodingFlag.PCM_SIGNED,
                endianness=Endianness.LITTLE,
            )
        ]

    def process(self, chunk: bytes) -> List[AudioData]:
        return self._emit(self._dec.decode_i16(chunk))

    def flush(self) -> List[AudioData]:
        return self._emit(f32_to_i16(self._dec.flush_f32()))
