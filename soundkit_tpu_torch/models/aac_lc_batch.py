"""Flagship model: batched multi-stream AAC-LC decoder in PyTorch
(counterpart of ``soundkit_tpu/models/aac_lc_batch.py``).

N concurrent ADTS streams are framed on the host, syntax-parsed by
the C++ parser into one packed v4 wire per lockstep batch, and decoded
on the device by :func:`ops.aac_batch.decode_frame_v4_packed`, with the
per-stream overlap-add state held in tensors that this object owns.
A batch whose lanes span sample rates, or whose content the v4 wire
cannot carry (pulses, more than 16 PNS bands or 128 band runs, AUs
over 1024 bytes), goes through the full wire instead and is counted
in ``full_wire_batches``.

A lane serves channel configurations 1 and 2. The push that completes
a lane's first ADTS frame (its header read in Python by
``aac_lc.AdtsStream``) raises :class:`TopologyMismatch` when the
stream's configuration is another, and queues nothing; the lane stays
unconfigured (``lane_configured``) until then, so that ``StreamFleet``
keeps the stream's bytes and moves it to a host decoder. The JAX model
seats such a stream and decodes its first element alone (the centre of
a 5.1 stream): a stated departure.

A decoder made with ``timed=True`` (CUDA only) times the stages of
each v4 batch: the host parse and the host-to-device copy on the host
clock, the device step with CUDA events; :meth:`stage_ms` reads them.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from soundkit_tpu_torch.codecs.aac_lc import SAMPLE_RATES, AdtsStream
from soundkit_tpu_torch.codecs.aac_lc_native import prepare_frame_batch_grouped
from soundkit_tpu_torch.models.vorbis_batch import TopologyMismatch
from soundkit_tpu_torch.native import AacHostParser, parser_library
from soundkit_tpu_torch.ops import aac_batch as ab
from soundkit_tpu_torch.utils.device import resolve_device


def state_from_jax(saved, prev_shape, device):
    """The JAX model's carried state (numpy ``saved`` [B, C, 1024] f32,
    ``prev_shape`` [B, C] i32) as the port's tensors on ``device``."""
    dev = resolve_device(device)
    return (
        torch.from_numpy(np.array(saved, dtype=np.float32)).to(dev),
        torch.from_numpy(np.array(prev_shape, dtype=np.int32)).to(dev),
    )


class BatchedAacLcDecoder:
    """Decode ``num_streams`` parallel ADTS streams in lockstep batches
    on ``device`` ('cuda', the default, or 'cpu')."""

    def __init__(self, num_streams: int, channels: int = 2, *, device="cuda", timed: bool = False):
        self.device = resolve_device(device)
        if timed and self.device.type != "cuda":
            raise ValueError("timed=True needs a CUDA device (the step is timed by CUDA events)")
        self.timed = timed
        # per timed v4 batch: (parse s, h2d s, step start event, step stop event)
        self._stage_times: List[tuple] = []
        self.B = num_streams
        self.C = channels
        self._streams = [AdtsStream() for _ in range(num_streams)]
        self._queues: List[List[bytes]] = [[] for _ in range(num_streams)]
        self._saved, self._prev_shape = ab.init_state(num_streams, channels, self.device)
        parser_library()  # a parser that cannot be built fails here
        self._parsers = {}  # sr_index -> AacHostParser
        self.v4_batches = 0
        self.full_wire_batches = 0

    def push(self, stream_idx: int, data: bytes) -> None:
        st = self._streams[stream_idx]
        aus = st.push(data)
        if st.channel_config not in (None, 1, 2):
            raise TopologyMismatch(f"lane {stream_idx}: ADTS channel configuration "
                                   f"{st.channel_config}; a lane serves 1 and 2")
        self._queues[stream_idx].extend(aus)

    def lane_configured(self, b: int) -> bool:
        """True once lane ``b``'s first ADTS header has parsed with a
        configuration the lane serves (past the point where
        TopologyMismatch can raise)."""
        return self._streams[b].channel_config in (1, 2)

    @property
    def ready_frames(self) -> int:
        """Batches decodable right now (the shortest queue)."""
        return min(len(q) for q in self._queues)

    def lane_ready(self, b: int) -> int:
        return len(self._queues[b])

    def lane_sample_rate(self, b: int) -> Optional[int]:
        sr = self._streams[b].sr_index
        return SAMPLE_RATES[sr] if sr is not None else None

    @property
    def state(self):
        """(saved [B, C, 1024] f32, prev_shape [B, C] i32) on the device."""
        return self._saved, self._prev_shape

    def set_state(self, saved: torch.Tensor, prev_shape: torch.Tensor) -> None:
        """Continue from another decoder's carried state (see
        :func:`state_from_jax`)."""
        if tuple(saved.shape) != (self.B, self.C, 1024) or tuple(prev_shape.shape) != (self.B, self.C):
            raise ValueError(f"state shapes {tuple(saved.shape)}, {tuple(prev_shape.shape)}")
        self._saved = saved.to(self.device, torch.float32)
        self._prev_shape = prev_shape.to(self.device, torch.int32)

    def reset_lane(self, b: int) -> None:
        """Recycle lane ``b`` for a new stream: fresh framer and queue,
        zeroed carry (updates the state tensors in place)."""
        self._streams[b] = AdtsStream()
        self._queues[b] = []
        self._saved[b] = 0.0
        self._prev_shape[b] = 0

    def decode_ready(self, max_frames: Optional[int] = None, device_out: bool = False):
        n = self.ready_frames if max_frames is None else min(self.ready_frames, max_frames)
        return self.decode_batches(n, device_out=device_out)

    def decode_batches(self, n: int, device_out: bool = False):
        """Decode exactly ``n`` lockstep batches -> [n, B, C, 1024] f32
        (a tensor on the device if ``device_out``, else numpy). Lanes
        with empty queues decode silence with their state frozen."""
        outs = []
        for _ in range(n):
            aus = [q.pop(0) if q else None for q in self._queues]
            outs.append(self._decode_batch(aus))
        if not outs:
            out = torch.zeros((0, self.B, self.C, 1024), device=self.device)
        else:
            out = torch.stack(outs)
        return out if device_out else out.cpu().numpy()

    def stage_ms(self) -> dict:
        """Medians over the timed v4 batches so far, in ms: ``parse``
        (host C++ parse and wire pack), ``h2d`` (host clock of the
        pageable copy) and ``step`` (CUDA events around the device
        step). Waits for the device."""
        if not self._stage_times:
            raise ValueError("no timed v4 batch yet")
        torch.cuda.synchronize(self.device)
        cols = list(zip(*self._stage_times))
        return {
            "batches": len(self._stage_times),
            "parse": 1e3 * float(np.median(cols[0])),
            "h2d": 1e3 * float(np.median(cols[1])),
            "step": float(np.median([a.elapsed_time(b) for a, b in zip(cols[2], cols[3])])),
        }

    def _decode_batch(self, aus: List[Optional[bytes]]) -> torch.Tensor:
        lane_sr = [s.sr_index for s in self._streams]
        srs = {lane_sr[i] for i, au in enumerate(aus) if au is not None}
        for sr in srs - self._parsers.keys():
            self._parsers[sr] = AacHostParser(sr)
        if len(srs) == 1:
            t0 = time.perf_counter()
            buf, overflow = self._parsers[next(iter(srs))].pack_v4(aus)
            if not overflow:
                self.v4_batches += 1
                t1 = time.perf_counter()
                wire = torch.from_numpy(buf).to(self.device)
                t2 = time.perf_counter()
                if self.timed:
                    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                pcm, self._saved, self._prev_shape = ab.decode_frame_v4_packed(
                    wire, self._prev_shape, self._saved)
                if self.timed:
                    stop.record()
                    self._stage_times.append((t1 - t0, t2 - t1, start, stop))
                return pcm
        self.full_wire_batches += 1
        fb = prepare_frame_batch_grouped(self._parsers, lane_sr, aus)
        C = self.C

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        pcm, self._saved, self._prev_shape = ab.decode_frame(
            t(fb.quant[:, :C]), t(fb.scale[:, :C]), t(fb.ms_mask), t(fb.int_factor),
            t(fb.perm[:, :C]), t(fb.filt_id[:, :C]), t(fb.lpc[:, :C]), t(fb.seq[:, :C]),
            t(fb.shape[:, :C]), self._prev_shape, t(fb.chan_valid[:, :C]), self._saved,
        )
        return pcm
