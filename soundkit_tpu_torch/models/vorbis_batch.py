"""Batched multi-stream Ogg Vorbis decoder in PyTorch (counterpart of
``soundkit_tpu/models/vorbis_batch.py``).

N concurrent Ogg Vorbis streams: each lane's pages are split into
packets by the port's ``OggPacketizer``; its three headers parse into a
shared ``VorbisSetup`` (``cached_setup``); each audio packet is decoded
to its spectrum at push time, by the port's C++ parse
(``codecs/vorbis_native.py``, one handle a lane) for a floor1 stream and
by ``VorbisSetup.decode_packet_spectrum`` for a stream with a floor0,
which the C++ parse refuses by construction. ``decode_batches`` then
packs lockstep rounds on the host, one packet a lane a round (the
priming rule and the host mirror of the previous block's size as the
reference's), and synthesizes each round on the device with
``ops.vorbis_batch.synth_round``: the two IMDCT products, then K13 (the
window, overlap-add and lap, one launch a round). The lap is carried per
lane on the device, ``[B, C, n1/2]``.

All lanes share one ``(blocksize0, blocksize1, channels)`` topology, the
first lane's to parse its headers; a lane whose headers disagree raises
:class:`TopologyMismatch` at that push.

The reference scans eight rounds a device call and pads a short tail
with invalid rounds; here the rounds are a host loop, and since an
invalid round leaves every lane's state as it was, the loop stops at the
last real round. The PCM is fetched once, after the loop.
``from_device_chunked`` (the reference's chunked fetch over its tunnel)
is not ported.

A failed build or load of the C++ parse raises: nothing falls back to
the Python packet path. A decoder made with ``timed=True`` (CUDA only)
times each collect's host packing on the host clock and each round's
host-to-device copy and step with CUDA events; :meth:`stage_ms` reads
them.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from soundkit_tpu_torch.codecs.vorbis_core import Floor1, VorbisSetup, cached_setup
from soundkit_tpu_torch.codecs.vorbis_native import NativeVorbisParser
from soundkit_tpu_torch.demux.ogg import OggPacketizer
from soundkit_tpu_torch.ops import vorbis_batch as vb
from soundkit_tpu_torch.utils.device import resolve_device


class TopologyMismatch(ValueError):
    """A lane's stream headers disagree with the model topology.

    Raised from ``push`` at header-parse time; the lane is left
    unconfigured, so a later ``reset_lane`` starts it clean."""


class _Lane:
    def __init__(self) -> None:
        self.pkts = OggPacketizer()
        self.headers: List[bytes] = []
        self.setup: Optional[VorbisSetup] = None
        self.parser = None  # NativeVorbisParser, or the setup itself (floor0)
        self.queue: List = []  # decoded spectra
        self.primed = False


def _parser(setup: VorbisSetup):
    """The packet parse of a lane: the C++ parse for a floor1 stream, the
    setup's Python decode where a floor0 makes the C++ parse refuse."""
    if all(isinstance(fl, Floor1) for fl in setup.floors):
        return NativeVorbisParser(setup)
    return setup


class BatchedVorbisDecoder:
    def __init__(self, num_streams: int, *, device="cuda", timed: bool = False):
        self.device = resolve_device(device)
        if timed and self.device.type != "cuda":
            raise ValueError("timed=True needs a CUDA device (the step is timed by CUDA events)")
        self.B = num_streams
        self.timed = timed
        self._stage_times: List[tuple] = []  # per timed collect: (pack s, [(h2d, step) events])
        self._lanes = [_Lane() for _ in range(num_streams)]
        self._topology = None  # (n0, n1, channels)
        self._carry = None  # device [B, C, n1//2] lap carry
        self._cflag = None  # host [B] previous-block-size flags

    def push(self, stream_idx: int, data: bytes) -> None:
        lane = self._lanes[stream_idx]
        for packet, _g in lane.pkts.push(data):
            if lane.setup is None:
                lane.headers.append(packet)
                if len(lane.headers) == 3:
                    setup = cached_setup(bytes(lane.headers[0]), bytes(lane.headers[2]))
                    topo = (setup.blocksize0, setup.blocksize1, setup.channels)
                    if self._topology is None:
                        self._topology = topo
                    if topo != self._topology:
                        # leave the lane unconfigured so a later
                        # reset_lane/alloc starts clean
                        lane.headers = []
                        raise TopologyMismatch(
                            f"lane {stream_idx} topology {topo} != model "
                            f"topology {self._topology}"
                        )
                    lane.setup = setup
                    lane.parser = _parser(setup)
                continue
            spec = lane.parser.decode_packet_spectrum(packet)
            if spec is not None:
                lane.queue.append(spec)

    @property
    def ready_frames(self) -> int:
        return min(len(lane.queue) for lane in self._lanes)

    def _pack_round(self):
        """Pop one packet a lane into a round's host arrays: (spec [B, C,
        n1/2] f32, flags int32 [5, B] in ``FLAG_ROWS`` order, out_len [B]).
        Advances the lanes' priming and the host mirror of the carry flag,
        as the reference's host stage does."""
        n0, n1, C = self._topology
        B, h1 = self.B, n1 // 2
        spec = np.zeros((B, C, h1), dtype=np.float32)
        n_flag, pf, nf = (np.ones(B, dtype=np.int32) for _ in range(3))
        valid = np.zeros(B, dtype=bool)
        primed = np.zeros(B, dtype=bool)
        cflag = self._cflag.copy()
        for b, lane in enumerate(self._lanes):
            primed[b] = lane.primed
            if not lane.queue:
                continue
            sdec = lane.queue.pop(0)
            valid[b] = True
            half = sdec.n // 2
            spec[b, :, :half] = sdec.spectrum.astype(np.float32)
            n_flag[b] = 1 if sdec.n == n1 else 0
            pf[b] = sdec.prev_flag
            nf[b] = sdec.next_flag
            if not lane.primed:
                # prime: treat prev block as same-size (d = n/2)
                cflag[b] = n_flag[b]
                lane.primed = True
        # host mirror of the step's new_carry_flag
        self._cflag = np.where(valid, n_flag, cflag).astype(np.int32)
        prev_n = np.where(cflag == 1, n1, n0)
        cur_n = np.where(n_flag == 1, n1, n0)
        out_len = np.where(valid & primed, prev_n // 4 + cur_n // 4, 0).astype(np.int32)
        flags = np.stack([n_flag, pf, nf, valid.astype(np.int32), cflag])
        return spec, flags, out_len

    def decode_batches(self, n_batches: int, device_out: bool = False) -> List:
        """Decode ``n_batches`` lockstep packets.

        Default: per-lane host PCM arrays [C, samples] concatenated over
        the batches. Lanes with empty queues decode nothing that step
        (state frozen).

        ``device_out=True`` skips the fetch and returns ``(outs, lens)``:
        ``outs`` a list of ``n_batches`` device tensors [B, C, n1//2] and
        ``lens`` a host [n_batches, B] int array of valid lengths (lane
        b's samples of round r are ``outs[r][b, :, :lens[r, b]]``).

        The carry flag (previous block size per lane) is pure host
        bookkeeping (new flag = block flag where a packet arrived), so it
        lives on the host; only the f32 lap carry stays on the device."""
        if self._topology is None:
            if device_out:
                return [], np.zeros((0, self.B), dtype=np.int32)
            return [np.zeros((0, 0)) for _ in range(self.B)]
        n0, n1, C = self._topology
        dev = self.device
        if self._carry is None:
            carry, self._cflag = vb.init_state(self.B, C, n1)
            self._carry = torch.from_numpy(carry).to(dev)
        out = torch.empty((n_batches, self.B, C, n1 // 2), dtype=torch.float32, device=dev)
        len_np = np.zeros((n_batches, self.B), dtype=np.int32)
        t0 = time.perf_counter()
        events = []
        for r in range(n_batches):
            spec, flags, len_np[r] = self._pack_round()
            if self.timed:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
            d_spec = torch.from_numpy(spec).to(dev)
            d_flags = torch.from_numpy(flags).to(dev)
            if self.timed:
                ev[1].record()
            _, self._carry = vb.synth_round(d_spec, d_flags, self._carry, n0, n1, out=out[r])
            if self.timed:
                ev[2].record()
                events.append(ev)
        if self.timed and n_batches:
            self._stage_times.append((time.perf_counter() - t0, events))
        if device_out:
            return list(out), len_np
        outs = [[] for _ in range(self.B)]
        mx = int(len_np.max()) if n_batches else 0
        if mx:
            out_np = out[..., :mx].cpu().numpy()
            for r, b in zip(*np.nonzero(len_np)):
                outs[b].append(out_np[r, b, :, : len_np[r, b]])
        return [np.concatenate(o, axis=-1) if o else np.zeros((C, 0)) for o in outs]

    def decode_ready(self) -> List[np.ndarray]:
        return self.decode_batches(self.ready_frames)

    def stage_ms(self) -> dict:
        """Medians over the timed collects so far, in ms: ``pack`` (a
        collect's host loop: the round packing, and the host side of the
        copies and launches), ``h2d`` (CUDA events around a round's
        copies) and ``step`` (CUDA events around a round's IMDCT products
        and K13). Waits for the device."""
        if not self._stage_times:
            raise ValueError("no timed collect yet")
        torch.cuda.synchronize(self.device)
        packs, events = zip(*self._stage_times)
        h2d = [a.elapsed_time(b) for ev in events for a, b, _ in ev]
        step = [b.elapsed_time(c) for ev in events for _, b, c in ev]
        return {"collects": len(packs), "rounds": len(step),
                "pack": 1e3 * float(np.median(packs)), "h2d": float(np.median(h2d)),
                "step": float(np.median(step))}

    # -- fleet group interface (models/fleet.py) ---------------------------

    def lane_ready(self, b: int) -> int:
        return len(self._lanes[b].queue)

    def lane_configured(self, b: int) -> bool:
        """True once lane ``b``'s headers parsed and matched the model
        topology (past the point where TopologyMismatch can raise)."""
        return self._lanes[b].setup is not None

    def lane_sample_rate(self, b: int) -> Optional[int]:
        setup = self._lanes[b].setup
        return setup.sample_rate if setup else None

    def reset_lane(self, b: int) -> None:
        """Recycle lane ``b``: fresh Ogg/header state and zeroed device
        lap carry, so no audio bleeds from the previous occupant.  The
        new stream must share the group topology (blocksizes/channels);
        a mismatch raises at header parse."""
        self._lanes[b] = _Lane()
        if self._carry is not None:
            self._carry[b] = 0.0
            self._cflag[b] = 1
