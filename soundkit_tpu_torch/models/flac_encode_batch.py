"""Batched FLAC stream encoder in PyTorch (counterpart of
``soundkit_tpu/models/flac_encode_batch.py``): block analysis on the
device, entropy pack on the host.

B lanes of PCM are buffered per lane; every full block of every lane
folds into the rows of ONE call of K14 (``ops.flac_analyze``: stereo
mode search, fixed / LPC-8 selection), whose [rows, 23] int32 plan rows
come back in one copy; the port's native packer
(``native_src/src/flac_pack.cpp``) recomputes each residual exactly from
its plan, searches the Rice partitions and writes the frames in one call.
Each lane yields an independent, standard .flac stream (STREAMINFO with
the MD5 of its PCM).

The wire ships once a call, int16 for <= 16-bit streams (else int32),
with ``.to(device)``; the residual plane never exists. A failed build of
the packer raises. ``_write_from_plan`` stays, as the per-frame oracle
the packer is held to (it needs the residuals of
``ops.flac_enc_batch.flac_analyze_plain``).

An encoder made with ``timed=True`` (CUDA only) keeps the seconds of
each stage (:meth:`stage_s`): the MD5 at push time, building the wire,
the host-to-device copy, K14 (CUDA events), the copy of the plans back
and the native pack.
"""
from __future__ import annotations

import hashlib
import time
from typing import List, Optional

import numpy as np
import torch

from soundkit_tpu_torch.codecs.flac_encode import BitWriter, FlacFrameEncoder, _SubframePlan
from soundkit_tpu_torch.native import flac_pack_library
from soundkit_tpu_torch.ops.flac_analyze import flac_analyze
from soundkit_tpu_torch.ops.flac_enc_batch import LPC_PRECISION, flac_plans_unpack
from soundkit_tpu_torch.utils.device import resolve_device

# candidate stack order inside the device op
_SLOT_SOURCES = {1: (0, 1), 8: (0, 2), 9: (2, 1), 10: (3, 2), 0: (0, 0)}

#: the stages :meth:`BatchedFlacEncoder.stage_s` reports, in order
STAGES = ("md5", "wire", "h2d", "k14", "d2h", "pack")


class _Lane:
    def __init__(self, channels: int, bits: int):
        self.buf = np.zeros((channels, 0), np.int64)
        self.frames: List[bytes] = []
        self.md5 = hashlib.md5()
        self.total = 0
        self.min_fs: Optional[int] = None
        self.max_fs = 0
        self.finished = False


class BatchedFlacEncoder:
    """B-lane lockstep FLAC encoder (16/24-bit, mono/stereo) on ``device``
    ('cuda', the default, or 'cpu')."""

    def __init__(self, n_lanes: int, sample_rate: int, channels: int,
                 bits_per_sample: int = 16, block_size: int = 4096, *, device="cuda",
                 timed: bool = False):
        if channels not in (1, 2):
            raise ValueError("batched encoder: 1 or 2 channels")
        self.device = resolve_device(device)
        if timed and self.device.type != "cuda":
            raise ValueError("timed=True needs a CUDA device (K14 is timed by CUDA events)")
        self.timed = timed
        self._stage = dict.fromkeys(STAGES, 0.0)  # host seconds; K14's from the events
        self._events: List[tuple] = []
        self.B = n_lanes
        self.channels = channels
        self.bits = bits_per_sample
        self.block_size = block_size
        self.sample_rate = sample_rate
        self._enc = [
            FlacFrameEncoder(sample_rate, channels, bits_per_sample)
            for _ in range(n_lanes)
        ]
        self._lanes = [_Lane(channels, bits_per_sample) for _ in range(n_lanes)]
        self._lib = flac_pack_library()

    def push(self, lane: int, samples: np.ndarray) -> None:
        """[C, n] (or [n] for mono) ints at the declared bit depth."""
        x = np.atleast_2d(np.asarray(samples, np.int64))
        st = self._lanes[lane]
        st.buf = np.concatenate([st.buf, x], axis=1)
        # the STREAMINFO MD5 runs here, once a pushed span; tail padding is
        # hashed where it is added (the finish paths)
        self._md5_update(st, x)

    def _md5_update(self, st: _Lane, block: np.ndarray) -> None:
        t0 = time.perf_counter()
        inter = block.T.reshape(-1)
        if self.bits == 16:
            st.md5.update(inter.astype("<i2").tobytes())
        else:
            b = inter.astype("<i4").tobytes()
            arr = np.frombuffer(b, np.uint8).reshape(-1, 4)[:, :3]
            st.md5.update(arr.tobytes())
        self._stage["md5"] += time.perf_counter() - t0

    def _record(self, st: _Lane, frame: bytes, n: int) -> None:
        st.total += n
        st.min_fs = len(frame) if st.min_fs is None else min(st.min_fs, len(frame))
        st.max_fs = max(st.max_fs, len(frame))
        st.frames.append(frame)

    def encode_step(self) -> int:
        """One lockstep round: every lane holding a full block encodes
        it through the shared device analysis.  Returns the number of
        lanes that produced a frame this step."""
        N = self.block_size
        jobs = []
        for i, st in enumerate(self._lanes):
            if st.buf.shape[1] >= N:
                jobs.append((i, st.buf[:, :N]))
                st.buf = st.buf[:, N:]
        return self._encode_jobs(jobs)

    def encode_pending(self) -> int:
        """Drain every full block of every lane through ONE device call
        (blocks are analysis-independent, so lanes AND rounds fold into
        the rows).  Returns the number of frames produced."""
        return self._encode_jobs(*self._take_pending())

    def _take_pending(self):
        """Every full block of every lane, taken from the buffers: (jobs,
        spans) for :meth:`_encode_jobs`."""
        N = self.block_size
        jobs = []  # (lane, block_view) in per-lane FIFO order
        spans = []  # (job0, nb, [C, nb*N] lane view) for bulk fill
        for i, st in enumerate(self._lanes):
            nb = st.buf.shape[1] // N
            if nb:
                lanev = st.buf[:, : nb * N]
                spans.append((len(jobs), nb, lanev))
                for k in range(nb):
                    jobs.append((i, lanev[:, k * N : (k + 1) * N]))
                st.buf = st.buf[:, nb * N :]
        return jobs, spans

    def _wire(self, jobs, N: int, spans=None) -> np.ndarray:
        """The [F, 2, N] block plane of a job list as K14 reads it (int16
        at <= 16 bits, else int32; channel 1 zero for mono)."""
        x = np.zeros((len(jobs), 2, N), np.int16 if self.bits <= 16 else np.int32)
        if spans is not None:
            # one strided copy per lane instead of one per block
            for j0, nb, lanev in spans:
                x[j0:j0 + nb, : self.channels] = (
                    lanev.reshape(self.channels, nb, N).swapaxes(0, 1))
        else:
            for j, (_, blk) in enumerate(jobs):
                x[j, : self.channels] = blk
        return x

    def _encode_jobs(self, jobs, spans=None, N: Optional[int] = None) -> int:
        """Analyze and pack a job list: one wire to the device, one K14
        launch, one copy of the plan rows back, one native pack call.
        ``N`` overrides the block size (tail frames; every job must hold
        exactly N samples)."""
        if not jobs:
            return 0
        if N is None:
            N = self.block_size
        t0 = time.perf_counter()
        F = len(jobs)
        x = self._wire(jobs, N, spans)
        t1 = time.perf_counter()
        wire = torch.from_numpy(x).to(self.device)
        t2 = time.perf_counter()
        if self.timed:
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        plans = flac_analyze(wire, N, self.bits, self.channels)
        if self.timed:
            stop.record()
            stop.synchronize()
            self._events.append((start, stop))
        t3 = time.perf_counter()  # untimed, the copy back waits for K14
        assign, kind, order, shift, qlp, _ = flac_plans_unpack(plans.cpu().numpy())
        t4 = time.perf_counter()
        frames = self._pack_frames([i for i, _ in jobs], x, assign, kind, order, shift, qlp)
        for (i, _), frame in zip(jobs, frames):
            self._record(self._lanes[i], frame, N)
        t5 = time.perf_counter()
        for k, dt in (("wire", t1 - t0), ("h2d", t2 - t1), ("d2h", t4 - t3), ("pack", t5 - t4)):
            self._stage[k] += dt
        return F

    def _pack_frames(self, lanes, wire, assign, kind, order, shift, qlp) -> List[bytes]:
        """Pack F analyzed blocks into frames with the native packer
        (``skt_flac_pack_frames`` / ``skt_flac_pack_frames16``) in one
        call, the residuals recomputed from the plans. ``wire`` is the
        [F, 2, N] block plane the analysis read; frame numbers advance per
        lane in job order (jobs are per-lane FIFO)."""
        F = len(lanes)
        N = wire.shape[-1]
        fno = np.zeros(F, np.int64)
        counts: dict = {}
        for j, i in enumerate(lanes):
            c = counts.get(i, self._enc[i]._frame_no)
            fno[j] = c
            counts[i] = c + 1
        cap = 256 + N * 12
        out = np.zeros(F * cap, np.uint8)
        out_len = np.zeros(F, np.int64)
        pack = (self._lib.skt_flac_pack_frames16 if wire.dtype == np.int16
                else self._lib.skt_flac_pack_frames)
        rc = pack(
            F, N, self.channels, self.sample_rate, self.bits,
            LPC_PRECISION, fno,
            np.ascontiguousarray(assign, np.int32),
            np.ascontiguousarray(kind, np.int32),
            np.ascontiguousarray(order, np.int32),
            np.ascontiguousarray(shift, np.int32),
            np.ascontiguousarray(qlp, np.int32), qlp.shape[-1],
            None, np.ascontiguousarray(wire), out, cap, out_len,
        )
        if rc != 0:
            raise RuntimeError(f"flac_pack overflow at frame {-rc - 1}")
        for i, c in counts.items():
            self._enc[i]._frame_no = c
        return [bytes(out[f * cap : f * cap + out_len[f]]) for f in range(F)]

    def _write_from_plan(self, enc: FlacFrameEncoder, block: np.ndarray,
                         assign: int, kind, order, shift, qlp,
                         res) -> bytes:
        C, n = block.shape
        if C == 1:
            assignment = 0
            chan_bits = (self.bits,)
            sources = (block[0].astype(np.int64),)
        else:
            L, R = block[0], block[1]
            cand = (L, R, L - R, (L + R) >> 1)
            s0, s1 = _SLOT_SOURCES[assign]
            sources = (cand[s0], cand[s1])
            assignment = assign
            chan_bits = (
                self.bits + (1 if assign == 9 else 0),
                self.bits + (1 if assign in (8, 10) else 0),
            )
        plans = []
        for slot, (src, bits) in enumerate(zip(sources, chan_bits)):
            o = int(order[slot])
            r = res[slot, o:n].astype(np.int64)
            if src[0] == src[-1] and np.all(src == src[0]):
                plans.append(_SubframePlan("constant", 0, None, bits,
                                           src[:1], 0))
                continue
            if kind[slot] == 1:
                plans.append(_SubframePlan(
                    "lpc", o, r, bits, src[:o], 0,
                    qlp=qlp[slot, :o].astype(np.int64),
                    shift=int(shift[slot]), precision=LPC_PRECISION,
                ))
            else:
                plans.append(_SubframePlan("fixed", o, r, bits, src[:o], 0))
        return enc.write_frame(n, assignment, plans)

    def finish_all(self) -> List[bytes]:
        """Finish every lane, batching the tail frames through the
        device analysis: one `_encode_jobs` call per DISTINCT tail
        length (in lockstep serving all lanes share one).  Returns the
        B complete .flac streams in lane order."""
        self.encode_pending()
        groups: dict = {}
        for i, st in enumerate(self._lanes):
            if st.finished or st.buf.shape[1] == 0:
                continue
            groups.setdefault(max(st.buf.shape[1], 16), []).append(i)
        for n, lanes in sorted(groups.items()):
            jobs = []
            for i in lanes:
                st = self._lanes[i]
                blk = st.buf
                if blk.shape[1] < n:  # <16-sample tail: repeat-pad
                    pad = np.repeat(blk[:, -1:], n - blk.shape[1],
                                    axis=1)
                    self._md5_update(st, pad)  # decoder will emit it
                    blk = np.concatenate([blk, pad], axis=1)
                st.buf = st.buf[:, :0]
                jobs.append((i, blk))
            self._encode_jobs(jobs, N=n)
        return [self.finish(i) for i in range(self.B)]

    def finish(self, lane: int) -> bytes:
        """Flush the lane's tail through the host planner and return
        its complete .flac stream."""
        st = self._lanes[lane]
        # drain any full blocks still pending for this lane only
        while st.buf.shape[1] >= self.block_size:
            self.encode_step()
        if st.buf.shape[1] >= 16:
            block = st.buf
            st.buf = st.buf[:, :0]
            frame = self._enc[lane].encode_frame(block)
            self._record(st, frame, block.shape[1])
        elif st.buf.shape[1] > 0:
            pad = 16 - st.buf.shape[1]
            ext = np.repeat(st.buf[:, -1:], pad, axis=1)
            self._md5_update(st, ext)  # decoder will emit the padding
            block = np.concatenate([st.buf, ext], axis=1)
            st.buf = st.buf[:, :0]
            frame = self._enc[lane].encode_frame(block)
            self._record(st, frame, block.shape[1])
        st.finished = True

        info = BitWriter()
        info.write(self.block_size, 16)
        info.write(self.block_size, 16)
        info.write(st.min_fs or 0, 24)
        info.write(st.max_fs, 24)
        info.write(self.sample_rate, 20)
        info.write(self.channels - 1, 3)
        info.write(self.bits - 1, 5)
        info.write(st.total, 36)
        for b in st.md5.digest():
            info.write(b, 8)
        si = info.bytes()
        header = b"fLaC" + bytes([0x80]) + len(si).to_bytes(3, "big") + si
        return header + b"".join(st.frames)

    def stage_s(self) -> dict:
        """Seconds of each stage over the encoder's life (``STAGES``; K14
        by CUDA events, timed encoders only, the rest on the host clock)
        and the device calls so far."""
        if not self.timed:
            raise ValueError("stage_s needs an encoder made with timed=True")
        out = dict(self._stage, calls=len(self._events))
        out["k14"] = sum(a.elapsed_time(b) for a, b in self._events) / 1e3
        return out
