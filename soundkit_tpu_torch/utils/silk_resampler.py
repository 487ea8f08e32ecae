"""The SILK 8 / 12 / 16 kHz to 48 kHz resampler of the Opus host decoder
(counterpart of ``soundkit_tpu/utils/swr.SilkResampler``).

The JAX package drives libswresample through ctypes, configured as
libavcodec's Opus decoder configures it (filter_size 16, exact rational
ratios, a zero preroll of ``SILK_RESAMPLE_DELAY[bw]`` samples). The port
links no FFmpeg: this is a streaming polyphase FIR in numpy over the taps
probed from that resampler (``ops/silk_batch.resampler_taps``, the
committed ``data/silk_resampler.npz``), with the stream edges and output
counts of libswresample's algorithm:

- at the ratios 3, 4 and 6 a filter of 16 taps starts its first window 7
  samples before the stream, so output ``m`` reads input up to
  ``m // R + 8``, and a call emits at most ``R * (N - 8)`` samples in all
  once ``N`` input samples (the preroll included) have arrived;
- nothing is emitted before 17 input samples; the samples before the
  stream are its mirror image (``x[-n] = x[n]``), which is what the
  probed ``first_slot_correction`` describes;
- :meth:`drain` appends the reflection of the last samples
  (``(min(buffered, 16) + 1) // 2`` of them, ``x[N + j] = x[N - 1 - j]``)
  and emits what that completes, as a flush (a NULL-input convert) does.

A call returns at most the number of samples asked for; what it cannot
emit yet stays buffered. The counts are libswresample's call for call
(the first NB frame comes up 24 samples short, which ``opus_core`` books
as its ``_delayed``); the values are the float32 rounding of the float64
polyphase sum, which may differ from libswresample's float32 sums in the
last bits.
"""
from __future__ import annotations

import numpy as np

# resampler group delay at the SILK rate, per bandwidth (NB/MB/WB),
# matching the oracle's silk_resample_delay table
SILK_RESAMPLE_DELAY = {0: 4, 1: 8, 2: 11}

FILTER_LENGTH = 16                   # libswresample's filter at filter_size 16
_LEAD = (FILTER_LENGTH - 1) // 2     # samples the first window starts before the stream


class SilkResampler:
    """Streaming FLT resampler: push SILK-rate samples, get 48 kHz."""

    def __init__(self, in_rate: int, bandwidth: int, channels: int = 1):
        from soundkit_tpu_torch.ops.silk_batch import resampler_taps

        taps, off = resampler_taps(bandwidth)
        if taps.shape != (48000 // in_rate, FILTER_LENGTH):
            raise ValueError(f"no probed taps for {in_rate} Hz at bandwidth {bandwidth}")
        self.channels = channels
        self._R = taps.shape[0]
        self._taps = taps
        self._off = off
        self._delay = SILK_RESAMPLE_DELAY[bandwidth]
        # the input stream from index self._lo on (the preroll first)
        self._x = np.zeros((self._delay, channels), np.float32)
        self._lo = 0
        self._n_in = self._delay
        self._n_out = 0
        self._started = False  # the mirrored start is in place
        self._flushed = False

    def _append(self, pcm: np.ndarray) -> None:
        self._x = np.concatenate([self._x, pcm], axis=0)
        self._n_in += pcm.shape[0]
        if not self._started and self._n_in > FILTER_LENGTH:
            # the samples before the stream are its mirror image
            self._x = np.concatenate([self._x[FILTER_LENGTH:0:-1], self._x], axis=0)
            self._lo = -FILTER_LENGTH
            self._started = True

    def _available(self, n_in: int) -> int:
        return self._R * (n_in - _LEAD - 1) if self._started else 0

    def _emit(self, n: int) -> np.ndarray:
        """The next ``n`` outputs, from the buffered input."""
        m = self._n_out + np.arange(n)
        q, p = np.divmod(m - self._off, self._R)
        idx = self._delay + q[:, None] - np.arange(FILTER_LENGTH)[None, :] - self._lo
        y = np.einsum("nj,njc->nc", self._taps[p], self._x[idx].astype(np.float64))
        self._n_out += n
        # keep what the next output's window still reads
        first = self._delay + (self._n_out - self._off) // self._R - (FILTER_LENGTH - 1)
        cut = first - self._lo
        if cut > 0:
            self._x = self._x[cut:]
            self._lo = first
        return y.astype(np.float32)

    def _flush(self) -> None:
        """A NULL-input convert: the first appends the reflection of the
        buffered tail to the stream, for good (later input follows it);
        later ones add nothing."""
        if self._flushed:
            return
        self._flushed = True
        buffered = self._n_in - (self._n_out // self._R - _LEAD if self._started else 0)
        refl = (min(buffered, FILTER_LENGTH) + 1) // 2
        end = self._n_in - self._lo
        self._append(self._x[end - refl:end][::-1])

    def _convert(self, pcm: np.ndarray, out_samples: int) -> np.ndarray:
        if pcm.shape[0]:
            self._append(pcm)
        else:
            self._flush()
        n = max(0, min(out_samples, self._available(self._n_in) - self._n_out))
        return self._emit(n)

    def process(self, pcm: np.ndarray, out_samples: int) -> np.ndarray:
        """pcm: [n, ch] float at the SILK rate; returns [m, ch] f32 at
        48 kHz with m <= out_samples (the oracle requests exactly the
        packet duration per superframe; the first NB frame comes up 24
        samples short of it — the oracle's delayed_samples). An empty
        ``pcm`` flushes, as the NULL-input convert it makes there does."""
        return self._convert(np.asarray(pcm, np.float32).reshape(-1, self.channels), out_samples)

    def drain(self, out_samples: int) -> np.ndarray:
        """Flush up to ``out_samples`` buffered samples (NULL-input
        convert), the oracle's opus_flush_resample on a bandwidth
        switch."""
        if out_samples <= 0:
            return np.zeros((0, self.channels), dtype=np.float32)
        return self._convert(np.zeros((0, self.channels), np.float32), out_samples)
