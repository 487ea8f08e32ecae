"""The batched MP3 -> 8 kHz µ-law transcode chain over the port
(counterpart of ``benchmarks/transcode_bench.py``'s ``tail_stage`` and its
main loop, ``:55-60`` and ``:87-93``).

N concurrent MP3 streams decode in lockstep chunks of ``CHUNK`` granules
(``BatchedMp3Decoder.decode_ready(max_granules=CHUNK, device_out=True)``:
K10 a granule), and each chunk runs the tail on the device: the downmix,
the carried-state polyphase resample 44.1 -> 8 kHz
(``ops.resample.resample_stateful``: K15 on the card) and the µ-law
encode. ``CHUNK = 49`` granules are 28,224 = 64 x 441 input samples, so
the 80/441 polyphase phase realigns at every chunk boundary and only the
255 samples of the filter's history are carried: the chunked output
equals a continuous resample of the whole stream. The codes stay on the
device until the caller reads them.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from soundkit_tpu_torch.ops import companding
from soundkit_tpu_torch.ops import resample as rs

SRC_RATE = 44100
DST_RATE = 8000
CHUNK = 49
GRANULE = 576


def tail_stage(pcm_block: torch.Tensor, hist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, C, CHUNK*576] f32 PCM -> (u8 µ-law codes [B, CHUNK*576*80/441],
    the new resampler history)."""
    mono = pcm_block.mean(dim=1)
    lo, hist = rs.resample_stateful(mono, hist, SRC_RATE, DST_RATE)
    return companding.encode_mulaw(torch.clamp(lo * 32768.0, -32768, 32767)), hist


def transcode_ready(decoder, hist: torch.Tensor, chunk: int = CHUNK,
                    keep_mono: bool = False) -> Tuple[List[torch.Tensor], torch.Tensor, int,
                                                      Optional[List[torch.Tensor]]]:
    """Every whole chunk of ``chunk`` granules that all of ``decoder``'s
    lanes have ready, through the decoder and :func:`tail_stage`: returns
    (the chunks' codes, each [B, m] u8 on the decoder's device, the new
    history, the granules decoded, and with ``keep_mono`` each chunk's
    downmixed PCM [B, chunk*576] for a check)."""
    codes, monos, granules = [], [] if keep_mono else None, 0
    while decoder.ready_granules >= chunk:
        block = decoder.decode_ready(max_granules=chunk, device_out=True)
        g, B, C, _ = block.shape
        granules += g
        merged = block.permute(1, 2, 0, 3).reshape(B, C, g * GRANULE)
        if keep_mono:
            monos.append(merged.mean(dim=1))
        c, hist = tail_stage(merged, hist)
        codes.append(c)
    return codes, hist, granules, monos


def continuous_codes(mono: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` µ-law codes of each row of ``mono`` [B, m] f32 (a
    lane's whole decoded mono signal at SRC_RATE) through one continuous
    numpy resample (``resample_np``): what the chunked chain must give."""
    lo = rs.resample_np(mono, SRC_RATE, DST_RATE)[:, :n]
    return companding.encode_mulaw(torch.from_numpy(np.clip(lo * 32768.0, -32768, 32767))).numpy()


def codes_apart(got: np.ndarray, ref: np.ndarray) -> Tuple[int, int]:
    """(codes that differ, codes that decode more than one µ-law step
    apart: the step of a code's segment, 8 << segment, the larger of the
    two) between two u8 arrays of one shape."""
    def step(codes):
        return 8 << ((~codes.astype(np.int32) >> 4) & 7)

    a, b = (companding.decode_mulaw(torch.from_numpy(c)).numpy().astype(np.int32)
            for c in (got, ref))
    return int((got != ref).sum()), int((np.abs(a - b) > np.maximum(step(got), step(ref))).sum())
