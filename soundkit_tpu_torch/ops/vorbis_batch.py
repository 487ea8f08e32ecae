"""Batched Vorbis synthesis in PyTorch: IMDCT, window and overlap-add
(counterpart of ``soundkit_tpu/ops/vorbis_batch.py``).

One step takes one packet's spectrum of every lane, ``[B, C, n1/2]``
float32 (short spectra zero-padded), to its finished PCM:

- the IMDCT of both block sizes as plain float32 products
  (:func:`vorbis_imdct`), run in IEEE float32 whatever the caller's TF32
  settings (``utils.device.ieee_fp32``), as the reference pins float32;
  the long result is ``[B, C, n1]`` and the short one ``[B, C, n0]``;
- then the window of the lane's block (a row of :func:`window_bank`),
  the shift of the four (previous, current) block-size cases, the
  overlap-add with the carried lap, the new lap and the masks of invalid
  lanes: K13 (``ops.vorbis_overlap.vorbis_overlap``) on the card, its
  plain version on the CPU.

:func:`synth_round` is the decoder's step, with the lane flags packed in
one int32 tensor (``ops.vorbis_overlap.FLAG_ROWS``);
:func:`vorbis_synth_step` is the reference's signature over it, and
:func:`vorbis_synth_step_plain` the same step with K13's plain version
on any device (the reference's op order), the path the tests hold to the
JAX package. :func:`window_bank` and :func:`init_state` are verbatim
copies of the reference's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from soundkit_tpu_torch.codecs.vorbis_core import imdct_matrix, vorbis_window
from soundkit_tpu_torch.ops.vorbis_overlap import vorbis_overlap, vorbis_overlap_plain
from soundkit_tpu_torch.utils.device import ieee_fp32


@functools.lru_cache(maxsize=8)
def window_bank(n0: int, n1: int) -> np.ndarray:
    """[5, n1] windows: rows 0-3 = long block with (prev_flag,
    next_flag) in (0,0),(0,1),(1,0),(1,1); row 4 = short block
    (zero-padded to n1)."""
    bank = np.zeros((5, n1), dtype=np.float32)
    long_slope = vorbis_window(n1 // 2)
    short_slope = vorbis_window(n0 // 2)
    for pf in (0, 1):
        for nf in (0, 1):
            w = np.ones(n1)
            if pf:
                w[: n1 // 2] = long_slope
            else:
                s = n0 // 2
                start = n1 // 4 - n0 // 4
                w[:start] = 0.0
                w[start : start + s] = short_slope
                w[start + s : n1 // 2] = 1.0
            if nf:
                w[n1 // 2 :] = long_slope[::-1]
            else:
                s = n0 // 2
                start = 3 * n1 // 4 - n0 // 4
                w[n1 // 2 : start] = 1.0
                w[start : start + s] = short_slope[::-1]
                w[start + s :] = 0.0
            bank[pf * 2 + nf] = w
    ws = np.zeros(n1)
    ws[: n0 // 2] = short_slope
    ws[n0 // 2 : n0] = short_slope[::-1]
    bank[4] = ws
    return bank


def init_state(B: int, C: int, n1: int):
    return (
        np.zeros((B, C, n1 // 2), dtype=np.float32),  # carry
        np.ones(B, dtype=np.int32),  # carry_flag (long by default)
    )


@functools.lru_cache(maxsize=8)
def device_tables(n0: int, n1: int, device: torch.device):
    """(M1^T [n1/2, n1], M0^T [n0/2, n0], window bank [5, n1]) as float32
    on ``device``, once a topology."""
    m1 = np.ascontiguousarray(imdct_matrix(n1).astype(np.float32).T)
    m0 = np.ascontiguousarray(imdct_matrix(n0).astype(np.float32).T)
    return tuple(torch.from_numpy(a).to(device) for a in (m1, m0, window_bank(n0, n1)))


def vorbis_imdct(spec: torch.Tensor, n0: int, n1: int):
    """Both IMDCTs of ``spec`` [B, C, n1/2] as the reference forms them:
    (``flat @ M1.T`` [B, C, n1], ``flat[:, :n0/2] @ M0.T`` [B, C, n0]),
    in IEEE float32."""
    B, C, h1 = spec.shape
    m1t, m0t, _ = device_tables(n0, n1, spec.device)
    flat = spec.reshape(B * C, h1)
    with ieee_fp32():
        pcm1 = flat @ m1t
        pcm0 = flat[:, : n0 // 2] @ m0t
    return pcm1.reshape(B, C, n1), pcm0.reshape(B, C, n0)


def pack_flags(n_flag, prev_flag, next_flag, valid, carry_flag) -> torch.Tensor:
    """The lane flags as K13 reads them: int32 [5, B] in the order of
    ``ops.vorbis_overlap.FLAG_ROWS``."""
    return torch.stack([t.to(torch.int32) for t in (n_flag, prev_flag, next_flag, valid,
                                                    carry_flag)])


def synth_round(spec, flags, carry, n0: int, n1: int, out=None):
    """One lockstep packet of every lane from packed ``flags`` (int32 [5,
    B]): the IMDCTs, then K13 on the card or its plain version on the
    CPU -> (out [B, C, n1/2], new_carry [B, C, n1/2]). ``out`` is written
    into the given tensor where there is one."""
    pcm1, pcm0 = vorbis_imdct(spec, n0, n1)
    bank = device_tables(n0, n1, spec.device)[2]
    return vorbis_overlap(pcm1, pcm0, bank, flags, carry, out=out)


def _lengths_and_flag(n_flag, valid, primed, carry_flag, n0: int, n1: int):
    """(out_len [B], new_carry_flag [B]) of a step, as the reference
    forms them: ``d = prev_n/4 + n/4`` where the lane is valid and primed,
    else 0; the new flag is the block's where the lane is valid."""
    prev_n = torch.where(carry_flag == 1, n1, n0)
    n = torch.where(n_flag == 1, n1, n0)
    d = prev_n // 4 + n // 4
    out_len = torch.where(valid & primed, d, 0).to(torch.int32)
    return out_len, torch.where(valid, n_flag, carry_flag).to(torch.int32)


def vorbis_synth_step(spec, n_flag, prev_flag, next_flag, valid, primed, carry, carry_flag,
                      n0: int, n1: int):
    """One lockstep packet for all lanes, with the reference's inputs
    and outputs.

    spec:      [B, C, n1//2] f32 (short spectra padded with zeros)
    n_flag:    [B] int32, 1 = long block (n1), 0 = short (n0)
    prev/next_flag: [B] int32 window flags (long blocks only)
    valid:     [B] bool: lane has a packet this step
    primed:    [B] bool: lane has synthesized at least one packet
    carry:     [B, C, n1//2] f32 lap state
    carry_flag:[B] int32 previous block's n_flag

    Returns (out [B, C, n1//2], out_len [B], new_carry, new_carry_flag);
    out[:, :, :out_len[b]] are lane b's finished samples. K13 on the card,
    its plain version on the CPU."""
    flags = pack_flags(n_flag, prev_flag, next_flag, valid, carry_flag)
    out, new_carry = synth_round(spec, flags, carry, n0, n1)
    out_len, new_flag = _lengths_and_flag(n_flag, valid, primed, carry_flag, n0, n1)
    return out, out_len, new_carry, new_flag


def vorbis_synth_step_plain(spec, n_flag, prev_flag, next_flag, valid, primed, carry,
                            carry_flag, n0: int, n1: int):
    """:func:`vorbis_synth_step` with K13's plain version on any device:
    the reference's ``_vorbis_synth_step`` op for op."""
    pcm1, pcm0 = vorbis_imdct(spec, n0, n1)
    bank = device_tables(n0, n1, spec.device)[2]
    flags = pack_flags(n_flag, prev_flag, next_flag, valid, carry_flag)
    out, new_carry = vorbis_overlap_plain(pcm1, pcm0, bank, flags, carry)
    out_len, new_flag = _lengths_and_flag(n_flag, valid, primed, carry_flag, n0, n1)
    return out, out_len, new_carry, new_flag
