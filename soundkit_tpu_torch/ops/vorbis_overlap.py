"""Vorbis window and overlap-add (K13): everything of one lockstep Vorbis
packet after the IMDCT products, for every lane (counterpart of
``soundkit_tpu/ops/vorbis_batch.py::_vorbis_synth_step`` after its two
matmuls).

:func:`vorbis_overlap` takes the long IMDCT output ``pcm1`` f32 [B, C,
n1], the short one ``pcm0`` f32 [B, C, n0] (read at its own width: no
padded copy), the window bank f32 [5, n1] (``ops.vorbis_batch.window_bank``),
the lane flags int32 [5, B] (rows ``FLAG_ROWS``: the block flag, the
previous and next window flags, validity and the previous block's flag)
and the carried lap ``carry`` f32 [B, C, n1/2], and returns ``(out [B, C,
n1/2], new_carry [B, C, n1/2])``. Per (lane, channel) and sample ``j <
n1/2``, with ``n`` the block's size, ``d = prev_n/4 + n/4`` and the
shift ``s`` 0 when the two block sizes agree, ``+(n1 - n0)/4`` after a
long block and ``-(n1 - n0)/4`` before one:

- the windowed block ``p[i] = pcm[i] w[i]`` (``pcm`` the block's IMDCT
  output, zero past ``n``; ``w`` the bank's row ``2 prev + next`` for a
  long block, row 4 for a short one) and its shift ``q[k] = p[k - s]``,
  zero where ``k - s`` leaves ``[0, n1)``;
- ``buf[k] = carry[k] + q[k]``, the carry zero past ``n1/2``;
- ``out[j] = buf[j]``; ``new_carry[j] = buf[d + j]`` for ``j < n/2``,
  else 0;
- a lane that is not valid gets ``out = 0`` and its carry back unchanged.

Each product and sum is rounded alone (the reference multiplies, then
adds), so the card and the CPU give the same bits.

For CUDA tensors it launches ``csrc/vorbis_overlap.cu`` and counts
``vorbis_overlap.launches``. For CPU tensors it takes
:func:`vorbis_overlap_plain`, the reference's op order (the padded short
block, the three static shifts, the three carry candidates).
"""
from __future__ import annotations

import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.utils.device import check_cuda, launch_check

#: the rows of the packed lane flags, in order
FLAG_ROWS = ("n_flag", "prev_flag", "next_flag", "valid", "carry_flag")


def vorbis_overlap_plain(pcm1, pcm0, bank, flags, carry):
    """:func:`vorbis_overlap` in plain torch, op for op the reference's
    ``_vorbis_synth_step`` after its matmuls."""
    B, C, n1 = pcm1.shape
    n0 = pcm0.shape[-1]
    h1 = n1 // 2
    n_flag, prev_flag, next_flag, valid, carry_flag = flags.to(torch.int64)
    valid = valid != 0
    pcm0 = torch.nn.functional.pad(pcm0, (0, n1 - n0))
    widx = torch.where(n_flag == 1, prev_flag * 2 + next_flag, 4)
    w = bank[widx]  # [B, n1]
    pcm = torch.where((n_flag == 1)[:, None, None], pcm1, pcm0)
    pcm = pcm * w[:, None, :]

    sL = (n1 - n0) // 4
    pcm_right = torch.nn.functional.pad(pcm, (sL, 0))[..., :n1]   # shift +sL
    pcm_left = torch.nn.functional.pad(pcm, (0, sL))[..., sL:]    # shift -sL
    prev_long = (carry_flag == 1)[:, None, None]
    cur_long = (n_flag == 1)[:, None, None]
    shifted = torch.where(prev_long == cur_long, pcm, torch.where(prev_long, pcm_right, pcm_left))
    carry_full = torch.nn.functional.pad(carry, (0, n1 - h1))
    buf = carry_full + shifted

    prev_n = torch.where(carry_flag == 1, n1, n0)
    n = torch.where(n_flag == 1, n1, n0)
    d = prev_n // 4 + n // 4
    dvals = [n0 // 2, (n0 + n1) // 4, n1 // 2]
    cands = [buf[..., dv: dv + h1] if dv + h1 <= n1
             else torch.nn.functional.pad(buf[..., dv:], (0, dv + h1 - n1)) for dv in dvals]
    new_carry = cands[0]
    for dv, cand in zip(dvals[1:], cands[1:]):
        new_carry = torch.where((d == dv)[:, None, None], cand, new_carry)
    k = torch.arange(h1, device=pcm1.device)[None, None, :]
    new_carry = torch.where(k < (n // 2)[:, None, None], new_carry, 0.0)

    v = valid[:, None, None]
    return torch.where(v, buf[..., :h1], 0.0), torch.where(v, new_carry, carry)


def vorbis_overlap(pcm1, pcm0, bank, flags, carry, out=None):
    """K13: the window, shift, overlap-add, new lap and masks of one
    packet for every lane (see the module's docstring) -> (out [B, C,
    n1/2], new_carry [B, C, n1/2]). ``out`` goes into the given f32 [B,
    C, n1/2] tensor where there is one; ``new_carry`` is always a new
    tensor (the kernel reads ``carry`` across samples). On the card every
    tensor must be contiguous and start on a 16-byte boundary (the kernel
    moves float4s), and the block sizes be multiples of 16 from 64 on
    (every Vorbis block size is); anything else raises."""
    if pcm1.device.type == "cpu":
        got, new_carry = vorbis_overlap_plain(pcm1, pcm0, bank, flags, carry)
        if out is not None:
            got = out.copy_(got)
        return got, new_carry
    outs = () if out is None else (out,)
    dev = check_cuda("vorbis_overlap", pcm1, pcm0, bank, flags, carry, *outs)
    B, C, n1 = pcm1.shape
    n0 = pcm0.shape[-1]
    h1 = n1 // 2
    if n1 < n0 or n0 < 64 or n0 % 16 or n1 % 16 or pcm0.shape != (B, C, n0) or \
            bank.shape != (5, n1) or flags.shape != (len(FLAG_ROWS), B) or \
            carry.shape != (B, C, h1) or any(t.shape != (B, C, h1) for t in outs):
        raise ValueError(f"vorbis_overlap: pcm1{tuple(pcm1.shape)} pcm0{tuple(pcm0.shape)} "
                         f"bank{tuple(bank.shape)} flags{tuple(flags.shape)} "
                         f"carry{tuple(carry.shape)}; want pcm1 [B, C, n1], pcm0 [B, C, n0], "
                         "bank [5, n1], flags [5, B], carry and out [B, C, n1/2], 64 <= n0 <= "
                         "n1, both multiples of 16")
    if flags.dtype != torch.int32 or any(t.dtype != torch.float32
                                         for t in (pcm1, pcm0, bank, carry, *outs)):
        raise TypeError("vorbis_overlap: flags int32; pcm1, pcm0, bank, carry and out float32")
    if any(t.data_ptr() % 16 for t in (pcm1, pcm0, bank, carry, *outs)):
        raise ValueError("vorbis_overlap: pcm1, pcm0, bank, carry and out must start on a "
                         "16-byte boundary")
    got = torch.empty((B, C, h1), dtype=torch.float32, device=dev) if out is None else out
    new_carry = torch.empty_like(carry)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_vorbis_overlap(
        pcm1.data_ptr(), pcm0.data_ptr(), bank.data_ptr(), flags.data_ptr(), carry.data_ptr(),
        got.data_ptr(), new_carry.data_ptr(), B, C, n0, n1, stream)
    launch_check("vorbis_overlap", rc)
    vorbis_overlap.launches += 1
    return got, new_carry


vorbis_overlap.launches = 0
