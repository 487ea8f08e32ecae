"""Batched FLAC LPC reconstruction on the device (counterpart of
``soundkit_tpu/ops/flac_lpc.py``).

The wire of one frame per lane:

  resw  [L, 2, T] int32: warm-up samples for n < order, else residuals
                         (CONSTANT and VERBATIM subframes are order-0
                         rows whose ``resw`` is the sample stream)
  coef  [L, 2, 32] int32: quantized LPC coefficients (FIXED orders use
                         the canonical integer sets with shift 0)
  order / shift / wasted [L, 2] int32, chan_assign / block_size [L]
  int32, lane_valid [L] bool

The exact integer recurrence

    s[n] = r[n]                                         for n < order
    s[n] = r[n] + ((sum_k coef[k] * s[n-1-k]) >> shift)  otherwise

runs over a 32-deep history in 64-bit arithmetic, then the wasted-bit
shift and the stereo decorrelation (left/side 8, right/side 9, mid/side
10), also in 64 bits; samples past ``block_size`` and invalid lanes are
zero, and the result is cut to int32 last. The host walk emits shifts
and wasted bits in 0..31. Outside that, kernel and plain version take
them as XLA's int64 shifts do, the amount read as unsigned: a shift of
64 or more (or a negative one) leaves the prediction's sign, 0 or -1;
wasted bits of 64 or more (or negative) leave 0.

:func:`flac_frame` (K9) launches ``csrc/flac_lpc.cu`` for CUDA tensors
and takes :func:`flac_frame_plain` for CPU tensors. FLAC frames carry
no state, so a caller with many rounds folds them into the lane axis of
one call (the reference's ``flac_frames_batch``).
"""
from __future__ import annotations

import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.utils.device import check_cuda, launch_check

MAX_ORDER = 32


def flac_frame_plain(resw, coef, order, shift, wasted, chan_assign, block_size, lane_valid):
    """The reference's scan step by step, vectorized over the rows."""
    L, C, T = resw.shape
    rows = L * C
    r_tm = resw.to(torch.int64).reshape(rows, T).t().contiguous()  # [T, rows]
    coef_l = coef.to(torch.int64).reshape(rows, MAX_ORDER)
    order_l = order.to(torch.int64).reshape(rows)
    shift_l = shift.to(torch.int64).reshape(rows)
    shift_l = torch.where((shift_l >= 0) & (shift_l < 64), shift_l, 63)  # >> 63: the sign

    hist = torch.zeros((rows, MAX_ORDER), dtype=torch.int64, device=resw.device)
    out_tm = torch.empty_like(r_tm)
    for n in range(T):
        pred = (hist * coef_l).sum(1) >> shift_l  # arithmetic >>
        s = torch.where(n < order_l, r_tm[n], pred + r_tm[n])
        hist = torch.cat([s[:, None], hist[:, :-1]], dim=1)
        out_tm[n] = s
    s = out_tm.t().reshape(L, C, T)

    ws = wasted.to(torch.int64)[..., None]
    s = torch.where((ws >= 0) & (ws < 64), s << ws.clamp(0, 63), 0)

    a = chan_assign.to(torch.int64)[:, None]
    c0, c1 = s[:, 0], s[:, 1]
    side = c1
    mid = (c0 << 1) | (side & 1)
    new0 = torch.where(a == 9, c1 + c0, torch.where(a == 10, (mid + side) >> 1, c0))
    new1 = torch.where(a == 8, c0 - c1, torch.where(a == 10, (mid - side) >> 1, c1))
    s = torch.stack([new0, new1], dim=1)

    n_idx = torch.arange(T, device=resw.device)
    s = torch.where(n_idx[None, None, :] < block_size.to(torch.int64)[:, None, None], s, 0)
    s = torch.where(lane_valid.bool()[:, None, None], s, 0)
    return s.to(torch.int32)


def flac_frame(resw, coef, order, shift, wasted, chan_assign, block_size, lane_valid):
    """K9: one FLAC frame for all lanes -> samples [L, 2, T] int32.
    Integer inputs int32, ``lane_valid`` bool."""
    if resw.device.type == "cpu":
        return flac_frame_plain(resw, coef, order, shift, wasted, chan_assign, block_size,
                                lane_valid)
    ints = (resw, coef, order, shift, wasted, chan_assign, block_size)
    dev = check_cuda("flac_frame", *ints, lane_valid)
    L, C, T = resw.shape
    if C != 2 or coef.shape != (L, 2, MAX_ORDER):
        raise ValueError(f"flac_frame: resw{tuple(resw.shape)}, coef{tuple(coef.shape)}")
    if any(t.shape != (L, 2) for t in (order, shift, wasted)) or \
            any(t.shape != (L,) for t in (chan_assign, block_size, lane_valid)):
        raise ValueError("flac_frame: order, shift and wasted are [L, 2]; chan_assign, "
                         "block_size and lane_valid are [L]")
    if not all(t.dtype == torch.int32 for t in ints) or lane_valid.dtype != torch.bool:
        raise TypeError("flac_frame: integer inputs must be int32 and lane_valid bool")
    out = torch.empty((L, 2, T), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_flac_lpc(
        resw.data_ptr(), coef.data_ptr(), order.data_ptr(), shift.data_ptr(), wasted.data_ptr(),
        chan_assign.data_ptr(), block_size.data_ptr(), lane_valid.data_ptr(), out.data_ptr(),
        L, T, stream,
    )
    launch_check("flac_frame", rc)
    flac_frame.launches += 1
    return out


flac_frame.launches = 0
