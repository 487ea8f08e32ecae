"""MP3 granule synthesis (K10): IMDCT, overlap-add, frequency inversion
and the polyphase synthesis filterbank, for one granule of every
channel lane (counterpart of the body of
``soundkit_tpu/ops/mp3_batch.py::_mp3_granule_device`` from the subband
reshape to its return).

Inputs, for L channel lanes:

  xr          f32 [L, 576]  lines after requantize, M/S and alias reduction
  block_type  i32 [L]       0 long, 1 start, 2 short, 3 stop
  mixed       u8  [L]       subbands 0-1 long with window 0 (mixed block)
  lane_valid  u8  [L]       0: silent PCM, state passed through
  overlap     f32 [L, 576]  the carried IMDCT upper halves, [32, 18] a lane
  fifo        f32 [L, 1024] the polyphase FIFO, newest first

and the result is ``(pcm [L, 576], new_overlap, new_fifo)`` in new
tensors; the inputs are not updated.

:func:`mp3_synth` launches ``csrc/mp3_synth.cu`` for CUDA tensors and
counts ``mp3_synth.launches``; for CPU tensors it takes
:func:`mp3_synth_plain`, the reference's computation in plain torch
(both IMDCT paths computed, then one selected; the 18 rounds shift the
FIFO one by one). The plain version runs its products in IEEE float32
whatever the caller's TF32 settings (:func:`utils.device.ieee_fp32`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.ops import mp3_dsp
from soundkit_tpu_torch.utils.device import check_cuda, ieee_fp32, launch_check

GRANULE = 576
FIFO = 1024


@functools.lru_cache(maxsize=1)
def u_indices() -> np.ndarray:
    """The 512 FIFO positions a round's windowed sum reads: blocks
    ``128 i + [0, 32)`` and ``128 i + [96, 128)``."""
    idx = np.zeros(512, dtype=np.int32)
    for i in range(8):
        idx[64 * i : 64 * i + 32] = np.arange(128 * i, 128 * i + 32)
        idx[64 * i + 32 : 64 * i + 64] = np.arange(128 * i + 96, 128 * i + 128)
    return idx


@functools.lru_cache(maxsize=1)
def _inv_mask() -> np.ndarray:
    m = np.ones((32, 18), np.float32)
    m[1::2, 1::2] = -1.0
    return m


@functools.lru_cache(maxsize=8)
def plain_tables(device: torch.device) -> dict:
    """The plain version's float32 tables on ``device``."""
    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return dict(
        m36=f32(mp3_dsp.imdct_matrix(36)), wins=f32(mp3_dsp.imdct_windows()),
        m12=f32(mp3_dsp.imdct_matrix(12)), ws=f32(mp3_dsp.short_window()),
        n=f32(mp3_dsp.synth_matrix()), d=f32(mp3_dsp.synth_window()),
        u_idx=torch.from_numpy(u_indices().astype(np.int64)).to(device),
        inv=f32(_inv_mask()),
    )


@functools.lru_cache(maxsize=8)
def kernel_tables(device: torch.device) -> torch.Tensor:
    """K10's packed float32 table on ``device``, in the order of the
    ``T_*`` offsets of ``csrc/mp3_synth.cu``: IMDCT 36 transposed [18,
    36], the window bank [4, 36], IMDCT 12 transposed [6, 12], the short
    window [12], the matrixing transposed [32, 64] and the D window
    [512]."""
    parts = (mp3_dsp.imdct_matrix(36).T, mp3_dsp.imdct_windows(), mp3_dsp.imdct_matrix(12).T,
             mp3_dsp.short_window(), mp3_dsp.synth_matrix().T, mp3_dsp.synth_window())
    flat = np.concatenate([np.asarray(p, np.float32).reshape(-1) for p in parts])
    return torch.from_numpy(flat).to(device)


def window_rows(block_type: torch.Tensor) -> torch.Tensor:
    """Window-bank row of each lane's long path, as the reference's
    gather takes ``wins[where(bt == 2, 0, bt)]``: a negative row counts
    from the end, then the row is clamped to 0..3."""
    bt = block_type.to(torch.int64)
    row = torch.where(bt == 2, 0, bt)
    return torch.where(row < 0, row + 4, row).clamp(0, 3)


def mp3_synth_plain(xr, block_type, mixed, lane_valid, overlap, fifo):
    """The reference's computation (``ops/mp3_batch.py:167-226``)."""
    L = xr.shape[0]
    tb = plain_tables(xr.device)
    valid = lane_valid.bool()
    mixed_f = mixed.bool().reshape(L, 1, 1)
    sb_ids = torch.arange(32, device=xr.device).reshape(1, 32, 1)
    flat = xr.reshape(L, 32, 18)
    with ieee_fp32():
        z_long = torch.einsum("lsk,nk->lsn", flat, tb["m36"])  # [L, 32, 36]
        w_long = tb["wins"][window_rows(block_type)]  # [L, 36]
        w_sel = torch.where(mixed_f & (sb_ids < 2), tb["wins"][0].reshape(1, 1, 36),
                            w_long[:, None, :])
        z_long = z_long * w_sel

        xs = flat.reshape(L, 32, 6, 3).transpose(2, 3)  # [L, 32, 3, 6]
        zs = torch.einsum("lswk,nk->lswn", xs, tb["m12"]) * tb["ws"]  # [L, 32, 3, 12]
        z_short = torch.zeros((L, 32, 36), dtype=zs.dtype, device=xr.device)
        for w in range(3):
            z_short[:, :, 6 + 6 * w: 18 + 6 * w] += zs[:, :, w]

        is_short = (block_type == 2).reshape(L, 1, 1)
        z = torch.where(is_short & ~(mixed_f & (sb_ids < 2)), z_short, z_long)

        ov = overlap.reshape(L, 32, 18)
        out = (z[..., :18] + ov) * tb["inv"]
        new_overlap = torch.where(valid.reshape(L, 1, 1), z[..., 18:], ov).reshape(L, GRANULE)

        ff = fifo
        outs = []
        for r in range(18):
            v = out[:, :, r] @ tb["n"].T  # [L, 64]
            ff = torch.cat([v, ff[:, :960]], dim=1)
            u = ff[:, tb["u_idx"]]  # [L, 512]
            outs.append((u * tb["d"]).reshape(L, 16, 32).sum(dim=1))
    pcm = torch.where(valid.reshape(L, 1), torch.stack(outs, dim=1).reshape(L, GRANULE), 0.0)
    new_fifo = torch.where(valid.reshape(L, 1), ff, fifo)
    return pcm, new_overlap, new_fifo


def mp3_synth(xr, block_type, mixed, lane_valid, overlap, fifo):
    """K10: one granule of every channel lane -> (pcm [L, 576],
    new_overlap [L, 576], new_fifo [L, 1024]), float32."""
    if xr.device.type == "cpu":
        return mp3_synth_plain(xr, block_type, mixed, lane_valid, overlap, fifo)
    dev = check_cuda("mp3_synth", xr, block_type, mixed, lane_valid, overlap, fifo)
    L = xr.shape[0]
    if xr.shape != (L, GRANULE) or overlap.shape != (L, GRANULE) or fifo.shape != (L, FIFO) \
            or any(t.shape != (L,) for t in (block_type, mixed, lane_valid)):
        raise ValueError(f"mp3_synth: xr{tuple(xr.shape)} overlap{tuple(overlap.shape)} "
                         f"fifo{tuple(fifo.shape)}; block_type, mixed and lane_valid are [L]")
    if any(t.dtype != torch.float32 for t in (xr, overlap, fifo)) or \
            block_type.dtype != torch.int32 or mixed.dtype != torch.uint8 or \
            lane_valid.dtype != torch.uint8:
        raise TypeError("mp3_synth: xr, overlap and fifo float32, block_type int32, "
                        "mixed and lane_valid uint8")
    pcm = torch.empty((L, GRANULE), dtype=torch.float32, device=dev)
    new_overlap = torch.empty_like(pcm)
    new_fifo = torch.empty((L, FIFO), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_mp3_synth(
        xr.data_ptr(), block_type.data_ptr(), mixed.data_ptr(), lane_valid.data_ptr(),
        overlap.data_ptr(), fifo.data_ptr(), kernel_tables(dev).data_ptr(), pcm.data_ptr(),
        new_overlap.data_ptr(), new_fifo.data_ptr(), L, stream)
    launch_check("mp3_synth", rc)
    mp3_synth.launches += 1
    return pcm, new_overlap, new_fifo


mp3_synth.launches = 0
