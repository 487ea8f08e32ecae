"""Phase-vocoder overlap-add (K16): the windowed synthesis frames summed
into the output line, divided by the window's square summed the same way,
cropped (counterpart of the ``* win`` and the ``lax.scan`` ``ola`` of
``soundkit_tpu/ops/stretch.py::stretch_batch_device`` and the divide,
crop and pad after it).

:func:`overlap_add` takes the irfft output ``frames`` f32 [B, T, F], the
window ``win`` f32 [F], the synthesis hop and the output length
``target``, and returns ``out`` f32 [B, target]: with the line ``hop (T -
1) + F`` long,

    line[b, J] = sum_t win[J - t hop] frame[b, t, J - t hop]
    norm[J]    = sum_t win[J - t hop]^2
    out[b, j]  = line[b, J] / max(norm[J], 1e-8),  J = F/2 + j

over the frames that cover J, added in ascending t, and 0 where J is
past the line. Each product and sum is rounded alone in the scan's order
and the divide is IEEE, so the card and the CPU give the same bits.

For CUDA tensors it launches ``csrc/stretch_ola.cu`` and counts
``overlap_add.launches``: its first kernel builds the norm's divisor once
a call (it does not depend on the lane), the second the output. For CPU
tensors it takes :func:`overlap_add_plain`, the reference's scan: T adds
of a frame into the line and of the window's square into the norm.
"""
from __future__ import annotations

import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.utils.device import check_cuda, launch_check


def overlap_add_plain(frames, win, hop: int, target: int) -> torch.Tensor:
    """:func:`overlap_add` as the reference computes it: the windowed
    frames added one after another into the whole line and the norm, the
    divide, then the crop and pad."""
    B, T, F = frames.shape
    out_len = hop * (T - 1) + F
    frames = frames * win
    out = torch.zeros((B, out_len), dtype=torch.float32, device=frames.device)
    norm = torch.zeros((1, out_len), dtype=torch.float32, device=frames.device)
    win2 = (win * win)[None, :]
    for t in range(T):
        pos = t * hop
        out[:, pos:pos + F] += frames[:, t]
        norm[:, pos:pos + F] += win2
    out = out / torch.clamp_min(norm, 1e-8)
    res = out[:, F // 2:F // 2 + target]
    if res.shape[1] < target:
        res = torch.nn.functional.pad(res, (0, target - res.shape[1]))
    return res


def overlap_add(frames, win, hop: int, target: int) -> torch.Tensor:
    """K16 (see the module's docstring) -> f32 [B, target]. On the card
    ``frames`` f32 [B, T, F] and ``win`` f32 [F] on one CUDA device,
    contiguous; anything else raises."""
    if frames.device.type == "cpu":
        return overlap_add_plain(frames, win, hop, target)
    dev = check_cuda("overlap_add", frames, win)
    B, T, F = frames.shape
    if win.shape != (F,) or hop <= 0 or max(hop * (T - 1) + F, F // 2 + target) >= 2 ** 31:
        raise ValueError(f"overlap_add: frames{tuple(frames.shape)} win{tuple(win.shape)} "
                         f"hop {hop} target {target}; want frames [B, T, F], win [F], hop > 0, "
                         "a line shorter than 2^31 samples")
    if frames.dtype != torch.float32 or win.dtype != torch.float32:
        raise TypeError("overlap_add: frames and win must be float32")
    den = torch.empty(target, dtype=torch.float32, device=dev)
    out = torch.empty((B, target), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_stretch_ola(
        frames.data_ptr(), win.data_ptr(), den.data_ptr(), out.data_ptr(), B, T, F, hop,
        F // 2, target, stream)
    launch_check("overlap_add", rc)
    overlap_add.launches += 1
    return out


overlap_add.launches = 0
