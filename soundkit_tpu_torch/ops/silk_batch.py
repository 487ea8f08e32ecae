"""Batched SILK synthesis for 20 ms Opus SILK frames in PyTorch
(counterpart of ``soundkit_tpu/ops/silk_batch.py``).

The host walk (``native_src/src/silk_parse.cpp``, ``skt_silk_parse_many``)
range-decodes every lane's frame and exports the synthesis inputs; one
:func:`silk_round` takes them for ``[B, 2]`` rows of one bandwidth group
to 48 kHz PCM with carried device state:

- the fresh lanes' and the reset side channels' state zeroed;
- the per-sample LTP/LPC synthesis: K12 (``ops.silk_synth.silk_synth``)
  on the card, its plain version on the CPU;
- the ``act`` masks (a channel the packet coded, on a valid lane), the
  stereo mid/side unmix with its ``n1``-sample weight interpolation, and
  the clip;
- the polyphase resample to 48 kHz with the probed taps of the JAX
  package's libswresample-matched resampler, and its probed slot-0
  correction on fresh lanes. Both are float32 products (the gather and
  taps as one [T + 4 sfl, 960] matrix), run in IEEE float32 whatever the
  caller's TF32 settings (:func:`utils.device.ieee_fp32`), as the
  reference computes them in float32.

The probed taps come from a committed table, ``data/silk_resampler.npz``
(made on the test side from the JAX package's ``resampler_taps``,
``_resample_plan`` and ``first_slot_correction``, and held to them bit
for bit): the port links no FFmpeg. :func:`resampler_taps` and
:func:`first_slot_correction` read it; ``_resample_plan`` and
:func:`lead_invalid` are verbatim copies of the reference's.

The JAX package's R-round ``lax.scan`` (``_jitted_scan``, the hybrid
chunk) is a host loop over :func:`silk_round` here.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from soundkit_tpu_torch.codecs.opus_tables import tables
from soundkit_tpu_torch.ops.silk_synth import silk_synth
from soundkit_tpu_torch.utils.device import ieee_fp32, tensor_device

LTP_ORDER = 5
HIST = 322            # silk_parse.cpp SILK_HISTORY
MAXLAG = 290          # silk_parse.cpp SILK_MAX_LAG
SUBFRAMES = 4         # 20 ms packets (the batched serving shape)
FRAME48 = 960

# per-bandwidth static geometry: internal rate, subframe length
SFL = (40, 60, 80)
ORDER = (10, 10, 16)
RATE = (8000, 12000, 16000)

TABLE_PATH = Path(__file__).resolve().parents[1] / "data" / "silk_resampler.npz"


@functools.lru_cache(maxsize=1)
def _table() -> dict:
    with np.load(TABLE_PATH) as z:
        return {k: z[k] for k in z.files}


def resampler_taps(bw: int) -> Tuple[np.ndarray, int]:
    """The probed polyphase taps of the reference's resampler at ``bw``:
    (taps [R, J] float64, off) such that its stream is
    y[off + R*n + p] = sum_j taps[p, j] * x[n - j]."""
    t = _table()
    return t[f"taps_{bw}"], int(t[f"off_{bw}"])


def _resample_plan(bw: int):
    """Static gather/tap matrices for one frame's 960-sample slot.

    Slot f covers y[960f + off_, 960(f+1) + off_) with
    off_ = min(off, 0); the first slot's leading |off_| samples are
    stream-invalid (the model accounts for them in lengths)."""
    taps, off = resampler_taps(bw)
    R, J = taps.shape
    off_ = min(off, 0)
    s = np.arange(FRAME48)
    q = (off_ + s - off) // R
    p = (off_ + s - off) % R
    T = max(0, int(-(q.min() - (J - 1))))  # input tail length
    idx = q[:, None] - np.arange(J)[None, :] + T          # [960, J]
    tap_m = taps[p]                                       # [960, J]
    lead_invalid = -off_
    return idx.astype(np.int32), tap_m, T, lead_invalid


def first_slot_correction(bw: int) -> np.ndarray:
    """The probed slot-0 correction ``C [960, K0]`` of the reference's
    resampler stream start (added once on a lane's first round:
    ``y_slot0 = plan(x) + x[:K0] @ C.T``)."""
    return _table()[f"C_{bw}"]


@functools.lru_cache(maxsize=16)
def _resample_matrices(bw: int, device: torch.device, dtype: torch.dtype = torch.float32):
    """(M [T + 4 sfl, 960], C^T [K0, 960] or None where C is all zero) of
    ``dtype`` on ``device``: ``x_ext @ M`` is the plan's gather-and-tap
    product ``sum_j x_ext[idx[s, j]] tap_m[s, j]``, the taps rounded to
    ``dtype`` as the reference rounds them."""
    idx, tap_m, T, _ = _resample_plan(bw)
    L = T + SUBFRAMES * SFL[bw]
    nd = np.float64 if dtype == torch.float64 else np.float32
    m = np.zeros((L, FRAME48), nd)
    s = np.arange(FRAME48)
    for j in range(idx.shape[1]):
        m[idx[:, j], s] += tap_m[:, j].astype(nd)
    corr = first_slot_correction(bw)
    ct = None if not corr.any() else torch.from_numpy(np.ascontiguousarray(corr.T.astype(nd))).to(device)
    return torch.from_numpy(m).to(device), ct


def silk_round(bw: int, stereo: bool, exc, gains, coef, has_leadin, voiced, lags, ltp,
               ltpscale, ch_coded, unmix, side_reset, stereo_w, gain48, valid, fresh,
               out_hist, lpch_tail, rs_tail):
    """One lockstep 20 ms round for one bandwidth group, all tensors on
    one device.

    exc f32 [B, 2, 320], gains f32 [B, 2, 4], coef f32 [B, 2, 2, 16],
    has_leadin / voiced i32 [B, 2], lags i32 [B, 2, 4], ltp f32
    [B, 2, 4, 5], ltpscale f32 [B, 2]: the parse's export;
    ch_coded i32 [B, 2] (the packet coded that channel), unmix i32 [B]
    (the packet coded stereo: a mid-only packet still unmixes, with the
    zeroed side history), side_reset i32 [B], stereo_w f32 [B, 4],
    gain48 f32 [B] (the OpusHead gain), valid bool [B] (the lane is in
    this group and has a frame), fresh f32 [B] (the lane's first round:
    zero state and the slot-0 correction); the carried state out_hist
    f32 [B, 2, 322], lpch_tail f32 [B, 2, 16], rs_tail f32 [B, 2, T].

    Returns (pcm48 f32 [B, 2, 960], out_hist, lpch_tail, rs_tail): an
    invalid lane gives zeros and keeps its state; a mono group duplicates
    its channel across the two (the model slices its channel count)."""
    B = exc.shape[0]
    dev = exc.device
    flen = SFL[bw] * SUBFRAMES
    n1 = int(tables()["silk_stereo_interp_len"][bw])
    one = torch.ones((), dtype=exc.dtype, device=dev)
    # fresh lanes (first round after recycle) start from zero state
    fr = (fresh != 0)[:, None, None]
    out_hist = torch.where(fr, 0.0, out_hist)
    lpch_tail = torch.where(fr, 0.0, lpch_tail)
    rs_tail = torch.where(fr, 0.0, rs_tail)
    zero_side = (side_reset != 0)[:, None, None] & (torch.arange(2, device=dev) == 1)[None, :, None]
    out_hist = torch.where(zero_side, 0.0, out_hist)
    lpch_tail = torch.where(zero_side, 0.0, lpch_tail)

    dst, lpch2 = silk_synth(bw, exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale,
                            out_hist, lpch_tail)
    act = ((ch_coded != 0) & valid[:, None])[..., None]
    new_hist = torch.where(act, dst[..., flen:], out_hist)
    new_lpch = torch.where(act, lpch2, lpch_tail)

    # mono path: the 2-sample-delayed mid channel
    mono = dst[:, 0, HIST - 2: HIST - 2 + flen]
    if stereo:
        # windows [B, flen+2] over the post-shift history; frozen
        # channels read their (unshifted) carried history instead
        def win(c):
            live = dst[:, c, HIST - 2: HIST + flen]
            froz = out_hist[:, c, HIST - flen - 2: HIST]
            return torch.where(act[:, c], live, froz)

        mid, side = win(0), win(1)
        cgrid = torch.arange(flen, device=dev)
        w0p, w1p = stereo_w[:, 0:1], stereo_w[:, 1:2]
        w0, w1 = stereo_w[:, 2:3], stereo_w[:, 3:4]
        t = torch.clamp(cgrid, max=n1).to(exc.dtype) / n1
        i0 = w0p + t * (w0 - w0p)
        i1 = w1p + t * (w1 - w1p)
        p0 = 0.25 * (mid[:, :-2] + 2.0 * mid[:, 1:-1] + mid[:, 2:])
        m1 = mid[:, 1:-1]
        s1 = side[:, 1:-1]
        left = torch.clamp((1.0 + i1) * m1 + s1 + i0 * p0, -one, one)
        right = torch.clamp((1.0 - i1) * m1 - s1 - i0 * p0, -one, one)
        # packet-coded-stereo drives the unmix: a midonly packet (side
        # frame absent, ch_coded[:,1]==0) still unmixes with the zeroed
        # side history
        st_flag = (unmix != 0)[:, None]
        pcm = torch.stack([torch.where(st_flag, left, mono),
                           torch.where(st_flag, right, mono)], dim=1)
    else:
        # mono group: duplicate across the fixed 2-channel state axis
        pcm = torch.stack([mono, mono], dim=1)

    # polyphase resample to 48 kHz (probed oracle taps), plus the probed
    # time-varying stream-start correction on fresh lanes
    x_ext = torch.cat([rs_tail, pcm], dim=-1)
    m, ct = _resample_matrices(bw, dev, exc.dtype)
    with ieee_fp32():
        y = (x_ext.reshape(B * 2, -1) @ m).reshape(B, 2, FRAME48)
        if ct is not None:
            K0 = ct.shape[0]
            corr = (pcm[..., :K0].reshape(B * 2, K0) @ ct).reshape(B, 2, FRAME48)
            y = y + fresh[:, None, None] * corr
    y = y * gain48[:, None, None]
    new_tail = x_ext[..., x_ext.shape[-1] - rs_tail.shape[-1]:]
    v3 = valid[:, None, None]
    return (torch.where(v3, y, 0.0), torch.where(v3, new_hist, out_hist),
            torch.where(v3, new_lpch, lpch_tail), torch.where(v3, new_tail, rs_tail))


def init_state(B: int, bw: int, device="cuda"):
    """Zero carried state for one bandwidth group on ``device``:
    (out_hist [B,2,HIST], lpch_tail [B,2,16], rs_tail [B,2,T]) f32."""
    dev = tensor_device(device)
    _, _, T, _ = _resample_plan(bw)
    return tuple(torch.zeros(shape, dtype=torch.float32, device=dev)
                 for shape in ((B, 2, HIST), (B, 2, 16), (B, 2, T)))


def lead_invalid(bw: int) -> int:
    """Stream-invalid leading samples in a lane's FIRST 48 kHz slot
    (negative resampler offset at this bandwidth)."""
    return _resample_plan(bw)[3]
