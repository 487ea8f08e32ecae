"""G.722 sub-band ADPCM scans, 64 kbit/s mode 1 (counterpart of
``soundkit_tpu/ops/g722.py``).

The state is one int32 tensor ``[B, 70]`` per batch (:data:`G722_LAYOUT`,
the fields of the JAX package's ``G722State`` in order; band dim 0 =
low, 1 = high). A decode step turns one code into two 16 kHz samples
(low- and high-band ADPCM, the shared predictor update ``_block4``, the
24-tap QMF synthesis); an encode step turns two samples into one code.
A masked step freezes the lane's state and writes 0.

- :func:`g722_decode_scan` and :func:`g722_encode_scan` (K7) run
  ``csrc/g722.cu`` for CUDA tensors: a lane is two groups of eight
  threads, a band each and a predictor tap a thread; tiles of steps go
  through shared memory and the QMF is a FIR over the tile, off the
  recurrence;
- the plain scans are a Python loop over N of the vectorized steps.

The tables are copies of the JAX package's. Each
wrapper takes its plain version for tensors on the CPU and launches the
kernel for CUDA tensors; ``launches`` counts the launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from soundkit_tpu_torch.ops.scan_state import StateLayout, launch_scan
from soundkit_tpu_torch.utils.device import tensor_device

WL = np.array([-60, -30, 58, 172, 334, 538, 1198, 3042], dtype=np.int32)
RL42 = np.array([0, 7, 6, 5, 4, 3, 2, 1, 7, 6, 5, 4, 3, 2, 1, 0], dtype=np.int32)
ILB = np.array(
    [2048, 2093, 2139, 2186, 2233, 2282, 2332, 2383, 2435, 2489, 2543, 2599,
     2656, 2714, 2774, 2834, 2896, 2960, 3025, 3091, 3158, 3228, 3298, 3371,
     3444, 3520, 3597, 3676, 3756, 3838, 3922, 4008],
    dtype=np.int32,
)
WH = np.array([0, -214, 798], dtype=np.int32)
RH2 = np.array([2, 1, 2, 1], dtype=np.int32)
QM2 = np.array([-7408, -1616, 7408, 1616], dtype=np.int32)
QM4 = np.array(
    [0, -20456, -12896, -8968, -6288, -4240, -2584, -1200,
     20456, 12896, 8968, 6288, 4240, 2584, 1200, 0],
    dtype=np.int32,
)
QM6 = np.array(
    [-136, -136, -136, -136, -24808, -21904, -19008, -16704, -14984, -13512,
     -12280, -11192, -10232, -9360, -8576, -7856, -7192, -6576, -6000, -5456,
     -4944, -4464, -4008, -3576, -3168, -2776, -2400, -2032, -1688, -1360,
     -1040, -728, 24808, 21904, 19008, 16704, 14984, 13512, 12280, 11192,
     10232, 9360, 8576, 7856, 7192, 6576, 6000, 5456, 4944, 4464, 4008, 3576,
     3168, 2776, 2400, 2032, 1688, 1360, 1040, 728, 432, 136, -432, -136],
    dtype=np.int32,
)
QMF_COEFFS = np.array(
    [3, -11, 12, 32, -210, 951, 3876, -805, 362, -156, 53, -11], dtype=np.int32
)

# encoder tables
Q6 = np.array(
    [0, 35, 72, 110, 150, 190, 233, 276, 323, 370, 422, 473, 530, 587, 650,
     714, 786, 858, 940, 1023, 1121, 1219, 1339, 1458, 1612, 1765, 1980, 2195,
     2557, 2919, 0, 0],
    dtype=np.int32,
)
ILN = np.array(
    [0, 63, 62, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
     16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 0],
    dtype=np.int32,
)
ILP = np.array(
    [0, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49, 48, 47, 46, 45,
     44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32, 0],
    dtype=np.int32,
)
IHN = np.array([0, 1, 0], dtype=np.int32)
IHP = np.array([0, 3, 2], dtype=np.int32)

G722_LAYOUT = StateLayout((
    ("x", (24,)), ("s", (2,)), ("sp", (2,)), ("sz", (2,)), ("r", (2, 2)), ("p", (2, 2)),
    ("a", (2, 2)), ("b", (2, 6)), ("d", (2, 6)), ("nb", (2,)), ("det", (2,)),
))

I32 = torch.int32
_TABLES = ("WL", "RL42", "ILB", "WH", "RH2", "QM2", "QM4", "QM6", "QMF_COEFFS",
           "Q6", "ILN", "ILP", "IHN", "IHP")


def g722_init_state(batch: int, device="cuda") -> torch.Tensor:
    """Initial state ``[batch, 70]`` on ``device``: low-band det 0,
    high-band det 8."""
    row = torch.zeros(G722_LAYOUT.width, dtype=I32)
    G722_LAYOUT.views(row[None]).det[0, 1] = 8
    return row.expand(batch, -1).contiguous().to(tensor_device(device))


@functools.lru_cache(maxsize=4)
def _t(device: torch.device):
    return {k: torch.from_numpy(globals()[k]).to(device) for k in _TABLES}


def _sat(v):
    return v.clamp(-32768, 32767)


def _block4(st, d):
    """Shared predictor update for both bands; d: [B, 2]. Returns the
    new (s, sp, sz, r, p, a, b, d) fields."""
    r0 = _sat(st.s + d)
    p0 = _sat(st.sz + d)

    # UPPOL2
    sg0 = p0 >> 15
    sg1 = st.p[:, :, 0] >> 15
    sg2 = st.p[:, :, 1] >> 15
    a1, a2 = st.a[:, :, 0], st.a[:, :, 1]
    wd1 = _sat(a1 << 2)
    wd2 = torch.where(sg0 == sg1, -wd1, wd1).clamp_max(32767)
    wd3 = (wd2 >> 7) + torch.where(sg0 == sg2, 128, -128).to(I32)
    wd3 = wd3 + ((a2 * 32512) >> 15)
    ap2 = wd3.clamp(-12288, 12288)

    # UPPOL1
    wd1b = torch.where(sg0 == sg1, 192, -192).to(I32)
    wd2b = (a1 * 32640) >> 15
    ap1 = _sat(wd1b + wd2b)
    wd3b = _sat(15360 - ap2)
    ap1 = torch.clamp(ap1, -wd3b, wd3b)

    # UPZERO
    wd1c = torch.where(d == 0, 0, 128).to(I32)[:, :, None]
    sgd0 = (d >> 15)[:, :, None]
    wd2c = torch.where((st.d >> 15) == sgd0, wd1c, -wd1c)
    wd3c = (st.b * 32640) >> 15
    bp = _sat(wd2c + wd3c)

    # DELAY
    d_new = torch.cat([d[:, :, None], st.d[:, :, :5]], dim=-1)
    r_new = torch.stack([r0, st.r[:, :, 0]], dim=-1)
    p_new = torch.stack([p0, st.p[:, :, 0]], dim=-1)
    a_new = torch.stack([ap1, ap2], dim=-1)

    # FILTEP
    wd1d = (ap1 * _sat(r_new[:, :, 0] * 2)) >> 15
    wd2d = (ap2 * _sat(r_new[:, :, 1] * 2)) >> 15
    sp = _sat(wd1d + wd2d)

    # FILTEZ
    sz = _sat(((bp * _sat(d_new * 2)) >> 15).sum(-1, dtype=I32))
    s = _sat(sp + sz)
    return dict(s=s, sp=sp, sz=sz, r=r_new, p=p_new, a=a_new, b=bp, d=d_new)


def _scale(nb, high: bool):
    """SCALEL / SCALEH: nb -> det."""
    wd1 = (nb >> 6) & 31
    wd2 = (10 if high else 8) - (nb >> 11)
    base = _t(nb.device)["ILB"][wd1.long()]
    wd3 = torch.where(wd2 < 0, base << (-wd2).clamp_min(0), base >> wd2.clamp_min(0))
    return wd3 << 2


def _adapt(t, st, ril, ihigh):
    """The band predictors' inputs and the new (nb, det) for both bands."""
    det_l, det_h = st.det[:, 0], st.det[:, 1]
    dlowt = (det_l * t["QM4"][ril.long()]) >> 15
    il4 = t["RL42"][ril.long()]
    nb_l = (((st.nb[:, 0] * 127) >> 7) + t["WL"][il4.long()]).clamp(0, 18432)
    dhigh = (det_h * t["QM2"][ihigh.long()]) >> 15
    ih2 = t["RH2"][ihigh.long()]
    nb_h = (((st.nb[:, 1] * 127) >> 7) + t["WH"][ih2.long()]).clamp(0, 22528)
    nb = torch.stack([nb_l, nb_h], dim=-1)
    det = torch.stack([_scale(nb_l, False), _scale(nb_h, True)], dim=-1)
    return torch.stack([dlowt, dhigh], dim=-1), nb, det


def _qmf(xq, t):
    """(sum over even taps, sum over odd taps) of the 24-tap delay line."""
    h = t["QMF_COEFFS"]
    return (xq[:, 0::2] * h).sum(-1, dtype=I32), (xq[:, 1::2] * h.flip(0)).sum(-1, dtype=I32)


def _finish(state, new, out, valid):
    if valid is None:
        return new, out
    v = valid[:, None] if out.dim() == 2 else valid
    return torch.where(valid[:, None], new, state), torch.where(v, out, 0).to(out.dtype)


def g722_decode_step(state, code, valid=None):
    """One code -> two 16 kHz samples per lane: (new state [B, 70], pcm i16 [B, 2])."""
    t = _t(state.device)
    st = G722_LAYOUT.views(state)
    code = code.to(I32)
    wd1 = code & 0x3F
    ihigh = (code >> 6) & 0x03
    ril = wd1 >> 2

    wd2 = (st.det[:, 0] * t["QM6"][wd1.long()]) >> 15
    rlow = (st.s[:, 0] + wd2).clamp(-16384, 16383)
    d, nb, det = _adapt(t, st, ril, ihigh)
    rhigh = (d[:, 1] + st.s[:, 1]).clamp(-16384, 16383)

    # QMF synthesis
    xq = torch.cat([st.x[:, 2:], (rlow + rhigh)[:, None], (rlow - rhigh)[:, None]], dim=-1)
    xout2, xout1 = _qmf(xq, t)
    pcm = torch.stack([_sat(xout1 >> 11), _sat(xout2 >> 11)], dim=-1).to(torch.int16)
    new = G722_LAYOUT.pack(state.shape[0], x=xq, nb=nb, det=det, **_block4(st, d))
    return _finish(state, new, pcm, valid)


def g722_encode_step(state, samples, valid=None):
    """Two 16 kHz samples [B, 2] -> one code per lane: (new state, code u8 [B])."""
    t = _t(state.device)
    st = G722_LAYOUT.views(state)
    xq = torch.cat([st.x[:, 2:], samples.to(I32)], dim=-1)
    sumeven, sumodd = _qmf(xq, t)
    xlow = (sumeven + sumodd) >> 14
    xhigh = (sumeven - sumodd) >> 14
    det_l, det_h = st.det[:, 0], st.det[:, 1]

    # low band quantize: 30-level decision ladder
    el = _sat(xlow - st.s[:, 0])
    wd = torch.where(el >= 0, el, -(el + 1))
    thr = (t["Q6"][None, 1:30] * det_l[:, None]) >> 12
    i = 1 + (wd[:, None] >= thr).sum(-1, dtype=I32)
    ilow = torch.where(el < 0, t["ILN"][i.long()], t["ILP"][i.long()])

    # high band quantize
    eh = _sat(xhigh - st.s[:, 1])
    wdh = torch.where(eh >= 0, eh, -(eh + 1))
    mih = torch.where(wdh >= ((564 * det_h) >> 12), 2, 1).long()
    ihigh = torch.where(eh < 0, t["IHN"][mih], t["IHP"][mih])

    d, nb, det = _adapt(t, st, ilow >> 2, ihigh)
    new = G722_LAYOUT.pack(state.shape[0], x=xq, nb=nb, det=det, **_block4(st, d))
    code = ((ihigh << 6) | ilow).to(torch.uint8)
    return _finish(state, new, code, valid)


def g722_decode_scan_plain(codes, state, valid=None):
    B, N = codes.shape
    pcm = torch.empty((B, N, 2), dtype=torch.int16, device=codes.device)
    valid = None if valid is None else valid.to(torch.bool)
    for n in range(N):
        state, pcm[:, n] = g722_decode_step(state, codes[:, n],
                                            None if valid is None else valid[:, n])
    return pcm.reshape(B, 2 * N), state


def g722_encode_scan_plain(samples, state, valid=None):
    B, n2 = samples.shape
    pairs = samples.reshape(B, n2 // 2, 2)
    codes = torch.empty((B, n2 // 2), dtype=torch.uint8, device=samples.device)
    valid = None if valid is None else valid.to(torch.bool)
    for n in range(n2 // 2):
        state, codes[:, n] = g722_encode_step(state, pairs[:, n],
                                              None if valid is None else valid[:, n])
    return codes, state


def g722_decode_scan(codes, state, valid=None):
    """K7 decode: codes [B, N] (u8 on CUDA), state i32 [B, 70], optional
    valid bool [B, N] -> (pcm i16 [B, 2N], final state)."""
    if codes.device.type == "cpu":
        return g722_decode_scan_plain(codes, state, valid)
    B, N = codes.shape
    res = launch_scan("g722_decode_scan", "skt_g722_scan", G722_LAYOUT, codes, torch.uint8,
                      state, valid, N, (B, 2 * N), torch.int16, 0)
    g722_decode_scan.launches += 1
    return res


def g722_encode_scan(samples, state, valid=None):
    """K7 encode: samples [B, 2N] (i16 on CUDA), state i32 [B, 70],
    optional valid bool [B, N] (one flag per code) -> (codes u8 [B, N],
    final state)."""
    if samples.device.type == "cpu":
        return g722_encode_scan_plain(samples, state, valid)
    if samples.shape[1] % 2:
        raise ValueError("g722_encode_scan: an even number of samples per lane")
    B, N = samples.shape[0], samples.shape[1] // 2
    res = launch_scan("g722_encode_scan", "skt_g722_scan", G722_LAYOUT, samples, torch.int16,
                      state, valid, N, (B, N), torch.uint8, 1)
    g722_encode_scan.launches += 1
    return res


g722_decode_scan.launches = 0
g722_encode_scan.launches = 0
