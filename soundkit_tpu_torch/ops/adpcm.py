"""G.726 ADPCM predictor scans (counterpart of ``soundkit_tpu/ops/adpcm.py``).

The state is one int32 tensor ``[B, 24]`` per batch (:data:`G726_LAYOUT`,
the fields of the JAX package's ``G726State`` in order). A step
advances every lane by one code with elementwise integer arithmetic;
a per-step validity mask freezes a lane's state and writes 0.

- :func:`g726_decode_scan` and :func:`g726_encode_scan` (K6) run
  ``csrc/g726.cu`` for CUDA tensors: a group of eight threads per lane
  walks all N steps with the state in registers, codes and outputs
  staged through shared-memory tiles;
- the plain scans are a Python loop over N of the vectorized steps
  (:func:`g726_decode_step`, :func:`g726_encode_step`).

The per-rate tables (:func:`g726_tables`) are copies of the JAX package's.
Each wrapper takes its plain version for tensors on the CPU and
launches the kernel for CUDA tensors; ``launches`` counts the launches.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from soundkit_tpu_torch.ops.scan_state import StateLayout, launch_scan
from soundkit_tpu_torch.utils.device import tensor_device

POWER2 = np.array([1 << i for i in range(15)], dtype=np.int32)

# Per-rate tables, keyed by code bits
_G726_TABLES = {
    2: dict(
        q=[261],
        dqln=[116, 365, 365, 116],
        wi=[-22, 439, 439, -22],
        fi=[0, 0xE00, 0xE00, 0],
    ),
    3: dict(
        q=[8, 218, 331],
        dqln=[-2048, 135, 273, 373, 373, 273, 135, -2048],
        wi=[-4, 30, 137, 582, 582, 137, 30, -4],
        fi=[0, 0x200, 0x400, 0xE00, 0xE00, 0x400, 0x200, 0],
    ),
    4: dict(
        q=[-124, 80, 178, 246, 300, 349, 400],
        dqln=[-2048, 4, 135, 213, 273, 323, 373, 425, 425, 373, 323, 273, 213, 135, 4, -2048],
        wi=[-12, 18, 41, 64, 112, 198, 355, 1122, 1122, 355, 198, 112, 64, 41, 18, -12],
        fi=[0, 0, 0, 0x200, 0x200, 0x200, 0x600, 0xE00,
            0xE00, 0x600, 0x200, 0x200, 0x200, 0, 0, 0],
    ),
    5: dict(
        q=[-122, -16, 68, 139, 198, 250, 298, 339, 378, 413, 445, 475, 502, 528, 553],
        dqln=[-2048, -66, 28, 104, 169, 224, 274, 318, 358, 395, 429, 459, 488, 514, 539,
              566, 566, 539, 514, 488, 459, 429, 395, 358, 318, 274, 224, 169, 104, 28,
              -66, -2048],
        wi=[14, 14, 24, 39, 40, 41, 58, 100, 141, 179, 219, 280, 358, 440, 529, 696,
            696, 529, 440, 358, 280, 219, 179, 141, 100, 58, 41, 40, 39, 24, 14, 14],
        fi=[0, 0, 0, 0, 0, 0x200, 0x200, 0x200, 0x200, 0x200, 0x400, 0x600, 0x800,
            0xA00, 0xC00, 0xC00, 0xC00, 0xC00, 0xA00, 0x800, 0x600, 0x400, 0x200,
            0x200, 0x200, 0x200, 0x200, 0, 0, 0, 0, 0],
    ),
}


def g726_tables(bits: int) -> Dict[str, np.ndarray]:
    t = _G726_TABLES[bits]
    return {k: np.asarray(v, dtype=np.int32) for k, v in t.items()}

G726_LAYOUT = StateLayout((
    ("yl", ()), ("yu", ()), ("dms", ()), ("dml", ()), ("ap", ()),
    ("a", (2,)), ("b", (6,)), ("pk", (2,)), ("dq", (6,)), ("sr", (2,)), ("td", ()),
))

I32 = torch.int32


def g726_init_state(batch: int, device="cuda") -> torch.Tensor:
    """Default-reset state ``[batch, 24]`` on ``device``."""
    row = torch.zeros(G726_LAYOUT.width, dtype=I32)
    st = G726_LAYOUT.views(row[None])
    st.yl[:] = 34816
    st.yu[:] = 544
    st.dq[:] = 32
    st.sr[:] = 32
    return row.expand(batch, -1).contiguous().to(tensor_device(device))


@functools.lru_cache(maxsize=16)
def _tables(bits: int, device: torch.device):
    t = g726_tables(bits)
    return {k: torch.from_numpy(v).to(device) for k, v in t.items()}


@functools.lru_cache(maxsize=4)
def _power2(device: torch.device):
    return torch.from_numpy(POWER2).to(device)


def _quan_power2(value):
    """Count of ``2^i <= value`` over i in 0..14."""
    return (value[..., None] >= _power2(value.device)).sum(-1, dtype=I32)


def _fmult(an, srn):
    """Float-format multiply."""
    anmag = torch.where(an > 0, an, (-an) & 0x1FFF)
    anexp = _quan_power2(anmag) - 6
    anmant = torch.where(
        anmag == 0, 32,
        torch.where(anexp >= 0, anmag >> anexp.clamp_min(0), anmag << (-anexp).clamp_min(0)))
    wanexp = anexp + ((srn >> 6) & 0x0F) - 13
    wanmant = (anmant * (srn & 0x3F) + 0x30) >> 4
    retval = torch.where(wanexp >= 0, (wanmant << wanexp.clamp_min(0)) & 0x7FFF,
                         wanmant >> (-wanexp).clamp_min(0))
    return torch.where((an ^ srn) < 0, -retval, retval)


def _predict(st):
    """(sez, se): the zero predictor and the full prediction (the six
    zero and two pole products in one elementwise call)."""
    prod = _fmult(torch.cat([st.b, st.a], -1) >> 2, torch.cat([st.dq, st.sr], -1))
    sezi = prod[:, :6].sum(-1, dtype=I32)
    pole = prod[:, 6:].sum(-1, dtype=I32)
    return sezi >> 1, (sezi + pole) >> 1


def _step_size(st):
    y = st.yl >> 6
    dif = st.yu - y
    al = st.ap >> 2
    mixed = torch.where(dif > 0, y + ((dif * al) >> 6),
                        torch.where(dif < 0, y + ((dif * al + 0x3F) >> 6), y))
    return torch.where(st.ap >= 256, st.yu, mixed)


def _reconstruct(sign, dqln, y):
    dql = dqln + (y >> 2)
    dex = (dql >> 7) & 15
    dqt = 128 + (dql & 127)
    dq_pos = (dqt << 7) >> (14 - dex)
    neg_case = torch.where(sign, -0x8000, 0)
    pos_case = torch.where(sign, dq_pos - 0x8000, dq_pos)
    return torch.where(dql < 0, neg_case, pos_case).to(I32)


def _float_format(v):
    exp = _quan_power2(v)
    return (exp << 6) + ((v << 6) >> exp)


def _update(st, y, wi, fi, dq, sr, dqsez, bits: int):
    """The new state of every lane (unmasked)."""
    pk0 = (dqsez < 0).to(I32)
    mag = dq & 0x7FFF

    ylint = st.yl >> 15
    ylfrac = (st.yl >> 10) & 0x1F
    thr1 = (32 + ylfrac) << ylint
    thr2 = torch.where(ylint > 9, 31 << 10, thr1)
    dqthr = (thr2 + (thr2 >> 1)) >> 1
    tr = (st.td != 0) & (mag > dqthr)

    yu = (y + ((wi - y) >> 5)).clamp(544, 5120)
    yl = st.yl + yu + ((-st.yl) >> 6)

    # pole/zero adaptation (the tr == 0 branch), then zeroed where tr
    pks1 = pk0 ^ st.pk[:, 0]
    a2p = st.a[:, 1] - (st.a[:, 1] >> 7)
    fa1 = torch.where(pks1 != 0, st.a[:, 0], -st.a[:, 0])
    a2p_adj = torch.where(fa1 < -8191, a2p - 0x100,
                          torch.where(fa1 > 8191, a2p + 0xFF, a2p + (fa1 >> 5)))
    a2p_clamped = torch.where(
        (pk0 ^ st.pk[:, 1]) != 0,
        torch.where(a2p_adj <= -12160, -12288,
                    torch.where(a2p_adj >= 12416, 12288, a2p_adj - 0x80)),
        torch.where(a2p_adj <= -12416, -12288,
                    torch.where(a2p_adj >= 12160, 12288, a2p_adj + 0x80)))
    a2p_new = torch.where(dqsez != 0, a2p_clamped, a2p)

    a1 = st.a[:, 0] - (st.a[:, 0] >> 8)
    a1 = torch.where(dqsez != 0, torch.where(pks1 == 0, a1 + 192, a1 - 192), a1)
    a1ul = 15360 - a2p_new
    a1 = torch.clamp(a1, -a1ul, a1ul)

    decay_shift = 9 if bits == 5 else 8
    b_decayed = st.b - (st.b >> decay_shift)
    dq_nonzero = (mag != 0)[:, None]
    same_sign = (dq[:, None] ^ st.dq) >= 0
    b_new = torch.where(dq_nonzero,
                        torch.where(same_sign, b_decayed + 128, b_decayed - 128), b_decayed)

    a_new = torch.where(tr[:, None], 0, torch.stack([a1, a2p_new], dim=-1))
    b_new = torch.where(tr[:, None], 0, b_new)
    a2p_eff = torch.where(tr, 0, a2p_new)

    # dq history push (float format)
    exp_mag = _quan_power2(mag)
    val = (exp_mag << 6) + ((mag << 6) >> exp_mag)
    dq0 = torch.where(mag == 0, torch.where(dq >= 0, 0x20, -0x3E0),
                      torch.where(dq >= 0, val, val - 0x400))
    # sr history push
    sr0 = torch.where(
        sr == 0, 0x20,
        torch.where(sr > 0, _float_format(sr.clamp_min(0)),
                    torch.where(sr > -32768, _float_format((-sr).clamp_min(0)) - 0x400, -0x3E0)))

    td = torch.where(tr, 0, (a2p_eff < -11776).to(I32))
    dms = st.dms + ((fi - st.dms) >> 5)
    dml = st.dml + (((fi << 2) - st.dml) >> 7)
    ap_up = st.ap + ((0x200 - st.ap) >> 4)
    ap_down = st.ap + ((-st.ap) >> 4)
    fast = (y < 1536) | (td != 0) | (((dms << 2) - dml).abs() >= (dml >> 3))
    ap = torch.where(tr, 256, torch.where(fast, ap_up, ap_down))

    return G726_LAYOUT.pack(
        st.yl.shape[0], yl=yl, yu=yu, dms=dms, dml=dml, ap=ap, a=a_new, b=b_new,
        pk=torch.stack([pk0, st.pk[:, 0]], dim=-1),
        dq=torch.cat([dq0[:, None], st.dq[:, :5]], dim=-1),
        sr=torch.stack([sr0, st.sr[:, 0]], dim=-1), td=td)


def _finish(state, new, out, valid):
    if valid is None:
        return new, out
    return torch.where(valid[:, None], new, state), torch.where(valid, out, 0).to(out.dtype)


def g726_decode_step(state, code, bits: int, valid=None):
    """One decode step for all lanes: (new state [B, 24], pcm i16 [B])."""
    t = _tables(bits, state.device)
    st = G726_LAYOUT.views(state)
    i = code.to(I32) & ((1 << bits) - 1)
    ii = i.long()
    sez, se = _predict(st)
    y = _step_size(st)
    dq = _reconstruct((i & (1 << (bits - 1))) != 0, t["dqln"][ii], y)
    dq_mask = 0x7FFF if bits == 5 else 0x3FFF
    sr = torch.where(dq < 0, se - (dq & dq_mask), se + dq)
    dqsez = sr - se + sez
    new = _update(st, y, t["wi"][ii] << 5, t["fi"][ii], dq, sr, dqsez, bits)
    pcm = (sr << 2).clamp(-32768, 32767).to(torch.int16)
    return _finish(state, new, pcm, valid)


def g726_encode_step(state, sample, bits: int, valid=None):
    """One encode step for all lanes: (new state [B, 24], code u8 [B])."""
    t = _tables(bits, state.device)
    st = G726_LAYOUT.views(state)
    code_mask = (1 << bits) - 1
    sl = sample.to(I32) >> 2
    sez, se = _predict(st)
    d = sl - se
    y = _step_size(st)

    # quantize
    dqm = d.abs()
    exp = _quan_power2(dqm >> 1)
    mant = ((dqm << 7) >> exp) & 0x7F
    dln = (exp << 7) + mant - (y >> 2)
    qi = (dln[:, None] >= t["q"]).sum(-1, dtype=I32)
    i = torch.where(d < 0, code_mask - qi, torch.where(qi == 0, code_mask, qi))
    ii = i.long()

    dq = _reconstruct((i & (1 << (bits - 1))) != 0, t["dqln"][ii], y)
    dq_mask = 0x7FFF if bits == 5 else 0x3FFF
    sr = torch.where(dq < 0, se - (dq & dq_mask), se + dq)
    dqsez = sr + sez - se
    new = _update(st, y, t["wi"][ii] << 5, t["fi"][ii], dq, sr, dqsez, bits)
    code = (i & code_mask).to(torch.uint8)
    return _finish(state, new, code, valid)


def _scan_plain(step, xs, state, bits, valid, out_dtype):
    out = torch.empty(xs.shape, dtype=out_dtype, device=xs.device)
    valid = None if valid is None else valid.to(torch.bool)
    for n in range(xs.shape[1]):
        state, out[:, n] = step(state, xs[:, n], bits, None if valid is None else valid[:, n])
    return out, state


def g726_decode_scan_plain(codes, state, bits: int, valid=None):
    return _scan_plain(g726_decode_step, codes, state, bits, valid, torch.int16)


def g726_encode_scan_plain(samples, state, bits: int, valid=None):
    return _scan_plain(g726_encode_step, samples, state, bits, valid, torch.uint8)


def _launch(name, xs, x_dtype, state, bits, valid, encode: bool, out_dtype):
    if bits not in (2, 3, 4, 5):
        raise ValueError(f"{name}: bits must be 2..5, not {bits}")
    return launch_scan(name, "skt_g726_scan", G726_LAYOUT, xs, x_dtype, state, valid,
                       xs.shape[1], tuple(xs.shape), out_dtype, bits, int(encode))


def g726_decode_scan(codes, state, bits: int, valid=None):
    """K6 decode: codes [B, N] (u8 on CUDA), state i32 [B, 24], optional
    valid bool [B, N] -> (pcm i16 [B, N], final state)."""
    if codes.device.type == "cpu":
        return g726_decode_scan_plain(codes, state, bits, valid)
    res = _launch("g726_decode_scan", codes, torch.uint8, state, bits, valid, False, torch.int16)
    g726_decode_scan.launches += 1
    return res


def g726_encode_scan(samples, state, bits: int, valid=None):
    """K6 encode: samples [B, N] (i16 on CUDA), state i32 [B, 24],
    optional valid bool [B, N] -> (codes u8 [B, N], final state)."""
    if samples.device.type == "cpu":
        return g726_encode_scan_plain(samples, state, bits, valid)
    res = _launch("g726_encode_scan", samples, torch.int16, state, bits, valid, True, torch.uint8)
    g726_encode_scan.launches += 1
    return res


g726_decode_scan.launches = 0
g726_encode_scan.launches = 0
