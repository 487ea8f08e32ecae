"""AAC spectral Huffman decode on the device (counterpart of
``soundkit_tpu/ops/aac_entropy.py``).

Inputs are the v4 wire's fields: the raw AU bytes ``au`` [B, CAP]
uint8 (channel lane ``l`` reads AU row ``l >> 1``), the bit offset of
each channel lane's spectral data, its section program ``runs``
(``cb | ncw << 4 | out << 10`` per run) and run count. The output is
the quantized spectrum [2B, 1024] int32.

:func:`spectral_decode` (K4) launches ``csrc/aac_spectral.cu`` for CUDA
tensors and takes :func:`spectral_decode_plain` for CPU tensors. The
flat lookup table's maker :func:`build_spectral_lut` is a copy of the
JAX package's; the kernel reads it as the two-level table of
:func:`build_spectral_lut2`, which gives the same entry for every
16-bit prefix.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.codecs.aac_lc import _CB_INFO, _unpack_index, raw_tables
from soundkit_tpu_torch.utils.device import check_cuda, launch_check

N_LINES = 1024
# codebooks 1..11 at index cb - 1
_CB_DIM = (4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2)
_CB_SIGNED = (1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0)
LUT_BITS = 16
LUT1_BITS = 8  # first level of K4's two-level table


@functools.lru_cache(maxsize=1)
def build_spectral_lut() -> np.ndarray:
    """[11, 2^16] int32: entry = len(5 bits, 0 = invalid) |
    (val0+16)<<5 | (val1+16)<<11 | (val2+16)<<17 | (val3+16)<<23.

    For signed codebooks the values are final; for unsigned ones they
    are magnitudes (signs stream after the codeword).  Codebook 11
    magnitudes of 16 mark escapes.
    """
    t = raw_tables()
    lut = np.zeros((11, 1 << LUT_BITS), dtype=np.int32)
    for cb in range(1, 12):
        codes = t[f"spectral_codes_{cb - 1}"]
        bits = t[f"spectral_bits_{cb - 1}"]
        dim, base, signed = _CB_INFO[cb]
        for idx, (code, ln) in enumerate(zip(codes, bits)):
            ln = int(ln)
            if ln == 0:
                continue
            vals = _unpack_index(cb, idx)
            packed = ln
            for i in range(4):
                v = vals[i] if i < dim else 0
                packed |= (v + 16) << (5 + 6 * i)
            lo = int(code) << (LUT_BITS - ln)
            hi = lo + (1 << (LUT_BITS - ln))
            lut[cb - 1, lo:hi] = packed
    return lut


def two_level_table(flat: np.ndarray, first_bits: int = LUT1_BITS) -> np.ndarray:
    """The flat ``[11, 2^16]`` table as K4's two-level table, one int32
    array: ``11 * 2^first_bits`` first-level entries (codebook-major,
    indexed by the window's top ``first_bits`` bits), then the
    subtables. A first-level entry whose prefix block of the flat table
    is constant holds that entry (final, bit 31 clear; 0 stays 0).
    Otherwise it is ``1 << 31 | k << 16 | offset``: the subtable at
    ``offset`` is indexed by the next ``k`` bits, the fewest after which
    the block is constant. So every 16-bit prefix looks up exactly its
    flat entry."""
    n_cb, size = flat.shape
    rest = LUT_BITS - first_bits
    first = np.zeros((n_cb, 1 << first_bits), np.uint32)
    subs = []
    off = first.size
    for cb in range(n_cb):
        for i, blk in enumerate(flat[cb].reshape(1 << first_bits, 1 << rest)):
            if (blk == blk[0]).all():
                first[cb, i] = np.uint32(blk[0])
                continue
            k = next(k for k in range(1, rest + 1)
                     if (blk.reshape(1 << k, -1) == blk.reshape(1 << k, -1)[:, :1]).all())
            subs.append(blk.reshape(1 << k, -1)[:, 0].astype(np.uint32))
            first[cb, i] = (1 << 31) | (k << 16) | off
            off += 1 << k
    if off >= 1 << 16:
        raise ValueError(f"two-level table of {off} entries: offsets need 16 bits")
    return np.concatenate([first.reshape(-1), *subs]).view(np.int32)


@functools.lru_cache(maxsize=1)
def build_spectral_lut2() -> np.ndarray:
    """K4's two-level table of :func:`build_spectral_lut` (3,958 entries)."""
    return two_level_table(build_spectral_lut())


@functools.lru_cache(maxsize=4)
def spectral_lut(device: torch.device) -> torch.Tensor:
    """[11 * 65536] int32 LUT on ``device`` (built once per device)."""
    return torch.from_numpy(build_spectral_lut()).reshape(-1).to(device)


@functools.lru_cache(maxsize=4)
def spectral_lut2(device: torch.device) -> torch.Tensor:
    """K4's two-level table on ``device`` (built once per device)."""
    return torch.from_numpy(build_spectral_lut2()).to(device)


def _au_words(au: torch.Tensor) -> torch.Tensor:
    """[B, CAP] uint8 -> [B, CAP // 4] big-endian words, in int64."""
    b = au.to(torch.int64).reshape(au.shape[0], -1, 4)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def spectral_decode_plain(au, bitpos, runs, n_runs):
    """The reference's interpreter step by step, vectorized over lanes
    (32-bit words held in int64)."""
    dev = au.device
    lanes, R = runs.shape
    words = _au_words(au).index_select(0, torch.arange(lanes, device=dev) >> 1)
    W = words.shape[1]
    lut = spectral_lut(dev).to(torch.int64)
    dim_v = torch.tensor(_CB_DIM, device=dev)
    signed_v = torch.tensor(_CB_SIGNED, device=dev).bool()
    runs = runs.to(torch.int64)
    n_runs = n_runs.to(torch.int64)
    slot = torch.arange(4, device=dev)[None, :]
    # top-k-bit masks, k = 1..24: leading ones of w, capped at 24
    ones32 = torch.full((24,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    top_masks = (ones32 << (32 - torch.arange(1, 25, device=dev))) & 0xFFFFFFFF

    def window32(bp):
        wi = bp >> 5
        sh = bp & 31
        w0 = words.gather(1, (wi % W)[:, None])[:, 0]
        w1 = words.gather(1, ((wi + 1) % W)[:, None])[:, 0]
        joined = ((w0 << sh) & 0xFFFFFFFF) | (w1 >> (32 - sh))
        return torch.where(sh == 0, w0, joined)

    bitpos = bitpos.to(torch.int64).clone()
    run_i = torch.zeros(lanes, dtype=torch.int64, device=dev)
    cw_i = torch.zeros_like(run_i)
    quant = torch.zeros((lanes, N_LINES + 1), dtype=torch.int32, device=dev)  # + spill
    while True:
        active = run_i < n_runs
        if not bool(active.any()):
            break
        r = runs.gather(1, run_i.clamp(max=R - 1)[:, None])[:, 0]
        cb = (r & 15).clamp(1, 11)
        esc_cb = (r & 15) == 11  # 12-15 read codebook 11's table, but never escape
        ncw = (r >> 4) & 63
        base = (r >> 10) & 4095
        dim = dim_v[cb - 1]
        in_dim = slot < dim[:, None]

        win = window32(bitpos)
        entry = lut[(cb - 1) * (1 << LUT_BITS) + (win >> (32 - LUT_BITS))]
        vals = ((entry[:, None] >> (5 + 6 * slot)) & 63) - 16
        vals = torch.where(in_dim, vals, 0)
        bitpos = torch.where(active, bitpos + (entry & 31), bitpos)

        need_sign = (vals != 0) & in_dim & ~signed_v[cb - 1][:, None]
        before = torch.cumsum(need_sign.long(), dim=1) - need_sign.long()
        sbit = (window32(bitpos)[:, None] >> (31 - before)) & 1
        vals = torch.where(need_sign & (sbit == 1), -vals, vals)
        bitpos = torch.where(active, bitpos + need_sign.sum(1), bitpos)

        for i in range(2):
            v = vals[:, i]
            esc = (v.abs() == 16) & esc_cb & active
            ewin = window32(bitpos)
            n1 = ((ewin[:, None] & top_masks) == top_masks).sum(1)
            n = 4 + n1
            bpe = bitpos + n1 + 1
            mag = (torch.ones_like(n) << n) | (window32(bpe) >> (32 - n))
            vals[:, i] = torch.where(esc, torch.where(v < 0, -mag, mag), v)
            bitpos = torch.where(esc, bpe + n, bitpos)

        pos = base + cw_i * dim
        for i in range(4):
            tgt = pos + i
            keep = active & (i < dim) & (tgt < N_LINES)
            tgt = torch.where(keep, tgt, N_LINES)
            quant.scatter_(1, tgt[:, None], vals[:, i : i + 1].to(torch.int32))

        cw_next = cw_i + 1
        done_run = cw_next >= ncw
        run_i = torch.where(active & done_run, run_i + 1, run_i)
        cw_i = torch.where(active, torch.where(done_run, 0, cw_next), cw_i)
    return quant[:, :N_LINES].contiguous()


def spectral_decode(au, bitpos, runs, n_runs):
    """K4: au uint8 [B, CAP], bitpos / n_runs int32 [2B], runs int32
    [2B, R] -> quant int32 [2B, 1024]."""
    if au.device.type == "cpu":
        return spectral_decode_plain(au, bitpos, runs, n_runs)
    dev = check_cuda("spectral_decode", au, bitpos, runs, n_runs)
    B, cap = au.shape
    lanes, R = runs.shape
    if au.dtype != torch.uint8 or cap % 4:
        raise TypeError("spectral_decode: au must be uint8 with a row length divisible by 4")
    if lanes != 2 * B or bitpos.shape != (lanes,) or n_runs.shape != (lanes,):
        raise ValueError(f"spectral_decode: {B} AUs need {2 * B} lanes, got runs{tuple(runs.shape)}")
    if not all(t.dtype == torch.int32 for t in (bitpos, runs, n_runs)):
        raise TypeError("spectral_decode: bitpos, runs and n_runs must be int32")
    quant = torch.empty((lanes, N_LINES), dtype=torch.int32, device=dev)  # the kernel zero-fills
    table = spectral_lut2(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_spectral_decode(
        au.data_ptr(), cap, bitpos.data_ptr(), runs.data_ptr(), R, n_runs.data_ptr(),
        table.data_ptr(), table.numel(), quant.data_ptr(), lanes, stream,
    )
    launch_check("spectral_decode", rc)
    spectral_decode.launches += 1
    return quant


spectral_decode.launches = 0
