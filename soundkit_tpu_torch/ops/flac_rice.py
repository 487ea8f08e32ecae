"""FLAC Rice / fixed-width residual decode on the device (counterpart of
``soundkit_tpu/ops/flac_rice.py``).

The wire ships the compressed frame bytes, not the residuals. The host
walk (``native_src/src/flac.cpp``) locates every coding span and emits
a dense segment table across the batch; the device decodes each
segment's codes from the frame words on its own and writes the residual
plane that feeds the LPC reconstruction (``ops/flac_lpc.py``):

  words        [NL, W] int32: the frame bytes as big-endian 32-bit words
               (the bits of a uint32, held in int32)
  seg_lane / seg_bitoff / seg_k / seg_n / seg_dest  [N] int32: the frame
               row of a segment, the bit offset of its first code, its
               Rice parameter ``k`` (0..31) or, as ``-width - 1``, the
               width (0..32) of its fixed-width codes, its code count (0
               for a pad row) and the index of its first value in the
               flat ``[NL * 2 * stride]`` plane
  warm         [NL, 2, 32] int32: warm-up samples (zero past the order)
  const_flag / const_val  [NL, 2] int32: CONSTANT subframes

A Rice code is a unary quotient (the count of zeros before a one, read
with ``clz`` from a 32-bit MSB-first window; a window with 24 or more
leading zeros adds 24 to the quotient and moves on), ``k`` remainder
bits, and a zigzag fold; a fixed-width code is one sign-extended read.
Segments never overlap each other; they overwrite the zero fill, the
warm-up and the constant fill. A value whose index falls outside the
plane is dropped. A segment whose window stays zero past the end of its
row (a quotient that never ends) emits nothing more.

The host walk emits ``k`` in 0..31 and bit offsets >= 0. Outside that,
kernel and plain version compute what the reference computes, whose
32-bit shifts by 32 or more give 0: a Rice parameter of 32 takes the
32-bit remainder window as ``zz`` (``q << 32`` is 0, ``rwin >> 0`` the
window), one above 32 gives ``zz = 0``; either advances by ``lead + 1 +
k``. A negative bit offset reads the words as the reference's
``jnp.take(flat_words, lane * W + min(i, W - 1))`` does: a flat index in
``[-NL * W, 0)`` counts from the end of all rows, one below that reads
``0xFFFFFFFF`` (the fill of an unsigned take).

:func:`flac_rice_plane` (K8) launches ``csrc/flac_rice.cu`` for CUDA
tensors and takes :func:`flac_rice_plane_plain` for CPU tensors;
:func:`flac_frames_segs` is the serving entry: Rice plane, then LPC.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.ops import flac_lpc
from soundkit_tpu_torch.utils.device import check_cuda, launch_check

_M32 = 0xFFFFFFFF


def seg_wire(frame_segs: List[np.ndarray], stride: int):
    """Flatten per-frame-lane [n,4] segment tables (bitoff, k, n, dest
    with dest = c*stride + pos) into dense global arrays whose dest
    addresses the flat [NL*2*stride] plane.  Returns
    (lane, bitoff, k, n, dest) int32 [N_pad] with pad rows n=0."""
    lanes, offs, ks, ns, dests = [], [], [], [], []
    for i, segs in enumerate(frame_segs):
        if segs.size == 0:
            continue
        m = segs.shape[0]
        lanes.append(np.full(m, i, np.int32))
        offs.append(segs[:, 0])
        ks.append(segs[:, 1])
        ns.append(segs[:, 2])
        dests.append(segs[:, 3] + np.int32(i * 2 * stride))
    if not lanes:
        z = np.zeros(1, np.int32)
        return z, z, z, z, z
    cat = lambda xs: np.concatenate(xs).astype(np.int32)  # noqa: E731
    lane, off, k, n, dest = map(cat, (lanes, offs, ks, ns, dests))
    N = lane.shape[0]
    N_pad = 1 << max((N - 1).bit_length(), 6)
    pad = N_pad - N
    if pad:
        zp = np.zeros(pad, np.int32)
        lane = np.concatenate([lane, zp])
        off = np.concatenate([off, zp])
        k = np.concatenate([k, zp])
        n = np.concatenate([n, zp])  # n=0 -> never active
        dest = np.concatenate([dest, zp])
    return lane, off, k, n, dest


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64 (0 -> 32): 32 less
    the bit length, which is the exponent of the value as float64."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def flac_rice_plane_plain(words, seg_lane, seg_bitoff, seg_k, seg_n, seg_dest, warm,
                          const_flag, const_val, stride: int):
    """The reference's interpreter step by step, one code per segment
    and step, vectorized over the segments (32-bit values held in
    int64), until every segment has come to its end."""
    dev = words.device
    NL, W = words.shape
    flat_words = words.reshape(-1).to(torch.int64) & _M32
    lane_base = seg_lane.to(torch.int64) * W
    seg_k = seg_k.to(torch.int64)
    seg_n = seg_n.to(torch.int64)
    seg_dest = seg_dest.to(torch.int64)

    is_fixed = seg_k < 0
    width = torch.where(is_fixed, -seg_k - 1, 0)
    wide = width > 32  # no such code: reads as 0
    inv = (32 - width).clamp(0, 32)
    k = seg_k.clamp(min=0)
    n_flat = flat_words.shape[0]

    def word(wi):
        """The reference's ``jnp.take`` of a row's word ``wi`` (clamped
        to the row's last): negative flat indices count from the end, and
        below ``-n_flat`` the take's fill."""
        f = lane_base + wi.clamp(max=W - 1)
        inside = (f >= -n_flat) & (f < n_flat)
        return torch.where(inside, flat_words[torch.where(inside, f % max(n_flat, 1), 0)], _M32)

    def window32(bitpos):
        """Next 32 bits MSB-first at each segment's bitpos."""
        wi = bitpos >> 5
        sh = bitpos & 31
        return ((word(wi) << sh) & _M32) | (word(wi + 1) >> (32 - sh))

    total = NL * 2 * stride
    plane = torch.zeros((NL, 2, stride), dtype=torch.int32, device=dev)
    plane[:, :, :32] = warm
    plane = torch.where((const_flag == 1)[:, :, None], const_val[:, :, None], plane)
    flat = plane.reshape(-1)

    bitpos = seg_bitoff.to(torch.int64)
    qacc = torch.zeros_like(bitpos)
    si = torch.zeros_like(bitpos)
    dead = torch.zeros_like(is_fixed)
    while True:
        active = (si < seg_n) & ~dead
        if not bool(active.any()):
            break
        win = window32(bitpos)

        # fixed-width read (escape partitions, verbatim): always one code
        v_u = torch.where((width == 0) | wide, 0, win >> inv)
        x = (v_u << inv) & _M32
        v_f = torch.where((width == 0) | wide, 0, (x - ((x >> 31) << 32)) >> inv)

        # Rice: unary quotient by clz; a window of 24 zeros or more takes
        # the step without finishing the code
        lead = _clz32(win)
        long_skip = ~is_fixed & (lead >= 24)
        q = (qacc + lead) & _M32
        rwin = window32(bitpos + lead + 1)
        # XLA's 32-bit shifts by 32 or more give 0
        rem = torch.where((k == 0) | (k > 32), 0, rwin >> (32 - k).clamp(min=0))
        zz = torch.where(k >= 32, 0, (q << k.clamp(max=31)) & _M32) | rem
        v_r = torch.where((zz & 1) == 1, -(zz >> 1) - 1, zz >> 1)

        # the row's words are spent and zero: this quotient never ends
        dead = dead | (active & long_skip & (win == 0) & ((bitpos >> 5) >= W - 1))
        done = active & (is_fixed | ~long_skip)
        val = torch.where(is_fixed, v_f, v_r)
        tgt = seg_dest + si
        put = done & (tgt >= 0) & (tgt < total)
        flat[tgt[put]] = val[put].to(torch.int32)

        adv = torch.where(is_fixed, width, torch.where(long_skip, 24, lead + 1 + seg_k))
        bitpos = torch.where(active, bitpos + adv, bitpos)
        qacc = torch.where(done | ~active, 0, torch.where(long_skip, qacc + 24, qacc))
        si = torch.where(done, si + 1, si)
    return plane


def flac_rice_plane(words, seg_lane, seg_bitoff, seg_k, seg_n, seg_dest, warm, const_flag,
                    const_val, stride: int):
    """K8: decode every segment's codes -> the residual plane
    [NL, 2, stride] int32, warm-up and constant channels filled."""
    if words.device.type == "cpu":
        return flac_rice_plane_plain(words, seg_lane, seg_bitoff, seg_k, seg_n, seg_dest, warm,
                                     const_flag, const_val, stride)
    segs = (seg_lane, seg_bitoff, seg_k, seg_n, seg_dest)
    dev = check_cuda("flac_rice_plane", words, *segs, warm, const_flag, const_val)
    NL, W = words.shape
    N = seg_lane.shape[0]
    if any(t.shape != (N,) for t in segs):
        raise ValueError("flac_rice_plane: the segment arrays must have one length")
    if warm.shape != (NL, 2, 32) or const_flag.shape != (NL, 2) or const_val.shape != (NL, 2):
        raise ValueError(f"flac_rice_plane: warm{tuple(warm.shape)}, "
                         f"const_flag{tuple(const_flag.shape)} for {NL} frame rows")
    if stride < 32 or W < 1:
        raise ValueError(f"flac_rice_plane: stride {stride} < 32 or no words")
    if not all(t.dtype == torch.int32 for t in (words, *segs, warm, const_flag, const_val)):
        raise TypeError("flac_rice_plane: every input must be int32")
    plane = torch.empty((NL, 2, stride), dtype=torch.int32, device=dev)  # the kernel fills it
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_flac_rice_plane(
        words.data_ptr(), NL, W, seg_lane.data_ptr(), seg_bitoff.data_ptr(), seg_k.data_ptr(),
        seg_n.data_ptr(), seg_dest.data_ptr(), N, warm.data_ptr(), const_flag.data_ptr(),
        const_val.data_ptr(), plane.data_ptr(), stride, stream,
    )
    launch_check("flac_rice_plane", rc)
    flac_rice_plane.launches += 1
    return plane


flac_rice_plane.launches = 0


def flac_frames_segs(words, segs, warm, const_flag, const_val, coef, order, shift, wasted,
                     chan_assign, block_size, lane_valid, stride: int):
    """Serving entry: many frames in one call over the segment wire, the
    Rice plane (K8) and then the LPC reconstruction (K9). ``segs`` is the
    tuple (lane, bitoff, k, n, dest) of :func:`seg_wire`, as tensors; the
    per-lane arrays have one row for each row of ``words``."""
    plane = flac_rice_plane(words, *segs, warm, const_flag, const_val, stride)
    return flac_lpc.flac_frame(plane, coef, order, shift, wasted, chan_assign, block_size,
                               lane_valid)
