"""Windowed IMDCT product (counterpart of the AAC half of
``soundkit_tpu/ops/pallas_kernels.py``).

``out[L, N] = (A[L, K] @ m_t[K, N]) * bank[win_idx]``: the window is a
row of ``bank`` chosen per output row, which is both the Pallas
kernels' ``[L, N]`` window (``bank`` = that window, ``win_idx`` =
``arange(L)``) and the main path's window-bank gather.

- :func:`imdct_window` (K1) runs ``csrc/imdct_window.cu`` on A = coef;
- :func:`dequant_imdct_window` (K2) runs the same kernel with the
  dequant ``sign(q) * |q|^(4/3) * scale`` in the A-operand path.

The kernel multiplies on the tensor cores in 3xTF32: each operand is
split into a TF32 ``hi`` and the rest ``lo = x - hi`` and the product is
``hi·hi + hi·lo + lo·hi`` with float32 sums, within float32 rounding of
the plain product. Both splits happen in the kernel; the basis is
transposed once (:func:`imdct_basis`) into the K-major ``[N, K]`` form
the tensor cores read.

Each wrapper takes its plain version for tensors on the CPU and
launches the kernel for CUDA tensors; ``launches`` counts the kernel
launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.utils.device import check_cuda, launch_check

# tile sizes of csrc/imdct_window.cu
_BK = 32
_BN = 128


class ImdctBasis(NamedTuple):
    """A synthesis basis in both forms: ``m_t`` [K, N] float32 for the
    plain product and ``m`` [N, K] (K-major, as the tensor cores read
    it) for the kernel."""

    m_t: torch.Tensor
    m: torch.Tensor


def imdct_basis(m_t: torch.Tensor) -> ImdctBasis:
    """``m_t`` [K, N] float32 and its transpose, made once."""
    return ImdctBasis(m_t, m_t.T.contiguous())


def dequant(quant: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``sign(q) * |q|^(4/3) * scale`` in float32."""
    q = quant.to(torch.float32)
    return torch.sign(q) * q.abs() ** (4.0 / 3.0) * scale


def imdct_window_plain(coef, m_t, bank, win_idx):
    return torch.matmul(coef, m_t) * bank[win_idx.long()]


def dequant_imdct_window_plain(quant, scale, m_t, bank, win_idx):
    return imdct_window_plain(dequant(quant, scale), m_t, bank, win_idx)


def _launch(name, entry, a_args, basis: ImdctBasis, bank, win_idx, L, K):
    dev = check_cuda(name, *a_args, basis.m, bank, win_idx)
    N = basis.m.shape[0]
    if basis.m.shape != (N, K) or bank.shape[1] != N or win_idx.shape != (L,):
        raise ValueError(f"{name}: shapes A[{L},{K}] basis{tuple(basis.m.shape)} "
                         f"bank{tuple(bank.shape)} win_idx{tuple(win_idx.shape)}")
    if K % _BK or N % _BN:
        raise ValueError(f"{name}: K={K} must be a multiple of {_BK}, N={N} of {_BN}")
    if basis.m.dtype != torch.float32 or bank.dtype != torch.float32 \
            or win_idx.dtype != torch.int32:
        raise TypeError(f"{name}: basis and bank must be float32, win_idx int32")
    out = torch.empty((L, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_build.kernels(), entry)(
        *(t.data_ptr() for t in a_args), basis.m.data_ptr(), bank.data_ptr(),
        win_idx.data_ptr(), out.data_ptr(), L, K, N, stream)
    launch_check(name, rc)
    return out


def imdct_window(coef, basis: ImdctBasis, bank, win_idx):
    """K1: coef f32 [L, K], basis of K x N, bank f32 [R, N], win_idx
    i32 [L] -> f32 [L, N]."""
    if coef.device.type == "cpu":
        return imdct_window_plain(coef, basis.m_t, bank, win_idx)
    if coef.dtype != torch.float32:
        raise TypeError("imdct_window: coef must be float32")
    L, K = coef.shape
    out = _launch("imdct_window", "skt_imdct_window", (coef,), basis, bank, win_idx, L, K)
    imdct_window.launches += 1
    return out


def dequant_imdct_window(quant, scale, basis: ImdctBasis, bank, win_idx):
    """K2: quant i32 [L, K], scale f32 [L, K], then as :func:`imdct_window`."""
    if quant.device.type == "cpu":
        return dequant_imdct_window_plain(quant, scale, basis.m_t, bank, win_idx)
    if quant.dtype != torch.int32 or scale.dtype != torch.float32 or scale.shape != quant.shape:
        raise TypeError("dequant_imdct_window: quant must be int32 and scale float32 of its shape")
    L, K = quant.shape
    out = _launch("dequant_imdct_window", "skt_dequant_imdct_window",
                  (quant, scale), basis, bank, win_idx, L, K)
    dequant_imdct_window.launches += 1
    return out


imdct_window.launches = 0
dequant_imdct_window.launches = 0
