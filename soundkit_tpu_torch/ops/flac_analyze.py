"""FLAC block analysis (K14): the plan of one FLAC block for every row
(counterpart of ``soundkit_tpu/ops/flac_enc_batch.py::flac_analyze_device``
with its plan rows packed, as the reference's serving entry returns them).

:func:`flac_analyze` takes the wire ``x`` [L, 2, N], int16 (<= 16-bit
streams) or int32, the samples present ``n_valid`` (<= N, the same for
every row), the bit depth and the channel count, and returns [L, 23]
int32 plan rows: assign, kind[2], order[2], shift[2], qlp[2 x 8]
(``ops.flac_enc_batch.flac_plans_unpack`` splits them). For CUDA tensors
it launches ``csrc/flac_analyze.cu`` and counts ``flac_analyze.launches``;
for CPU tensors it packs the plans of
``ops.flac_enc_batch.flac_analyze_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.ops.flac_enc_batch import PLAN_COLS, flac_analyze_plain, flac_plans_pack
from soundkit_tpu_torch.utils.device import check_cuda, launch_check

#: the widest block FLAC's frame header can declare
MAX_BLOCK = 65535


def flac_analyze(x: torch.Tensor, n_valid: int, bits: int, channels: int = 2) -> torch.Tensor:
    """K14: [L, 23] int32 plan rows of the blocks ``x`` [L, 2, N] (see the
    module's docstring). On the card the samples must lie within 24 bits
    (the kernel's differences and LPC taps are 32-bit: FLAC's encoder
    writes 16 and 24 bits); an int32 wire is checked for it (one read of
    its range back to the host) and anything else raises."""
    if x.dim() != 3 or x.shape[1] != 2 or not 1 <= x.shape[2] <= MAX_BLOCK:
        raise ValueError(f"flac_analyze: x {tuple(x.shape)}; want [L, 2, N], 1 <= N <= "
                         f"{MAX_BLOCK}")
    L, _, N = x.shape
    if not 0 <= n_valid <= N or channels not in (1, 2) or not 1 <= bits <= 24:
        raise ValueError(f"flac_analyze: n_valid {n_valid} of N {N}, channels {channels}, "
                         f"bits {bits}; want 0 <= n_valid <= N, 1 or 2 channels, <= 24 bits")
    if x.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"flac_analyze: x is {x.dtype}; want int16 or int32")
    if x.device.type == "cpu":
        return flac_plans_pack(*flac_analyze_plain(x, n_valid, bits, channels)[:5])
    dev = check_cuda("flac_analyze", x)
    plans = torch.empty((L, PLAN_COLS), dtype=torch.int32, device=dev)
    if L == 0:
        return plans
    if x.dtype == torch.int32:
        lo, hi = torch.stack(torch.aminmax(x)).tolist()
        if lo < -(1 << 23) or hi >= 1 << 23:
            raise ValueError(f"flac_analyze: samples in [{lo}, {hi}]; the kernel takes "
                             f"24-bit samples")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.kernels().skt_flac_analyze(x.data_ptr(), int(x.dtype == torch.int32), L, N,
                                           int(n_valid), bits, channels, plans.data_ptr(), stream)
    launch_check("flac_analyze", rc)
    flac_analyze.launches += 1
    return plans


flac_analyze.launches = 0


def occupancy(wide: bool = False) -> dict:
    """K14's build as the card runs it, for the int16 or (``wide``) int32
    wire: registers and spilled bytes a thread, dynamic shared memory a
    block, resident blocks an SM and the persistent grid it launches."""
    out = (ctypes.c_int * 5)()
    launch_check("flac_analyze_occupancy",
                 _build.kernels().skt_flac_analyze_occupancy(int(wide), out))
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm", "grid"), out))
