"""Each CUDA kernel of the port against its plain PyTorch version.

The inputs and the bounds that ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py`` hold the kernels to, in one place.
Each ``*_case`` function builds seeded inputs on a CUDA device and
returns ``(kernel, plain)``, two callables without arguments that run
the kernel's wrapper and its plain version on the same tensors;
:func:`compare` runs both once and raises :class:`KernelMismatch`
beyond the bound. The bounds are on ``max|kernel - plain| / max|plain|``:

- K4 ``spectral_decode``: bit-exact;
- K5 ``tns_filter``: 1e-4 (a 20-tap all-pole recursion over 1024 lines);
- K1 ``imdct_window`` and K2 ``dequant_imdct_window``: 1e-5 (fp32 FMA;
  a TF32 product would land near 1e-3).
"""
from __future__ import annotations

import numpy as np
import torch

from soundkit_tpu_torch.ops import aac_batch as ab
from soundkit_tpu_torch.ops import aac_entropy as ae
from soundkit_tpu_torch.ops import imdct

REL_BOUND = {
    "spectral_decode": 0.0,
    "tns_filter": 1e-4,
    "imdct_window": 1e-5,
    "dequant_imdct_window": 1e-5,
}


class KernelMismatch(AssertionError):
    pass


def compare(name: str, kernel, plain) -> dict:
    """Run ``kernel`` and ``plain`` once each; ``max_abs_err`` and
    ``rel_err`` of the kernel's result, or :class:`KernelMismatch`."""
    got, ref = kernel(), plain()
    if got.is_cuda:
        torch.cuda.synchronize()
    err = (got.double() - ref.double()).abs().max().item()
    rel = err / max(ref.double().abs().max().item(), 1e-30)
    ok = got.shape == ref.shape and bool(torch.isfinite(got).all()) and rel <= REL_BOUND[name]
    if name == "spectral_decode":
        ok = torch.equal(got, ref)
    if not ok:
        raise KernelMismatch(f"{name}: max|d| {err} = {rel:.3e} of max|ref| "
                             f"(bound {REL_BOUND[name]})")
    return {"max_abs_err": err, "rel_err": rel}


def spectral_case(wire: torch.Tensor, B: int):
    """K4 on the spectra of a packed v4 wire of ``B`` AUs (2B channel lanes)."""
    f = ab.unpack_v4_wire(wire, B)
    args = (f["au"], f["spec_bit"].reshape(-1).to(torch.int32),
            f["runs"].reshape(2 * B, -1).to(torch.int32),
            f["n_runs"].reshape(-1).to(torch.int32))
    return (lambda: ae.spectral_decode(*args)), (lambda: ae.spectral_decode_plain(*args))


def tns_case(B: int, C: int, device, seed: int, overlap: bool = False):
    """K5 on three TNS regions per row with stable LPC of order 0..20.
    The regions are disjoint, as the parser emits them; with ``overlap``
    they may overlap, so that ``perm`` is not an involution."""
    rng = np.random.default_rng(seed)
    regions = np.zeros((B, C, 8, 3), np.int16)
    for f in range(3):
        start = rng.integers(0, 900, (B, C)) if overlap else f * 340 + rng.integers(0, 200, (B, C))
        regions[:, :, f, 0] = start
        regions[:, :, f, 1] = start + rng.integers(1, 124, (B, C))
        regions[:, :, f, 2] = rng.integers(0, 2, (B, C))
    perm, filt = ab.perm_filt_from_regions(torch.from_numpy(regions).to(device))
    lpc = ab.tns_refl_to_lpc(
        torch.from_numpy(rng.integers(-4, 5, (B, C, 8, 20)).astype(np.int8)).to(device),
        torch.full((B, C, 8), 4, dtype=torch.uint8, device=device),
        torch.from_numpy(rng.integers(0, 21, (B, C, 8)).astype(np.uint8)).to(device),
    ).contiguous()
    coef = torch.from_numpy((rng.standard_normal((B, C, 1024)) * 100).astype(np.float32)).to(device)
    return ((lambda: ab.tns_filter(coef, perm, filt, lpc)),
            (lambda: ab.tns_filter_plain(coef, perm, filt, lpc)))


def _synthesis(rows: int, short: bool, device, gen):
    m_long, bank_long, m_short, bank_short = ab.synthesis_banks(torch.device(device))
    m_t, bank = (m_short, bank_short) if short else (m_long, bank_long)
    win = torch.randint(0, bank.shape[0], (rows,), generator=gen, dtype=torch.int32).to(device)
    return m_t, bank, win


def imdct_case(rows: int, short: bool, device, seed: int):
    """K1 over ``rows`` rows of the long (K = 1024) or short (K = 128)
    synthesis, with the real IMDCT matrix and window bank."""
    gen = torch.Generator().manual_seed(seed)
    m_t, bank, win = _synthesis(rows, short, device, gen)
    coef = (torch.randn((rows, m_t.shape[0]), generator=gen) * 1000.0).to(device)
    return ((lambda: imdct.imdct_window(coef, m_t, bank, win)),
            (lambda: imdct.imdct_window_plain(coef, m_t, bank, win)))


def dequant_imdct_case(rows: int, device, seed: int):
    """K2 over ``rows`` long rows: half the lines zero, |q| <= 64,
    scale factors 60..140 around the global gain 100."""
    gen = torch.Generator().manual_seed(seed)
    m_t, bank, win = _synthesis(rows, False, device, gen)
    q = torch.randint(-64, 65, (rows, 1024), generator=gen, dtype=torch.int32)
    q = torch.where(torch.rand((rows, 1024), generator=gen) < 0.5, 0, q).to(device)
    sf = torch.randint(60, 141, (rows, 1024), generator=gen).to(device)
    scale = torch.exp2(0.25 * (sf.to(torch.float32) - 100.0))
    return ((lambda: imdct.dequant_imdct_window(q, scale, m_t, bank, win)),
            (lambda: imdct.dequant_imdct_window_plain(q, scale, m_t, bank, win)))
