"""The first designs of K11, K12, K15, K16 and K17, built beside the kernels
for timing.

``first_designs_csrc/`` holds the sources of the CELT comb postfilter, the
SILK LTP/LPC synthesis, the polyphase FIR, the vocoder's overlap-add and the
phase locking as they were before their redesign for Hopper (one block a
CELT stream, every line loaded before any is filtered, comb steps of
``min(32, Tmin - 2)`` over all four periods and the de-emphasis memory on
one lane; eight SILK rows a block, three block barriers a subframe and the
LPC on eight lanes of one warp; one phase a thread at four cycles with a
shared load a product; the divisor built into a scratch by a first launch,
then an output a thread with its covering frames loaded one at a time; a
warp a row with warp scans and the full-range ``sincosf``), their entry
points renamed ``skt_celt_postfilter_first`` and ``skt_silk_synth_first``
where the kernel library has the same name. They build into a library of
their own (``_build/first_designs-*.so``, one ``nvcc`` a source, as the
kernels build) and are called here on the tensors a caller gives, so that
``chip_smoke.py`` and ``tools/dsp_kernel_bench.py`` can time a redesigned
kernel against its first design on one card in one process. Nothing on a
path calls them, and they count no launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.ops import celt_postfilter as cp
from soundkit_tpu_torch.ops import resample as rs
from soundkit_tpu_torch.ops import silk_synth as ss
from soundkit_tpu_torch.utils.device import check_cuda, launch_check

SRC_DIR = Path(__file__).resolve().parent / "first_designs_csrc"
SOURCES = tuple(SRC_DIR / f for f in ("celt_postfilter.cu", "silk_synth.cu", "resample.cu",
                                      "stretch_ola.cu", "phase_lock.cu"))
#: the first K15's launch shape: cycles a thread sums, outputs a block aims
#: at, and the floats of input a block may stage (48 KB)
CYCLES_PER_THREAD = 4
TILE_OUTPUTS = 2048
TILE_FLOATS = 12288


def library_path() -> Path:
    nvcc = _build._compiler("nvcc", "/usr/local/cuda/bin/nvcc")
    return _build._build("first_designs", nvcc, _build.NVCC_FLAGS, SOURCES, ())


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.skt_resample.argtypes = [*[p] * 5, *[i] * 6, p]
    lib.skt_stretch_ola.argtypes = [*[p] * 4, *[i] * 6, p]
    lib.skt_phase_lock.argtypes = [*[p] * 5, i, i, p]
    lib.skt_celt_postfilter_first.argtypes = [*[p] * 11, i, i, p]
    lib.skt_silk_synth_first.argtypes = [*[p] * 12, i, i, p]
    for fn in (lib.skt_resample, lib.skt_stretch_ola, lib.skt_phase_lock,
               lib.skt_celt_postfilter_first, lib.skt_silk_synth_first):
        fn.restype = ctypes.c_int
    return lib


def tile_cycles(L: int, M: int, n_cycles: int) -> int:
    """Cycles a block of the first K15 takes: about TILE_OUTPUTS outputs,
    at most TILE_FLOATS staged inputs, a multiple of CYCLES_PER_THREAD,
    spread evenly over the blocks of a row."""
    R = CYCLES_PER_THREAD
    want = -(-TILE_OUTPUTS // L)
    cap = max(R, (TILE_FLOATS - rs.SINC_LEN + 1) // M // R * R)
    ct = max(R, min(-(-want // R) * R, cap))
    n_cycles = max(n_cycles, 1)
    tiles = -(-n_cycles // ct)
    per = -(-n_cycles // tiles)
    return -(-per // R) * R


@functools.lru_cache(maxsize=16)
def _bank(in_rate: int, out_rate: int, device: torch.device):
    taps_rev, offsets, _, _ = rs.design_polyphase(in_rate, out_rate)
    return (torch.from_numpy(taps_rev.T.copy()).to(device),
            torch.from_numpy(offsets.astype("int32")).to(device))


def polyphase_fir(x, hist, in_rate: int, out_rate: int, n_out: int) -> torch.Tensor:
    """The first K15 on CUDA tensors: ``rs.polyphase_fir``'s contract."""
    dev = check_cuda("polyphase_fir (first design)", x, *(() if hist is None else (hist,)))
    B, n = x.shape
    taps_t, offsets = _bank(in_rate, out_rate, dev)
    L = taps_t.shape[1]
    M = in_rate // math.gcd(in_rate, out_rate)
    ct = tile_cycles(L, M, (n_out + L - 1) // L)
    out = torch.empty((B, n_out), dtype=torch.float32, device=dev)
    rc = library().skt_resample(
        x.data_ptr(), hist.data_ptr() if hist is not None else None, taps_t.data_ptr(),
        offsets.data_ptr(), out.data_ptr(), B, n, L, M, n_out, ct,
        torch.cuda.current_stream(dev).cuda_stream)
    launch_check("polyphase_fir (first design)", rc)
    return out


def overlap_add(frames, win, hop: int, target: int) -> torch.Tensor:
    """The first K16 on CUDA tensors: ``ops.stretch_ola.overlap_add``'s
    contract, with the divisor's scratch."""
    dev = check_cuda("overlap_add (first design)", frames, win)
    B, T, F = frames.shape
    den = torch.empty(target, dtype=torch.float32, device=dev)
    out = torch.empty((B, target), dtype=torch.float32, device=dev)
    rc = library().skt_stretch_ola(
        frames.data_ptr(), win.data_ptr(), den.data_ptr(), out.data_ptr(), B, T, F, hop, F // 2,
        target, torch.cuda.current_stream(dev).cuda_stream)
    launch_check("overlap_add (first design)", rc)
    return out


def phase_lock(mag, phase, syn, with_nearest: bool = False):
    """The first K17 on CUDA tensors: ``ops.phase_lock.phase_lock``'s contract."""
    dev = check_cuda("phase_lock (first design)", mag, phase, syn)
    K = mag.shape[-1]
    spec = torch.empty(mag.shape, dtype=torch.complex64, device=dev)
    nearest = torch.empty(mag.shape, dtype=torch.int32, device=dev) if with_nearest else None
    rc = library().skt_phase_lock(
        mag.data_ptr(), phase.data_ptr(), syn.data_ptr(), spec.data_ptr(),
        nearest.data_ptr() if with_nearest else None, mag.numel() // K, K,
        torch.cuda.current_stream(dev).cuda_stream)
    launch_check("phase_lock (first design)", rc)
    return (spec, nearest) if with_nearest else spec


def celt_postfilter(full, comb, valid, ola, hist, emph):
    """The first K11 on CUDA tensors: ``cp.celt_postfilter``'s contract
    (without ``pcm_out``) -> (pcm, new_ola, new_hist, new_emph)."""
    dev = check_cuda("celt_postfilter (first design)", full, comb, valid, ola, hist, emph)
    B, C = full.shape[0], full.shape[1]
    pcm = torch.empty((B, C, cp.N), dtype=torch.float32, device=dev)
    new_ola, new_hist, new_emph = (torch.empty_like(t) for t in (ola, hist, emph))
    rc = library().skt_celt_postfilter_first(
        full.data_ptr(), comb.data_ptr(), valid.data_ptr(), ola.data_ptr(), hist.data_ptr(),
        emph.data_ptr(), cp.kernel_tables(dev).data_ptr(), pcm.data_ptr(), new_ola.data_ptr(),
        new_hist.data_ptr(), new_emph.data_ptr(), B, C, torch.cuda.current_stream(dev).cuda_stream)
    launch_check("celt_postfilter (first design)", rc)
    return pcm, new_ola, new_hist, new_emph


def silk_synth(bw: int, exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale, out_hist,
               lpch_tail):
    """The first K12 on CUDA tensors: ``ss.silk_synth``'s contract ->
    (dst, new lpch_tail)."""
    ins = (exc, gains, coef, has_leadin, voiced, lags, ltp, ltpscale, out_hist, lpch_tail)
    dev = check_cuda("silk_synth (first design)", *ins)
    B = exc.shape[0]
    dst = torch.empty((B, 2, ss.HIST + ss.SUBFRAMES * ss.SFL[bw]), dtype=torch.float32, device=dev)
    new_tail = torch.empty_like(lpch_tail)
    rc = library().skt_silk_synth_first(*(t.data_ptr() for t in ins), dst.data_ptr(),
                                        new_tail.data_ptr(), B * 2, bw,
                                        torch.cuda.current_stream(dev).cuda_stream)
    launch_check("silk_synth (first design)", rc)
    return dst, new_tail
