"""PCM quality comparison and benchmark metrics.

Behavioral equivalent of the reference's oracle-comparison harness
(``aac-wasm-bench/src/lib.rs``): ``PcmStats`` with FNV checksum
(:59-93), ``QualityComparison`` with offset-search alignment and
RMSE/SNR/percentile error metrics (:96-405), the default pass
thresholds (:8-11, :219-225), and ``BenchResult`` RTF accounting
(:506-545).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

DEFAULT_RMSE_TOLERANCE = 0.005
DEFAULT_MEAN_ABS_TOLERANCE = 0.001
DEFAULT_MAX_ABS_TOLERANCE = 0.50
DEFAULT_MIN_SNR_DB = 35.0


@dataclass
class PcmStats:
    sample_count: int
    rms: float
    peak_abs: float
    checksum: int

    @classmethod
    def from_pcm(cls, pcm: np.ndarray) -> "PcmStats":
        pcm = np.asarray(pcm, dtype=np.float32)
        n = len(pcm)
        rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2))) if n else 0.0
        peak = float(np.abs(pcm).max()) if n else 0.0
        # FNV-1a-style over the f32 bit patterns (lib.rs:70-78)
        checksum = 0xCBF29CE484222325
        for bits in pcm.view(np.uint32).tolist():
            checksum ^= bits
            checksum = (checksum * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return cls(n, rms, peak, checksum)


@dataclass
class QualityComparison:
    compared_samples: int
    reference_samples: int
    candidate_samples: int
    length_delta: int
    candidate_sample_offset: int
    reference_rms: float
    candidate_rms: float
    max_abs_error: float
    p99_abs_error: float
    p999_abs_error: float
    p9999_abs_error: float
    samples_over_001: int
    samples_over_01: int
    samples_over_02: int
    mean_abs_error: float
    rmse: float
    snr_db: float

    def passes_default_thresholds(self) -> bool:
        return (
            self.length_delta == 0
            and self.rmse <= DEFAULT_RMSE_TOLERANCE
            and self.mean_abs_error <= DEFAULT_MEAN_ABS_TOLERANCE
            and self.max_abs_error <= DEFAULT_MAX_ABS_TOLERANCE
            and self.snr_db >= DEFAULT_MIN_SNR_DB
        )

    def offset_in_frames(self, channels: int) -> float:
        return self.candidate_sample_offset / max(channels, 1)

    # -- constructors --

    @classmethod
    def compare(cls, reference: np.ndarray, candidate: np.ndarray) -> "QualityComparison":
        return _compare_with_offset(reference, candidate, 0)

    @classmethod
    def compare_aligned(
        cls,
        reference: np.ndarray,
        candidate: np.ndarray,
        channels: int,
        max_frame_offset: int,
    ) -> "QualityComparison":
        step = max(channels, 1)
        probe = min(len(reference), len(candidate), step * 1024 * 32)
        best_offset = 0
        best = _compare_with_offset(reference, candidate, 0, probe)
        for off in range(-max_frame_offset * step, max_frame_offset * step + 1, step):
            if off == 0:
                continue
            c = _compare_with_offset(reference, candidate, off, probe)
            if c.compared_samples and c.rmse < best.rmse:
                best_offset, best = off, c
        return _compare_with_offset(reference, candidate, best_offset)

    @classmethod
    def compare_unaligned(cls, reference: np.ndarray, candidate: np.ndarray) -> "QualityComparison":
        return cls.compare_aligned(reference, candidate, 1, 8192)


def _compare_with_offset(
    reference: np.ndarray,
    candidate: np.ndarray,
    offset: int,
    max_samples: Optional[int] = None,
) -> QualityComparison:
    reference = np.asarray(reference, dtype=np.float64)
    candidate = np.asarray(candidate, dtype=np.float64)
    if offset >= 0:
        cand = candidate[offset:]
        ref = reference
    else:
        cand = candidate
        ref = reference[-offset:]
    n = min(len(ref), len(cand))
    if max_samples is not None:
        n = min(n, max_samples)
    r = ref[:n]
    c = cand[:n]
    err = np.abs(r - c)
    if n:
        rmse = float(np.sqrt(np.mean((r - c) ** 2)))
        p_sig = np.mean(r**2)
        p_err = np.mean((r - c) ** 2)
        snr = 10 * np.log10(p_sig / p_err) if p_err > 0 else 999.0
        sorted_err = np.sort(err)
        def pct(p):
            return float(sorted_err[min(int(p * n), n - 1)])
        qc = QualityComparison(
            compared_samples=n,
            reference_samples=len(reference),
            candidate_samples=len(candidate),
            length_delta=len(candidate) - len(reference),
            candidate_sample_offset=offset,
            reference_rms=float(np.sqrt(np.mean(r**2))),
            candidate_rms=float(np.sqrt(np.mean(c**2))),
            max_abs_error=float(err.max()),
            p99_abs_error=pct(0.99),
            p999_abs_error=pct(0.999),
            p9999_abs_error=pct(0.9999),
            samples_over_001=int(np.count_nonzero(err > 0.01)),
            samples_over_01=int(np.count_nonzero(err > 0.1)),
            samples_over_02=int(np.count_nonzero(err > 0.2)),
            mean_abs_error=float(err.mean()),
            rmse=rmse,
            snr_db=snr,
        )
    else:
        qc = QualityComparison(
            0, len(reference), len(candidate), len(candidate) - len(reference),
            offset, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0, 0.0, 0.0, 0.0,
        )
    return qc


@dataclass
class BenchResult:
    """RTF accounting (aac-wasm-bench/src/lib.rs:506-545)."""

    name: str
    frames: int
    samples_per_frame: int
    channels: int
    sample_rate: int
    elapsed_seconds: float

    @property
    def audio_seconds(self) -> float:
        if self.sample_rate == 0:
            return 0.0
        return self.frames * self.samples_per_frame / self.sample_rate

    @property
    def real_time_factor(self) -> float:
        a = self.audio_seconds
        return self.elapsed_seconds / a if a > 0 else 0.0

    @property
    def frames_per_second(self) -> float:
        return self.frames / self.elapsed_seconds if self.elapsed_seconds > 0 else 0.0

    def __str__(self) -> str:
        return (
            f"{self.name}: {self.frames} frames, {self.audio_seconds:.3f}s audio in "
            f"{self.elapsed_seconds:.3f}s -> RTF {self.real_time_factor:.6f} "
            f"({1.0 / max(self.real_time_factor, 1e-12):.0f}x realtime, "
            f"{self.frames_per_second:.0f} frames/s)"
        )
