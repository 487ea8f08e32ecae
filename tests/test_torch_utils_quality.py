"""The JAX package's tests of ``utils/quality.py``, ``utils/waveform.py``,
``utils/test_utils.py`` and ``utils/tracing.py`` (``tests/test_utils_quality.py``),
run against the port's copies: ``DecodeResult``, ``PcmStats``,
``QualityComparison`` (offset search, SNR and the default thresholds),
``BenchResult``, the ASCII waveform, and the logging hooks, which are
silent by default."""
import numpy as np

from soundkit_tpu_torch.utils.quality import (
    BenchResult,
    PcmStats,
    QualityComparison,
)
from soundkit_tpu_torch.utils.test_utils import DecodeResult, render_waveform


def test_decode_result_metrics():
    t = np.arange(16000)
    pcm = (np.sin(2 * np.pi * 440 * t / 16000) * 16384).astype(np.int16)
    r = DecodeResult.new(pcm, 16000, 1)
    assert r.sample_count == 16000
    assert abs(r.duration_secs - 1.0) < 1e-9
    assert abs(r.rms - 0.5 / np.sqrt(2)) < 0.01
    assert len(r.waveform) == 120
    assert r.rms_db < 0
    art = render_waveform(r.waveform)
    assert "█" in art


def test_decode_result_i32_bits():
    pcm = np.array([1 << 22, -(1 << 22)], dtype=np.int32)  # half scale at 24-bit
    r = DecodeResult.from_i32_with_bits(pcm, 48000, 1, 24)
    assert abs(r.rms - 0.5) < 1e-6


def test_pcm_stats_checksum_changes():
    a = PcmStats.from_pcm(np.array([0.1, 0.2], np.float32))
    b = PcmStats.from_pcm(np.array([0.1, 0.2000001], np.float32))
    assert a.checksum != b.checksum
    assert a.sample_count == 2


def test_quality_comparison_identical_passes():
    x = np.sin(np.arange(50000) * 0.01).astype(np.float32) * 0.5
    qc = QualityComparison.compare(x, x)
    assert qc.rmse == 0 and qc.snr_db > 100
    assert qc.passes_default_thresholds()


def test_quality_comparison_offset_search():
    x = np.sin(np.arange(50000) * 0.01) * 0.5
    shifted = np.concatenate([np.zeros(100), x])
    qc = QualityComparison.compare_aligned(x, shifted, 1, 200)
    assert qc.candidate_sample_offset == 100
    assert qc.snr_db > 100
    assert qc.offset_in_frames(1) == 100


def test_quality_comparison_fails_on_noise():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(10000) * 0.3
    y = x + rng.standard_normal(10000) * 0.1
    qc = QualityComparison.compare(x, y)
    assert not qc.passes_default_thresholds()
    assert 5 < qc.snr_db < 15


def test_bench_result():
    b = BenchResult("aac", frames=1000, samples_per_frame=1024, channels=2,
                    sample_rate=48000, elapsed_seconds=0.1)
    assert abs(b.audio_seconds - 1000 * 1024 / 48000) < 1e-9
    assert b.real_time_factor < 0.01
    assert "x realtime" in str(b)


def test_waveform_chart():
    """ASCII waveform analog (soundkit-decoder lib.rs:2729-2853)."""
    import numpy as np

    from soundkit_tpu_torch.utils.waveform import (
        WAVEFORM_WIDTH,
        render_waveform,
        waveform_chart,
        waveform_peaks,
    )

    t = np.arange(16000) / 16000.0
    pcm = (np.sin(2 * np.pi * 3 * t) * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    peaks = waveform_peaks(pcm)
    assert peaks.shape == (WAVEFORM_WIDTH,) and peaks.max() <= 1.0
    lines = render_waveform(peaks)
    assert len(lines) == 8 and all(len(ln) == 2 + WAVEFORM_WIDTH for ln in lines)
    # mirrored: bottom half is the top half reversed
    assert lines[:4] == list(reversed(lines[4:]))
    chart = waveform_chart("test", pcm, 16000)
    assert "(1.00s" in chart and "dB)" in chart
    # silence renders empty rows, not a crash
    assert "no audio data" in render_waveform(np.zeros(0))[0]


def test_tracing_hooks(caplog):
    """Silent by default; emits under DEBUG/TRACE like the reference's
    subscriber-less tracing."""
    import logging

    from soundkit_tpu_torch.utils.tracing import TRACE, debug_init, stage_timer, trace_frame

    debug_init("flac", rate=16000)  # no handler configured: no output
    with caplog.at_level(logging.DEBUG, logger="soundkit_tpu"):
        debug_init("flac", rate=16000)
    assert any("init flac" in r.getMessage() for r in caplog.records)
    caplog.clear()
    with caplog.at_level(TRACE, logger="soundkit_tpu"):
        trace_frame("mp3", rate=16000)
    assert any("frame mp3" in r.getMessage() for r in caplog.records)

    stages = {}
    with stage_timer(stages, "parse"):
        pass
    with stage_timer(stages, "parse"):
        pass
    assert stages["parse"] >= 0.0
