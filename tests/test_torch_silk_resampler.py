"""The port's SILK resampler (``utils/silk_resampler.py``, a numpy
polyphase FIR over the probed taps) against the JAX package's
``utils/swr.SilkResampler``, which drives libswresample: output counts
identical call by call, and values at 90 dB or better (the port's bar
for float32 SILK), over Opus superframes at NB, MB and WB, mono and
stereo, a bandwidth switch with its drain, and odd call patterns (empty
inputs, which flush there, and calls before the filter has a window)."""
import numpy as np
import pytest

from soundkit_tpu.utils.swr import SilkResampler as JaxResampler
from soundkit_tpu_torch.utils.silk_resampler import SILK_RESAMPLE_DELAY, SilkResampler

from torch_port_helpers import snr_db

RATES = (8000, 12000, 16000)
BAR_DB = 90.0


def _run(calls, bw: int, channels: int, seed: int):
    """Drive both resamplers with ``calls`` ((input samples, asked) or
    ("drain", asked)); returns their outputs, asserting equal counts."""
    rng = np.random.default_rng(seed)
    port = SilkResampler(RATES[bw], bw, channels)
    ref = JaxResampler(RATES[bw], bw, channels)
    got, want = [], []
    for k, (n, ask) in enumerate(calls):
        if n == "drain":
            g, w = port.drain(ask), ref.drain(ask)
        else:
            x = rng.standard_normal((n, channels)) * 0.3
            g, w = port.process(x, ask), ref.process(x, ask)
        assert g.dtype == w.dtype == np.float32
        assert g.shape == w.shape, (k, n, ask, g.shape, w.shape)
        got.append(g)
        want.append(w)
    return np.concatenate(got), np.concatenate(want)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bw", [0, 1, 2])
def test_superframes_match_libswresample(bw, channels):
    """10, 20, 40 and 60 ms superframes, each asking for its duration at
    48 kHz, as ``opus_core`` asks: the first NB frame comes up 24 short."""
    rng = np.random.default_rng(bw * 2 + channels)
    durations = rng.choice([10, 20, 40, 60], 30)
    calls = [(RATES[bw] // 1000 * int(d), int(d) * 48) for d in durations]
    got, want = _run(calls, bw, channels, seed=bw)
    assert snr_db(got, want) >= BAR_DB
    first = SilkResampler(RATES[bw], bw, channels).process(np.zeros((RATES[bw] // 50, channels)), 960)
    assert first.shape[0] == (936 if bw == 0 else 960)
    assert SILK_RESAMPLE_DELAY == {0: 4, 1: 8, 2: 11}


@pytest.mark.parametrize("channels", [1, 2])
def test_bandwidth_switch_drains_like_libswresample(channels):
    """An NB span, then the drain of its delayed samples, then a fresh WB
    resampler: the counts and values of ``opus_core``'s switch."""
    calls = [(160, 960)] * 5 + [("drain", 24)]
    got, want = _run(calls, 0, channels, seed=5)
    assert got.shape[0] == 5 * 960 - 24 + 24
    assert snr_db(got, want) >= BAR_DB
    got, want = _run([(320, 960)] * 5, 2, channels, seed=6)
    assert got.shape[0] == 5 * 960 and snr_db(got, want) >= BAR_DB


@pytest.mark.parametrize("bw", [0, 1, 2])
def test_odd_call_patterns_match_libswresample(bw):
    """Random input sizes and asks, empty inputs (a flush there, whose
    reflection stays in the stream), drains, and calls before 17 input
    samples have arrived."""
    rng = np.random.default_rng(40 + bw)
    for trial in range(30):
        calls = []
        for _ in range(int(rng.integers(1, 10))):
            r = rng.random()
            if r < 0.2:
                calls.append((0, int(rng.integers(0, 500))))
            elif r < 0.3:
                calls.append(("drain", int(rng.integers(-1, 80))))
            elif r < 0.5:
                calls.append((int(rng.integers(1, 20)), int(rng.integers(0, 200))))
            else:
                calls.append((int(rng.integers(0, 400)), int(rng.integers(0, 3000))))
        got, want = _run(calls, bw, 1 + trial % 2, seed=trial)
        if np.any(want):
            assert snr_db(got, want) >= BAR_DB, (trial, calls)
