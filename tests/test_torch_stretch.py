"""The port's phase vocoder (``soundkit_tpu_torch.ops.stretch``) against
the JAX package's on the CPU.

The device vocoder cannot agree with the JAX one elementwise: pocketfft
and XLA's FFT differ by ulps, so do ``torch.angle`` and ``jnp.angle``,
and the float32 running sum of the synthesis phase over the frames turns
an ulp of 1e4-1e5 rad into about 0.01 rad. So it is held by SNR: against
the JAX function at bars measured here (sine cases 68.8 and 72.8 dB, bar
60; the formant warp of a vowel 35.4 dB, bar 30: the log magnitude and
the cepstral lifter magnify the FFTs' ulps, and the JAX function itself
lies 31.2 dB from the float64 host path there; noise with the formant
pitch shift 58.6 dB, bar 50), and against the float64 host
``stretch_channels`` / ``stretch_pitch`` at the JAX tests' own bars (50
dB stretch, 25 dB formant warp, 40 dB pitch shift). The plain versions
of K16 and K17 are held bit for bit to the reference's sequential
overlap-add and to its ``_nearest_peak_np``; the host half and the
offline API, which are verbatim numpy, equal the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundkit_tpu import stretch as jax_stretch_api
from soundkit_tpu.core import audio_types as jax_at
from soundkit_tpu.ops import stretch as jst
from soundkit_tpu_torch import stretch as stretch_api
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.ops import phase_lock, stretch_ola
from soundkit_tpu_torch.ops import stretch as st
from soundkit_tpu_torch.tools import kernel_check as kc

from test_stretch import _formants, _vowel


def snr(ref, x):
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean((ref - x) ** 2), 1e-30))


def _sines(rate, base, step, n=3):
    t = np.arange(rate) / rate
    return np.stack([np.sin(2 * np.pi * (base + step * b) * t).astype(np.float32) * 0.5
                     for b in range(n)])


def test_stretch_matches_jax_and_host():
    sig = _sines(16000, 180, 60)
    ref = np.asarray(jax.jit(jst.stretch_batch_device, static_argnums=(1,))(sig, 1.25))
    got = st.stretch_batch_device(torch.from_numpy(sig), 1.25).numpy()
    host = np.stack([st.stretch_channels(sig[b:b + 1], 1.25)[0] for b in range(3)])
    assert got.shape == ref.shape == host.shape == (3, 20000)
    assert snr(ref, got) > 60, snr(ref, got)
    assert snr(host, got) > 50, snr(host, got)


def test_formant_warp_matches_jax_and_host():
    rate = 44100
    sig = _vowel(rate, 110.0, rate)
    ref = np.asarray(jax.jit(jst.stretch_batch_device, static_argnums=(1, 2))(sig[None], 1.2,
                                                                            1.5))[0]
    got = st.stretch_batch_device(torch.from_numpy(sig[None].astype(np.float32)), 1.2, 1.5)[0]
    got = got.numpy()
    host = st.stretch_channels(sig[None], 1.2, envelope_warp=1.5)[0]
    assert snr(ref, got) > 30, snr(ref, got)
    assert snr(host, got) > 25, snr(host, got)
    for a, b in zip(_formants(got, rate), _formants(sig, rate)):
        assert abs(a / (b / 1.5) - 1.0) < 0.12


def test_pitch_shift_matches_jax_and_host():
    sig = _sines(16000, 200, 50)
    f = jax.jit(jst.pitch_shift_batch_device, static_argnums=(1, 2, 3))
    ref = np.asarray(f(sig, 1.0, 1.5, None))
    got = st.pitch_shift_batch_device(torch.from_numpy(sig), 1.0, 1.5).numpy()
    host = np.stack([st.stretch_pitch(sig[b:b + 1], 1.0, 1.5)[0] for b in range(3)])
    assert got.shape == ref.shape == (3, 16000)
    assert snr(ref, got) > 60, snr(ref, got)
    n = min(host.shape[1], got.shape[1])
    assert snr(host[:, :n], got[:, :n]) > 40, snr(host[:, :n], got[:, :n])
    peak = np.argmax(np.abs(np.fft.rfft(got[0] * np.hanning(16000))))
    assert abs(peak - 300) < 5, peak


def test_pitch_shift_with_formants_on_noise_matches_jax_and_host():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 16000)) * 0.3).astype(np.float32)
    f = jax.jit(jst.pitch_shift_batch_device, static_argnums=(1, 2, 3))
    ref = np.asarray(f(x, 1.25, 1.5, 1.0))
    got = st.pitch_shift_batch_device(torch.from_numpy(x), 1.25, 1.5, 1.0).numpy()
    host = np.stack([st.stretch_pitch(x[b:b + 1], 1.25, 1.5, 1.0)[0] for b in range(2)])
    assert got.shape == ref.shape == host.shape == (2, 20000)
    assert snr(ref, got) > 50, snr(ref, got)
    assert snr(host, got) > 40, snr(host, got)


@pytest.mark.parametrize("B,T,hop,target", [(2, 9, 960, 3000), (3, 5, 640, 4000),
                                            (1, 4, 2048, 9000), (2, 7, 333, 1500)])
def test_overlap_add_plain_is_the_reference_scan_bit_for_bit(B, T, hop, target):
    """K16's plain version against the reference's ``lax.scan`` of
    ``dynamic_update_slice`` adds (the lines of ``stretch_batch_device``
    from the windowed frames to the crop), on the same frames."""
    frames, win = kc.stretch_ola_inputs(B + T + hop, B, T, torch.device("cpu"))
    fw = jnp.asarray((frames * win).numpy())
    F = frames.shape[-1]
    out_len = hop * (T - 1) + F
    win2 = jnp.asarray((win * win).numpy())[None, :]

    def ola(carry, xs):
        out, norm, t = carry
        pos = t * hop
        out = jax.lax.dynamic_update_slice(
            out, jax.lax.dynamic_slice(out, (0, pos), (B, F)) + xs, (0, pos))
        norm = jax.lax.dynamic_update_slice(
            norm, jax.lax.dynamic_slice(norm, (0, pos), (1, F)) + win2, (0, pos))
        return (out, norm, t + 1), None

    (out, norm, _), _ = jax.lax.scan(ola, (jnp.zeros((B, out_len), jnp.float32),
                                           jnp.zeros((1, out_len), jnp.float32), jnp.int32(0)),
                                     jnp.swapaxes(fw, 0, 1))
    out = np.asarray(out / jnp.maximum(norm, 1e-8))[:, F // 2:F // 2 + target]
    ref = np.pad(out, ((0, 0), (0, target - out.shape[1])))
    got = stretch_ola.overlap_add(frames, win, hop, target).numpy()
    np.testing.assert_array_equal(got, ref)


def test_nearest_peak_plain_equals_the_host_rule_with_ties_and_flat_runs():
    mag, _, _ = kc.phase_lock_inputs(3, 9, 1025, torch.device("cpu"))
    mag[2] = 0.0                      # a silent frame: its last bin is the only peak
    mag[3, ::2] = 1.0                 # alternating plateau
    mag[3, 1::2] = 1.0
    mag[4, 100:110] = 7.0             # a flat-topped peak
    mag[5, 500] = mag[5, 510] = 9.0   # two peaks, bins between at equal distance
    mag[5, 501:510] = 0.0
    got = phase_lock.nearest_peak_plain(mag).numpy()
    np.testing.assert_array_equal(got, jst._nearest_peak_np(mag.numpy()))
    assert got[5, 505] == 500 and got[2].tolist() == [1024] * 1025


def test_phase_lock_plain_matches_the_host_resynthesis():
    """K17's plain spectrum equals the host path's lines on the same
    inputs within float32 rounding (the host computes in float64)."""
    mag, phase, syn = kc.phase_lock_inputs(4, 6, 1025, torch.device("cpu"), span=50.0)
    got = phase_lock.phase_lock(mag, phase, syn).numpy()
    m, p, s = (t.numpy().astype(np.float64) for t in (mag, phase, syn))
    nearest = jst._nearest_peak_np(m)
    rot = np.take_along_axis(s, nearest, -1) - np.take_along_axis(p, nearest, -1)
    ref = m * np.exp(1j * (p + rot))
    np.testing.assert_allclose(got, ref, atol=4e-5 * np.abs(m).max())


def test_host_half_and_offline_api_equal_the_jax_package():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 6000)) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(st.stretch_pitch(x, 1.3, 0.8, 1.0),
                                  jst.stretch_pitch(x, 1.3, 0.8, 1.0))
    pcm = (x.T.reshape(-1) * 20000).astype("<i2").tobytes()
    audio = AudioData(16, 2, 16000, pcm, EncodingFlag.PCM_SIGNED, Endianness.LITTLE)
    jaudio = jax_at.AudioData(16, 2, 16000, pcm, jax_at.EncodingFlag.PCM_SIGNED,
                              jax_at.Endianness.LITTLE)
    cfg = stretch_api.OfflineStretchConfig.recommended_for_music(16000, 2).with_time_ratio(1.2) \
        .with_pitch_scale(1.1).with_formant_preserved()
    jcfg = jax_stretch_api.OfflineStretchConfig.recommended_for_music(16000, 2) \
        .with_time_ratio(1.2).with_pitch_scale(1.1).with_formant_preserved()
    for port_fn, ref_fn in ((stretch_api.stretch_audio_data, jax_stretch_api.stretch_audio_data),
                            (stretch_api.stretch_audio_data_preserve_format,
                             jax_stretch_api.stretch_audio_data_preserve_format)):
        assert port_fn(audio, cfg).data == ref_fn(jaudio, jcfg).data
    with pytest.raises(stretch_api.StretchError, match="pitch_scale"):
        stretch_api.stretch_deinterleaved([x[0]], stretch_api.OfflineStretchConfig(16000, 1,
                                                                                   pitch_scale=9))
