"""The port's resampler (``soundkit_tpu_torch.ops.resample``) against the
JAX package's on the CPU: the one-shot and the carried-state device forms
within the reference's own host-vs-device bar (atol 2e-5), chunked equal
to one-shot bit for bit on the CPU path, the history the JAX function
carries fed to the port, and the numpy pieces above it
(``StreamingResampler``, ``downsample_audio``, ``resample_np``) bit for bit
the JAX package's. Also the convolution guard ``utils.device.ieee_fp32``
and the shape of K15's tiles for every supported rate pair."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundkit_tpu.core import audio_pipeline as jax_ap
from soundkit_tpu.core import audio_types as jax_at
from soundkit_tpu.ops import resample as jax_rs
from soundkit_tpu.pipeline.resampler import StreamingResampler as JaxStreamingResampler
from soundkit_tpu_torch.core import audio_pipeline as ap
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.ops import resample as rs
from soundkit_tpu_torch.pipeline.resampler import StreamingResampler
from soundkit_tpu_torch.tools import kernel_check as kc

REPO = Path(__file__).resolve().parent.parent
PAIRS = [(48000, 16000), (44100, 48000), (44100, 8000), (8000, 44100), (3000, 2000)]


def _rows(seed, B, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("in_rate,out_rate", PAIRS)
def test_resample_matches_jax(in_rate, out_rate):
    x = _rows(in_rate + out_rate, 3, 4410 + 17)
    ref = np.asarray(jax.jit(lambda a: jax_rs.resample(a, in_rate, out_rate))(x))
    got = rs.resample(torch.from_numpy(x), in_rate, out_rate).numpy()
    assert got.shape == ref.shape == (3, rs.out_len(x.shape[1], *rs.design_polyphase(
        in_rate, out_rate)[2:4]))
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got, rs.resample_np(x, in_rate, out_rate), atol=2e-5)


@pytest.mark.parametrize("in_rate,out_rate", PAIRS)
def test_resample_stateful_matches_jax_and_one_shot(in_rate, out_rate):
    """Three chunks through the carried-state form: within 2e-5 of the JAX
    function's chunks, and concatenated equal to the port's one-shot
    resample bit for bit (torch's CPU convolution sums each output in an
    order that does not change with the row's length)."""
    L, M = rs.design_polyphase(in_rate, out_rate)[2:4]
    chunk = M * max(1, 900 // M)
    x = _rows(7, 2, 3 * chunk)
    f = jax.jit(jax_rs.resample_stateful, static_argnums=(2, 3))
    jh = jnp.asarray(jax_rs.resample_init_state(2))
    th = rs.resample_init_state(2, device="cpu")
    outs, refs = [], []
    for k in range(3):
        c = x[:, k * chunk:(k + 1) * chunk]
        o, jh = f(jnp.asarray(c), jh, in_rate, out_rate)
        refs.append(np.asarray(o))
        t, th = rs.resample_stateful(torch.from_numpy(c), th, in_rate, out_rate)
        outs.append(t.numpy())
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    got = np.concatenate(outs, 1)
    assert got.shape == (2, 3 * chunk * L // M)
    np.testing.assert_allclose(got, np.concatenate(refs, 1), atol=2e-5)
    one = rs.resample(torch.from_numpy(x), in_rate, out_rate).numpy()
    np.testing.assert_array_equal(got, one)


def test_carried_history_from_the_jax_function():
    """The history the JAX function leaves after chunk 1 continues the
    port's chunk 2 as its own would."""
    x = _rows(11, 2, 2 * 441 * 16)
    c1, c2 = x[:, :441 * 16], x[:, 441 * 16:]
    f = jax.jit(jax_rs.resample_stateful, static_argnums=(2, 3))
    _, jh = f(jnp.asarray(c1), jnp.asarray(jax_rs.resample_init_state(2)), 44100, 8000)
    ref, _ = f(jnp.asarray(c2), jh, 44100, 8000)
    got, hist = rs.resample_stateful(torch.from_numpy(c2), torch.from_numpy(np.asarray(jh)),
                                     44100, 8000)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_array_equal(hist.numpy(), c2[:, -255:])


def test_stateful_refuses_a_misaligned_chunk_like_the_reference():
    x = np.zeros((1, 440), np.float32)
    with pytest.raises(ValueError) as ref:
        jax_rs.resample_stateful(jnp.asarray(x), jnp.asarray(jax_rs.resample_init_state(1)),
                                 44100, 8000)
    with pytest.raises(ValueError) as got:
        rs.resample_stateful(torch.from_numpy(x), rs.resample_init_state(1, "cpu"), 44100, 8000)
    assert str(got.value) == str(ref.value) == "chunk length 440 must satisfy n*80 % 441 == 0"


def test_same_rate_passes_through():
    x = torch.from_numpy(_rows(1, 2, 100))
    h = rs.resample_init_state(2, "cpu")
    assert rs.resample(x, 16000, 16000) is x
    assert rs.resample_stateful(x, h, 16000, 16000) == (x, h)


def test_init_state_is_a_zero_tensor():
    """The port's ``resample_init_state`` returns a tensor on the device it
    is given (the reference's, numpy zeros of the same shape)."""
    h = rs.resample_init_state(3, device="cpu")
    ref = jax_rs.resample_init_state(3)
    assert isinstance(h, torch.Tensor) and h.dtype == torch.float32 and h.device.type == "cpu"
    np.testing.assert_array_equal(h.numpy(), ref)


def test_streaming_resampler_equals_the_jax_package_on_a_random_chunking():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 20000)) * 0.5).astype(np.float32)
    for in_rate, out_rate in ((44100, 8000), (8000, 48000), (48000, 48000)):
        port, ref = StreamingResampler(in_rate, out_rate, 2), \
            JaxStreamingResampler(in_rate, out_rate, 2)
        lo = 0
        while lo < x.shape[1]:
            n = int(rng.integers(1, 3000))
            np.testing.assert_array_equal(port.process(x[:, lo:lo + n]),
                                          ref.process(x[:, lo:lo + n]))
            lo += n
        assert port.flush().shape == ref.flush().shape == (2, 0)


@pytest.mark.parametrize("in_rate,out_rate", PAIRS + [(96000, 22050)])
def test_resample_np_equals_the_jax_package(in_rate, out_rate):
    x = _rows(5, 2, 3001)
    np.testing.assert_array_equal(rs.resample_np(x, in_rate, out_rate),
                                  jax_rs.resample_np(x, in_rate, out_rate))


@pytest.mark.parametrize("bits,fmt", [(16, EncodingFlag.PCM_SIGNED), (32, EncodingFlag.PCM_FLOAT),
                                      (24, EncodingFlag.PCM_SIGNED)])
def test_downsample_audio_equals_the_jax_package(bits, fmt):
    rng = np.random.default_rng(bits)
    data = rng.integers(0, 256, 2 * 4410 * bits // 8, dtype=np.uint8).tobytes()
    if bits == 32:
        data = (rng.standard_normal(2 * 4410) * 0.3).astype("<f4").tobytes()
    port = ap.downsample_audio(AudioData(bits, 2, 44100, data, fmt, Endianness.LITTLE), 8000)
    ref = jax_ap.downsample_audio(jax_at.AudioData(bits, 2, 44100, data, jax_at.EncodingFlag[fmt.name],
                                                   jax_at.Endianness.LITTLE), 8000)
    assert len(port) == len(ref) == 2
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="Unsupported output sample_rate"):
        ap.downsample_audio(AudioData(bits, 2, 44100, data, fmt, Endianness.LITTLE), 12345)


@pytest.mark.parametrize("in_rate,out_rate", kc.RESAMPLE_PAIRS)
def test_k15_tiles_fit_for_every_rate_pair(in_rate, out_rate):
    """K15's tile for every supported pair stages at most 48 KB of input
    (the kernel refuses more), holds whole cycles of CYCLES_PER_THREAD,
    and the plain version gives ``ceil(n L / M)`` outputs there."""
    L, M = rs.design_polyphase(in_rate, out_rate)[2:4]
    for n_cycles in (1, 64, 55125):
        ct = rs.tile_cycles(L, M, n_cycles)
        assert ct % rs.CYCLES_PER_THREAD == 0
        assert (ct * M + rs.SINC_LEN - 1) * 4 <= 48 * 1024
    x = torch.from_numpy(_rows(2, 1, 2 * M + 5))
    assert rs.resample(x, in_rate, out_rate).shape == (1, rs.out_len(2 * M + 5, L, M))


def _flag_state():
    """Every precision flag the guard touches; None where torch refuses to
    read one (a caller that mixed the older and the newer API)."""
    cudnn = torch.backends.cudnn
    getters = [torch.get_float32_matmul_precision, lambda: torch.backends.cuda.matmul.allow_tf32,
               lambda: cudnn.allow_tf32]
    getters += [lambda n=n: n.fp32_precision
                for n in (torch.backends.cuda.matmul, cudnn, getattr(cudnn, "conv", None),
                          getattr(cudnn, "rnn", None)) if hasattr(n, "fp32_precision")]
    out = []
    for g in getters:
        try:
            out.append(g())
        except RuntimeError:
            out.append(None)
    return tuple(out)


CALLERS = {
    "default": lambda: None,
    "medium_and_cudnn_tf32": lambda: (torch.set_float32_matmul_precision("medium"),
                                      setattr(torch.backends.cudnn, "allow_tf32", True)),
    "legacy_tf32_everywhere": lambda: (setattr(torch.backends.cuda.matmul, "allow_tf32", True),
                                       setattr(torch.backends.cudnn, "allow_tf32", True)),
    "cudnn_off": lambda: setattr(torch.backends.cudnn, "allow_tf32", False),
    "newer_api_tf32": lambda: [setattr(n, "fp32_precision", "tf32") for n in (
        torch.backends.cuda.matmul, getattr(torch.backends.cudnn, "conv", None))
        if hasattr(n, "fp32_precision")],
}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_ieee_fp32_pins_and_restores_every_flag(caller):
    """Inside the guard cuDNN convolutions and matrix products run in IEEE
    float32 (TF32 off through both of torch's APIs); on exit, after an
    exception too, every setting the caller had comes back."""
    script = f"""
import torch, sys
sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})
from test_torch_resample import CALLERS, _flag_state
from soundkit_tpu_torch.utils.device import ieee_fp32
CALLERS[{caller!r}]()
caller = _flag_state()
with ieee_fp32():
    inside = _flag_state()
assert caller == _flag_state(), (caller, _flag_state())
try:
    with ieee_fp32():
        raise KeyError("inside")
except KeyError:
    pass
assert caller == _flag_state(), (caller, _flag_state())
assert inside[:3] == ("highest", False, False), inside
assert all(v == "ieee" for v in inside[3:]), inside
print("restored", caller)
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "restored" in proc.stdout
