"""Port parity: soundkit_tpu_torch's telephony ops (G.711 companding, the
G.726 and G.722 scans) against the JAX package's on the CPU, bit-exact:
PCM or codes and the carried state. K3's reference is the Pallas kernel
in interpret mode, as tests/test_pallas_kernels.py runs it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundkit_tpu.ops import adpcm as jax_adpcm
from soundkit_tpu.ops import companding as jax_companding
from soundkit_tpu.ops import g722 as jax_g722
from soundkit_tpu.ops import pallas_kernels as pk
from soundkit_tpu_torch.models.telephony_batch import state_from_jax
from soundkit_tpu_torch.ops import adpcm, companding, g722

B, N = 6, 300


def _valid(n=N, seed=0):
    """Ragged mask: a full lane, a lane that stops, lanes with holes,
    an empty lane."""
    rng = np.random.default_rng(seed)
    v = rng.random((B, n)) < 0.85
    v[0] = True
    v[1, n // 3:] = False
    v[2, : n // 2] = True
    v[5] = False
    return v


def _pcm(n, seed=0):
    """Synthetic int16 speech-band PCM: tones at several levels over
    noise, one lane clipped at full scale, one near silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.sin(2 * np.pi * t[None] * rng.uniform(0.005, 0.3, (B, 1))) * rng.uniform(200, 30000, (B, 1))
    x += rng.normal(0, 1, (B, n)) * rng.uniform(0, 2000, (B, 1))
    x[3] *= 8
    x[4] = rng.integers(-3, 4, n)
    return np.clip(x, -32768, 32767).astype(np.int16)


def _port_state(st):
    return state_from_jax(st, "cpu")


def test_g711_decode_matches_pallas_kernel():
    """Every code under both laws, with and without a ragged count."""
    codes = np.stack([np.roll(np.tile(np.arange(256), 2), 37 * i) for i in range(8)]).astype(np.int32)
    is_alaw = (np.arange(8) % 2).astype(np.int32)[:, None]
    ref = np.asarray(pk.g711_decode_pallas(jnp.asarray(codes), jnp.asarray(is_alaw)))
    counts = np.array([512, 0, 1, 255, 256, 300, 511, 17], np.int32)
    ref_masked = np.where(np.arange(512)[None] < counts[:, None], ref, 0)

    c = torch.from_numpy(codes.astype(np.uint8))
    law = torch.from_numpy(is_alaw)
    np.testing.assert_array_equal(companding.g711_decode(c, law).numpy(), ref)
    got = companding.g711_decode(c, law[:, 0], torch.from_numpy(counts))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), ref_masked)


@pytest.mark.parametrize("law", ["mulaw", "alaw"])
def test_g711_encode_matches_jax_on_every_int16(law):
    s = np.arange(-32768, 32768).astype(np.int16)
    ref = getattr(jax_companding, f"encode_{law}_np")(s)
    got = getattr(companding, f"encode_{law}")(torch.from_numpy(s))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


def test_quan_power2_closed_form():
    """The G.726 kernel's quan(v) = min(bit_length(v), 15) for v > 0,
    else 0, is the plain count of 2^i <= v over every v in [0, 32767]."""
    v = np.arange(-1, 32768)
    closed = np.where(v > 0, np.minimum(np.floor(np.log2(np.maximum(v, 1))) + 1, 15), 0)
    got = adpcm._quan_power2(torch.from_numpy(v.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, closed)


def test_initial_states_match_jax():
    assert adpcm.G726_LAYOUT.width == 24 and g722.G722_LAYOUT.width == 70
    assert torch.equal(adpcm.g726_init_state(B, "cpu"), _port_state(jax_adpcm.g726_init_state(B)))
    assert torch.equal(g722.g722_init_state(B, "cpu"), _port_state(jax_g722.g722_init_state(B)))


@pytest.mark.parametrize("direction", ["decode", "encode"])
@pytest.mark.parametrize("bits", [2, 3, 4, 5])
def test_g726_scan_matches_jax(bits, direction):
    """Decode random codes, encode synthetic PCM; ragged mask."""
    valid = _valid(seed=bits)
    if direction == "decode":
        xs = np.random.default_rng(bits).integers(0, 1 << bits, (B, N)).astype(np.uint8)
        ref, ref_st = jax_adpcm.g726_decode_scan(
            jnp.asarray(xs, jnp.int32), jax_adpcm.g726_init_state(B, jnp), bits, jnp.asarray(valid))
        got, st = adpcm.g726_decode_scan(torch.from_numpy(xs), adpcm.g726_init_state(B, "cpu"), bits,
                                         torch.from_numpy(valid))
    else:
        xs = _pcm(N, seed=bits)
        ref, ref_st = jax_adpcm.g726_encode_scan(
            jnp.asarray(xs, jnp.int32), jax_adpcm.g726_init_state(B, jnp), bits, jnp.asarray(valid))
        got, st = adpcm.g726_encode_scan(torch.from_numpy(xs), adpcm.g726_init_state(B, "cpu"), bits,
                                         torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(st, _port_state(ref_st))
    assert np.count_nonzero(np.asarray(ref)) > 0


@pytest.mark.parametrize("direction", ["decode", "encode"])
def test_g722_scan_matches_jax(direction):
    valid = _valid(seed=7)
    if direction == "decode":
        xs = np.random.default_rng(7).integers(0, 256, (B, N)).astype(np.uint8)
        ref, ref_st = jax_g722.g722_decode_scan(
            jnp.asarray(xs, jnp.int32), jax_g722.g722_init_state(B, jnp), jnp.asarray(valid))
        got, st = g722.g722_decode_scan(torch.from_numpy(xs), g722.g722_init_state(B, "cpu"),
                                        torch.from_numpy(valid))
    else:
        xs = _pcm(2 * N, seed=7)
        ref, ref_st = jax_g722.g722_encode_scan(
            jnp.asarray(xs, jnp.int32), jax_g722.g722_init_state(B, jnp), jnp.asarray(valid))
        got, st = g722.g722_encode_scan(torch.from_numpy(xs), g722.g722_init_state(B, "cpu"),
                                        torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(st, _port_state(ref_st))
    assert np.count_nonzero(np.asarray(ref)) > 0


@pytest.mark.parametrize("codec", ["g726_40", "g722"])
def test_state_from_jax_continues_the_scan(codec):
    """JAX decodes the first half, the port continues from the handed-over
    state, and the whole equals JAX's decode of the whole."""
    h = N // 2
    if codec == "g722":
        codes = np.asarray(jax_g722.g722_encode_scan(
            jnp.asarray(_pcm(2 * N, seed=3), jnp.int32), jax_g722.g722_init_state(B, jnp))[0])
        scan = lambda c, st: jax_g722.g722_decode_scan(jnp.asarray(c, jnp.int32), st)
        port_scan, init = g722.g722_decode_scan, jax_g722.g722_init_state(B, jnp)
    else:
        codes = np.asarray(jax_adpcm.g726_encode_scan(
            jnp.asarray(_pcm(N, seed=3), jnp.int32), jax_adpcm.g726_init_state(B, jnp), 5)[0])
        scan = lambda c, st: jax_adpcm.g726_decode_scan(jnp.asarray(c, jnp.int32), st, 5)
        port_scan = lambda c, st: adpcm.g726_decode_scan(c, st, 5)
        init = jax_adpcm.g726_init_state(B, jnp)
    whole, whole_st = scan(codes, init)
    _, half_st = scan(codes[:, :h], init)
    rest, st = port_scan(torch.from_numpy(codes[:, h:].astype(np.uint8)), _port_state(half_st))
    spc = 2 if codec == "g722" else 1
    np.testing.assert_array_equal(rest.numpy(), np.asarray(whole)[:, spc * h:])
    assert torch.equal(st, _port_state(whole_st))
