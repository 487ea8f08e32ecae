"""Port parity: the spectral Huffman decode (K4's plain version)
against the JAX package's device interpreter on real v4 wires,
bit-exact."""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from soundkit_tpu.ops import aac_batch as jab
from soundkit_tpu.ops.aac_entropy import aac_spectral_decode_device
from soundkit_tpu_torch.ops import aac_batch as tab
from soundkit_tpu_torch.ops import aac_entropy as tae

from torch_port_helpers import picked_aus, v4_wire


def _jax_decode(buf, B):
    """The JAX v4 step's own preparation of the interpreter inputs."""
    f = jab.unpack_v4_wire(jnp.asarray(buf), B)
    au = f["au"].reshape(B, jab.V4_AU_CAP // 4, 4).astype(jnp.uint32)
    words = (au[..., 0] << 24) | (au[..., 1] << 16) | (au[..., 2] << 8) | au[..., 3]
    runs = f["runs"].reshape(2 * B, jab.V4_RUNS)
    return np.asarray(jax.jit(aac_spectral_decode_device)(
        jnp.repeat(words, 2, axis=0),
        f["spec_bit"].reshape(2 * B).astype(jnp.int32),
        (runs & 15).astype(jnp.int32), ((runs >> 4) & 63).astype(jnp.int32),
        ((runs >> 10) & 4095).astype(jnp.int32),
        f["n_runs"].reshape(2 * B).astype(jnp.int32),
    ))


def _port_inputs(buf, B):
    f = tab.unpack_v4_wire(torch.from_numpy(buf), B)
    return (f["au"], f["spec_bit"].reshape(2 * B).to(torch.int32),
            f["runs"].reshape(2 * B, -1).to(torch.int32),
            f["n_runs"].reshape(2 * B).to(torch.int32))


def test_spectral_decode_plain_bit_exact_vs_jax():
    aus = picked_aus()
    B = len(aus)
    buf = v4_wire(aus)
    args = _port_inputs(buf, B)
    # coverage: every codebook and the codebook-11 escapes appear
    runs, n_runs = args[2].numpy(), args[3].numpy()
    cbs = {int(r & 15) for lane, n in zip(runs, n_runs) for r in lane[:n]}
    assert cbs == set(range(1, 12)), cbs
    got = tae.spectral_decode_plain(*args).numpy()
    assert np.abs(got).max() > 16  # escapes decoded
    np.testing.assert_array_equal(got, _jax_decode(buf, B))


def test_spectral_decode_wrapper_takes_plain_on_cpu():
    aus = picked_aus()[:6]
    args = _port_inputs(v4_wire(aus), len(aus))
    before = tae.spectral_decode.launches
    got = tae.spectral_decode(*args)
    assert tae.spectral_decode.launches == before
    assert torch.equal(got, tae.spectral_decode_plain(*args))
