"""Port parity: the spectral Huffman decode (K4's plain version)
against the JAX package's device interpreter on real v4 wires and on
random inputs, bit-exact; K4's two-level table against the flat LUT on
every prefix."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from soundkit_tpu.ops import aac_batch as jab
from soundkit_tpu.ops.aac_entropy import aac_spectral_decode_device
from soundkit_tpu_torch.ops import aac_batch as tab
from soundkit_tpu_torch.ops import aac_entropy as tae
from soundkit_tpu_torch.tools import kernel_check as kc

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


# ---------------------------------------------------------------------------
# K4's two-level table and random inputs
# ---------------------------------------------------------------------------

def _two_level_lookup(table, n_cb, first_bits=tae.LUT1_BITS):
    """The kernel's lookup, emulated for every codebook and 16-bit prefix:
    [n_cb, 65536] entries."""
    rest = tae.LUT_BITS - first_bits
    x = np.arange(1 << tae.LUT_BITS)
    t = table.astype(np.int64)
    e = t[np.arange(n_cb)[:, None] * (1 << first_bits) + (x >> rest)[None]]
    k = (e >> 16) & 15
    sub = t[np.where(e < 0, (e & 0xFFFF) + ((x & ((1 << rest) - 1))[None] >> (rest - k)), 0)]
    return np.where(e < 0, sub, e)


def test_two_level_table_equals_the_flat_lut_on_every_prefix():
    """K4's table looks up, for every codebook and 16-bit prefix, the
    flat LUT's entry."""
    flat = tae.build_spectral_lut()
    table = tae.build_spectral_lut2()
    np.testing.assert_array_equal(_two_level_lookup(table, 11), flat)
    assert table.size == 11 * 256 + 1142
    # every prefix is valid (complete codes): no lookup meets a zero entry
    assert np.count_nonzero(flat) == flat.size


def test_two_level_table_keeps_zero_entries():
    """A flat table with holes (entries 0, as the flat LUT marks an
    invalid prefix) and long codes maps every prefix, holes included,
    to its flat entry; a hole must never become a pointer's garbage."""
    rng = np.random.default_rng(5)
    flat = tae.build_spectral_lut().copy()
    for cb in range(11):
        for _ in range(3):
            lo = rng.integers(0, 1 << 16)
            flat[cb, lo : lo + rng.integers(1, 300)] = 0
    flat[2, 0x1234] = 0  # a single hole: a subtable of 2^8 entries
    table = tae.two_level_table(flat)
    np.testing.assert_array_equal(_two_level_lookup(table, 11), flat)
    assert (_two_level_lookup(table, 11) == 0).sum() == (flat == 0).sum() > 0


def test_spectral_tables_fit_the_kernels_shared_memory():
    """The two-level table takes at most the 16 KB of shared memory that
    K4's block gives it beside its run programs, AU rows and output rows
    (the flat LUT takes 2.75 MB)."""
    assert tae.build_spectral_lut2().nbytes <= 16 * 1024 < tae.build_spectral_lut().nbytes


def _jax_decode_inputs(au, bitpos, runs, n_runs):
    """The JAX interpreter on the port's K4 inputs (AU rows repeated per
    channel lane)."""
    a = jnp.asarray(au.numpy()).reshape(au.shape[0], -1, 4).astype(jnp.uint32)
    words = (a[..., 0] << 24) | (a[..., 1] << 16) | (a[..., 2] << 8) | a[..., 3]
    r = jnp.asarray(runs.numpy())
    return np.asarray(jax.jit(aac_spectral_decode_device)(
        jnp.repeat(words, 2, axis=0), jnp.asarray(bitpos.numpy()), r & 15, (r >> 4) & 63,
        (r >> 10) & 4095, jnp.asarray(n_runs.numpy())))


@pytest.mark.parametrize("seed", [1, 2])
def test_spectral_decode_plain_bit_exact_vs_jax_on_random_inputs(seed):
    """Random AU bytes, offsets and run programs (``kernel_check``'s K4
    random case): bit-exact against the JAX interpreter, with codebooks
    0 and 12-15 (which read codebook 11's table but never escape),
    escapes, outputs past line 1023 and wrapping windows all present."""
    au, bitpos, runs, n_runs = kc.spectral_random_inputs(24, seed)
    r = runs.numpy()
    used = np.arange(r.shape[1])[None] < n_runs.numpy()[:, None]
    cbs = set((r[used] & 15).tolist())
    assert {0, 11, 12, 13, 14, 15} <= cbs, cbs
    assert ((r[used] >> 10) & 4095).max() >= 1024
    assert (n_runs.numpy() == 0).any()
    ref = _jax_decode_inputs(au, bitpos, runs, n_runs)
    assert np.abs(ref).max() > 16  # escapes decoded
    np.testing.assert_array_equal(tae.spectral_decode_plain(au, bitpos, runs, n_runs).numpy(), ref)
