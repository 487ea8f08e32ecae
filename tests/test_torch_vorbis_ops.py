"""Port parity of the batched Vorbis synthesis: ``soundkit_tpu_torch.ops.vorbis_batch``
against ``soundkit_tpu.ops.vorbis_batch`` on the CPU, on numpy-seeded
rounds. The window bank is bit-identical; the step's PCM and new lap are
within 1e-6 of the largest reference value (the IMDCT products are summed
in another order by the two packages), its lengths and new flags equal.
The port's copies of ``imdct_matrix`` and ``vorbis_window`` equal the
originals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundkit_tpu.codecs import vorbis_core as jax_core
from soundkit_tpu.ops import vorbis_batch as jax_vb
from soundkit_tpu_torch.codecs import vorbis_core
from soundkit_tpu_torch.ops import vorbis_batch as vb
from soundkit_tpu_torch.ops import vorbis_overlap as vo
from soundkit_tpu_torch.tools import kernel_check as kc

TOPOLOGIES = [(256, 2048), (512, 4096), (256, 256)]
BAR = 1e-6


@pytest.mark.parametrize("n0,n1", TOPOLOGIES + [(64, 8192)])
def test_window_bank_is_bit_identical(n0, n1):
    got, want = vb.window_bank(n0, n1), jax_vb.window_bank(n0, n1)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for a, b in zip(vb.init_state(5, 2, n1), jax_vb.init_state(5, 2, n1)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [64, 256, 512, 2048, 8192])
def test_imdct_matrix_and_window_equal_the_originals(n):
    np.testing.assert_array_equal(vorbis_core.imdct_matrix(n), jax_core.imdct_matrix(n))
    np.testing.assert_array_equal(vorbis_core.vorbis_window(n // 2), jax_core.vorbis_window(n // 2))


def random_rounds(seed: int, B: int, C: int, n0: int, n1: int, rounds: int):
    """Per round: (spec [B, C, n1/2] f32, n_flag, prev_flag, next_flag,
    valid) as numpy, from seeded per-lane block sequences: every (previous,
    current) size case occurs (lane 1 takes them in turn), lanes go idle
    (invalid) for whole rounds, lane 0 only from round 2 on (it stays
    unprimed until then). A short
    block's spectrum is zero past n0/2, as the decoder packs it."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        n_flag = rng.integers(0, 2, B).astype(np.int32)
        n_flag[1] = (r // 2) % 2  # short, short, long, long, ...: every case in turn
        valid = rng.random(B) >= 0.25
        valid[0], valid[1] = r >= 2, True
        pf, nf = rng.integers(0, 2, (2, B)).astype(np.int32)
        spec = (rng.standard_normal((B, C, n1 // 2)) * 0.05).astype(np.float32)
        spec[n_flag == 0, :, n0 // 2:] = 0.0
        spec[~valid] = 0.0
        out.append((spec, n_flag, pf, nf, valid))
    return out


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("n0,n1", TOPOLOGIES)
def test_synth_step_plain_matches_jax_over_chained_rounds(n0, n1, C):
    """Five lanes over six chained rounds, each package carrying its own
    lap and flag: PCM and lap within 1e-6 of the largest reference value,
    lengths and flags equal; the dispatching step equals the plain one on
    the CPU bit for bit."""
    B = 5
    carry_np, cflag_np = vb.init_state(B, C, n1)
    port = (torch.from_numpy(carry_np), torch.from_numpy(cflag_np))
    ref = (jnp.asarray(carry_np), jnp.asarray(cflag_np))
    primed = np.zeros(B, bool)
    cases = set()
    for spec, n_flag, pf, nf, valid in random_rounds(7 * n0 + n1 + C, B, C, n0, n1, 6):
        cases |= {(int(a), int(b)) for a, b, v in zip(np.asarray(ref[1]), n_flag, valid) if v}
        args = [spec, n_flag, pf, nf, valid, primed.copy()]
        want = jax_vb.vorbis_synth_step(*(jnp.asarray(a) for a in args), ref[0], ref[1],
                                        n0=n0, n1=n1)
        got = vb.vorbis_synth_step_plain(*(torch.from_numpy(a) for a in args), *port,
                                         n0=n0, n1=n1)
        again = vb.vorbis_synth_step(*(torch.from_numpy(a) for a in args), *port, n0=n0, n1=n1)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        for i in (0, 2):
            w = np.asarray(want[i])
            assert np.abs(got[i].numpy() - w).max() <= BAR * np.abs(w).max()
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        port, ref = (got[2], got[3]), (want[2], want[3])
        primed |= valid
    assert cases == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("n0,n1", TOPOLOGIES)
def test_overlap_plain_is_the_jax_step_after_its_matmuls_bit_for_bit(n0, n1, C):
    """K13's plain version on the reference's own IMDCT outputs (its
    float32 products, formed as its step forms them) gives the reference
    step's PCM and lap bit for bit: the window, shifts, sums and masks are
    the same operations in the same order. Every size case, invalid
    lanes, a random lap."""
    import jax

    B = 8
    _, _, bank, flags, carry = kc.vorbis_overlap_random_inputs(3 + C, B, C, n0, n1)
    n_flag, pf, nf, valid, cflag = (f.numpy() for f in flags)
    spec = (np.random.default_rng(n0 + n1).standard_normal((B, C, n1 // 2)) * 0.05
            ).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        flat = jnp.asarray(spec).reshape(B * C, n1 // 2)
        pcm1 = flat @ jnp.asarray(jax_core.imdct_matrix(n1).astype(np.float32)).T
        pcm0 = flat[:, : n0 // 2] @ jnp.asarray(jax_core.imdct_matrix(n0).astype(np.float32)).T
    want = jax_vb._vorbis_synth_step(
        jnp.asarray(spec), jnp.asarray(n_flag), jnp.asarray(pf), jnp.asarray(nf),
        jnp.asarray(valid != 0), jnp.ones(B, bool), jnp.asarray(carry.numpy()),
        jnp.asarray(cflag), n0=n0, n1=n1)
    got = vo.vorbis_overlap_plain(torch.from_numpy(np.array(pcm1).reshape(B, C, n1)),
                                  torch.from_numpy(np.array(pcm0).reshape(B, C, n0)),
                                  bank, flags, carry)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[2]))


def test_overlap_on_the_cpu_writes_into_a_given_tensor():
    inputs = kc.vorbis_overlap_random_inputs(4, 6, 2, 256, 2048)
    into = torch.full((6, 2, 1024), 7.0)
    out, new_carry = vo.vorbis_overlap(*inputs, out=into)
    want = vo.vorbis_overlap_plain(*inputs)
    assert out is into and torch.equal(out, want[0]) and torch.equal(new_carry, want[1])


def test_overlap_work_counts_what_the_inputs_need():
    """The bound's count on two lanes of the long-long and short-long
    cases: a long block after a short one reads all but its first (n1 -
    n0)/4 samples."""
    n0, n1 = 256, 2048
    inputs = list(kc.vorbis_overlap_random_inputs(1, 4, 1, n0, n1))
    inputs[3] = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 1], [1, 0, 1, 1], [1, 1, 0, 0],
                              [1, 0, 1, 1]], dtype=torch.int32)
    nbytes, flops = kc.vorbis_overlap_work(inputs)
    h1 = n1 // 2
    want = inputs[3].numpy().nbytes + 2 * n1 * 4 + 4 * 3 * h1 * 4 + (n1 + n1 - (n1 - n0) // 4) * 4
    assert nbytes == want and flops == 2 * (2 * h1 + n1)
