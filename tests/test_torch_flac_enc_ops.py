"""The port's FLAC encode analysis against the JAX package's.

``ops.flac_enc_batch.flac_analyze_plain`` (the plain version of K14) is
held to the JAX ``flac_analyze_x64`` on the same numpy rows: seeded rows
of every kind, the edge rows (silence, constant blocks, full scale,
+-max alternating, 16-sample blocks, n_valid < N) and the blocks of the
fixtures' PCM, at 16 and 24 bits, stereo and mono. assign, kind, order,
shift and qlp must be identical and the residual plane bit-exact on every
row but those a case names by count (one row of one case on these
inputs). On each such row the whole output, residual included, must
equal the reference's once the port takes the reference's inexact bit
length (below) or XLA's sum of the autocorrelation's products (a
Welch-windowed tone makes the Levinson recursion ill-conditioned, so the
sum order can move a quantized coefficient).

Where the port departs from the reference on purpose, a test names the
case: XLA's float64 log2 on the CPU rounds below the integer at some
powers of two, so the reference's bit lengths are one short there; the
port's are exact. And the autocorrelation is summed in K14's order,
which the plain version keeps.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundkit_tpu.ops import flac_enc_batch as jax_enc
from soundkit_tpu_torch.ops import flac_analyze as k14
from soundkit_tpu_torch.ops import flac_enc_batch as enc
from soundkit_tpu_torch.tools import flac_fixtures as ff
from soundkit_tpu_torch.tools import kernel_check as kc

REPO = Path(__file__).resolve().parent.parent

#: powers of two 2^k (k <= 48) whose float64 log2 XLA's CPU backend rounds
#: below k, so that floor(log2) is one short
XLA_LOG2_LOW = (3, 6, 7, 12, 13, 14, 24, 26, 28, 48)


def _jax_plans(x: np.ndarray, n_valid: int, bits: int, channels: int):
    """The JAX analysis as the JAX encoder runs it: [L, 2, N] rows, or the
    single-channel branch (C = 1) for mono. Rows are independent, so they
    are padded with silent rows to a multiple of 32 (fewer shapes for XLA
    to compile) and cut back."""
    rows = x if channels == 2 else x[:, :1]
    L = len(rows)
    pad = np.zeros((-(-L // 32) * 32, *rows.shape[1:]), np.int64)
    pad[:L] = rows
    return tuple(o[:L] for o in jax_enc.flac_analyze_x64(pad, n_valid, bits))


def _xla_order(xw, n_valid):
    """The autocorrelation of the port's windowed samples summed by XLA
    (the reference's expression, jitted)."""
    N = xw.shape[-1]
    with jax.enable_x64():
        ac = jax.jit(lambda a: jnp.stack([jnp.sum(a[..., : N - i] * a[..., i:], axis=-1)
                                          for i in range(9)], -1))(jnp.asarray(xw.numpy()))
        return torch.from_numpy(np.array(ac))


def _rows_differ(a, b) -> np.ndarray:
    return np.stack([(np.asarray(x).reshape(len(x), -1) != np.asarray(y).reshape(len(y), -1))
                     .any(1) for x, y in zip(a, b)]).any(0)


def _jax_bit_length(v):
    """The reference's bit length, 64 - ``_clz64`` (a floor of XLA's log2)."""
    with jax.enable_x64():
        return torch.from_numpy(64 - np.asarray(jax_enc._clz64(jnp.asarray(v.numpy()), jnp)))


def _explained(x: np.ndarray, n_valid: int, bits: int, channels: int, want) -> np.ndarray:
    """Rows whose whole output, residual included, equals the reference's
    once the port takes the reference's bit length (XLA's low log2 at a
    power of two), XLA's autocorrelation sums, or both."""
    explained = np.zeros(len(x), bool)
    for patches in ((("bit_length", _jax_bit_length),), (("autocorrelation", _xla_order),),
                    (("bit_length", _jax_bit_length), ("autocorrelation", _xla_order))):
        with pytest.MonkeyPatch.context() as mp:
            for name, fn in patches:
                mp.setattr(enc, name, fn)
            alt = enc.flac_analyze_plain(torch.from_numpy(x), n_valid, bits, channels)
        explained |= ~_rows_differ([t.numpy() for t in alt], want)
    return explained


def _assert_same(x: np.ndarray, n_valid: int, bits: int, channels: int, excused: int = 0):
    """The plans and residuals equal the JAX package's on every row but at
    most ``excused``, each of which :func:`_explained` must account for."""
    got = enc.flac_analyze_plain(torch.from_numpy(x), n_valid, bits, channels)
    want = _jax_plans(x, n_valid, bits, channels)
    for name, g, w in zip(("assign", "kind", "order", "shift", "qlp", "res"), got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape, name
    differ = _rows_differ([g.numpy() for g in got], want)
    assert differ.sum() <= excused, f"rows {np.nonzero(differ)[0]} differ from the JAX package's"
    if differ.any():
        named = _explained(x[differ], n_valid, bits, channels, [w[differ] for w in want])
        assert named.all(), f"rows {np.nonzero(differ)[0][~named]} differ for no named reason"
    for name, g, w in zip(("assign", "kind", "order", "shift", "qlp", "res"), got, want):
        np.testing.assert_array_equal(g.numpy()[~differ], w[~differ], err_msg=name)
    return got, differ


@pytest.mark.parametrize("bits,channels,n,n_valid,excused", [
    (16, 2, 4096, 4096, 0), (24, 2, 4096, 4096, 0), (16, 1, 4096, 4096, 0),
    (24, 1, 4096, 4096, 0), (16, 2, 16, 16, 0), (24, 1, 16, 16, 0), (16, 2, 4096, 3000, 1),
    (24, 2, 4096, 1000, 0),
])
def test_plain_equals_jax_on_seeded_rows(bits, channels, n, n_valid, excused):
    """Rows of every kind of ``kernel_check.flac_analyze_inputs``: the
    plans and the residuals equal the JAX package's. One row of the
    n_valid = 3000 case differs, and equals the reference's under its bit
    length (a Rice parameter at a power of two)."""
    x = kc.flac_analyze_inputs(bits + channels + n_valid, 12, n, bits, channels).numpy()
    got, _ = _assert_same(x, n_valid, bits, channels, excused)
    if n_valid == 4096 and channels == 2:
        assert len(set(got[0].tolist())) >= 3  # the rows reach several assignments
        assert got[1].sum() > 0 and (got[1] == 0).any()  # both kinds


@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("bits", [16, 24])
def test_plain_equals_jax_on_the_edge_rows(bits, channels):
    """Silence, constant blocks, full-scale noise and +-max alternating
    with R = -L (a side channel of bits + 1), in one call (the 16-sample
    blocks and n_valid < N: the seeded rows; the block longer than a tile:
    test_a_windowed_tone_moves_with_the_sum_order)."""
    edges = ("silence", "constant", "full_scale_noise", "alternating_max")
    rows = [x.numpy() for name, x, _, c in kc.flac_analyze_edge_cases(bits)
            if c == channels and name.rsplit("_c", 1)[0] in edges]
    got, differ = _assert_same(np.concatenate(rows), 4096, bits, channels)
    assert not differ.any()
    assert (got[2].numpy()[:6] == 0).all()  # silence: order 0


@pytest.mark.parametrize("clip", ff.CLIPS)
def test_plain_equals_jax_on_the_fixture_pcm(clip):
    """Every 4096-sample block of a fixture's PCM (the port's decode of the
    committed clip); its tail as a short block (the encoder's tails:
    tests/test_torch_flac_enc_model.py)."""
    c = {x.name: x for x in ff.load_clips()}[clip]
    pcm = ff.clip_pcm(c, "cpu")
    n = pcm.shape[1] // 4096
    rows = np.zeros((n + 1, 2, 4096), np.int64)
    rows[:n, : c.channels] = pcm[:, : n * 4096].reshape(c.channels, n, 4096).swapaxes(0, 1)
    tail = pcm.shape[1] - n * 4096
    rows[n, : c.channels, :tail] = pcm[:, n * 4096:]
    _assert_same(rows[:n], 4096, c.bits, c.channels)
    _assert_same(rows[n:], tail, c.bits, c.channels)  # n_valid < N: the tail alone


def _powers(k_max: int = 48):
    out = [0, 1]
    for k in range(1, k_max + 1):
        out += [(1 << k) - 1, 1 << k, (1 << k) + 1]
    return np.array(sorted(set(out)), np.int64)


def test_bit_length_is_exact_and_the_jax_formula_is_short_at_named_powers():
    """The port's bit length is exact at 0, 1, 2^k - 1, 2^k and 2^k + 1 for
    k <= 48. The reference's (64 - ``_clz64``, a floor of a float64 log2)
    equals it everywhere there but at 2^k for k in ``XLA_LOG2_LOW``, where
    XLA's log2 lies below k and the reference's is one short."""
    v = _powers()
    got = enc.bit_length(torch.from_numpy(v)).numpy()
    assert got.tolist() == [int(a).bit_length() for a in v.tolist()]
    with jax.enable_x64():
        ref = 64 - np.asarray(jax_enc._clz64(jnp.asarray(v), jnp))
        low = np.asarray(jnp.log2(jnp.asarray([2.0 ** k for k in XLA_LOG2_LOW])))
    short = {int(a) for a, g, r in zip(v, got, ref) if g != r}
    assert short == {1 << k for k in XLA_LOG2_LOW}
    assert all(ref[v == (1 << k)][0] == k for k in XLA_LOG2_LOW)
    assert (low < np.array(XLA_LOG2_LOW)).all()


def test_quantization_shift_is_exact_at_powers_of_two():
    """max|a| = 2^k exactly: the port's shift is clip(12 - k, 0, 15) (an
    exact floor of log2); the reference's formula gives the same for every
    k in -30..20 but those of ``XLA_LOG2_LOW``, where its log2 is low."""
    ks = np.arange(-30, 21)
    a = torch.zeros((len(ks), 8), dtype=torch.float64)
    a[:, 3] = torch.from_numpy(2.0 ** ks)
    shift, _ = enc.quantize_lpc(a)
    assert shift.tolist() == np.clip(12 - ks, 0, 15).tolist()
    with jax.enable_x64():
        cmax = jnp.asarray(2.0 ** ks)
        log2cmax = jnp.floor(jnp.log2(cmax)) + 1.0
        ref = np.asarray(jnp.clip(14 - log2cmax.astype(jnp.int64) - 1, 0, 15))
    differ = {int(k) for k, g, r in zip(ks, shift.tolist(), ref) if g != r}
    assert differ == {k for k in XLA_LOG2_LOW if k <= 20 and 12 - k >= 0}


def test_rice_estimate_differs_from_jax_only_where_its_log2_is_low():
    """Residual rows whose zigzag mean is 63, 64 and 65: the port's Rice
    estimate equals the reference's ``_rice_est_cost`` at 63 and 65; at 64
    (2^6, in ``XLA_LOG2_LOW``) the reference's parameter is one lower."""
    n = 256
    # a constant zigzag value u: r = u / 2 for an even u, -(u + 1) / 2 for an odd one
    res = np.stack([np.full(n, u // 2 if u % 2 == 0 else -(u + 1) // 2, np.int64)
                    for u in (63, 64, 65)])
    got = enc.rice_est_cost(torch.from_numpy(res), n).tolist()
    with jax.enable_x64():
        ref = np.asarray(jax_enc._rice_est_cost(jnp.asarray(res), n, jnp)).tolist()
    assert got[0] == ref[0] and got[2] == ref[2]
    # k = bit_length(64) - 2 = 5 here, 4 in the reference
    assert got[1] == n * (64 >> 5) + n * 6
    assert ref[1] == n * (64 >> 4) + n * 5


def test_autocorrelation_keeps_the_kernels_order():
    """The plain version sums the autocorrelation in K14's order: AC_SPT
    and AC_WARPS are the kernel's SPT and THREADS / 32, and its lags
    equal the plain sums to float64 rounding."""
    src = (REPO / "soundkit_tpu_torch/csrc/flac_analyze.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert enc.AC_SPT == const("SPT")
    assert enc.AC_WARPS * 32 == const("THREADS")
    rng = np.random.default_rng(4)
    xw = torch.from_numpy(rng.standard_normal((3, 9000)))
    xw[:, 8999:] = 0.0
    got = enc.autocorrelation(xw, 8999)
    want = torch.stack([(xw[:, : 9000 - i] * xw[:, i:]).sum(-1) for i in range(9)], -1)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-9)


def test_a_windowed_tone_moves_with_the_sum_order():
    """Why the plain version fixes K14's order: on a pure 24-bit tone over
    9000 samples (the multi-tile edge row) the Levinson recursion is
    ill-conditioned, and the autocorrelation summed in torch's order
    gives another quantized coefficient than K14's order. The reference
    (XLA's order) lands on another plan again than one of them; the
    streams of every order decode to the same samples."""
    name, x, n_valid, channels = [c for c in kc.flac_analyze_edge_cases(24)
                                  if c[0] == "multi_tile_c1"][0]
    ours = enc.flac_analyze_plain(x, n_valid, 24, channels)[4][1]
    cand = x[1:2, 0].to(torch.float64)
    t = (2.0 * torch.arange(x.shape[-1], dtype=torch.float64) - (n_valid - 1)) / (n_valid - 1)
    w = torch.where(torch.arange(x.shape[-1]) < n_valid, 1.0 - t * t, 0.0)
    xw = torch.where(torch.arange(x.shape[-1]) < n_valid, cand, 0.0) * w
    ac = torch.stack([(xw[:, : x.shape[-1] - i] * xw[:, i:]).sum(-1) for i in range(9)], -1)
    rel = (ac - enc.autocorrelation(xw, n_valid)).abs().max() / ac.abs().max()
    assert 0 < rel < 1e-14  # the sums agree to rounding ...
    a = _levinson(ac[0].tolist())
    _, q = enc.quantize_lpc(torch.tensor([a], dtype=torch.float64))
    assert not torch.equal(q[0], ours[0].long())  # ... and the coefficients do not


def _levinson(ac):
    a = [0.0] * 8
    err = ac[0]
    for i in range(8):
        acc = ac[1] if i == 0 else ac[i + 1] - sum(a[i - 1 - j] * ac[1 + j] for j in range(i))
        k = acc / err
        a = [a[j] - k * a[i - 1 - j] for j in range(i)] + [k] + a[i + 1:]
        err = err * (1.0 - k * k)
    return a


@pytest.mark.parametrize("bits,channels", [(16, 2), (24, 1)])
def test_cpu_route_packs_the_plain_plans(bits, channels):
    """``flac_analyze`` on CPU tensors is the plain version's plans in the
    packed [L, 23] row layout, which ``flac_plans_unpack`` splits back;
    the numpy entry gives the JAX serving entry's tuple. No launch."""
    x = kc.flac_analyze_inputs(5, 7, 4096, bits, channels)
    before = k14.flac_analyze.launches
    rows = k14.flac_analyze(x, 4096, bits, channels)
    assert rows.shape == (7, enc.PLAN_COLS) and rows.dtype == torch.int32
    plain = enc.flac_analyze_plain(x, 4096, bits, channels)
    for got, want in zip(enc.flac_plans_unpack(rows.numpy())[:5], plain[:5]):
        np.testing.assert_array_equal(got, want.numpy())
    got = enc.flac_analyze_batch(x.numpy(), 4096, bits, channels=channels, device="cpu")
    want = jax_enc.flac_analyze_batch(x.numpy() if channels == 2 else x.numpy()[:, :1], 4096,
                                      bits, fetch_res=False)
    assert got[5] is None and want[5] is None
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g, w)
    assert k14.flac_analyze.launches == before


def test_flac_analyze_refuses_what_the_kernel_does_not_take():
    """Shapes, types, depths and a tensor neither on the CPU nor on a
    CUDA device raise before any launch."""
    x = torch.zeros((3, 2, 64), dtype=torch.int16)
    before = k14.flac_analyze.launches
    for call in (lambda: k14.flac_analyze(x[:, :1], 64, 16),
                 lambda: k14.flac_analyze(torch.zeros((3, 2, 70000), dtype=torch.int16), 64, 16),
                 lambda: k14.flac_analyze(x, 65, 16),
                 lambda: k14.flac_analyze(x, 64, 32),
                 lambda: k14.flac_analyze(x, 64, 16, channels=3)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(TypeError):
        k14.flac_analyze(x.long(), 64, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        k14.flac_analyze(torch.empty((3, 2, 64), dtype=torch.int16, device="meta"), 64, 16)
    assert k14.flac_analyze.launches == before
