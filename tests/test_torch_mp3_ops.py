"""Port parity of the batched MP3 granule step: soundkit_tpu_torch's
``ops.mp3_batch`` (plain torch glue, then K10's plain version on the
CPU) against the JAX package's ``ops.mp3_batch`` on the CPU, on seeded
numpy inputs: every block type, mixed blocks on and off, 0 / 1 / 31
alias boundaries, M/S on and off, ragged validity and a non-zero carried
state chained over several granules; the compact, packed and multi-round
variants; the packed step (K10's plain version, which K10 is held to on
the card) on wild wires: M/S with an invalid partner, one channel with
M/S set, alias boundaries outside 0..31, block types -7..8; the wire
layout and its unpacking field for field.

Tolerance: ``max|port - jax| <= 1e-5 * max|jax|`` on the PCM and on both
carried states (float32 sums in another order; measured ~1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundkit_tpu.ops import mp3_batch as jax_mb
from soundkit_tpu_torch.ops import mp3_batch as mb
from soundkit_tpu_torch.ops import mp3_synth
from soundkit_tpu_torch.tools import kernel_check as kc

REL = 1e-5


def assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= REL * scale, f"{what}: max|d| {err} = {err / scale:.2e} of max|ref|"


def granule_inputs(rng, B, C, wild=False):
    """One granule's compact inputs: (quant i16, expq i16, ms, block_type,
    mixed, n_alias_sb, lane_valid) as numpy. Lanes cycle through block
    types 0-3 with and without the mixed flag; n_alias follows the
    parser's rule (0 for pure short, 1 for mixed short, else 31) except
    on every fifth lane, which draws it from {0, 1, 31}. ``wild`` draws
    block types from -7..8, outside what a parser emits."""
    quant = rng.integers(-12, 13, (B, C, 576)) * (rng.random((B, C, 576)) < 0.6)
    quant[rng.random((B, C, 576)) < 0.01] = rng.integers(-900, 900)
    expq = rng.integers(-110, -30, (B, C, 576))
    expq[rng.random((B, C, 576)) < 0.15] = -32768
    lane = np.arange(B)[:, None] + np.arange(C)[None, :]
    bt = (lane % 4).astype(np.int32)
    if wild:
        bt = rng.integers(-7, 9, (B, C)).astype(np.int32)
    mixed = (lane // 4) % 2 == 1
    nal = np.where((bt == 2) & ~mixed, 0, np.where(bt == 2, 1, 31)).astype(np.int32)
    drawn = rng.choice(np.array([0, 1, 31], np.int32), (B, C))
    nal = np.where(lane % 5 == 4, drawn, nal).astype(np.int32)
    ms = rng.random(B) < 0.5
    valid = rng.random((B, C)) < 0.8
    return (quant.astype(np.int16), expq.astype(np.int16), ms, bt, mixed, nal, valid)


def random_state(rng, B, C):
    return (rng.standard_normal((B, C, 32, 18)).astype(np.float32) * 0.3,
            rng.standard_normal((B, C, 1024)).astype(np.float32) * 0.3)


def to_scale(expq):
    return np.where(expq == -32768, 0.0, np.exp2(0.25 * expq.astype(np.float32))).astype(np.float32)


@pytest.mark.parametrize("C", [2, 1])
@pytest.mark.parametrize("wild", [False, True])
def test_granule_step_matches_jax_over_chained_granules(C, wild):
    """``mp3_granule_device`` (int32 quant and float32 scale) for five
    chained granules from a random carried state."""
    rng = np.random.default_rng(10 + C + 2 * wild)
    B = 12
    ov, ff = random_state(rng, B, C)
    j_ov, j_ff = jnp.asarray(ov), jnp.asarray(ff)
    p_ov, p_ff = torch.from_numpy(ov), torch.from_numpy(ff)
    step = jax.jit(jax_mb.mp3_granule_device)
    for g in range(5):
        q16, expq, ms, bt, mixed, nal, valid = granule_inputs(rng, B, C, wild)
        quant, scale = q16.astype(np.int32), to_scale(expq)
        pcm_j, j_ov, j_ff = step(quant, scale, ms, bt, mixed, nal, valid, j_ov, j_ff)
        pcm_p, p_ov, p_ff = mb.mp3_granule_device(
            torch.from_numpy(quant), torch.from_numpy(scale), torch.from_numpy(ms),
            torch.from_numpy(bt), torch.from_numpy(mixed), torch.from_numpy(nal),
            torch.from_numpy(valid), p_ov, p_ff)
        for what, got, want in (("pcm", pcm_p, pcm_j), ("overlap", p_ov, j_ov),
                                ("fifo", p_ff, j_ff)):
            assert_close(got.numpy(), want, f"granule {g} {what}")
        assert not np.asarray(pcm_j)[~valid].any() and np.abs(np.asarray(pcm_j)).max() > 0


def test_mixed_blocks_against_jax():
    """Crafted mixed blocks (LAME never sets ``switch_point``): every lane
    mixed, short and long types, one alias boundary on the short ones."""
    rng = np.random.default_rng(4)
    B, C = 8, 2
    q16, expq, ms, _, _, _, valid = granule_inputs(rng, B, C)
    bt = np.tile(np.array([[2, 2], [0, 2], [1, 3], [2, 0]], np.int32), (2, 1))
    mixed = np.ones((B, C), bool)
    nal = np.where(bt == 2, 1, 31).astype(np.int32)
    valid[:] = True
    ov, ff = random_state(rng, B, C)
    want = jax.jit(jax_mb.mp3_granule_device)(q16.astype(np.int32), to_scale(expq), ms, bt, mixed,
                                              nal, valid, ov, ff)
    got = mb.mp3_granule_device(
        torch.from_numpy(q16.astype(np.int32)), torch.from_numpy(to_scale(expq)),
        torch.from_numpy(ms), torch.from_numpy(bt), torch.from_numpy(mixed),
        torch.from_numpy(nal), torch.from_numpy(valid), torch.from_numpy(ov), torch.from_numpy(ff))
    for what, g, w in zip(("pcm", "overlap", "fifo"), got, want):
        assert_close(g.numpy(), w, what)
    # and mixed differs from the same lanes unmixed (the low subbands take another path)
    plain = mb.mp3_granule_device(
        torch.from_numpy(q16.astype(np.int32)), torch.from_numpy(to_scale(expq)),
        torch.from_numpy(ms), torch.from_numpy(bt), torch.zeros((B, C), dtype=torch.bool),
        torch.from_numpy(nal), torch.from_numpy(valid), torch.from_numpy(ov), torch.from_numpy(ff))
    assert not torch.equal(plain[1], got[1])


def packed_wire(rng, B, G=1):
    """``G`` rows of the packed wire with random fields, and the fields."""
    fields = []
    for g in range(G):
        q16, expq, ms, bt, mixed, nal, valid = granule_inputs(rng, B, 2)
        fields.append(dict(bt=bt, nal=nal, quant=q16, expq=expq, mixed=mixed.astype(np.uint8),
                           ms=ms.astype(np.uint8), valid=valid.astype(np.uint8)))
    return kc.mp3_wire_rows(fields), fields


@pytest.mark.parametrize("B", [1, 3, 1024])
def test_wire_layout_equals_the_jax_package(B):
    port, ref = mb.mp3_wire_layout(B), jax_mb.mp3_wire_layout(B)
    assert port[1] == ref[1]
    assert [(n, o, np.dtype(d), s) for n, o, d, s in port[0]] == \
        [(n, o, np.dtype(d), s) for n, o, d, s in ref[0]]


def test_wire_unpack_field_for_field():
    rng = np.random.default_rng(6)
    B = 5
    wire, (vals,) = packed_wire(rng, B)
    got = mb.unpack_mp3_wire(torch.from_numpy(wire[0]), B)
    want = jax_mb.unpack_mp3_wire(jnp.asarray(wire[0]), B)
    assert sorted(got) == sorted(want) == sorted(vals)
    for name in got:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, vals[name].astype(g.dtype), err_msg=name)


@pytest.mark.parametrize("C", [2, 1])
def test_packed_step_matches_jax_over_chained_granules(C):
    """The packed wire row by row, carrying the state (the model's
    path); the compact step on the unpacked fields gives the same."""
    rng = np.random.default_rng(20 + C)
    B, G = 9, 4
    wire, fields = packed_wire(rng, B, G)
    ov, ff = random_state(rng, B, C)
    j_state = (jnp.asarray(ov), jnp.asarray(ff))
    p_state = (torch.from_numpy(ov), torch.from_numpy(ff))
    c_state = p_state
    step = jax.jit(jax_mb.mp3_granule_device_compact_packed)
    d_wire = torch.from_numpy(wire)
    for g in range(G):
        pcm_j, *j_state = step(jnp.asarray(wire[g]), *j_state)
        pcm_p, *p_state = mb.mp3_granule_device_compact_packed(d_wire[g], *p_state)
        for what, got, want in zip(("pcm", "overlap", "fifo"), (pcm_p, *p_state),
                                   (pcm_j, *j_state)):
            assert_close(got.numpy(), want, f"granule {g} {what}")
        f = fields[g]
        pcm_c, *c_state = mb.mp3_granule_device_compact(
            *(torch.from_numpy(np.ascontiguousarray(f[k][:, :C])) for k in ("quant", "expq")),
            torch.from_numpy(f["ms"] != 0), torch.from_numpy(np.ascontiguousarray(f["bt"][:, :C])),
            torch.from_numpy(f["mixed"][:, :C] != 0),
            torch.from_numpy(np.ascontiguousarray(f["nal"][:, :C])),
            torch.from_numpy(f["valid"][:, :C] != 0), *c_state)
        assert torch.equal(pcm_c, pcm_p)


def test_multi_round_step_matches_jax():
    rng = np.random.default_rng(30)
    B, C, G = 6, 2, 4
    rounds = [granule_inputs(rng, B, C) for _ in range(G)]
    stacked = [np.stack([r[i] for r in rounds]) for i in range(7)]
    ov, ff = random_state(rng, B, C)
    want = jax.jit(jax_mb.mp3_granules_device_compact_multi)(*stacked, ov, ff)
    got = mb.mp3_granules_device_compact_multi(*(torch.from_numpy(a) for a in stacked),
                                               torch.from_numpy(ov), torch.from_numpy(ff))
    assert got[0].shape == (G, B, C, 576)
    for what, g, w in zip(("pcm", "overlap", "fifo"), got, want):
        assert_close(g.numpy(), w, what)


def test_alias_network_cases():
    """0, 1 and 31 boundaries: lines move only inside the butterflies of
    the active boundaries."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.integers(-9, 10, (3, 1, 576)).astype(np.int32))
    scale = torch.full((3, 1, 576), 0.01)
    ones = torch.ones((3, 1), dtype=torch.bool)
    state = mb.init_state(3, 1, "cpu")
    outs = {}
    for n in (0, 1, 31):
        cap = {}
        real = mp3_synth.mp3_synth_plain

        def spy(xr, *rest, cap=cap):
            cap["xr"] = xr.clone()
            return real(xr, *rest)

        mb.mp3_synth_plain, saved = spy, mb.mp3_synth_plain
        try:
            mb.mp3_granule_device(q, scale, torch.zeros(3, dtype=torch.bool),
                                  torch.zeros((3, 1), dtype=torch.int32), ~ones,
                                  torch.full((3, 1), n, dtype=torch.int32), ones, *state)
        finally:
            mb.mp3_synth_plain = saved
        outs[n] = cap["xr"]
    base = torch.sign(q.float()) * q.float().abs() ** (4 / 3) * scale
    assert torch.equal(outs[0], base.reshape(3, 576))
    moved1 = (outs[1] != base.reshape(3, 576)).nonzero()[:, 1].unique()
    assert set(moved1.tolist()) <= set(range(10, 26))
    moved31 = (outs[31] != base.reshape(3, 576)).nonzero()[:, 1].unique()
    assert len(moved31) > 300 and set(moved31.tolist()) > set(moved1.tolist())


def test_plain_synthesis_runs_its_products_in_ieee_float32(monkeypatch):
    """Whatever the caller set, the plain version's einsums and matmuls
    run with TF32 off and the precision "highest"; the caller's settings
    come back afterwards."""
    seen = []
    real_einsum, real_matmul = torch.einsum, torch.Tensor.__matmul__

    def note():
        seen.append((torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32))

    monkeypatch.setattr(torch, "einsum", lambda *a: note() or real_einsum(*a))
    monkeypatch.setattr(torch.Tensor, "__matmul__", lambda x, y: note() or real_matmul(x, y))
    rows, ov, ff = mp3_synth_inputs()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        mp3_synth.mp3_granule_packed(rows[0], ov, ff)
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")
    assert len(seen) == 2 + 18 and set(seen) == {("highest", False)}


def mp3_synth_inputs():
    return kc.mp3_synth_random_inputs(3, streams=5, granules=1)


WILD_CASES = ("ms_invalid_partner", "mono_with_ms", "nal_out_of_range", "block_types_wild")


def wild_fields(rng, B, case):
    """One granule's wire fields of ``kernel_check.mp3_random_fields``,
    pushed to ``case``: every stream M/S with channel 0 valid and
    channel 1 invalid on half of them; M/S on every stream (for a
    one-channel decoder); every lane's alias boundaries from -3, 40, -100
    and 1000; every lane's block type from -7..8 with the mixed flag on
    half of them."""
    f = kc.mp3_random_fields(rng, B)
    if case == "ms_invalid_partner":
        f["ms"][:] = True
        f["valid"][:] = True
        f["valid"][::2] = (True, False)
    elif case == "mono_with_ms":
        f["ms"][:] = True
    elif case == "nal_out_of_range":
        f["nal"] = rng.choice(np.array([-3, 40, -100, 1000]), (B, 2))
    else:
        f["bt"] = rng.integers(-7, 9, (B, 2))
        f["mixed"] = rng.random((B, 2)) < 0.5
    return f


@pytest.mark.parametrize("case", WILD_CASES)
def test_packed_step_matches_jax_on_wild_wires(case):
    """K10's plain version (``mp3_granule_packed`` on the CPU) against
    the JAX package's packed step over three chained wild rows, from a
    random state."""
    rng = np.random.default_rng(40 + WILD_CASES.index(case))
    B, C = 11, 1 if case == "mono_with_ms" else 2
    wire = kc.mp3_wire_rows([wild_fields(rng, B, case) for _ in range(3)])
    ov, ff = random_state(rng, B, C)
    j_state = (jnp.asarray(ov), jnp.asarray(ff))
    p_state = (torch.from_numpy(ov), torch.from_numpy(ff))
    step = jax.jit(jax_mb.mp3_granule_device_compact_packed)
    for g in range(len(wire)):
        pcm_j, *j_state = step(jnp.asarray(wire[g]), *j_state)
        pcm_p, *p_state = mp3_synth.mp3_granule_packed(torch.from_numpy(wire[g]), *p_state)
        for what, got, want in zip(("pcm", "overlap", "fifo"), (pcm_p, *p_state),
                                   (pcm_j, *j_state)):
            assert_close(got.numpy(), want, f"{case} granule {g} {what}")
        assert np.abs(np.asarray(pcm_j)).max() > 0


@pytest.mark.parametrize("C", [2, 1])
def test_packed_step_on_the_cpu_is_the_chain_it_replaced(C):
    """On the CPU, ``mp3_granule_packed`` (with and without ``pcm_out``)
    gives, bit for bit, what the compact step gives on the unpacked
    fields: the views, ``expq_scale``, ``granule_lines``, then the plain
    synthesis."""
    rows, ov, ff = kc.mp3_synth_random_inputs(50 + C, streams=7, channels=C, granules=2)
    for row in rows:
        f = mb.unpack_mp3_wire(row, 7)
        want = mb.mp3_granule_device_compact(
            f["quant"][:, :C], f["expq"][:, :C], f["ms"] != 0, f["bt"][:, :C],
            f["mixed"][:, :C] != 0, f["nal"][:, :C], f["valid"][:, :C] != 0, ov, ff)
        got = mp3_synth.mp3_granule_packed(row, ov, ff)
        out = torch.full((7, C, 576), float("nan"))
        into = mb.mp3_granule_device_compact_packed(row, ov, ff, pcm_out=out)
        assert into[0] is out
        for g, i, w in zip(got, into, want):
            assert torch.equal(g, w) and torch.equal(i, w)
        ov, ff = want[1], want[2]
