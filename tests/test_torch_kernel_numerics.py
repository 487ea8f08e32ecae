"""The arithmetic of the redesigned K1 and K5 kernels, emulated in torch
on the CPU (the kernels themselves run only on the card):

- K1 (csrc/imdct_window.cu) multiplies in 3xTF32: each operand split
  into hi (x with its 13 low mantissa bits cleared) and lo = x - hi, of
  which the tensor cores read the TF32 part; products lo·hi + hi·lo +
  hi·hi, each 32-deep stage summed apart and added into the running sum
  in float32. On the real IMDCT bases with the spectra of the committed
  fixtures that stays within K1's bound of 1e-5 of max|out| from the
  plain float32 product; plain TF32 (hi·hi) does not. A split whose hi
  is rounded as ``cvt.rna.tf32.f32`` rounds holds the bound as well.
- K5 (csrc/tns.cu) sums the taps oldest first and fuses the newest one
  last: y = fma(-a0, h0, x - sum_{k=19..1} a_k h_k). That order stays
  within K5's bound of 1e-4 of max|out| from the plain scan on every
  layout that the card's checks use.
"""
import pytest
import torch

from soundkit_tpu_torch.ops import aac_batch, imdct
from soundkit_tpu_torch.tools import kernel_check as kc

from torch_port_helpers import picked_aus, v4_wire


def tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 part of float32 values: the 13 low mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: rounded to 10 mantissa bits, ties away from
    zero (adding half a TF32 unit to the magnitude bits, then clearing)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(x, hi_of=tf32):
    """(hi, lo) as the kernel forms and the tensor cores read them; with
    ``hi_of=tf32_rna``, hi is rounded as ``cvt.rna`` would round it."""
    hi = hi_of(x)
    return hi.double(), tf32(x - hi).double()


def three_tf32(a, m_t, stage: int = 32, hi_of=tf32):
    """K1's product: exact TF32 products, each stage rounded to float32
    and added into a float32 running sum."""
    ah, al = split(a, hi_of)
    bh, bl = split(m_t, hi_of)
    out = torch.zeros((a.shape[0], m_t.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], stage):
        s = slice(k0, k0 + stage)
        out = out + (al[:, s] @ bh[s] + ah[:, s] @ bl[s] + ah[:, s] @ bh[s]).float()
    return out


@pytest.fixture(scope="module")
def synthesis_calls():
    """(coef, basis, bank, win_idx) of the long and the short K1 call
    when the CPU path decodes one v4 batch of the fixtures' AUs."""
    calls = []
    real = aac_batch.imdct_window

    def record(coef, basis, bank, win_idx):
        calls.append((coef.clone(), basis, bank, win_idx))
        return real(coef, basis, bank, win_idx)

    aus = picked_aus()
    saved, prev = aac_batch.init_state(len(aus), 2, "cpu")
    aac_batch.imdct_window = record
    try:
        aac_batch.decode_frame_v4_packed(torch.from_numpy(v4_wire(aus)), prev, saved)
    finally:
        aac_batch.imdct_window = real
    assert [c[0].shape[1] for c in calls] == [1024, 128]
    return dict(zip(("long", "short"), calls))


@pytest.mark.parametrize("which", ["long", "short"])
def test_3xtf32_holds_the_bound_and_tf32_does_not(synthesis_calls, which):
    coef, basis, bank, win = synthesis_calls[which]
    assert torch.count_nonzero(coef) > 0
    window = bank[win.long()]
    ref = imdct.imdct_window_plain(coef, basis.m_t, bank, win).double()
    scale = ref.abs().max().item()

    def rel(got):
        return (got.double() * window.double() - ref).abs().max().item() / scale

    assert rel(three_tf32(coef, basis.m_t)) <= kc.REL_BOUND["imdct_window"]
    ah, _ = split(coef)
    bh, _ = split(basis.m_t)
    assert rel((ah @ bh).float()) > 10 * kc.REL_BOUND["imdct_window"]


@pytest.mark.parametrize("which", ["long", "short"])
def test_3xtf32_with_rounded_split_holds_the_bound(synthesis_calls, which):
    """The split with hi rounded (``cvt.rna.tf32.f32``) in place of the
    kernel's cleared bits holds the bound too, and plain TF32 rounded
    so still misses it: clearing bits only moves hi's rounding into lo."""
    coef, basis, bank, win = synthesis_calls[which]
    window = bank[win.long()]
    ref = imdct.imdct_window_plain(coef, basis.m_t, bank, win).double()
    scale = ref.abs().max().item()

    def rel(got):
        return (got.double() * window.double() - ref).abs().max().item() / scale

    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12])
    assert tf32_rna(x).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0]
    assert rel(three_tf32(coef, basis.m_t, hi_of=tf32_rna)) <= kc.REL_BOUND["imdct_window"]
    assert rel((tf32_rna(coef).double() @ tf32_rna(basis.m_t).double()).float()) \
        > 10 * kc.REL_BOUND["imdct_window"]


def fma(a, b, c):
    """float32 fused multiply-add: the product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def tns_reassociated(coef, perm, filt_id, lpc):
    """The plain scan with K5's summation order."""
    B, C, N = coef.shape
    order = lpc.shape[3]
    x = torch.gather(coef, -1, perm.long())
    hist = torch.zeros((B, C, order))
    prev = torch.full((B, C), -1, dtype=filt_id.dtype)
    ys = []
    for j in range(N):
        fid = filt_id[..., j]
        act = fid >= 0
        hist = torch.where((fid != prev)[..., None], 0.0, hist)
        sel = fid.clamp(0, lpc.shape[2] - 1).long()[..., None, None].expand(B, C, 1, order)
        a = torch.gather(lpc, 2, sel)[..., 0, :]
        rest = torch.zeros((B, C))
        for k in range(order - 1, 0, -1):
            rest = fma(a[..., k], hist[..., k], rest)
        y = torch.where(act, fma(-a[..., 0], hist[..., 0], x[..., j] - rest), x[..., j])
        hist = torch.where(act[..., None], torch.cat([y[..., None], hist[..., :-1]], -1), hist)
        prev = fid
        ys.append(y)
    return torch.gather(torch.stack(ys, -1), -1, perm.long())


@pytest.mark.parametrize("kind", kc.TNS_KINDS)
def test_tns_reassociated_order_holds_the_bound(kind):
    coef, perm, filt, lpc = kc.tns_inputs(6, 2, torch.device("cpu"), seed=7, kind=kind)
    ref = aac_batch.tns_filter_plain(coef, perm, filt, lpc).double()
    got = tns_reassociated(coef, perm, filt, lpc).double()
    rel = (got - ref).abs().max().item() / ref.abs().max().item()
    assert rel <= kc.REL_BOUND["tns_filter"]
    if kind == "order0":
        assert torch.equal(got, ref)
    else:
        assert not torch.equal(got.float(), coef)  # the filters did something

