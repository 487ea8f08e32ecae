"""K17's rotation (``csrc/phase_lock.cu``: ``rotation``) on the CPU, where
the kernel cannot run: a numpy mirror of its arithmetic, with the float64
constants and float32 coefficients read from the source, held to float64
cos / sin of the float32 argument within 2^-22 (of unit magnitude) over
the arguments the pitch shift makes (up to 1.05e6 rad), arguments a few
ulps from multiples of pi/2, and the extremes."""
import re
from decimal import Decimal, getcontext
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parent.parent / "soundkit_tpu_torch" / "csrc" / "phase_lock.cu"
BOUND = 2.0 ** -22
SPAN = 1.05e6
F32 = np.float32


def _constants() -> dict:
    text = SRC.read_text()
    out = {name: float(v) for name, v in
           re.findall(r"constexpr double (\w+) = ([-+0-9.e]+);", text)}
    out.update({name: F32(v) for name, v in re.findall(r"\b([SC][0-3]) = ([-+0-9.e]+)f", text)})
    return out


K = _constants()


def _fma32(a, b, c):
    """fmaf in float32 (the float32 product is exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def rotation_mirror(s: np.ndarray):
    """(cos s, sin s) of float32 ``s`` as the kernel's ``rotation``
    computes them: kq = rint(s 2/pi) and r = s - kq PIO2_HI - kq PIO2_LO
    in float64 (kq PIO2_HI is exact, so the first step rounds once as the
    fma does), r rounded to float32, the polynomials in float32 fmafs,
    the quadrant kq mod 4."""
    d = s.astype(np.float64)
    kq = np.rint(d * K["TWO_OVER_PI"])
    r = (d - kq * K["PIO2_HI"]) - kq * K["PIO2_LO"]
    x = r.astype(F32)
    q = kq.astype(np.int64) & 3
    z = (x * x).astype(F32)
    ps = _fma32(_fma32(_fma32(np.full_like(z, K["S3"]), z, K["S2"]), z, K["S1"]), z, K["S0"])
    pc = _fma32(_fma32(_fma32(np.full_like(z, K["C3"]), z, K["C2"]), z, K["C1"]), z, K["C0"])
    sr = _fma32((x * z).astype(F32), ps, x)
    cr = _fma32((z * z).astype(F32), pc, _fma32(np.full_like(z, F32(-0.5)), z, F32(1.0)))
    sv, cv = np.where(q & 1, cr, sr), np.where(q & 1, sr, cr)
    return np.where((q + 1) & 2, -cv, cv), np.where(q & 2, -sv, sv), r


def _held(s):
    c, sn, r = rotation_mirror(s)
    d = s.astype(np.float64)
    assert np.abs(r).max() <= np.pi / 4 + 1e-6
    err = max(np.abs(c - np.cos(d)).max(), np.abs(sn - np.sin(d)).max())
    assert err <= BOUND, f"{err:.3g} > 2^-22"
    return err


def test_constants_split_pi_over_2():
    """PIO2_HI carries 33 significant bits (kq PIO2_HI exact for |kq| <
    2^20, and |kq| <= 1.05e6 2/pi < 2^20); PIO2_HI + PIO2_LO is pi/2 within
    1e-25; the coefficients are float32 literals."""
    m, e = np.frexp(K["PIO2_HI"])
    assert float(m * 2.0 ** 33) == int(m * 2.0 ** 33)
    assert SPAN * K["TWO_OVER_PI"] < 2 ** 20
    getcontext().prec = 60
    pio2 = Decimal("1.57079632679489661923132169163975144209858469968755291048747")
    assert abs(Decimal(K["PIO2_HI"]) + Decimal(K["PIO2_LO"]) - pio2) < Decimal("1e-25")
    assert abs(K["TWO_OVER_PI"] - 2 / np.pi) < 1e-16
    assert all(isinstance(K[c], np.float32) for c in ("S0", "S1", "S2", "S3", "C0", "C1", "C2", "C3"))


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_of_a_million_seeded_arguments(seed):
    s = np.random.default_rng(seed).uniform(-SPAN, SPAN, 10 ** 6).astype(F32)
    _held(s)


def test_rotation_near_multiples_of_pi_over_2():
    """Arguments within 3 ulps of k pi/2 (k up to the span's), where the
    float64 remainder is smallest against the argument."""
    k = np.unique(np.concatenate([np.arange(-64, 65), np.linspace(-SPAN, SPAN, 4001) * 2 / np.pi])
                  .round())
    base = (k * np.pi / 2).astype(F32)
    s = [base]
    up, down = base.copy(), base.copy()
    for _ in range(3):
        up, down = np.nextafter(up, F32(np.inf)), np.nextafter(down, F32(-np.inf))
        s += [up, down]
    _held(np.concatenate(s))


def test_rotation_at_the_extremes():
    s = np.array([SPAN, -SPAN, np.nextafter(F32(SPAN), F32(0)), F32(0), -F32(0), F32(1e-30),
                  F32(np.pi / 4), F32(-np.pi / 4), F32(np.pi), F32(2 * np.pi)], dtype=F32)
    _held(s)
