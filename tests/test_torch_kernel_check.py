"""The shared kernel-vs-plain harness (``soundkit_tpu_torch.tools.kernel_check``)
on the CPU, where both sides of every case run the plain version: each
case builds and agrees, and a result beyond its bound is refused."""
import pytest
import torch

from soundkit_tpu_torch.tools import kernel_check as kc
from torch_port_helpers import picked_aus, v4_wire

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,make", [
    ("spectral_decode", lambda: kc.spectral_case(torch.from_numpy(v4_wire(picked_aus())), 42)),
    ("tns_filter", lambda: kc.tns_case(3, 2, CPU, seed=2)),
    ("tns_filter", lambda: kc.tns_case(3, 2, CPU, seed=2, overlap=True)),
    ("imdct_window", lambda: kc.imdct_case(6, False, CPU, seed=1)),
    ("imdct_window", lambda: kc.imdct_case(24, True, CPU, seed=2)),
    ("dequant_imdct_window", lambda: kc.dequant_imdct_case(6, CPU, seed=3)),
])
def test_cases_agree_on_cpu(name, make):
    kernel, plain = make()
    res = kc.compare(name, kernel, plain)
    assert res == {"max_abs_err": 0.0, "rel_err": 0.0}
    assert torch.count_nonzero(plain()) > 0


@pytest.mark.parametrize("name,bump", [
    ("spectral_decode", 1),
    ("imdct_window", 1e-3),
    ("tns_filter", float("nan")),
])
def test_compare_refuses_a_result_beyond_its_bound(name, bump):
    ref = torch.arange(1, 9, dtype=torch.int32 if name == "spectral_decode" else torch.float32)
    bad = ref.clone()
    bad[3] += bump
    with pytest.raises(kc.KernelMismatch, match=name):
        kc.compare(name, lambda: bad, lambda: ref)
