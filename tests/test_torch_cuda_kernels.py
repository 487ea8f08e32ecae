"""Each CUDA kernel against its plain PyTorch version on the card, with
the inputs and bounds of ``soundkit_tpu_torch.tools.kernel_check``
(the ones ``chip_smoke.py`` applies at B = 1024), at small shapes.

Needs an NVIDIA GPU (sm_90a) and nvcc; skipped without one. It imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from soundkit_tpu_torch.native import AacHostParser
from soundkit_tpu_torch.tools import aac_fixtures as fx
from soundkit_tpu_torch.tools import kernel_check as kc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("L,K", [(70, 1024), (300, 128)])
def test_imdct_window_kernels(dev, L, K):
    kc.compare("imdct_window", *kc.imdct_case(L, K == 128, dev, seed=L))
    kc.compare("dequant_imdct_window", *kc.dequant_imdct_case(L, dev, seed=L))


def test_spectral_decode_kernel_bit_exact(dev):
    B = 72
    buf, overflow = AacHostParser(3).pack_v4(fx.batch_aus(fx.clip_aus(fx.load_clips()), B, 0))
    assert not overflow
    kc.compare("spectral_decode", *kc.spectral_case(torch.from_numpy(buf).to(dev), B))


def test_tns_filter_kernel(dev):
    kc.compare("tns_filter", *kc.tns_case(40, 2, dev, seed=2, overlap=True))
