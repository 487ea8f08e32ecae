"""The port stands without JAX, picks no device for the caller, and
routes CPU tensors (only those) to the plain versions."""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from soundkit_tpu_torch import _build
from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
from soundkit_tpu_torch.ops import aac_batch, aac_entropy, imdct
from soundkit_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "soundkit_tpu_torch"

_NO_JAX_DECODE = r"""
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked")
sys.meta_path.insert(0, _Block())
import numpy as np
from soundkit_tpu_torch.models.aac_lc_batch import BatchedAacLcDecoder
from soundkit_tpu_torch.tools.aac_fixtures import load_clips, lane_streams
m = BatchedAacLcDecoder(2, 2, device="cpu")
for i, s in enumerate(lane_streams(load_clips(), 2, 2)):
    m.push(i, s)
pcm = m.decode_batches(2)
assert pcm.shape == (2, 2, 2, 1024) and np.isfinite(pcm).all() and np.abs(pcm).max() > 0
assert m.v4_batches == 2
assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
print("decoded without jax")
"""


def test_port_decodes_on_cpu_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_DECODE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "decoded without jax" in proc.stdout


def test_no_port_source_imports_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in PORT.rglob("*.py") if pat.search(p.read_text())]
    assert not offenders


@pytest.mark.parametrize("path", ["chip_smoke.py", "tests/test_torch_cuda_kernels.py",
                                  "soundkit_tpu_torch/tools/profile_step.py"])
def test_gpu_entry_points_import_only_the_port(path):
    """What runs on the card imports neither JAX nor the JAX package
    itself; the port reaches the JAX package's host modules for it."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|soundkit_tpu)\b", re.M)
    assert not pat.findall((REPO / path).read_text())


def test_timed_decoder_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        BatchedAacLcDecoder(2, 2, device="cpu", timed=True)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        BatchedAacLcDecoder(2, 2, device="cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only CPU tensors reach the plain versions; anything else must
    launch a kernel or raise."""
    meta = torch.empty((16, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        imdct.imdct_window(meta, meta, meta, torch.empty(16, dtype=torch.int32, device="meta"))
    counts = (imdct.imdct_window.launches, aac_entropy.spectral_decode.launches,
              aac_batch.tns_filter.launches)
    coef = torch.randn((1, 2, 1024))
    perm = torch.arange(1024, dtype=torch.int32).expand(1, 2, 1024).contiguous()
    filt = torch.full((1, 2, 1024), -1, dtype=torch.int32)
    out = aac_batch.tns_filter(coef, perm, filt, torch.zeros((1, 2, 8, 20)))
    assert torch.equal(out, coef)
    assert counts == (imdct.imdct_window.launches, aac_entropy.spectral_decode.launches,
                      aac_batch.tns_filter.launches)


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("nvcc is installed")
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.kernel_library_path()


def test_build_failure_carries_compiler_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(_build.BuildError, match="bad.cpp"):
        _build._build("bad", shutil.which("g++"), _build.GXX_FLAGS, [bad], [])
