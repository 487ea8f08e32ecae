"""Port parity: the windowed IMDCT product (K1) and its dequant form
(K2) against the JAX package's Pallas kernels, which run in interpret
mode on the CPU as tests/test_pallas_kernels.py runs them.

Tolerance: max|d| <= 1e-5 * max|ref|, float32 accumulation over
K <= 1024 terms in another order (TF32 would give ~1e-3)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from soundkit_tpu.ops import pallas_kernels as pk
from soundkit_tpu.ops.aac_dsp import imdct_matrix
from soundkit_tpu_torch.ops import imdct

L = 16


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _inputs(K, seed):
    rng = np.random.default_rng(seed)
    m_t = np.ascontiguousarray(imdct_matrix(K).astype(np.float32).T)
    window = rng.uniform(0, 1, (L, 2 * K)).astype(np.float32)
    return rng, m_t, window


@pytest.mark.parametrize("K", [1024, 128])
def test_imdct_window_plain_matches_pallas(K):
    rng, m_t, window = _inputs(K, K)
    coef = (rng.standard_normal((L, K)) * 100).astype(np.float32)
    ref = np.asarray(pk.imdct_window_pallas(jnp.asarray(coef), jnp.asarray(m_t), jnp.asarray(window)))
    # an [L, N] window is a bank whose row i serves output row i
    got = imdct.imdct_window(torch.from_numpy(coef), imdct.imdct_basis(torch.from_numpy(m_t)),
                             torch.from_numpy(window), torch.arange(L, dtype=torch.int32))
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("K", [1024, 128])
def test_dequant_imdct_window_plain_matches_pallas(K):
    rng, m_t, window = _inputs(K, K + 1)
    q = rng.integers(-64, 65, (L, K)).astype(np.int32)
    q[rng.uniform(size=(L, K)) < 0.5] = 0
    scale = rng.uniform(0.5, 2.0, (L, K)).astype(np.float32)
    ref = np.asarray(pk.aac_dequant_imdct_window_pallas(
        jnp.asarray(q), jnp.asarray(scale), jnp.asarray(m_t), jnp.asarray(window),
        tile_l=8, tile_n=min(512, 2 * K)))
    got = imdct.dequant_imdct_window(torch.from_numpy(q), torch.from_numpy(scale),
                                     imdct.imdct_basis(torch.from_numpy(m_t)),
                                     torch.from_numpy(window),
                                     torch.arange(L, dtype=torch.int32))
    assert _rel(got.numpy(), ref) <= 1e-5


def test_window_bank_rows_follow_win_idx():
    """A bank row index per output row equals the explicit [L, N]
    window gathered from the bank (the main path's window lookup)."""
    rng, m_t, _ = _inputs(128, 7)
    bank = rng.uniform(0, 1, (32, 256)).astype(np.float32)
    idx = rng.integers(0, 32, L).astype(np.int32)
    coef = rng.standard_normal((L, 128)).astype(np.float32)
    ref = np.asarray(pk.imdct_window_pallas(jnp.asarray(coef), jnp.asarray(m_t), jnp.asarray(bank[idx])))
    got = imdct.imdct_window(torch.from_numpy(coef), imdct.imdct_basis(torch.from_numpy(m_t)),
                             torch.from_numpy(bank), torch.from_numpy(idx))
    assert _rel(got.numpy(), ref) <= 1e-5
