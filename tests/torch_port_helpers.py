"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Real v4 wires come from the committed 48 kHz fixtures
(tests/data/torch_port) through the port's standalone host parser.
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np

from soundkit_tpu_torch.tools import aac_fixtures

SR_INDEX_48K = 3
# AUs per clip that cover long, short (EIGHT_SHORT) and TNS frames
PICKS = (1, 9, 13, 22, 40, 94, 112)


@functools.lru_cache(maxsize=1)
def clip_aus() -> List[List[bytes]]:
    """Raw AUs (ADTS headers stripped) of every fixture clip."""
    return aac_fixtures.clip_aus(aac_fixtures.load_clips())


@functools.lru_cache(maxsize=1)
def host_parser():
    from soundkit_tpu_torch.native import AacHostParser

    return AacHostParser(SR_INDEX_48K)


def picked_aus() -> List[bytes]:
    """One AU per (clip, pick): 42 AUs of mixed content."""
    return [aus[i] for aus in clip_aus() for i in PICKS]


def v4_wire(aus: List[bytes]) -> np.ndarray:
    buf, overflow = host_parser().pack_v4(aus)
    assert not overflow
    return buf


def snr_db(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.sum((got - ref) ** 2)
    return float(10 * np.log10(np.sum(ref**2) / max(err, 1e-300)))


def lane_snrs(got, ref, lane_axis: int) -> np.ndarray:
    """SNR per lane; lanes whose reference is silent must match exactly
    and report +inf."""
    got = np.moveaxis(np.asarray(got, np.float64), lane_axis, 0)
    ref = np.moveaxis(np.asarray(ref, np.float64), lane_axis, 0)
    out = []
    for g, r in zip(got, ref):
        if not np.any(r):
            assert not np.any(g), "output on a silent lane"
            out.append(np.inf)
        else:
            out.append(snr_db(g, r))
    return np.array(out)
