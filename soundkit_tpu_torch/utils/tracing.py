"""Library tracing hooks.

Behavioral analog of the reference's ``tracing`` usage: the library
emits ``debug!`` on decoder init (soundkit-flac/src/lib.rs:717-722,
soundkit-opus/src/lib.rs:366-371) and ``trace!`` per MP3 frame
(soundkit-mp3/src/lib.rs:203-214) but installs NO subscriber — output
only appears when the application configures one.  Here that maps to
stdlib ``logging`` under the ``soundkit_tpu`` logger hierarchy with a
NullHandler: silent by default, and an application enables it with
``logging.basicConfig(level=logging.DEBUG)`` or a custom handler.

Also provides ``stage_timer`` — the "per-stage host timings" profiling
primitive (SURVEY.md §5) used by benchmarks to attribute time between
parse / transfer / device-step / readback.
"""
from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Dict

logger = logging.getLogger("soundkit_tpu")
logger.addHandler(logging.NullHandler())

TRACE = 5  # finer than DEBUG, like tracing's trace! level
logging.addLevelName(TRACE, "TRACE")


def debug_init(codec: str, **params) -> None:
    """Decoder-init debug line (reference: debug! on init)."""
    if logger.isEnabledFor(logging.DEBUG):
        kv = " ".join(f"{k}={v}" for k, v in params.items())
        logger.debug("init %s %s", codec, kv)


def trace_frame(codec: str, **fields) -> None:
    """Per-frame trace line (reference: trace! per MP3 frame)."""
    if logger.isEnabledFor(TRACE):
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        logger.log(TRACE, "frame %s %s", codec, kv)


@contextmanager
def stage_timer(stages: Dict[str, float], name: str):
    """Accumulate wall time into ``stages[name]`` (per-stage host
    timings; pairs with BenchResult for hotspot attribution)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
