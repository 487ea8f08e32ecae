"""PyTorch + CUDA port of soundkit-tpu's batched decode.

The JAX package ``soundkit_tpu`` stays the reference; this package
mirrors its layout (``ops/``, ``models/``, ``utils/``) and imports its
host layer (framing, the C++ syntax parser's wire packers, numpy
tables) but never JAX. Hand-written CUDA kernels live in ``csrc/`` and
are built at first use (``_build.py``).
"""
