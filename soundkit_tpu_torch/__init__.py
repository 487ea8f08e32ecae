"""PyTorch + CUDA port of soundkit-tpu's batched decode.

The JAX package ``soundkit_tpu`` stays the reference; this package
mirrors its layout (``codecs/``, ``ops/``, ``models/``, ``utils/``) and
imports nothing of it and no JAX: the host pieces it needs (ADTS
framing, the wire packers, the C++ syntax parser's source in
``native_src/``, the numpy tables in ``data/`` and the ops modules) are
its own copies. Hand-written CUDA kernels live in ``csrc/`` and are
built at first use (``_build.py``).
"""
