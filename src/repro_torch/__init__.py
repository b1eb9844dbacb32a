"""PyTorch/CUDA port of the memory-planning inference system.

The JAX package ``repro`` is the reference; this package mirrors its
layout and module names so that the counterpart of a module is easy to
find. It imports ``torch`` and ``numpy`` and nothing of ``repro`` or JAX:
what it needs from the reference's plain-Python modules (configs, the
planning core) it keeps as its own copy.

Entry points (``runtime.engine.InferenceEngine``, ``launch.serve``) run on
the CUDA device unless the caller asks for the CPU.
"""
