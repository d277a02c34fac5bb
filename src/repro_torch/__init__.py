"""repro_torch — the PyTorch/CUDA port of ``repro``.

The package mirrors ``src/repro/`` path for path: each module's reference is
the file at the same path under ``repro/``. It imports ``torch`` and numpy
only, never ``jax`` and never ``repro``. Attention, the MoE experts' SwiGLU
and the Mamba selective scan run through kernels written by hand for Hopper
(``repro_torch.kernels``); the plain large matrix products stay
``torch.matmul``, as the JAX package leaves them to XLA.
"""
