"""dlsc_tpu_torch — the PyTorch / CUDA port of dlsc_tpu for NVIDIA Hopper.

The JAX package ``dlsc_tpu`` is the reference this package is held against.
The port covers the AST serving path: the log-mel front-end, the AST ViT in
eval mode, the export/load artifact and the micro-batching HTTP server. Its
two hot kernels are hand-written CUDA for ``sm_90a`` (``csrc/``), built at
first use by ``dlsc_tpu_torch._kernels``; a CPU tensor takes each kernel's
plain PyTorch version instead.

Nothing here imports ``jax``.
"""

__version__ = "0.1.0"
