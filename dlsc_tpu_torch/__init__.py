"""dlsc_tpu_torch — the PyTorch / CUDA port of dlsc_tpu for NVIDIA Hopper.

The JAX package ``dlsc_tpu`` is the reference this package is held against.
The port covers every model family of the JAX package: the AST family
(AST-Base, AST-Small, AST-Mini, AST-MoE), EnvNet-v2, the spectrogram-image
CNN and LEAF; their pipelines (log-mel, crops and waveform augmentations,
BC mixing, the CNN's images), the models in train and eval mode with
Flax-style BatchNorm, the train step, the fold data path and the Trainer
behind the train, evaluate and predict CLIs, the export/load artifact, the
micro-batching HTTP server and the train and inference benches. Its hot kernels
are hand-written CUDA for ``sm_90a`` (``csrc/``), built at first use by
``dlsc_tpu_torch._kernels``; a CPU tensor takes each kernel's plain PyTorch
version instead.

Nothing here imports ``jax``.
"""

__version__ = "0.1.0"
