"""Models of the port: the AST family's ViT, EnvNet-v2, the spectrogram CNN,
LEAF, their shared layers and the JAX weight converter."""
