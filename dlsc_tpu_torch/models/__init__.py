"""Models of the port: the AST ViT in eval mode and the JAX weight converter."""
