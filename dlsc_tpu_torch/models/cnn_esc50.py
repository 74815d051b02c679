"""The spectrogram-image CNN (the Inik 2023 HPO widths).

Counterpart of ``dlsc_tpu/models/cnn_esc50.py`` ``CNN_ESC50`` (:165-199),
in NCHW, on the pipeline's 1-channel 224 x 224 log-mel images:

- five VALID conv-BN-ReLU blocks of 109, 203, 181, 210 and 169 channels
  (kernels 2, 2, 3, 4, 4), the first followed by a 4 x 4 average pool with
  stride 4, the second by a 4 x 4 max pool with stride 3;
- FC 850, ReLU, dropout 0.5, FC num_classes.

The trunk is flattened in the JAX package's NHWC order (9 x 9 x 169 = 13 689
features at 224²), so a JAX ``Dense_0`` kernel loads as it is. Weights:
Flax's default init (truncated LeCun normal, zero biases).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dlsc_tpu_torch.models.layers import (BatchNorm, CNNBase, as_dtype, conv, dtype_name,
                                          fans, flax_params, lecun_normal_, linear)
from dlsc_tpu_torch.ops.dropout_draw import Draw, dropout

# (channels, kernel, pool window, pool stride, pool kind) of each block
BLOCKS = ((109, 2, 4, 4, "avg"), (203, 2, 4, 3, "max"), (181, 3, None, None, None),
          (210, 4, None, None, None), (169, 4, None, None, None))
HIDDEN, DROPOUT = 850, 0.5


def trunk_shape(size: int) -> tuple[int, int, int]:
    """(H, W, C) of the trunk's output on a size x size image."""
    for _, k, pool, stride, _ in BLOCKS:
        size = size - k + 1
        if pool:
            size = (size - pool) // stride + 1
    return size, size, BLOCKS[-1][0]


class CNN_ESC50(CNNBase):
    """The CNN on (B, H, W), (B, 1, H, W) or (B, C, H, W) images (C > 1 is
    averaged); ``forward`` as ``layers.CNNBase``. ``image_size`` sizes the
    first dense layer (the JAX module infers it from its input)."""

    def __init__(self, num_classes: int = 50, image_size: int = 224,
                 dtype: torch.dtype | str = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dtype = as_dtype(dtype)
        self.config = dict(num_classes=num_classes, image_size=image_size,
                           dtype=dtype_name(dtype))
        cin, convs, bns = 1, [], []
        for cout, k, *_ in BLOCKS:
            convs.append(nn.Conv2d(cin, cout, k))
            bns.append(BatchNorm(cout))
            cin = cout
        self.convs, self.bns = nn.ModuleList(convs), nn.ModuleList(bns)
        h, w, c = trunk_shape(image_size)
        self.fc1 = nn.Linear(h * w * c, HIDDEN)
        self.fc2 = nn.Linear(HIDDEN, num_classes)
        self._finish(dtype, device, generator)

    @torch.no_grad()
    def _init(self, gen: torch.Generator | None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, fans(m.weight)[0], gen)
                m.bias.zero_()

    def flax_names(self) -> dict[str, str]:
        names = {}
        for i in range(len(BLOCKS)):
            names.update(flax_params(f"Conv_{i}", f"convs.{i}", "conv"))
            names.update(flax_params(f"BatchNorm_{i}", f"bns.{i}", "bn"))
        names.update(flax_params("Dense_0", "fc1", "dense"))
        names.update(flax_params("Dense_1", "fc2", "dense"))
        return names

    def logits(self, x: torch.Tensor, draw: Draw | None) -> torch.Tensor:
        if x.ndim == 4:
            x = x.mean(dim=1) if x.shape[1] > 1 else x[:, 0]
        B = x.shape[0]
        x = x.to(self.dtype)[:, None]
        for (_, _, pool, stride, kind), cv, bn in zip(BLOCKS, self.convs, self.bns):
            x = F.relu(bn(conv(x, cv)))
            if kind == "avg":
                x = F.avg_pool2d(x, pool, stride)
            elif kind == "max":
                x = F.max_pool2d(x, pool, stride)
        x = x.permute(0, 2, 3, 1).reshape(B, -1)               # the NHWC flatten
        x = dropout(F.relu(linear(x, self.fc1)), DROPOUT, draw, 0)
        return F.linear(x.float(), self.fc2.weight.float(), self.fc2.bias.float())
