"""EnvNet-v2 (Tokozume 2018): the raw-waveform CNN.

Counterpart of ``dlsc_tpu/models/envnet_v2.py`` ``EnvNetV2`` (:72-141), in
NCHW:

- two temporal conv-BN-ReLUs, (1, 64) stride 2 and (1, 16) stride 2, then
  a (1, 64) max pool;
- the channel → frequency swap: (B, 64, 1, W) → (B, 1, 64, W);
- four conv-conv-pool blocks of 32, 64, 128 and 256 channels;
- FC 4096 → 4096 → num_classes, ReLU and dropout after the first two.

Convolutions are VALID with biases; every BatchNorm is ``layers.BatchNorm``
(Flax's). The trunk is flattened in the JAX package's NHWC order ((B, H, W,
C), 10 x 33 x 256 = 84 480 features on a 5-s clip), so a JAX ``Dense_0``
kernel loads as it is. ``F.max_pool2d`` replaces both of the JAX
``pool_impl``s, and the JAX ``bn_barrier`` (an XLA fusion barrier with
identity semantics) has no counterpart. Weights: Kaiming normal over
fan-out for the convolutions and N(0, 1/fan_in) for the dense layers, zero
biases, as the JAX package initialises them.

    model = EnvNetV2(num_classes=50, generator=torch.Generator().manual_seed(0))
    logits = model(wave)            # (B, T) → (B, 50) f32
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dlsc_tpu_torch.models.layers import (BatchNorm, CNNBase, as_dtype, conv, dtype_name,
                                          fans, flax_params, linear, normal_)
from dlsc_tpu_torch.ops.dropout_draw import Draw, dropout

# (channels, kernel, stride) of the two front-end convolutions
FRONT = ((32, (1, 64), (1, 2)), (64, (1, 16), (1, 2)))
FRONT_POOL = (1, 64)
# (channels, first kernel, second kernel, pool) of the four trunk blocks
TRUNK = ((32, (8, 8), (8, 8), (5, 3)),
         (64, (1, 4), (1, 4), (1, 2)),
         (128, (1, 2), (1, 2), (1, 2)),
         (256, (1, 2), (1, 2), (1, 2)))
FC = (4096, 4096)


class ConvBNRelu(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=(1, 1)):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, kernel, stride)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(conv(x, self.conv, self.stride)))


def trunk_shape(num_samples: int) -> tuple[int, int, int]:
    """(H, W, C) of the trunk's output on a clip of ``num_samples``."""
    w = num_samples
    for _, k, s in FRONT:
        w = (w - k[1]) // s[1] + 1
    w //= FRONT_POOL[1]
    h = FRONT[-1][0]
    for _, k1, k2, pool in TRUNK:
        h, w = h - k1[0] + 1 - k2[0] + 1, w - k1[1] + 1 - k2[1] + 1
        h, w = h // pool[0], w // pool[1]
    return h, w, TRUNK[-1][0]


class EnvNetV2(CNNBase):
    """EnvNet-v2 on (B, T), (B, 1, T) or (B, 1, 1, T) waveforms; ``forward``
    as ``layers.CNNBase``. ``input_samples``, the length of one input (the
    pipeline's window: 5 s at 44.1 kHz in every config), sizes the first
    dense layer, which the JAX module infers from its first input; another
    length raises. ``config`` holds the constructor arguments."""

    def __init__(self, num_classes: int = 50, dropout: float = 0.5,
                 input_samples: int = 220_500, dtype: torch.dtype | str = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dtype = as_dtype(dtype)
        self.config = dict(num_classes=num_classes, dropout=dropout,
                           input_samples=input_samples, dtype=dtype_name(dtype))
        self.rate = dropout
        h, w, c = trunk_shape(input_samples)
        if h < 1 or w < 1:
            raise ValueError(f"EnvNetV2: a clip of {input_samples} samples leaves no trunk "
                             "output; ~30 000 samples at least")
        cin, front = 1, []
        for cout, k, s in FRONT:
            front.append(ConvBNRelu(cin, cout, k, s))
            cin = cout
        self.front = nn.ModuleList(front)
        cin, trunk = 1, []
        for cout, k1, k2, _ in TRUNK:
            trunk += [ConvBNRelu(cin, cout, k1), ConvBNRelu(cout, cout, k2)]
            cin = cout
        self.trunk = nn.ModuleList(trunk)
        widths = (h * w * c, *FC, num_classes)
        self.fc = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self._finish(dtype, device, generator)

    @torch.no_grad()
    def _init(self, gen: torch.Generator | None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_(m.weight, 2.0 / fans(m.weight)[1], gen)   # Kaiming, fan-out
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                normal_(m.weight, 1.0 / m.in_features, gen)
                m.bias.zero_()

    def flax_names(self) -> dict[str, str]:
        names = {}
        for i in range(len(self.front) + len(self.trunk)):
            prefix = f"front.{i}" if i < len(self.front) else f"trunk.{i - len(self.front)}"
            names.update(flax_params(f"_ConvBNRelu_{i}/Conv_0", f"{prefix}.conv", "conv"))
            names.update(flax_params(f"_ConvBNRelu_{i}/BatchNorm_0", f"{prefix}.bn", "bn"))
        for i in range(len(self.fc)):
            names.update(flax_params(f"Dense_{i}", f"fc.{i}", "dense"))
        return names

    def logits(self, x: torch.Tensor, draw: Draw | None) -> torch.Tensor:
        if x.ndim == 3:
            x = x[:, 0]
        elif x.ndim == 4:
            x = x[:, 0, 0]
        B, n = x.shape
        if n != self.config["input_samples"]:
            raise ValueError(f"EnvNetV2 was built for inputs of {self.config['input_samples']} "
                             f"samples and got {n}: build it with input_samples={n}")
        x = x.to(self.dtype)[:, None, None, :]                 # (B, 1, 1, T)
        for blk in self.front:
            x = blk(x)
        x = F.max_pool2d(x, FRONT_POOL)
        x = x.transpose(1, 2)                                  # (B, 1, 64, W): channels → H
        for i, (_, _, _, pool) in enumerate(TRUNK):
            x = self.trunk[2 * i + 1](self.trunk[2 * i](x))
            x = F.max_pool2d(x, pool)
        x = x.permute(0, 2, 3, 1).reshape(B, -1)               # the NHWC flatten
        for site, layer in enumerate(self.fc[:-1]):
            x = dropout(F.relu(linear(x, layer)), self.rate, draw, site)
        head = self.fc[-1]
        return F.linear(x.float(), head.weight.float(), head.bias.float())
