"""resnet18-cifar10 [cnn] — the paper's own experimental architecture.

ResNet18 with channel multiplier 0.25/0.5 on CIFAR10; every stride-1 3x3
conv runs the quantized Winograd F(4x4,3x3) pipeline (Legendre base,
8-bit with 9-bit Hadamard by default). See repro.models.resnet.
"""
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.winograd import WinogradSpec
from repro_torch.models.resnet import ResNetConfig

CONFIG = ResNetConfig(
    name="resnet18-cifar10",
    width_mult=0.5,
    wino=WinogradSpec(m=4, r=3, base="legendre",
                      quant=QuantConfig(hadamard_bits=9)),
    use_winograd=True,
)
