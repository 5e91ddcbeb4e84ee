"""Models of the slices: tiny_lm (serving), the Transformer, the MNIST CNN
and ResNet (training)."""

from . import mnist, resnet, tiny_lm, transformer  # noqa: F401
