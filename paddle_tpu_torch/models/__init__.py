"""Models of the slices: tiny_lm (serving); the Transformer, the MNIST
CNN, ResNet, SE-ResNeXt, VGG-16 and DeepFM (training)."""

from . import (deepfm, mnist, resnet, se_resnext, tiny_lm,  # noqa: F401
               transformer, vgg)
