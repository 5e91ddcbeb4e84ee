"""Models of the slices: tiny_lm (serving); the Transformer, the MNIST
CNN, ResNet, SE-ResNeXt, VGG-16, DeepFM and the stacked dynamic LSTM
(training)."""

from . import (deepfm, mnist, resnet, se_resnext,  # noqa: F401
               stacked_dynamic_lstm, tiny_lm, transformer, vgg)
