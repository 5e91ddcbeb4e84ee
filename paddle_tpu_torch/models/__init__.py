"""Models of the slices: tiny_lm (serving); the Transformer, the MNIST
CNN, ResNet, SE-ResNeXt, VGG-16, DeepFM, the stacked dynamic LSTM and
the attention seq2seq of machine_translation (training, and its beam
decode)."""

from . import (deepfm, machine_translation, mnist, resnet,  # noqa: F401
               se_resnext, stacked_dynamic_lstm, tiny_lm, transformer, vgg)
