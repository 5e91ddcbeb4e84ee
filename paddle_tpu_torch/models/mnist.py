"""MNIST CNN (mirror of ``paddle_tpu/models/mnist.py``; reference:
benchmark/fluid/models/mnist.py cnn_model)."""

from __future__ import annotations

from .. import layers, nets


def cnn_model(data):
    conv_pool_1 = nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2, pool_stride=2,
        act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    predict = layers.fc(input=conv_pool_2, size=10, act="softmax")
    return predict


def build(batch_size=None):
    """Returns (feeds, fetches): classification training graph."""
    images = layers.data(name="pixel", shape=[1, 28, 28], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = cnn_model(images)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return {"pixel": images, "label": label}, {"loss": avg_cost, "acc": acc,
                                               "predict": predict}
