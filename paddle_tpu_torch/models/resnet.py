"""ResNet for ImageNet / cifar10 (mirror of ``paddle_tpu/models/resnet.py``;
reference: benchmark/fluid/models/resnet.py).

The canonical topology through the layers DSL, op for op the JAX
package's. ``data_format="NHWC"`` runs channels-last end to end: cuDNN
takes each NHWC activation as an NCHW tensor in channels-last memory
(``ops/nn.py``), with no transpose between layers. "NCHW" is kept for
reference API parity.
"""

from __future__ import annotations

from .. import layers


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False, data_format="NCHW"):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False,
                         data_format=data_format)
    return layers.batch_norm(input=conv, act=act, is_test=is_test,
                             data_layout=data_format)


def shortcut(input, ch_out, stride, is_test=False, data_format="NCHW"):
    c_axis = 1 if data_format == "NCHW" else len(input.shape) - 1
    if input.shape[c_axis] != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test, data_format=data_format)
    return input


def basicblock(input, ch_out, stride, is_test=False, data_format="NCHW"):
    short = shortcut(input, ch_out, stride, is_test=is_test,
                     data_format=data_format)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test,
                          data_format=data_format)
    return layers.elementwise_add(short, conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False, data_format="NCHW"):
    short = shortcut(input, ch_out * 4, stride, is_test=is_test,
                     data_format=data_format)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test,
                          data_format=data_format)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test, data_format=data_format)
    return layers.elementwise_add(short, conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, is_test=False,
               data_format="NCHW"):
    res_out = block_func(input, ch_out, stride, is_test=is_test,
                         data_format=data_format)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test=is_test,
                             data_format=data_format)
    return res_out


def _space_to_depth_stem(input, is_test, data_format):
    """Space-to-depth stem: a 2x2 space-to-depth, then a 3x3 stride-1
    conv on 12 channels, in place of the 7x7 stride-2 conv on 3 (the
    JAX package's stem for its TPU, where 3 input channels fill few
    contraction lanes). Its output has the canonical stem's
    [B, 112, 112, 64] geometry."""
    assert data_format == "NHWC", "space_to_depth stem is NHWC-only"
    H, W, C = input.shape[1], input.shape[2], input.shape[3]
    assert H % 2 == 0 and W % 2 == 0, \
        f"space_to_depth stem needs even spatial dims, got {H}x{W}"
    r = layers.reshape(input, [0, H // 2, 2, W // 2, 2, C])
    t = layers.transpose(r, perm=[0, 1, 3, 2, 4, 5])
    std = layers.reshape(t, [0, H // 2, W // 2, 4 * C])
    return conv_bn_layer(std, ch_out=64, filter_size=3, stride=1, padding=1,
                         is_test=is_test, data_format=data_format)


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False,
                    data_format="NCHW", stem="conv7"):
    cfg = {18: ([2, 2, 2, 1], basicblock),
           34: ([3, 4, 6, 3], basicblock),
           50: ([3, 4, 6, 3], bottleneck),
           101: ([3, 4, 23, 3], bottleneck),
           152: ([3, 8, 36, 3], bottleneck)}
    stages, block_func = cfg[depth]
    if stem == "space_to_depth":
        conv1 = _space_to_depth_stem(input, is_test, data_format)
    else:
        conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                              padding=3, is_test=is_test,
                              data_format=data_format)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                          pool_stride=2, pool_padding=1,
                          data_format=data_format)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, is_test=is_test,
                      data_format=data_format)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, is_test=is_test,
                      data_format=data_format)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, is_test=is_test,
                      data_format=data_format)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, is_test=is_test,
                      data_format=data_format)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                          global_pooling=True, data_format=data_format)
    out = layers.fc(input=pool2, size=class_dim, act="softmax")
    return out


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False,
                   data_format="NCHW"):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1, padding=1,
                          is_test=is_test, data_format=data_format)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test=is_test,
                      data_format=data_format)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test=is_test,
                      data_format=data_format)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test=is_test,
                      data_format=data_format)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         global_pooling=True, data_format=data_format)
    out = layers.fc(input=pool, size=class_dim, act="softmax")
    return out


def build(class_dim=1000, depth=50, image_shape=(3, 224, 224), is_test=False,
          data_format="NCHW", stem="conv7"):
    if data_format == "NHWC" and image_shape[0] in (1, 3):
        image_shape = (image_shape[1], image_shape[2], image_shape[0])
    image = layers.data(name="image", shape=list(image_shape), dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = resnet_imagenet(image, class_dim=class_dim, depth=depth,
                              is_test=is_test, data_format=data_format,
                              stem=stem)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return {"image": image, "label": label}, {"loss": avg_cost, "acc": acc,
                                              "predict": predict}
