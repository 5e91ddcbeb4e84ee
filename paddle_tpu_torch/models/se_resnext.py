"""SE-ResNeXt-50/101/152 for ImageNet (copy of
``paddle_tpu/models/se_resnext.py``, the BASELINE.json configuration
"ResNet-50 / SE-ResNeXt-50 ImageNet"): grouped 3 x 3 bottlenecks of
cardinality 32, squeeze-excitation with reduction 16, NCHW or NHWC.
Grouped convs are one torch conv with `groups` (cuDNN on the card); the
SE block's global pool, two fcs and `elementwise_mul` gate are ordinary
op rules.
"""

from __future__ import annotations

from .. import layers


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False, data_format="NCHW"):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False, data_format=data_format)
    return layers.batch_norm(input=conv, act=act, is_test=is_test,
                             data_layout=data_format)


def squeeze_excitation(input, num_channels, reduction_ratio=16,
                       data_format="NCHW"):
    pool = layers.pool2d(input=input, pool_type="avg", global_pooling=True,
                         data_format=data_format)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio,
                        act="relu")
    excitation = layers.fc(input=squeeze, size=num_channels, act="sigmoid")
    return _scale_channels(input, excitation, data_format)


def _scale_channels(x, gate, data_format):
    """x [B,C,H,W] (or NHWC) * gate [B,C] broadcast over space."""
    shape = [0, -1, 1, 1] if data_format == "NCHW" else [0, 1, 1, -1]
    gate = layers.reshape(gate, shape=shape)
    return layers.elementwise_mul(x, gate)


def bottleneck_block(input, num_filters, stride, cardinality=32,
                     reduction_ratio=16, is_test=False, data_format="NCHW"):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          is_test=is_test, data_format=data_format)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu", is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_test=is_test, data_format=data_format)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio,
                               data_format)
    c_axis = 1 if data_format == "NCHW" else len(input.shape) - 1
    if input.shape[c_axis] != num_filters * 2 or stride != 1:
        short = conv_bn_layer(input, num_filters * 2, 1, stride=stride,
                              act=None, is_test=is_test,
                              data_format=data_format)
    else:
        short = input
    return layers.elementwise_add(short, scale, act="relu")


def se_resnext_imagenet(input, class_dim=1000, depth=50, cardinality=32,
                        reduction_ratio=16, is_test=False,
                        data_format="NCHW"):
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
    assert depth in cfg, f"SE-ResNeXt depth must be one of {sorted(cfg)}"
    layers_per_stage = cfg[depth]
    num_filters = [128, 256, 512, 1024]

    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu",
                         is_test=is_test, data_format=data_format)
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type="max",
                         data_format=data_format)
    for stage, count in enumerate(layers_per_stage):
        for i in range(count):
            conv = bottleneck_block(
                conv, num_filters[stage], stride=2 if i == 0 and stage > 0
                else 1, cardinality=cardinality,
                reduction_ratio=reduction_ratio, is_test=is_test,
                data_format=data_format)
    pool = layers.pool2d(input=conv, pool_type="avg", global_pooling=True,
                         data_format=data_format)
    drop = layers.dropout(pool, dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=drop, size=class_dim, act="softmax")


def build(class_dim=1000, depth=50, image_shape=(3, 224, 224),
          is_test=False, data_format="NCHW"):
    if data_format == "NHWC" and image_shape[0] in (1, 3):
        image_shape = (image_shape[1], image_shape[2], image_shape[0])
    image = layers.data(name="image", shape=list(image_shape),
                        dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = se_resnext_imagenet(image, class_dim=class_dim, depth=depth,
                                  is_test=is_test, data_format=data_format)
    cost = layers.cross_entropy(input=predict, label=label)
    loss = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return ({"image": image, "label": label},
            {"loss": loss, "accuracy": acc, "predict": predict})
