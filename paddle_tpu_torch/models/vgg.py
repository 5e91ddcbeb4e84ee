"""VGG-16 with batch norm and dropout (copy of
``paddle_tpu/models/vgg.py``; reference benchmark/fluid/models/vgg.py):
five `nets.img_conv_group` blocks of 3 x 3 convs, each conv batch-normed
and dropped out (`downgrade_in_infer`, so the dropout kernel never runs
here), then two 512-wide fcs. Convs, pools and batch norm are torch's
own, cuDNN on the card."""

from __future__ import annotations

from .. import layers, nets


def vgg16_bn_drop(input, is_test=False):
    def conv_block(inp, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=inp, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0.0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0.0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0.0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0.0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0.0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", is_test=is_test)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return fc2


def build(class_dim=10, image_shape=(3, 32, 32), is_test=False):
    image = layers.data(name="image", shape=list(image_shape), dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    net = vgg16_bn_drop(image, is_test=is_test)
    predict = layers.fc(input=net, size=class_dim, act="softmax")
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    return {"image": image, "label": label}, {"loss": avg_cost, "acc": acc,
                                              "predict": predict}
