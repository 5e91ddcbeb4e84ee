"""Compound networks (mirror of ``paddle_tpu/nets.py``; reference
python/paddle/fluid/nets.py: simple_img_conv_pool :24, img_conv_group
:126, sequence_conv_pool :244, glu, scaled_dot_product_attention
:329)."""

from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """A run of convs (each optionally batch-normed and dropped out,
    `downgrade_in_infer`) and one pool (VGG's block)."""
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]

    def _expand(v):
        return v if isinstance(v, (list, tuple)) else [v] * len(conv_num_filter)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i], param_attr=param_attr[i],
                            act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """sequence_conv, then sequence_pool (reference nets.py
    sequence_conv_pool)."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention (reference nets.py:329),
    the op chain scale -> matmul -> softmax -> dropout -> matmul.
    [B, T, D] in, [B, T, D] out."""
    if queries.shape[-1] % num_heads != 0:
        raise ValueError("hidden size must divide num_heads")
    d_key = queries.shape[-1] // num_heads

    def _split_heads(x):
        if num_heads == 1:
            return x
        b = layers.reshape(x, shape=[0, 0, num_heads, x.shape[-1] // num_heads])
        return layers.transpose(b, perm=[0, 2, 1, 3])

    def _merge_heads(x):
        if num_heads == 1:
            return x
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(t, shape=[0, 0, t.shape[2] * t.shape[3]])

    q, k, v = _split_heads(queries), _split_heads(keys), _split_heads(values)
    scaled = layers.scale(x=q, scale=d_key ** -0.5)
    product = layers.matmul(x=scaled, y=k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    return _merge_heads(ctx)
