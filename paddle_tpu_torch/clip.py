"""Gradient clipping (reference: python/paddle/fluid/clip.py):
ErrorClipByValue, GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm — applied between backward and the update ops.
Copy of ``paddle_tpu/clip.py``: the clips append `clip`,
`clip_by_norm`, and for the global norm `square`, `reduce_sum`, `sum`,
`sqrt`, `fill_constant`, `elementwise_max`, `elementwise_div` and
`elementwise_mul`, whose rules are in ``ops/math.py``."""

from __future__ import annotations

from .core import ir


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def append_clip_op(self, block, grad_name):
        block.append_op("clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max})


def error_clip_callback(block, context):
    pass  # per-op error clip hooks are applied via ErrorClipByValue directly


class BaseGradientClipAttr:
    def _create_operators(self, param, grad):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=f"{grad.name}@clip", shape=grad.shape,
                               dtype=grad.dtype, stop_gradient=True)
        block.append_op("clip", inputs={"X": [grad.name]},
                        outputs={"Out": [out.name]},
                        attrs={"min": self.min, "max": self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=f"{grad.name}@clip", shape=grad.shape,
                               dtype=grad.dtype, stop_gradient=True)
        block.append_op("clip_by_norm", inputs={"X": [grad.name]},
                        outputs={"Out": [out.name]},
                        attrs={"max_norm": self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale all gradients by clip_norm/max(global_norm, clip_norm)
    (reference clip.py GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    @staticmethod
    def apply(params_grads, clip_norm):
        if not params_grads:
            return params_grads
        block = params_grads[0][1].block
        sq_sums = []
        for p, g in params_grads:
            sq = block.create_var(name=f"{g.name}@sq", shape=(1,),
                                  dtype=g.dtype, stop_gradient=True)
            block.append_op("square", inputs={"X": [g.name]},
                            outputs={"Out": [f"{g.name}@sq_full"]})
            block.create_var(name=f"{g.name}@sq_full", shape=g.shape,
                             dtype=g.dtype, stop_gradient=True)
            block.append_op("reduce_sum", inputs={"X": [f"{g.name}@sq_full"]},
                            outputs={"Out": [sq.name]},
                            attrs={"reduce_all": True, "keep_dim": False})
            sq_sums.append(sq.name)
        gnorm_sq = block.create_var(name="@global_norm_sq@" + sq_sums[0],
                                    shape=(1,), dtype="float32", stop_gradient=True)
        block.append_op("sum", inputs={"X": sq_sums}, outputs={"Out": [gnorm_sq.name]})
        gnorm = block.create_var(name=gnorm_sq.name + "@sqrt", shape=(1,),
                                 dtype="float32", stop_gradient=True)
        block.append_op("sqrt", inputs={"X": [gnorm_sq.name]},
                        outputs={"Out": [gnorm.name]})
        # scale = clip_norm / max(gnorm, clip_norm)
        denom = block.create_var(name=gnorm.name + "@max", shape=(1,),
                                 dtype="float32", stop_gradient=True)
        cn = block.create_var(name=gnorm.name + "@cn", shape=(1,),
                              dtype="float32", stop_gradient=True)
        block.append_op("fill_constant", outputs={"Out": [cn.name]},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": float(clip_norm)})
        block.append_op("elementwise_max", inputs={"X": [gnorm.name], "Y": [cn.name]},
                        outputs={"Out": [denom.name]}, attrs={"axis": -1})
        scale = block.create_var(name=gnorm.name + "@scale", shape=(1,),
                                 dtype="float32", stop_gradient=True)
        block.append_op("elementwise_div", inputs={"X": [cn.name], "Y": [denom.name]},
                        outputs={"Out": [scale.name]}, attrs={"axis": -1})
        out = []
        for p, g in params_grads:
            ng = block.create_var(name=f"{g.name}@gclip", shape=g.shape,
                                  dtype=g.dtype, stop_gradient=True)
            block.append_op("elementwise_mul", inputs={"X": [g.name], "Y": [scale.name]},
                            outputs={"Out": [ng.name]}, attrs={"axis": -1})
            out.append((p, block.vars[ng.name]))
        return out

    def _create_operators(self, param, grad):
        raise RuntimeError("use GradientClipByGlobalNorm.apply / set_gradient_clip")


_global_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    global _global_clip
    _global_clip = clip


def append_gradient_clip_ops(params_grads):
    global _global_clip
    if isinstance(_global_clip, GradientClipByGlobalNorm):
        return GradientClipByGlobalNorm.apply(params_grads, _global_clip.clip_norm)
    out = []
    for p, g in params_grads:
        if g is None:
            out.append((p, g))
            continue
        clip_attr = getattr(p, "gradient_clip", None) or _global_clip
        if clip_attr is None:
            out.append((p, g))
        else:
            out.append(clip_attr._create_operators(p, g))
    return out
