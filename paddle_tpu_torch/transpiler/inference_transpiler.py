"""Inference graph rewrites (reference:
python/paddle/fluid/transpiler/inference_transpiler.py — `fuse_batch_norm`
:107 folds BN into the preceding conv's weights/bias; fuse_relu_mkldnn :63).

Mirror of ``paddle_tpu/transpiler/inference_transpiler.py``. The port
runs a block op by op, so a batch norm that stays in the Program costs
its own rule call and its elementwise passes over the conv's output on
every batch; folded, it is one bias add inside the conv's rule. The
batch norm's four parameters stay declared, so a folded model saved by
`io.save_inference_model` still holds them, beside the new biases, as
the JAX package's does (ROADMAP Queue 3).

The arithmetic is done in numpy on host copies, in the JAX package's
expression order, so the folded parameters equal the JAX package's bit
for bit; each result is then written back onto the device that held the
tensor it replaces (a card scope keeps every parameter on the card).

Like the JAX fold, this one folds every conv2d -> batch_norm pair whose
batch norm reads the conv's output: it checks neither the batch norm's
`is_test` nor whether another op reads the conv's output (ROADMAP Queue
3: a training-mode pair folds with its running statistics, and a second
reader of the conv's output loses it). Run it on inference programs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import ir
from ..core.executor import global_scope


def _host(val) -> np.ndarray:
    """A scope value as a host numpy array (a copy of a device tensor)."""
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def _like(ref, arr: np.ndarray):
    """`arr` as the kind of value `ref` is: a tensor on `ref`'s device,
    or numpy."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(ref.device)
    return arr


class InferenceTranspiler:
    def transpile(self, program: ir.Program, place=None, scope=None):
        scope = scope or global_scope()
        self._fuse_batch_norm(program, scope)
        return program

    def _fuse_batch_norm(self, program: ir.Program, scope):
        """Fold conv2d -> batch_norm pairs: W' = W * gamma/std,
        b' = beta - gamma*mean/std (reference inference_transpiler.py:107).
        Returns the number of pairs folded."""
        block = program.global_block()
        i = 0
        fused = 0
        while i < len(block.ops) - 1:
            op = block.ops[i]
            nxt = block.ops[i + 1]
            if (op.type == "conv2d" and nxt.type == "batch_norm"
                    and op.output("Output") and nxt.input("X")
                    and op.output("Output")[0] == nxt.input("X")[0]):
                w_name = op.input("Filter")[0]
                w_val = scope.find_var(w_name)
                scale = _host(scope.find_var(nxt.input("Scale")[0]))
                bias = _host(scope.find_var(nxt.input("Bias")[0]))
                mean = _host(scope.find_var(nxt.input("Mean")[0]))
                var = _host(scope.find_var(nxt.input("Variance")[0]))
                w = _host(w_val)
                eps = nxt.attrs.get("epsilon", 1e-5)
                std = np.sqrt(var + eps)
                scope.set_var(w_name, _like(
                    w_val, w * (scale / std).reshape(-1, 1, 1, 1)))
                conv_bias = 0.0
                if op.input("Bias"):
                    conv_bias = _host(scope.find_var(op.input("Bias")[0]))
                new_bias = (conv_bias - mean) * scale / std + bias
                bias_name = w_name + "@bn_folded_bias"
                scope.set_var(bias_name,
                              _like(w_val, new_bias.astype(w.dtype)))
                block.create_var(name=bias_name, shape=list(new_bias.shape),
                                 dtype=str(w.dtype), persistable=True)
                # rewrite: conv gains Bias, bn output aliases conv output
                op.inputs["Bias"] = [bias_name]
                op.outputs["Output"] = [nxt.output("Y")[0]]
                block.remove_op(i + 1)
                fused += 1
            i += 1
        program._bump()
        return fused
