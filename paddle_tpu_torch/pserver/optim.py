"""Server-side optimizer kernels (numpy, dense + per-row sparse).

Capability parity with the reference pserver's per-param optimize blocks
(reference: python/paddle/fluid/transpiler/distribute_transpiler.py:333
`get_pserver_program` builds one optimize sub-block per param slice;
operators' SelectedRows kernels, e.g. paddle/fluid/operators/sgd_op.h:63,
adam_op.h sparse path, apply row-wise updates for sparse grads).

Mirror of ``paddle_tpu/pserver/optim.py``, copied bit for bit. The host
PS runs on CPU; numpy is the natural kernel substrate (the
reference's pserver optimize blocks likewise run CPU Eigen kernels). Each
optimizer holds its accumulators keyed like the reference's
`_create_accumulators`, and exposes `dense(param, grad)` plus
`sparse(param, rows, row_grads)` for barrierless per-grad updates
(RunAsyncLoop semantics: no barriers, latest-write-wins).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class ServerOptimizer:
    """Base: subclasses update in place (param is the server's array)."""

    def __init__(self, lr: float, attrs: Dict):
        self.lr = float(lr)
        self.attrs = attrs or {}
        self._acc: Dict[str, np.ndarray] = {}

    def _accum(self, key, like, fill=0.0):
        if key not in self._acc:
            self._acc[key] = np.full_like(like, fill)
        return self._acc[key]

    def dense(self, param: np.ndarray, grad: np.ndarray) -> None:
        raise NotImplementedError

    def sparse(self, param: np.ndarray, rows: np.ndarray,
               row_grads: np.ndarray) -> None:
        """Default row-wise path: gather, dense-update the slice, scatter.
        Duplicated rows must be pre-combined by the client (reference
        merge_ids semantics)."""
        sub = param[rows]
        self._sparse_rows(param, rows, sub, row_grads)

    def _sparse_rows(self, param, rows, sub, row_grads):
        raise NotImplementedError

    def state(self):
        return {"lr": self.lr, "attrs": self.attrs, "acc": self._acc}

    def load_state(self, st):
        self.lr = st["lr"]
        self.attrs = st["attrs"]
        self._acc = st["acc"]


class SGD(ServerOptimizer):
    def dense(self, param, grad):
        param -= self.lr * grad

    def _sparse_rows(self, param, rows, sub, row_grads):
        param[rows] = sub - self.lr * row_grads


class Momentum(ServerOptimizer):
    def dense(self, param, grad):
        mu = self.attrs.get("mu", 0.9)
        v = self._accum("velocity", param)
        v *= mu
        v += grad
        if self.attrs.get("use_nesterov"):
            param -= self.lr * (grad + mu * v)
        else:
            param -= self.lr * v

    def _sparse_rows(self, param, rows, sub, row_grads):
        mu = self.attrs.get("mu", 0.9)
        v = self._accum("velocity", param)
        vr = mu * v[rows] + row_grads
        v[rows] = vr
        if self.attrs.get("use_nesterov"):  # match the dense path exactly
            param[rows] = sub - self.lr * (row_grads + mu * vr)
        else:
            param[rows] = sub - self.lr * vr


class Adagrad(ServerOptimizer):
    def dense(self, param, grad):
        eps = self.attrs.get("epsilon", 1e-6)
        m = self._accum("moment", param)
        m += grad * grad
        param -= self.lr * grad / (np.sqrt(m) + eps)

    def _sparse_rows(self, param, rows, sub, row_grads):
        eps = self.attrs.get("epsilon", 1e-6)
        m = self._accum("moment", param)
        mr = m[rows] + row_grads * row_grads
        m[rows] = mr
        param[rows] = sub - self.lr * row_grads / (np.sqrt(mr) + eps)


class Adam(ServerOptimizer):
    def dense(self, param, grad):
        b1 = self.attrs.get("beta1", 0.9)
        b2 = self.attrs.get("beta2", 0.999)
        eps = self.attrs.get("epsilon", 1e-8)
        m = self._accum("moment1", param)
        v = self._accum("moment2", param)
        t = self._acc.setdefault("t", np.zeros((), np.int64))
        self._acc["t"] = t = t + 1
        m *= b1
        m += (1 - b1) * grad
        v *= b2
        v += (1 - b2) * grad * grad
        mhat = m / (1 - b1 ** int(t))
        vhat = v / (1 - b2 ** int(t))
        param -= self.lr * mhat / (np.sqrt(vhat) + eps)

    def _sparse_rows(self, param, rows, sub, row_grads):
        # per-row lazy adam (reference adam_op.h sparse path updates only
        # touched rows; a per-row step counter keeps bias correction local)
        b1 = self.attrs.get("beta1", 0.9)
        b2 = self.attrs.get("beta2", 0.999)
        eps = self.attrs.get("epsilon", 1e-8)
        m = self._accum("moment1", param)
        v = self._accum("moment2", param)
        steps = self._acc.setdefault(
            "row_t", np.zeros((param.shape[0],), np.int64))
        steps[rows] += 1
        t = steps[rows][:, None].astype(param.dtype)
        mr = b1 * m[rows] + (1 - b1) * row_grads
        vr = b2 * v[rows] + (1 - b2) * row_grads * row_grads
        m[rows] = mr
        v[rows] = vr
        mhat = mr / (1 - b1 ** t)
        vhat = vr / (1 - b2 ** t)
        param[rows] = sub - self.lr * mhat / (np.sqrt(vhat) + eps)


_KERNELS = {"sgd": SGD, "momentum": Momentum, "adagrad": Adagrad,
            "adam": Adam}


def make_optimizer(op_type: str, lr: float, attrs: Dict) -> ServerOptimizer:
    if op_type not in _KERNELS:
        raise NotImplementedError(
            f"server-side optimizer {op_type!r} not implemented; supported: "
            f"{sorted(_KERNELS)} (reference pserver optimize blocks support "
            f"any op — add the kernel here)")
    return _KERNELS[op_type](lr, attrs)
