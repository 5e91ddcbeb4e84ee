"""Re-export of program-level autodiff (reference: fluid.backward; a copy
of ``paddle_tpu/backward.py``)."""

from .core.backward import append_backward, calc_gradient  # noqa: F401
