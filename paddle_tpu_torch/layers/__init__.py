"""The layers DSL (mirror of ``paddle_tpu/layers``; the names still
waiting are listed in ``tests/test_torch_breadth.py``)."""

from .io import (data, py_reader, open_recordio_file,  # noqa: F401
                 double_buffer, ListenAndServ, Send, Recv,
                 read_file, shuffle, batch, open_files,
                 random_data_generator, load, Preprocessor)
from .nn import *  # noqa: F401,F403
from .tensor import (create_tensor, create_global_var,  # noqa: F401
                     fill_constant, fill_constant_batch_size_like, assign,
                     concat, sums, argmax, argmin, argsort, zeros, ones,
                     reverse, create_parameter)
from .ops import *  # noqa: F401,F403
from .metric_op import accuracy, auc  # noqa: F401
from .loss_layers import (nce, hsigmoid, linear_chain_crf,  # noqa: F401
                          crf_decoding, warpctc, edit_distance)
from .control_flow import (While, StaticRNN, Switch, DynamicRNN,  # noqa: F401
                           IfElse, increment, less_than, equal,
                           create_array, array_write, array_read,
                           array_length, lod_rank_table, max_sequence_len,
                           lod_tensor_to_array, array_to_lod_tensor,
                           shrink_memory, reorder_lod_tensor_by_rank,
                           Print, is_empty, ParallelDo)
from . import learning_rate_scheduler  # noqa: F401
from .learning_rate_scheduler import (append_LARS,  # noqa: F401
                                      exponential_decay, inverse_time_decay,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
from . import detection  # noqa: F401
from .detection import (prior_box, anchor_generator, iou_similarity,  # noqa: F401
                        box_coder, bipartite_match, target_assign,
                        multiclass_nms, detection_output, multi_box_head,
                        detection_map, ssd_loss, rpn_target_assign,
                        mine_hard_examples, polygon_box_transform)
from .quant import fake_quantize, fake_dequantize  # noqa: F401
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()
