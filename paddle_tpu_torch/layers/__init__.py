"""The layers DSL (the slices' subset of ``paddle_tpu/layers``)."""

from .io import (data, py_reader, open_recordio_file,  # noqa: F401
                 double_buffer, ListenAndServ, Send, Recv,
                 read_file, shuffle, batch, open_files,
                 random_data_generator, load, Preprocessor)
from .metric_op import accuracy  # noqa: F401
from .nn import (batch_norm, cast, ceil, clip, clip_by_norm,  # noqa: F401
                 conv2d, cross_entropy, dropout, dynamic_gru, dynamic_lstm,
                 dynamic_lstmp, elementwise_add, elementwise_div,
                 elementwise_max, elementwise_min, elementwise_mul,
                 elementwise_pow, elementwise_sub, embedding, exp, fc,
                 floor, gru_unit, layer_norm, lstm_unit, matmul, mean,
                 pool2d, reduce_sum, relu, reshape, row_conv, scale,
                 sequence_concat, sequence_conv, sequence_erase,
                 sequence_expand, sequence_first_step, sequence_last_step,
                 sequence_mask, sequence_pool, sequence_reshape,
                 sequence_slice, sequence_softmax, sigmoid,
                 sigmoid_cross_entropy_with_logits, slice, softmax,
                 square_error_cost,
                 softmax_with_cross_entropy, split, sqrt, square, squeeze,
                 tanh, topk, transpose, unsqueeze)
from .tensor import (assign, concat, fill_constant,  # noqa: F401
                     fill_constant_batch_size_like, sums)
from .control_flow import (While, StaticRNN, Switch, DynamicRNN,  # noqa: F401
                           IfElse, increment, less_than, equal,
                           create_array, array_write, array_read,
                           array_length, lod_rank_table, max_sequence_len,
                           lod_tensor_to_array, array_to_lod_tensor,
                           shrink_memory, reorder_lod_tensor_by_rank,
                           Print, is_empty)
from . import learning_rate_scheduler  # noqa: F401
from .learning_rate_scheduler import (append_LARS,  # noqa: F401
                                      exponential_decay, inverse_time_decay,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
from .math_op_patch import monkey_patch_variable

monkey_patch_variable()
