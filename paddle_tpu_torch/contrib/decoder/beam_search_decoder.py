"""General RNN decoder API: training and beam-search inference (mirror
of ``paddle_tpu/contrib/decoder/beam_search_decoder.py``; reference
python/paddle/fluid/contrib/decoder/beam_search_decoder.py).

``InitState``, ``StateCell``, ``TrainingDecoder`` and
``BeamSearchDecoder`` keep the reference's contract: a ``StateCell``
owns named hidden states and step inputs, a user's ``state_updater``
computes the next state, ``TrainingDecoder`` runs the cell over
teacher-forced step inputs (a ``DynamicRNN``), ``BeamSearchDecoder``
runs it in generation mode and beam-searches the output distribution.

Generation is a ``StaticRNN`` of ``max_len`` steps on dense
``[batch, beam]`` state, as in the JAX package: a finished beam is
masked inside ``beam_search_step`` (``ops/beam.py``) instead of being
pruned from the tensor, where the reference's ``While`` over LoD arrays
shrinks the beam.
"""

from __future__ import annotations

import contextlib

from ... import layers
from ...layer_helper import LayerHelper
from ...models.machine_translation import (tile_beam, batch_gather,
                                           beam_search_step, beam_backtrack,
                                           _log_softmax)

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


@contextlib.contextmanager
def _in_parent_block(rnn):
    """Build ops in the StaticRNN's parent block while inside its step
    block — memory inits must live outside the loop body."""
    program = rnn.helper.main_program
    cur = program._current_block_idx
    program._current_block_idx = rnn._parent_block.idx
    try:
        yield
    finally:
        program._current_block_idx = cur


class InitState:
    """Initial hidden state (reference beam_search_decoder.py InitState).

    Either wraps an existing variable, or creates a constant-filled one
    shaped like ``init_boot``'s batch. ``need_reorder`` is accepted for
    API parity; the dense [batch, beam] layout keeps batch rows aligned,
    so no rank-table reorder is ever needed.
    """

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "init_boot must be provided to infer the shape of InitState")
        else:
            self._init = layers.fill_constant_batch_size_like(
                init_boot, [-1] + list(shape), dtype, value)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _MemoryState:
    """Training-mode state storage: a DynamicRNN memory."""

    def __init__(self, state_name, rnn_obj, init_state):
        self._state_name = state_name
        self._rnn_obj = rnn_obj
        self._state_mem = self._rnn_obj.memory(
            init=init_state.value, need_reorder=init_state.need_reorder)

    def get_state(self):
        return self._state_mem

    def update_state(self, state):
        self._rnn_obj.update_memory(self._state_mem, state)


class _BeamState:
    """Beam-mode state storage: a StaticRNN memory carried as
    [batch*beam, ...]; the decoder reorders it by parent beam after each
    selection step (the static analog of the reference's
    sequence_expand-by-prev_scores)."""

    def __init__(self, state_name, decoder, init_state):
        self._state_name = state_name
        self._decoder = decoder
        with _in_parent_block(decoder._rnn):
            tiled = tile_beam(init_state.value, decoder._beam_size)
        self._state_mem = decoder._rnn.memory(init=tiled)
        self._pending = None

    def get_state(self):
        return self._state_mem

    def update_state(self, state):
        # actual update_memory happens in the decoder once the step's
        # parent selection is known (decode() applies batch_gather)
        self._pending = state


class StateCell:
    """Hidden-state container + updater for RNN decoding (reference
    beam_search_decoder.py StateCell). States are declared as InitState
    objects; the ``state_updater`` callback computes the next state from
    the current states and step inputs each decode step."""

    def __init__(self, inputs, states, out_state, name=None):
        self._helper = LayerHelper("state_cell", name=name)
        self._cur_states = {}
        self._state_names = []
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError("state must be an InitState object")
            self._cur_states[state_name] = state
            self._state_names.append(state_name)
        self._inputs = inputs
        self._cur_decoder_obj = None
        self._in_decoder = False
        self._states_holder = {}
        self._switched_decoder = False
        self._state_updater = None
        self._out_state = out_state
        if self._out_state not in self._cur_states:
            raise ValueError("out_state must be one state in states")

    def _enter_decoder(self, decoder_obj):
        if self._in_decoder or self._cur_decoder_obj is not None:
            raise ValueError("StateCell has already entered a decoder.")
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj
        self._switched_decoder = False

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder:
            raise ValueError("StateCell not in decoder, invalid leave.")
        if self._cur_decoder_obj is not decoder_obj:
            raise ValueError("Inconsistent decoder object in StateCell.")
        self._in_decoder = False
        self._cur_decoder_obj = None
        self._switched_decoder = False

    def _switch_decoder(self):
        if not self._in_decoder:
            raise ValueError("StateCell must enter a decoder first.")
        if self._switched_decoder:
            raise ValueError("StateCell already done switching.")
        for state_name in self._state_names:
            if state_name not in self._states_holder:
                state = self._cur_states[state_name]
                if not isinstance(state, InitState):
                    raise ValueError(
                        f"state {state_name} should be an InitState object")
                self._states_holder[state_name] = {}
                if self._cur_decoder_obj.type == _DecoderType.TRAINING:
                    holder = _MemoryState(
                        state_name, self._cur_decoder_obj.dynamic_rnn, state)
                elif self._cur_decoder_obj.type == _DecoderType.BEAM_SEARCH:
                    holder = _BeamState(
                        state_name, self._cur_decoder_obj, state)
                else:
                    raise ValueError("Unknown decoder type")
                self._states_holder[state_name][
                    id(self._cur_decoder_obj)] = holder
            self._cur_states[state_name] = self._states_holder[state_name][
                id(self._cur_decoder_obj)].get_state()
        self._switched_decoder = True

    def get_state(self, state_name):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        if state_name not in self._cur_states:
            raise ValueError(f"Unknown state {state_name}")
        return self._cur_states[state_name]

    def get_input(self, input_name):
        if input_name not in self._inputs or self._inputs[input_name] is None:
            raise ValueError(f"Invalid input {input_name}.")
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        self._cur_states[state_name] = state_value

    def state_updater(self, updater):
        self._state_updater = updater

        def _decorator(state_cell):
            if state_cell is self:
                raise TypeError("Updater should only accept a StateCell "
                                "object as argument.")
            updater(state_cell)

        return _decorator

    def compute_state(self, inputs):
        """Feed the step inputs and run the updater (reference
        StateCell.compute_state)."""
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for input_name, input_value in inputs.items():
            if input_name not in self._inputs:
                raise ValueError(
                    f"Unknown input {input_name}: not a declared step input")
            self._inputs[input_name] = input_value
        self._state_updater(self)

    def update_states(self):
        """Record the new state values after a step (reference
        StateCell.update_states)."""
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for state_name, decoder_state in self._states_holder.items():
            if id(self._cur_decoder_obj) not in decoder_state:
                raise ValueError("Unknown decoder object; make sure "
                                 "switch_decoder has been invoked.")
            decoder_state[id(self._cur_decoder_obj)].update_state(
                self._cur_states[state_name])

    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder:
    """Teacher-forced decoder (reference beam_search_decoder.py
    TrainingDecoder): wraps a DynamicRNN; the user's block reads step
    inputs, computes the cell, and declares outputs."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._helper = LayerHelper("training_decoder", name=name)
        self._status = TrainingDecoder.BEFORE_DECODER
        self._dynamic_rnn = layers.DynamicRNN()
        self._type = _DecoderType.TRAINING
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)

    @contextlib.contextmanager
    def block(self):
        if self._status != TrainingDecoder.BEFORE_DECODER:
            raise ValueError("decoder.block() can only be invoked once")
        self._status = TrainingDecoder.IN_DECODER
        with self._dynamic_rnn.block():
            yield
        self._status = TrainingDecoder.AFTER_DECODER
        self._state_cell._leave_decoder(self)

    @property
    def state_cell(self):
        self._assert_in_decoder_block("state_cell")
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @property
    def type(self):
        return self._type

    def step_input(self, x):
        self._assert_in_decoder_block("step_input")
        return self._dynamic_rnn.step_input(x)

    def static_input(self, x):
        self._assert_in_decoder_block("static_input")
        return self._dynamic_rnn.static_input(x)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError("Output of training decoder can only be "
                             "visited outside the block.")
        return self._dynamic_rnn(*args, **kwargs)

    def output(self, *outputs):
        self._assert_in_decoder_block("output")
        self._dynamic_rnn.output(*outputs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError(f"{method} should be invoked inside block of "
                             "TrainingDecoder object.")


class BeamSearchDecoder:
    """Generation-mode decoder with beam search (reference
    beam_search_decoder.py BeamSearchDecoder).

    Static-beam redesign: a bounded StaticRNN of ``max_len`` steps carries
    ``[batch, beam]`` ids/scores/finished plus the cell states tiled to
    ``[batch*beam, ...]``; each step embeds the previous ids, runs the
    user's state updater, projects the out-state to vocab log-probs, and
    applies ``beam_search_step`` + parent-gather instead of the
    reference's LoD ``beam_search`` op + shrinking While loop.
    ``topk_size`` is accepted for API parity and not applied:
    ``beam_search_step`` ranks the full vocabulary, as in the JAX package.
    """

    BEFORE_BEAM_SEARCH_DECODER = 0
    IN_BEAM_SEARCH_DECODER = 1
    AFTER_BEAM_SEARCH_DECODER = 2

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50, sparse_emb=True,
                 max_len=100, beam_size=1, end_id=1, name=None):
        self._helper = LayerHelper("beam_search_decoder", name=name)
        self._type = _DecoderType.BEAM_SEARCH
        self._status = BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._word_dim = word_dim
        self._input_var_dict = input_var_dict or {}
        self._rnn = layers.StaticRNN(name=(name or "bsd") + "_rnn",
                                     num_steps=max_len)
        self._ids_mem = None
        self._scores_mem = None
        self._fin_mem = None
        self._step_results = None
        self._final = None

    @contextlib.contextmanager
    def block(self):
        """One decode step (the StaticRNN step body)."""
        if self._status != BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER:
            raise ValueError("block() can only be invoked once.")
        self._status = BeamSearchDecoder.IN_BEAM_SEARCH_DECODER
        with self._rnn.step():
            yield
        self._status = BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER
        self._state_cell._leave_decoder(self)

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        self._assert_in_decoder_block("state_cell")
        return self._state_cell

    def early_stop(self):
        """API parity no-op: finished beams are masked inside
        beam_search_step (they accumulate nothing and re-emit end_id), so
        a fully-finished batch coasts through the remaining bounded steps
        with unchanged results instead of breaking the loop."""

    def _init_beam_memories(self):
        """ids/scores/finished memories, [batch, beam]."""
        K = self._beam_size
        with _in_parent_block(self._rnn):
            ids0 = layers.cast(
                layers.reshape(tile_beam(
                    layers.reshape(self._init_ids, shape=[-1, 1]), K),
                    shape=[-1, K]), "int32")
            import numpy as np
            # only beam 0 live at step 0, else all beams duplicate the
            # same hypothesis K times
            first_active = layers.assign(
                np.array([0.0] + [-1e9] * (K - 1), np.float32))
            s0 = layers.reshape(tile_beam(
                layers.cast(layers.reshape(self._init_scores,
                                           shape=[-1, 1]), "float32"), K),
                shape=[-1, K])
            scores0 = layers.elementwise_add(s0, first_active, axis=-1)
            fin0 = layers.cast(layers.elementwise_mul(
                layers.cast(ids0, "float32"),
                layers.fill_constant(shape=[1], dtype="float32", value=0.0)),
                "bool")
        self._ids_mem = self._rnn.memory(init=ids0)
        self._scores_mem = self._rnn.memory(init=scores0)
        self._fin_mem = self._rnn.memory(init=fin0)

    def decode(self):
        """The standard decode loop (reference BeamSearchDecoder.decode)."""
        V, K, E = self._target_dict_dim, self._beam_size, self._word_dim
        with self.block():
            self._init_beam_memories()
            prev_ids = self._ids_mem                     # [B, K]
            prev_scores = self._scores_mem               # [B, K]
            flat_ids = layers.reshape(prev_ids, shape=[-1, 1])
            emb = layers.embedding(layers.cast(flat_ids, "int64"),
                                   size=[V, E], dtype="float32",
                                   is_sparse=self._sparse_emb)
            prev_ids_embedding = (layers.squeeze(emb, axes=[1])
                                  if len(emb.shape) == 3 else emb)

            feed_dict = {}
            for name, var in self._input_var_dict.items():
                if name not in self._state_cell._inputs:
                    raise ValueError(f"Variable {name} not found in "
                                     "StateCell!")
                # constant across steps and identical across a batch's
                # beams: tile once (static analog of per-step
                # sequence_expand by prev_scores)
                with _in_parent_block(self._rnn):
                    feed_dict[name] = tile_beam(var, K)
            for name in self._state_cell._inputs:
                if name not in feed_dict:
                    feed_dict[name] = prev_ids_embedding

            self._state_cell.compute_state(inputs=feed_dict)
            current_state = self._state_cell.out_state()   # [B*K, H]
            logits = layers.fc(input=current_state, size=V, act=None)
            logp = _log_softmax(logits)
            logp3 = layers.reshape(logp, shape=[-1, K, V])
            new_ids, parents, new_scores, new_fin = beam_search_step(
                logp3, prev_scores, self._fin_mem, beam_size=K,
                end_id=self._end_id)

            self._state_cell.update_states()
            for holders in self._state_cell._states_holder.values():
                st = holders[id(self)]
                if st._pending is None:
                    continue
                shp = [-1, K] + [int(d) for d in st._pending.shape[1:]]
                sel = batch_gather(
                    layers.reshape(st._pending, shape=shp), parents)
                flat = [-1] + [int(d) for d in st._pending.shape[1:]]
                self._rnn.update_memory(
                    st._state_mem, layers.reshape(sel, shape=flat))
                st._pending = None
            self._rnn.update_memory(self._ids_mem, new_ids)
            self._rnn.update_memory(self._scores_mem, new_scores)
            self._rnn.update_memory(self._fin_mem, new_fin)
            self._rnn.step_output(new_ids)
            self._rnn.step_output(parents)
            self._rnn.step_output(new_scores)

    def __call__(self):
        """Backtrack the recorded selections into ranked sequences:
        (translation_ids [B, beam, T], translation_scores [B, beam])."""
        if self._status != BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER:
            raise ValueError("Output of BeamSearchDecoder object can only "
                             "be visited outside the block.")
        ids_hist, parents_hist, scores_hist = self._rnn()
        final_scores = layers.squeeze(
            layers.slice(scores_hist, axes=[1], starts=[self._max_len - 1],
                         ends=[self._max_len]), axes=[1])
        return beam_backtrack(ids_hist, parents_hist, final_scores)

    def _assert_in_decoder_block(self, method):
        if self._status != BeamSearchDecoder.IN_BEAM_SEARCH_DECODER:
            raise ValueError(f"{method} should be invoked inside block of "
                             "BeamSearchDecoder object.")
