"""The port's parity table: every op of tests/test_op_autosweep.py's
SPECS that paddle_tpu_torch registers, run by both packages.

For each such op the one-op program is built with the JAX package as the
sweep's `_build_and_run` builds it: the op on its spec's inputs (lod
inputs with their `@SEQLEN` companions), then, unless the spec is
forward-only or names no grads, a cast of its first output to float32, a
`mean`, and `append_backward`. The port parses that program's JSON
(`Program.parse_from_string`), and both executors run it on the CPU on
the spec's feed. Every output and every input grad is compared. The
sweep module is loaded by path under a private name and not edited, so
an op ported later gets its case here with no new test code.

fp32 tolerance: 1e-4 relative, and 1e-6 absolute where a value lies
near 0. Named exceptions:
- `RANDOM_OPS` (`dropout`, `gaussian_random`, `uniform_random`,
  `truncated_gaussian_random`, `uniform_random_batch_size_like`, `nce`,
  `random_crop`): the two packages draw from different streams by design
  (ROADMAP Queue 3, expected differences), so the test compares what the
  draw must satisfy: the keep share and the kept values, or the bounds
  and the first two moments; `random_crop`'s output is a window of its
  input; `nce`'s `Cost` and `SampleLogits` are the JAX formula's on the
  port's own `SampleLabels`, whose true ids are the labels and whose
  negatives are uniform over [0, V) (`_check_nce`, in the AMP column
  too).
- `CANCELLING_GRADS`: the grads of mean(softmax), mean(sequence_softmax)
  and mean(batch_norm) cancel to about 0 (each row or channel of the
  output sums to a constant), so they are held to an absolute tolerance
  at float32's rounding of the terms that cancel.

The kink column runs every fp32 case but the random ones again with
its float inputs rounded to multiples of 0.5 inside their own range
(`on_lattice`), so exact zeros, bounds and ties reach the rules, where
uniform draws never land; an op whose kink sits at an attr off that
lattice gets the attr moved onto it (`KINK_ATTRS`). Outputs and grads
are compared as in the fp32 column, NaN equal to NaN. An op undefined on
such inputs is waived by name with its reason (`KINK_WAIVED`); a fault
of the port is repaired, never waived.

The AMP column runs every op of the sweep's AMP_OPS_IN_SPECS that the
port registers under `Executor(amp=True)`. The JAX side runs in one
subprocess with XLA_FLAGS=--xla_allow_excess_precision=false, set before
jax starts (this process's jax started long before), and writes its
programs and outputs to an .npz. The port holds bit for bit, except
where the policy's float32 set sums in another order or rounds exp, log
or log1p an ulp apart (`AMP_SUM_ORDER`, each op named with its reason).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.ir import seqlen_var_name

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.ops import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_PATH = os.path.join(REPO, "tests", "test_op_autosweep.py")


def _load_sweep():
    spec = importlib.util.spec_from_file_location("_op_autosweep_specs",
                                                  SWEEP_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sweep = _load_sweep()
PORTED = set(tregistry.registered_ops())
CASES = sorted(PORTED & set(sweep.SPECS))
AMP_CASES = [op for op in sweep.AMP_OPS_IN_SPECS if op in PORTED]

RANDOM_OPS = {"dropout", "gaussian_random", "uniform_random",
              "truncated_gaussian_random", "uniform_random_batch_size_like",
              "nce", "random_crop"}
# op -> absolute tolerance on its input grads
CANCELLING_GRADS = {"softmax": 1e-7, "sequence_softmax": 1e-7,
                    "batch_norm": 1e-7}
# ops the port registers that the sweep waives, each with the port test
# that holds it against the JAX package (the file names the op; the
# prefill ops and `gather_last_token` run inside `models/tiny_lm.py`'s
# programs, which the serving tests generate from against the JAX engine)
WAIVED_PORT_TESTS = {
    "while": "test_torch_control.py",
    "bounded_while": "test_torch_control.py",
    "static_rnn": "test_torch_control.py",
    "dynamic_rnn": "test_torch_control.py",
    "conditional_block": "test_torch_control.py",
    "if_else": "test_torch_control.py",
    "select_input": "test_torch_control.py",
    "array_write": "test_torch_control.py",
    "array_read": "test_torch_control.py",
    "array_length": "test_torch_control.py",
    "array_to_lod_tensor": "test_torch_control.py",
    "lod_tensor_to_array": "test_torch_control.py",
    "lod_rank_table": "test_torch_control.py",
    "max_sequence_len": "test_torch_control.py",
    "shrink_memory": "test_torch_control.py",
    "reorder_lod_tensor_by_rank": "test_torch_control.py",
    "beam_search_step": "test_torch_control.py",
    "beam_backtrack": "test_torch_control.py",
    "tile_beam": "test_torch_control.py",
    "print": "test_torch_control.py",
    "fused_attention": "test_torch_train.py",
    "paged_attention": "test_torch_kernels.py",
    "prefill_attention": "test_torch_serve.py",
    "paged_attention_q8": "test_torch_kv8.py",
    "prefill_attention_q8": "test_torch_kv8.py",
    "gather_last_token": "test_torch_serve.py",
    "sequence_slice": "test_torch_seq.py",
    "sequence_erase": "test_torch_seq.py",
    "load": "test_torch_data.py",
    "auc": "test_torch_breadth.py",
    "prior_box": "test_torch_detection.py",
    "anchor_generator": "test_torch_detection.py",
    "box_coder": "test_torch_detection.py",
    "bipartite_match": "test_torch_detection.py",
    "target_assign": "test_torch_detection.py",
    "multiclass_nms": "test_torch_detection.py",
    "mine_hard_examples": "test_torch_detection.py",
    "polygon_box_transform": "test_torch_detection.py",
    "rpn_target_assign": "test_torch_detection.py",
    "detection_map": "test_torch_detection.py",
}
# The AMP column's float32 results that are not bit for bit, op ->
# tolerance relative to the tensor's largest magnitude. Every bf16 output
# and grad is bit for bit (`mul`, `matmul`, `conv2d`, `lstm`, `gru`), and
# so are `cross_entropy` and `square_error_cost`. What is left runs in
# float32 under the policy's float32 set, where a sum is taken in another
# order than XLA's, or XLA's exp / log / log1p rounds an ulp from torch's:
AMP_SUM_ORDER = {
    # a float32 sum over all its values; also every case's `sweep_loss`
    "mean": 2e-6,
    # row sums of X * Y and of the squares, in the grads
    "cos_sim": 4e-7,
    # the alpha recursion's logsumexp over the tags, and its grad
    "linear_chain_crf": 4e-7,
    # the row's sum of exp, and exp / log
    "log_softmax": 4e-7,
    # exp and log1p: one element of twelve an ulp apart
    "sigmoid_cross_entropy_with_logits": 2e-7,
    # the row's sum of exp in the grad
    "softmax_with_cross_entropy": 2e-7,
    # a float32 mean over two dims, summed in torch's order: one element
    # of three 7.5e-9 from XLA's
    "reduce_mean": 1e-7,
    # each path node's dot product over the input's width, the sum over
    # the path, and XLA's log1p / exp in softplus: one element of four
    # an ulp apart
    "hierarchical_sigmoid": 2e-7,
    # log_softmax's row sums, and the grad back through the logaddexp
    # chain over the frames: most elements of the Logits grad an ulp or
    # two apart
    "warpctc": 4e-7,
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_float(a):
    return a.dtype.kind == "f"


def one_op_program(op_type, spec):
    """The sweep's `_build_and_run` program for `op_type` (forward, then
    cast, mean and append_backward unless forward-only); returns (main
    program, feed, fetch names, grad fetch names)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        block = main.global_block()
        helper = fluid.layers.nn.LayerHelper(op_type)
        feed, input_names, grad_targets = {}, {}, []
        for slot, vals in spec.inputs.items():
            vlist = vals if isinstance(vals, list) else [vals]
            names = []
            for k, v in enumerate(vlist):
                name = f"in_{slot}_{k}"
                lod_lens = spec.lod.get(slot)
                if isinstance(lod_lens, list):
                    lod_lens = lod_lens[k]
                block.create_var(name=name, shape=tuple(v.shape),
                                 dtype=str(v.dtype), is_data=True,
                                 lod_level=1 if lod_lens is not None else 0,
                                 stop_gradient=not _is_float(v))
                if lod_lens is not None:
                    block.create_var(name=seqlen_var_name(name),
                                     shape=(-1,), dtype="int32",
                                     stop_gradient=True)
                    feed[name] = (v, lod_lens)
                else:
                    feed[name] = v
                names.append(name)
                if _is_float(v) and (spec.grad is None or slot in spec.grad):
                    grad_targets.append(name)
            input_names[slot] = names
        out_names = {}
        for slot in spec.outs:
            ov = block.create_var(name=f"out_{slot}", shape=(),
                                  dtype="float32")
            out_names[slot] = [ov.name]
        op_inputs = dict(input_names)
        opdef = sweep.registry.get_op_def(op_type)
        if "SeqLen" in opdef.input_slots and spec.lod:
            lod_slot = next(iter(spec.lod))
            op_inputs["SeqLen"] = [seqlen_var_name(n)
                                   for n in input_names[lod_slot]]
        helper.append_op(op_type, inputs=op_inputs, outputs=out_names,
                         attrs=dict(spec.attrs))
        fetch = [f"out_{s}" for s in spec.outs]
        grads = []
        if not (spec.fwd_only or not grad_targets or spec.grad == []):
            primary = block.vars[f"out_{spec.outs[0]}"]
            loss_v = block.create_var(name="sweep_loss", shape=(),
                                      dtype="float32")
            f32 = block.create_var(name="out_f32", shape=(),
                                   dtype="float32")
            helper.append_op("cast", inputs={"X": [primary.name]},
                             outputs={"Out": [f32.name]},
                             attrs={"out_dtype": "float32"})
            helper.append_op("mean", inputs={"X": [f32.name]},
                             outputs={"Out": [loss_v.name]})
            fluid.append_backward(loss_v)
            grads = [n + "@GRAD" for n in grad_targets]
            fetch += ["sweep_loss"] + grads
    return main, feed, fetch, grads


def _run_port(program_json, feed, fetch, amp=False):
    native.reset_launches()
    out = ptt.Executor(ptt.CPUPlace(), amp=amp).run(
        ptt.Program.parse_from_string(program_json), feed=feed,
        fetch_list=fetch, scope=ptt.Scope())
    assert not any(native.launches.values())
    return [np.asarray(o) for o in out]


def _check_nce(spec, amp=False):
    """The port's `nce` on the spec's inputs, with every output fetched:
    `Cost` and `SampleLogits` equal the JAX rule's formula evaluated on
    the port's own `SampleLabels`, whose first columns are the labels
    and whose negatives lie in [0, V); then the rule alone on a large
    batch draws each class about equally often."""
    import copy
    import jax
    import jax.numpy as jnp
    full = copy.copy(spec)
    full.outs = ["Cost", "SampleLogits", "SampleLabels"]
    full.grad = []
    main, feed, fetch, _ = one_op_program("nce", full)
    cost, logits, labels = _run_port(main.serialize_to_string(), feed,
                                     fetch, amp=amp)
    V = spec.attrs["num_total_classes"]
    x, w = spec.inputs["Input"], spec.inputs["Weight"]
    lab = spec.inputs["Label"].reshape(len(x), -1)
    np.testing.assert_array_equal(labels[:, :lab.shape[1]], lab)
    assert labels.min() >= 0 and labels.max() < V
    ids = jnp.asarray(labels.astype(np.int32))
    want_logits = jnp.einsum("bd,bkd->bk", x, jnp.take(w, ids, axis=0))
    shift = np.log(spec.attrs["num_neg_samples"]) + np.log(1.0 / V)
    t = lab.shape[1]
    want_cost = (jnp.sum(jax.nn.softplus(-(want_logits[:, :t] - shift)), 1)
                 + jnp.sum(jax.nn.softplus(want_logits[:, t:] - shift), 1))
    np.testing.assert_allclose(logits, np.asarray(want_logits), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cost[:, 0], np.asarray(want_cost), rtol=1e-5,
                               atol=1e-6)
    # uniform negatives: 4096 x 8 draws over V classes, each count
    # within 5 standard deviations of its mean
    rule = tregistry.get_op_def("nce").lower
    ctx = tregistry.LoweringContext({"num_total_classes": V,
                                     "num_neg_samples": 8}, "cpu", seed=11)
    drawn = rule(ctx, torch.zeros(4096, 2), torch.zeros(4096, 1,
                                                        dtype=torch.long),
                 torch.zeros(V, 2))["SampleLabels"][:, 1:]
    counts = np.bincount(drawn.numpy().reshape(-1), minlength=V)
    n, p = drawn.numel(), 1.0 / V
    assert len(counts) == V
    assert np.abs(counts - n * p).max() <= 5 * np.sqrt(n * p * (1 - p)), \
        counts


def _check_random(op_type, spec, ref, got):
    """What a draw must satisfy, on both sides alike."""
    if op_type == "nce":
        _check_nce(spec)
        return
    if op_type == "random_crop":
        x, out = spec.inputs["X"], got[0]
        assert out.shape == ref[0].shape and out.dtype == ref[0].dtype
        h, w = out.shape[-2:]
        assert any(np.array_equal(out, x[..., i:i + h, j:j + w])
                   for i in range(x.shape[-2] - h + 1)
                   for j in range(x.shape[-1] - w + 1))
        return
    if op_type == "dropout":
        keep = [float((o != 0).mean()) for o in (ref[0], got[0])]
        rate = spec.attrs["dropout_prob"]
        assert all(abs(k - (1 - rate)) < 0.05 for k in keep), keep
        assert set(np.unique(got[0][got[0] != 0])) == \
            set(np.unique(ref[0][ref[0] != 0]))
        return
    a, b = ref[0], got[0]
    assert a.shape == b.shape and a.dtype == b.dtype
    if op_type in ("uniform_random", "uniform_random_batch_size_like"):
        lo, hi = spec.attrs["min"], spec.attrs["max"]
        assert lo <= b.min() and b.max() <= hi
        assert abs(b.mean() - a.mean()) < 0.15
        assert abs(b.std() - (hi - lo) / 12 ** 0.5) < 0.1
    elif op_type == "truncated_gaussian_random":
        # the standard normal truncated to [-2, 2]: std 0.880 of `std`
        mean, std = spec.attrs["mean"], spec.attrs["std"]
        assert mean - 2 * std <= b.min() and b.max() <= mean + 2 * std
        assert abs(b.mean() - mean) < 0.1 * std
        assert abs(b.std() - 0.880 * std) < 0.05 * std
        assert abs(b.std() - a.std()) < 0.05 * std
    else:
        assert abs(b.mean() - spec.attrs["mean"]) < 0.15
        assert abs(b.std() - spec.attrs["std"]) < 0.1
        assert abs(b.std() - a.std()) < 0.1


def _compare(op_type, fetch, grads, ref, got, equal_nan=False):
    for name, r, g in zip(fetch, ref, got):
        assert r.shape == g.shape, name
        if not _is_float(r):
            np.testing.assert_array_equal(g, r, err_msg=name)
            continue
        if name in grads and op_type in CANCELLING_GRADS:
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=CANCELLING_GRADS[op_type],
                                       equal_nan=equal_nan, err_msg=name)
            continue
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6,
                                   equal_nan=equal_nan, err_msg=name)


@pytest.mark.parametrize("op_type", CASES)
def test_op_matches_paddle_tpu_fp32(op_type):
    spec = sweep.SPECS[op_type]
    main, feed, fetch, grads = one_op_program(op_type, spec)
    ref = [np.asarray(r) for r in fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=fluid.Scope())]
    got = _run_port(main.serialize_to_string(), feed, fetch)
    if op_type in RANDOM_OPS:
        _check_random(op_type, spec, ref, got)
        return
    _compare(op_type, fetch, grads, ref, got)


# ---------------------------------------------------------------------------
# the kink column: the fp32 cases on inputs that sit on kinks and ties
# ---------------------------------------------------------------------------

# Attrs moved onto the lattice of the rounded inputs, for the ops whose
# kink sits at an attr the spec puts off it (the spec's own bounds lie
# between multiples of 0.5, or outside the input's range):
KINK_ATTRS = {
    "clip": lambda ins: {"min": -0.5, "max": 0.5},
    # max_norm = the rounded input's norm, so the scale is exactly 1 (the
    # squares of multiples of 0.5 sum exactly in float32, so every side
    # computes the same norm)
    "clip_by_norm": lambda ins: {"max_norm": float(np.sqrt(np.sum(
        ins["X"] * ins["X"], dtype=np.float32)))},
    "relu6": lambda ins: {"threshold": 2.0},
    "hard_sigmoid": lambda ins: {"slope": 1.0, "offset": 0.5},
    "soft_relu": lambda ins: {"threshold": 0.5},
    "margin_rank_loss": lambda ins: {"margin": 0.5},
}
# ops whose value or grad is undefined on such inputs, each with its
# reason (none so far: every fp32 case is defined on the lattice)
KINK_WAIVED = {}
KINK_CASES = [op for op in CASES
              if op not in RANDOM_OPS and op not in KINK_WAIVED]


def on_lattice(v):
    """A float input rounded to multiples of 0.5, kept inside its own
    range [min, max] (a value whose nearest multiple lies outside goes to
    the nearest one inside; an input whose range holds no multiple stays
    as it is). That puts exact zeros, bounds and ties on the inputs."""
    if not _is_float(v) or v.size == 0:
        return v
    lo, hi = np.ceil(v.min() * 2) / 2, np.floor(v.max() * 2) / 2
    if lo > hi:
        return v
    return np.clip(np.round(v * 2) / 2, lo, hi).astype(v.dtype)


def kink_spec(op_type):
    import copy
    spec = copy.copy(sweep.SPECS[op_type])
    spec.inputs = {slot: ([on_lattice(x) for x in v] if isinstance(v, list)
                          else on_lattice(v))
                   for slot, v in spec.inputs.items()}
    if op_type in KINK_ATTRS:
        spec.attrs = dict(spec.attrs, **KINK_ATTRS[op_type](spec.inputs))
    return spec


@pytest.mark.parametrize("op_type", KINK_CASES)
def test_op_matches_paddle_tpu_on_kinks_and_ties(op_type):
    """The fp32 case once more with every float input on the 0.5 lattice:
    outputs and grads at the fp32 tolerance, NaN where the JAX package
    has NaN."""
    spec = kink_spec(op_type)
    main, feed, fetch, grads = one_op_program(op_type, spec)
    ref = [np.asarray(r) for r in fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=fluid.Scope())]
    got = _run_port(main.serialize_to_string(), feed, fetch)
    _compare(op_type, fetch, grads, ref, got, equal_nan=True)


def test_kink_column_reaches_the_kinks():
    """The lattice puts the repaired ops' inputs on their kinks: exact
    zero logits, values at clip's bounds, a norm at max_norm."""
    x = kink_spec("sigmoid_cross_entropy_with_logits").inputs["X"]
    assert (x == 0).any()
    c = kink_spec("clip")
    assert (np.abs(c.inputs["X"]) == c.attrs["max"]).any()
    n = kink_spec("clip_by_norm")
    assert np.float32(np.sqrt(np.sum(n.inputs["X"] ** 2))) == \
        np.float32(n.attrs["max_norm"])
    assert set(KINK_CASES) == set(CASES) - RANDOM_OPS


def test_table_covers_every_port_op():
    """Every op the port registers is a case of the table, or a waiver of
    the sweep that a port test covers (the file names the op)."""
    assert len(CASES) >= 185
    waived = PORTED - set(sweep.SPECS)
    assert waived <= set(sweep.WAIVED)
    assert waived == set(WAIVED_PORT_TESTS)
    tiny_lm = open(os.path.join(REPO, "paddle_tpu_torch", "models",
                                "tiny_lm.py")).read()
    for op, fname in WAIVED_PORT_TESTS.items():
        text = open(os.path.join(REPO, "tests", fname)).read()
        if op in ("prefill_attention", "prefill_attention_q8",
                  "gather_last_token"):
            # the int8 op types are the fp32 ones + "_q8" (tiny_lm.py)
            assert op.removesuffix("_q8") in tiny_lm \
                and "tiny_lm" in text, (op, fname)
        else:
            assert op in text, (op, fname)
    assert set(AMP_CASES) == set(sweep.AMP_OPS_IN_SPECS) & PORTED
    assert {"cos_sim", "linear_chain_crf", "crf_decoding"} <= set(CASES)
    assert {"nce", "hierarchical_sigmoid", "warpctc"} <= set(AMP_CASES)


# ---------------------------------------------------------------------------
# the AMP column
# ---------------------------------------------------------------------------

_AMP_SCRIPT = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import jax
jax.config.update("jax_platforms", "cpu")
import test_torch_parity_table as table
import paddle_tpu as fluid
out = {}
for op_type in table.AMP_CASES:
    spec = table.sweep.SPECS[op_type]
    main, feed, fetch, grads = table.one_op_program(op_type, spec)
    res = fluid.Executor(fluid.CPUPlace(), amp=True).run(
        main, feed=feed, fetch_list=fetch, scope=fluid.Scope())
    out[op_type + "/program"] = np.array(main.serialize_to_string())
    out[op_type + "/fetch"] = np.array(json.dumps(fetch))
    for i, r in enumerate(res):
        r = np.asarray(r)
        if r.dtype.name == "bfloat16":
            r = r.astype(np.float32)
        out[f"{op_type}/out{i}"] = r
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_amp_outputs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("amp") / "jax_amp.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _AMP_SCRIPT, REPO, path],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("op_type", AMP_CASES)
def test_op_matches_paddle_tpu_amp_bit_for_bit(op_type, jax_amp_outputs):
    spec = sweep.SPECS[op_type]
    if op_type == "nce":        # random: what its draw must satisfy
        _check_nce(spec, amp=True)
        return
    _, feed, fetch, _ = one_op_program(op_type, spec)
    assert json.loads(str(jax_amp_outputs[op_type + "/fetch"])) == fetch
    got = _run_port(str(jax_amp_outputs[op_type + "/program"]), feed,
                    fetch, amp=True)
    for i, (name, g) in enumerate(zip(fetch, got)):
        r = jax_amp_outputs[f"{op_type}/out{i}"]
        assert r.shape == g.shape, name
        if name == "sweep_loss" or op_type in AMP_SUM_ORDER:
            tol = AMP_SUM_ORDER["mean" if name == "sweep_loss" else op_type]
            scale = max(float(np.abs(r).max()), 1e-30)
            err = float(np.abs(g.astype(np.float64) - r).max()) / scale
            assert err <= tol, (name, err, tol)
        else:
            np.testing.assert_array_equal(g, r.astype(g.dtype)
                                          if not _is_float(r) else r,
                                          err_msg=name)
