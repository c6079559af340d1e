"""The BASELINE configs' training programs in the port against the JAX
package's tools (tools/bench_lenet.py, tools/bench_resnet.py,
tools/bench_transformer.py).

Program equality: `paddle_tpu_torch.models.build_lenet`,
`build_resnet50` and `build_transformer_big` build main and startup
programs equal to the tools' (`to_dict()` and `serialize_to_string()`),
with AMP on and off, from the same unique-name state: LeNet at its own
shape, ResNet-50 at full depth with img 32 and 16 classes, Transformer-big
at the tool's CPU widths (seq 32, vocab 512, d 128, 4 heads, 2 layers,
FFN 256).

Training against the JAX executor is in test_torch_baseline_train.py.
"""
import importlib.util
import os

import pytest

from paddle_tpu.core.program import _reset_unique_names as jax_reset_names
from paddle_tpu_torch import models
from paddle_tpu_torch.core.program import (_reset_unique_names as
                                           torch_reset_names)
from test_torch_vision_ops import contained_state  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_lenet = _tool("bench_lenet")
bench_resnet = _tool("bench_resnet")
bench_transformer = _tool("bench_transformer")

RESNET = dict(batch=4, img=32, classes=16)
TRANSFORMER = dict(src_len=32, trg_len=32, vocab=512, d_model=128, heads=4,
                   n_layers=2, d_inner=256)


def build_both(jax_fn, port_fn, **kw):
    jax_reset_names()
    ref = jax_fn(**kw)
    torch_reset_names()
    port = port_fn(**kw)
    return ref, port


BUILDERS = {
    "lenet": (bench_lenet.build_lenet, models.build_lenet, {}),
    "resnet50": (bench_resnet.build_resnet50, models.build_resnet50,
                 RESNET),
    "transformer_big": (bench_transformer.build_transformer_big,
                        models.build_transformer_big, TRANSFORMER),
}


# the ops these programs add to the port and their counts at full depth
# (ResNet-50: 53 convolutions and batch norms, 49 + 4 downsamples, and 49
# relus; Transformer-big: one one-hot and one label smoothing, on the
# label, so without gradient); every conv2d, pool2d, batch_norm and relu
# has its grad op
OP_COUNTS = {"lenet": {"conv2d": 2, "pool2d": 2, "relu": 4,
                       "batch_norm": 0},
             "resnet50": {"conv2d": 53, "batch_norm": 53, "relu": 49,
                          "pool2d": 2},
             "transformer_big": {"one_hot_v2": 1, "label_smooth": 1,
                                 "relu": 2 * TRANSFORMER["n_layers"]}}


@pytest.mark.parametrize("use_amp", [False, True])
@pytest.mark.parametrize("config", list(BUILDERS))
def test_program_serializes_equal_to_the_tool(config, use_amp):
    jax_fn, port_fn, kw = BUILDERS[config]
    (jm, js, jl), (tm, ts, tl) = build_both(jax_fn, port_fn,
                                            use_amp=use_amp, **kw)
    assert jl.name == tl.name
    types = [op.type for op in tm.global_block().ops]
    assert ("cast" in types) == (use_amp and config != "lenet")
    counts = OP_COUNTS[config]
    assert {t: types.count(t) for t in counts} == counts
    for t, n in counts.items():
        no_grad = t in ("one_hot_v2", "label_smooth")
        assert types.count(t + "_grad") == (0 if no_grad else n), t
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    assert tm._grad_map == jm._grad_map
