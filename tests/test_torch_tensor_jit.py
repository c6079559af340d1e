"""The paddle.tensor functions under `jit.to_static`, held against
paddle_tpu.jit on the CPU: a 2-layer, hidden-64 BERT-style encoder
(embeddings, two TransformerEncoderLayers, flash off as under any
recorder) with a masked-LM head written with the ported functions
(`unsqueeze`, `gather_nd`, `topk`, `logsumexp`, `stack`, `split`,
`cumsum`, `where`, `expand`, `tile`, `index_sample`, `argmax`, `equal`,
`cast`, `mean`) records a program whose `to_dict` equals the JAX
package's, and its outputs and parameter gradients agree (1e-5, fp32).
`Tensor.squeeze` / `unsqueeze` record as `squeeze2` / `unsqueeze2`, as
the JAX Tensor's methods do; `torch.sin(x)` and indexing keep raising
(tests/test_torch_jit.py)."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.tensor as J
from paddle_tpu import jit as jjit
from paddle_tpu.core.program import _reset_unique_names as jreset

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.tensor as T
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import _reset_unique_names as treset
from paddle_tpu_torch.dygraph import guard

from test_torch_program import flash_mode
from test_torch_gpt import jax_generator_restored  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, SEQ, HIDDEN, HEADS, LAYERS, BATCH = 50, 16, 64, 4, 2, 2
MASKED = 5


@pytest.fixture(autouse=True)
def _cpu():
    torch.set_num_threads(2)
    with guard(CPUPlace()), flash_mode(False):
        yield


def _pkg(which):
    return (paddle_tpu, jnn, J) if which == "jax" else (pt, tnn, T)


def encoder_with_head(which):
    paddle, nn, M = _pkg(which)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(VOCAB, HIDDEN)
            self.pos = nn.Embedding(SEQ, HIDDEN)
            self.norm = nn.LayerNorm(HIDDEN)
            self.layers = nn.LayerList([
                nn.TransformerEncoderLayer(HIDDEN, HEADS, 4 * HIDDEN,
                                           dropout=0.0, activation="gelu")
                for _ in range(LAYERS)])
            self.head = nn.Linear(HIDDEN, VOCAB)

        def forward(self, ids, pos, pad, where_at, labels):
            h = self.norm(M.add(self.word(ids), self.pos(pos)))
            # the padding mask [B, S] -> [B, 1, 1, S], additive
            am = M.scale(M.unsqueeze(pad, [1, 2]), 1e4, -1e4)
            for layer in self.layers:
                h = layer(h, am)
            rows = M.gather_nd(h, where_at)              # [N, H]
            logits = self.head(rows)                     # [N, V]
            lse = M.logsumexp(logits, 1)                 # [N]
            picked = M.squeeze(M.index_sample(
                logits, M.unsqueeze(labels, 1)), 1)
            loss = M.mean(M.subtract(lse, picked))
            top_v, top_i = M.topk(logits, 5)
            hit = M.cast(M.equal(M.argmax(logits, 1), labels), "float32")
            acc = M.mean(hit)
            st = M.stack([lse, M.cumsum(lse)], 1)         # [N, 2]
            a, b = M.split(st, 2, 1)
            best = M.where(M.greater_than(a, b), a, b)
            grid = M.tile(M.expand(M.unsqueeze(lse, 0), [2, MASKED]),
                          [1, 2])
            return loss, acc, top_v, top_i, best, grid

    return Net()


def _inputs():
    r = np.random.RandomState(0)
    ids = r.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int64)
    pos = np.tile(np.arange(SEQ, dtype=np.int64), (BATCH, 1))
    pad = np.ones((BATCH, SEQ), np.float32)
    pad[1, 12:] = 0.0
    where_at = np.array([[0, 1], [0, 7], [1, 3], [1, 9], [0, 15]], np.int64)
    labels = r.randint(0, VOCAB, (MASKED,)).astype(np.int64)
    return [ids, pos, pad, where_at, labels]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def test_encoder_head_records_the_jax_program_and_matches():
    jreset()
    jm = encoder_with_head("jax")
    treset()
    tm = encoder_with_head("port")
    tm.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    arrays = _inputs()
    jargs = [paddle_tpu.to_tensor(a) for a in arrays]
    targs = [pt.to_tensor(a) for a in arrays]
    jf = jjit.StaticFunction(jm.forward, layer=jm)
    tf = tjit.StaticFunction(tm.forward, layer=tm)
    jreset()
    jo = jf(*jargs)
    treset()
    to = tf(*targs)
    jcp = next(iter(jf._cache.values()))
    tcp = next(iter(tf._cache.values()))
    assert tcp.program.to_dict() == jcp.program.to_dict()
    types = {op.type for op in tcp.program.global_block().ops}
    for op in ("unsqueeze2", "gather_nd", "top_k_v2", "logsumexp", "stack",
               "split", "cumsum", "where", "expand_v2", "tile",
               "index_sample", "squeeze2", "arg_max"):
        assert op in types, op
    for a, b in zip(to, jo):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    # gradients through the replay (a second call replays the program)
    jo, to = jf(*jargs), tf(*targs)
    jo[0].backward()
    to[0].backward()
    tparams = dict(tm.named_parameters())
    n = 0
    for k, jp in jm.named_parameters():
        tp = tparams[k]
        assert tp.grad is not None, k
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad),
                                   **TOL, err_msg=k)
        n += 1
    assert n == len(tparams)
    assert len(tf._cache) == 1


@pytest.mark.parametrize("method", ["squeeze", "unsqueeze"])
def test_tensor_methods_record_as_the_jax_tensors(method):
    x = np.ones((2, 1, 3), np.float32)

    def jfn(v):
        out = v.squeeze(1) if method == "squeeze" else v.unsqueeze(0)
        return J.scale(out, 2.0)

    def tfn(v):
        out = v.squeeze(1) if method == "squeeze" else v.unsqueeze(0)
        return T.scale(out, 2.0)

    jf, tf = jjit.to_static(jfn), tjit.to_static(tfn)
    jt, tt = paddle_tpu.to_tensor(x), pt.to_tensor(x)
    jreset()
    jo = jf(jt)
    treset()
    to = tf(tt)
    jcp = next(iter(jf._cache.values()))
    tcp = next(iter(tf._cache.values()))
    assert tcp.program.to_dict() == jcp.program.to_dict()
    assert [op.type for op in tcp.program.global_block().ops][0] == \
        method + "2"
    np.testing.assert_array_equal(_np(to), _np(jo))


def test_dropout_op_is_differentiable_under_a_replay():
    """The `dropout` op's kernel runs ops.dropout.DropoutFn, so a recorded
    program's replay under torch autograd carries the gradient through
    it on the card too (the Philox kernel's output has no history of its
    own); on the CPU its gradient is the mask's, as the static grad op."""
    from paddle_tpu_torch.ops.registry import OpContext, run_kernel
    x = torch.ones(4, 8, requires_grad=True)
    out = run_kernel("dropout", {"X": x},
                     {"dropout_prob": 0.5, "seed": 3, "fix_seed": True,
                      "op_uid": 1,
                      "dropout_implementation": "upscale_in_train"},
                     OpContext(seed=0))
    assert "DropoutFn" in type(out["Out"].grad_fn).__name__
    out["Out"].sum().backward()
    torch.testing.assert_close(x.grad, out["Mask"].float() * 2.0)
