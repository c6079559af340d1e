"""paddle_tpu_torch.hapi.Model's fit / evaluate / predict / save / load /
summary and its callbacks, held against paddle_tpu.hapi on the CPU: on
the same dataset and carried weights, the history, metrics and
predictions are the JAX package's (1e-5); `fit` with `use_jit=True`
equals `fit` without it (1e-5); `save` -> `load` -> one more
`train_batch` is bitwise the model that was not reloaded; a fit killed by
the chaos harness resumes at the JAX package's epoch and ends bitwise on
a straight run's weights; `summary` prints the JAX table.  Mirrors the
fit / callbacks / summary cases of tests/test_hapi_models.py."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.program import _reset_unique_names as jreset
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.metric import Accuracy as JAccuracy

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.core.program import _reset_unique_names as treset
from paddle_tpu_torch.dygraph import guard
from paddle_tpu_torch.hapi.callbacks import Callback as TCallback
from paddle_tpu_torch.hapi.callbacks import EarlyStopping, ModelCheckpoint
from paddle_tpu_torch.io import TensorDataset as TTensorDataset
from paddle_tpu_torch.metric import Accuracy as TAccuracy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with guard(CPUPlace()):
        torch.set_num_threads(2)
        yield


def mlp(nn):
    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.act = nn.ReLU()
            self.fc2 = nn.Linear(16, 3)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))
    return MLP()


def toy(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 8).astype(np.float32)
    y = (x[:, :3].argmax(1)).astype(np.int64)[:, None]
    return x, y


class Recorder:
    """The events a callback sees, with the loss of each batch."""

    def __init__(self, base):
        rec = self
        self.events = []

        class R(base):
            def on_epoch_begin(self, epoch, logs=None):
                rec.events.append(("epoch", epoch))

            def on_train_batch_end(self, step, logs=None):
                rec.events.append(("batch", step,
                                   float(np.asarray(logs["loss"]))))

            def on_eval_end(self, logs=None):
                rec.events.append(("eval", sorted(logs)))
        self.cb = R()


def pair(jit=False, metrics=True):
    x, y = toy()
    jreset()
    jnet = mlp(jnn)
    jm = paddle_tpu.Model(jnet)
    jm.prepare(jopt.Adam(learning_rate=0.05, parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(), JAccuracy() if metrics else None)
    treset()
    tnet = mlp(tnn)
    tnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})
    tm = pt.Model(tnet)
    tm.prepare(topt.Adam(learning_rate=0.05, parameters=tnet.parameters()),
               tnn.CrossEntropyLoss(), TAccuracy() if metrics else None,
               use_jit=jit)
    return jm, tm, (x, y)


def test_fit_evaluate_predict_equal_the_jax_packages():
    jm, tm, (x, y) = pair()
    jrec, trec = Recorder(JCallback), Recorder(TCallback)
    jh = jm.fit(JTensorDataset([x, y]), eval_data=JTensorDataset([x, y]),
                batch_size=16, epochs=4, shuffle=False, verbose=0,
                callbacks=[jrec.cb])
    th = tm.fit(TTensorDataset([x, y]), eval_data=TTensorDataset([x, y]),
                batch_size=16, epochs=4, shuffle=False, verbose=0,
                callbacks=[trec.cb])
    assert len(th) == len(jh) == 4
    for t, j in zip(th, jh):
        assert sorted(t) == sorted(j) == ["acc", "loss"]
        for k in t:
            np.testing.assert_allclose(t[k], j[k], **TOL, err_msg=k)
    assert th[-1]["loss"] < th[0]["loss"]
    assert [e[:2] for e in trec.events] == [e[:2] for e in jrec.events]
    np.testing.assert_allclose([e[2] for e in trec.events if len(e) == 3],
                               [e[2] for e in jrec.events if len(e) == 3],
                               **TOL)
    tl = tm.evaluate(TTensorDataset([x, y]), batch_size=16, verbose=0)
    jl = jm.evaluate(JTensorDataset([x, y]), batch_size=16, verbose=0)
    assert sorted(tl) == sorted(jl)
    for k in tl:
        np.testing.assert_allclose(tl[k], jl[k], **TOL, err_msg=k)
    tp = tm.predict(TTensorDataset([x]), batch_size=16, stack_outputs=True)
    jp = jm.predict(JTensorDataset([x]), batch_size=16, stack_outputs=True)
    assert tp[0].shape == (64, 3)
    np.testing.assert_allclose(tp[0], jp[0], **TOL)
    per_batch = tm.predict(TTensorDataset([x]), batch_size=16)
    assert len(per_batch[0]) == 4


def test_fit_with_use_jit_equals_fit_without_it():
    _, eager, (x, y) = pair(jit=False)
    _, jitted, _ = pair(jit=True)
    jitted.network.set_state_dict(eager.network.state_dict())
    he = eager.fit(TTensorDataset([x, y]), batch_size=16, epochs=3,
                   shuffle=False, verbose=0)
    hj = jitted.fit(TTensorDataset([x, y]), batch_size=16, epochs=3,
                    shuffle=False, verbose=0)
    for a, b in zip(hj, he):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)
    for (k, a), b in zip(jitted.network.state_dict().items(),
                         eager.network.state_dict().values()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **TOL, err_msg=k)
    fn = jitted._jit_fns[1]
    assert len(fn._cache) == 1
    types = [op.type for op in next(iter(fn._cache.values())).program
             .global_block().ops]
    assert types[:3] == ["matmul_v2", "elementwise_add", "relu"]
    assert "softmax_with_cross_entropy" in types


def test_save_load_then_train_batch_is_bitwise(tmp_path):
    _, tm, (x, y) = pair(metrics=False)
    tm.fit(TTensorDataset([x, y]), batch_size=16, epochs=1, shuffle=False,
           verbose=0)
    path = str(tmp_path / "ckpt" / "model")
    tm.save(path)
    assert os.path.exists(path + ".pdparams") and \
        os.path.exists(path + ".pdopt")
    _, fresh, _ = pair(metrics=False)
    fresh.load(path)
    a = tm.train_batch([x[:16]], [y[:16]])
    b = fresh.train_batch([x[:16]], [y[:16]])
    assert a == b
    for (k, p), q in zip(tm.network.state_dict().items(),
                         fresh.network.state_dict().values()):
        assert torch.equal(p, q), k


def test_model_files_cross_load_between_packages(tmp_path):
    jm, tm, (x, y) = pair(metrics=False)
    jm.fit(JTensorDataset([x, y]), batch_size=16, epochs=1, shuffle=False,
           verbose=0)
    path = str(tmp_path / "jax_model")
    jm.save(path)
    tm.load(path)
    for (k, a), b in zip(tm.network.state_dict().items(),
                         jm.network.state_dict().values()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      np.asarray(b.numpy()), err_msg=k)
    np.testing.assert_allclose(tm.train_batch([x[:16]], [y[:16]])[0],
                               jm.train_batch([x[:16]], [y[:16]])[0], **TOL)
    tpath = str(tmp_path / "port_model")
    tm.save(tpath)
    jm.load(tpath)
    for (k, a), b in zip(tm.network.state_dict().items(),
                         jm.network.state_dict().values()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      np.asarray(b.numpy()), err_msg=k)


def test_callbacks_early_stopping_and_checkpoint(tmp_path):
    x, y = toy(32)
    treset()
    net = mlp(tnn)
    model = pt.Model(net)
    model.prepare(topt.SGD(learning_rate=0.0, parameters=net.parameters()),
                  tnn.CrossEntropyLoss())
    es = EarlyStopping(monitor="loss", patience=1, min_delta=1e-12)
    model.fit(TTensorDataset([x, y]), eval_data=TTensorDataset([x, y]),
              batch_size=16, epochs=10, verbose=0, callbacks=[es])
    assert model.stop_training  # lr=0: no improvement, stops early
    d = str(tmp_path / "ck")
    model.fit(TTensorDataset([x, y]), batch_size=16, epochs=2, verbose=1,
              callbacks=[ModelCheckpoint(save_freq=1, save_dir=d)])
    assert os.path.exists(os.path.join(d, "final.pdparams"))


@pytest.mark.parametrize("which", ["mlp", "lenet"])
def test_summary_prints_the_jax_table(which, capsys):
    if which == "mlp":
        jreset()
        jnet = mlp(jnn)
        treset()
        tnet = mlp(tnn)
    else:
        from paddle_tpu.vision.models import LeNet as JLeNet
        from paddle_tpu_torch.vision.models import LeNet as TLeNet
        jreset()
        jnet = JLeNet()
        treset()
        tnet = TLeNet()
    ji = paddle_tpu.Model(jnet).summary()
    jout = capsys.readouterr().out
    ti = pt.Model(tnet).summary()
    tout = capsys.readouterr().out
    assert ti == ji
    assert tout == jout
    if which == "mlp":
        assert ti["total_params"] == 8 * 16 + 16 + 16 * 3 + 3
    assert pt.summary(tnet) == ji
    assert pt.hapi.Input([None, 8], "float32", "x").shape == (None, 8)


_PROG = r"""
import json, sys
import numpy as np
sys.path.insert(0, {repo!r})
pkg, mode, d = sys.argv[1], sys.argv[2], sys.argv[3]
if pkg == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as paddle
    from paddle_tpu.core.program import _reset_unique_names
    guard = None
else:
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.program import _reset_unique_names
    from paddle_tpu_torch.dygraph import guard
    _cpu = guard(paddle.CPUPlace())
    _cpu.__enter__()

class DS(paddle.io.Dataset):
    def __init__(self, n=16):
        rng = np.random.RandomState(0)
        self.x = rng.rand(n, 4).astype(np.float32)
        self.y = self.x.sum(1, keepdims=True).astype(np.float32)
    def __len__(self):
        return len(self.x)
    def __getitem__(self, i):
        return self.x[i], self.y[i]

_reset_unique_names()
paddle.seed(0)
net = paddle.nn.Linear(4, 1)
w0 = {{"weight": np.full((4, 1), 0.5, np.float32),
       "bias": np.zeros((1,), np.float32)}}
net.set_state_dict(w0)
m = paddle.Model(net)
m.prepare(optimizer=paddle.optimizer.Adam(
    learning_rate=0.01, parameters=net.parameters()),
    loss=paddle.nn.MSELoss())
kw = dict(batch_size=4, epochs=4, shuffle=False, verbose=0)
if mode == "crash":
    m.fit(DS(), save_dir=d, save_freq=10, **kw)
elif mode == "resume":
    m.fit(DS(), save_dir=d, save_freq=10, resume=True, **kw)
else:
    m.fit(DS(), **kw)
w = {{k: np.asarray(v.detach().numpy() if hasattr(v, "detach")
                    else v.numpy()).tolist()
     for k, v in m.network.state_dict().items()}}
print("PARAMS=" + json.dumps(w))
"""


def _params(out):
    line = [ln for ln in out.splitlines() if ln.startswith("PARAMS=")][-1]
    return json.loads(line[len("PARAMS="):])


def test_fit_resumes_after_a_chaos_kill_at_the_jax_packages_epoch(tmp_path):
    """4 batches an epoch; the chaos harness SIGTERMs at batch 10 (mid
    epoch 2): the preemption handler commits epoch 1 (save_freq=10 never
    saved), in both packages; resume=True then ends bitwise on the
    weights of a straight run."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    prog = _PROG.format(repo=REPO)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PADDLE_TPU_CHAOS", None)
    crash_env = dict(env, PADDLE_TPU_CHAOS="kill@10:signal=term")
    epochs = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        p = subprocess.run([sys.executable, "-c", prog, pkg, "crash", d],
                           env=crash_env, capture_output=True, text=True,
                           timeout=240)
        assert p.returncode == 143, (pkg, p.returncode, p.stderr[-2000:])
        mgr = CheckpointManager(os.path.join(d, "checkpoints"))
        epochs[pkg] = (mgr.all_steps(), mgr.load().extra["epoch"])
        mgr.close()
    assert epochs["port"] == epochs["jax"] == ([1], 1)
    d = str(tmp_path / "port")
    runs = {}
    for mode in ("resume", "straight"):
        p = subprocess.run([sys.executable, "-c", prog, "port", mode, d],
                           env=env, capture_output=True, text=True,
                           timeout=240)
        assert p.returncode == 0, (mode, p.stderr[-2000:])
        runs[mode] = _params(p.stdout)
    assert runs["resume"] == runs["straight"]


def test_fit_refusals_and_options():
    _, tm, (x, y) = pair(metrics=False)
    with pytest.raises(ValueError, match="save_dir"):
        tm.fit(TTensorDataset([x, y]), resume=True)
    with pytest.raises(TypeError, match="Dataset or DataLoader"):
        tm.fit([1, 2, 3])
    h = tm.fit(pt.io.DataLoader(TTensorDataset([x, y]), batch_size=32,
                                num_workers=0), epochs=1, verbose=0)
    assert len(h) == 1 and np.isfinite(h[0]["loss"])
