"""The port stands alone: no file of paddle_tpu_torch/, nor chip_smoke.py
or chip_diag.py, imports jax, jaxlib or paddle_tpu (an AST scan: a sys.modules check
cannot work, since the test interpreter imports jax at start), and its
entry points refuse to fall back to the CPU when no GPU is present."""
import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py", "chip_diag.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "paddle_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        bad += [m for m in mods if m.split(".")[0] in FORBIDDEN]
    return bad


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and os.path.exists(files[0])
    offenders = {os.path.relpath(p, ROOT): _forbidden_imports(p)
                 for p in files}
    assert {p: m for p, m in offenders.items() if m} == {}


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("import os\nfrom paddle_tpu.core import flags\n"
                 "import jax.numpy as jnp\nfrom . import paddle_tpu\n")
    assert _forbidden_imports(str(p)) == ["paddle_tpu.core", "jax.numpy"]


def test_entry_points_raise_without_gpu(tmp_path, monkeypatch):
    from paddle_tpu_torch.core.place import CPUPlace
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.inference.server import InferenceServer
    from paddle_tpu_torch.static import Executor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor()
    assert Executor(CPUPlace()).device == torch.device("cpu")
    # a model dir the CPU path can load, to show only the place differs
    from paddle_tpu_torch import static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [-1, 4])
        y = static.layers.fc(x, 2)
    exe = Executor(CPUPlace())
    with static.scope_guard(static.Scope()):
        exe.run(startup)
        from paddle_tpu_torch.io import save_inference_model
        save_inference_model(str(tmp_path), ["x"], [y], exe, main)
    cfg = Config(str(tmp_path))
    assert cfg.use_gpu()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_predictor(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(str(tmp_path))
    cfg.disable_gpu()
    (out,) = create_predictor(cfg).run([np.ones((3, 4), np.float32)])
    assert out.shape == (3, 2)
    # the dygraph training entry points: a model, an optimizer and a
    # hapi.Model built without a place take CUDAPlace(0) and raise
    from paddle_tpu_torch import dygraph, hapi, optimizer
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertModel)
    tiny = dict(vocab_size=16, hidden_size=8, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=16,
                max_position_embeddings=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BertForPretraining(BertModel(BertConfig(**tiny)))
    with dygraph.guard(CPUPlace()):
        net = BertForPretraining(BertModel(BertConfig(**tiny)))
        assert optimizer.AdamW(parameters=net.parameters())._device == \
            torch.device("cpu")
        assert hapi.Model(net).parameters()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimizer.AdamW(parameters=net.parameters())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hapi.Model(net)
