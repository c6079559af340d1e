"""The port's InferenceServer on the CPU (place=CPUPlace()) serving the
small BERT encoder that paddle_tpu saved: concurrent /predict posts come
back with the rows of paddle_tpu's Predictor (atol=rtol=1e-5), and
/health, /metadata, 503 on a full queue, /generate and the drained stop()
behave as tests/test_inference_server.py and tests/test_serving.py assert
for the reference server."""
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.inference import Config as JConfig, Predictor as JPredictor
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.inference.server import InferenceServer
from paddle_tpu_torch.serving import metrics

from test_torch_predictor import _feeds, save_reference_model
from test_torch_program import flash_mode

TOL = dict(rtol=1e-5, atol=1e-5)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bert_flash"))
    save_reference_model(d, flash=True)
    return d


def test_concurrent_predict_matches_reference(model_dir):
    with flash_mode(True):
        ref = JPredictor(JConfig(model_dir))
    ids, pos = _feeds(5, seed=4)
    (want,) = ref.run([ids, pos])
    want = np.asarray(want)
    runs0 = metrics.counter("batch.runs")
    srv = InferenceServer(model_dir, place=CPUPlace(), max_wait_ms=20.0)
    srv.start()
    try:
        base = f"http://{srv.host}:{srv.port}"
        with urllib.request.urlopen(base + "/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(base + "/metadata", timeout=10) as r:
            md = json.loads(r.read())
        assert md["inputs"] == ["ids", "pos"]
        out_name = md["outputs"][0]
        rows = [(0, 1), (1, 3), (3, 5)]  # 1, 2 and 2 rows
        results = [None] * len(rows)

        def client(i):
            a, b = rows[i]
            reply = _post(base + "/predict", {"inputs": {
                "ids": ids[a:b].tolist(),
                "pos": {"data": pos[a:b].ravel().tolist(),
                        "shape": list(pos[a:b].shape), "dtype": "int64"}}})
            o = reply["outputs"][out_name]
            results[i] = np.asarray(o["data"], np.float32).reshape(
                o["shape"])

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(rows))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        for (a, b), got in zip(rows, results):
            np.testing.assert_allclose(got, want[a:b], **TOL)
        assert metrics.counter("batch.runs") > runs0
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            st = json.loads(r.read())
        assert st["status"] == "ok" and st["place"] == "CPUPlace"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert "serving_requests_completed_total" in r.read().decode()
        # malformed request -> structured 400, server stays alive
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/predict", {"inputs": {}})
        assert ei.value.code == 400
        assert "error" in json.loads(ei.value.read())
        # /generate without a generator attached: 501, as the reference
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/generate", {"input_ids": [1, 2]})
        assert ei.value.code == 501
        assert "no generation model attached" in \
            json.loads(ei.value.read())["error"]
    finally:
        srv.stop()
    assert srv.status == "stopped"
    assert srv.batcher.queue_depth == 0
    with pytest.raises(Exception):
        urllib.request.urlopen(base + "/health", timeout=2)


def test_full_queue_answers_503_with_retry_after(model_dir):
    srv = InferenceServer(model_dir, place=CPUPlace(), max_queue=0)
    srv.start()
    try:
        ids, pos = _feeds(1)
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=10)
        conn.request("POST", "/predict", json.dumps(
            {"inputs": {"ids": ids.tolist(), "pos": pos.tolist()}}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 503
        assert int(resp.getheader("Retry-After")) >= 1
        assert body["type"] == "QueueFullError" and body["retry_after_s"] > 0
        conn.close()
    finally:
        srv.stop()


def test_stop_drains_in_flight_requests(model_dir):
    """stop() lets an admitted request finish before closing."""
    srv = InferenceServer(model_dir, place=CPUPlace(), max_wait_ms=2000.0)
    srv.start()
    ids, pos = _feeds(1)
    got = {}

    def client():
        got["reply"] = _post(f"http://{srv.host}:{srv.port}/predict",
                             {"inputs": {"ids": ids.tolist(),
                                         "pos": pos.tolist()}})

    t = threading.Thread(target=client)
    t.start()
    deadline = time.monotonic() + 30.0  # until the request is admitted
    while not srv.batcher.queue_depth and time.monotonic() < deadline:
        time.sleep(0.005)
    assert srv.batcher.queue_depth == 1
    srv.stop()
    t.join(timeout=30)
    assert not t.is_alive()
    assert srv.status == "stopped"
    out = next(iter(got["reply"]["outputs"].values()))
    assert out["shape"] == [1, 32, 64]


def test_server_rejects_generator_and_stops_unstarted(model_dir,
                                                     monkeypatch):
    """A generator is served now (tests/test_torch_generation.py), and so
    is gen_kv_pool="auto" (the pool sized by static.page_budget from the
    memory budget).  A tp degree the world does not divide raises."""
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.models import (GPTConfig, GPTForGeneration,
                                         GPTModel)
    with dygraph.guard(CPUPlace()):
        gen = GPTForGeneration(GPTModel(GPTConfig(
            vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
            max_position=32, dropout=0.0)))
    plan = dict(num_layers=1, num_heads=2, head_dim=8, page_tokens=4,
                pages=8, tp_degree=2)
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", str(16 * 2 ** 20))
    auto = InferenceServer(model_dir, place=CPUPlace(), generator=gen,
                           gen_kv_pool="auto")
    pool = auto.engine.kv_pool
    assert pool is not None and pool.plan["hbm_bytes"] == 16 * 2 ** 20
    assert pool.num_pages == pool.plan["pages"] > 0
    auto.stop(drain_timeout_s=1.0)
    # a plan sized for tp-sharded decode is served (tests/test_torch_tp_
    # decode.py): off a process group the world is 1, which tp 2 does not
    # divide, with the plan's degree or an explicit one
    for kw in ({"gen_kv_pool": plan}, {"gen_tp_degree": 2}):
        with pytest.raises(ValueError, match="does not divide"):
            InferenceServer(model_dir, place=CPUPlace(), generator=gen,
                            **kw)
    srv = InferenceServer(model_dir, place=CPUPlace())
    done = threading.Event()

    def stopper():
        srv.stop(drain_timeout_s=1.0)
        done.set()

    threading.Thread(target=stopper, daemon=True).start()
    assert done.wait(10), "stop() hung on a never-started server"
    assert srv.status == "stopped"
