"""HTTP inference server for the port — the `/predict` serving surface.

Copy of paddle_tpu/inference/server.py with the same protocol, so the
same clients (go/paddle/predictor.go, r/paddle.R) talk to either:

    GET  /metadata           -> {"inputs": [name...], "outputs": [...]}
    POST /predict            <- {"inputs": {name: nested-list|
                                            {"data": [...], "shape": [...],
                                             "dtype": "float32"}}}
                             -> {"outputs": {name: {"data": flat list,
                                             "shape": [...],
                                             "dtype": "..."}}}
    POST /generate           <- {"input_ids": [[...]...], "max_length": N,
                                 "decode_strategy": "greedy_search", ...}
                             -> {"output_ids": [[...]...]}
    GET  /health             -> {"status": "loading|ok|draining"}
                                (non-"ok" replies are 503: readiness)
    GET  /stats              -> serving.* monitor snapshot (+ kv_pool and
                                prefix_cache blocks with a generator)
    GET  /metrics            -> the same registry in Prometheus text
                                exposition format (core.monitor)

Concurrency model: ThreadingHTTPServer accepts one thread per
connection, but handler threads never run the model themselves —
`/predict` rows are admitted into a `serving.DynamicBatcher`, whose ONE
scheduler thread coalesces concurrent requests into one device batch and
runs the Predictor (on the GPU unless `place=CPUPlace()`), and
`/generate` sequences join the `serving.ContinuousBatchingEngine`'s
decode batch, whose ONE decode thread owns the model's device work
(`generator=` / `attach_generator`; the model runs where its parameters
are).  Callers block on per-request futures and get exactly their rows
back.

Backpressure is explicit: a full admission queue answers 503 with a
Retry-After hint, an expired deadline answers 504, and `stop()` flips
/health to "draining", lets in-flight work finish, then closes the
socket.
"""
from __future__ import annotations

import json
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

__all__ = ["InferenceServer"]


class BadRequest(ValueError):
    """Client-side malformation — always answered with HTTP 400."""


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1: keep-alive connections — serving clients hold one
    # connection open per worker instead of paying a TCP handshake and a
    # server thread spawn per request (every _reply sends Content-Length,
    # which 1.1 keep-alive requires)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, code, payload, headers=None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_error(self, code, err, headers=None):
        body = {"error": f"{type(err).__name__}: {err}",
                "type": type(err).__name__}
        retry = getattr(err, "retry_after_s", None)
        if retry is not None:
            # the header is RFC 7231 delta-seconds (integer, ceiling);
            # the body carries the precise jittered hint so in-process
            # clients keep sub-second decorrelation
            body["retry_after_s"] = round(float(retry), 3)
            headers = dict(headers or {})
            headers.setdefault("Retry-After",
                               str(max(1, int(-(-float(retry) // 1)))))
        self._reply(code, body, headers)

    # -- routes -------------------------------------------------------------
    def do_GET(self):
        srv: "InferenceServer" = self.server.inference  # type: ignore
        if self.path == "/health":
            status = srv.status
            self._reply(200 if status == "ok" else 503,
                        {"status": status})
        elif self.path == "/metadata":
            p = srv._base
            self._reply(200, {"inputs": p.get_input_names(),
                              "outputs": p.get_output_names()})
        elif self.path == "/stats":
            self._reply(200, srv.stats())
        elif self.path == "/metrics":
            from ..core.monitor import prometheus_text
            body = prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        srv: "InferenceServer" = self.server.inference  # type: ignore
        # ALWAYS drain the body first: replying before reading it would
        # leave the bytes on a keep-alive socket, where they get parsed
        # as the next request line (HTTP/1.1 desync)
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
        except Exception as e:
            self._reply_error(400, e)
            return
        if self.path not in ("/predict", "/generate"):
            self._reply(404, {"error": f"no route {self.path}"})
            return
        if not srv._enter_request():
            self._reply(503, {"error": "server is draining",
                              "status": srv.status},
                        {"Retry-After": "1"})
            return
        try:
            try:
                req = json.loads(body)
            except Exception as e:  # malformed JSON
                self._reply_error(400, e)
                return
            if self.path == "/predict":
                self._predict(srv, req)
            else:
                self._generate(srv, req)
        finally:
            srv._exit_request()

    def _predict(self, srv: "InferenceServer", req):
        from ..serving.batcher import BatcherError, QueueFullError
        try:
            feeds = srv._parse_feeds(req)
        except Exception as e:
            self._reply_error(400, e)
            return
        try:
            outs = srv._run_predict(feeds)
        except BadRequest as e:
            # submit-side validation (e.g. mismatched leading batch
            # dims) is the CLIENT's malformation, not a model failure
            self._reply_error(400, e)
            return
        except QueueFullError as e:
            self._reply_error(e.http_status, e)
            return
        except BatcherError as e:
            self._reply_error(e.http_status, e)
            return
        except Exception as e:
            # model/runtime failure on a well-formed request
            self._reply_error(500, e)
            return
        payload = {"outputs": {
            name: {"data": np.asarray(o).ravel().tolist(),
                   "shape": list(np.asarray(o).shape),
                   "dtype": str(np.asarray(o).dtype)}
            for name, o in zip(srv._base.get_output_names(), outs)}}
        self._reply(200, payload)

    def _generate(self, srv: "InferenceServer", req):
        from ..serving.batcher import BatcherError, QueueFullError
        if srv._engine is None:
            self._reply(501, {"error": "no generation model attached "
                                       "(InferenceServer(generator=...))"})
            return
        try:
            seqs, kw = srv._parse_generate(req)
        except Exception as e:
            self._reply_error(400, e)
            return
        futs = []
        try:
            futs = [srv._engine.submit(s, **kw) for s in seqs]
            # ONE deadline across all sequences of the request, not
            # t_left per future
            deadline = time.monotonic() + srv._engine.default_timeout_s \
                + 5.0
            outs = [f.result(timeout=max(0.0,
                                         deadline - time.monotonic()))
                    for f in futs]
        except Exception as e:  # noqa: BLE001 — mapped to status below
            # any partial failure: cancel the sequences already admitted
            # so no decode slot keeps generating into a discarded future
            for f in futs:
                f.cancel()
            if isinstance(e, FuturesTimeout):
                self._reply_error(504, e)
            elif isinstance(e, QueueFullError):
                self._reply_error(e.http_status, e)
            elif isinstance(e, BatcherError):
                self._reply_error(e.http_status, e)
            elif isinstance(e, ValueError):
                self._reply_error(400, e)
            else:
                self._reply_error(500, e)
            return
        self._reply(200, {"output_ids": [np.asarray(o).tolist()
                                         for o in outs]})


class InferenceServer:
    """serve a saved inference model over HTTP with dynamic batching.

        srv = InferenceServer(model_dir, port=0)   # CUDAPlace(0)
        srv.start()          # background thread; srv.port is bound
        ...
        srv.stop()           # drains in-flight work, then closes

    ``place`` (CUDAPlace(i) or CPUPlace()) is passed down to the
    Predictor; None means CUDAPlace(0), which raises without a CUDA
    device.  ``generator=`` attaches an autoregressive model (a
    ``models.GPTForGeneration``, on the device its parameters are on) and
    serves ``/generate`` through a ContinuousBatchingEngine: ``gen_slots``
    decode slots, ``gen_kv_pool`` (a plan dict or a ``PagedKVPool``) for
    the paged KV pool, ``gen_prefix_cache="auto"`` for the radix prefix
    cache, ``gen_speculative="auto"`` for speculative decoding through a
    stamped 2-layer draft (see ``attach_generator``).
    """

    def __init__(self, model_dir: str, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 8,
                 max_wait_ms: float = 2.0, max_queue: int = 64,
                 request_timeout_s: float = 30.0, generator=None,
                 place=None, gen_slots: Optional[int] = None,
                 gen_kv_pool=None, gen_prefix_cache=None,
                 gen_speculative=None, gen_tp_degree: Optional[int] = None):
        from . import Config, create_predictor
        from ..core.place import CPUPlace, CUDAPlace
        from ..serving import DynamicBatcher
        self._status = "loading"
        config = Config(model_dir)
        if isinstance(place, CPUPlace):
            config.disable_gpu()
        elif isinstance(place, CUDAPlace):
            config.enable_use_gpu(device_id=place.device_id)
        elif place is not None:
            raise TypeError(f"place must be CPUPlace or CUDAPlace, got "
                            f"{place!r}")
        self._base = create_predictor(config)
        self._batcher = DynamicBatcher(
            self._base.run, max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue=max_queue, default_timeout_s=request_timeout_s)
        self._engine = None
        if generator is not None:
            self.attach_generator(generator, max_slots=gen_slots,
                                  kv_pool=gen_kv_pool,
                                  prefix_cache=gen_prefix_cache,
                                  speculative=gen_speculative,
                                  tp_degree=gen_tp_degree)
        self._inflight = 0
        self._inflight_mu = threading.Lock()
        self._inflight_zero = threading.Condition(self._inflight_mu)
        self._serve_thread = None
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.inference = self  # type: ignore
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]

    # -- wiring -------------------------------------------------------------
    def attach_generator(self, model, max_slots: Optional[int] = None,
                         max_queue: int = 64, timeout_s: float = 120.0,
                         kv_pool=None, prefix_cache=None,
                         speculative=None, tp_degree: Optional[int] = None):
        """Enable /generate: wrap ``model`` in a ContinuousBatchingEngine
        (started with the server).  ``kv_pool`` (a plan dict or a
        ``PagedKVPool``) serves decode through the block-paged KV pool on
        the model's device (admission by free-page count, COW prefix
        sharing); the plan's batch ceiling applies unless ``max_slots``
        is given, and its ``kv_dtype`` / ``weight_dtype`` ("int8") select
        int8 pages and int8 decode matmuls.  ``prefix_cache="auto"``
        retains hot prompt prefixes across requests;
        ``speculative="auto"`` decodes through a stamped 2-layer draft
        (both need paged KV).  ``tp_degree`` > 1 serves decode tp-sharded
        (``serving.TPShardedDecoder``: this server is the leader, rank 0,
        and the other ranks of the process group run the decoder's
        ``follow()``); a plan passed as ``kv_pool`` carries its own
        degree, an explicit arg wins.  ``kv_pool="auto"`` sizes the
        pool with ``static.page_budget`` from the card's memory."""
        from ..serving import ContinuousBatchingEngine
        self._engine = ContinuousBatchingEngine(
            model, max_slots=max_slots, max_queue=max_queue,
            default_timeout_s=timeout_s, kv_pool=kv_pool,
            prefix_cache=prefix_cache, speculative=speculative,
            tp_degree=tp_degree)
        if self._status == "ok":
            self._engine.start()
        return self._engine

    @property
    def status(self) -> str:
        return self._status

    @property
    def engine(self):
        return self._engine

    @property
    def batcher(self):
        return self._batcher

    @property
    def predictor(self):
        return self._base

    def stats(self) -> dict:
        """The /stats payload: serving namespace + queue depth."""
        from ..serving.metrics import serving_stats
        out = {"status": self._status, "serving": serving_stats(),
               "place": repr(self._base.place),
               "queue_depth": self._batcher.queue_depth}
        if self._engine is not None:
            out["gen_queue_depth"] = self._engine.queue_depth
            out["gen_active_slots"] = self._engine.active_slots
            out["gen_kv_buckets"] = self._engine.kv_buckets
            if self._engine.kv_pool is not None:
                out["kv_pool"] = self._engine.kv_pool.stats()
            if self._engine.prefix_cache is not None:
                out["prefix_cache"] = self._engine.prefix_cache.stats()
            if self._engine.speculative is not None:
                out["speculative"] = self._engine.speculative.stats()
        return out

    # -- request plumbing (handler-thread side) -----------------------------
    def _enter_request(self) -> bool:
        from ..serving import metrics
        with self._inflight_mu:
            if self._status != "ok":
                return False
            self._inflight += 1
            metrics.gauge("server.inflight", self._inflight)
            return True

    def _exit_request(self):
        from ..serving import metrics
        with self._inflight_mu:
            self._inflight -= 1
            metrics.gauge("server.inflight", self._inflight)
            if self._inflight == 0:
                self._inflight_zero.notify_all()

    def _parse_feeds(self, req):
        if not isinstance(req, dict) or "inputs" not in req:
            raise BadRequest('request body needs an "inputs" object')
        feeds = []
        for name in self._base.get_input_names():
            if name not in req["inputs"]:
                raise BadRequest(f"missing input {name!r}")
            v = req["inputs"][name]
            if isinstance(v, dict):
                arr = np.asarray(v["data"],
                                 dtype=np.dtype(v.get("dtype", "float32")))
                arr = arr.reshape(v["shape"])
            else:
                arr = np.asarray(v)
            feeds.append(arr)
        return feeds

    @staticmethod
    def _parse_generate(req):
        if not isinstance(req, dict) or "input_ids" not in req:
            raise BadRequest('request body needs "input_ids"')
        ids = req["input_ids"]
        if not isinstance(ids, list) or not ids:
            raise BadRequest('"input_ids" must be a non-empty list')
        seqs = ids if isinstance(ids[0], list) else [ids]
        kw = {}
        for key in ("max_length", "top_k", "seed"):
            if key in req:
                kw[key] = int(req[key])
        if "temperature" in req:
            kw["temperature"] = float(req["temperature"])
        if "decode_strategy" in req:
            kw["decode_strategy"] = str(req["decode_strategy"])
        return [np.asarray(s, np.int64) for s in seqs], kw

    def _run_predict(self, feeds):
        try:
            fut = self._batcher.submit(feeds)
        except ValueError as e:
            # submit() validates the request shape synchronously —
            # keep it distinguishable from run-side model errors
            raise BadRequest(str(e))
        return fut.result(timeout=self._batcher.default_timeout_s + 5.0)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> threading.Thread:
        self._batcher.start()
        if self._engine is not None:
            self._engine.start()
        t = threading.Thread(target=self._httpd.serve_forever,
                             kwargs={"poll_interval": 0.1}, daemon=True)
        t.start()
        self._serve_thread = t
        self._status = "ok"
        return t

    def stop(self, drain_timeout_s: float = 30.0):
        """Graceful shutdown: flip /health to "draining", reject new work,
        let in-flight handlers and queued batches finish, then close the
        socket.  Idempotent."""
        if self._status == "stopped":
            return
        self._status = "draining"
        deadline = time.monotonic() + drain_timeout_s
        # finish everything already admitted to the serving tier ...
        self._batcher.stop(drain=True,
                           timeout=max(0.0, deadline - time.monotonic()))
        if self._engine is not None:
            self._engine.stop(drain=True,
                              timeout=max(0.0, deadline - time.monotonic()))
        # ... and wait for handler threads to write their responses before
        # tearing the socket down (the old stop() raced server_close here)
        with self._inflight_mu:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._inflight_zero.wait(left)
        if self._serve_thread is not None:
            # shutdown() handshakes with serve_forever — calling it on a
            # never-started server would wait on an event nobody sets
            self._httpd.shutdown()
        self._httpd.server_close()
        self._status = "stopped"
