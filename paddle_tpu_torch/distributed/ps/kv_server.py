"""The parameter server's KV runtime: a threaded TCP server and its client.

Counterpart of paddle_tpu/distributed/ps/kv_server.py (the reference's
RPCServer / RPCClient, listen_and_serv and the sync / async / geo
communicator), kept close to verbatim: the tier is host code, with the
same length-prefixed binary protocol (numpy buffers, no pickle on the
wire), the same apply rules, heartbeats, retries and deadlines, so a
server of either package serves a client of the other.

Sync mode: the server applies `param -= lr * mean(grads)` once every live
trainer's push for a step has arrived (barrier counting, heartbeat
aware).  Async mode applies each push at once (Hogwild).  Geo mode adds
a delta.  Row-sharded sparse tables apply their configured optimizer
(SGD, or Adam with server-resident moments).

`KVClient.stats` counts the client's rpcs: calls, bytes sent and
received (headers included) and the seconds spent in them, the KV
plane's share of a trainer's step.
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["KVServer", "KVClient"]

_MAGIC = b"PSRPC1\n"
# ops
OP_INIT = 1        # set param if absent
OP_PULL = 2        # get param
OP_PUSH_SYNC = 3   # push grad; applied when all trainers arrive
OP_PUSH_ASYNC = 4  # push grad; applied immediately
OP_BARRIER = 5
OP_SHUTDOWN = 6
OP_PING = 7
OP_SET = 8         # overwrite param (geo-SGD delta merge uses add)
OP_PUSH_DELTA = 9  # geo: add delta to param
OP_ERROR = 10      # server-side failure; name carries the message
OP_HEARTBEAT = 11  # trainer liveness ping; extra carries the trainer id
OP_PULL_ROWS = 12  # sparse pull: arr carries int64 LOCAL row ids
OP_PUSH_ROWS = 13  # sparse push: ids message then values message (2-part)
OP_CONFIG_SPARSE_OPT = 14  # arr=[beta1,beta2,eps], extra: 0=sgd 1=adam
OP_QPUSH = 16      # named-queue push (heter activation relay)
OP_QPOP = 17       # named-queue BLOCKING pop; extra carries the timeout
OP_PUSH_ROWS_SYNC = 15     # 2-part like PUSH_ROWS; server accumulates
#                            until every live trainer's push arrives,
#                            averages merged rows, then applies the
#                            table's optimizer (fixes the client-trusting
#                            grad_scale protocol: a client that omits
#                            scaling can no longer train at N x lr)


def _send_msg(sock, op: int, name: str, arr: Optional[np.ndarray],
              extra: float = 0.0):
    name_b = name.encode()
    if arr is not None:
        arr = np.ascontiguousarray(arr)
        dtype_b = str(arr.dtype).encode()
        shape = arr.shape
        payload = arr.tobytes()
    else:
        dtype_b, shape, payload = b"", (), b""
    shape_b = ",".join(str(s) for s in shape).encode()
    header = struct.pack("!BIIIdI", op, len(name_b), len(dtype_b),
                         len(shape_b), extra, len(payload))
    msg = _MAGIC + header + name_b + dtype_b + shape_b + payload
    sock.sendall(msg)
    return len(msg)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_msg(sock, stats=None):
    magic = _recv_exact(sock, len(_MAGIC))
    if magic != _MAGIC:
        raise ConnectionError("bad magic")
    header = _recv_exact(sock, struct.calcsize("!BIIIdI"))
    op, nl, dl, sl, extra, pl = struct.unpack("!BIIIdI", header)
    name = _recv_exact(sock, nl).decode() if nl else ""
    dtype = _recv_exact(sock, dl).decode() if dl else ""
    shape_s = _recv_exact(sock, sl).decode() if sl else ""
    payload = _recv_exact(sock, pl) if pl else b""
    if stats is not None:
        stats["bytes_recv"] += len(_MAGIC) + len(header) + nl + dl + sl + pl
    arr = None
    if dtype:
        shape = tuple(int(x) for x in shape_s.split(",")) if shape_s else ()
        arr = np.frombuffer(payload, dtype=dtype).reshape(shape).copy()
    return op, name, arr, extra


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: "KVServer" = self.server.kv  # type: ignore
        sock = self.request
        try:
            while True:
                op, name, arr, extra = _recv_msg(sock)
                if op == OP_PING:
                    _send_msg(sock, OP_PING, "", None)
                elif op == OP_HEARTBEAT:
                    with srv._sync_cv:
                        srv._trainer_seen[int(extra)] = time.time()
                        srv._sync_cv.notify_all()
                    _send_msg(sock, OP_HEARTBEAT, "", None)
                elif op == OP_INIT:
                    with srv._lock:
                        srv._store.setdefault(name, arr.astype(np.float32))
                    _send_msg(sock, OP_INIT, name, None)
                elif op == OP_SET:
                    with srv._lock:
                        srv._store[name] = arr.astype(np.float32)
                    _send_msg(sock, OP_SET, name, None)
                elif op == OP_PULL:
                    with srv._lock:
                        val = srv._store.get(name)
                    _send_msg(sock, OP_PULL, name, val)
                elif op == OP_PUSH_ASYNC:
                    with srv._lock:
                        srv._apply(name, arr, extra)
                    _send_msg(sock, OP_PUSH_ASYNC, name, None)
                elif op == OP_PUSH_DELTA:
                    with srv._lock:
                        if name in srv._store:
                            srv._store[name] = srv._store[name] + \
                                arr.astype(np.float32)
                    _send_msg(sock, OP_PUSH_DELTA, name, None)
                elif op == OP_PULL_ROWS:
                    # sparse table pull: arr = local row ids of this shard
                    try:
                        with srv._lock:
                            tab = srv._store.get(name)
                            rows = (None if tab is None
                                    else tab[arr.astype(np.int64)])
                    except (IndexError, ValueError) as e:
                        # e.g. out-of-range row id: reply a typed error
                        # instead of dying and leaving the client with an
                        # opaque ConnectionError
                        _send_msg(sock, OP_ERROR,
                                  f"pull_rows({name}): {e}", None)
                    else:
                        _send_msg(sock, OP_PULL_ROWS, name, rows)
                elif op == OP_PUSH_ROWS:
                    # two-part message: ids (this one, extra = lr) then
                    # values on the same socket; the table's configured
                    # optimizer applies immediately (Hogwild — reference
                    # async PS sparse-table semantics)
                    vop, _, vals, _ = _recv_msg(sock)
                    ids = arr.astype(np.int64)
                    try:
                        with srv._lock:
                            if vals is not None:
                                srv._apply_sparse_rows(
                                    name, ids, vals.astype(np.float32),
                                    float(extra))
                    except (KeyError, IndexError, ValueError) as e:
                        _send_msg(sock, OP_ERROR, str(e), None)
                    else:
                        _send_msg(sock, OP_PUSH_ROWS, name, None)
                elif op == OP_PUSH_ROWS_SYNC:
                    vop, _, vals, _ = _recv_msg(sock)
                    try:
                        srv._push_rows_sync(
                            name, arr.astype(np.int64),
                            (np.zeros((0, 1), np.float32) if vals is None
                             else vals.astype(np.float32)), float(extra))
                    except (TimeoutError, KeyError, IndexError,
                            ValueError) as e:
                        _send_msg(sock, OP_ERROR, str(e), None)
                    else:
                        _send_msg(sock, OP_PUSH_ROWS_SYNC, name, None)
                elif op == OP_QPUSH:
                    with srv._queue_cv:
                        srv._queues.setdefault(name, []).append(arr)
                        srv._queue_cv.notify_all()
                    _send_msg(sock, OP_QPUSH, name, None)
                elif op == OP_QPOP:
                    # extra is the server-side wait budget; 0 means a
                    # non-blocking try-pop (the client loops short waits
                    # so no single wait approaches its socket timeout)
                    deadline = time.time() + max(0.0, extra)
                    val = None
                    timed_out = False
                    with srv._queue_cv:
                        while True:
                            q = srv._queues.get(name)
                            if q:
                                val = q.pop(0)
                                break
                            if time.time() > deadline:
                                timed_out = True
                                break
                            srv._queue_cv.wait(timeout=0.5)
                    if timed_out:
                        _send_msg(sock, OP_ERROR,
                                  f"queue {name!r}: pop timed out", None)
                    else:
                        _send_msg(sock, OP_QPOP, name, val)
                elif op == OP_CONFIG_SPARSE_OPT:
                    with srv._lock:
                        cfg = arr.astype(np.float64).reshape(-1)
                        # first writer wins, like OP_INIT: a trainer
                        # restarting mid-training must not wipe the
                        # accumulated moments/step counter
                        srv._sparse_opt.setdefault(name, {
                            "type": "adam" if extra >= 0.5 else "sgd",
                            "beta1": float(cfg[0]), "beta2": float(cfg[1]),
                            "epsilon": float(cfg[2]),
                            "m1": None, "m2": None, "step": 0})
                    _send_msg(sock, OP_CONFIG_SPARSE_OPT, name, None)
                elif op == OP_PUSH_SYNC:
                    try:
                        srv._push_sync(name, arr, extra)
                    except TimeoutError as e:
                        _send_msg(sock, OP_ERROR, str(e), None)
                    else:
                        _send_msg(sock, OP_PUSH_SYNC, name, None)
                elif op == OP_BARRIER:
                    try:
                        srv._barrier_wait()
                    except TimeoutError as e:
                        _send_msg(sock, OP_ERROR, str(e), None)
                    else:
                        _send_msg(sock, OP_BARRIER, "", None)
                elif op == OP_SHUTDOWN:
                    _send_msg(sock, OP_SHUTDOWN, "", None)
                    threading.Thread(target=self.server.shutdown,
                                     daemon=True).start()
                    return
        except (ConnectionError, OSError):
            return


class KVServer:
    """listen_and_serv analog: blocking `serve()`, thread-safe store."""

    def __init__(self, endpoint: str, num_trainers: int = 1,
                 sync_timeout: float = 30.0, heartbeat_timeout: float = 10.0):
        host, port = endpoint.rsplit(":", 1)
        self.num_trainers = max(1, num_trainers)
        self.sync_timeout = sync_timeout
        # heart_beat_monitor.h parity: trainers that registered a heartbeat
        # but have gone silent longer than this are treated as dead, so
        # sync pushes / barriers complete over the survivors instead of
        # hanging the whole job
        self.heartbeat_timeout = heartbeat_timeout
        self._trainer_seen: Dict[int, float] = {}
        self._store: Dict[str, np.ndarray] = {}
        self._lock = threading.RLock()
        self._pending: Dict[str, List[np.ndarray]] = {}
        self._push_gen: Dict[str, int] = {}
        # per-table server-resident optimizer state (pslib analog:
        # lookup_sparse_table_fuse_adam keeps Adam moments ON the server)
        self._sparse_opt: Dict[str, dict] = {}
        self._rows_pending: Dict[str, List] = {}
        self._rows_gen: Dict[str, int] = {}
        # named blocking queues: the heter activation relay + the
        # enqueue/dequeue op family (reference
        # operators/collective/c_*queue* + framework BlockingQueue)
        self._queues: Dict[str, List[np.ndarray]] = {}
        self._queue_cv = threading.Condition()
        self._sync_cv = threading.Condition()
        self._barrier_count = 0
        self._barrier_gen = 0
        socketserver.ThreadingTCPServer.allow_reuse_address = True
        self._tcp = socketserver.ThreadingTCPServer(
            (host or "127.0.0.1", int(port)), _Handler)
        # handler threads block in recv on live client connections; never
        # join them on close (clients own the connection lifetime)
        self._tcp.daemon_threads = True
        self._tcp.block_on_close = False
        self._tcp.kv = self  # type: ignore
        self.endpoint = f"{host}:{self._tcp.server_address[1]}"

    # server-side sgd (reference pserver optimizer block)
    def _apply(self, name, grad, lr):
        if name in self._store and grad is not None:
            self._store[name] = self._store[name] - \
                float(lr) * grad.astype(np.float32)

    def _apply_sparse_rows(self, name, ids, vals, lr):
        """Apply row gradients with the table's configured optimizer.

        Caller holds `_lock`.  Duplicate ids are merged (summed) first —
        required for Adam, whose moments must update once per row per
        step.  sgd: `row -= lr * g`.  adam: the reference
        lookup_sparse_table_fuse_adam_op.cc:145 recipe — server-resident
        per-row moments, GLOBAL beta-power schedule
        (lr' = lr * sqrt(1 - b2^t) / (1 - b1^t))."""
        if ids.size == 0:
            return
        tab = self._store.get(name)
        if tab is None:
            raise KeyError(
                f"sparse table {name!r} not on this server — push dropped")
        if ids.max(initial=0) >= tab.shape[0] or ids.min(initial=0) < 0:
            raise IndexError(
                f"push_rows({name}): row id out of range 0..{tab.shape[0]}")
        uids, inv = np.unique(ids, return_inverse=True)
        merged = np.zeros((uids.size,) + vals.shape[1:], np.float32)
        np.add.at(merged, inv, vals)
        # copy-on-write: OP_PULL sends store refs outside the lock
        tab = tab.copy()
        cfg = self._sparse_opt.get(name)
        if cfg is None or cfg["type"] == "sgd":
            tab[uids] -= float(lr) * merged
        else:
            if cfg["m1"] is None:
                cfg["m1"] = np.zeros_like(tab)
                cfg["m2"] = np.zeros_like(tab)
            b1, b2, eps = cfg["beta1"], cfg["beta2"], cfg["epsilon"]
            cfg["step"] += 1
            t = cfg["step"]
            m1 = cfg["m1"][uids] * b1 + (1.0 - b1) * merged
            m2 = cfg["m2"][uids] * b2 + (1.0 - b2) * merged * merged
            cfg["m1"][uids] = m1
            cfg["m2"][uids] = m2
            lr_t = float(lr) * np.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
            tab[uids] -= lr_t * m1 / (np.sqrt(m2) + eps)
        self._store[name] = tab

    def _push_rows_sync(self, name, ids, vals, lr):
        """Sync-mode sparse push: accumulate every live trainer's
        (ids, vals), then apply the AVERAGED merged rows once — the
        dense _push_sync discipline moved server-side, so correctness no
        longer depends on clients passing grad_scale=1/N.  Clients must
        push to every shard each step (empty ids allowed) so the fanin
        count completes."""
        def apply(batch):
            # empty contributions count toward the fanin but may carry
            # degenerate value shapes — drop them here
            nonempty = [(i, v) for i, v in batch if i.size]
            if nonempty:
                all_ids = np.concatenate([i for i, _ in nonempty])
                all_vals = np.concatenate([v for _, v in nonempty])
            else:
                all_ids = np.zeros((0,), np.int64)
                all_vals = np.zeros((0, 1), np.float32)
            with self._lock:
                self._apply_sparse_rows(
                    name, all_ids, all_vals / max(1, len(batch)), lr)

        self._sync_fanin(self._rows_pending, self._rows_gen, name,
                         (ids, vals), apply, "sync sparse push")

    def _effective_trainers(self) -> int:
        """Fanin for sync rounds: only trainers that REGISTERED a heartbeat
        and then went silent count as dead — a trainer that hasn't
        connected yet (startup staggering) is presumed alive, otherwise
        the first booter would complete rounds alone and break sync-SGD
        semantics (heart_beat_monitor.h counts the same way)."""
        now = time.time()
        dead = sum(1 for t in self._trainer_seen.values()
                   if now - t >= self.heartbeat_timeout)
        return max(1, self.num_trainers - dead)

    def _sync_fanin(self, pending, gens, name, mine, apply_fn, what):
        """Shared accumulate-until-every-live-trainer discipline: append
        `mine` to pending[name]; the completing waiter pops the batch,
        runs apply_fn(batch) and bumps the generation.  Per-name
        generation counter avoids the wake-after-next-round race; the
        fanin re-evaluates each second so a trainer dying mid-round
        shrinks the barrier instead of hanging everyone; on timeout the
        waiter WITHDRAWS its own contribution (by identity) so the next
        round's mean does not mix in a stale gradient."""
        deadline = time.time() + self.sync_timeout
        with self._sync_cv:
            pending.setdefault(name, []).append(mine)
            my_gen = gens.get(name, 0)
            while True:
                # completion checks FIRST so a round landing right at the
                # deadline is reported as success, not TimeoutError
                if gens.get(name, 0) != my_gen:
                    return  # a round (including this grad) was applied
                pend = pending.get(name, [])
                if len(pend) >= self._effective_trainers():
                    batch = pending.pop(name)
                    apply_fn(batch)
                    gens[name] = my_gen + 1
                    self._sync_cv.notify_all()
                    return
                if time.time() > deadline:
                    pend = pending.get(name)
                    if pend is not None:
                        for i, item in enumerate(pend):
                            if item is mine:
                                del pend[i]
                                break
                        if not pend:
                            pending.pop(name, None)
                    raise TimeoutError(
                        f"{what} of {name!r}: not all "
                        f"{self.num_trainers} trainers arrived")
                self._sync_cv.wait(timeout=1.0)

    def _push_sync(self, name, grad, lr):
        """Apply the mean once every LIVE trainer's push has arrived."""
        def apply(batch):
            with self._lock:
                self._apply(name, np.mean(batch, axis=0), lr)

        self._sync_fanin(self._pending, self._push_gen, name, grad,
                         apply, "sync push")

    def _barrier_wait(self):
        deadline = time.time() + 60
        with self._sync_cv:
            self._barrier_count += 1
            gen = self._barrier_gen
            while True:
                if gen != self._barrier_gen:
                    return  # released (checked before the deadline raise)
                if self._barrier_count >= self._effective_trainers():
                    self._barrier_count = 0
                    self._barrier_gen += 1
                    self._sync_cv.notify_all()
                    return
                if time.time() > deadline:
                    # withdraw this waiter so a later barrier attempt
                    # doesn't release early on the leaked count
                    self._barrier_count -= 1
                    raise TimeoutError("barrier timeout")
                self._sync_cv.wait(timeout=1.0)

    def serve(self):
        self._tcp.serve_forever(poll_interval=0.1)

    def serve_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.serve, daemon=True)
        t.start()
        return t

    def stop(self):
        self._tcp.shutdown()
        self._tcp.server_close()

    def get(self, name):
        with self._lock:
            return self._store.get(name)


class KVClient:
    """RPCClient analog: one socket per pserver, vars sharded round-robin
    by name hash (DistributeTranspiler round-robin param placement,
    transpiler/distribute_transpiler.py:80 VarBlock).

    Transport failures retry with bounded exponential backoff inside an
    rpc_deadline budget (FLAGS_rpc_deadline, the reference grpc client's
    deadline and error callbacks); each retry drops the cached socket and
    reconnects, so a pserver restart is survived transparently.  Push-type
    ops are at-least-once under retry (a push that was applied just before
    the connection died may re-apply), matching the reference's async RPC
    semantics."""

    def __init__(self, endpoints: List[str], sock_timeout: float = 60.0,
                 rpc_deadline: Optional[float] = None,
                 max_retries: int = 8):
        self.endpoints = list(endpoints)
        self.sock_timeout = sock_timeout
        if rpc_deadline is None:
            try:
                from ...core.flags import get_flags
                rpc_deadline = float(
                    get_flags("rpc_deadline")["rpc_deadline"]) / 1000.0
            except Exception:
                rpc_deadline = 180.0
        self.rpc_deadline = rpc_deadline
        self.max_retries = max_retries
        self._socks: Dict[str, socket.socket] = {}
        self._hb_stop: Optional[threading.Event] = None
        self.stats = {"calls": 0, "bytes_sent": 0, "bytes_recv": 0,
                      "seconds": 0.0}

    def _sock(self, ep) -> socket.socket:
        s = self._socks.get(ep)
        if s is None:
            host, port = ep.rsplit(":", 1)
            s = socket.create_connection((host, int(port)),
                                         timeout=self.sock_timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks[ep] = s
        return s

    def _ep_for(self, name: str) -> str:
        # stable across processes (builtin hash() is seed-randomized and
        # would shard the same param to different servers per process)
        import zlib
        return self.endpoints[zlib.crc32(name.encode())
                              % len(self.endpoints)]

    def _with_retry(self, ep, fn, idempotent=True, deadline=None,
                    max_retries=None):
        """Run fn(sock) against ep, reconnecting with exponential backoff
        on transport errors until rpc_deadline/max_retries runs out.

        idempotent=False (OP_PUSH_SYNC, OP_BARRIER — ops the server
        COUNTS): once the request hit the wire a retry could double-count
        this trainer in the sync fanin, so only failures raised before
        the send (connection establishment) are retried; a mid-flight
        failure propagates to the caller instead of corrupting the
        round's average."""
        t0 = time.perf_counter()
        try:
            return self._retry_loop(ep, fn, idempotent, deadline,
                                    max_retries)
        finally:
            self.stats["calls"] += 1
            self.stats["seconds"] += time.perf_counter() - t0

    def _retry_loop(self, ep, fn, idempotent, deadline, max_retries):
        deadline = time.time() + (self.rpc_deadline if deadline is None
                                  else deadline)
        retries = self.max_retries if max_retries is None else max_retries
        delay = 0.05
        last: Exception = ConnectionError("no attempt made")
        for attempt in range(retries):
            sent = False
            try:
                s = self._sock(ep)

                def guard_send(*a, **kw):
                    nonlocal sent
                    sent = True
                    n = _send_msg(*a, **kw)
                    self.stats["bytes_sent"] += n
                    return n

                return fn(s, guard_send)
            except (ConnectionError, OSError, socket.timeout) as e:
                last = e
                # the socket is in an unknown state: drop and reconnect
                s = self._socks.pop(ep, None)
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                if sent and not idempotent:
                    raise ConnectionError(
                        f"non-idempotent rpc to {ep} failed mid-flight "
                        f"(not retried to avoid double-apply): {e}") from e
                now = time.time()
                if now >= deadline or attempt == retries - 1:
                    break
                time.sleep(min(delay, max(deadline - now, 0.0)))
                delay = min(delay * 2, 5.0)
        raise ConnectionError(
            f"rpc to pserver {ep} failed after {retries} "
            f"attempts / {self.rpc_deadline:.0f}s deadline: {last}")

    # ops where a post-send retry could double-count on the server
    # (queue ops: a retried push double-enqueues, a retried pop after a
    # server-side success drops an element)
    _NON_IDEMPOTENT = (OP_PUSH_SYNC, OP_BARRIER, OP_PUSH_ROWS_SYNC,
                       OP_QPUSH, OP_QPOP)

    def _call(self, ep, op, name="", arr=None, extra=0.0, deadline=None,
              max_retries=None):
        def roundtrip(s, send):
            send(s, op, name, arr, extra)
            return _recv_msg(s, self.stats)

        rop, rname, rarr, rextra = self._with_retry(
            ep, roundtrip, idempotent=op not in self._NON_IDEMPOTENT,
            deadline=deadline, max_retries=max_retries)
        if rop == OP_ERROR:
            raise TimeoutError(rname)
        return rop, rname, rarr, rextra

    def wait_server_ready(self, timeout=60):
        """rpc wait_server_ready parity: ping until every server answers.
        Each ping gets a SHORT single-attempt budget so the outer
        `timeout` stays authoritative (the general rpc_deadline retry
        loop would otherwise stretch one dead endpoint to ~3x it)."""
        deadline = time.time() + timeout
        for ep in self.endpoints:
            while True:
                try:
                    self._call(ep, OP_PING, deadline=1.0, max_retries=1)
                    break
                except (ConnectionError, OSError):
                    self._socks.pop(ep, None)
                    if time.time() > deadline:
                        raise TimeoutError(f"pserver {ep} not ready")
                    time.sleep(0.2)

    def init_param(self, name, value):
        self._call(self._ep_for(name), OP_INIT, name, np.asarray(value))

    def set_param(self, name, value):
        self._call(self._ep_for(name), OP_SET, name, np.asarray(value))

    def pull(self, name) -> np.ndarray:
        _, _, arr, _ = self._call(self._ep_for(name), OP_PULL, name)
        if arr is None:
            raise KeyError(f"param {name!r} not on server")
        return arr

    def push_grad(self, name, grad, lr, sync=True):
        op = OP_PUSH_SYNC if sync else OP_PUSH_ASYNC
        self._call(self._ep_for(name), op, name, np.asarray(grad),
                   float(lr))

    def push_delta(self, name, delta):
        self._call(self._ep_for(name), OP_PUSH_DELTA, name,
                   np.asarray(delta))

    # -- sparse (row-sharded) tables ---------------------------------------
    # Row r of a distributed table lives on pserver (r % n_eps) at local
    # row (r // n_eps) — the reference's block-partitioned
    # distributed_lookup_table (distributed_lookup_table_op.cc), with
    # modulo placement instead of contiguous blocks so shards stay
    # balanced under skewed id distributions.
    def init_sparse_table(self, name, value):
        """Split [V, D] rows across pservers (first writer wins)."""
        value = np.asarray(value)
        n = len(self.endpoints)
        for e, ep in enumerate(self.endpoints):
            self._call(ep, OP_INIT, name, value[e::n])

    def pull_sparse(self, name, ids) -> np.ndarray:
        """Gather rows `ids` (global) from the sharded table."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        n = len(self.endpoints)
        out = None
        for e, ep in enumerate(self.endpoints):
            mask = (ids % n) == e
            if not mask.any():
                continue
            local = ids[mask] // n
            _, _, rows, _ = self._call(ep, OP_PULL_ROWS, name, local)
            if rows is None:
                raise KeyError(
                    f"sparse table {name!r} shard {e} not on {ep}")
            if out is None:
                out = np.zeros((ids.size,) + rows.shape[1:], rows.dtype)
            out[mask] = rows
        if out is None:  # ids empty
            raise ValueError("pull_sparse with no ids")
        return out

    def config_sparse_optimizer(self, name, optimizer="adam", beta1=0.9,
                                beta2=0.999, epsilon=1e-8):
        """Install a server-resident optimizer on every shard of `name`
        (pslib analog: lookup_sparse_table_fuse_adam keeps per-row Adam
        moments ON the pserver, fleet_wrapper.h:66 pull/push contract)."""
        if optimizer not in ("sgd", "adam"):
            raise ValueError(f"sparse optimizer {optimizer!r}: sgd|adam")
        cfg = np.array([beta1, beta2, epsilon], np.float64)
        for ep in self.endpoints:
            self._call(ep, OP_CONFIG_SPARSE_OPT, name, cfg,
                       extra=1.0 if optimizer == "adam" else 0.0)

    def push_sparse(self, name, ids, grads, lr, grad_scale=1.0,
                    sync=False):
        """Scatter row grads back; the server applies its configured
        optimizer (sgd default, adam via config_sparse_optimizer).

        sync=True: the server accumulates until every live trainer's push
        arrives and applies the AVERAGE once — grad_scale is ignored and
        an empty push still goes to every shard so the fanin completes.
        grad_scale remains for the legacy async protocol only (callers
        that pre-scale their Hogwild pushes)."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        grads = np.asarray(grads)
        n = len(self.endpoints)
        op = OP_PUSH_ROWS_SYNC if sync else OP_PUSH_ROWS
        eff_lr = float(lr) * (1.0 if sync else float(grad_scale))
        for e, ep in enumerate(self.endpoints):
            mask = (ids % n) == e
            if not sync and not mask.any():
                continue
            local = ids[mask] // n
            vals = grads[mask] if grads.size else \
                np.zeros((0,) + grads.shape[1:], np.float32)

            def roundtrip(s, send, local=local, vals=vals):
                send(s, op, name, local, eff_lr)
                send(s, op, name, vals)
                return _recv_msg(s, self.stats)

            rop, rname, _, _ = self._with_retry(
                ep, roundtrip, idempotent=op not in self._NON_IDEMPOTENT)
            if rop == OP_ERROR:
                raise TimeoutError(rname)

    # -- named blocking queues (heter relay / enqueue-dequeue ops) ---------
    def q_push(self, name, value):
        """Push onto the named server queue (queue lives on the shard
        `name` hashes to, so all parties agree without coordination)."""
        self._call(self._ep_for(name), OP_QPUSH, name, np.asarray(value))

    def q_pop(self, name, timeout=60.0) -> np.ndarray:
        """Blocking pop; raises TimeoutError if nothing arrives within
        `timeout` (0 = non-blocking try-pop).

        The wait is a client-side loop of SHORT server-side waits, each
        far below sock_timeout: a single long server wait would race the
        socket timeout, and an element popped just after the client gave
        up would be written to a discarded socket — lost, leaving the
        relay off by one forever."""
        deadline = time.time() + float(timeout)
        chunk = max(1.0, min(10.0, self.sock_timeout / 4))
        while True:
            wait = min(chunk, max(deadline - time.time(), 0.0))
            try:
                _, _, arr, _ = self._call(self._ep_for(name), OP_QPOP,
                                          name, extra=wait)
                return arr
            except TimeoutError:
                if time.time() >= deadline:
                    raise TimeoutError(f"queue {name!r}: pop timed out")

    def barrier(self):
        for ep in self.endpoints:
            self._call(ep, OP_BARRIER)

    # -- trainer liveness (heart_beat_monitor.h parity) --------------------
    def start_heartbeat(self, trainer_id: int,
                        interval: float = 2.0) -> threading.Event:
        """Background thread pinging every pserver with this trainer's id;
        the server drops silent trainers from sync fanins.  Uses its own
        sockets (the client's aren't thread-safe).  Returns the stop
        Event (also stopped by close())."""
        if self._hb_stop is not None:
            return self._hb_stop
        stop = threading.Event()
        endpoints = list(self.endpoints)

        def loop():
            # short socket timeout: one hung pserver must not stall the
            # heartbeats to the healthy ones past heartbeat_timeout (which
            # would mark THIS live trainer dead on those servers)
            hb = KVClient(endpoints, sock_timeout=min(2.0, interval))
            try:
                while not stop.is_set():
                    for ep in endpoints:
                        try:
                            hb._call(ep, OP_HEARTBEAT,
                                     extra=float(trainer_id))
                        except (ConnectionError, OSError):
                            hb._socks.pop(ep, None)
                    stop.wait(interval)
            finally:
                hb.close()

        threading.Thread(target=loop, daemon=True).start()
        self._hb_stop = stop
        return stop

    def stop_heartbeat(self):
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_stop = None

    def shutdown_servers(self):
        for ep in list(self._socks) or self.endpoints:
            try:
                self._call(ep, OP_SHUTDOWN)
            except (ConnectionError, OSError):
                pass

    def close(self):
        self.stop_heartbeat()
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        self._socks.clear()
