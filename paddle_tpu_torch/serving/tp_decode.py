"""tp-sharded decode: serve one model from N ranks of a process group.

Counterpart of paddle_tpu/serving/tp_decode.py.  ``build_decode_program``
builds the JAX package's decode-step program op for op (Megatron
column/row-parallel q/k/v/out and fc1/fc2 from
``distributed/tensor_parallel.py``, attention over ``num_heads / tp``
local heads, the per-layer KV cache fed head-sharded with
``dist_attr=["tp", 1]``, the new K/V columns ``c_concat``-gathered back to
global head order, the tied LM head), one program per ``(B, lc, W)``
bucket.

Who runs it.  The JAX decoder is one controller over a mesh.  The port
has one process a rank (``distributed.spawn`` / ``launch``), so the
decoder is a leader and its followers:

  * every rank constructs ``TPShardedDecoder(model, tp_degree)`` at the
    same point (the leader through ``ContinuousBatchingEngine(model,
    tp_degree=...)``): the constructor forms the dp x tp groups.  Only
    the leader's weights matter: each bucket's first run broadcasts them
    from rank 0 and cuts every rank's tp shard (CompiledProgram's start);
  * rank 0, the leader, owns the engine, the pool, the radix cache, the
    speculative draft and the HTTP server.  Its ``forward`` sends each
    call to the other ranks: a header (the bucket), the replicated feeds
    (``ids``, ``pos``, ``mask``) by broadcast and, point to point, only
    each rank's head slice of the cache feeds (all layers' K and V in one
    message).  Then it runs the bucket's step like every rank;
  * the other ranks run ``follow()``: receive, build the same bucket
    program, run the same CompiledProgram step, until the leader's
    ``stop()`` sends the stop header.  Retries, speculative rollback and
    radix adoption stay on the leader: only ``forward`` crosses, so every
    rank posts the same collectives in the same order.

The logits and the gathered K/V columns come back whole on the leader,
which rebuilds the per-layer caches at global head count on its device:
the engine's model contract (``config``, ``gen_cache``, ``_mask``,
``state_dict``, ``parameters``, ``device`` and the cache-aware
``forward``) with no ``.gpt`` attribute, as in the JAX class.

Under gloo, point-to-point CUDA tensors go through a host copy (gloo's
send and receive take CPU tensors); broadcasts take CUDA tensors.  Under
NCCL everything stays on the devices.  ``bytes_sent`` counts the cache
slices the leader sent the followers (``last_step_bytes`` the last
call's), ``bytes_received`` what a follower received, ``cache_bytes``
the leader's cache feeds whole (each rank is fed 1 / tp of them).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["TPShardedDecoder", "build_decode_program"]

_PFX = "tpdec_"
_RUN, _STOP = 1, 0


def _param_map(cfg) -> Dict[str, str]:
    """static param name -> dygraph state_dict key."""
    m = {_PFX + "wte": "wte.weight", _PFX + "wpe": "wpe.weight",
         _PFX + "lnf_w": "ln_f.weight", _PFX + "lnf_b": "ln_f.bias"}
    for li in range(cfg.num_layers):
        b = f"{_PFX}b{li}_"
        s = f"blocks.{li}."
        m[b + "ln1_w"] = s + "ln1.weight"
        m[b + "ln1_b"] = s + "ln1.bias"
        m[b + "ln2_w"] = s + "ln2.weight"
        m[b + "ln2_b"] = s + "ln2.bias"
        for p, d in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("o", "out_proj")):
            m[b + p + "_w"] = f"{s}attn.{d}.weight"
            m[b + p + "_b"] = f"{s}attn.{d}.bias"
        m[b + "fc1_w"] = s + "fc1.weight"
        m[b + "fc1_b"] = s + "fc1.bias"
        m[b + "fc2_w"] = s + "fc2.weight"
        m[b + "fc2_b"] = s + "fc2.bias"
    return m


def build_decode_program(cfg, batch: int, cache_len: int, width: int,
                         tp_degree: int):
    """Build ONE static decode-step program for a (B, lc, W) bucket.

    Feeds: ``ids``/``pos`` int64 [B, W] and ``mask`` float32
    [B, 1, W, lc+W] (stamped ``replicated_feed``); per-layer
    ``cache_k_{li}``/``cache_v_{li}`` float32 at the GLOBAL [B, H, lc, Dh]
    geometry, stamped ``dist_attr=["tp", 1]`` (each rank holds its
    [B, H/tp, lc, Dh] slice).  Fetches: ``logits`` [B, W, V] and per-layer
    ``kg_{li}``/``vg_{li}``, the layer's new K/V columns gathered back to
    [B, W, hidden] global feature order.  Returns ``(program, feed_names,
    fetch_names)``."""
    from ..core.program import Program, program_guard
    from ..static import layers
    from ..static.layer_helper import LayerHelper
    from ..static.param_attr import ParamAttr
    from ..distributed.tensor_parallel import (
        col_parallel_fc, row_parallel_fc, tp_identity, shard_param,
        TP_RING_ID, MP_AXIS)

    c = cfg
    tp = int(tp_degree)
    H, Dh = c.num_heads, c.hidden_size // c.num_heads
    if H % tp:
        raise ValueError(
            f"num_heads={H} must divide by tp_degree={tp} (attention "
            "heads shard whole onto tp ranks)")
    h_loc = H // tp
    B, lc, W = int(batch), int(cache_len), int(width)
    L = lc + W

    main, startup = Program(), Program()
    feed_names = ["ids", "pos", "mask"]
    kv_fetches = []
    with program_guard(main, startup):
        ids = layers.data("ids", [B, W], "int64")
        pos = layers.data("pos", [B, W], "int64")
        mask = layers.data("mask", [B, 1, W, L], "float32")
        for v in (ids, pos, mask):
            v.attrs["replicated_feed"] = True
        cache_feeds = []
        for li in range(c.num_layers):
            if lc:
                ck = layers.data(f"cache_k_{li}", [B, H, lc, Dh], "float32")
                cv = layers.data(f"cache_v_{li}", [B, H, lc, Dh], "float32")
                # head-dim shard: rank r holds heads r*h_loc..(r+1)*h_loc
                shard_param(ck, dim=1)
                shard_param(cv, dim=1)
                feed_names += [ck.name, cv.name]
                cache_feeds.append((ck, cv))
            else:
                cache_feeds.append(None)

        def _fix(z, shape):
            # re-anchor a shape inference gave up on (global/local mixes)
            # at the known runtime shape
            if z.shape is None:
                z.shape = tuple(shape)
                z.dtype = "float32"
            return z

        def _ln(x, name):
            return layers.layer_norm(
                x, begin_norm_axis=2, epsilon=1e-5,
                param_attr=ParamAttr(name=name + "_w"),
                bias_attr=ParamAttr(name=name + "_b"))

        def _split(z):  # [B, W, h_loc*Dh] local -> [B, h_loc, W, Dh]
            z = layers.reshape(z, [-1, W, h_loc, Dh])
            # the batch dim stays -1 (symbolic), as in the JAX package
            z.shape = (-1, W, h_loc, Dh)
            return layers.transpose(z, [0, 2, 1, 3])

        def _gather(z):
            # all-gather the column-sharded features back to global order
            # for the fetch; attention keeps consuming the shard
            helper = LayerHelper("kv_gather")
            out = helper.create_variable_for_type_inference(z.dtype)
            op = helper.append_op("c_concat", {"X": [z]}, {"Out": [out]},
                                  {"ring_id": TP_RING_ID})
            op.attrs["mp_axis"] = MP_AXIS
            if out.shape is None:
                out.shape = tuple(z.shape)
                out.dtype = z.dtype
            return out

        tok = layers.embedding(ids, size=[c.vocab_size, c.hidden_size],
                               param_attr=ParamAttr(name=_PFX + "wte"))
        posv = layers.embedding(pos, size=[c.max_position, c.hidden_size],
                                param_attr=ParamAttr(name=_PFX + "wpe"))
        x = layers.elementwise_add(tok, posv)

        for li in range(c.num_layers):
            pb = f"{_PFX}b{li}_"
            h = _ln(x, pb + "ln1")
            # ONE Megatron f-op shared by the q/k/v column projections
            xid = tp_identity(h, tp_degree=tp)
            proj = {}
            for p in ("q", "k", "v"):
                proj[p] = col_parallel_fc(
                    xid, c.hidden_size, num_flatten_dims=2,
                    param_attr=ParamAttr(name=pb + p + "_w"),
                    bias_attr=ParamAttr(name=pb + p + "_b"),
                    input_is_identity=True, tp_degree=tp,
                    name=f"b{li}_{p}")
            qh, kh, vh = (_split(proj[p]) for p in ("q", "k", "v"))
            if lc:
                ck, cv = cache_feeds[li]
                kc = layers.concat([ck, kh], axis=2)
                vc = layers.concat([cv, vh], axis=2)
                for z in (kc, vc):
                    z.shape = (B, h_loc, L, Dh)
                    z.dtype = "float32"
            else:
                kc, vc = kh, vh
            # matmul THEN scale, mask add, softmax: the dygraph
            # MultiHeadAttention score path, op for op
            scores = layers.matmul(qh, kc, transpose_y=True)
            if scores.shape is None:
                scores.shape = (B, h_loc, W, L)
                scores.dtype = "float32"
            scores = layers.scale(scores, scale=Dh ** -0.5)
            scores = layers.elementwise_add(scores, mask)
            wts = layers.softmax(scores, axis=-1)
            ctx = layers.matmul(wts, vc)
            if ctx.shape is None:
                ctx.shape = (B, h_loc, W, Dh)
                ctx.dtype = "float32"
            ctx = layers.transpose(ctx, [0, 2, 1, 3])
            ctx = layers.reshape(ctx, [-1, W, h_loc * Dh])
            ctx.shape = (B, W, h_loc * Dh)
            attn = row_parallel_fc(
                ctx, c.hidden_size, num_flatten_dims=2,
                in_features=c.hidden_size,
                param_attr=ParamAttr(name=pb + "o_w"),
                bias_attr=ParamAttr(name=pb + "o_b"),
                tp_degree=tp, name=f"b{li}_o")
            x = _fix(layers.elementwise_add(x, attn),
                     (B, W, c.hidden_size))
            h = _ln(x, pb + "ln2")
            f1 = col_parallel_fc(
                h, c.intermediate_size, num_flatten_dims=2,
                param_attr=ParamAttr(name=pb + "fc1_w"),
                bias_attr=ParamAttr(name=pb + "fc1_b"),
                tp_degree=tp, name=f"b{li}_fc1")
            g = layers.gelu(f1, approximate=False)
            f2 = row_parallel_fc(
                g, c.hidden_size, num_flatten_dims=2,
                in_features=c.intermediate_size,
                param_attr=ParamAttr(name=pb + "fc2_w"),
                bias_attr=ParamAttr(name=pb + "fc2_b"),
                tp_degree=tp, name=f"b{li}_fc2")
            x = _fix(layers.elementwise_add(x, f2),
                     (B, W, c.hidden_size))

            kv_fetches += [_gather(proj["k"]).name,
                           _gather(proj["v"]).name]

        xf = _ln(x, _PFX + "lnf")
        wte_w = main.global_block().var(_PFX + "wte")
        logits = layers.matmul(xf, wte_w, transpose_y=True)
    fetch_names = [logits.name] + kv_fetches
    return main, feed_names, fetch_names


class TPShardedDecoder:
    """Engine forward backend running decode tp-sharded over the ranks of
    the process group (module docstring: the leader and its followers).

    Exposes the engine's model contract, with the forward dispatched
    through per-bucket ``CompiledProgram``s whose world is dp x tp
    (dp = world / tp replicas, each computing the same batch).  Has NO
    ``.gpt`` attribute: the engine unwraps ``getattr(model, "gpt",
    model)`` and must keep the sharded backend."""

    def __init__(self, model, tp_degree: int, places=None,
                 weight_dtype: str = "float32"):
        from ..distributed.compiled_program import _World
        from ..static.executor import Executor, Scope
        from .int8_decode import _place_of
        inner = getattr(model, "gpt", model)
        # decode must be deterministic (dropout off) for the
        # token-equality contract with the single-device path
        inner.eval()
        self._inner = inner
        self.config = inner.config
        tp = int(tp_degree)
        if tp < 1:
            raise ValueError(f"tp_degree must be >= 1, got {tp}")
        if self.config.num_heads % tp:
            raise ValueError(
                f"num_heads={self.config.num_heads} must divide by "
                f"tp_degree={tp}")
        self.tp_degree = tp
        self.weight_dtype = str(weight_dtype)
        if self.weight_dtype not in ("float32", "int8"):
            raise ValueError(
                f"weight_dtype must be float32 or int8, got "
                f"{weight_dtype!r}")
        self._places = places
        self._scope = Scope()
        self._exe = Executor(_place_of(inner.device))
        # one dp x tp world (its groups) shared by every bucket's program;
        # forming it is collective: every rank constructs the decoder
        self._world = _World(tp)
        self.rank = 0 if self._world.whole is None else \
            torch.distributed.get_rank()
        self._programs: Dict[Tuple[int, int, int], Tuple] = {}
        self._stopped = False
        self.bytes_sent = 0
        self.bytes_received = 0
        self.cache_bytes = 0  # the leader's cache feeds, whole
        self.last_step_bytes = 0
        self.steps = 0
        self._install_weights()

    # -- engine model contract (delegated) ------------------------------
    @property
    def device(self) -> torch.device:
        return self._inner.device

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def gen_cache(self, batch_size):
        return self._inner.gen_cache(batch_size)

    def _mask(self, seq):
        return self._inner._mask(seq)

    def state_dict(self, *a, **kw):
        return self._inner.state_dict(*a, **kw)

    def parameters(self, *a, **kw):
        return self._inner.parameters(*a, **kw)

    def eval(self):
        self._inner.eval()
        return self

    @property
    def buckets_compiled(self) -> int:
        return len(self._programs)

    # -- weights --------------------------------------------------------
    def _install_weights(self):
        sd = self._inner.state_dict()
        for pname, key in _param_map(self.config).items():
            self._scope.set(pname, sd[key].detach().float().clone())

    def shard_bytes(self) -> Dict[str, int]:
        """Bytes of this rank's decode weights in its scope, by
        placement: ``sharded`` (the tp-sharded projections, and their
        int8 copies and scales under weight_dtype="int8") and
        ``replicated`` (embeddings, LayerNorms, the row-parallel biases),
        and ``sharded_whole``, the bytes of the sharded ones whole.  Read
        after the first forward, when the scope holds the shards."""
        out = {"sharded": 0, "replicated": 0, "sharded_whole": 0}
        seen = set()
        for prog, _, _ in self._programs.values():
            block = prog._program.global_block()
            for n, v in block.vars.items():
                if not v.persistable or n in seen:
                    continue
                seen.add(n)
                t = self._scope.get(n)
                if t is None:
                    continue
                n_bytes = t.numel() * t.element_size()
                if v.attrs.get("dist_attr"):
                    out["sharded"] += n_bytes
                    whole = 1
                    for d in v.shape:
                        whole *= int(d)
                    out["sharded_whole"] += whole * t.element_size()
                else:
                    out["replicated"] += n_bytes
        return out

    def _program_for(self, B: int, lc: int, W: int):
        key = (B, lc, W)
        hit = self._programs.get(key)
        if hit is None:
            from ..distributed.compiled_program import (CompiledProgram,
                                                        BuildStrategy)
            prog, feeds, fetches = build_decode_program(
                self.config, B, lc, W, self.tp_degree)
            if self.weight_dtype == "int8":
                # weight-only stamp: q/k/v/out-proj/fc products become
                # int8_matmul over GLOBALLY-quantized per-out-channel
                # weights; deterministic ".int8"/".deq_scale" names, so
                # every bucket shares one quantized scope copy (the tied
                # logits matmul stays fp32: its transpose_y excludes it)
                from ..slim.quantization import freeze_weights_int8
                freeze_weights_int8(prog, self._scope)
            bs = BuildStrategy()
            bs.tensor_parallel_degree = self.tp_degree
            compiled = CompiledProgram(prog, build_strategy=bs)
            compiled._world = self._world
            if self._places is not None:
                compiled._places = list(self._places)
            hit = (compiled, feeds, fetches)
            self._programs[key] = hit
        return hit

    # -- the wire between the leader and its followers -------------------
    def _followers(self):
        if self._world.whole is None:
            return []
        return list(range(1, self._world.size))

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        dist.broadcast(t, src=0, group=self._world.whole)
        return t

    def _gloo(self) -> bool:
        import torch.distributed as dist
        return dist.get_backend(self._world.whole) == "gloo"

    def _send(self, t: torch.Tensor, dst: int):
        import torch.distributed as dist
        t = t.contiguous()
        if t.is_cuda and self._gloo():
            t = t.cpu()
        dist.send(t, dst=dst, group=self._world.whole)
        n = t.numel() * t.element_size()
        self.bytes_sent += n
        self.last_step_bytes += n

    def _recv(self, shape, dtype) -> torch.Tensor:
        import torch.distributed as dist
        dev = self.device
        stage = dev.type == "cuda" and self._gloo()
        t = torch.empty(shape, dtype=dtype,
                        device="cpu" if stage else dev)
        dist.recv(t, src=0, group=self._world.whole)
        self.bytes_received += t.numel() * t.element_size()
        return t.to(dev) if stage else t

    def _head_slice(self, t: torch.Tensor, tp_index: int) -> torch.Tensor:
        h = self.config.num_heads // self.tp_degree
        return t.narrow(1, tp_index * h, h)

    # -- forward --------------------------------------------------------
    def _run(self, B, lc, W, feed):
        compiled, _feeds, fetches = self._program_for(B, lc, W)
        out = compiled._run_local(self._exe, feed, fetches, self._scope)
        self.steps += 1
        return out

    def forward(self, input_ids, cache=None, pos_offset=None,
                attn_mask=None):
        from ..nn import MultiHeadAttention
        if not self.is_leader:
            raise RuntimeError("only the leader (rank 0) calls forward; "
                               "the other ranks run follow()")
        if self._stopped:
            raise RuntimeError("the decoder's followers were stopped")
        if cache is None:
            # plain LM forward (no decode cache): the leader's model
            return self._inner(input_ids, pos_offset=pos_offset,
                               attn_mask=attn_mask)
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        B, W = int(ids.shape[0]), int(ids.shape[1])
        lc = int(cache[0].k.shape[2])
        if pos_offset is None:
            off = torch.zeros(B, dtype=torch.int64, device=dev)
        else:
            off = torch.as_tensor(pos_offset, dtype=torch.int64,
                                  device=dev).reshape(-1).expand(B)
        pos = off[:, None] + torch.arange(W, dtype=torch.int64,
                                          device=dev)[None]
        m = self._inner._mask(W) if attn_mask is None else \
            torch.as_tensor(attn_mask, device=dev).float()
        if m.dim() == 2:   # the model's [S, S] causal mask (lc == 0)
            m = m[None, None]
        m = m.expand(B, 1, W, lc + W).contiguous()
        L = self.config.num_layers
        self.last_step_bytes = 0
        followers = self._followers()
        if followers:
            self._bcast(torch.tensor([_RUN, B, lc, W], dtype=torch.int64,
                                     device=dev))
            self._bcast(torch.stack([ids, pos]).contiguous())
            self._bcast(m)
            if lc:
                for r in followers:
                    t = r % self.tp_degree
                    self._send(torch.stack(
                        [self._head_slice(x, t) for c in cache
                         for x in (c.k, c.v)]), r)
        self.cache_bytes += sum(x.numel() * x.element_size()
                                for c in cache for x in (c.k, c.v))
        t0 = self._world.tp_index
        feed = {"ids": ids, "pos": pos, "mask": m}
        if lc:
            for li, c in enumerate(cache):
                feed[f"cache_k_{li}"] = self._head_slice(c.k, t0)
                feed[f"cache_v_{li}"] = self._head_slice(c.v, t0)
        outs = self._run(B, lc, W, feed)
        logits = outs[0]
        H = self.config.num_heads
        Dh = self.config.hidden_size // H
        new_caches = []
        for li in range(L):
            k_new = outs[1 + 2 * li].reshape(B, W, H, Dh).transpose(1, 2)
            v_new = outs[2 + 2 * li].reshape(B, W, H, Dh).transpose(1, 2)
            new_caches.append(MultiHeadAttention.Cache(
                torch.cat([cache[li].k, k_new], dim=2),
                torch.cat([cache[li].v, v_new], dim=2)))
        return logits, new_caches

    __call__ = forward

    def follow(self) -> int:
        """A follower's loop: run every step the leader sends until its
        stop message.  Returns the number of steps run."""
        if self.is_leader:
            raise RuntimeError("the leader (rank 0) does not follow")
        dev = self.device
        c = self.config
        L, h_loc = c.num_layers, c.num_heads // self.tp_degree
        Dh = c.hidden_size // c.num_heads
        n = 0
        while True:
            hdr = self._bcast(torch.zeros(4, dtype=torch.int64, device=dev))
            cmd, B, lc, W = (int(v) for v in hdr.tolist())
            if cmd == _STOP:
                self._stopped = True
                return n
            idpos = self._bcast(torch.zeros((2, B, W), dtype=torch.int64,
                                            device=dev))
            m = self._bcast(torch.zeros((B, 1, W, lc + W),
                                        dtype=torch.float32, device=dev))
            feed = {"ids": idpos[0], "pos": idpos[1], "mask": m}
            if lc:
                kv = self._recv((2 * L, B, h_loc, lc, Dh), torch.float32)
                for li in range(L):
                    feed[f"cache_k_{li}"] = kv[2 * li]
                    feed[f"cache_v_{li}"] = kv[2 * li + 1]
            self._run(B, lc, W, feed)
            n += 1

    def stop(self):
        """The leader ends its followers' loops (idempotent; a decoder
        without followers has nothing to stop)."""
        if self._stopped or not self.is_leader:
            return
        self._stopped = True
        if self._followers():
            self._bcast(torch.tensor([_STOP, 0, 0, 0], dtype=torch.int64,
                                     device=self.device))
