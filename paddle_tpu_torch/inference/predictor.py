"""Predictor: load -> inference passes -> (bf16 rewrite) -> run.

Counterpart of paddle_tpu/inference/predictor.py (Config / Predictor /
create_predictor / ZeroCopyTensor, the AnalysisPredictor surface).  The
model directory is the same; the program runs on the port's eager
executor, on the GPU by default: `Config` selects CUDAPlace(device_id)
as the reference's `Config._use_xla = True` selects its accelerator, and
`Config.disable_gpu()` selects the CPU.  With no CUDA device and no CPU
request, creating a Predictor raises.

`Config.enable_bfloat16()` (or `enable_tensorrt_engine(precision_mode=
PrecisionType.Bfloat16)`) runs the AMP rewrite (`amp.rewrite_program`)
on the program after the passes, as the JAX Predictor does: white ops
(matmuls, fc, flash_attention) run in bf16, black ones (and ops on no
list, such as fused_embedding_eltwise_layernorm) in fp32.  numpy has no
bfloat16, so a bf16 fetch comes back as its exact float32 upcast (the
JAX package returns ml_dtypes bfloat16 arrays: equal values, another
dtype).

Under PADDLE_TPU_VERIFY the program after the pipeline is self-checked
(`static.verifier.self_check`, pass name "inference_pipeline"), as in the
JAX Predictor.  The JAX Predictor's pow2 feed bucketing
bounded jit retraces; the eager executor has none to bound, so a request
batch runs at its own size.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ..core.place import CPUPlace, CUDAPlace
from ..ops.kernels.quantize import column_major
from .passes import apply_passes, PassContext, DEFAULT_INFERENCE_PASSES

__all__ = ["Config", "AnalysisConfig", "Predictor", "create_predictor",
           "ZeroCopyTensor", "PrecisionType"]


class PrecisionType:
    Float32 = 0
    Int8 = 1
    Half = 2
    Bfloat16 = 3


class Config:
    """AnalysisConfig parity (inference/api/paddle_analysis_config.h)."""

    Precision = PrecisionType

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._use_gpu = True
        self._device_id = 0
        self._ir_optim = True
        self._passes = list(DEFAULT_INFERENCE_PASSES)
        self._deleted_passes = set()
        self._precision = PrecisionType.Float32

    # -- device --------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def gpu_device_id(self):
        return self._device_id

    def place(self):
        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()

    # -- precision -----------------------------------------------------------
    def enable_tensorrt_engine(self, workspace_size=1 << 30,
                               max_batch_size=1, min_subgraph_size=3,
                               precision_mode=PrecisionType.Float32,
                               use_static=False, use_calib_mode=False):
        """No TensorRT here: the precision request is honoured (Bfloat16
        runs the AMP rewrite after the passes); the other knobs are
        accepted and unused, as in the JAX package."""
        self._precision = precision_mode

    def enable_bfloat16(self):
        self._precision = PrecisionType.Bfloat16

    def precision_mode(self):
        return self._precision

    # -- pass control (paddle_pass_builder parity) --------------------------
    def switch_ir_optim(self, on=True):
        self._ir_optim = on

    def ir_optim(self):
        return self._ir_optim

    def delete_pass(self, name):
        self._deleted_passes.add(name)

    def pass_builder(self):
        return self

    def switch_use_feed_fetch_ops(self, on):
        pass  # feed/fetch ops never exist in this executor

    def switch_specify_input_names(self, on=True):
        pass

    def set_model(self, model_dir_or_prog, params_file=None):
        if params_file is None:
            self._model_dir = model_dir_or_prog
        else:
            self._prog_file = model_dir_or_prog
            self._params_file = params_file

    def model_dir(self):
        return self._model_dir


AnalysisConfig = Config


class ZeroCopyTensor:
    """Input/output handle: numpy in, numpy out."""

    def __init__(self, name, predictor, is_input):
        self._name = name
        self._predictor = predictor
        self._is_input = is_input

    def name(self):
        return self._name

    def reshape(self, shape):
        pass  # shapes flow from copy_from_cpu

    def copy_from_cpu(self, arr):
        self._predictor._inputs[self._name] = np.asarray(arr)

    def copy_to_cpu(self):
        return np.asarray(self._predictor._outputs[self._name])

    def shape(self):
        src = self._predictor._inputs if self._is_input \
            else self._predictor._outputs
        return list(np.shape(src[self._name]))


class Predictor:
    """AnalysisPredictor parity over the eager executor."""

    def __init__(self, config: Config, _shared=None):
        from ..static.executor import Executor
        self._config = config
        self._inputs: Dict[str, np.ndarray] = {}
        self._outputs: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._exe = Executor(config.place())
        self._pass_stats: Dict[str, int] = {}
        if _shared is not None:
            (self._program, self._scope, self._feed_names,
             self._fetch_names) = _shared
            return
        self._load_and_optimize()

    def _load_and_optimize(self):
        from ..static.executor import Scope, scope_guard
        from ..io.framework_io import load_inference_model
        self._scope = Scope()
        model_dir = self._config._model_dir
        prog_file = self._config._prog_file
        params_file = self._config._params_file
        # the reference spellings: Config(model_dir) -> dir with __model__;
        # Config(prog_file, params_file) -> explicit file paths
        if model_dir and os.path.isfile(model_dir):
            prog_file, params_file = model_dir, prog_file
            model_dir = None
        if model_dir is None and prog_file:
            model_dir = os.path.dirname(prog_file) or "."
            prog_file = os.path.basename(prog_file)
            if params_file:
                pdir = os.path.dirname(params_file)
                params_file = os.path.basename(params_file) \
                    if (not pdir or os.path.abspath(pdir)
                        == os.path.abspath(model_dir)) \
                    else os.path.abspath(params_file)
        with scope_guard(self._scope):
            prog, feed_names, fetch_targets = load_inference_model(
                model_dir, self._exe, model_filename=prog_file,
                params_filename=params_file)
        self._feed_names = feed_names
        self._fetch_names = [t.name for t in fetch_targets]
        if self._config._ir_optim:
            names = [p for p in self._config._passes
                     if p not in self._config._deleted_passes]
            ctx = PassContext(scope=self._scope)
            prog = apply_passes(prog, names, ctx)
            self._pass_stats = ctx.stats
            # passes may rename pruned-through fetch targets
            self._fetch_names = list(getattr(prog, "_fetch_names",
                                             self._fetch_names))
        # int8_matmul's product takes its weight column-major: lay each
        # int8 weight out so once here, not on every run
        for op in prog.global_block().ops:
            if op.type == "int8_matmul":
                w = op.inputs["W"][0]
                self._scope.set(w, column_major(self._scope.get(w)))
        if self._config._precision == PrecisionType.Bfloat16:
            from ..amp import rewrite_program
            rewrite_program(prog)  # self-checks as pass "amp"
        else:
            # env-gated post-pipeline verification (PADDLE_TPU_VERIFY):
            # the inference folds rewrite weights AND graph together, so
            # a broken fold should fail at load, not at the first
            # /predict.  (On the bf16 branch rewrite_program just ran
            # the same full check — don't walk the IR twice.)
            from ..static.verifier import self_check
            self_check(prog, "inference_pipeline")
        self._program = prog

    @property
    def place(self):
        return self._exe.place

    # -- 2.x API ------------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_handle(self, name) -> ZeroCopyTensor:
        return ZeroCopyTensor(name, self, True)

    def get_output_handle(self, name) -> ZeroCopyTensor:
        return ZeroCopyTensor(name, self, False)

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """2.x run(): positional inputs optional (else copy_from_cpu).
        Returns numpy outputs when inputs are given."""
        if inputs is not None:
            for n, a in zip(self._feed_names, inputs):
                self._inputs[n] = np.asarray(a)
        block = self._program.global_block()
        fetch_vars = [block.var(n) for n in self._fetch_names]
        with self._lock:
            res = self._exe.run(self._program, feed=dict(self._inputs),
                                fetch_list=fetch_vars, scope=self._scope)
        self._outputs = dict(zip(self._fetch_names, res))
        if inputs is not None:
            return list(res)
        return True

    def clone(self):
        """Per-thread clone sharing weights (analysis_predictor Clone)."""
        return Predictor(self._config,
                         _shared=(self._program, self._scope,
                                  self._feed_names, self._fetch_names))

    def zero_copy_run(self):
        return self.run(None)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
