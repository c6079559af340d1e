"""Pipeline parallelism: the program cut into stages on `device_guard`
and run under the GPipe schedule (pipeline_program.py), through
PipelineOptimizer or fleet's `strategy.pipeline` (pipeline_optimizer.py).
Counterpart of paddle_tpu/pipeline/."""
from .pipeline_program import PipelineCompiledProgram, assign_stages  # noqa: F401
from .pipeline_optimizer import PipelineOptimizer  # noqa: F401
