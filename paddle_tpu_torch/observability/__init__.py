"""paddle_tpu_torch.observability — the telemetry tier.

Counterpart of paddle_tpu/observability/, whose three modules are pure
Python and copied here: journal lines and heartbeat records are the JAX
package's JSON, key for key, so either package's readers (and the fleet
control plane) read the other's files.  The legs:

  * structured run journal — `journal` (append-only per-rank JSONL;
    kill/resume timelines reconstruct post-hoc from the files alone)
  * Prometheus exposition — `core.monitor.prometheus_text`, served at
    /metrics on the inference server and via the trainer `sidecar`
  * rank heartbeats — `heartbeat` (per-step progress files; the
    launcher's stall deadline turns a wedged-in-a-dead-collective rank
    into a supervised teardown + elastic re-form)
"""
from . import journal  # noqa: F401
from . import heartbeat  # noqa: F401
from . import sidecar  # noqa: F401
from .journal import (  # noqa: F401
    RunJournal, emit, get_journal, set_journal_dir, read_journal,
    read_rank_journals, reconstruct_timeline, trainer_rank, JOURNAL_ENV,
)
from .heartbeat import (  # noqa: F401
    HeartbeatWriter, maybe_beat, read_heartbeats, stalled_ranks,
    HEARTBEAT_ENV, DEFAULT_STALL_TIMEOUT_S,
)
from .sidecar import (  # noqa: F401
    MetricsSidecar, start_metrics_server, METRICS_PORT_ENV,
)

__all__ = [
    "journal", "heartbeat", "sidecar",
    "RunJournal", "emit", "get_journal", "set_journal_dir",
    "read_journal", "read_rank_journals", "reconstruct_timeline",
    "trainer_rank", "JOURNAL_ENV",
    "HeartbeatWriter", "maybe_beat", "read_heartbeats", "stalled_ranks",
    "HEARTBEAT_ENV", "DEFAULT_STALL_TIMEOUT_S",
    "MetricsSidecar", "start_metrics_server", "METRICS_PORT_ENV",
]
