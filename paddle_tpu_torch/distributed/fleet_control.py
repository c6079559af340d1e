"""Fleet control plane — cross-host elastic re-form over a shared filesystem.

Counterpart of paddle_tpu/distributed/fleet_control.py (a copy: it is
pure Python).  The records it writes (membership, proposals, commits,
barriers) are the JAX package's JSON, so either package's launchers and
readers share a fleet directory.  ``launch.py --elastic`` tears a broken
pod down and relaunches it at the largest power-of-two divisor of the
logical world the survivors can fill.  A lost HOST is a fleet problem:
every surviving launcher must independently reach the SAME conclusions
(who is still here, what world do we re-form to, which checkpoint step
do we resume from) or the re-formed job is a chimera of disagreeing
worlds.

This module is that coordination layer.  It deliberately has no network
server: a multi-host job mounts a shared filesystem for checkpoints
(NFS, a cloud bucket through fuse), and the checkpoint tier's atomic-commit primitives
(``checkpoint/atomic.py``) already make that filesystem a correct
rendezvous medium — a reader never sees a torn record, and rename
publishes are ordered.  TorchElastic reaches the same agreement through
an etcd/c10d store; the artifact carried per host here is the same
(epoch-stamped membership + a committed survivor set).

Three sub-protocols:

**Membership** — every launcher maintains ``member.host<h>.json``
(atomic write, refreshed each supervision tick) carrying its host id,
capacity (local devices it can contribute), current fleet epoch, pid
and wall-clock.  Liveness is the record's age — a lost host simply
stops refreshing — PLUS the trainer heartbeat files
(``observability/heartbeat.py``): a host whose launcher still refreshes
but whose every trainer heartbeat went stale past the stall deadline is
wedged-in-a-dead-collective and counts as lost too.

**Two-phase survivor agreement** — on member loss (or initial
formation) each live launcher:

  1. *proposes*: writes ``propose.e<E>.host<h>.json`` with the survivor
     set it observes, the re-formed world (largest pow2 divisor of the
     LOGICAL world the survivors' capacity fills), and the restore
     step; then
  2. *commits*: when every proposed member has filed an IDENTICAL
     proposal for epoch E, the lowest-id member (the coordinator)
     publishes ``commit.e<E>.json``; everyone else adopts the committed
     record (first write wins — a racing coordinator re-reads instead
     of overwriting).  A host dying mid-agreement makes the proposals
     disagree; the survivors re-observe and re-propose the smaller set
     at the same epoch, which converges because liveness loss is
     monotone within an epoch.

**Restore-step agreement** — the committed record carries the newest
MUTUALLY-VISIBLE checkpoint step, computed from the run journals
(``observability/journal.py``): `reconstruct_timeline` — a post-hoc
forensic tool — is used LIVE here, folding each surviving
rank's journal into its incarnation story and intersecting the steps
every survivor staged (``checkpoint_save``) with the steps some rank
published (``checkpoint_commit``).  A step one survivor never staged
cannot be restored rank-merged; a step staged everywhere but never
committed is a torn artifact.

The committed record is exported to workers as the
``PADDLE_TPU_FLEET_*`` env contract (`fleet_env` parses it back), and
`CheckpointManager.load_merged` (checkpoint/manager.py) closes the
loop: the re-formed world reads ALL of the old world's per-rank shard
manifests and reassembles rank-complete state.

Observability: ``fleet.members`` / ``fleet.epoch`` /
``fleet.reform_count`` gauges through ``core/monitor`` (Prometheus
exposition included) and a ``reform`` event in the run journal per
committed (re-)formation.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence

__all__ = [
    "FLEET_DIR_ENV", "FleetAgreementTimeout", "FleetCommit",
    "FleetController", "FleetBarrier", "FleetEnv", "fleet_env",
    "fleet_rank", "fleet_world_size", "write_member", "read_members",
    "live_members", "propose_reform", "read_proposals", "read_commit",
    "newest_mutual_checkpoint_step",
]

FLEET_DIR_ENV = "PADDLE_TPU_FLEET_DIR"

# the full worker-side contract (launch.py exports these; fleet_env reads
# them back in the trainer)
ENV_DIR = FLEET_DIR_ENV
ENV_EPOCH = "PADDLE_TPU_FLEET_EPOCH"
ENV_HOST = "PADDLE_TPU_FLEET_HOST_ID"
ENV_HOSTS = "PADDLE_TPU_FLEET_HOSTS"
ENV_WORLD = "PADDLE_TPU_FLEET_WORLD"
ENV_LOGICAL = "PADDLE_TPU_FLEET_LOGICAL_WORLD"
ENV_RESTORE_STEP = "PADDLE_TPU_FLEET_RESTORE_STEP"
ENV_LAUNCHER_PID = "PADDLE_TPU_FLEET_LAUNCHER_PID"

# controller journal streams must not collide with trainer ranks: rank
# 900+h is the fleet-controller namespace (read_rank_journals still
# parses it; newest_mutual_checkpoint_step only reads the ranks asked)
CONTROLLER_RANK_BASE = 900

DEFAULT_MEMBER_TIMEOUT_S = 20.0


class FleetAgreementTimeout(RuntimeError):
    """The two-phase survivor agreement did not converge in time."""


class FleetCommit(dict):
    """The committed (re-)formation record: plain dict with attribute
    sugar for the fields every consumer reads."""

    @property
    def epoch(self) -> int:
        return int(self["epoch"])

    @property
    def members(self) -> List[int]:
        return [int(h) for h in self["members"]]

    @property
    def world(self) -> int:
        return int(self["world"])

    @property
    def restore_step(self) -> Optional[int]:
        s = self.get("restore_step")
        return None if s is None else int(s)


def fleet_world_size(capacity: int, logical_world: int) -> int:
    """Largest power-of-two divisor of `logical_world` that `capacity`
    surviving chips can fill — the same re-form math launch.py applies
    to a single host's survivors, lifted to the fleet."""
    if capacity < 1:
        return 0
    w = 1
    while w * 2 <= capacity and logical_world % (w * 2) == 0:
        w *= 2
    return w


def fleet_rank(host: int, members: Sequence[int]) -> int:
    """This host's rank in the CURRENT formation — its index in the
    sorted member list.  Host ids are stable across re-forms; ranks are
    dense per formation (the CheckpointManager rank/world contract)."""
    ordered = sorted(int(h) for h in members)
    return ordered.index(int(host))


# ---------------------------------------------------------------------------
# membership files
# ---------------------------------------------------------------------------
def _member_path(directory: str, host: int) -> str:
    return os.path.join(directory, f"member.host{int(host)}.json")


def _write_json(path: str, record: dict) -> None:
    from ..checkpoint.atomic import atomic_write
    with atomic_write(path, mode="w", fsync=False) as f:
        json.dump(record, f, sort_keys=True)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # racing an atomic replace / not yet written


def write_member(directory: str, host: int, capacity: int, epoch: int,
                 ranks: Sequence[int] = (), **fields) -> dict:
    """Write (or refresh) this host's epoch-stamped membership record.
    Atomic via checkpoint/atomic.py — a peer reading concurrently sees
    the previous complete record, never a torn one."""
    os.makedirs(directory, exist_ok=True)
    rec = {"host": int(host), "capacity": int(capacity),
           "epoch": int(epoch), "ranks": [int(r) for r in ranks],
           "pid": os.getpid(), "t": time.time()}
    rec.update(fields)
    _write_json(_member_path(directory, host), rec)
    return rec


def read_members(directory: str) -> Dict[int, dict]:
    """host -> last complete membership record."""
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("member.host") and name.endswith(".json")):
            continue
        rec = _read_json(os.path.join(directory, name))
        if rec is not None and "host" in rec:
            out[int(rec["host"])] = rec
    return out


def live_members(directory: str, timeout_s: float = DEFAULT_MEMBER_TIMEOUT_S,
                 heartbeat_dir: Optional[str] = None,
                 stall_timeout_s: Optional[float] = None,
                 now: Optional[float] = None) -> Dict[int, dict]:
    """Members whose record is fresh — a lost host stops refreshing and
    ages out.  With `heartbeat_dir` + `stall_timeout_s`, a host whose
    launcher still refreshes but whose EVERY trainer heartbeat is stale
    past the deadline is dropped too (wedged in a dead collective:
    alive-looking, making no progress)."""
    now = time.time() if now is None else now
    out = {}
    for host, rec in read_members(directory).items():
        if rec.get("status") == "done":
            continue  # cleanly departed: not live, and never "lost"
        if now - float(rec.get("t", 0)) > timeout_s:
            continue
        if heartbeat_dir and stall_timeout_s and rec.get("ranks"):
            from ..observability.heartbeat import stalled_ranks
            ranks = [int(r) for r in rec["ranks"]]
            stalled = stalled_ranks(heartbeat_dir, float(stall_timeout_s),
                                    ranks=ranks, now=now)
            if len(stalled) == len(ranks):
                continue
        out[host] = rec
    return out


# ---------------------------------------------------------------------------
# two-phase survivor agreement
# ---------------------------------------------------------------------------
def _propose_path(directory: str, epoch: int, host: int) -> str:
    return os.path.join(directory, f"propose.e{int(epoch)}.host{int(host)}.json")


def _commit_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"commit.e{int(epoch)}.json")


def propose_reform(directory: str, host: int, epoch: int,
                   members: Sequence[int], world: int,
                   restore_step: Optional[int]) -> dict:
    """Phase 1: publish this host's view of the epoch-E formation.
    Re-proposing (after the observed set changed) atomically replaces
    the previous proposal."""
    rec = {"host": int(host), "epoch": int(epoch),
           "members": sorted(int(h) for h in members), "world": int(world),
           "restore_step": (None if restore_step is None
                            else int(restore_step)),
           "t": time.time()}
    _write_json(_propose_path(directory, epoch, host), rec)
    return rec


def read_proposals(directory: str, epoch: int) -> Dict[int, dict]:
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    prefix = f"propose.e{int(epoch)}.host"
    for name in names:
        if not (name.startswith(prefix) and name.endswith(".json")):
            continue
        rec = _read_json(os.path.join(directory, name))
        if rec is not None and "host" in rec:
            out[int(rec["host"])] = rec
    return out


def read_commit(directory: str, epoch: int) -> Optional[FleetCommit]:
    rec = _read_json(_commit_path(directory, epoch))
    return FleetCommit(rec) if rec else None


def _proposal_key(rec: dict):
    return (tuple(rec["members"]), int(rec["world"]), rec.get("restore_step"))


# ---------------------------------------------------------------------------
# restore-step agreement off the run journals
# ---------------------------------------------------------------------------
def newest_mutual_checkpoint_step(journal_dir: str,
                                  ranks: Sequence[int]) -> Optional[int]:
    """The newest checkpoint step every surviving rank can restore from,
    derived LIVE from the run journals: `reconstruct_timeline` folds
    each rank's event stream into its incarnation story, and a step
    qualifies when every rank in `ranks` STAGED it (``checkpoint_save``
    across any incarnation) and at least one rank PUBLISHED it
    (``checkpoint_commit`` — in the multi-host layout only rank 0
    commits).  Returns None when no step qualifies (fresh start)."""
    from ..observability.journal import read_journal, reconstruct_timeline
    staged_per_rank: List[set] = []
    committed: set = set()
    for rank in ranks:
        path = os.path.join(journal_dir, f"journal.rank{int(rank)}.jsonl")
        try:
            events = read_journal(path)
        except OSError:
            return None  # a survivor with no journal has nothing staged
        timeline = reconstruct_timeline(events)
        staged: set = set()
        for inc in timeline["incarnations"]:
            staged.update(int(s) for s in inc.get("saves", ())
                          if s is not None)
            committed.update(int(s) for s in inc.get("commits", ())
                             if s is not None)
        staged_per_rank.append(staged)
    if not staged_per_rank:
        return None
    mutual = set.intersection(*staged_per_rank) & committed
    return max(mutual) if mutual else None


# ---------------------------------------------------------------------------
# cross-host barrier (shared-fs; the CheckpointManager publish barrier)
# ---------------------------------------------------------------------------
class FleetBarrier:
    """Zero-arg callable barrier over the fleet dir, usable as the
    ``barrier=`` argument of ``Executor.enable_checkpointing`` so
    multi-host periodic checkpoints PUBLISH during the run (save → wait
    → barrier → rank-0 commit) instead of staying staged.

    Every member must call it the same number of times in the same
    order (periodic checkpoint cadence is deterministic, so this
    holds); call ``n`` of epoch E synchronizes on
    ``barrier.e<E>.n<n>/host<h>`` marker files."""

    def __init__(self, directory: str, host: int, members: Sequence[int],
                 epoch: int = 0, timeout_s: float = 120.0,
                 poll_s: float = 0.02):
        self.dir = directory
        self.host = int(host)
        self.members = sorted(int(h) for h in members)
        self.epoch = int(epoch)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self._n = 0

    def __call__(self) -> None:
        self._n += 1
        d = os.path.join(self.dir, f"barrier.e{self.epoch}.n{self._n}")
        os.makedirs(d, exist_ok=True)
        mine = os.path.join(d, f"host{self.host}")
        with open(mine, "w") as f:
            f.write(str(time.time()))
        deadline = time.monotonic() + self.timeout_s
        want = {f"host{h}" for h in self.members}
        while True:
            try:
                have = set(os.listdir(d))
            except OSError:
                have = set()
            if want <= have:
                break
            if time.monotonic() > deadline:
                raise FleetAgreementTimeout(
                    f"fleet barrier {d} timed out: have "
                    f"{sorted(have)}, want {sorted(want)}")
            time.sleep(self.poll_s)
        # best-effort GC of the previous round (everyone has passed it)
        prev = os.path.join(self.dir,
                            f"barrier.e{self.epoch}.n{self._n - 1}")
        if self._n > 1 and os.path.isdir(prev):
            import shutil
            shutil.rmtree(prev, ignore_errors=True)


# ---------------------------------------------------------------------------
# the controller (one per launcher)
# ---------------------------------------------------------------------------
class FleetController:
    """One launcher's handle on the fleet: membership refresh, loss
    detection, and the two-phase (re-)formation agreement.

    Typical launcher loop (launch.py drives this)::

        ctl = FleetController(dir, host=h, capacity=4, logical_world=8)
        commit = ctl.form(expect=(0, 1))          # initial rendezvous
        ...spawn trainers with ctl.env_for_workers(commit)...
        while supervising:
            ctl.tick(ranks=my_trainer_ranks)      # refresh membership
            lost = ctl.lost_members(commit)
            if lost: teardown(); commit = ctl.reform(commit); respawn()
    """

    def __init__(self, directory: str, host: int, capacity: int,
                 logical_world: int,
                 member_timeout_s: float = DEFAULT_MEMBER_TIMEOUT_S,
                 journal_dir: Optional[str] = None,
                 heartbeat_dir: Optional[str] = None,
                 stall_timeout_s: Optional[float] = None,
                 agreement_timeout_s: float = 120.0,
                 poll_s: float = 0.05):
        self.dir = str(directory)
        self.host = int(host)
        self.capacity = int(capacity)
        self.logical_world = int(logical_world)
        self.member_timeout_s = float(member_timeout_s)
        self.journal_dir = journal_dir
        self.heartbeat_dir = heartbeat_dir
        self.stall_timeout_s = stall_timeout_s
        self.agreement_timeout_s = float(agreement_timeout_s)
        self.poll_s = float(poll_s)
        self.epoch = 0
        self.reform_count = 0
        self.ranks: List[int] = []
        self._last_refresh = 0.0
        self._journal = None
        os.makedirs(self.dir, exist_ok=True)

    # -- membership ---------------------------------------------------------
    def reset_rendezvous(self) -> None:
        """Sweep a PREVIOUS run's protocol files before the initial
        formation (the launcher calls this once at startup).  A reused
        ``--fleet_dir`` would otherwise poison the new run: a stale
        ``commit.e<E>`` is adopted verbatim by `form` (stale members,
        stale restore step), stale proposals trip `reform_requested`,
        stale barrier markers let a fresh `FleetBarrier` pass before
        the peers staged, and a previous run's ``status=done``
        membership permanently excludes a returning host.

        Safe against the CURRENT run's rendezvous: the initial `form`
        waits for every expected host's fresh membership before anyone
        proposes or commits, and each host sweeps before writing its
        own record — so any commit visible during a sweep is stale by
        construction, and a swept current-run proposal is simply
        rewritten on the next agreement iteration.  One fleet per
        directory."""
        import shutil
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for name in names:
            path = os.path.join(self.dir, name)
            try:
                if name.startswith(("propose.", "commit.")):
                    os.unlink(path)
                elif name.startswith("barrier."):
                    shutil.rmtree(path, ignore_errors=True)
                elif name.startswith("member.host"):
                    rec = _read_json(path)
                    if rec is None or rec.get("status") == "done" or \
                            time.time() - float(rec.get("t", 0)) \
                            > self.member_timeout_s:
                        os.unlink(path)
            except OSError:
                pass  # racing a peer's sweep of the same stale file

    def tick(self, ranks: Optional[Sequence[int]] = None,
             min_interval_s: float = 0.25) -> None:
        """Refresh this host's membership record (rate-limited; the
        launcher calls this every supervision poll)."""
        if ranks is not None:
            self.ranks = [int(r) for r in ranks]
        now = time.time()
        if now - self._last_refresh < min_interval_s:
            return
        self._last_refresh = now
        write_member(self.dir, self.host, self.capacity, self.epoch,
                     ranks=self.ranks)

    def observe(self) -> Dict[int, dict]:
        """Live member records by this host's current evidence."""
        return live_members(self.dir, self.member_timeout_s,
                            heartbeat_dir=self.heartbeat_dir,
                            stall_timeout_s=self.stall_timeout_s)

    def lost_members(self, commit: FleetCommit) -> List[int]:
        """Members of the committed formation no longer observably live
        (this host excluded — its own liveness is not in question; a
        host that LEFT cleanly, status "done", is departed, not lost)."""
        live = self.observe()
        done = {h for h, rec in read_members(self.dir).items()
                if rec.get("status") == "done"}
        return sorted(h for h in commit.members
                      if h != self.host and h not in live
                      and h not in done)

    def reform_requested(self) -> bool:
        """True when a peer already started (or committed) the NEXT
        epoch's agreement — e.g. its local trainers died while ours are
        healthy.  The supervision loop treats this like member loss:
        tear down and join the agreement."""
        nxt = self.epoch + 1
        return bool(read_commit(self.dir, nxt)
                    or read_proposals(self.dir, nxt))

    def leave(self) -> None:
        """Depart cleanly (all local work finished): peers stop counting
        this host toward formations without treating it as lost."""
        write_member(self.dir, self.host, self.capacity, self.epoch,
                     ranks=self.ranks, status="done")

    def await_members(self, expect: Sequence[int],
                      timeout_s: Optional[float] = None) -> Dict[int, dict]:
        """Initial rendezvous: block until every host in `expect` has a
        fresh membership record (each arriving launcher writes its own
        first, so the wait converges)."""
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.agreement_timeout_s)
        want = {int(h) for h in expect}
        while True:
            self.tick(min_interval_s=0.0)
            live = self.observe()
            if want <= set(live):
                return live
            if time.monotonic() > deadline:
                raise FleetAgreementTimeout(
                    f"fleet formation timed out waiting for hosts "
                    f"{sorted(want - set(live))} (have {sorted(live)})")
            time.sleep(self.poll_s)

    # -- agreement ----------------------------------------------------------
    def _restore_step(self, members: Dict[int, dict]) -> Optional[int]:
        if not self.journal_dir:
            return None
        ranks = sorted(r for rec in members.values()
                       for r in rec.get("ranks", ()))
        if not ranks:
            return None
        try:
            return newest_mutual_checkpoint_step(self.journal_dir, ranks)
        except Exception:  # forensics must not wedge the re-form
            return None

    def form(self, expect: Optional[Sequence[int]] = None,
             epoch: Optional[int] = None) -> FleetCommit:
        """Run the two-phase agreement for `epoch` (default: the
        controller's current epoch) and return the committed formation.
        With `expect`, first blocks until those hosts rendezvous (the
        initial formation); without it, whoever is observably live forms
        the survivor set (the re-form path)."""
        epoch = self.epoch if epoch is None else int(epoch)
        self.epoch = epoch
        if expect is not None:
            self.await_members(expect)
        deadline = time.monotonic() + self.agreement_timeout_s
        prev_key = None
        while True:
            committed = read_commit(self.dir, epoch)
            if committed is not None:
                return self._adopt(committed)
            self.tick(min_interval_s=0.0)
            live = self.observe()
            if self.host not in live:  # clock skew on a slow mount
                live[self.host] = {"host": self.host,
                                   "capacity": self.capacity,
                                   "ranks": self.ranks}
            members = sorted(live)
            capacity = sum(int(r.get("capacity", 0))
                           for r in live.values())
            world = fleet_world_size(capacity, self.logical_world)
            if world < 1:
                raise FleetAgreementTimeout(
                    "no surviving capacity to form a fleet world")
            mine = propose_reform(self.dir, self.host, epoch, members,
                                  world, self._restore_step(live))
            props = read_proposals(self.dir, epoch)
            agreed = (set(props) >= set(members)
                      and all(_proposal_key(props[h]) == _proposal_key(mine)
                              for h in members))
            # commit only once the agreed view has been STABLE across
            # two consecutive observations: the fastest survivor must
            # not freeze a formation that excludes a peer whose
            # membership refresh is one tick behind
            stable = agreed and prev_key == _proposal_key(mine)
            prev_key = _proposal_key(mine)
            if stable and self.host == min(members):
                # coordinator publishes; first write wins — re-read
                # rather than clobber if a racing epoch already landed
                path = _commit_path(self.dir, epoch)
                if not os.path.exists(path):
                    rec = dict(mine)
                    rec["coordinator"] = self.host
                    _write_json(path, rec)
                committed = read_commit(self.dir, epoch)
                if committed is not None:
                    return self._adopt(committed)
            if time.monotonic() > deadline:
                raise FleetAgreementTimeout(
                    f"fleet epoch {epoch} agreement timed out "
                    f"(proposals: { {h: _proposal_key(p) for h, p in props.items()} })")
            time.sleep(self.poll_s)

    def reform(self, prev: FleetCommit) -> FleetCommit:
        """Member loss → next epoch's agreement among the survivors."""
        self.reform_count += 1
        return self.form(epoch=prev.epoch + 1)

    def _adopt(self, commit: FleetCommit) -> FleetCommit:
        self.epoch = commit.epoch
        self._observe_metrics(commit)
        return commit

    def _observe_metrics(self, commit: FleetCommit) -> None:
        try:
            from ..core.monitor import gauge_set
            gauge_set("fleet.members", len(commit.members))
            gauge_set("fleet.epoch", commit.epoch)
            gauge_set("fleet.reform_count", self.reform_count)
        except Exception:
            pass
        if self.journal_dir:
            try:
                from ..observability.journal import RunJournal
                if self._journal is None:
                    self._journal = RunJournal(
                        self.journal_dir,
                        rank=CONTROLLER_RANK_BASE + self.host)
                self._journal.event(
                    "reform", epoch=commit.epoch, world=commit.world,
                    members=commit.members,
                    restore_step=commit.restore_step,
                    reform_count=self.reform_count)
            except Exception:
                pass  # telemetry must never wedge the re-form

    # -- worker env contract ------------------------------------------------
    def env_for_workers(self, commit: FleetCommit) -> Dict[str, str]:
        env = {
            ENV_DIR: self.dir,
            ENV_EPOCH: str(commit.epoch),
            ENV_HOST: str(self.host),
            ENV_HOSTS: ",".join(str(h) for h in commit.members),
            ENV_WORLD: str(commit.world),
            ENV_LOGICAL: str(self.logical_world),
            ENV_LAUNCHER_PID: str(os.getpid()),
        }
        if commit.restore_step is not None:
            env[ENV_RESTORE_STEP] = str(commit.restore_step)
        return env

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()
            self._journal = None


class FleetEnv:
    """The parsed worker-side view of the ``PADDLE_TPU_FLEET_*`` env
    contract a fleet launcher exports."""

    __slots__ = ("dir", "epoch", "host", "hosts", "world", "logical_world",
                 "restore_step")

    def __init__(self, dir, epoch, host, hosts, world, logical_world,
                 restore_step):
        self.dir = dir
        self.epoch = epoch
        self.host = host
        self.hosts = hosts
        self.world = world
        self.logical_world = logical_world
        self.restore_step = restore_step

    @property
    def rank(self) -> int:
        """This host's dense rank in the current formation (the
        CheckpointManager rank)."""
        return fleet_rank(self.host, self.hosts)

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    def barrier(self, timeout_s: float = 120.0) -> FleetBarrier:
        """A publish barrier for this formation (pass as
        ``enable_checkpointing(barrier=...)``)."""
        return FleetBarrier(self.dir, self.host, self.hosts,
                            epoch=self.epoch, timeout_s=timeout_s)

    def __repr__(self):
        return (f"FleetEnv(epoch={self.epoch}, host={self.host}, "
                f"hosts={self.hosts}, world={self.world})")


def fleet_env(environ: Optional[Dict[str, str]] = None) -> Optional[FleetEnv]:
    """Parse the worker-side fleet contract; None when not under a fleet
    launcher."""
    e = os.environ if environ is None else environ
    directory = e.get(ENV_DIR)
    if not directory:
        return None
    try:
        hosts = [int(h) for h in e.get(ENV_HOSTS, "").split(",") if h != ""]
        restore = e.get(ENV_RESTORE_STEP)
        return FleetEnv(
            dir=directory,
            epoch=int(e.get(ENV_EPOCH, "0")),
            host=int(e.get(ENV_HOST, "0")),
            hosts=hosts or [int(e.get(ENV_HOST, "0"))],
            world=int(e.get(ENV_WORLD, "1")),
            logical_world=int(e.get(ENV_LOGICAL, e.get(ENV_WORLD, "1"))),
            restore_step=None if restore in (None, "") else int(restore),
        )
    except ValueError:
        warnings.warn(
            f"malformed {FLEET_DIR_ENV} env contract; ignoring fleet mode",
            RuntimeWarning, stacklevel=2)
        return None
