"""Typed daemon configuration (reference:src/common/config.{h,cc}).

Counterpart of ``ceph_tpu/common/config.py``, whole: the same option
table (names, types, defaults and choices), so a daemon of either
package reads the same settings, and the same ``Config`` layering and
observers.  Later ports (the monitor, the OSD) read the rest of it.

The reference compiles 1206 ``OPTION(name, type, default)`` lines
(reference:src/common/config_opts.h) into ``md_config_t`` and layers
sources: compiled defaults -> ceph.conf ini -> CEPH_ARGS env -> argv ->
runtime ``injectargs`` / admin-socket ``config set``, with registered
observers notified on change (reference:src/common/config.h
md_config_obs_t).

Here the same shape, sized to this framework: a typed option table with
defaults, ini-file and environment loading, runtime ``set`` with
validation, and observer callbacks keyed on option name.  Cluster-tier
configuration (EC profiles, pool flags) deliberately lives in the OSDMap
instead — the reference's two-tier split (daemon flags vs mon-versioned
profiles, reference:src/mon/OSDMonitor.cc:4305).
"""

from __future__ import annotations

import configparser
import dataclasses
import os
import shlex
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class Option:
    name: str
    type: type  # int | float | bool | str
    default: Any
    desc: str = ""
    # enumerated options reject bad values HERE, before Config.set
    # commits — an observer raising after the commit would leave
    # `config show` and daemon state diverged
    choices: "tuple | None" = None

    def coerce(self, value: Any) -> Any:
        if self.type is bool:
            if isinstance(value, bool):
                return value
            s = str(value).strip().lower()
            if s in ("1", "true", "yes", "on"):
                return True
            if s in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"{self.name}: bad bool {value!r}")
        try:
            coerced = self.type(value)
        except (TypeError, ValueError) as e:
            raise ValueError(f"{self.name}: {e}") from None
        if self.choices is not None and coerced not in self.choices:
            raise ValueError(
                f"{self.name}: must be one of {self.choices}, "
                f"got {coerced!r}"
            )
        return coerced


def _opts(*options: Option) -> dict[str, Option]:
    return {o.name: o for o in options}


# The flag table (config_opts.h analog) — every tunable the daemons read.
OPTIONS: dict[str, Option] = _opts(
    # messenger
    Option("ms_connect_timeout", float, 5.0, "outbound connect timeout (s)"),
    Option("ms_reconnect_backoff", float, 0.1,
           "base backoff between reconnect attempts (s)"),
    Option("ms_reconnect_max_attempts", int, 2,
           "reconnect attempts before a send fails"),
    Option("ms_dispatch_throttle_bytes", int, 0,
           "in-flight inbound byte budget per messenger (0 = off; "
           "reference default 100MB)"),
    Option("osd_subop_retries", int, 2,
           "re-send rounds for sub-ops lost to transient socket "
           "failures before the op fails (sub-writes are idempotent; "
           "the reference recovers the same way via messenger "
           "reconnect/replay)"),
    Option("ms_inject_socket_failures", int, 0,
           "fault injection: sever a connection once per ~N socket "
           "operations, mid-frame when sending (0 = off; the "
           "reference's ms_inject_socket_failures, "
           "config_opts.h:209)"),
    Option("ms_reply_coalesce_max", int, 16,
           "coalesced-ack bound: the messenger writer loop packs up "
           "to this many consecutive READY blob-free acks (COALESCE "
           "message classes: op/sub-op/rep-op replies) to one peer "
           "into a single batch frame — one binary header + crc + "
           "syscall amortized over N acks.  Flush-on-idle: an empty "
           "send queue ships immediately, so coalescing amortizes "
           "bursts without ever delaying a lone ack (the EC "
           "dispatcher's adaptive-window discipline applied to "
           "replies).  <=1 disables (live via observer)"),
    Option("ms_op_batch_max", int, 16,
           "multi-op request frame bound (the Objecter-parity batch "
           "path): the messenger writer loop packs "
           "up to this many consecutive READY batchable requests "
           "(BATCH_OPS message classes — client MOSDOps, blobs "
           "included via per-member blob tables) to one peer into a "
           "single batch frame, one binary header + crc + syscall "
           "amortized over N ops.  Same flush-on-idle discipline as "
           "ms_reply_coalesce_max: an empty send queue ships "
           "immediately, so batching amortizes the client "
           "aggregator's per-tick bursts (striper fan-out, "
           "object_cacher writeback) without delaying a lone op.  "
           "<=1 disables (live via observer)"),
    Option("ms_clock_sync_interval", float, 5.0,
           "per-peer monotonic clock-offset re-estimation period (s): "
           "the messenger runs an NTP-style MClockSync exchange at "
           "connection start and whenever the peer's estimate ages "
           "past this, so span timestamps from different processes "
           "merge into one op waterfall (0 disables the probes; "
           "common/clocksync.py records the uncertainty of every "
           "estimate)"),
    # observability: op waterfall (common/tracing.py spans + the
    # stack.* ledger)
    Option("osd_op_trace_sample_every", int, 64,
           "record full waterfall spans for 1-in-N client ops (per "
           "OSD): sampled ops get per-hop spans (client serialize / "
           "wire / dispatch / qos wait / execute / EC coalesce+device "
           "/ reply) recorded locally, piggybacked on the reply, and "
           "fed into the stack.lat_* histograms -> mgr prometheus — "
           "per-hop p99 as a continuously exported series (1 = every "
           "op, 0 disables; live via observer)"),
    # observability: tail-sampled tracing — every client op
    # provisionally traces (the binary frame header already carries
    # trace id + send stamp); the OSD decides keep/drop at COMPLETION,
    # so the slow tail, the errors and the failover replays always
    # carry waterfalls while the median op costs nothing but the
    # per-op keep check
    Option("osd_trace_keep", bool, True,
           "tail-based trace keep policy: at op completion, keep the "
           "waterfall when the op ran slow (osd_trace_keep_slow_"
           "threshold), failed, or its launch record shows a "
           "failover/fallback replay or accel re-route — plus the "
           "1-in-osd_op_trace_sample_every baseline.  False reverts "
           "to pure head sampling (the tracing-off arm of the bench "
           "overhead capture pairs False with sample_every=0; live "
           "via observer)"),
    Option("osd_trace_keep_slow_threshold", float, 0.0,
           "op wall time (s) past which the keep policy retains the "
           "trace; 0 = osd_op_complaint_time/4 (live via observer, "
           "as is a complaint-time change)"),
    Option("trace_ring_capacity", int, 4096,
           "events kept per tracepoint-provider ring "
           "(common/tracing.py; process-global — one set of rings per "
           "process).  Live via observer; shrinking evicts oldest "
           "events and the eviction is COUNTED (dump_tracepoints "
           "reports dropped / dropped_since_dump)"),
    # osd: liveness
    Option("osd_heartbeat_interval", float, 0.0,
           "peer ping period (s); 0 disables (reference default 6)"),
    Option("osd_heartbeat_grace", float, 3.0,
           "silence before reporting a peer failed (reference default 20)"),
    # osd: data path
    Option("osd_subop_timeout", float, 30.0,
           "shard sub-op round-trip budget (s)"),
    Option("osd_client_op_retries", int, 8, "client-visible op retries"),
    # osd: op tracking (reference:src/common/TrackedOp + the
    # osd_op_complaint_time / osd_op_history_size options)
    Option("osd_op_complaint_time", float, 30.0,
           "in-flight op age that counts as a slow request and feeds "
           "the SLOW_OPS health warning (0 disables)"),
    Option("osd_op_history_size", int, 20,
           "completed ops kept for dump_historic_ops (and the "
           "by-duration ring)"),
    # osd: scrub
    Option("osd_scrub_interval", float, 0.0,
           "background deep-scrub period (s); 0 = on-demand only"),
    Option("osd_scrub_auto_repair", bool, True,
           "background scrub repairs what it finds"),
    # osd: recovery
    Option("osd_recovery_retry_interval", float, 0.5,
           "pause before retrying a partial recovery pass (s)"),
    Option("osd_recovery_scan_timeout", float, 10.0,
           "peering scan round-trip budget (s)"),
    Option("osd_max_backfills", int, 1,
           "PG recovery/backfill reservations granted concurrently per "
           "OSD, in each of the local and remote reserver roles "
           "(reference:src/common/config_opts.h:621)"),
    Option("osd_recovery_max_active", int, 3,
           "concurrent object recovery pushes per recovering PG "
           "(reference:src/common/config_opts.h:801)"),
    Option("osd_recovery_max_chunk", int, 8 << 20,
           "replicated recovery push segment size in bytes "
           "(reference:src/common/config_opts.h:803)"),
    Option("osd_recovery_reserve_timeout", float, 30.0,
           "budget for acquiring local+remote recovery reservations "
           "before the pass defers (s)"),
    # osd: QoS op scheduling (reference: osd_op_queue selecting
    # WeightedPriorityQueue / mClockScheduler, src/common/config_opts.h
    # + the osd_mclock_scheduler_* profile options; dmClock from
    # Gulati et al., OSDI 2010) — osd.scheduler
    Option("osd_op_queue", str, "mclock",
           "op scheduler policy: mclock (dmClock reservation/weight/"
           "limit tags) | wpq (weight-only fair queueing) | fifo "
           "(arrival order, scheduling off); live-switchable",
           choices=("mclock", "wpq", "fifo")),
    Option("osd_op_queue_slots", int, 256,
           "concurrent grants the QoS scheduler hands out (the "
           "capacity model); a CLIENT grant is held across the whole "
           "op, replica round trips included, so this must cover "
           "device concurrency TIMES latency hiding — size it like a "
           "connection pool, not like a core count; queues form — and "
           "the policy starts mattering — only when all slots are "
           "busy"),
    Option("osd_op_queue_cut_off", int, 256,
           "total queued entries across the QoS scheduler past which "
           "new best-effort admissions (scrub/snaptrim/ec_background) "
           "defer (QosDeferred) instead of queueing — overload "
           "shedding for background work when the pool is drowning "
           "in client traffic"),
    Option("osd_mclock_scheduler_client_res", float, 10.0,
           "client class: reserved ops/s under contention"),
    Option("osd_mclock_scheduler_client_wgt", float, 4.0,
           "client class: proportional weight above the reservation"),
    Option("osd_mclock_scheduler_client_lim", float, 0.0,
           "client class: ops/s hard cap (0 = unlimited)"),
    Option("osd_mclock_scheduler_recovery_res", float, 1.0,
           "recovery class: reserved object pushes/s"),
    Option("osd_mclock_scheduler_recovery_wgt", float, 1.0,
           "recovery class: proportional weight"),
    Option("osd_mclock_scheduler_recovery_lim", float, 0.0,
           "recovery class: pushes/s hard cap (0 = unlimited)"),
    Option("osd_mclock_scheduler_scrub_res", float, 0.5,
           "scrub class: reserved PG scrubs/s"),
    Option("osd_mclock_scheduler_scrub_wgt", float, 1.0,
           "scrub class: proportional weight"),
    Option("osd_mclock_scheduler_scrub_lim", float, 0.0,
           "scrub class: PG scrubs/s hard cap (0 = unlimited)"),
    Option("osd_mclock_scheduler_snaptrim_res", float, 0.5,
           "snaptrim class: reserved PG trim passes/s"),
    Option("osd_mclock_scheduler_snaptrim_wgt", float, 1.0,
           "snaptrim class: proportional weight"),
    Option("osd_mclock_scheduler_snaptrim_lim", float, 0.0,
           "snaptrim class: trim passes/s hard cap (0 = unlimited)"),
    Option("osd_mclock_scheduler_ec_background_res", float, 16.0,
           "ec_background class: reserved stripes/s at the EC "
           "dispatcher boundary (the rate background stripes fall "
           "back to while client ops are queued)"),
    Option("osd_mclock_scheduler_ec_background_wgt", float, 1.0,
           "ec_background class: proportional weight"),
    Option("osd_mclock_scheduler_ec_background_lim", float, 0.0,
           "ec_background class: stripes/s hard cap (0 = unlimited)"),
    # erasure code
    Option("osd_ec_mesh", bool, False,
           "route EC encode/reconstruct through the device-mesh engine "
           "(k+m shard rows on mesh rows, ICI all-gather reconstruct; "
           "the messenger keeps carrying control traffic) — "
           "the multi-device engine.  With osd_ec_dispatch on the "
           "mesh is a dispatcher LANE: coalescing, QoS pacing, the "
           "launch deadline, and engine failover all govern mesh "
           "traffic; batch keys carry the mesh slice and stripe "
           "bucketing aligns to mesh_size x bucket"),
    Option("osd_ec_mesh_devices", int, 0,
           "devices in the EC mesh slice (0 = every device the "
           "process sees); a nonzero value pins the mesh to the first N "
           "devices — bench.py's mesh phase sweeps this dimension for "
           "per-chip scaling efficiency"),
    Option("osd_ec_dispatch", bool, True,
           "coalesce concurrent EC encode/decode requests into one "
           "padded device launch off the event loop "
           "(osd.ec_dispatch); with osd_ec_mesh on, mesh "
           "launches ride the same dispatcher as a first-class lane"),
    Option("osd_ec_dispatch_window", float, 0.0005,
           "EC dispatcher coalescing window (s): a batch flushes this "
           "long after its first request unless the stripe threshold "
           "fires first"),
    Option("osd_ec_dispatch_max_stripes", int, 512,
           "EC dispatcher flush threshold: queued stripes per "
           "(codec, geometry) key that trigger an immediate launch"),
    Option("osd_ec_dispatch_bucket", bool, True,
           "pad each batched launch's stripe count to the next power "
           "of two so the jit cache holds O(log max_S) entries per "
           "codec instead of one per distinct object size"),
    # erasure code: accelerator fault domain (engine health state
    # machine + failover, osd.ec_failover — the reference's
    # heartbeat_map/suicide-grace discipline applied to the device)
    Option("osd_ec_engine_failover", bool, True,
           "supervise the EC device engine: fatal launch failures "
           "(device lost / runtime error / OOM / kernel build) replay the "
           "in-flight batch on the host fallback engine and trip a "
           "circuit breaker; data-shape errors still surface to the "
           "caller (off = launch failures fail every waiter, the "
           "pre-failover behavior)"),
    Option("osd_ec_launch_deadline", float, 30.0,
           "budget for one batched EC device launch (s): past it the "
           "waiters replay on the fallback engine and the breaker "
           "trips; the wedged worker thread stays on the HeartbeatMap "
           "clock (grace -> health warn, suicide_grace -> daemon "
           "policy), so a hung device call can never silently freeze "
           "the OSD (0 disables the deadline, not the watchdog)"),
    Option("osd_ec_probe_interval", float, 1.0,
           "base backoff between canary probes of a TRIPPED EC engine "
           "(s); doubles per failed probe up to 32x.  A probe is one "
           "one-stripe encode on the device engine checked against "
           "the host oracle; success re-promotes the engine"),
    Option("ec_inject_engine_failure", int, 0,
           "fault injection: every Nth batched EC device launch "
           "raises a fabricated device-lost error (1 = "
           "every launch, 0 = off; the accelerator analog of "
           "ms_inject_socket_failures — live via observer)"),
    Option("ec_inject_launch_hang", float, 0.0,
           "fault injection: every batched EC device launch stalls "
           "this many seconds in the worker thread before running — "
           "a wedged device call, for exercising "
           "osd_ec_launch_deadline (0 = off; live via observer)"),
    # erasure code: shared accelerator service (accel — one
    # standalone device daemon serving many OSDs over the messenger)
    Option("osd_ec_accel_addr", str, "",
           "address (host:port) of the shared EC accelerator daemon "
           "this OSD ships coalesced encode/decode batches to ('' = "
           "no remote; live — retargeting resets the connection)"),
    Option("osd_ec_accel_mode", str, "off",
           "remote EC lane policy: off = local lanes only; prefer = "
           "route to the accelerator while its beacon reads healthy "
           "and unsaturated, fall back to the local lanes otherwise; "
           "require = always route remote (no local device expected "
           "on this host) — accelerator faults still replay on the "
           "local host fallback engine, so no client op ever fails",
           choices=("off", "prefer", "require")),
    Option("osd_ec_accel_deadline", float, 10.0,
           "round-trip budget for one remote EC batch (s): past it "
           "the waiters replay on the local fallback engine and the "
           "remote is marked unreachable (0 = unbounded)"),
    Option("osd_ec_accel_retry_interval", float, 1.0,
           "base backoff before re-trying an unreachable accelerator "
           "(s); doubles per failed attempt up to 16x.  A beacon or "
           "successful reply clears the backoff immediately"),
    Option("osd_ec_accel_stale_interval", float, 10.0,
           "age past which an accelerator's last beacon/reply health "
           "snapshot no longer gates routing (s): a snapshot aged >= "
           "this is stale and traffic re-probes the remote instead of "
           "pinning TRIPPED/saturated forever off one old message "
           "(live via observer)"),
    Option("accel_beacon_interval", float, 0.5,
           "accelerator daemon: engine-state/queue-depth beacon "
           "period to every connected OSD (s); 0 disables (replies "
           "still piggyback the same fields)"),
    Option("accel_mgr_report_interval", float, 1.0,
           "accelerator daemon -> mgr perf-counter report period (s); "
           "0 disables"),
    Option("accel_locality", str, "",
           "accelerator daemon: locality label advertised in its "
           "AccelMap registration (match the crush host names of the "
           "OSDs it is co-located with); decode batches prefer the "
           "accelerator matching their surviving shards' majority "
           "label, so reads stop shipping survivor bytes across the "
           "fabric"),
    Option("mon_accel_beacon_grace", float, 5.0,
           "mon: a registered accelerator silent (no MAccelBoot "
           "beacon) for this long is marked down in the AccelMap and "
           "the epoch bump is published — routers stop targeting it "
           "within one map push"),
    # the default is the reference's word for word (the two tables
    # compare equal); no code reads this option
    Option("erasure_code_dir", str, "ceph_tpu.models",
           "plugin module prefix (dlopen dir analog)"),
    Option("osd_class_dir", str, "",
           "directory of external object-class files cls_<name>.py "
           "(reference: osd_class_dir + ClassHandler dlopen of "
           "libcls_<name>.so); empty = built-ins only"),
    Option("osd_erasure_code_plugins", str, "jerasure isa lrc shec",
           "plugins preloaded at daemon start"),
    Option("osd_pool_default_erasure_code_profile", str,
           "plugin=isa technique=reed_sol_van k=2 m=1",
           "profile for pools created without one"),
    # stores
    Option("wal_checkpoint_bytes", int, 64 << 20,
           "journal size triggering a WalStore checkpoint"),
    Option("wal_sync", str, "fsync", "journal durability: fsync|flush|none"),
    # mgr
    Option("mgr_beacon_interval", float, 0.5,
           "mgr -> mon registration beacon period (s)"),
    Option("osd_mgr_report_interval", float, 1.0,
           "osd -> mgr MPGStats period (s); 0 disables"),
    # mon
    Option("mon_mgr_report_interval", float, 1.0,
           "mon -> mgr perf-counter report period (s); 0 disables"),
    Option("mon_failure_min_reporters", int, 1,
           "distinct reporters before an osd is marked down"),
    Option("mon_cluster_log_max", int, 1000,
           "cluster-log ring entries kept at the mon (ceph log last)"),
    Option("mon_lease_interval", float, 1.0,
           "multi-mon lease/heartbeat period (s)"),
    Option("mon_election_timeout", float, 2.0,
           "silence before a mon calls an election (s)"),
    # admin
    Option("admin_socket", str, "",
           "unix socket path for perf dump / config commands ('' = off)"),
    # kernel visibility (ops.device_trace): on-demand profiler
    # trace windows + the device-launch flight recorder
    Option("kernel_trace_max_duration", float, 30.0,
           "hard cap on one `kernel trace start` window (s): the "
           "requested duration clamps here and an expired window "
           "auto-closes on the next service call, so an operator "
           "cannot leave profiler overhead armed on the device path"),
    Option("osd_ec_launch_history", int, 64,
           "device-launch flight-recorder depth: the last N EC "
           "launches (lane, batch key, QoS class, queue-wait vs "
           "device wall, slowest member op's trace id) kept for "
           "dump_launch_history and the SLOW_OPS dump enrichment"),
    # auth (reference:src/auth; auth_supported / keyring options)
    Option("auth_supported", str, "none",
           "authentication: none | cephx (handshake tickets)"),
    Option("keyring", str, "", "keyring file path (cephx)"),
    # debugging (reference:lockdep + HeartbeatMap thread timeouts)
    Option("lockdep", bool, False,
           "detect lock-order cycles on PG/daemon locks"),
    Option("osd_op_thread_timeout", float, 15.0,
           "op worker heartbeat grace before the daemon is unhealthy"),
    Option("osd_op_thread_suicide_timeout", float, 150.0,
           "op worker stall that aborts the daemon (0 disables)"),
    # tenant ledger / tsdb / SLO
    Option("osd_client_ledger_topk", int, 128,
           "per-OSD tenant ledger capacity: the space-saving sketch "
           "tracks the K heaviest (client, pool, class) keys exactly "
           "and folds the tail into one 'other' bucket — memory is "
           "O(K) no matter how many tenants exist"),
    Option("osd_client_ledger_window", float, 10.0,
           "tenant-ledger sliding window (s): dumps and the mgr's "
           "ceph_client_* series reflect the last 0.5-1x this span, "
           "so idle tenants age out of the top-K"),
    Option("osd_inject_op_delay", float, 0.0,
           "DEBUG: sleep this long (s) inside every client op before "
           "execution — the latency-storm injector the SLO burn-rate "
           "tests flip on and off live (0 = off)"),
    Option("osd_inject_op_delay_every", int, 1,
           "DEBUG: apply osd_inject_op_delay to only 1-in-N client "
           "ops (<=1 = every op) — the tail-sampling acceptance run "
           "pins ~1% injected-slow ops against the keep policy "
           "(live via observer)"),
    Option("mgr_tsdb_step", float, 1.0,
           "mgr time-series store bucket width (s): daemon reports "
           "land in fixed-step buckets; rates derive from cumulative "
           "deltas across them"),
    Option("mgr_tsdb_retention", int, 600,
           "mgr time-series ring depth (buckets per series): memory "
           "per series is this many points, full stop — history "
           "beyond step*retention falls off the ring"),
    Option("mgr_tsdb_max_series", int, 4096,
           "hard cap on distinct series the mgr store tracks; "
           "overflow increments tsdb.dropped_series instead of "
           "growing without bound"),
    Option("mgr_slo_op_p99_target", float, 0.5,
           "SLO: client op latency threshold (s) — ops slower than "
           "this burn the latency error budget (budget: "
           "mgr_slo_slow_frac_budget of ops may exceed it)"),
    Option("mgr_slo_slow_frac_budget", float, 0.01,
           "SLO: allowed fraction of ops over the p99 target (the "
           "error budget the burn rate is measured against)"),
    Option("mgr_slo_failure_rate_target", float, 0.01,
           "SLO: allowed client op failure rate (op_err/op)"),
    Option("mgr_slo_fast_window", float, 5.0,
           "SLO fast burn window (s) — the 5m analog scaled to test "
           "time; both windows must burn to raise SLO_BURN, and the "
           "fast one decaying clears it"),
    Option("mgr_slo_slow_window", float, 60.0,
           "SLO slow burn window (s) — the 1h analog scaled to test "
           "time"),
    Option("mgr_slo_burn_threshold", float, 2.0,
           "burn-rate multiple (consumption / budget) that raises "
           "SLO_BURN when BOTH windows exceed it"),
    Option("mgr_trace_store_capacity", int, 512,
           "kept waterfalls the mgr trace store rings (mgr/trace_"
           "store.py): overflow evicts oldest and counts "
           "trace.store_evictions — memory is O(capacity * hops), "
           "full stop"),
)


class Config:
    """Layered typed config with observers.

    Precedence (low to high): option defaults -> ini file -> environment
    (``CEPH_TPU_ARGS='--name value ...'``) -> constructor overrides ->
    runtime :meth:`set`.
    """

    def __init__(
        self,
        overrides: dict[str, Any] | None = None,
        conf_file: str | None = None,
        section: str = "global",
        env: str | None = None,
        options: dict[str, Option] | None = None,
    ):
        self.options = dict(options or OPTIONS)
        self._values: dict[str, Any] = {
            name: o.default for name, o in self.options.items()
        }
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        if conf_file:
            self.load_file(conf_file, section)
        env_args = (
            env if env is not None else os.environ.get("CEPH_TPU_ARGS", "")
        )
        if env_args:
            self.load_args(shlex.split(env_args))
        for k, v in (overrides or {}).items():
            self.set(k, v)

    # -- sources
    def load_file(self, path: str, section: str = "global") -> None:
        cp = configparser.ConfigParser()
        with open(path) as f:
            cp.read_file(f)
        for sec in ("global", section):
            if cp.has_section(sec):
                for k, v in cp.items(sec):
                    self.set(k.replace(" ", "_"), v)

    def load_args(self, args: list[str]) -> None:
        """``--osd_subop_timeout 10 --wal_sync flush`` style pairs."""
        i = 0
        while i < len(args):
            a = args[i]
            if not a.startswith("--"):
                raise ValueError(f"bad arg {a!r}")
            name = a[2:]
            if "=" in name:
                name, val = name.split("=", 1)  # value BEFORE normalizing:
                i += 1                           # it may contain hyphens
            else:
                if i + 1 >= len(args):
                    raise ValueError(f"missing value for {a}")
                val = args[i + 1]
                i += 2
            self.set(name.replace("-", "_"), val)

    # -- access
    def get(self, name: str) -> Any:
        return self._values[name]

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name) from None

    def set(self, name: str, value: Any) -> None:
        opt = self.options.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        coerced = opt.coerce(value)
        self._values[name] = coerced
        for cb in self._observers.get(name, []):
            cb(name, coerced)

    def observe(self, name: str, cb: Callable[[str, Any], None]) -> None:
        """Register a change callback (md_config_obs_t analog)."""
        if name not in self.options:
            raise KeyError(f"unknown option {name!r}")
        self._observers.setdefault(name, []).append(cb)

    def unobserve(self, name: str, cb: Callable[[str, Any], None]) -> None:
        """Remove a callback (daemons MUST unregister on stop: a shared
        Config would otherwise keep firing actions on dead daemons)."""
        cbs = self._observers.get(name, [])
        if cb in cbs:
            cbs.remove(cb)

    def show(self) -> dict[str, Any]:
        """Every option with its current value (``config show``)."""
        return dict(sorted(self._values.items()))

    def diff(self) -> dict[str, Any]:
        """Only options changed from their defaults (``config diff``)."""
        return {
            k: v for k, v in sorted(self._values.items())
            if v != self.options[k].default
        }
