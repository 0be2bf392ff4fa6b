"""Per-daemon unix admin socket (reference:src/common/admin_socket.cc).

``ceph daemon <name> <command>`` analog: a tiny asyncio unix-socket
server taking one JSON request per connection ``{"prefix": "...", ...}``
and answering with a JSON document — the transport for ``perf dump``,
``config show``, ``config set``, ``dump_ops_in_flight`` and whatever a
daemon registers.

Counterpart of ``ceph_tpu/common/admin_socket.py``.  The request and
reply framing is the reference's, so :func:`admin_command` of either
package reaches either package's socket, and :func:`register_common`
registers the same commands.  The ``kernel trace`` windows are the
port's own (``ops/device_trace.py``): ``torch.profiler`` sessions in
place of ``jax.profiler``, on the device the daemon names
(``register_common(..., device=...)``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Any, Callable

logger = logging.getLogger("ceph_tpu_torch.admin")

Handler = Callable[[dict], Any]  # request dict -> json-able reply


def _kernel_profiler():
    """The process-global ops.profiler singleton, or None when the ops
    package is unavailable (profiler.py imports torch only where it
    times a CUDA call, so this initializes no device)."""
    try:
        from ..ops.profiler import profiler
    except Exception:  # pragma: no cover - broken partial install
        return None
    return profiler()


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._handlers: dict[str, tuple[Handler, str]] = {}
        self._server: asyncio.AbstractServer | None = None
        self.register("help", self._help, "list registered commands")

    def register(self, prefix: str, handler: Handler, desc: str = "") -> None:
        """Register a command (AdminSocket::register_command)."""
        if prefix in self._handlers:
            raise ValueError(f"admin command {prefix!r} already registered")
        self._handlers[prefix] = (handler, desc)

    def _help(self, _req: dict) -> dict:
        return {p: d for p, (_h, d) in sorted(self._handlers.items())}

    async def start(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)  # stale socket from a dead daemon
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._server = await asyncio.start_unix_server(
            self._serve, path=self.path
        )

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if os.path.exists(self.path):
            os.unlink(self.path)

    async def _serve(self, reader, writer) -> None:
        try:
            # read to EOF (the client write_eof()s after the request): a
            # single read(n) returns the first segment, truncating large
            # requests that span socket buffers
            raw = await reader.read()
            try:
                req = json.loads(raw or b"{}")
                prefix = req.get("prefix", "")
                entry = self._handlers.get(prefix)
                if entry is None:
                    reply = {"error": f"unknown command {prefix!r}",
                             "commands": sorted(self._handlers)}
                else:
                    result = entry[0](req)
                    if asyncio.iscoroutine(result):
                        result = await result
                    reply = result
            except Exception as e:  # command errors go to the caller
                logger.exception("admin command failed")
                reply = {"error": str(e)}
            writer.write(json.dumps(reply).encode())
            await writer.drain()
        finally:
            writer.close()


def register_common(asok: "AdminSocket", *, perf=None, config=None,
                    device=None) -> None:
    """The observability commands every daemon serves — one wiring for
    osd/mon/mgr/accel so the surfaces cannot drift: ``perf dump`` /
    ``perf schema`` / ``perf reset``, ``dump_histograms``,
    ``dump_kernel_profile``, ``kernel trace start|stop|status|dump``
    (ops.device_trace windows), ``config show|diff|set``, ``log dump``,
    ``dump_tracepoints`` (optionally filtered to one trace id via
    {"trace": ...}).  ``device`` is where the daemon's kernels run: a
    CUDA device opens windows that capture the card's activity (and
    fail without it), ``"cpu"`` host-only windows, None the card when
    there is one."""
    if perf is not None:
        asok.register("perf dump", lambda req: perf.dump(),
                      "typed performance counters")
        asok.register("perf schema", lambda req: perf.schema(),
                      "counter types/descriptions + histogram axes")

        def _perf_reset(req: dict) -> dict:
            names = perf.reset(req.get("name", "all"))
            return {"success": f"reset {', '.join(names)}"}

        asok.register("perf reset", _perf_reset,
                      "zero accumulated counters ({'name': subsys|all})")

        def _dump_histograms(req: dict) -> dict:
            out = perf.dump_histograms()
            kp = _kernel_profiler()
            if kp is not None:
                h = kp.dump_histograms()
                if h:
                    # the process-wide kernel engines ride next to the
                    # daemon subsystems (every daemon in this process
                    # shares the one jit cache they describe)
                    out["kernel"] = h
            return out

        asok.register("dump_histograms", _dump_histograms,
                      "log2-bucketed size/latency distributions")

    def _dump_kernel_profile(req: dict):
        kp = _kernel_profiler()
        if kp is None:
            return {"error": "kernel profiler unavailable"}
        top = req.get("top")
        # NB: req["prefix"] is the admin COMMAND name — the engine-
        # family filter rides a separate key
        return kp.dump(prefix=req.get("engine"),
                       top=int(top) if top is not None else None)

    asok.register("dump_kernel_profile", _dump_kernel_profile,
                  "kernel timings: first call vs steady state, "
                  "signature hits/misses, batch shapes per engine, "
                  "device-trace buckets "
                  "(optional {'top': N, 'engine': <family prefix>})")

    def _dump_frame_slab(req: dict) -> dict:
        # the frame scratch pool (common/slab.py, binary wire
        # protocol): hit/miss totals + per-class free-list occupancy —
        # the operator view behind stack.slab_hits/misses/bytes_held
        from .slab import frame_slab

        return frame_slab().stats()

    asok.register("dump_frame_slab", _dump_frame_slab,
                  "frame scratch slab pool: hits/misses, bytes held, "
                  "per-size-class free-list occupancy")

    # -- device trace windows (ops.device_trace): one process-wide
    # torch.profiler window at a time, served from every daemon's
    # socket.  start/stop/dump run in an executor — opening a session
    # and parsing its capture take tens of milliseconds (the first CUDA
    # session seconds), and an admin command must never stall
    # heartbeats or in-flight ops.
    def _device_tracer():
        try:
            from ..ops.device_trace import tracer
        except Exception:  # pragma: no cover - broken partial install
            return None
        return tracer()

    # the profiler's client initializes on the first thread that opens
    # a session and must be the thread torch was imported on: do it
    # here, on the daemon's own thread, not in an executor
    svc0 = _device_tracer()
    if svc0 is not None:
        svc0.prepare()

    async def _in_executor(fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            None, fn, *args
        )

    async def _ktrace_start(req: dict):
        svc = _device_tracer()
        if svc is None:
            return {"unavailable": "device tracer unavailable"}
        max_s = 30.0
        if config is not None:
            try:
                max_s = float(config.get("kernel_trace_max_duration"))
            except Exception:  # pragma: no cover - option table gap
                pass
        duration = req.get("duration")
        label = str(req.get("label", "") or "")
        return await _in_executor(
            lambda: svc.start(
                duration=float(duration) if duration else None,
                label=label, max_duration=max_s, device=device,
            )
        )

    async def _ktrace_stop(_req: dict):
        svc = _device_tracer()
        if svc is None:
            return {"unavailable": "device tracer unavailable"}
        return await _in_executor(svc.stop)

    def _ktrace_status(_req: dict):
        svc = _device_tracer()
        if svc is None:
            return {"unavailable": "device tracer unavailable"}
        return svc.status()

    async def _ktrace_dump(_req: dict):
        svc = _device_tracer()
        if svc is None:
            return {"unavailable": "device tracer unavailable"}
        return await _in_executor(svc.dump)

    asok.register("kernel trace start", _ktrace_start,
                  "open a torch.profiler device trace window "
                  "({'duration': s, 'label': ...}; bounded by "
                  "kernel_trace_max_duration, one window at a time)")
    asok.register("kernel trace stop", _ktrace_stop,
                  "close the open trace window and parse it into the "
                  "per-engine kernel/copy/collective breakdown")
    asok.register("kernel trace status", _ktrace_status,
                  "trace window state + per-bucket device-seconds "
                  "totals across windows")
    asok.register("kernel trace dump", _ktrace_dump,
                  "the last closed window's breakdown (auto-closes an "
                  "expired window first)")
    if config is not None:
        asok.register("config show", lambda req: config.show(),
                      "every option with its current value")
        asok.register("config diff", lambda req: config.diff(),
                      "options changed from defaults")

        def _config_set(req: dict):
            config.set(req["name"], req["value"])
            return {"success": f"{req['name']} = {config.get(req['name'])}"}

        asok.register("config set", _config_set, "set one option at runtime")

    def _log_dump(req: dict) -> dict:
        from .log import install

        ml = install()
        n = int(req.get("num", 200) or 200)
        if n < 0:
            return {"error": f"num must be >= 0, got {n}"}
        return {"entries": ml.recent(n=n, level=req.get("level"))}

    asok.register("log dump", _log_dump,
                  "recent in-memory log entries (ring buffer)")

    def _dump_tracepoints(req: dict) -> dict:
        from .tracing import dump_all

        return dump_all(trace=req.get("trace"))

    asok.register("dump_tracepoints", _dump_tracepoints,
                  "ring-buffer tracepoint events (optional trace "
                  "filter; each ring reports dropped / "
                  "dropped_since_dump so a truncated timeline is "
                  "visibly truncated)")

    def _dump_op_waterfall(req: dict) -> dict:
        from .tracing import op_waterfall

        trace = req.get("trace") or req.get("trace_id")
        if not trace:
            return {"error": "pass the op's trace id as "
                             "{'trace': 'client.N:tX'}"}
        return op_waterfall(str(trace))

    asok.register("dump_op_waterfall", _dump_op_waterfall,
                  "one op's cross-daemon hop waterfall "
                  "({'trace': <id>}): ordered clock-aligned hops with "
                  "durations, nesting, alignment uncertainty, "
                  "path_sum_s and the dominant hop")

    def _dump_clock_sync(_req: dict) -> dict:
        from .clocksync import clock_table

        return clock_table().dump()

    asok.register("dump_clock_sync", _dump_clock_sync,
                  "per-peer monotonic clock-offset estimates "
                  "(offset/uncertainty/rtt/age/samples) feeding the "
                  "op waterfall's cross-process alignment")


async def admin_command(path: str, prefix: str, **kw) -> Any:
    """Client side: one command round trip (the `ceph daemon` CLI core)."""
    reader, writer = await asyncio.open_unix_connection(path)
    try:
        writer.write(json.dumps({"prefix": prefix, **kw}).encode())
        await writer.drain()
        writer.write_eof()
        raw = await reader.read()
        return json.loads(raw)
    finally:
        writer.close()
