"""ceph: the cluster-status CLI (reference:src/ceph.in).

Stats commands (status/df/pg dump/metrics) are served by the active
mgr — discovered through the map, like the reference's mon-to-mgr
command forwarding; everything else goes to the mon.

Usage:
  ceph -m MON status
  ceph -m MON df
  ceph -m MON pg dump
  ceph -m MON metrics          # prometheus exposition text
  ceph -m MON mgr module ls
  ceph -m MON osd dump
  ceph daemon NAME|SOCKET CMD  # admin-socket passthrough, e.g.
                               #   ceph daemon osd.0 perf dump
                               #   ceph daemon osd.0 dump_historic_ops
                               #   ceph daemon /run/osd.0.asok help
                               # NAME resolves via the admin_socket
                               # config pattern (CEPH_TPU_ARGS)

Counterpart of ``ceph_tpu/tools/ceph_cli.py``, over the port's client
and admin socket.  The client has no card, so the CLI takes no
``--device``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..rados.client import RadosClient, RadosError

MGR_COMMANDS = {"status", "health", "df", "osd df", "pg dump",
                "pg query", "pg ls", "metrics", "mgr module ls",
                "metrics query", "metrics ls", "metrics range",
                "metrics stats", "client ledger",
                "trace ls", "trace show", "trace top", "trace summary"}


async def _mgr_command(client: RadosClient, cmd: dict):
    m = client.osdmap
    if not m.mgr_addr:
        print("error: no active mgr in the map", file=sys.stderr)
        return 1, None
    conn = await client.messenger.connect(m.mgr_addr, m.mgr_name)
    reply = await client.command_on(conn, cmd)
    if reply.code < 0:
        print(f"error: {reply.status}", file=sys.stderr)
        return 1, None
    return 0, reply.out


def _fmt_check(c: dict) -> str:
    return (f"[{c['severity'].removeprefix('HEALTH_')}] "
            f"{c['code']}: {c['summary']}")


def _print_status(out: dict) -> None:
    print(f"  health:  {out['health']}")
    for c in out.get("checks", []):
        print(f"           {_fmt_check(c)}")
    om = out["osdmap"]
    flags = f", flags {','.join(om['flags'])}" if om.get("flags") else ""
    print(f"  osd:     {om['num_osds']} osds: {om['num_up_osds']} up, "
          f"{om['num_in_osds']} in (epoch {om['epoch']}){flags}")
    mg = out["mgrmap"]
    stand = f", standbys: {', '.join(mg['standbys'])}" if mg["standbys"] else ""
    print(f"  mgr:     {mg['active'] or '(none)'}{stand}")
    md = out.get("mdsmap") or {}
    if md.get("ranks"):
        ms = f", standbys: {', '.join(md['standbys'])}" \
            if md.get("standbys") else ""
        occupied = sum(1 for n in md["ranks"] if n)
        ranks = ", ".join(
            f"{i}={n or '(vacant)'}" for i, n in enumerate(md["ranks"])
        )
        print(f"  mds:     {occupied}/{md['max_mds']} active "
              f"({ranks}){ms}")
    pm = out["pgmap"]
    print(f"  data:    {pm['num_pools']} pools, {pm['num_pgs']} pgs, "
          f"{pm['num_objects']} objects, {pm['data_bytes']} bytes")
    io = out["io"]
    print(f"  io:      {io['op_per_sec']:.0f} op/s, "
          f"{io['rd_bytes_sec']:.0f} B/s rd, {io['wr_bytes_sec']:.0f} B/s wr")


def _print_trace(out: dict) -> None:
    """`ceph trace show` plain renderer: one kept op's cross-daemon
    waterfall, children indented under their parent hop."""
    print(f"trace {out.get('trace')}  client={out.get('client')} "
          f"pool={out.get('pool')} reason={out.get('reason')} "
          f"wall={(out.get('wall_s') or 0) * 1e3:.3f}ms "
          f"osd={out.get('osd')}")
    if out.get("launch"):
        print(f"  launch: {out['launch']}")
    print(f"  {'HOP':<20} {'ENTITY':<12} {'START_MS':>9} "
          f"{'DUR_MS':>9} {'UNC_US':>7}")
    for s in out.get("hops") or []:
        name = ("  " if s.get("parent") else "") + str(s.get("hop"))
        unc = (s.get("uncertainty_s") or 0.0) * 1e6
        print(f"  {name:<20} {str(s.get('entity')):<12} "
              f"{(s.get('start_s') or 0.0) * 1e3:>9.3f} "
              f"{(s.get('dur_s') or 0.0) * 1e3:>9.3f} {unc:>7.1f}")
    print(f"  path_sum={(out.get('path_sum_s') or 0) * 1e3:.3f}ms "
          f"dominant={out.get('dominant_hop')} "
          f"max_unc={(out.get('max_uncertainty_s') or 0) * 1e6:.1f}us")


def _fmt_log_entry(e: dict) -> str:
    return (f"{e['stamp']:.3f} {e['name']} "
            f"[{e['level'][:3].upper()}] {e['msg']}")


def _watch(args) -> int:
    """`ceph -w`: print the recent cluster log, then follow live."""
    from ..rados.client import resolve_mon_arg

    mon = resolve_mon_arg(args.mon)

    async def run() -> int:
        client = await RadosClient(mon).connect()
        try:
            # subscribe FIRST, then fetch history: entries landing in
            # the subscribe window buffer in the queue instead of being
            # lost; the history set dedupes the overlap
            q = await client.watch_cluster_log()
            code, _status, out = await client.command(
                {"prefix": "log last", "num": 20}
            )
            seen = set()
            if code == 0:
                for e in (out or {}).get("entries", []):
                    seen.add((e["stamp"], e["name"], e["msg"]))
                    print(_fmt_log_entry(e))
            while True:
                e = await q.get()
                key = (e["stamp"], e["name"], e["msg"])
                if key in seen:
                    seen.discard(key)  # overlap with history: once only
                    continue
                print(_fmt_log_entry(e), flush=True)
        except (RadosError, ConnectionError, TimeoutError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        except (KeyboardInterrupt, asyncio.CancelledError):
            return 0
        finally:
            await client.shutdown()

    try:
        return asyncio.run(run())
    except KeyboardInterrupt:
        return 0


def _daemon_command(args) -> int:
    """`ceph daemon <name|socket> <cmd> [args]` — the reference's
    admin-socket passthrough (reference:src/ceph.in admin_socket path):
    one JSON round trip to the daemon's unix socket, no mon needed."""
    words = list(args.words[1:])
    if len(words) < 2:
        print("usage: ceph daemon <name|socket-path> <command...>",
              file=sys.stderr)
        return 2
    target, *rest = words
    if "/" in target or target.endswith(".asok"):
        path = target
    else:
        from ..common import Config

        pattern = Config().admin_socket  # env/CEPH_TPU_ARGS layered
        if not pattern:
            print("error: no admin_socket configured (set CEPH_TPU_ARGS="
                  "'--admin_socket /path/{name}.asok' or pass a socket "
                  "path)", file=sys.stderr)
            return 1
        path = pattern.replace("{name}", target)

    async def run() -> int:
        from ..common.admin_socket import admin_command

        try:
            # the daemon's own command registry decides where the
            # multi-word prefix ends — a client-side vocabulary would
            # silently drift from what daemons register (`help` is
            # built into every AdminSocket); longest match wins
            known = await admin_command(path, "help")
            prefixes = set(known) if isinstance(known, dict) else set()
            for i in range(len(rest), 0, -1):
                if " ".join(rest[:i]) in prefixes:
                    prefix, leftover = " ".join(rest[:i]), rest[i:]
                    break
            else:
                prefix, leftover = rest[0], rest[1:]
            kw: dict = {}
            positional = []
            for w in leftover:
                if "=" in w:
                    k, _, v = w.partition("=")
                    kw[k] = v
                else:
                    positional.append(w)
            if prefix == "config set" and len(positional) == 2:
                kw.setdefault("name", positional[0])
                kw.setdefault("value", positional[1])
            elif prefix == "log dump" and positional:
                kw.setdefault("num", positional[0])
            elif prefix == "perf reset" and positional:
                # positional subsystem form: `perf reset osd` / `all`
                kw.setdefault("name", positional[0])
            out = await admin_command(path, prefix, **kw)
        except (ConnectionError, OSError) as e:
            print(f"error: {path}: {e}", file=sys.stderr)
            return 1
        print(json.dumps(out, indent=1, sort_keys=True))
        return 0 if not (isinstance(out, dict) and "error" in out) else 1

    return asyncio.run(run())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph", description=__doc__)
    p.add_argument("-m", "--mon")
    p.add_argument("-f", "--format", choices=["plain", "json"],
                   default="plain")
    p.add_argument("-w", "--watch", action="store_true",
                   help="follow the cluster log (like `ceph -w`)")
    p.add_argument("words", nargs="*", help="command words")
    args = p.parse_args(argv)
    if args.words and args.words[0] == "daemon":
        return _daemon_command(args)
    if not args.mon:
        p.error("-m/--mon is required (except for `ceph daemon`)")
    if args.watch:
        if args.words:
            p.error("-w takes no command words")
        return _watch(args)
    if not args.words:
        p.error("command words required (or -w)")
    words = list(args.words)
    extra: dict = {}
    health_detail = False
    if words == ["health", "detail"]:
        words, health_detail = ["health"], True
    # `ceph osd set|unset <flag>` (reference CLI shape)
    if (len(words) == 3 and words[0] == "osd"
            and words[1] in ("set", "unset")):
        extra["flag"] = words.pop()
    # `ceph osd down|out|in <id>` (reference CLI shape)
    if (len(words) == 3 and words[0] == "osd"
            and words[1] in ("down", "out", "in")):
        try:
            extra["id"] = int(words[2])
            words.pop()
        except ValueError:
            pass  # let the mon answer the unknown-command error
    # `ceph pg query <pgid>` / `ceph pg ls [state]` (reference shapes)
    if words[:2] == ["pg", "query"] and len(words) == 3:
        extra["pgid"] = words.pop()
    if words[:2] == ["pg", "ls"] and len(words) == 3:
        extra["states"] = words.pop()
    # `ceph osd map <pool> <object>` (reference CLI shape)
    if words[:2] == ["osd", "map"] and len(words) == 4:
        extra["object"] = words.pop()
        extra["pool"] = words.pop()
    # `ceph osd pool ls detail` / `ceph osd pool rename <src> <dst>`
    if words == ["osd", "pool", "ls", "detail"]:
        extra["detail"] = True
        words = words[:3]
    if words[:3] == ["osd", "pool", "rename"] and len(words) == 5:
        extra["destpool"] = words.pop()
        extra["srcpool"] = words.pop()
    # `ceph osd pool set-quota <pool> max_objects|max_bytes <n>` and
    # `ceph osd pool get-quota <pool>` (reference CLI shapes)
    if words[:3] == ["osd", "pool", "set-quota"] and len(words) == 6:
        extra["val"] = words.pop()
        extra["field"] = words.pop()
        extra["pool"] = words.pop()
    if words[:3] == ["osd", "pool", "get-quota"] and len(words) == 4:
        extra["pool"] = words.pop()
    # `ceph metrics query metric=osd.op window=10 [derive=rate]` and
    # friends: trailing key=value words become params
    if words[:2] in (["metrics", "query"], ["metrics", "ls"],
                     ["metrics", "range"]):
        while len(words) > 2 and "=" in words[-1]:
            k, _, v = words.pop().partition("=")
            extra[k] = v
        # bare third word: the metric (query/range) or glob (ls)
        if len(words) == 3:
            extra["metric" if words[1] != "ls" else "pattern"] = \
                words.pop()
    # `ceph trace show <id>` / `ceph trace ls|top|summary [k=v...]`
    # trailing key=value words become params, like metrics
    if words[:1] == ["trace"] and len(words) >= 2:
        while len(words) > 2 and "=" in words[-1]:
            k, _, v = words.pop().partition("=")
            extra[k] = v
        if words[:2] == ["trace", "show"] and len(words) == 3:
            extra["trace"] = words.pop()
    # `ceph log last [n] [level]` (reference CLI shape)
    if words[:2] == ["log", "last"]:
        for w in words[2:]:
            if w.isdigit():
                extra["num"] = int(w)
            else:
                extra["level"] = w
        words = words[:2]
    prefix = " ".join(words)
    from ..rados.client import resolve_mon_arg

    mon = resolve_mon_arg(args.mon)

    async def run() -> int:
        client = await RadosClient(mon).connect()
        try:
            status = ""
            if prefix in MGR_COMMANDS:
                rc, out = await _mgr_command(
                    client, {"prefix": prefix, **extra}
                )
                if rc:
                    return rc
            else:
                code, status, out = await client.command(
                    {"prefix": prefix, **extra}
                )
                if code < 0:
                    print(f"error: {status}", file=sys.stderr)
                    return 1
            if args.format == "json":
                print(json.dumps(out, indent=1, sort_keys=True))
            elif prefix == "status" and isinstance(out, dict):
                _print_status(out)
            elif prefix == "health" and isinstance(out, dict):
                if health_detail:
                    print(out["health"])
                    for c in out.get("checks", []):
                        print(_fmt_check(c))
                else:
                    detail = "; ".join(
                        c["summary"] for c in out.get("checks", [])
                    )
                    print(out["health"] + (f" {detail}" if detail else ""))
            elif prefix == "pg ls" and isinstance(out, dict):
                print(f"{'PG':<8} {'STATE':<28} {'OBJECTS':>8} "
                      f"{'BYTES':>12} ACTING")
                for r in out.get("pgs", []):
                    print(f"{r['pgid']:<8} {r['state']:<28} "
                          f"{r['objects']:>8} {r['bytes']:>12} "
                          f"{r['acting']} p{r['acting_primary']}")
            elif prefix == "osd map" and isinstance(out, dict):
                print(f"osdmap e{out['epoch']} pool '{out['pool']}' "
                      f"({out['pool_id']}) object '{out['objname']}' -> "
                      f"pg {out['raw_pgid']} ({out['pgid']}) -> up "
                      f"({out['up']}, p{out['up_primary']}) acting "
                      f"({out['acting']}, p{out['acting_primary']})")
            elif prefix == "osd df" and isinstance(out, dict):
                print(f"{'ID':>4} {'STATUS':>7} {'REWEIGHT':>9} "
                      f"{'USED':>12} {'PGS':>5}")
                for n in out.get("nodes", []):
                    print(f"{n['id']:>4} {n['status']:>7} "
                          f"{n['reweight']:>9.5f} "
                          f"{n['bytes_used']:>12} {n['pgs']:>5}")
                s = out.get("summary", {})
                print(f"{'TOTAL':>22} {s.get('total_bytes_used', 0):>12} "
                      f"{s.get('total_pgs', 0):>5}")
            elif prefix == "osd tree" and isinstance(out, dict):
                print(f"{'ID':>4} {'CLASS':>5} {'WEIGHT':>9} "
                      f"TYPE NAME{'':<24} STATUS REWEIGHT")
                for n in out.get("nodes", []):
                    name = "  " * n["depth"] + (
                        f"{n['type']} {n['name']}" if n["type"] != "osd"
                        else n["name"]
                    )
                    if n["type"] == "osd":
                        print(f"{n['id']:>4} {n.get('class') or '-':>5} "
                              f"{n['crush_weight']:>9.5f} {name:<33}"
                              f"{n['status']:>7} {n['reweight']:>8.5f}")
                    else:
                        print(f"{n['id']:>4} {'':>5} "
                              f"{n['crush_weight']:>9.5f} {name}")
            elif prefix == "log last" and isinstance(out, dict):
                for e in out.get("entries", []):
                    print(_fmt_log_entry(e))
            elif (prefix in ("trace ls", "trace top")
                  and isinstance(out, dict)):
                print(f"{'TRACE':<14} {'CLIENT':<12} {'POOL':>4} "
                      f"{'REASON':<8} {'DOMINANT':<16} {'WALL_MS':>9}")
                for r in out.get("traces", []):
                    print(f"{str(r.get('trace')):<14} "
                          f"{str(r.get('client')):<12} "
                          f"{str(r.get('pool')):>4} "
                          f"{str(r.get('reason')):<8} "
                          f"{str(r.get('dominant_hop')):<16} "
                          f"{(r.get('wall_s') or 0) * 1e3:>9.3f}")
            elif prefix == "trace show" and isinstance(out, dict):
                _print_trace(out)
            elif prefix == "trace summary" and isinstance(out, dict):
                print(f"{out.get('traces', 0)} kept traces; reasons: "
                      + ", ".join(f"{k}={v}" for k, v in sorted(
                          (out.get("reasons") or {}).items())))
                print(f"{'DOMINANT_HOP':<18} {'COUNT':>6} "
                      f"{'SUM_MS':>10} {'MAX_MS':>10}")
                for h in out.get("dominant_hops", []):
                    print(f"{h['hop']:<18} {h['count']:>6} "
                          f"{h['wall_sum_s'] * 1e3:>10.3f} "
                          f"{h['wall_max_s'] * 1e3:>10.3f}")
            elif isinstance(out, str):
                print(out, end="")
            elif out is None:
                if status:  # status-only replies (e.g. set-quota acks)
                    print(status)
            else:
                print(json.dumps(out, indent=1, sort_keys=True))
            return 0
        except (RadosError, ConnectionError, TimeoutError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        finally:
            await client.shutdown()

    return asyncio.run(run())


if __name__ == "__main__":
    sys.exit(main())
