#!/usr/bin/env python3
"""GPU smoke run of ``ceph_tpu_torch``, the PyTorch + CUDA port of the
erasure-code engine, on one NVIDIA card.

Run from the root of the repository, on a machine with a CUDA card and
the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each fatal on any mismatch or exception:

1. the card: ``nvidia-smi`` name and power limit, and torch's name;
2. build the four Hopper kernels from ``ceph_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build seconds and the
   compiler's register counts;
3. hold each kernel bit-exact against its plain torch version on the
   card: at the main-path shapes, at ragged and misaligned lane counts,
   at w=16, on recovery matrices, on matrices wider than one output
   tile, on jerasure's RS(8,3) matrix, on a matrix with a zero column,
   on k = 255, and on inputs longer than one launch's plan (k = 1000 at
   w=8, k = 200 at w=16; K = 6144 bit-matrix rows); the bit-matrix
   kernel also on rows misaligned by one lane, on the one-erasure
   cauchy_good decode matrix (24 zero columns) and on M = 128 outputs;
   and against the numpy oracle on a column slice;
4. the main path, with the launch counts set to 0 just before it: the
   five BASELINE.json configurations through
   ``registry.instance().factory(...)``, 64 objects of 1 MiB per call
   (a 64 MiB data block), encode, erase, decode, bytes equal to the
   originals and parity equal to ``encode_chunks_host``, then encode and
   decode again from tensors on the card; then the port's
   ``tools/ec_benchmark`` once for encode and once for decode.  Each
   erasure-code kernel must have launched in this phase;
5. time each kernel at its main-path shape (CUDA events, median of many
   launches, one launch between two events for the ``kernels`` line and
   also batches of 20 back-to-back launches) beside its plain version and
   its bound, ``gf_matmul`` also on jerasure's RS(8,3) matrix and on a
   three-erasure ISA recovery matrix, ``bitmatrix_xor`` also on the
   one- and four-erasure cauchy_good decode matrices, each beside its
   own bound; the end-to-end RS(8,3) encode and decode GB/s through the
   registry, with host numpy in and out and device-resident, each with
   the kernel profiler's tap and with it bypassed, in turns; and the
   device-resident cauchy_good k=10 m=4 encode and decode beside the two
   packet-layout copies they make;
6. the OSD EC engine, with the launch counts set to 0 just before it: the
   cross-op microbatch dispatcher built as the OSD builds it (window
   0.0005 s, 512 stripes, bucketing on, launch deadline 30 s, failover on
   under an ``EngineSupervisor``, 2 worker threads, ``create_ec_perf``),
   driving pool A (ISA RS(8,3), stripe unit 4096: 64 concurrent 4 MiB
   writes, then ``decode_concat`` of all 64 with shard 0 lost and with
   shards 1, 5, 9 lost) and pool B (jerasure cauchy_good k=10 m=4,
   packetsize 4096: 64 concurrent 4 MiB objects padded to 13 stripes, then
   a four-erasure ``decode_concat``), every byte of every timed run
   checked against the host engine (pool A is also written a second time,
   and once more through a dispatcher with one worker thread); then one
   pool-A batch with ``inject_engine_failure`` on (its
   waiters must get the same bytes through the host replay) and the
   canary's re-promotion of the card.  Outside the injected batch no op
   may be served off the card (failovers, fallback-direct and
   native-direct all 0), ``gf_matmul`` must launch in pool A and
   ``bitmatrix_xor`` in pool B, and the supervisor must end HEALTHY.  It
   also times the parts of one dispatched 16 MiB ISA launch: the host
   gather, the copy to the card, the permute, the kernel, the
   concatenation, the copy back and the per-op slices;
7. CRUSH bulk placement: ``crush_straw2`` bit-exact against its plain
   version (flat_64's row over 1M lanes; rows with zero weights, one
   item, none, weights from 0x100 to 0x100000; the rows of a 1536-OSD
   map; X = 1, 31 and 1M+7; random r), timed beside its bound; then
   ``crush_choose`` on each of the four single-step cases below over 1M
   lanes bit-exact against its plain version (the step engine's loops
   with ``straw2_plain``), timed beside the bound of the draws it
   counted, with the tile of threads a lane it took, and on two edges of
   its launch (32 slots on the racks map over 65,536 lanes; a take row
   of 12,000 items, too wide to stage, over 8192); then, with the launch
   counts set to 0, the main path: ``CrushTester`` (the ``crushtool
   --test`` engine) over x = 0..999,999 on flat_64 firstn and indep,
   chooseleaf_16x4, 8 racks x 16 hosts x 12 devices (each one
   ``crush_choose`` launch), and the chained LRC rule (the step engine
   on ``crush_straw2``), each twice, three of them a third time under
   ``torch.profiler`` (the card's busy and idle time), and ``crushtool
   --test`` once; then ``CrushTester`` through the fused and the step
   routes in turns on the four single-step cases; then each case's
   whole output equals the plain route (the step engine with the plain
   draw) and the step route (the step engine on ``crush_straw2``), 4096
   evenly spread lanes equal the scalar mapper, and the tester's counts
   equal a count of the output;
8. the cluster map and device-planned churn: ``synthetic_map`` of
   10,240 OSDs (640 hosts of 16) with a replicated pool (size 3,
   chooseleaf firstn over hosts) and an ISA k=8 m=3 pool (chooseleaf
   indep over hosts), both at 65536 PGs; three churn events from it
   (one host down; the same host down and out; a host of 16 added),
   each copied through the wire dict by ``apply_churn``; then, with the
   launch counts set to 0, the main path: ``ChurnPlanner`` on the card
   maps each pool twice and plans each event.  Every mapping and plan
   must come from the device path, ``crush_choose`` must have launched
   (both pools' rules are single-step), every plan must remap PGs, and
   for the down and out events only PGs that held the host's OSDs
   before or hold them after may remap.  Then each pool's
   ``crush_choose`` launch alone (65,536 lanes of 3 and 11 slots under
   the 640-item root), bit-exact against its plain version with the
   draw on ``crush_straw2`` and timed beside the bound of its draws.
   Then ``map_pool`` through the
   fused and the step routes in turns; the whole pre-churn and
   out-event mappings and the out event's plan equal the plain route's,
   every event's mappings and plan equal the step route's, 64 PGs a
   pool of each of the four maps equal the scalar
   ``pg_to_up_acting_osds``, and one ``map_all`` runs under
   ``torch.profiler`` (the card's busy and idle time, ``crush_choose``'s
   share);
9. the shared accelerator service, with the launch counts set to 0 just
   before it: one ``AccelDaemon("accel.0")`` on the card with
   ``Config()``'s dispatcher settings, bound to 127.0.0.1, fed by 4
   simulated OSDs (each an ``AsyncMessenger``, an
   ``AccelClient(mode="require")`` and an ``ECDispatcher`` with that
   remote lane and its own ``EngineSupervisor``; codecs on the CPU, so
   every card launch is the daemon's): phase 6's pool A (64 writes, 16
   from each OSD, then reads with shard 0 and with {1, 5, 9} lost) and
   pool B (64 writes, a four-erasure read), and a jerasure reed_sol_van
   k=8 m=3 w=16 pool (8 objects from 2 OSDs), every byte against the
   host engine and the originals, each step's GB/s beside phase 6's.
   Every OSD's ops must take the remote lane, none the device lane; the
   daemon serves none off the card; ``gf_matmul`` launches in pool A and
   ``bitmatrix_xor`` in pool B; at least one launch is shared by two
   OSDs; every remote flight record names the daemon's ``served`` engine
   and device wall; the daemon's breaker ends HEALTHY.  It prints the
   per-request split (the OSD's round trip, the daemon's queue wait and
   device wall).  Then the daemon is stopped with 8 pool-A ops from 2
   OSDs in flight: every waiter must get the same bytes from its OSD's
   local replay (``origin=remote``) with the OSD's breaker untouched.
   Last, the messenger alone carries pool A encode's frames (no erasure
   code) once.  The phase runs under
   ``asyncio.wait_for``;
10. the accelerator fleet behind the mon: the port's mon in its own
   process (``tools/daemon.py mon`` with a store, watching this
   process), two ``AccelDaemon``s on the card registered through it
   (``accel.a`` at locality host0, ``accel.b`` at host1), and 4
   simulated OSDs each with a map subscription and an
   ``AccelRouter(mode="require")`` fed ``apply_map`` from every push, a
   dispatcher with that remote lane and its own ``EngineSupervisor``
   (the fleet test's beacon and retry intervals, else ``Config()``'s).
   Every router must hold both daemons at the mon's accelmap epoch.
   Then, with the launch counts set to 0: phase 6's pools A and B
   through the fleet (every byte checked; ``gf_matmul`` in pool A,
   ``bitmatrix_xor`` in pool B; no op off the card; both daemons
   launch; the routers' ``accel@<id>`` split sums to their aggregate);
   16 degraded reads whose survivors are labelled mostly host1 must all
   go to ``accel.b`` (locality hits, no misses); ``accel.a`` crashes
   with 8 reads from 2 OSDs in flight on it, and ``accel.b`` must serve
   every one (``failover_next`` >= 1, no local replay, local breakers
   HEALTHY) while the mon's markdown reaches all four routers within
   5 s (the time from the kill is printed); last ``accel.b`` crashes
   with 8 reads in flight, which replay on the OSDs (``origin=remote``),
   and every router reads unreachable.  Each step's GB/s is printed
   beside phase 9's.  The phase runs under ``asyncio.wait_for`` and
   stops the mon process;
11. the operator surface: the port's mon in its own process with a
   store and an admin socket (``CEPH_TPU_ARGS='--admin_socket ...'``),
   ``accel.a`` on the card with an admin socket, registered through the
   mon, and 4 OSD routers as in phase 10.  With the launch counts set to
   0: ``kernel trace start`` over the daemon's socket (600 s asked,
   clamped to ``kernel_trace_max_duration`` 60 s; a second start must be
   refused), phase 6's pools A and B encoded through it (every byte
   checked), ``kernel trace stop`` and ``dump``.  The dump must show
   kernel and copy seconds, ``gf_matmul_kernel`` and
   ``bitmatrix_xor_kernel`` among its top ops, more than half of its
   device seconds attributed to engines and a whole capture (its
   ``capture`` key: as many captured events of each EC kernel as
   launches counted in the window, and no tap interval without a
   captured device event; a short capture fails), and ``dump_kernel_profile``
   the same engines' merged ``device_trace`` buckets; it prints the
   buckets, the top ops, the occupancy and the card's idle share (the
   union of the captured CUDA intervals over the window's wall).  Then
   the daemon's ``dump_launch_history``, ``status`` and ``perf dump``
   over the socket must equal its own objects read around them, and the
   mon's ``perf dump`` and ``config show`` answer.  Last, two
   ``MgrDaemon``s in this process: ``mgr.x`` active from its beacon,
   ``accel.a``'s ``MDaemonStats`` there within 5 report intervals, its
   ``ec`` counters once each in the prometheus ``metrics``, and after
   ``mgr fail mgr.x`` ``mgr.y`` active with the reports following it.
   The phase runs under ``asyncio.wait_for`` and stops the mon process.
12. the card's EC writes in the stores beneath the OSD, with the launch
   counts set to 0 just before it: pool A's 64 objects of 4 MiB encoded
   through an ``ECDispatcher`` on the card with the OSD's defaults (as in
   phase 6), each shard's transaction built as the reference OSD's EC
   write builds it (the ``{pg}s{shard}`` collection, the rollback
   stash, the truncate, the chunk, the crc table, the object info and
   the PG log entry in one transaction) and committed with
   ``queue_transaction`` into 11 port ``BlueStore``s (``sync="fsync"``,
   no compression), one per shard; every store unmounted and mounted,
   ``fsck()`` clean, each shard's PG log the 64 entries in version
   order; then a degraded read of every object with shard 1 rotten
   under object 0 (a flipped byte of its block file, which must raise
   ``BitrotError``), shard 5's store down and shard 9 holding a wrong
   chunk of object 0 under its old crc table (which must fail
   ``StripeHashes.verify``): the survivors come from
   ``codec.minimum_to_decode``, are read from the stores and decoded by
   ``decode_concat`` on the card, and every object's bytes must equal
   what was written; last, shard 2 on a port ``WalStore``
   (``sync="fsync"``) whose ``crash_after`` fires at the 10th of 16 more
   writes: remounted, the 10 journaled writes read back whole, the 6
   later ones are absent, and every acknowledged object decodes with
   shards 0 and 1 lost, through the WalStore where it holds the object.
   No op may leave the card and ``gf_matmul`` must launch.  It prints the
   write's and the read's GB/s (host clock) and how each splits between
   the stores and the dispatcher.  The phase runs under
   ``asyncio.wait_for``.
13. the port's OSD data path, with the launch counts set to 0 just
   before its traffic: ``MiniCluster(n_osds=14, store_kind="blue")`` on
   the card (one mon, 14 ``OSD``s in this event loop, each with its
   ``ECDispatcher`` on the card, ``osd_max_backfills`` 16); pool A (isa
   k=8 m=3, stripe unit 4096, 8 PGs, ``min_size`` 8) and pool B
   (jerasure cauchy_good k=10 m=4, packetsize 4096, chunk 32768, 4 PGs),
   both profiles set through ``osd erasure-code-profile set`` with their
   ``plugin``.  Through the port's ``RadosClient``, 16 ops in flight:
   64 × 4 MiB ``write_full`` to pool A and 16 to pool B; every object
   read back; one non-primary OSD of object 0's PG killed and every
   object read again; two more killed (that PG loses three shards,
   every pool-B PG three) and every object read again (multi-erasure
   decodes: ``gf_matmul`` and ``bitmatrix_xor``); 16 more pool-A writes
   with the three down; the three restarted, recovery waited for until
   every shard chunk of every object is at its primary's version, and
   everything read once more.  Every read must equal what was written;
   every shard chunk in every OSD's store must equal the host engine's
   encode of its object and its ``StripeHashes`` verify; both kernels
   must launch in the phase, ``gf_matmul`` in the three-down read and in
   the recovery; no OSD's dispatcher or ``ec`` counters may show an op
   served off the card.  It prints each step's GB/s (host clock), the
   recovery's wall time and the launches of each step.  The phase runs
   under ``asyncio.wait_for`` and stops the mon before the OSDs.
14. scrub, repair and a cache tier on the port's OSD, with the launch
   counts set to 0 just before its traffic: the same ``MiniCluster`` of 14
   OSDs on BlueStore, pools A and B as in phase 13, a replicated cache
   pool (size 3, 4 PGs) and a replicated pool for object classes.  32 ×
   4 MiB written to pool A; shards rotted behind the OSDs' backs (object
   0 shard 1's bytes, object 1 shard 9 truncated by a chunk, object 2
   shard 5's crc table, object 3 shards 1, 5 and 9, object 4 shard 0);
   ``scrub_pool`` with repair must name each fault with its kind and
   repair all 7 bad shards, ``gf_matmul`` launching in the repair
   decodes, each repaired shard equal to the host engine's encode under
   its object's crc table; a second scrub must be clean and every read
   equal the write.  Then ``osd_scrub_interval`` 0.5 on one PG's primary
   and one more shard rotted: its background scrub must repair it.  Then
   the cache pool over pool B (``osd tier add``, ``cache-mode
   writeback`` with hit sets of 0.2 s, count 2 and ``cache_min_flush_age``
   0, ``set-overlay``, ``target_max_objects`` 4): 16 × 4 MiB written
   through pool B's name with the tiering agents paused must sit dirty in
   the cache and not in pool B; the agents, started again, must flush all
   16 (``bitmatrix_xor`` launching, every pool-B shard equal to the host
   engine's encode) and evict them; with one pool-B OSD down (a data shard
   of as many objects as can be, no primary), every read must promote
   from pool B through a degraded read (``bitmatrix_xor`` decoding) and
   equal the write.  Last, ``lock``, ``refcount``, ``version`` and
   ``numops`` calls on the replicated pool must answer what the reference
   answers (``CLS_CALLS``), a call on pool A ``-EOPNOTSUPP``, and no OSD
   may have served an op off the card.  It prints the scrub's wall time
   and GB/s, each repair decode's ms, the flush and promote GB/s (host
   clock) and each step's launches.  The phase runs under
   ``asyncio.wait_for`` and stops the mon before the OSDs.
15. the storm, and the OSDs in their own processes, in two parts.  (a)
   phase 13's ``MiniCluster`` of 14 OSDs on BlueStore and pools A and B
   under the port's storm driver, with the launch counts set to 0 just
   before its traffic: ``ClientLoad`` of 4 MiB objects (2 writers, 8
   names each) through ``StormDriver.scenario_single_kill`` on pool A and
   ``scenario_rolling`` (two victims) on pool B, each kill held back
   until 20 writes have been acked since the load started or the last
   victim came back, and each restart until 20 writes issued after the
   victim was marked down have been acked; each must hold the
   reference's invariants (no failed client op, every acked write read
   back byte-identical, every PG scrubbed clean), the single kill's
   device plan (``ChurnPlanner`` on the card) must equal the live remap,
   ``crush_choose`` (``crush_straw2`` for a pool's rule that it does not
   take), ``gf_matmul`` and ``bitmatrix_xor`` must each launch and no
   OSD may serve an op off the card.  (b) the port's
   ``ProcCluster``: a mon and 14 OSD processes (``python -m
   ceph_tpu_torch.tools.daemon``, each opening the card itself) on
   BlueStore, heartbeat 2 s, an admin socket each through
   ``CEPH_TPU_ARGS``, pool A.  64 × 4 MiB ``write_full`` with 16 in
   flight under a ``kernel trace`` window on the OSD that leads the most
   pool-A PGs (its capture must be whole), read back; that OSD
   ``kill -9``'d 0.2 s into 16 × 4 MiB overwrites, its plan from the
   client's maps held against the live remap, restarted, every PG
   scrubbed clean and every object read back (each acked write
   byte-identical, each unacked one a complete version; a read that
   fails, healthy or after the restart, fails the phase); ``rados bench
   a 5 write`` and ``seq`` through the port's ``rados`` CLI; ``ceph osd
   tree`` and ``osd dump`` through the port's ``ceph`` CLI; then every OSD
   process through its socket: it names the card (``arch``) and no op
   left the card (``perf dump``, ``dump_ec_dispatch``), with device-lane
   batches over the 14.  It prints each step's GB/s and wall time (host
   clock), the card's memory in use and the traced process's idle share
   (that process's view only).  Each part runs under
   ``asyncio.wait_for``.
16. the mesh lane on the card, with the launch counts set to 0 just
   before it.  (a) the card's own mesh (``get_mesh_engine(0)``: 1 x 1
   on one card) as the mesh lane of an ``ECDispatcher`` built as phase
   6's: pool A's 64 x 4 MiB encoded, parity equal to a device-lane
   dispatcher's and ``ec_util.encode``'s, then ``decode_concat`` with
   shards {1, 5, 9} lost equal to the originals; the same for jerasure
   reed_sol_van k=8 m=3 w=16 (16 objects).  (b) ``MeshEcEngine(devices=
   [card] * 4)``: pool A (a 1 x 4 grid, the gather over ``shard``) and
   isa k=7 m=3 (16 objects, 4 x 1, the prime-k gather over ``pg``)
   through its dispatcher, bytes equal to (a)'s, reads equal to the
   originals: the only run of the gather copies on a card.  (c) a
   4-OSD ``MiniCluster`` on the card with ``osd_ec_mesh`` on, isa k=2
   m=2 (8 PGs): 16 x 4 MiB writes, ``mesh_encode_calls`` and mesh
   batches above 0, every OSD on the card's mesh engine, a healthy
   read, and a read with one OSD down that reconstructs through the
   mesh; every stored shard equal to a mesh-off cluster's.  (d) one
   ``kernel trace`` window over (b)'s reconstructs and two
   ``probe_gather`` calls: ``mesh_reconstruct`` must show
   ``collective`` (the gather's device-to-device copies) and
   ``fused_op`` (``gf_matmul``) time, and the capture must be whole.
   Every batch of (a) and (b) on the mesh lane and none off the card;
   ``gf_matmul`` must launch in (a), (b) and (c).  It prints each step's
   GB/s (host clock) beside phase 6's, the gather copies' device ms and
   the launches.  The phase runs under ``asyncio.wait_for``.
17. S3 on erasure-coded data pools, with the launch counts set to 0 just
   before its traffic: a 6-OSD ``MiniCluster`` on the card and two RGW
   gateways (``S3Server`` on 127.0.0.1): zone a's data pool isa cauchy
   k=4 m=2 (``gf_matmul``; reed_sol_van's one-shard decode would be the
   XOR program), zone b's jerasure cauchy_good k=4 m=2 packetsize 4096
   (``bitmatrix_xor``), profiles set with ``osd erasure-code-profile
   set``.  Signed SigV2 HTTP: 32 PUTs of 4 MiB into zone a and a
   multipart upload of 8 parts of 5 MiB, GETs of every object equal to the
   originals and one ranged GET; a ``ZoneSyncer`` full pass copies zone
   a's bucket into zone b, and GETs through b's gateway equal the
   originals; the shards of two data objects a zone in the OSDs' stores
   equal a CPU codec's encode of their bytes; then the OSD holding data
   shard 0 of zone a's first backing object is killed, and GETs of every
   object of both zones equal the originals.  ``gf_matmul`` must launch
   in the PUTs, ``bitmatrix_xor`` in the sync, and both in the degraded
   GETs; no OSD serves an op off the card.  It prints each step's GB/s
   (host clock) beside phase 13's write and reads and each step's
   launches.  The phase runs under ``asyncio.wait_for``.
18. CephFS on an erasure-coded data pool, and RBD, with the launch counts
   set to 0 just before its traffic: a 6-OSD ``MiniCluster`` on the card,
   ``mds.a`` active with its data pool isa cauchy k=4 m=2 (set with ``osd
   erasure-code-profile set``) and ``mds.b`` standing by, a mounted
   ``CephFSClient``.  32 files of 4 MiB across 4 directories; three
   unaligned 1 MiB overwrites into one file (read-modify-write in the
   OSDs, the last past its end), a truncate and a rename across
   directories; every file reads back equal; the shards of two data
   objects equal a CPU codec's encode; ``mds.a`` killed, and once ``mds.b``
   is active the ``readdir`` and ``stat`` of every path equal what they
   were; the OSD holding data shard 0 of the first file's first object
   killed, and every file reads back equal.  Then RBD on two replicated
   pools of the same cluster: a journaled 64 MiB image written in 16 x 4
   MiB, a snapshot, a clone flattened, a mirror bootstrapped into the
   second pool and 4 later writes replayed from the journal, and ``rbd
   export`` of the mirror equal to the source's.  ``gf_matmul`` must
   launch in the writes, the overwrites and the degraded reads; no OSD
   serves an op off the card.  It prints each step's GB/s (host clock)
   beside phase 17's PUT and GETs, the failover's seconds, and each
   step's launches (the RBD step's should be 0).  The phase runs under
   ``asyncio.wait_for``.

Output: the card line, a ``{"kernels": [...]}`` line (each kernel's
``launches`` on its main path, phase 4 or 7 (both CRUSH kernels), with ``launches_osd_engine``
from phase 6, ``launches_churn`` from phase 8,
``launches_accel_service`` from phase 9, ``launches_accel_fleet``
from phase 10, ``launches_observability`` from phase 11 and
``launches_osd_stores`` from phase 12, ``launches_osd_cluster`` from
phase 13, ``launches_osd_scrub_tier`` from phase 14, and from phase 15
``launches_storm``, part (a)'s launches in this process, and
``launches_proc_cluster``, the traced OSD process's captured launches,
beside it, ``launches_mesh`` from phase 16, ``launches_rgw`` from
phase 17 and ``launches_cephfs`` from phase 18), and last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

OBJECTS = 64
OBJECT_SIZE = 1 << 20
SEED = 20261017

# phase 6: the OSD's dispatcher defaults (ceph_tpu/common/config.py:261-300)
# and object size (RBD's default 4 MiB objects)
OSD_WINDOW_S = 0.0005
OSD_MAX_STRIPES = 512
OSD_LAUNCH_DEADLINE_S = 30.0
OSD_PROBE_INTERVAL_S = 1.0
OSD_WORKERS = 2
OSD_OBJECT_SIZE = 4 << 20
OSD_OPS = 64
# pool A: ISA RS(8,3) with Ceph's default stripe unit (chunk) of 4096
POOL_A = ("isa", {"k": "8", "m": "3"}, 4096)
# pool B: the BASELINE jerasure cauchy_good k=10 m=4, packetsize 4096
# (its chunk is w * packetsize = 32768)
POOL_B = ("jerasure", {"technique": "cauchy_good", "k": "10", "m": "4",
                       "packetsize": "4096"}, 32768)

# H100 SXM device memory rate (NVIDIA data sheet)
MEMORY_BYTES_PER_S = 3.35e12
# 32-bit integer add / logical / shift / multiply results per clock per
# SM on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput table); times SMs and the maximum SM clock
INT32_OPS_PER_CLOCK_PER_SM = 64
# integer operations of one GF doubling on a packed lane, at the least:
# a PRMT that copies each symbol's high bit over the symbol, an AND and a
# shift for (x & low) << 1, and one three-input LOP3 that XORs in the
# high mask ANDed with the polynomial (ceph_tpu_torch/csrc/gf_matmul.cu
# gf_double)
OPS_PER_DOUBLING = 4

# phase 7: CRUSH inputs per case (crushtool --test --max-x 999999), lanes
# checked against the scalar mapper per case
CRUSH_X = 1_000_000
CRUSH_SAMPLE = 4096

# phase 8: a 10k-OSD cluster (tests/test_churn.py:200's shape, 640 hosts
# of 16) whose two pools sit at Ceph's mon_max_pool_pg_num default, 65536
# PGs each: 917,504 PG shards, about 90 an OSD (mon_target_pg_per_osd's
# default is 100); PGs a pool of each map checked against the scalar walk
CHURN_OSDS = 10_240
CHURN_OSDS_PER_HOST = 16
CHURN_PG_NUM = 65536
CHURN_EC = {"plugin": "isa", "k": "8", "m": "3"}
CHURN_SAMPLES = 64

# plugin, profile, erasure sets to decode (chunk positions)
CONFIGS = [
    ("jerasure", {"technique": "reed_sol_van", "k": "2", "m": "1"}, [[0], [2]]),
    ("isa", {"k": "8", "m": "3"}, [[0], [1, 5, 9]]),
    ("jerasure", {"technique": "cauchy_good", "k": "10", "m": "4",
                  "packetsize": "4096"}, [[3], [0, 4, 11, 13]]),
    # BASELINE.json names l=4, which the reference rejects (k and m must
    # be multiples of (k+m)/l); l=3 is the valid neighbour, checked below
    ("lrc", {"k": "8", "m": "4", "l": "3"}, [[0], [0, 1, 4]]),
    ("shec", {"k": "8", "m": "4", "c": "3"}, [[2], [0, 1, 2]]),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def check_equal(what: str, got, want) -> None:
    import torch

    if tuple(got.shape) != tuple(want.shape) or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel differs from its plain version")


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max().item())


def time_cuda(fn, reps: int, warmup: int = 3, batch: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` samples, each ``batch``
    back-to-back calls between two CUDA events on the current stream,
    divided by ``batch``.  One call a sample (the ``kernels`` line) also
    counts the host's launch gap; a batch keeps the card from waiting on
    the host between calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def time_wall(fn, reps: int, warmup: int = 1) -> float:
    """Median seconds of ``fn`` (which ends synchronised) on the host clock."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions ---------------------------


def xor_ops(terms_per_output) -> int:
    """Least integer operations that XOR t terms into each output: the
    first term is a move into the zeroed accumulator, and one
    three-input LOP3 folds two more, so t // 2 for each output."""
    return sum(int(t) // 2 for t in terms_per_output)


def gf_ops(matrix: np.ndarray, n4: int) -> int:
    """Integer operations of the doubling method for ``matrix`` over n4
    lanes: each input row's chain up to its highest needed bit, plus the
    folded XORs of each output's set coefficient bits."""
    matrix = np.asarray(matrix, dtype=np.int64)
    doublings = sum(int(np.bitwise_or.reduce(col)).bit_length() - 1
                    for col in matrix.T if col.any())
    terms = [sum(bin(int(c)).count("1") for c in row) for row in matrix]
    return n4 * (OPS_PER_DOUBLING * doublings + xor_ops(terms))


def used_rows(matrix: np.ndarray) -> int:
    """Input rows the matrix reads: a zero column's row is never read."""
    return int(np.count_nonzero(np.asarray(matrix).any(axis=0)))


def check_kernels(dev, rng) -> dict:
    """Every kernel bit-exact against its plain version on the card;
    returns the main-path inputs and errors for the timing phase."""
    import torch

    from ceph_tpu_torch.ops import gf_cuda, gf_torch, matrices as mx
    from ceph_tpu_torch.ops.gf import gf
    from ceph_tpu_torch.models.matrix_codec import _gf2_invert
    from ceph_tpu_torch.tools.gf_matmul_sweep import cauchy_decode_bitmatrix

    def lanes(rows: int, n4: int):
        return torch.from_numpy(
            rng.integers(-(1 << 31), 1 << 31, size=(rows, n4), dtype=np.int64)
            .astype(np.int32)
        ).to(dev)

    def gf_case(what, matrix, w, d32):
        got = gf_cuda.gf_matmul(gf_cuda.gf_table(matrix, w, dev), d32)
        want = gf_torch.gf_matmul_u32(matrix, d32, w)
        torch.cuda.synchronize()
        check_equal(f"gf_matmul {what}", got, want)
        return got, want

    def bm_case(what, bm, p32):
        got = gf_cuda.bitmatrix_xor(gf_cuda.bitmatrix_table(bm, dev), p32)
        want = gf_torch.bitmatrix_matmul_u32(bm, p32)
        torch.cuda.synchronize()
        check_equal(f"bitmatrix_xor {what}", got, want)
        return got, want

    # GF kernel: main path is ISA RS(8,3) over 64 x 1 MiB objects
    k, m = 8, 3
    rs = mx.isa_rs_vandermonde(k, m)
    n4_main = OBJECTS * OBJECT_SIZE // k // 4
    d_main = lanes(k, n4_main)
    got, want = gf_case("RS(8,3) full shape", rs, 8, d_main)
    gf_err = max_abs_err(got, want)
    # the numpy oracle on a column slice
    cols = np.ascontiguousarray(d_main[:, :4096].cpu().numpy()).view(np.uint8)
    oracle = gf(8).matmul_region(rs, cols)
    if not np.array_equal(got[:, :4096].cpu().numpy().view(np.uint8), oracle):
        raise AssertionError("gf_matmul differs from the numpy oracle")
    for n4 in (1, 3, 5, 1021, 4 * 4096 * 16 + 3):  # ragged lane counts
        gf_case(f"RS(8,3) n4={n4}", rs, 8, lanes(k, n4))
    # 4 KiB objects: 128 lanes a chunk row, misaligned by one lane
    buf = lanes(1, k * 128 * OBJECTS + 1)
    gf_case("RS(8,3) misaligned", rs, 8, buf[0, 1:].view(k, 128 * OBJECTS))
    gf_case("RS(4,2) w=16", mx.rs_vandermonde(4, 2, 16), 16, lanes(4, n4_main // 2))
    gf_case("RS(4,2) w=16 ragged", mx.rs_vandermonde(4, 2, 16), 16, lanes(4, 777))
    present = [0, 2, 3, 4, 6, 7, 8, 9]  # rows 1 and 5 lost
    g = np.vstack([np.eye(k, dtype=np.int64), rs])
    recovery = gf(8).invert_matrix(g[present])
    gf_case("recovery matrix", recovery, 8, lanes(k, n4_main))
    wide = rng.integers(0, 256, size=(20, 10))  # two output tiles
    gf_case("20x10 two tiles", wide, 8, lanes(10, 12345))
    jerasure = mx.rs_vandermonde(k, m, 8)  # every chain 7 long
    gf_case("jerasure RS(8,3) full shape", jerasure, 8, d_main)
    gf_case("RS(8,3) m=3 ragged", rs, 8, lanes(k, 2 * 2048 * 132 + 1023))
    zero_col = rs.copy()
    zero_col[:, 5] = 0  # no output takes input row 5
    gf_case("zero column", zero_col, 8, lanes(k, 300000))
    k255 = rng.integers(0, 256, size=(1, 255))  # k + m = 256, many ring stages
    gf_case("k=255", k255, 8, lanes(255, 40000))
    gf_case("5x8 in a tile of 6", rng.integers(0, 256, size=(5, 8)), 8, lanes(8, 99999))
    # input rows past one plan: launches that accumulate, vector and scalar stores
    gf_case("16x1000 w=8", rng.integers(0, 256, size=(16, 1000)), 8, lanes(1000, 4096))
    gf_case("4x200 w=16 ragged", rng.integers(0, 1 << 16, size=(4, 200)), 16,
            lanes(200, 3001))

    # bit-matrix kernel: main path is cauchy_good k=10 m=4 w=8, ps=4096
    k, m, w = 10, 4, 8
    bm = gf(w).matrix_to_bitmatrix(mx.cauchy_good(k, m, w))
    chunk = 4 * w * 4096  # 1 MiB / k rounded up to w*packetsize
    n4_bm = OBJECTS * chunk // w // 4
    p_main = lanes(k * w, n4_bm)
    got_b, want_b = bm_case("cauchy_good(10,4) full shape", bm, p_main)
    bm_err = max_abs_err(got_b, want_b)
    for n4 in (1, 3, 1021):
        bm_case(f"cauchy_good n4={n4}", bm, lanes(k * w, n4))
    lost = [1, 12]  # one data chunk and one parity chunk
    use = [c for c in range(k + m) if c not in lost][:k]
    eye = np.eye(k * w, dtype=np.uint8)
    gen = np.vstack([eye, bm])
    rows = np.concatenate([gen[c * w:(c + 1) * w] for c in use])
    rb = _gf2_invert(rows)
    bm_case("recovery bit-matrix", rb[w:2 * w], lanes(k * w, n4_bm))
    bm16 = gf(16).matrix_to_bitmatrix(mx.cauchy_good(4, 4, 16))  # M = 64
    bm_case("cauchy_good(4,4) w=16", bm16, lanes(64, 4099))
    wide_bm = (rng.random((80, 40)) < 0.5).astype(np.uint8)  # two tiles
    bm_case("80x40 two tiles", wide_bm, lanes(40, 5000))
    for mt_rows in (5, 12, 30):  # the narrower tiles
        bm_case(f"{mt_rows} outputs", bm[:mt_rows], lanes(k * w, 999))
    # rows misaligned by one lane: the producer's plain loads, not bulk copies
    buf = lanes(1, k * w * 8192 + 1)
    bm_case("misaligned rows", bm, buf[0, 1:].view(k * w, 8192))
    decode1 = cauchy_decode_bitmatrix([3])  # [8, 104], 24 zero columns
    p_decode1 = lanes(decode1.shape[1], n4_bm)
    bm_case("one-erasure decode [8, 104]", decode1, p_decode1)
    decode4 = cauchy_decode_bitmatrix([0, 4, 11, 13])  # [32, 80]
    bm_case("four-erasure decode [32, 80]", decode4, p_main)
    k6144 = (rng.random((8, 6144)) < 0.4).astype(np.uint8)  # chunks of used rows
    bm_case("K=6144", k6144, lanes(6144, 1000))
    m128 = (rng.random((128, 80)) < 0.35).astype(np.uint8)  # four output tiles
    bm_case("M=128", m128, lanes(80, 4099))
    return {
        "gf": (rs, d_main, gf_err),
        "gf_more": {"jerasure RS(8,3)": jerasure,
                    "ISA RS(8,3) recovery of 3": recovery3(rs)},
        "bitmatrix": (bm, p_main, bm_err),
        "bitmatrix_more": {"cauchy_good decode of 1 erasure": (decode1, p_decode1),
                           "cauchy_good decode of 4 erasures": (decode4, p_main)},
    }


def recovery3(rs: np.ndarray) -> np.ndarray:
    """The [3, 8] matrix that a decode of ISA RS(8,3) launches to rebuild
    data chunks 1, 5 and 7 from the first 8 survivors, built as
    ``MatrixErasureCode`` builds it."""
    from ceph_tpu_torch.ops import matrices as mx

    k = rs.shape[1]
    lost = [1, 5, 7]
    present = [c for c in range(k + rs.shape[0]) if c not in lost][:k]
    return mx.decode_matrix(rs, k, 8, present)[lost]


# -- phase 4: the main path ----------------------------------------------------


def run_config(plugin: str, profile: dict, erasure_sets, dev, rng) -> None:
    from ceph_tpu_torch.models import registry

    codec = registry.instance().factory(plugin, dict(profile))
    if codec.device != dev:
        raise AssertionError(f"{plugin} codec on {codec.device}, expected {dev}")
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    C = codec.get_chunk_size(OBJECT_SIZE)
    data = rng.integers(0, 256, size=(k, OBJECTS * C), dtype=np.uint8)
    t0 = time.perf_counter()
    parity = codec.encode_chunks(data)
    t_enc = time.perf_counter() - t0
    host = codec.encode_chunks_host(data)
    if not np.array_equal(parity, host):
        raise AssertionError(f"{plugin} {profile}: parity differs from encode_chunks_host")
    log(f"  {plugin} {profile}: [{k}, {OBJECTS * C}] encode ok, parity == host oracle "
        f"({t_enc:.3f} s host clock, first call)")
    mapping = codec.get_chunk_mapping() or list(range(k))
    coding = [i for i in range(n) if i not in mapping]
    full = {pos: data[r] for r, pos in enumerate(mapping)}
    full.update({pos: parity[r] for r, pos in enumerate(coding)})
    for erased in erasure_sets:
        avail = {i: c for i, c in full.items() if i not in erased}
        t0 = time.perf_counter()
        out = codec.decode(list(erased), avail)
        t_dec = time.perf_counter() - t0
        for e in erased:
            if not np.array_equal(out[e], full[e]):
                raise AssertionError(f"{plugin} {profile}: chunk {e} differs after decode of {erased}")
        log(f"  {plugin} {profile} erased {erased}: decode ok ({t_dec:.3f} s host clock)")
    # device-resident: tensors in, tensors out, on the card throughout
    import torch

    parity_t = codec.encode_chunks(torch.from_numpy(data).to(dev))
    if not (isinstance(parity_t, torch.Tensor) and parity_t.device == dev
            and np.array_equal(parity_t.cpu().numpy(), parity)):
        raise AssertionError(f"{plugin} {profile}: device-resident encode differs")
    for erased in erasure_sets:
        present = [i for i in range(n) if i not in erased]
        survivors = torch.from_numpy(np.stack([full[i] for i in present])).to(dev)
        out = codec.decode_chunks(present, survivors, list(erased))
        want = np.stack([full[e] for e in erased])
        if not (isinstance(out, torch.Tensor) and out.device == dev
                and np.array_equal(out.cpu().numpy(), want)):
            raise AssertionError(
                f"{plugin} {profile}: device-resident decode of {erased} differs")
    log(f"  {plugin} {profile}: device-resident encode and decode ok")


def run_main_path(dev, rng) -> None:
    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.models.interface import ErasureCodeValidationError
    from ceph_tpu_torch.tools import ec_benchmark

    try:
        registry.instance().factory("lrc", {"k": "8", "m": "4", "l": "4"})
    except ErasureCodeValidationError as e:
        log(f"  lrc k=8 m=4 l=4 rejected as by the reference: {e}")
    else:
        raise AssertionError("lrc k=8 m=4 l=4 must be rejected")
    for plugin, profile, erasure_sets in CONFIGS:
        run_config(plugin, profile, erasure_sets, dev, rng)
    for workload in ("encode", "decode"):
        argv = ["--plugin", "isa", "-p", "k=8", "-p", "m=3", "--workload", workload,
                "--size", str(OBJECT_SIZE), "--iterations", "10"]
        if workload == "encode":
            argv += ["--batch", str(OBJECTS)]
        log(f"  ec_benchmark {' '.join(argv)}  (<seconds>\\t<KiB>):")
        if ec_benchmark.main(argv) != 0:
            raise AssertionError(f"ec_benchmark {workload} failed")


# -- phase 5: timing -------------------------------------------------------------


def bound_fn(dev, ops_per_clock_per_sm: int = INT32_OPS_PER_CLOCK_PER_SM):
    """bound(nbytes, ops) -> (least ms, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over SMs
    x ops_per_clock_per_sm x the maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    int_ops_per_s = sms * ops_per_clock_per_sm * max_clock_hz
    log(f"  operations peak {int_ops_per_s:.4g} op/s ({sms} SMs x "
        f"{ops_per_clock_per_sm} x {max_clock_hz / 1e6:.0f} MHz); "
        f"memory {MEMORY_BYTES_PER_S:.4g} B/s")

    def bound(nbytes: int, ops: int):
        t_bytes = nbytes / MEMORY_BYTES_PER_S * 1e3
        t_ops = ops / int_ops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    return bound


def time_kernels(dev, inputs: dict, launches: dict) -> list[dict]:
    from ceph_tpu_torch.ops import gf_cuda, gf_torch

    bound = bound_fn(dev)

    rows = []
    rs, d_main, gf_err = inputs["gf"]
    table = gf_cuda.gf_table(rs, 8, dev)
    bt = gf_cuda.bitmatrix_table(inputs["bitmatrix"][0], dev)
    kernel_calls = [lambda: gf_cuda.gf_matmul(table, d_main),
                    lambda: gf_cuda.bitmatrix_xor(bt, inputs["bitmatrix"][1])]
    ms = time_cuda(kernel_calls[0], reps=50)
    plain_ms = time_cuda(lambda: gf_torch.gf_matmul_u32(rs, d_main, 8), reps=5)
    k, n4 = d_main.shape
    m = rs.shape[0]
    b_ms, b_by = bound((used_rows(rs) + m) * n4 * 4, gf_ops(rs, n4))
    rows.append({
        "name": "gf_matmul", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_matmul.cu",
        "replaces": "ceph_tpu/ops/gf_pallas.py:95",
        "launches": launches["gf_matmul"], "max_abs_err": gf_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })
    bm, p_main, bm_err = inputs["bitmatrix"]
    ms = time_cuda(kernel_calls[1], reps=50)
    plain_ms = time_cuda(lambda: gf_torch.bitmatrix_matmul_u32(bm, p_main), reps=5)
    K, n4 = p_main.shape
    M = bm.shape[0]
    b_ms, b_by = bound((used_rows(bm) + M) * n4 * 4,
                       xor_ops(np.count_nonzero(bm, axis=1)) * n4)
    rows.append({
        "name": "bitmatrix_xor", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/bitmatrix_xor.cu",
        "replaces": "ceph_tpu/ops/gf_pallas.py:151",
        "launches": launches["bitmatrix_xor"], "max_abs_err": bm_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })
    for r, fn in zip(rows, kernel_calls):
        log(f"  {r['name']}: {r['ms']} ms one launch a sample, "
            f"{time_cuda(fn, reps=50, batch=20)} ms in batches of 20 (bound "
            f"{r['bound_ms']} ms by {r['bound_by']}, plain {r['plain_ms']} ms; one "
            f"launch a sample is {r['bound_ms'] / r['ms']:.1%} of bound)")
    k, n4 = d_main.shape
    for what, matrix in inputs["gf_more"].items():
        t = gf_cuda.gf_table(matrix, 8, dev)
        ms = time_cuda(lambda: gf_cuda.gf_matmul(t, d_main), reps=50)
        batched = time_cuda(lambda: gf_cuda.gf_matmul(t, d_main), reps=50, batch=20)
        b_ms, b_by = bound((used_rows(matrix) + matrix.shape[0]) * n4 * 4,
                           gf_ops(matrix, n4))
        log(f"  gf_matmul {what} over [{k}, {n4}]: {ms} ms one launch a sample, "
            f"{batched} ms in batches of 20 (bound {b_ms} ms by {b_by}, "
            f"{b_ms / batched:.1%} of bound in batches)")
    for what, (matrix, p32) in inputs["bitmatrix_more"].items():
        t = gf_cuda.bitmatrix_table(matrix, dev)
        ms = time_cuda(lambda: gf_cuda.bitmatrix_xor(t, p32), reps=50)
        batched = time_cuda(lambda: gf_cuda.bitmatrix_xor(t, p32), reps=50, batch=20)
        b_ms, b_by = bound((used_rows(matrix) + matrix.shape[0]) * p32.shape[1] * 4,
                           xor_ops(np.count_nonzero(matrix, axis=1)) * p32.shape[1])
        log(f"  bitmatrix_xor {what} {list(matrix.shape)} over {list(p32.shape)}: {ms} ms "
            f"one launch a sample, {batched} ms in batches of 20 (bound {b_ms} ms by "
            f"{b_by}, {b_ms / batched:.1%} of bound in batches)")
    return rows


def time_end_to_end(dev, rng) -> dict:
    import torch

    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.ops.profiler import KernelProfiler, profiler

    codec = registry.instance().factory("isa", {"k": "8", "m": "3"})
    k = codec.get_data_chunk_count()
    C = codec.get_chunk_size(OBJECT_SIZE)
    data = rng.integers(0, 256, size=(k, OBJECTS * C), dtype=np.uint8)
    parity = codec.encode_chunks(data)
    chunks = np.concatenate([data, parity])
    present, missing = list(range(1, k + 1)), [0]
    survivors = chunks[present]
    data_t = torch.from_numpy(data).to(dev)
    survivors_t = torch.from_numpy(survivors).to(dev)
    nbytes = OBJECTS * OBJECT_SIZE

    def dev_encode():
        codec.encode_chunks(data_t)
        torch.cuda.synchronize()

    def dev_decode():
        codec.decode_chunks(present, survivors_t, missing)
        torch.cuda.synchronize()

    def dev_encode_x10():  # a caller that keeps the card fed
        for _ in range(10):
            codec.encode_chunks(data_t)
        torch.cuda.synchronize()

    cases = {
        "encode_host_numpy": (lambda: codec.encode_chunks(data), 10),
        "decode_host_numpy": (lambda: codec.decode_chunks(present, survivors, missing), 10),
        "encode_device_resident": (dev_encode, 20),
        "decode_device_resident": (dev_decode, 20),
        "encode_device_resident_10_back_to_back": (dev_encode_x10, 10),
    }
    # the codec entries pass through the kernel profiler's tap; time them
    # with the tap and with it bypassed, in turns (on, off, off, on)
    tap = KernelProfiler.call_jitted

    def bypass(self, engine, key, fn, args, *, nbytes=0, shape=None, wrap=None):
        out = fn(*args)
        return out if wrap is None else wrap(out)

    times = {key: {"on": [], "off": []} for key in cases}
    try:
        for mode in ("on", "off", "off", "on"):
            KernelProfiler.call_jitted = tap if mode == "on" else bypass
            for key, (fn, reps) in cases.items():
                times[key][mode].append(time_wall(fn, reps))
    finally:
        KernelProfiler.call_jitted = tap
    # the tap times a call on the card between CUDA events, read later
    profiler().reset()
    for _ in range(20):
        codec.encode_chunks(data_t)
    eng = profiler().dump()["engines"]["gf_encode"]
    tap_s = eng["exec_time"] + eng["first_exec_s"]
    if eng["calls"] != 20 or not tap_s > 0:
        raise AssertionError(f"profiler tap on the card: {eng}")
    log(f"  profiler gf_encode, 20 device-resident calls back to back: "
        f"{tap_s / 20 * 1e3:.4f} ms a call on the card (CUDA events)")
    gbps = {}
    for key, t in times.items():
        on, off = statistics.median(t["on"]), statistics.median(t["off"])
        n = 10 * nbytes if key.endswith("back_to_back") else nbytes
        gbps[key] = n / on / 1e9
        log(f"  isa RS(8,3) {key}: {gbps[key]:.3f} GB/s ({on * 1e3:.4f} ms for "
            f"{n // nbytes} x {OBJECTS} x 1 MiB objects, host clock); profiler tap bypassed "
            f"{n / off / 1e9:.3f} GB/s ({off * 1e3:.4f} ms); each pass, ms: "
            f"on {[round(x * 1e3, 4) for x in t['on']]}, "
            f"off {[round(x * 1e3, 4) for x in t['off']]}")
    return gbps


def time_packet_layout(dev, rng) -> None:
    """Device-resident jerasure cauchy_good k=10 m=4 encode and decode
    (one erasure) on the host clock, beside the two packet-layout copies
    of ``BitmatrixErasureCode`` ([n, C] chunks <-> [n*w, B*ps] packet
    rows) that they make around the kernel, timed alone."""
    import torch

    from ceph_tpu_torch.models import registry

    codec = registry.instance().factory(
        "jerasure", {"technique": "cauchy_good", "k": "10", "m": "4", "packetsize": "4096"})
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    C = codec.get_chunk_size(OBJECT_SIZE)
    data_t = torch.from_numpy(
        rng.integers(0, 256, size=(k, OBJECTS * C), dtype=np.uint8)).to(dev)
    parity_t = codec.encode_chunks(data_t)
    chunks_t = torch.cat([data_t, parity_t])
    present, missing = [c for c in range(n) if c != 3], [3]
    survivors_t = chunks_t[present].contiguous()
    packets_out = codec._to_packets(parity_t)  # [m*w, B*ps], as the kernel gives it

    def dev_encode():
        codec.encode_chunks(data_t)
        torch.cuda.synchronize()

    def dev_decode():
        codec.decode_chunks(present, survivors_t, missing)
        torch.cuda.synchronize()

    encode_s = time_wall(dev_encode, 20)
    decode_s = time_wall(dev_decode, 20)
    to_ms = time_cuda(lambda: codec._to_packets(data_t), reps=20, batch=20)
    from_ms = time_cuda(lambda: codec._from_packets(packets_out, codec.m), reps=20, batch=20)
    nbytes = OBJECTS * OBJECT_SIZE
    log(f"  cauchy_good(10,4) encode_device_resident: {encode_s * 1e3:.4f} ms host clock "
        f"({nbytes / encode_s / 1e9:.3f} GB/s of object data); decode of 1 erasure "
        f"{decode_s * 1e3:.4f} ms ({nbytes / decode_s / 1e9:.3f} GB/s)")
    log(f"  packet layout copies alone, batches of 20: _to_packets of the data "
        f"{list(data_t.shape)} {to_ms} ms, _from_packets of the parity "
        f"{list(packets_out.shape)} {from_ms} ms; together "
        f"{(to_ms + from_ms) / (encode_s * 1e3):.1%} of the device-resident encode")


# -- phase 6: the OSD EC engine ----------------------------------------------------


def _delta(before: dict, after: dict) -> dict:
    """after - before over the numbers of two nested dispatcher dumps."""
    out = {}
    for key, value in after.items():
        if isinstance(value, dict):
            out[key] = _delta(before.get(key, {}), value)
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            out[key] = value - before.get(key, 0)
    return out


def _pool_line(name: str, before: dict, after: dict) -> str:
    d = _delta(before, after)
    t = d["totals"]
    buckets = {k: v for k, v in d["buckets"].items() if v}
    return (f"  {name}: ops {t['ops']}, stripes {t['stripes']}, batches {t['batches']}, "
            f"flush {t['flush_reasons']}, pad stripes {t['pad_stripes']}, buckets {buckets}")


def _check_shards(what: str, got: dict, want: dict) -> None:
    if sorted(got) != sorted(want) or any(
            not np.array_equal(np.asarray(got[s]), np.asarray(want[s])) for s in want):
        raise AssertionError(f"{what}: shards differ from the host engine's")


def time_launch_breakdown(dev, codec, sinfo, objs) -> dict:
    """The parts of one dispatched ISA launch of OSD_MAX_STRIPES stripes,
    each timed alone: host gather of the ops' payloads into one buffer,
    copy to the card, the permute to shard rows, the kernel, the
    concatenation of data and parity rows, the copy back, and the per-op
    shard slices the waiters get; beside the whole ``ec_util.encode``
    call on the gathered buffer.  Host parts on the host clock (ending
    synchronised), device parts with CUDA events in batches of 20."""
    import torch

    from ceph_tpu_torch.osd import ec_util

    sw, cs = sinfo.stripe_width, sinfo.chunk_size
    k = codec.get_data_chunk_count()
    per_op = len(objs[0]) // sw

    def gather():
        cat = np.zeros(OSD_MAX_STRIPES * sw, dtype=np.uint8)
        for i, o in enumerate(objs):
            cat[i * per_op * sw:(i + 1) * per_op * sw] = o
        return cat

    cat = gather()
    d3 = cat.view(np.int32).reshape(OSD_MAX_STRIPES, k, cs // 4)

    def h2d():
        x = torch.from_numpy(d3).to(dev)
        torch.cuda.synchronize()
        return x

    x = h2d()
    flat = x.permute(1, 0, 2).reshape(k, -1)
    parity = codec._engine(flat)
    out = torch.cat([flat, parity])
    host_out = out.cpu().numpy()

    def slices():
        return [{s: host_out[s][i * per_op * cs // 4:(i + 1) * per_op * cs // 4].copy()
                 for s in range(host_out.shape[0])} for i in range(len(objs))]

    def d2h():
        out.cpu().numpy()

    def whole():
        ec_util.encode(sinfo, codec, cat)

    parts = {
        "host gather": time_wall(gather, 10) * 1e3,
        "copy to the card": time_wall(h2d, 10) * 1e3,
        "permute": time_cuda(lambda: x.permute(1, 0, 2).reshape(k, -1), reps=20, batch=20),
        "kernel": time_cuda(lambda: codec._engine(flat), reps=20, batch=20),
        "cat": time_cuda(lambda: torch.cat([flat, parity]), reps=20, batch=20),
        "copy back": time_wall(d2h, 10) * 1e3,
        "per-op slices": time_wall(slices, 10) * 1e3,
    }
    whole_ms = time_wall(whole, 10) * 1e3
    # the same call as the dispatcher makes it: on a freshly gathered
    # buffer each time, and from a worker thread
    fresh_ms = time_wall(lambda: ec_util.encode(sinfo, codec, gather()), 10) * 1e3
    n = per_op * cs

    def cycle():  # what one dispatcher worker does for one launch
        out = ec_util.encode(sinfo, codec, gather())
        return [{s: a[i * n:(i + 1) * n].copy() for s, a in out.items()}
                for i in range(len(objs))]

    with ThreadPoolExecutor(1) as pool:
        worker_ms = time_wall(lambda: pool.submit(whole).result(), 10) * 1e3
        cycle_ms = time_wall(lambda: pool.submit(cycle).result(), 10) * 1e3
        # the dispatcher's waiters hold their slices, so each launch
        # allocates fresh host memory instead of reusing the last one's
        kept = []
        kept_ms = time_wall(lambda: kept.append(pool.submit(cycle).result()), 10) * 1e3
        del kept
    total = sum(parts.values())
    log(f"  one dispatched ISA launch of {OSD_MAX_STRIPES} stripes "
        f"({OSD_MAX_STRIPES * sw >> 20} MiB in, {host_out.nbytes >> 20} MiB out), "
        f"parts timed alone (ms): " + ", ".join(
            f"{name} {ms} ({ms / total:.1%})" for name, ms in parts.items()))
    log(f"  sum of parts {total} ms; ec_util.encode on the gathered buffer {whole_ms} ms, "
        f"on a fresh gather each call {fresh_ms} ms with the gather, from a worker "
        f"thread {worker_ms} ms; gather, encode and slices in a worker thread "
        f"{cycle_ms} ms, keeping every launch's slices as the waiters do {kept_ms} ms")
    return {"parts_ms": parts, "whole_encode_ms": whole_ms}


def run_osd_engine(dev, rng, figures: dict | None = None) -> dict:
    """Phase 6 (see the module docstring).  ``figures``, when given, gets
    each step's GB/s line (phase 9 prints them beside its own).  Returns
    the kernels' launch counts over the whole drive, counted from one
    reset at its start:
    both pool-A gathers and its decodes, the one-worker run, pool B, the
    canary's probes and the batch after re-promotion (the injected batch
    launches nothing; the launch breakdown's timing launches come after
    and are not counted)."""
    import asyncio

    import torch

    from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.ops.profiler import profiler
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
    from ceph_tpu_torch.osd.ec_failover import HEALTHY, STATE_NAMES, EngineSupervisor
    from ceph_tpu_torch.osd.ec_perf import create_ec_perf

    def make_pool(spec):
        plugin, profile, chunk = spec
        codec = registry.instance().factory(plugin, dict(profile))
        if codec.device != dev:
            raise AssertionError(f"{plugin} codec on {codec.device}, expected {dev}")
        k = codec.get_data_chunk_count()
        return codec, ec_util.StripeInfo(k * chunk, chunk)

    codec_a, sinfo_a = make_pool(POOL_A)
    codec_b, sinfo_b = make_pool(POOL_B)
    objs = [rng.integers(0, 256, size=OSD_OBJECT_SIZE, dtype=np.uint8)
            for _ in range(OSD_OPS)]
    objs_b = [np.frombuffer(sinfo_b.pad_to_stripe(o.tobytes()), dtype=np.uint8)
              for o in objs]
    total_bytes = OSD_OPS * OSD_OBJECT_SIZE
    log(f"  pool A: isa k=8 m=3, chunk {sinfo_a.chunk_size}, stripe width "
        f"{sinfo_a.stripe_width}; pool B: cauchy_good k=10 m=4, chunk "
        f"{sinfo_b.chunk_size}, stripe width {sinfo_b.stripe_width}; "
        f"{OSD_OPS} objects of {OSD_OBJECT_SIZE >> 20} MiB "
        f"({len(objs_b[0]) // sinfo_b.stripe_width} stripes each in pool B)")

    perf = PerfCountersCollection()
    pec = create_ec_perf(perf)
    sup = EngineSupervisor(enabled=True, perf=pec, probe_interval=OSD_PROBE_INTERVAL_S)
    launches = {}
    if figures is None:
        figures = {}

    async def main():
        disp = ECDispatcher(
            perf=pec, window=OSD_WINDOW_S, max_stripes=OSD_MAX_STRIPES, bucket=True,
            max_workers=OSD_WORKERS, supervisor=sup,
            launch_deadline=OSD_LAUNCH_DEADLINE_S,
        )

        async def timed(coros):
            t0 = time.perf_counter()
            out = await asyncio.gather(*coros)
            return out, time.perf_counter() - t0

        def gbps(seconds):
            return f"{total_bytes / seconds / 1e9:.3f} GB/s ({seconds * 1e3:.1f} ms)"

        def snapshot():
            torch.cuda.synchronize()
            return dict(gf_cuda.launches)

        def kernel_counts(name, since):
            got = {n: c - since[n] for n, c in snapshot().items()}
            log(f"  launches in {name}: {got}")
            return got

        def off_card(d, name):
            t = d["totals"]
            for key in ("failovers", "fallback_direct", "native_direct", "deadline_timeouts"):
                if t[key]:
                    raise AssertionError(f"{t[key]} {key} in {name}: an op was served off "
                                         "the card")

        # the phase's launches are counted from this one reset
        gf_cuda.reset_launches()
        start = snapshot()
        want_a = [ec_util.encode_fallback(sinfo_a, codec_a, o) for o in objs]

        # pool A
        profiler().reset()
        before = disp.dump()
        shards_a, enc_s = await timed(disp.encode(sinfo_a, codec_a, o) for o in objs)
        again, enc2_s = await timed(disp.encode(sinfo_a, codec_a, o) for o in objs)
        for run in (shards_a, again):
            for i, got in enumerate(run):
                _check_shards(f"pool A op {i}", got, want_a[i])
        del again
        log(f"  pool A encode, {OSD_OPS} x 4 MiB, bytes == encode_fallback in both: first "
            f"gather {gbps(enc_s)}, second {gbps(enc2_s)} (host clock)")
        figures["pool A encode"] = gbps(enc2_s)
        for lost in ((0,), (1, 5, 9)):
            outs, dec_s = await timed(
                disp.decode_concat(sinfo_a, codec_a,
                                   {s: v for s, v in sh.items() if s not in lost})
                for sh in shards_a)
            for i, (o, got) in enumerate(zip(objs, outs)):
                if bytes(got) != o.tobytes():
                    raise AssertionError(f"pool A op {i}: decode_concat of {lost} differs")
            log(f"  pool A decode_concat with shards {list(lost)} lost, bytes == written: "
                f"{gbps(dec_s)} (host clock)")
            figures[f"pool A decode {list(lost)}"] = gbps(dec_s)
        log(_pool_line("pool A", before, disp.dump()))
        launches["pool A"] = kernel_counts("pool A", start)
        shard_eng = profiler().dump()["engines"]["ec_shards"]
        hits = shard_eng["jit_cache"]["hits"]
        log(f"  profiler ec_shards: {shard_eng['calls']} calls, shapes {shard_eng['shapes']}, "
            f"first call {shard_eng['first_exec_s'] * 1e3:.3f} ms, steady state "
            f"{shard_eng['exec_time'] / max(hits, 1) * 1e3:.3f} ms a call over {hits} "
            f"calls ({shard_eng['exec_gbps']} GB/s of input lanes)")
        del shards_a
        # the same writes through a dispatcher with one worker thread:
        # what the second worker's overlap buys, and what it costs each call
        one = ECDispatcher(window=OSD_WINDOW_S, max_stripes=OSD_MAX_STRIPES, max_workers=1)
        profiler().reset()
        one_out, one_s = await timed(one.encode(sinfo_a, codec_a, o) for o in objs)
        await one.stop()
        for i, got in enumerate(one_out):
            _check_shards(f"pool A op {i} through one worker", got, want_a[i])
        off_card(one.dump(), "the one-worker run")
        del one_out, want_a
        one_eng = profiler().dump()["engines"]["ec_shards"]
        log(f"  pool A encode through one worker thread, bytes == encode_fallback: "
            f"{gbps(one_s)}; ec_shards "
            f"{one_eng['exec_time'] / max(one_eng['jit_cache']['hits'], 1) * 1e3:.3f} ms "
            f"a call (host clock)")

        # pool B
        since = snapshot()
        before = disp.dump()
        shards_b, enc_s = await timed(disp.encode(sinfo_b, codec_b, o) for o in objs_b)
        for i, (o, got) in enumerate(zip(objs_b, shards_b)):
            _check_shards(f"pool B op {i}", got, ec_util.encode_fallback(sinfo_b, codec_b, o))
        lost = (0, 4, 11, 13)
        outs, dec_s = await timed(
            disp.decode_concat(sinfo_b, codec_b, {s: v for s, v in sh.items() if s not in lost})
            for sh in shards_b)
        for i, (o, got) in enumerate(zip(objs_b, outs)):
            if bytes(got) != o.tobytes():
                raise AssertionError(f"pool B op {i}: decode_concat of {lost} differs")
        log(f"  pool B encode, {OSD_OPS} objects, bytes == encode_fallback: {gbps(enc_s)}; "
            f"decode_concat with shards {list(lost)} lost, bytes == written: "
            f"{gbps(dec_s)} (host clock, object bytes before padding)")
        figures["pool B encode"] = gbps(enc_s)
        figures[f"pool B decode {list(lost)}"] = gbps(dec_s)
        log(_pool_line("pool B", before, disp.dump()))
        launches["pool B"] = kernel_counts("pool B", since)
        del shards_b, outs

        off_card(disp.dump(), "pools A and B")
        if launches["pool A"]["gf_matmul"] == 0:
            raise AssertionError("gf_matmul was not launched in pool A")
        if launches["pool B"]["bitmatrix_xor"] == 0:
            raise AssertionError("bitmatrix_xor was not launched in pool B")

        # failover: two pool-A launches with the injected fault, then the canary
        batch = objs[:2 * OSD_MAX_STRIPES // (OSD_OBJECT_SIZE // sinfo_a.stripe_width)]
        disp.inject_engine_failure = 1
        replayed, _ = await timed(disp.encode(sinfo_a, codec_a, o) for o in batch)
        disp.inject_engine_failure = 0
        for i, (o, got) in enumerate(zip(batch, replayed)):
            _check_shards(f"injected batch op {i}", got,
                          ec_util.encode_fallback(sinfo_a, codec_a, o))
        t = disp.dump()["totals"]
        log(f"  injected fault: {len(batch)} ops, failovers {t['failovers']}, replayed ops "
            f"{t['replayed_ops']}, supervisor {STATE_NAMES[sup.state]}; bytes == "
            f"encode_fallback")
        if t["failovers"] != 2 or t["replayed_ops"] != len(batch):
            raise AssertionError(f"injected fault: failovers {t['failovers']}, "
                                 f"replayed {t['replayed_ops']}")
        t0 = time.perf_counter()
        while sup.state != HEALTHY:
            if time.perf_counter() - t0 > 60:
                raise AssertionError(f"canary did not re-promote: {sup.dump()}")
            await asyncio.sleep(0.05)
        log(f"  canary re-promoted the card after {time.perf_counter() - t0:.2f} s "
            f"(probes {sup.totals['probes']}, promotions {sup.totals['promotions']})")
        since = snapshot()
        after, _ = await timed(disp.encode(sinfo_a, codec_a, o) for o in batch[:4])
        for i, (o, got) in enumerate(zip(batch, after)):
            _check_shards(f"post-promotion op {i}", got,
                          ec_util.encode_fallback(sinfo_a, codec_a, o))
        launches["after promotion"] = kernel_counts("the batch after re-promotion", since)
        t = disp.dump()["totals"]
        if (t["failovers"], t["fallback_direct"], t["native_direct"]) != (2, 0, 0):
            raise AssertionError(f"ops served off the card outside the injected batch: {t}")
        if launches["after promotion"]["gf_matmul"] == 0:
            raise AssertionError("gf_matmul was not launched after re-promotion")
        if sup.state != HEALTHY:
            raise AssertionError(f"supervisor {STATE_NAMES[sup.state]} at the end")
        log(f"  dispatcher totals: {t}")
        log(f"  ec perf: encode_time {pec.dump()['encode_time']}, "
            f"decode_time {pec.dump()['decode_time']}")
        await disp.stop()
        launches["phase"] = kernel_counts("the whole phase", start)

    asyncio.run(main())
    time_launch_breakdown(dev, codec_a, sinfo_a,
                          objs[:OSD_MAX_STRIPES // (OSD_OBJECT_SIZE // sinfo_a.stripe_width)])
    return launches["phase"]


# -- phase 7: CRUSH bulk placement --------------------------------------------


def crush_cases(rng):
    """The phase-7 maps and rules: (name, map, rule, numrep, weights).

    The four single-step cases of ``gf_matmul_sweep.crush_choose_maps``
    (``CrushMap.flat(64)`` firstn and indep; ``bench.py``'s
    chooseleaf_16x4; 8 racks x 16 hosts x 12 devices, 1536 OSDs with
    uneven device weights, 12 reweighted out or down, chooseleaf firstn
    over hosts), and the chained LRC rule of ``tests/test_crush_vec.py``
    on its rack map (choose 2 racks, then chooseleaf 2 hosts each: the
    rule's four positions)."""
    from ceph_tpu_torch.crush.map import (
        CRUSH_BUCKET_STRAW2, CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_CHOOSELEAF_INDEP,
        CRUSH_RULE_EMIT, CRUSH_RULE_TAKE, CrushMap, Rule)
    from ceph_tpu_torch.tools.gf_matmul_sweep import crush_choose_maps

    cases = crush_choose_maps(rng)
    lrc = CrushMap()  # tests/test_crush_vec.py _build_racks(): 2 racks x 3 hosts
    lrc.type_names.update({1: "host", 2: "rack", 3: "root"})
    lrng = np.random.default_rng(7)
    dev_id, racks = 0, []
    for rk in range(2):
        hosts = []
        for hs in range(3):
            n = int(lrng.integers(2, 5))
            devs = list(range(dev_id, dev_id + n))
            dev_id += n
            ws = [int(lrng.integers(1, 4)) * 0x10000 for _ in devs]
            hosts.append(lrc.make_bucket(CRUSH_BUCKET_STRAW2, 1, devs, ws, name=f"h{rk}{hs}"))
        racks.append(lrc.make_bucket(CRUSH_BUCKET_STRAW2, 2, hosts,
                                     [lrc.buckets[b].weight for b in hosts], name=f"rack{rk}"))
    lrc.make_bucket(CRUSH_BUCKET_STRAW2, 3, racks, [lrc.buckets[b].weight for b in racks],
                    name="default")
    rule = Rule(0, 3, 1, 4)
    rule.step(CRUSH_RULE_TAKE, lrc.root_id()).step(CRUSH_RULE_CHOOSE_INDEP, 2, 2)
    rule.step(CRUSH_RULE_CHOOSELEAF_INDEP, 2, 1).step(CRUSH_RULE_EMIT)
    cases.append(("lrc chain 2 racks x 2 hosts", lrc, lrc.add_rule(rule), 4, None))
    return cases


def straw2_rows_for_checks(dev, rng, big):
    """BucketRows for the kernel checks: 64 equal weights (flat_64's
    row), half of 16 items at weight 0, one item, size 0, 64 weights
    from 0x100 to 0x100000, all 8 weights 0; and the 1536-OSD map's
    rows (8, 16 and 12 items)."""
    import torch

    from ceph_tpu_torch.crush.mapper_torch_hier import tables_for
    from ceph_tpu_torch.ops import crush_torch

    I = 64
    items = np.full((6, I), 0x7FFFFFFF, dtype=np.int32)
    weights = np.zeros((6, I), dtype=np.int32)
    size = np.array([64, 16, 1, 0, 64, 8], dtype=np.int32)
    for b, n in enumerate(size):
        items[b, :n] = rng.permutation(4096)[:n]
    weights[0, :64] = 0x10000
    weights[1, :16] = np.where(np.arange(16) % 2, 0x10000, 0)
    weights[2, 0] = 0x20000
    weights[4, :64] = np.exp2(rng.uniform(8, 20, size=64)).astype(np.int32)
    child_row = np.where(items < 0, 0, -1).astype(np.int32)
    synthetic = crush_torch.BucketRows(
        *(torch.from_numpy(a).to(dev) for a in
          (items, weights, crush_torch.recip_table(weights), child_row,
           np.zeros_like(items), size)),
        crush_torch.ln_table(dev))
    return synthetic, tables_for(big, dev).rows


def profile_tester(cmap, ruleno, numrep, weights) -> str:
    """One ``CrushTester`` run at x = 0..CRUSH_X-1 under torch.profiler:
    the wall time, the card's busy time (the sum of its kernels' spans;
    one stream, so they do not overlap), the idle share, and the kernels
    that took most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.crush.tester import CrushTester

    tester = CrushTester(cmap)
    tester.min_x, tester.max_x = 0, CRUSH_X - 1
    tester.weight = weights
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tester.test_rule(ruleno, numrep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict[str, float] = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    if not busy:
        return f"{wall * 1e3:.3f} ms wall; device time not measured (no kernel events)"
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    return (f"{wall * 1e3:.3f} ms wall, the card busy {busy:.3f} ms (idle "
            f"{1 - busy / (wall * 1e3):.1%}); most device time: "
            + "; ".join(f"{name[:48]} {ms:.3f} ms" for name, ms in top))


@contextlib.contextmanager
def crush_route(route: str):
    """Route the batched mapper for a comparison: "step" puts every rule
    on the step engine (``crush_straw2``, no ``crush_choose``), "plain"
    also routes its draw to ``straw2_plain`` (no kernel at all)."""
    from ceph_tpu_torch.crush import mapper_torch
    from ceph_tpu_torch.ops import crush_torch

    engine, draw = mapper_torch._engine, crush_torch.straw2
    if route in ("step", "plain"):
        mapper_torch._engine = mapper_torch._step_engine
    if route == "plain":
        crush_torch.straw2 = crush_torch.straw2_plain
    try:
        yield
    finally:
        mapper_torch._engine, crush_torch.straw2 = engine, draw


def time_choose(name, T, rule, x, rw, bound, per_draw, route="plain") -> tuple:
    """``crush_choose`` on one case: checked bit-exact against
    ``crush_choose_plain`` (the step engine's loops; under ``route``
    "plain" their draw is ``straw2_plain``, under "fused" the
    ``crush_straw2`` kernel), its draws counted, timed one launch a
    sample and in batches of 20 beside the bound of its draws
    (``per_draw`` SASS instructions a draw) and its bytes (x in, each
    slot out, the take row and the reweight vector read once).  Returns
    (max_abs_err, ms of one launch, plain ms, bound ms, bound by)."""
    import torch

    from ceph_tpu_torch.crush import mapper_torch
    from ceph_tpu_torch.ops import crush_cuda

    counted = torch.zeros(1, dtype=torch.int64, device=x.device)
    got = crush_cuda.crush_choose(T, rule, x, rw, counted)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with crush_route(route):
        start.record()
        want = mapper_torch.crush_choose_plain(T, rule, x, rw)
        end.record()
    torch.cuda.synchronize()
    check_equal(f"crush_choose {name}, {x.shape[0]} lanes", got, want)
    plain_ms = start.elapsed_time(end)
    draws = int(counted.item())
    ms = time_cuda(lambda: crush_cuda.crush_choose(T, rule, x, rw), reps=30)
    batched = time_cuda(lambda: crush_cuda.crush_choose(T, rule, x, rw), reps=10, batch=20)
    nbytes = x.shape[0] * 4 * (1 + rule.width) + T.sizes[rule.take_row] * 24 + rw.numel() * 4
    b_ms, b_by = bound(nbytes, draws * per_draw)
    log(f"  crush_choose on {name} over {x.shape[0]} lanes, tile {crush_cuda.choose_tile(T, rule)} "
        f"(rows of {T.sizes[rule.take_row]} at the take, {rule.widest} at most, their gcd "
        f"{rule.row_gcd}): bit-exact against "
        f"crush_choose_plain ({route} route); {draws} draws counted "
        f"({draws / x.shape[0]:.4g} a lane); {ms} ms one launch a sample, {batched} ms in "
        f"batches of 20, plain ({route} route) {plain_ms} ms; bound "
        f"{b_ms} ms by {b_by} ({nbytes} bytes; {per_draw} SASS instructions a draw); "
        f"{b_ms / batched:.1%} of bound in batches")
    return max_abs_err(got, want), ms, plain_ms, b_ms, b_by


def run_crush(dev, rng) -> list[dict]:
    """Phase 7: the ``crush_straw2`` and ``crush_choose`` kernels against
    their plain versions, the main path through ``CrushTester`` at x =
    0..CRUSH_X-1, the fused and the step routes timed in turns, and each
    case's output against the scalar mapper, the plain route and the
    step route.  Returns the kernels' rows of the ``kernels`` line."""
    import torch

    from ceph_tpu_torch.crush import mapper, mapper_torch
    from ceph_tpu_torch.crush.encoding import crush_to_dict
    from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE, CrushMap
    from ceph_tpu_torch.crush.mapper_torch_hier import fused_rule, reweight_lanes, tables_for
    from ceph_tpu_torch.crush.tester import CrushTester
    from ceph_tpu_torch.ops import crush_cuda, crush_torch, gf_cuda
    from ceph_tpu_torch.tools import crushtool
    from ceph_tpu_torch.tools.gf_matmul_sweep import (
        INSTRUCTIONS_PER_DRAW, ISSUE_LANES_PER_CLOCK_PER_SM)

    cases = crush_cases(rng)
    synthetic, big_rows = straw2_rows_for_checks(dev, rng, cases[3][1])

    def lanes(n, hi):
        return torch.from_numpy(rng.integers(0, hi, size=n, dtype=np.int64)
                                .astype(np.uint32).view(np.int32)).to(dev)

    # 1. crush_straw2 against its plain version, bit-exact
    flat_x = torch.arange(CRUSH_X, dtype=torch.int32, device=dev)
    flat_rows = torch.zeros_like(flat_x)
    flat_r = lanes(CRUSH_X, 1 << 31)
    checks = [("flat_64 row, 1M lanes", synthetic, flat_x, flat_rows, flat_r)]
    for n in (1, 31, CRUSH_X + 7):
        checks.append((f"synthetic rows, X={n}", synthetic, lanes(n, 1 << 32),
                       lanes(n, synthetic.items.shape[0]), lanes(n, 1 << 31)))
        checks.append((f"1536-OSD map rows, X={n}", big_rows, lanes(n, 1 << 32),
                       lanes(n, big_rows.items.shape[0]), lanes(n, 1 << 31)))
    checks.append(("synthetic rows, r in [0, 64)", synthetic, lanes(4099, 1 << 32),
                   lanes(4099, 6), lanes(4099, 64)))
    err = 0
    for what, T, x, rows, r in checks:
        got = crush_cuda.crush_straw2(T, x, rows, r)
        want = crush_torch.straw2_plain(T, x, rows, r)
        torch.cuda.synchronize()
        for name, g, w in zip(("item", "child row", "child type", "empty"), got, want):
            check_equal(f"crush_straw2 {what} {name}", g, w)
        err = max(err, max_abs_err(got[0], want[0]))
    log(f"  crush_straw2 bit-exact against straw2_plain on {len(checks)} shapes")
    ms = time_cuda(lambda: crush_cuda.crush_straw2(synthetic, flat_x, flat_rows, flat_r), reps=30)
    batched = time_cuda(lambda: crush_cuda.crush_straw2(synthetic, flat_x, flat_rows, flat_r),
                        reps=10, batch=20)
    plain_ms = time_cuda(lambda: crush_torch.straw2_plain(synthetic, flat_x, flat_rows, flat_r),
                         reps=3, warmup=1)
    draws = CRUSH_X * 64
    bound = bound_fn(dev, ISSUE_LANES_PER_CLOCK_PER_SM)
    b_ms, b_by = bound(CRUSH_X * (3 * 4 + 3 * 4 + 1), draws * INSTRUCTIONS_PER_DRAW)
    log(f"  crush_straw2 on flat_64's row over {CRUSH_X} lanes ({draws} draws): {ms} ms one "
        f"launch a sample, {batched} ms in batches of 20, plain {plain_ms} ms; bound "
        f"{b_ms} ms by {b_by} ({INSTRUCTIONS_PER_DRAW} SASS instructions a draw); "
        f"{draws / batched / 1e6:.4g} G draws/s in batches, {b_ms / batched:.1%} of bound")
    straw2_row = {
        "name": "crush_straw2", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_straw2.cu",
        "replaces": "ceph_tpu/crush/mapper_jax_hier.py:189 (_straw2_rows; "
                    "straw2_choose_approx, ceph_tpu/crush/mapper_jax.py:280)",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
    }

    # 2. crush_choose against its plain version on each single-step case
    # at 1M lanes, bit-exact, timed beside the bound of the draws it
    # counted; flat_64 firstn's figures go into the kernels line
    choose_figures = {}
    for name, cmap, ruleno, numrep, weights in cases:
        rule = fused_rule(cmap, ruleno, numrep)
        if rule is None:
            continue
        T, rw = tables_for(cmap, dev), reweight_lanes(cmap, weights, dev)
        choose_figures[name] = time_choose(name, T, rule, flat_x, rw, bound,
                                           INSTRUCTIONS_PER_DRAW)
    choose_err, choose_ms, choose_plain_ms, c_ms, c_by = choose_figures["flat_64 firstn"]
    # two edges of the launch: 32 slots on the racks map over 65,536
    # lanes (a tile of 4: 1024 threads' slots take 64 KB of shared memory,
    # above the 48 KB a block gets unasked), and a take row of 12,000
    # items, too wide to stage, over 8192 lanes (read from global memory;
    # the draw on crush_straw2, since the plain draw over it takes minutes)
    _name, big, big_rule, _n, big_w = cases[3]
    wide = CrushMap.flat(12_000)
    for name, cmap, ruleno, numrep, weights, n, route in (
            ("racks_8x16x12 chooseleaf, 32 slots", big, big_rule, 32, big_w, 65536, "plain"),
            ("flat_12000 firstn", wide, wide.add_simple_rule(wide.root_id(), 0), 3, None, 8192,
             "fused")):
        rule = fused_rule(cmap, ruleno, numrep)
        time_choose(name, tables_for(cmap, dev), rule, flat_x[:n],
                    reweight_lanes(cmap, weights, dev), bound, INSTRUCTIONS_PER_DRAW, route)

    # 3. the main path: CrushTester (crushtool --test's engine) on each
    # case; a rule that crush_choose takes launches it, the chain crush_straw2
    xs = np.arange(CRUSH_X, dtype=np.uint32)
    reports = {}
    single = {name: fused_rule(cmap, ruleno, numrep) is not None
              for name, cmap, ruleno, numrep, _w in cases}
    gf_cuda.reset_launches()
    for name, cmap, ruleno, numrep, weights in cases:
        tester = CrushTester(cmap)
        tester.min_x, tester.max_x = 0, CRUSH_X - 1
        tester.weight = weights
        kernel = "crush_choose" if single[name] else "crush_straw2"
        for run in ("first", "second"):  # the first builds the map's tables
            before = gf_cuda.launch_counts()
            rep = tester.test_rule(ruleno, numrep)
            torch.cuda.synchronize()
            launched = {k: c - before[k] for k, c in gf_cuda.launch_counts().items()
                        if k.startswith("crush")}
            if rep.backend != "vectorized" or launched[kernel] == 0:
                raise AssertionError(f"{name}: backend {rep.backend}, launches {launched}")
            if run == "second" and (rep.device_counts, rep.bad_mappings) != (
                    reports[name].device_counts, reports[name].bad_mappings):
                raise AssertionError(f"{name}: a second run counted otherwise")
            reports[name] = rep
            log(f"  {name}, {run} run: CrushTester {rep.num_inputs} x numrep {numrep} in "
                f"{rep.elapsed_seconds} s = {rep.num_inputs / rep.elapsed_seconds} mappings/s "
                f"({rep.backend}; launches {launched}; bad {rep.bad_mappings})")
    for name, cmap, ruleno, numrep, weights in (cases[0], cases[3], cases[4]):
        log(f"  {name}, a third run under torch.profiler: {profile_tester(cmap, ruleno, numrep, weights)}")
    path = gf_cuda.BUILD_DIR / "crush_16x4.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(crush_to_dict(cases[2][1])))
    argv = ["-i", str(path), "--test", "--rule", "0", "--num-rep", "3",
            "--max-x", str(CRUSH_X - 1)]
    log(f"  crushtool {' '.join(argv)}:")
    if crushtool.main(argv) != 0:
        raise AssertionError("crushtool --test failed")
    torch.cuda.synchronize()
    main_path = gf_cuda.launch_counts()
    log(f"  CRUSH launches on the main path: crush_choose {main_path['crush_choose']}, "
        f"crush_straw2 {main_path['crush_straw2']}")

    # 4. CrushTester through the fused route and the step route, in turns
    for name, cmap, ruleno, numrep, weights in cases:
        if not single[name]:
            continue
        tester = CrushTester(cmap)
        tester.min_x, tester.max_x = 0, CRUSH_X - 1
        tester.weight = weights
        rates = {"fused": [], "step": []}
        for route in ("fused", "step", "step", "fused"):
            with crush_route(route):
                rep = tester.test_rule(ruleno, numrep)
                torch.cuda.synchronize()
            rates[route].append(rep.num_inputs / rep.elapsed_seconds)
        log(f"  {name}: CrushTester mappings/s in turns (fused, step, step, fused): fused "
            f"{rates['fused']}, step {rates['step']}; fused / step "
            f"{statistics.median(rates['fused']) / statistics.median(rates['step']):.3g}x")

    # 5. each case's whole output: fused route == plain route == step
    # route, sampled lanes == the scalar mapper, the tester's counts ==
    # its bincount
    for name, cmap, ruleno, numrep, weights in cases:
        out = mapper_torch.vec_do_rule(cmap, ruleno, xs, numrep, weight=weights)
        before = gf_cuda.launch_counts()
        with crush_route("plain"):
            t0 = time.perf_counter()
            plain = mapper_torch.vec_do_rule(cmap, ruleno, xs, numrep, weight=weights)
            t_plain = time.perf_counter() - t0
        if gf_cuda.launch_counts() != before:
            raise AssertionError(f"{name}: the plain route launched a kernel")
        with crush_route("step"):
            step = mapper_torch.vec_do_rule(cmap, ruleno, xs, numrep, weight=weights)
        if gf_cuda.launch_counts()["crush_choose"] != before["crush_choose"]:
            raise AssertionError(f"{name}: the step route launched crush_choose")
        for what, other in (("plain", plain), ("step", step)):
            if out.shape != other.shape or not np.array_equal(out, other):
                raise AssertionError(f"{name}: the main route differs from the {what} route")
        sample = np.linspace(0, CRUSH_X - 1, CRUSH_SAMPLE).astype(np.int64)
        ws = mapper.Workspace(cmap)
        for x in sample:
            want = mapper.crush_do_rule(cmap, ruleno, int(x), numrep, weight=weights,
                                        workspace=ws)
            row = np.full(out.shape[1], CRUSH_ITEM_NONE, dtype=np.int32)
            row[:len(want)] = want
            if not np.array_equal(out[x], row):
                raise AssertionError(f"{name} x={x}: {list(out[x])} != scalar {want}")
        t0 = time.perf_counter()
        for x in range(1000):
            mapper.crush_do_rule(cmap, ruleno, x, numrep, weight=weights, workspace=ws)
        scalar_us = (time.perf_counter() - t0) / 1000 * 1e6
        placed = out != CRUSH_ITEM_NONE
        vals, counts = np.unique(out[placed], return_counts=True)
        rep = reports[name]
        if (rep.device_counts != {int(v): int(c) for v, c in zip(vals, counts)}
                or rep.bad_mappings != int((placed.sum(axis=1) < out.shape[1]).sum())):
            raise AssertionError(f"{name}: CrushTester counts differ from the output's")
        route = "crush_choose" if single[name] else "the step engine's crush_straw2"
        log(f"  {name}: [{CRUSH_X}, {out.shape[1]}] main route ({route}) == plain route "
            f"({t_plain:.3f} s) == step route, {CRUSH_SAMPLE} lanes == scalar mapper, counts "
            f"== bincount; scalar mapper {scalar_us} us a mapping")
    straw2_row["launches"] = main_path["crush_straw2"]
    choose_row = {
        "name": "crush_choose", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_choose.cu",
        "replaces": "ceph_tpu/crush/mapper_jax.py:336 (choose_firstn; choose_indep :400; "
                    "choose_firstn_hier, choose_indep_hier, "
                    "ceph_tpu/crush/mapper_jax_hier.py:344, :467)",
        "launches": main_path["crush_choose"], "max_abs_err": choose_err,
        "ms": choose_ms, "plain_ms": choose_plain_ms, "bound_ms": c_ms, "bound_by": c_by,
        "library_ms": None,
    }
    return [straw2_row, choose_row]


# -- phase 8: the cluster map and device-planned churn ---------------------------


def device_busy(prof, kernel: str) -> tuple[float, float]:
    """(the card's busy ms, the share of it in kernels named ``kernel``)
    from a torch.profiler run: the sum of the card's kernel spans (one
    stream, so they do not overlap)."""
    busy = mine = 0.0
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            mine += ms if kernel in e.name else 0.0
    return busy, (mine / busy if busy else 0.0)


def run_churn(dev, rng) -> dict:
    """Phase 8 (see the module docstring).  Returns the kernels' launches
    on the phase's main path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.crush import mapper_torch
    from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
    from ceph_tpu_torch.crush.mapper_torch_hier import (
        MapTables, fused_rule, reweight_lanes, tables_for)
    from ceph_tpu_torch.osd.churn import ChurnPlanner, apply_churn, synthetic_map
    from ceph_tpu_torch.osd.osdmap import OSDMap, PGid
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.tools.gf_matmul_sweep import (
        INSTRUCTIONS_PER_DRAW, ISSUE_LANES_PER_CLOCK_PER_SM, pool_lanes)

    t0 = time.perf_counter()
    m = synthetic_map(CHURN_OSDS, CHURN_OSDS_PER_HOST, replicated=(3, CHURN_PG_NUM),
                      ec=(CHURN_EC, CHURN_PG_NUM))
    log(f"  synthetic_map: {CHURN_OSDS} OSDs, {len(m.crush.buckets)} buckets, pools "
        + ", ".join(f"{p.id} {p.name} size {p.size} pg_num {p.pg_num}" for p in m.pools.values())
        + f" in {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    OSDMap.from_dict(m.to_dict())
    log(f"  the wire round trip apply_churn makes (to_dict, from_dict): "
        f"{(time.perf_counter() - t0) * 1e3} ms")
    first = int(rng.integers(CHURN_OSDS // CHURN_OSDS_PER_HOST)) * CHURN_OSDS_PER_HOST
    host = list(range(first, first + CHURN_OSDS_PER_HOST))
    events = [(f"1. host of osd.{first}-{host[-1]} down", host, {"kill": host}),
              ("2. the same host down and out", host, {"kill": host, "out": host}),
              (f"3. a host of {CHURN_OSDS_PER_HOST} added",
               list(range(CHURN_OSDS, CHURN_OSDS + CHURN_OSDS_PER_HOST)),
               {"add": CHURN_OSDS_PER_HOST})]
    posts = [apply_churn(m, **kw) for _name, _osds, kw in events]

    t0 = time.perf_counter()
    MapTables(m.crush, dev)
    torch.cuda.synchronize()
    log(f"  bucket tables of the map on the card: {(time.perf_counter() - t0) * 1e3} ms")

    # the main path, from one reset
    gf_cuda.reset_launches()
    planner = ChurnPlanner(m)
    pre = {}
    for pool in m.pools.values():
        times = []
        for _run in ("first", "second"):  # the first also builds the map's tables
            t0 = time.perf_counter()
            pre[pool.id] = planner.map_pool(m, pool)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not pre[pool.id].device:
            raise AssertionError(f"pool {pool.name}: mapped off the device path")
        log(f"  map_pool {pool.name} ({pool.pg_num} PGs x {pool.size}): first "
            f"{times[0] * 1e3} ms, second {times[1] * 1e3} ms = "
            f"{pool.pg_num / times[1]} PGs mapped/s")
    for pool in m.pools.values():  # host steps of a map_pool, each alone
        ruleno = m.crush.find_rule(pool.crush_ruleset, pool.type, pool.size)
        t0 = time.perf_counter()
        mapper_torch.supports(m.crush, ruleno)
        t1 = time.perf_counter()
        tables_for(m.crush, dev)
        t2 = time.perf_counter()
        log(f"  map_pool {pool.name} host steps: the supports walk {(t1 - t0) * 1e3} ms, "
            f"the tables' layout check {(t2 - t1) * 1e3} ms")
    plans = []
    for (name, osds, kw), post in zip(events, posts):
        t0 = time.perf_counter()
        plan = planner.plan(post)
        t_plan = time.perf_counter() - t0
        post_maps = planner.map_all(post)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planner.diff(pre, post_maps, post)
        t_diff = time.perf_counter() - t0
        s = plan.summary()
        if not plan.device or not all(mp.device for mp in post_maps.values()):
            raise AssertionError(f"event {name}: planned off the device path")
        if not s["pgs_remapped"]:
            raise AssertionError(f"event {name}: no PG remapped")
        plans.append((plan, post_maps))
        log(f"  event {name}: plan {t_plan} s (the row diff and the host loop over "
            f"its rows {t_diff * 1e3} ms), {s['pgs_remapped']} PGs remapped, "
            f"{s['moved_shards']} shards moved, max scan fan-in {s['max_fan_in']}")
    torch.cuda.synchronize()
    launches = dict(gf_cuda.launches)
    log(f"  launches on the main path: {launches}")
    # each pool's rule is single-step: its CUDA lanes take crush_choose
    for pool in m.pools.values():
        ruleno = m.crush.find_rule(pool.crush_ruleset, pool.type, pool.size)
        if fused_rule(m.crush, ruleno, pool.size) is None:
            raise AssertionError(f"pool {pool.name}: crush_choose does not take its rule")
    if launches["crush_choose"] == 0:
        raise AssertionError("crush_choose was not launched in phase 8")

    # each pool's crush_choose launch alone, as map_pool makes it
    # (65,536 lanes; the 640-item root staged), bit-exact against its
    # plain version with the draw on crush_straw2 (phase 7 holds that
    # against straw2_plain; the plain route's map_all below takes about
    # 20 s) and timed beside its bound
    bound = bound_fn(dev, ISSUE_LANES_PER_CLOCK_PER_SM)
    for pool in m.pools.values():
        ruleno, x, weights = pool_lanes(m, pool, dev)
        time_choose(f"pool {pool.name} ({pool.pg_num} PGs x {pool.size})",
                    tables_for(m.crush, dev), fused_rule(m.crush, ruleno, pool.size), x,
                    reweight_lanes(m.crush, weights, dev), bound, INSTRUCTIONS_PER_DRAW,
                    route="fused")

    # map_pool through the fused and the step routes, in turns
    for pool in m.pools.values():
        times = {"fused": [], "step": []}
        for route in ("fused", "step", "step", "fused"):
            with crush_route(route):
                t0 = time.perf_counter()
                planner.map_pool(m, pool)
                torch.cuda.synchronize()
                times[route].append((time.perf_counter() - t0) * 1e3)
        log(f"  map_pool {pool.name} in turns (fused, step, step, fused), ms: fused "
            f"{times['fused']}, step (crush_straw2) {times['step']}")

    # CRUSH moves only what the churned OSDs held, or now hold
    for (name, osds, _kw), (plan, post_maps) in zip(events[:2], plans[:2]):
        churned = torch.tensor(osds, dtype=torch.int32, device=dev)
        for pid, entries in plan.remapped.items():
            touched = (torch.isin(pre[pid].acting, churned).any(dim=1)
                       | torch.isin(post_maps[pid].acting, churned).any(dim=1))
            seeds = torch.tensor([e["seed"] for e in entries], device=dev)
            if not bool(touched[seeds].all()):
                raise AssertionError(f"event {name}: pool {pid} remapped a PG that "
                                     "neither held nor holds a churned OSD")
            log(f"  event {name}, pool {pid}: {len(entries)} remapped of "
                f"{int(touched.sum())} PGs that held or hold the host's OSDs")

    # the whole pre-churn and out-event mappings: main route == plain route
    plain_maps = {}
    for name, mp, kernel_maps in (("pre-churn", m, pre), ("event 2", posts[1], plans[1][1])):
        with crush_route("plain"):
            t0 = time.perf_counter()
            plain = plain_maps[name] = planner.map_all(mp)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
        for pid, got in kernel_maps.items():
            check_equal(f"{name} pool {pid} acting", got.acting, plain[pid].acting)
            check_equal(f"{name} pool {pid} primary", got.primary, plain[pid].primary)
        log(f"  {name}: every PG of both pools, main route == plain route "
            f"(plain route {t_plain} s)")
    plain_plan = planner.diff(plain_maps["pre-churn"], plain_maps["event 2"], posts[1])
    if plain_plan.remapped != plans[1][0].remapped or plain_plan.summary() != plans[1][0].summary():
        raise AssertionError("event 2: the plan differs from the plain route's")
    # every event's mappings and plan: main route == step route
    with crush_route("step"):
        step_pre = planner.map_all(m)
        for (name, _osds, _kw), post, (plan, post_maps) in zip(events, posts, plans):
            step_post = planner.map_all(post)
            for pid, got in post_maps.items():
                check_equal(f"event {name} pool {pid} acting", got.acting, step_post[pid].acting)
                check_equal(f"event {name} pool {pid} primary", got.primary,
                            step_post[pid].primary)
            step_plan = planner.diff(step_pre, step_post, post)
            if step_plan.remapped != plan.remapped or step_plan.summary() != plan.summary():
                raise AssertionError(f"event {name}: the plan differs from the step route's")
    log("  event 2's plan == the plain route's; every event's mappings and plan == the "
        "step route's (crush_straw2)")

    # sampled PGs of each map == the scalar walk
    scalar_s, walked = 0.0, 0
    for name, mp, maps in [("pre-churn", m, pre)] + [
            (ev[0], post, pm) for ev, post, (_plan, pm) in zip(events, posts, plans)]:
        for pid, mapping in maps.items():
            seeds = rng.choice(mp.pools[pid].pg_num, size=CHURN_SAMPLES, replace=False)
            idx = torch.as_tensor(seeds, device=dev)
            rows = mapping.acting.index_select(0, idx).tolist()
            prims = mapping.primary.index_select(0, idx).tolist()
            width = mapping.acting.shape[1]
            for seed, row, prim in zip(seeds, rows, prims):
                t0 = time.perf_counter()
                _u, _upp, acting, primary = mp.pg_to_up_acting_osds(PGid(pid, int(seed)))
                scalar_s += time.perf_counter() - t0
                walked += 1
                want = (list(acting[:width]) + [CRUSH_ITEM_NONE] * width)[:width]
                if row != want or prim != primary:
                    raise AssertionError(f"{name} pg {pid}.{int(seed):x}: card {row} "
                                         f"primary {prim} != scalar {want} primary {primary}")
    log(f"  {walked} sampled PGs == the scalar pg_to_up_acting_osds; the scalar walk "
        f"{scalar_s / walked * 1e3} ms a PG")
    if planner.verify_oracle(m, samples=8, rng=rng) != 16:
        raise AssertionError("verify_oracle did not check both pools")

    # one map_all under torch.profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        planner.map_all(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, share = device_busy(prof, "crush_choose")
    if busy:
        log(f"  map_all under torch.profiler: {wall * 1e3} ms wall, the card busy "
            f"{busy} ms (idle {1 - busy / (wall * 1e3):.1%}), crush_choose {share:.1%} "
            "of the busy time")
    else:
        log(f"  map_all under torch.profiler: {wall * 1e3} ms wall; device time not "
            "measured (no kernel events)")
    return launches


# -- phase 9: the shared accelerator service --------------------------------------


def sim_osd_class():
    """The simulated OSD of phases 9 and 10 (a class built on first use:
    the port is imported only once the script has found it)."""
    import asyncio

    from ceph_tpu_torch.common import PerfCountersCollection
    from ceph_tpu_torch.msg import AsyncMessenger, Dispatcher, messages
    from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
    from ceph_tpu_torch.osd.ec_failover import EngineSupervisor
    from ceph_tpu_torch.osd.ec_perf import create_accel_client_perf, create_ec_perf
    from ceph_tpu_torch.osd.osdmap import advance_map

    class SimOsd(Dispatcher):
        """A simulated OSD: messenger, a remote lane built by
        ``make_remote(self)`` (an ``AccelClient``, or an ``AccelRouter``
        fed ``apply_map`` from every push of a mon it subscribes to, as
        the OSD daemon does), a dispatcher with that lane, its own
        breaker, and codecs on the CPU."""

        def __init__(self, i: int, cfg, make_remote):
            self.name = f"osd.{i}"
            self.messenger = AsyncMessenger(self.name, self)
            self.messenger.apply_config(cfg)
            self.perf = PerfCountersCollection()
            self.pacc = create_accel_client_perf(self.perf)
            self.remote = make_remote(self)
            self.sup = EngineSupervisor(enabled=True, perf=create_ec_perf(self.perf),
                                        probe_interval=OSD_PROBE_INTERVAL_S)
            self.dispatch = ECDispatcher(
                window=cfg.osd_ec_dispatch_window,
                max_stripes=cfg.osd_ec_dispatch_max_stripes,
                bucket=cfg.osd_ec_dispatch_bucket, max_workers=OSD_WORKERS,
                supervisor=self.sup, launch_deadline=cfg.osd_ec_launch_deadline,
                remote=self.remote)
            self.osdmap = None
            self.mon = None
            self.dropped = {}  # accel id -> when a map push dropped it
            self.replies = {}
            self.tid = 0

        async def subscribe(self, mon_addr):
            self.mon = await self.messenger.connect(mon_addr, "mon")
            self.mon.send(messages.MMonGetMap(have=0))

        async def command(self, cmd):
            self.tid += 1
            fut = self.replies[self.tid] = asyncio.get_running_loop().create_future()
            self.mon.send(messages.MMonCommand(tid=self.tid, cmd=cmd))
            reply = await asyncio.wait_for(fut, 30)
            if reply.code != 0:
                raise AssertionError(f"mon command {cmd}: {reply.code} {reply.status}")
            return reply.out

        async def ms_dispatch(self, conn, msg):
            if isinstance(msg, messages.MOSDMapMsg):
                m = advance_map(self.osdmap, msg.epoch, msg.osdmap, msg.incrementals)
                if m is None:
                    conn.send(messages.MMonGetMap(have=None))
                    return
                self.osdmap = m
                had = set(self.remote._map_clients)
                self.remote.apply_map(m.accelmap)
                for aid in had - set(self.remote._map_clients):
                    self.dropped[aid] = time.perf_counter()
            elif isinstance(msg, messages.MMonCommandReply):
                fut = self.replies.pop(msg.tid, None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
            else:
                self.remote.handle(msg, conn)

        def ms_handle_reset(self, conn):
            self.remote.on_reset(conn)

        async def stop(self):
            await self.dispatch.stop()
            await self.messenger.shutdown()

    return SimOsd

# 4 simulated OSDs feed one accelerator daemon over loopback TCP
ACCEL_OSDS = 4
# pool C: the w=16 case, 8 objects from 2 OSDs
POOL_W16 = ("jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "16"},
            4096)
W16_OPS = 8
W16_OSDS = 2
# the failover step: one pool-A batch of 8 ops from 2 OSDs, in flight
# when the daemon stops; the daemon's launches are held this long so
# that the stop lands mid-batch
FAILOVER_OPS = 8
FAILOVER_OSDS = 2
FAILOVER_HOLD_S = 1.0
# the whole phase runs under this limit, so a hang fails the script
ACCEL_PHASE_LIMIT_S = 600.0


async def time_wire(objs, sinfo) -> None:
    """The messenger alone, with the bytes of the service's pool-A encode
    step and no erasure code (``tools/wire_profile.py``, which also
    profiles such a round): one round over connections already up.
    Object bytes / wall of the gather, on the host clock."""
    from ceph_tpu_torch.tools.wire_profile import wire_round

    per_rpc = OSD_MAX_STRIPES // (len(objs[0]) // sinfo.stripe_width)
    s, what = await wire_round(objs, per_rpc, ACCEL_OSDS)
    nbytes = sum(len(o) for o in objs)
    log(f"  the messenger alone: pool A encode's frames ({what}): "
        f"{nbytes / s / 1e9:.3f} GB/s of object bytes ({s * 1e3:.1f} ms, host clock)")


def run_accel_service(dev, rng, in_process: dict | None = None,
                      figures: dict | None = None) -> dict:
    """Phase 9 (see the module docstring).  ``in_process`` holds phase
    6's GB/s of the same steps, printed beside the service's;
    ``figures``, when given, gets the service's own (phase 10 prints
    them beside the fleet's).  Returns the kernels' launch counts over
    the phase's main path (every launch is the daemon's: the OSDs'
    codecs live on the CPU)."""
    import asyncio

    import torch

    from ceph_tpu_torch.accel import AccelClient, AccelDaemon
    from ceph_tpu_torch.common import Config
    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_failover import HEALTHY, STATE_NAMES

    cfg = Config(env="")
    SimOsd = sim_osd_class()

    def cpu_pool(spec):
        # the wire profile names its plugin, as a pool's EC profile does:
        # the daemon rebuilds the codec from the profile alone
        plugin, profile, chunk = spec
        codec = registry.instance().factory(plugin, dict(profile, plugin=plugin),
                                            device="cpu")
        return codec, ec_util.StripeInfo(codec.get_data_chunk_count() * chunk, chunk)

    codec_a, sinfo_a = cpu_pool(POOL_A)
    codec_b, sinfo_b = cpu_pool(POOL_B)
    codec_c, sinfo_c = cpu_pool(POOL_W16)
    objs = [rng.integers(0, 256, size=OSD_OBJECT_SIZE, dtype=np.uint8)
            for _ in range(OSD_OPS)]
    objs_b = [np.frombuffer(sinfo_b.pad_to_stripe(o.tobytes()), dtype=np.uint8)
              for o in objs]
    total_bytes = OSD_OPS * OSD_OBJECT_SIZE
    # the port's host engine on the CPU codecs: the bytes every op must get
    want_a = [ec_util.encode(sinfo_a, codec_a, o) for o in objs]
    want_b = [ec_util.encode(sinfo_b, codec_b, o) for o in objs_b]
    want_c = [ec_util.encode(sinfo_c, codec_c, o) for o in objs[:W16_OPS]]
    launches = {}
    split = {"queue_wait": [], "device_wall": []}

    async def main():
        acc = AccelDaemon("accel.0", device=None)
        if acc.device != dev:
            raise AssertionError(f"accelerator daemon on {acc.device}, expected {dev}")
        await acc.start("127.0.0.1", 0)
        osds = [SimOsd(i, cfg, lambda o: AccelClient(
            o.messenger, addr=acc.addr, mode="require",
            deadline=cfg.osd_ec_accel_deadline,
            retry_interval=cfg.osd_ec_accel_retry_interval,
            stale_interval=cfg.osd_ec_accel_stale_interval, perf=o.pacc))
            for i in range(ACCEL_OSDS)]
        log(f"  accel.0 on {acc.device} at {acc.addr}; {ACCEL_OSDS} OSDs (mode require, "
            f"codecs on the CPU); window {cfg.osd_ec_dispatch_window} s, "
            f"{cfg.osd_ec_dispatch_max_stripes} stripes")

        def snapshot():
            torch.cuda.synchronize()
            return dict(gf_cuda.launches)

        def counts(name, since):
            got = {n: c - since[n] for n, c in snapshot().items()}
            log(f"  daemon launches in {name}: {got}")
            return got

        def owner(i, n_osds=ACCEL_OSDS):
            return osds[i % n_osds]

        async def timed(coros):
            t0 = time.perf_counter()
            out = await asyncio.gather(*coros)
            return out, time.perf_counter() - t0

        def gbps(nbytes, seconds):
            return nbytes / seconds / 1e9

        seen = {}

        def new_records(o):
            """The OSD's flight records since the last call (the ring
            holds its last 64 launches, more than one step makes)."""
            recs = [r for r in o.dispatch.flight.dump()["launches"]
                    if r["seq"] > seen.get(o.name, 0)]
            if recs:
                seen[o.name] = recs[-1]["seq"]
            return recs

        def note_records(what):
            """Every remote flight record an OSD kept for this step names
            the daemon's served engine and device wall; gather the
            per-request split."""
            for o in osds:
                for r in new_records(o):
                    if r.get("lane") != "remote" or r.get("served") != "remote" \
                            or r.get("remote_served") != "device" \
                            or r.get("device_wall_s") is None:
                        raise AssertionError(f"{what}: {o.name} flight record {r}")
                    split["device_wall"].append(r["device_wall_s"])
                    split["queue_wait"].append(r.get("remote_queue_wait_s") or 0.0)

        def step(name, nbytes, seconds):
            if figures is not None:
                figures[name] = f"{gbps(nbytes, seconds):.3f} GB/s"
            log(f"  {name}: {gbps(nbytes, seconds):.3f} GB/s ({seconds * 1e3:.1f} ms, "
                f"host clock, through the service); "
                f"in process (phase 6): {(in_process or {}).get(name, 'not run')}")

        gf_cuda.reset_launches()
        start = snapshot()

        # pool A: 64 writes, 16 from each OSD, then two degraded reads
        got, s = await timed(owner(i).dispatch.encode(sinfo_a, codec_a, o)
                             for i, o in enumerate(objs))
        for i, g in enumerate(got):
            _check_shards(f"service pool A op {i}", g, want_a[i])
        step("pool A encode", total_bytes, s)
        note_records("pool A encode")
        for lost in ((0,), (1, 5, 9)):
            outs, s = await timed(
                owner(i).dispatch.decode_concat(
                    sinfo_a, codec_a, {k: v for k, v in sh.items() if k not in lost})
                for i, sh in enumerate(got))
            for i, (o, out) in enumerate(zip(objs, outs)):
                if bytes(out) != o.tobytes():
                    raise AssertionError(f"service pool A op {i}: decode of {lost} differs")
            step(f"pool A decode {list(lost)}", total_bytes, s)
            note_records(f"pool A decode {lost}")
        del got, outs
        launches["pool A"] = counts("pool A", start)
        if launches["pool A"]["gf_matmul"] == 0:
            raise AssertionError("gf_matmul was not launched by the daemon in pool A")

        # pool B: 64 padded objects, 16 from each OSD, a four-erasure read
        since = snapshot()
        got, s = await timed(owner(i).dispatch.encode(sinfo_b, codec_b, o)
                             for i, o in enumerate(objs_b))
        for i, g in enumerate(got):
            _check_shards(f"service pool B op {i}", g, want_b[i])
        step("pool B encode", total_bytes, s)
        note_records("pool B encode")
        lost = (0, 4, 11, 13)
        outs, s = await timed(
            owner(i).dispatch.decode_concat(
                sinfo_b, codec_b, {k: v for k, v in sh.items() if k not in lost})
            for i, sh in enumerate(got))
        for i, (o, out) in enumerate(zip(objs_b, outs)):
            if bytes(out) != o.tobytes():
                raise AssertionError(f"service pool B op {i}: decode of {lost} differs")
        step(f"pool B decode {list(lost)}", total_bytes, s)
        note_records("pool B decode")
        del got, outs
        launches["pool B"] = counts("pool B", since)
        if launches["pool B"]["bitmatrix_xor"] == 0:
            raise AssertionError("bitmatrix_xor was not launched by the daemon in pool B")

        # w=16: 8 objects from 2 OSDs, encode and a one-erasure read
        since = snapshot()
        got, _ = await timed(owner(i, W16_OSDS).dispatch.encode(sinfo_c, codec_c, o)
                             for i, o in enumerate(objs[:W16_OPS]))
        for i, g in enumerate(got):
            _check_shards(f"service w=16 op {i}", g, want_c[i])
        outs, _ = await timed(
            owner(i, W16_OSDS).dispatch.decode_concat(
                sinfo_c, codec_c, {k: v for k, v in sh.items() if k != 2})
            for i, sh in enumerate(got))
        for i, (o, out) in enumerate(zip(objs, outs)):
            if bytes(out) != o.tobytes():
                raise AssertionError(f"service w=16 op {i}: decode differs")
        note_records("w=16")
        launches["w=16"] = counts("the w=16 case", since)
        if launches["w=16"]["gf_matmul"] == 0:
            raise AssertionError("gf_matmul was not launched by the daemon in the w=16 case")
        launches["phase"] = counts("the main path", start)
        log(f"  w=16 (jerasure reed_sol_van k=8 m=3): {W16_OPS} objects from {W16_OSDS} "
            "OSDs, encode and decode bytes == host engine")

        # checks over the main path
        sent = {o.name: 0 for o in osds}
        for i in range(OSD_OPS):
            sent[owner(i).name] += 5  # pool A: 1 encode, 2 decodes; pool B: 1 + 1
        for i in range(W16_OPS):
            sent[owner(i, W16_OSDS).name] += 2
        for o in osds:
            t = o.dispatch.dump()["totals"]
            lanes = t["lanes"]
            if lanes["remote"]["ops"] != sent[o.name] or lanes["device"]["ops"] != 0:
                raise AssertionError(f"{o.name}: lanes {lanes}, expected "
                                     f"{sent[o.name]} remote ops")
            if t["failovers"] or t["fallback_direct"] or t["native_direct"]:
                raise AssertionError(f"{o.name}: ops served off the service: {t}")
        t = acc.dispatch.dump()["totals"]
        if t["failovers"] or t["fallback_direct"] or t["native_direct"] or \
                t["deadline_timeouts"]:
            raise AssertionError(f"accel.0: ops served off the card: {t}")
        shared = t["cross_client_batches"]
        if shared == 0:
            raise AssertionError("no daemon launch was shared by two or more OSDs")
        if acc.supervisor.state != HEALTHY:
            raise AssertionError(f"accel.0 supervisor {STATE_NAMES[acc.supervisor.state]}")
        rtt = {o.name: o.pacc.dump()["remote_rtt"] for o in osds}
        log(f"  accel.0 dispatcher: {t['batches']} launches for {t['ops']} member ops "
            f"({t['ops'] / t['batches']:.2f} ops a launch), {shared} launches shared by "
            f"two or more OSDs, flush {t['flush_reasons']}, pad stripes {t['pad_stripes']}; "
            f"clients {acc.client_table()}")
        med = {k: statistics.median(v) * 1e3 for k, v in split.items() if v}
        avg_rtt = sum(r["sum"] for r in rtt.values()) / max(
            1, sum(r["avgcount"] for r in rtt.values())) * 1e3
        service = acc.perf.get("accel").dump()["service_time"]
        log(f"  per request: OSD-side round trip {avg_rtt:.3f} ms on average over "
            f"{sum(r['avgcount'] for r in rtt.values())} batches; daemon queue wait median "
            f"{med.get('queue_wait', 0):.3f} ms, device wall median "
            f"{med.get('device_wall', 0):.3f} ms ({len(split['device_wall'])} records); "
            f"the daemon's service time (receipt to reply, a request) "
            f"{service['avg'] * 1e3:.3f} ms on average over {service['avgcount']}")

        # failover: the daemon stops while a pool-A batch of 8 ops from
        # 2 OSDs is in flight; every waiter must get the same bytes
        # through its OSD's local replay, and no local breaker moves
        acc.dispatch.inject_launch_hang = FAILOVER_HOLD_S
        before = {o.name: dict(o.dispatch.dump()["totals"]) for o in osds}
        tasks = [asyncio.ensure_future(owner(i, FAILOVER_OSDS).dispatch.encode(
            sinfo_a, codec_a, o)) for i, o in enumerate(objs[:FAILOVER_OPS])]
        t0 = time.perf_counter()
        while not acc.dispatch.dump()["inflight_launches"]:
            if time.perf_counter() - t0 > 30:
                raise AssertionError("the failover batch never reached the daemon's card")
            await asyncio.sleep(0.001)
        await acc.stop(crash=True)
        replayed = await asyncio.gather(*tasks)
        for i, g in enumerate(replayed):
            _check_shards(f"replayed op {i}", g, want_a[i])
        n_replayed = 0
        for o in osds[:FAILOVER_OSDS]:
            t = o.dispatch.dump()["totals"]
            n_replayed += t["replayed_ops"] - before[o.name]["replayed_ops"]
            recs = new_records(o)
            if not recs or any((r["served"], r.get("origin")) != ("fallback", "remote")
                               for r in recs):
                raise AssertionError(f"{o.name}: failover records {recs}")
            if o.sup.state != HEALTHY or o.sup.totals["fatal_errors"]:
                raise AssertionError(f"{o.name}: the local breaker moved: {o.sup.dump()}")
        if n_replayed != FAILOVER_OPS:
            raise AssertionError(f"{n_replayed} ops replayed, expected {FAILOVER_OPS}")
        log(f"  failover: accel.0 stopped with {FAILOVER_OPS} ops from {FAILOVER_OSDS} OSDs "
            f"in flight; all replayed on the OSDs' host engines (origin=remote), bytes == "
            f"host engine; local breakers HEALTHY")
        for o in osds:
            await o.stop()
        await time_wire(objs, sinfo_a)

    asyncio.run(asyncio.wait_for(main(), ACCEL_PHASE_LIMIT_S))
    return launches["phase"]


# -- phase 10: the accelerator fleet behind the Monitor ---------------------------

# the fleet test's intervals (tests/test_accel_fleet.py:455-459)
FLEET_OVERRIDES = {"accel_beacon_interval": 0.05, "osd_ec_accel_retry_interval": 0.1}
FLEET_DAEMONS = (("accel.a", "host0"), ("accel.b", "host1"))
# step 3: degraded pool-A reads whose survivors are labelled mostly host1
LOCALITY_OPS = 16
# the mon's markdown of a crashed daemon must reach every router in this
# long (the connection reset marks it down at once; mon_accel_beacon_grace,
# 5 s by default, is the bound of the beacon-loss path)
MARKDOWN_BOUND_S = 5.0
FLEET_PHASE_LIMIT_S = 600.0


def start_mon_process(root: Path, store: str, options: str = ""):
    """The port's mon in its own process, through the daemon tool: a
    solo mon with a durable store that exits if this process dies.
    ``options`` reach it through ``CEPH_TPU_ARGS`` (``--name value``
    pairs).  Returns the process, its address and the file its stderr
    goes to."""
    import os
    import select

    err = open(Path(store) / "mon.stderr", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.daemon", "mon", "--rank", "0",
         "--addr", "127.0.0.1:0", "--monmap", "127.0.0.1:0", "--store", store,
         "--watch-parent", str(os.getpid())],
        cwd=root, stdout=subprocess.PIPE, stderr=err, text=True,
        env=dict(os.environ, CEPH_TPU_ARGS=options, PYTHONPATH=os.pathsep.join(
            p for p in (str(root), os.environ.get("PYTHONPATH")) if p)))
    ready, _, _ = select.select([proc.stdout], [], [], 120)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("mon.0 up at "):
        proc.kill()
        proc.wait()
        err.seek(0)
        raise AssertionError(f"the mon process did not come up: {line!r} {err.read()[-2000:]}")
    return proc, line.split()[-1], err


def stop_process(proc) -> None:
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def run_accel_fleet(dev, rng, single: dict | None = None) -> dict:
    """Phase 10 (see the module docstring).  ``single`` holds phase 9's
    GB/s of the same steps through one daemon, printed beside the
    fleet's.  Returns the kernels' launch counts over the phase, counted
    from one reset once the fleet is up (every launch is a daemon's: the
    OSDs' codecs live on the CPU)."""
    import asyncio
    import tempfile

    import torch

    from ceph_tpu_torch.accel import AccelDaemon, AccelRouter
    from ceph_tpu_torch.common import Config
    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_failover import HEALTHY

    root = Path(__file__).resolve().parent
    cfg = Config(FLEET_OVERRIDES, env="")
    SimOsd = sim_osd_class()

    def cpu_pool(spec):
        plugin, profile, chunk = spec
        codec = registry.instance().factory(plugin, dict(profile, plugin=plugin),
                                            device="cpu")
        return codec, ec_util.StripeInfo(codec.get_data_chunk_count() * chunk, chunk)

    codec_a, sinfo_a = cpu_pool(POOL_A)
    codec_b, sinfo_b = cpu_pool(POOL_B)
    objs = [rng.integers(0, 256, size=OSD_OBJECT_SIZE, dtype=np.uint8)
            for _ in range(OSD_OPS)]
    objs_b = [np.frombuffer(sinfo_b.pad_to_stripe(o.tobytes()), dtype=np.uint8)
              for o in objs]
    total_bytes = OSD_OPS * OSD_OBJECT_SIZE
    want_a = [ec_util.encode(sinfo_a, codec_a, o) for o in objs]
    want_b = [ec_util.encode(sinfo_b, codec_b, o) for o in objs_b]
    launches = {}

    async def main(mon_addr):
        accs = {}
        for name, locality in FLEET_DAEMONS:
            acc = AccelDaemon(name, mon_addr=mon_addr,
                              config=Config(dict(FLEET_OVERRIDES, accel_locality=locality),
                                            env=""), device=None)
            if acc.device != dev:
                raise AssertionError(f"{name} on {acc.device}, expected {dev}")
            await acc.start("127.0.0.1", 0)
            accs[name] = acc
        osds = [SimOsd(i, cfg, lambda o: AccelRouter(
            o.messenger, mode="require", deadline=cfg.osd_ec_accel_deadline,
            retry_interval=cfg.osd_ec_accel_retry_interval,
            stale_interval=cfg.osd_ec_accel_stale_interval, perf=o.pacc,
            perf_collection=o.perf))
            for i in range(ACCEL_OSDS)]
        t0 = time.perf_counter()
        for o in osds:
            await o.subscribe(mon_addr)
        # 1. both daemons in every router, learned from a map push
        while any(len(o.remote._map_clients) < len(accs) for o in osds):
            if time.perf_counter() - t0 > 30:
                raise AssertionError("the routers never learned the fleet: "
                                     f"{[o.remote.dump() for o in osds]}")
            await asyncio.sleep(0.01)
        amap = await osds[0].command({"prefix": "accel ls"})
        aid = {e["name"]: int(k) for k, e in amap["accels"].items()}
        if set(aid) != set(accs) or not all(e["up"] for e in amap["accels"].values()):
            raise AssertionError(f"the mon's AccelMap: {amap}")
        epochs = {o.name: o.osdmap.accelmap.epoch for o in osds}
        if set(epochs.values()) != {amap["epoch"]}:
            raise AssertionError(f"accelmap epochs: mon {amap['epoch']}, routers {epochs}")
        for o in osds:
            if {cl.aid for cl in o.remote._map_clients.values()} != set(aid.values()):
                raise AssertionError(f"{o.name}: fleet {o.remote.dump()['fleet']}")
        log(f"  mon.0 (its own process) at {mon_addr}; {', '.join(f'{n} (aid {aid[n]}, '
            f'locality {loc}) on {accs[n].device} at {accs[n].addr}' for n, loc in FLEET_DAEMONS)}; "
            f"{ACCEL_OSDS} OSDs (AccelRouter, mode require, codecs on the CPU) hold both, "
            f"accelmap epoch {amap['epoch']} on the mon and every router "
            f"({(time.perf_counter() - t0) * 1e3:.1f} ms after subscribing)")

        def snapshot():
            torch.cuda.synchronize()
            return dict(gf_cuda.launches)

        def counts(name, since):
            got = {n: c - since[n] for n, c in snapshot().items()}
            log(f"  launches in {name}: {got}")
            return got

        def owner(i, n_osds=ACCEL_OSDS):
            return osds[i % n_osds]

        async def timed(coros):
            t0 = time.perf_counter()
            out = await asyncio.gather(*coros)
            return out, time.perf_counter() - t0

        def step(name, seconds):
            log(f"  {name}: {total_bytes / seconds / 1e9:.3f} GB/s ({seconds * 1e3:.1f} ms, "
                f"host clock, through the fleet); one daemon (phase 9): "
                f"{(single or {}).get(name, 'not run')}")

        def totals(o):
            return dict(o.dispatch.dump()["totals"])

        def router_sum(key):
            return sum(o.remote.totals[key] for o in osds)

        def served():
            return {n: (a.dispatch.dump()["totals"]["ops"],
                        a.dispatch.dump()["totals"]["batches"]) for n, a in accs.items()}

        gf_cuda.reset_launches()
        start = snapshot()

        # 2. pool A: 64 writes, 16 from each OSD, then two degraded reads;
        # pool B: 64 writes, a four-erasure read
        got, s = await timed(owner(i).dispatch.encode(sinfo_a, codec_a, o)
                             for i, o in enumerate(objs))
        for i, g in enumerate(got):
            _check_shards(f"fleet pool A op {i}", g, want_a[i])
        step("pool A encode", s)
        shards_a = got
        for lost in ((0,), (1, 5, 9)):
            outs, s = await timed(
                owner(i).dispatch.decode_concat(
                    sinfo_a, codec_a, {k: v for k, v in sh.items() if k not in lost})
                for i, sh in enumerate(shards_a))
            for i, (o, out) in enumerate(zip(objs, outs)):
                if bytes(out) != o.tobytes():
                    raise AssertionError(f"fleet pool A op {i}: decode of {lost} differs")
            step(f"pool A decode {list(lost)}", s)
        launches["pool A"] = counts("pool A", start)
        if launches["pool A"]["gf_matmul"] == 0:
            raise AssertionError("gf_matmul was not launched by the fleet in pool A")
        since = snapshot()
        got, s = await timed(owner(i).dispatch.encode(sinfo_b, codec_b, o)
                             for i, o in enumerate(objs_b))
        for i, g in enumerate(got):
            _check_shards(f"fleet pool B op {i}", g, want_b[i])
        step("pool B encode", s)
        lost = (0, 4, 11, 13)
        outs, s = await timed(
            owner(i).dispatch.decode_concat(
                sinfo_b, codec_b, {k: v for k, v in sh.items() if k not in lost})
            for i, sh in enumerate(got))
        for i, (o, out) in enumerate(zip(objs_b, outs)):
            if bytes(out) != o.tobytes():
                raise AssertionError(f"fleet pool B op {i}: decode of {lost} differs")
        step(f"pool B decode {list(lost)}", s)
        del got, outs
        launches["pool B"] = counts("pool B", since)
        if launches["pool B"]["bitmatrix_xor"] == 0:
            raise AssertionError("bitmatrix_xor was not launched by the fleet in pool B")
        for o in osds:
            t = totals(o)
            if t["lanes"]["remote"]["ops"] != 5 * OSD_OPS // ACCEL_OSDS or \
                    t["lanes"]["device"]["ops"] or t["failovers"] or \
                    t["fallback_direct"] or t["native_direct"]:
                raise AssertionError(f"{o.name}: an op left the fleet: {t}")
        for n, a in accs.items():
            t = a.dispatch.dump()["totals"]
            if t["failovers"] or t["fallback_direct"] or t["native_direct"] or \
                    t["deadline_timeouts"]:
                raise AssertionError(f"{n}: ops served off the card: {t}")
        share = served()
        split = {}
        for o in osds:
            for a in o.remote._map_clients:
                fam = o.perf.get(f"accel@{a}")
                split[a] = split.get(a, 0) + fam.get("remote_batches")
        agg = sum(o.pacc.get("remote_batches") for o in osds)
        if sum(split.values()) != agg:
            raise AssertionError(f"accel@<id> split {split} does not sum to {agg}")
        log(f"  per daemon (member ops, launches): {share}; the routers' accel@<id> split "
            f"of {agg} batches: {split}; rebalances {router_sum('rebalances')} (a target is "
            f"kept while its load is within the router's hysteresis of the best)")

        # 3. a locality-labelled decode: survivors mostly on host1
        before = {k: router_sum(k) for k in ("locality_hits", "locality_misses")}
        ops_b = served()["accel.b"][0]
        ops_a = served()["accel.a"][0]
        survivors = [k for k in range(len(want_a[0])) if k not in (1, 5, 9)]
        labels = ["host1"] * (len(survivors) - 2) + ["host0"] * 2
        outs, s = await timed(
            owner(i).dispatch.decode_concat(
                sinfo_a, codec_a, {k: shards_a[i][k] for k in survivors}, locality=labels)
            for i in range(LOCALITY_OPS))
        for i, out in enumerate(outs):
            if bytes(out) != objs[i].tobytes():
                raise AssertionError(f"locality decode op {i} differs")
        hits = router_sum("locality_hits") - before["locality_hits"]
        misses = router_sum("locality_misses") - before["locality_misses"]
        if hits == 0 or misses or served()["accel.a"][0] != ops_a or \
                served()["accel.b"][0] - ops_b != LOCALITY_OPS:
            raise AssertionError(f"locality decode: hits {hits}, misses {misses}, "
                                 f"served {served()}")
        log(f"  locality: {LOCALITY_OPS} degraded reads labelled mostly host1 all served by "
            f"accel.b: {hits} locality hits, {misses} misses ({s * 1e3:.1f} ms); per daemon "
            f"(member ops, launches): {served()}")

        # 4. accel.a dies with 8 pool-A reads from 2 OSDs in flight on it
        # (their survivors labelled host0, so every router sends them to it)
        victim, survivor = accs["accel.a"], accs["accel.b"]
        victim.dispatch.inject_launch_hang = FAILOVER_HOLD_S
        before = {o.name: totals(o) for o in osds}
        hop = router_sum("failover_next")
        ops_b = served()["accel.b"][0]
        labels = ["host0"] * len(survivors)
        tasks = [asyncio.ensure_future(owner(i, FAILOVER_OSDS).dispatch.decode_concat(
            sinfo_a, codec_a, {k: shards_a[i][k] for k in survivors}, locality=labels))
            for i in range(FAILOVER_OPS)]
        t0 = time.perf_counter()
        while not victim.dispatch.dump()["inflight_launches"]:
            if time.perf_counter() - t0 > 30:
                raise AssertionError("the failover batch never reached accel.a's card")
            await asyncio.sleep(0.001)
        t_kill = time.perf_counter()
        kill = asyncio.ensure_future(victim.stop(crash=True))
        outs = await asyncio.gather(*tasks)
        t_served = time.perf_counter() - t_kill
        await kill
        for i, out in enumerate(outs):
            if bytes(out) != objs[i].tobytes():
                raise AssertionError(f"failed-over op {i} differs")
        hops = router_sum("failover_next") - hop
        moved = served()["accel.b"][0] - ops_b
        for o in osds:
            t = totals(o)
            if t["failovers"] != before[o.name]["failovers"] or \
                    t["replayed_ops"] != before[o.name]["replayed_ops"]:
                raise AssertionError(f"{o.name}: a local replay in the failover: {t}")
            if o.sup.state != HEALTHY:
                raise AssertionError(f"{o.name}: the local breaker moved: {o.sup.dump()}")
        if hops < 1 or moved != FAILOVER_OPS:
            raise AssertionError(f"failover: {hops} hops, accel.b served {moved} ops")
        while any(aid["accel.a"] not in o.dropped for o in osds):
            if time.perf_counter() - t_kill > MARKDOWN_BOUND_S:
                raise AssertionError(f"the markdown did not reach every router in "
                                     f"{MARKDOWN_BOUND_S} s: {[o.dropped for o in osds]}")
            await asyncio.sleep(0.001)
        spread = [o.dropped[aid["accel.a"]] - t_kill for o in osds]
        amap = await osds[0].command({"prefix": "accel ls"})
        if amap["accels"][str(aid["accel.a"])]["up"]:
            raise AssertionError(f"the mon did not mark accel.a down: {amap}")
        log(f"  failover: accel.a crashed with {FAILOVER_OPS} reads from {FAILOVER_OSDS} OSDs "
            f"in flight; accel.b served all {moved} ({t_served * 1e3:.1f} ms from the kill), "
            f"failover_next {hops}, no local replay, local breakers HEALTHY")
        log(f"  markdown: the mon marked accel.a down (accelmap epoch {amap['epoch']}); the "
            f"push reached the routers {min(spread) * 1e3:.3f} to {max(spread) * 1e3:.3f} ms "
            f"after the kill (bound {MARKDOWN_BOUND_S} s)")
        launches["phase"] = counts("the phase", start)

        # 5. the whole fleet down: accel.b dies with 8 reads in flight
        survivor.dispatch.inject_launch_hang = FAILOVER_HOLD_S
        before = {o.name: totals(o) for o in osds}
        tasks = [asyncio.ensure_future(owner(i, FAILOVER_OSDS).dispatch.decode_concat(
            sinfo_a, codec_a, {k: shards_a[i][k] for k in survivors}))
            for i in range(FAILOVER_OPS)]
        t0 = time.perf_counter()
        while not survivor.dispatch.dump()["inflight_launches"]:
            if time.perf_counter() - t0 > 30:
                raise AssertionError("the last batch never reached accel.b's card")
            await asyncio.sleep(0.001)
        await survivor.stop(crash=True)
        outs = await asyncio.gather(*tasks)
        for i, out in enumerate(outs):
            if bytes(out) != objs[i].tobytes():
                raise AssertionError(f"replayed op {i} differs")
        replayed = sum(totals(o)["replayed_ops"] - before[o.name]["replayed_ops"]
                       for o in osds)
        for o in osds[:FAILOVER_OSDS]:
            recs = o.dispatch.flight.dump()["launches"][-1:]
            if not recs or (recs[0]["served"], recs[0].get("origin")) != ("fallback", "remote"):
                raise AssertionError(f"{o.name}: last flight record {recs}")
        t0 = time.perf_counter()
        while not all(o.remote.unreachable for o in osds):
            if time.perf_counter() - t0 > MARKDOWN_BOUND_S:
                raise AssertionError(f"whole fleet down: unreachable "
                                     f"{[o.remote.unreachable for o in osds]}")
            await asyncio.sleep(0.001)
        if replayed != FAILOVER_OPS:
            raise AssertionError(f"whole fleet down: {replayed} ops replayed, expected "
                                 f"{FAILOVER_OPS}")
        log(f"  whole fleet down: accel.b crashed with {FAILOVER_OPS} reads in flight; all "
            f"replayed on the OSDs' host engines (origin=remote), bytes == originals; every "
            f"router reads unreachable")
        for o in osds:
            await o.stop()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mon_") as store:
        proc, mon_addr, err = start_mon_process(root, store)
        try:
            asyncio.run(asyncio.wait_for(main(mon_addr), FLEET_PHASE_LIMIT_S))
            if proc.poll() is not None:
                raise AssertionError(f"the mon process exited with {proc.returncode}")
        finally:
            stop_process(proc)
            err.close()
    return launches["phase"]


# -- phase 11: the operator surface --------------------------------------------------


# the window asks for longer than kernel_trace_max_duration allows, and
# must come back clamped to it
TRACE_MAX_S = 60.0
TRACE_ASK_S = 600.0
# accel.a's MDaemonStats must reach the active mgr within this many
# report intervals of the daemon's map naming it
REPORT_INTERVALS = 5
OBS_PHASE_LIMIT_S = 600.0
# the kernels the trace window must name among its top ops
TRACE_KERNELS = ("gf_matmul_kernel", "bitmatrix_xor_kernel")


def _leaves(obj, path=()):
    """Every leaf of a JSON body, by its path."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _leaves(v, path + (i,))
    else:
        yield path, obj


def check_between(what: str, got, before, after) -> None:
    """``got`` was read over a socket between two in-process reads of
    the same body: the same leaves, each number within the two reads'
    range (counters and ages move while the daemon runs), anything else
    equal to one of them."""
    def norm(body):
        return dict(_leaves(json.loads(json.dumps(body))))

    g, b, a = norm(got), norm(before), norm(after)
    if set(g) != set(b) or set(g) != set(a):
        raise AssertionError(f"{what}: the socket's body has other keys: "
                             f"{sorted(set(g) ^ set(b))[:10]}")
    for k, v in g.items():
        lo, hi = b[k], a[k]
        if isinstance(v, (int, float)) and not isinstance(v, bool) and \
                isinstance(lo, (int, float)) and isinstance(hi, (int, float)):
            if not min(lo, hi) <= v <= max(lo, hi):
                raise AssertionError(f"{what}: {k} = {v} over the socket, "
                                     f"{lo} and {hi} in process")
        elif v != lo and v != hi:
            raise AssertionError(f"{what}: {k} = {v!r} over the socket, "
                                 f"{lo!r} and {hi!r} in process")


def check_trace_window(result: dict, launched: dict) -> float:
    """The window's dump must show the card's work: kernel and copy
    seconds, both EC kernels among its top ops, and more than half of
    its device seconds attributed to the engines that launched them.
    The capture must be whole: for each EC kernel, as many captured
    kernel events as launches counted in the window (``launched``, the
    wrappers' counts), the same counts in the dump's ``capture``, and
    no tap interval without a captured device event.  Returns the
    attributed share."""
    from ceph_tpu_torch.ops import gf_cuda

    if "error" in result or "unavailable" in result:
        raise AssertionError(f"the trace window failed: {result}")
    capture = result["capture"]
    for name in gf_cuda.EC_KERNELS:
        got = capture["kernels"][name]
        if got != {"launched": launched[name], "captured": launched[name]}:
            raise AssertionError(f"the trace window's capture is short: {name} launched "
                                 f"{launched[name]} times in the window, the dump "
                                 f"{got}")
    if capture["short"] or capture["intervals_without_device_events"]:
        raise AssertionError(f"the trace window's capture is short: {capture}")
    b = result["buckets"]
    if not b["fused_op"] > 0 or not b["dma"] > 0:
        raise AssertionError(f"trace buckets {b}: no kernel or no copy time")
    names = [op["name"] for op in result["top_ops"]]
    for k in TRACE_KERNELS:
        if not any(k in n for n in names):
            raise AssertionError(f"{k} is not among the window's top ops: {names}")
    attributed = sum(e["seconds"] for e in result["engines"].values())
    share = attributed / result["device_seconds"]
    if share <= 0.5:
        raise AssertionError(f"only {share:.3f} of the device seconds attributed to "
                             f"engines: {result['engines']} {result['unattributed']}")
    return share


def run_observability(dev, rng) -> dict:
    """Phase 11 (see the module docstring).  Returns the kernels' launch
    counts over the phase's steps."""
    import asyncio
    import os
    import tempfile

    import torch

    from ceph_tpu_torch.accel import AccelDaemon, AccelRouter
    from ceph_tpu_torch.common import Config, admin_command
    from ceph_tpu_torch.mgr import MgrDaemon
    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.ops.device_trace import busy_seconds, tracer
    from ceph_tpu_torch.osd import ec_util

    root = Path(__file__).resolve().parent
    cfg = Config(FLEET_OVERRIDES, env="")
    SimOsd = sim_osd_class()

    def cpu_pool(spec):
        plugin, profile, chunk = spec
        codec = registry.instance().factory(plugin, dict(profile, plugin=plugin),
                                            device="cpu")
        return codec, ec_util.StripeInfo(codec.get_data_chunk_count() * chunk, chunk)

    codec_a, sinfo_a = cpu_pool(POOL_A)
    codec_b, sinfo_b = cpu_pool(POOL_B)
    objs = [rng.integers(0, 256, size=OSD_OBJECT_SIZE, dtype=np.uint8)
            for _ in range(OSD_OPS)]
    objs_b = [np.frombuffer(sinfo_b.pad_to_stripe(o.tobytes()), dtype=np.uint8)
              for o in objs]
    want_a = [ec_util.encode(sinfo_a, codec_a, o) for o in objs]
    want_b = [ec_util.encode(sinfo_b, codec_b, o) for o in objs_b]
    launches = {}

    async def main(mon_addr, mon_sock, sockdir):
        report_s = cfg.accel_mgr_report_interval
        mgrs = {n: MgrDaemon(n, mon_addr, config=Config(env=""))
                for n in ("mgr.x", "mgr.y")}
        acc_sock = os.path.join(sockdir, "accel.a.asok")
        acc = AccelDaemon("accel.a", mon_addr=mon_addr, config=Config(dict(
            FLEET_OVERRIDES, accel_locality="host0", admin_socket=acc_sock,
            kernel_trace_max_duration=TRACE_MAX_S), env=""), device=None)
        if acc.device != dev:
            raise AssertionError(f"accel.a on {acc.device}, expected {dev}")
        await acc.start("127.0.0.1", 0)
        osds = [SimOsd(i, cfg, lambda o: AccelRouter(
            o.messenger, mode="require", deadline=cfg.osd_ec_accel_deadline,
            retry_interval=cfg.osd_ec_accel_retry_interval,
            stale_interval=cfg.osd_ec_accel_stale_interval, perf=o.pacc,
            perf_collection=o.perf))
            for i in range(ACCEL_OSDS)]
        for o in osds:
            await o.subscribe(mon_addr)

        async def until(what, pred, bound):
            t0 = time.perf_counter()
            while not pred():
                if time.perf_counter() - t0 > bound:
                    raise AssertionError(f"{what}: not within {bound} s")
                await asyncio.sleep(0.005)
            return time.perf_counter() - t0

        await until("the routers learn accel.a",
                    lambda: all(o.remote._map_clients for o in osds), 30)

        def snapshot():
            torch.cuda.synchronize()
            return dict(gf_cuda.launches)

        async def asok(path, prefix, **kw):
            return await asyncio.wait_for(admin_command(path, prefix, **kw), 60)

        def owner(i):
            return osds[i % ACCEL_OSDS]

        gf_cuda.reset_launches()
        start = snapshot()

        # 1. a trace window around pools A and B
        opened = await asok(acc_sock, "kernel trace start", duration=TRACE_ASK_S,
                            label="phase 11")
        if not opened.get("success") or opened["duration_s"] != TRACE_MAX_S:
            raise AssertionError(f"kernel trace start: {opened}")
        refused = await asok(acc_sock, "kernel trace start", duration=1.0)
        if not refused.get("busy") or "already open" not in refused.get("error", ""):
            raise AssertionError(f"a second window was not refused: {refused}")
        t0 = time.perf_counter()
        got = await asyncio.gather(*(owner(i).dispatch.encode(sinfo_a, codec_a, o)
                                     for i, o in enumerate(objs)))
        for i, g in enumerate(got):
            _check_shards(f"traced pool A op {i}", g, want_a[i])
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = await asyncio.gather(*(owner(i).dispatch.encode(sinfo_b, codec_b, o)
                                     for i, o in enumerate(objs_b)))
        for i, g in enumerate(got):
            _check_shards(f"traced pool B op {i}", g, want_b[i])
        t_b = time.perf_counter() - t0
        del got
        stopped = await asok(acc_sock, "kernel trace stop")
        dumped = await asok(acc_sock, "kernel trace dump")
        if dumped != stopped:
            raise AssertionError(f"kernel trace dump {dumped} differs from stop {stopped}")
        launches["window"] = {n: c - start[n] for n, c in snapshot().items()}
        for name in gf_cuda.EC_KERNELS:
            if launches["window"][name] == 0:
                raise AssertionError(f"{name} was not launched in the trace window")
        log(f"  the capture: {dumped['capture']}; launches counted in the window "
            f"{launches['window']}")
        share = check_trace_window(dumped, launches["window"])
        profile = await asok(acc_sock, "dump_kernel_profile")
        for engine, e in dumped["engines"].items():
            merged = profile["engines"].get(engine, {}).get("device_trace")
            if not merged or abs(sum(merged.values()) - e["seconds"]) > 1e-5 * max(
                    1, len(merged)):
                raise AssertionError(f"dump_kernel_profile's {engine}: device_trace "
                                     f"{merged}, the window {e}")

        # 2. the window's split
        nbytes = OSD_OPS * OSD_OBJECT_SIZE
        busy = busy_seconds(tracer().last_device_spans)
        wall = dumped["wall_s"]
        log(f"  kernel trace window on accel.a ({acc.device}): pool A encode "
            f"{nbytes / t_a / 1e9:.3f} GB/s, pool B encode {nbytes / t_b / 1e9:.3f} GB/s "
            f"(host clock, traced), every byte checked; wall {wall} s, "
            f"{dumped['launch_intervals']} tap intervals, {dumped['op_events']} device events")
        log(f"  buckets (device seconds): {dumped['buckets']}; device_seconds "
            f"{dumped['device_seconds']}; occupancy {dumped.get('occupancy')}; "
            f"{share:.4f} of the device seconds attributed to engines, unattributed "
            f"{dumped['unattributed']}")
        for rank, op in enumerate(dumped["top_ops"], 1):
            if rank <= 5 or any(k in op["name"] for k in TRACE_KERNELS):
                log(f"  top op {rank}: {op['name'][:90]} [{op['bucket']}] x{op['count']} "
                    f"{op['seconds']:.6f} s")
        for engine, e in dumped["engines"].items():
            log(f"  engine {engine}: fused_op {e['fused_op']} s, dma {e['dma']} s, "
                f"{e['events']} events")
        log(f"  the card busy {busy:.6f} s of the window's {wall} s: idle share "
            f"{1 - busy / wall:.4f} (union of the captured CUDA intervals)")

        # 3. the admin sockets
        for prefix, read in (("dump_launch_history", acc.dispatch.flight.dump),
                             ("status", lambda: {
                                 "name": acc.name, "addr": acc.addr,
                                 "clients": acc.client_table(),
                                 "queue_depth": acc.queue_depth(),
                                 "engine_state": acc.supervisor.state}),
                             ("perf dump", acc.perf.dump)):
            before = read()
            got = await asok(acc_sock, prefix)
            check_between(f"accel.a {prefix}", got, before, read())
        mon_perf = await asok(mon_sock, "perf dump")
        mon_conf = await asok(mon_sock, "config show")
        if "mon" not in mon_perf or mon_conf.get("admin_socket") != mon_sock.replace(
                "mon.0", "{name}"):
            raise AssertionError(f"the mon's socket: perf {sorted(mon_perf)}, "
                                 f"admin_socket {mon_conf.get('admin_socket')!r}")
        log(f"  admin sockets: accel.a's dump_launch_history, status and perf dump equal "
            f"the daemon's own; mon.0 (its own process) answers perf dump "
            f"({mon_perf['mon']['map_epoch']=}) and config show; a second window refused")

        # 4. the mgr
        await mgrs["mgr.x"].start()
        t_x = await until("mgr.x active", lambda: mgrs["mgr.x"].active, 30)
        await mgrs["mgr.y"].start()
        await until("accel.a's map names mgr.x",
                    lambda: acc.osdmap is not None and acc.osdmap.mgr_name == "mgr.x", 30)
        t_r = await until("accel.a's report at mgr.x",
                          lambda: "accel.a" in mgrs["mgr.x"].daemon_stats,
                          REPORT_INTERVALS * report_s)
        code, _, text = mgrs["mgr.x"].handle_command({"prefix": "metrics"})
        ec = mgrs["mgr.x"].daemon_stats["accel.a"]["perf"]["ec"]
        n_ec = 0
        for key, val in ec.items():
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                lines = [ln for ln in text.splitlines()
                         if ln.startswith(f'ceph_ec_{key}{{daemon="accel.a"}} ')]
                if len(lines) != 1 or float(lines[0].split()[-1]) != float(val):
                    raise AssertionError(f"prometheus ceph_ec_{key} for accel.a: {lines}, "
                                         f"reported {val}")
                n_ec += 1
        if code != 0 or n_ec == 0:
            raise AssertionError(f"prometheus: code {code}, {n_ec} ec counters")
        t0 = time.perf_counter()
        await osds[0].command({"prefix": "mgr fail", "name": "mgr.x"})
        await until("mgr.y active", lambda: mgrs["mgr.y"].active, 30)
        t_f = time.perf_counter() - t0
        t_y = await until("accel.a's report at mgr.y",
                          lambda: "accel.a" in mgrs["mgr.y"].daemon_stats,
                          REPORT_INTERVALS * report_s + 5)
        log(f"  mgr: mgr.x active {t_x * 1e3:.1f} ms after it started; accel.a's "
            f"MDaemonStats reached it {t_r * 1e3:.1f} ms after its map named mgr.x "
            f"(report interval {report_s} s); prometheus carries its {n_ec} ec counters "
            f"once each; mgr fail mgr.x: mgr.y active {t_f * 1e3:.1f} ms after the command "
            f"was sent, accel.a's report there {t_y * 1e3:.1f} ms later")
        launches["phase"] = {n: c - start[n] for n, c in snapshot().items()}
        for o in osds:
            await o.stop()
        for m in mgrs.values():
            await m.stop()
        await acc.stop()
        if os.path.exists(acc_sock):
            raise AssertionError("accel.a's admin socket outlived the daemon")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as store:
        sockdir = os.path.join(store, "run")
        os.makedirs(sockdir)
        proc, mon_addr, err = start_mon_process(
            root, store, f"--admin_socket {sockdir}/{{name}}.asok")
        try:
            asyncio.run(asyncio.wait_for(
                main(mon_addr, os.path.join(sockdir, "mon.0.asok"), sockdir),
                OBS_PHASE_LIMIT_S))
            if proc.poll() is not None:
                raise AssertionError(f"the mon process exited with {proc.returncode}")
        finally:
            stop_process(proc)
            err.close()
    return launches["phase"]


# -- phase 12: the card's EC writes in the shard stores ----------------------------


# one PG of pool A, its 11 shards on 11 OSDs' stores (one BlueStore each)
STORE_PG = "1.0"
STORE_EPOCH = 7
STORE_OBJECTS = 64
# the three shards lost to the degraded read, one way each
STORE_BITROT_SHARD = 1
STORE_DOWN_SHARD = 5
STORE_BAD_CRC_SHARD = 9
# the crash step: this shard's store is a WalStore that journals
# STORE_CRASH_AFTER of the STORE_CRASH_OBJECTS writes and then crashes;
# its read loses STORE_WAL_LOST, so minimum_to_decode reads the WalStore
STORE_WAL_SHARD = 2
STORE_CRASH_OBJECTS = 16
STORE_CRASH_AFTER = 10
STORE_WAL_LOST = (0, 1)
# the object info xattr (ceph_tpu/osd/recovery.py:69 OI_KEY)
OI_KEY = "_"
STORE_PHASE_LIMIT_S = 600.0


def store_oid(i: int) -> str:
    return f"rbd_data.12ab.{i:016x}"


def ec_write_txns(sinfo, oid: str, shard_bufs: dict, size: int, version, prior) -> dict:
    """The per-shard transactions of the OSD's EC write of a whole object:
    ``_ec_commit``'s ``build_txn`` (ceph_tpu/osd/daemon.py:2563-2630: the
    shard collection ``{pg}s{shard}``, the rollback stash, the truncate of a
    full write, the chunk, the crc table and the object info), with the PG
    log entry appended in the same transaction as ``_apply_sub_write`` does
    (:3149-3170)."""
    from ceph_tpu_torch.osd import ec_transaction
    from ceph_tpu_torch.osd.ec_util import StripeHashes
    from ceph_tpu_torch.osd.pg_log import PGLogEntry, add_log_entry_to_txn, stash_name
    from ceph_tpu_torch.store import CollectionId, ObjectId, Transaction

    plan = ec_transaction.plan_write_full(sinfo, 0, size)
    hashes = StripeHashes(len(shard_bufs), sinfo.chunk_size)
    hashes.set_range(0, shard_bufs)
    hinfo_b = json.dumps(hashes.to_dict()).encode()
    oi_b = json.dumps({"size": plan.new_size, "version": version.to_list()}).encode()
    sname = stash_name(oid, version)
    entry = PGLogEntry("modify", oid, version, prior, stash=sname)
    txns = {}
    for shard, buf in shard_bufs.items():
        cid = CollectionId(f"{STORE_PG}s{shard}")
        soid = ObjectId(oid, shard)
        txn = (Transaction().create_collection(cid)
               .try_stash(cid, soid, ObjectId(sname, shard))
               .truncate(cid, soid, plan.shard_truncate)
               .write(cid, soid, 0, np.asarray(buf).tobytes())
               .setattr(cid, soid, StripeHashes.XATTR_KEY, hinfo_b)
               .setattr(cid, soid, OI_KEY, oi_b))
        add_log_entry_to_txn(txn, cid, shard, entry)
        txns[shard] = txn
    return txns


def read_shards_degraded(sinfo, codec, stores: dict, oid: str, lost=()) -> tuple[dict, set]:
    """The OSD's degraded read of a whole object (``_ec_read``,
    ceph_tpu/osd/daemon.py:3280-3310): survivors from
    ``codec.minimum_to_decode`` over the shards not lost, each read from its
    store and its chunks held against the stored crc table; a shard whose
    read raises (``BitrotError``, a missing object) or whose crc fails joins
    the failed set and the survivors are chosen again.  Returns the chunks
    read and the shards that failed."""
    from ceph_tpu_torch.osd.ec_util import StripeHashes
    from ceph_tpu_torch.store import CollectionId, ObjectId

    want = list(range(codec.get_data_chunk_count()))
    usable = {s for s in stores if s not in lost}
    failed: set = set()
    while True:
        to_read = codec.minimum_to_decode(want, sorted(usable - failed))
        chunks = {}
        for s in to_read:
            cid, soid = CollectionId(f"{STORE_PG}s{s}"), ObjectId(oid, s)
            try:
                arr = np.frombuffer(stores[s].read(cid, soid), dtype=np.uint8)
                hashes = StripeHashes.from_dict(
                    json.loads(stores[s].getattr(cid, soid, StripeHashes.XATTR_KEY)))
            except (OSError, KeyError):
                failed.add(s)
                continue
            if arr.size % sinfo.chunk_size or not hashes.verify(s, 0, arr):
                failed.add(s)
                continue
            chunks[s] = arr
        if len(chunks) == len(to_read):
            return chunks, failed


def run_osd_stores(dev, rng, root: str | None = None) -> dict:
    """Phase 12 (see the module docstring).  ``root`` holds the stores
    (a temporary directory when None).  Returns the kernels' launch
    counts over the phase, counted from one reset."""
    import asyncio
    import os
    import shutil
    import tempfile

    import torch

    from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
    from ceph_tpu_torch.osd.ec_failover import HEALTHY, STATE_NAMES, EngineSupervisor
    from ceph_tpu_torch.osd.ec_perf import create_ec_perf
    from ceph_tpu_torch.osd.pg_log import Eversion, read_log
    from ceph_tpu_torch.store import (
        BitrotError,
        BlueStore,
        CollectionId,
        CrashPoint,
        ObjectId,
        Transaction,
        WalStore,
    )
    from ceph_tpu_torch.store.blue import _okey

    plugin, profile, chunk = POOL_A
    codec = registry.instance().factory(plugin, dict(profile), device=dev)
    if codec.device != dev:
        raise AssertionError(f"{plugin} codec on {codec.device}, expected {dev}")
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    sinfo = ec_util.StripeInfo(k * chunk, chunk)
    objs = [rng.integers(0, 256, size=OSD_OBJECT_SIZE, dtype=np.uint8)
            for _ in range(STORE_OBJECTS + STORE_CRASH_OBJECTS)]
    nbytes = STORE_OBJECTS * OSD_OBJECT_SIZE
    perf = PerfCountersCollection()
    pec = create_ec_perf(perf)
    sup = EngineSupervisor(enabled=True, perf=pec, probe_interval=OSD_PROBE_INTERVAL_S)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stores_") if root is None else None
    root = root or tmp
    stores = {s: BlueStore(os.path.join(root, f"osd.{s}"), sync="fsync") for s in range(n)}
    launches = {}

    def cid_of(s):
        return CollectionId(f"{STORE_PG}s{s}")

    def snapshot():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return gf_cuda.launch_counts()

    def off_card(d, what):
        t = d["totals"]
        for key in ("failovers", "fallback_direct", "native_direct", "deadline_timeouts"):
            if t[key]:
                raise AssertionError(f"{t[key]} {key} in {what}: an op was served off the card")

    async def main():
        disp = ECDispatcher(
            perf=pec, window=OSD_WINDOW_S, max_stripes=OSD_MAX_STRIPES, bucket=True,
            max_workers=OSD_WORKERS, supervisor=sup, launch_deadline=OSD_LAUNCH_DEADLINE_S)
        for s in stores.values():
            s.mkfs()
            s.mount()
        gf_cuda.reset_launches()
        start = snapshot()

        # 1. the write: encode on the card, then each shard's transaction
        commit_s = 0.0
        committed = []

        async def write(i, shard_stores):
            """Encode object i on the card and commit each shard's
            transaction; the shards that acknowledged go in ``committed``."""
            nonlocal commit_s
            shards = await disp.encode(sinfo, codec, objs[i])
            t0 = time.perf_counter()
            version = Eversion(STORE_EPOCH, i + 1)
            txns = ec_write_txns(sinfo, store_oid(i), shards, OSD_OBJECT_SIZE, version,
                                 Eversion())
            acked = []
            for s, st in shard_stores.items():
                try:
                    st.queue_transaction(txns[s], on_commit=lambda s=s: acked.append(s))
                except CrashPoint:
                    pass  # journaled, then the store's process died: no ack
            commit_s += time.perf_counter() - t0
            committed.append((i, sorted(acked)))
            return shards

        t0 = time.perf_counter()
        written = await asyncio.gather(*(write(i, stores) for i in range(STORE_OBJECTS)))
        wall = time.perf_counter() - t0
        for i, (o, sh) in enumerate(zip(objs, written)):
            _check_shards(f"stored op {i}", sh, ec_util.encode_fallback(sinfo, codec, o))
        if any(acked != list(range(n)) for _, acked in committed):
            raise AssertionError(f"a shard did not commit: {committed}")
        log(f"  write: {STORE_OBJECTS} x {OSD_OBJECT_SIZE / 2**20:g} MiB through "
            f"ECDispatcher.encode into {n} BlueStores (sync=fsync, no compression), "
            f"{n * STORE_OBJECTS} transactions: {nbytes / wall / 1e9:.3f} GB/s "
            f"({wall * 1e3:.1f} ms, host clock); the stores' commits "
            f"{commit_s * 1e3:.1f} ms ({commit_s / wall:.1%}), waiting on the "
            f"dispatcher's encode {(wall - commit_s) * 1e3:.1f} ms "
            f"({1 - commit_s / wall:.1%})")

        # 2. the restart
        t0 = time.perf_counter()
        for s in stores.values():
            s.umount()
            s.mount()
        for s, st in stores.items():
            report = st.fsck()
            if report["errors"] or report["objects"] < STORE_OBJECTS:
                raise AssertionError(f"shard {s} fsck after the restart: {report}")
            log_s = read_log(st, cid_of(s), s)
            versions = [e.version for e in log_s]
            if versions != [Eversion(STORE_EPOCH, i + 1) for i in range(STORE_OBJECTS)]:
                raise AssertionError(f"shard {s}'s PG log after the restart: {versions[:4]}...")
        log(f"  restart: {n} stores unmounted and mounted, fsck clean, each PG log "
            f"{STORE_OBJECTS} entries in version order ({time.perf_counter() - t0:.2f} s)")

        # 3. the degraded read: shard 1 rots under object 0, shard 5 is down,
        # shard 9 holds a wrong chunk of object 0 under its old crc table
        rot = stores[STORE_BITROT_SHARD]
        boff = rot._onodes[_okey(cid_of(STORE_BITROT_SHARD),
                                 ObjectId(store_oid(0), STORE_BITROT_SHARD))].extents[0][2]
        with open(os.path.join(rot.path, "block"), "r+b") as f:
            f.seek(boff + 4097)
            byte = f.read(1)
            f.seek(boff + 4097)
            f.write(bytes([byte[0] ^ 0x5A]))
        try:
            rot.read(cid_of(STORE_BITROT_SHARD), ObjectId(store_oid(0), STORE_BITROT_SHARD))
            raise AssertionError("the flipped byte did not surface as BitrotError")
        except BitrotError:
            pass
        stores[STORE_DOWN_SHARD].umount()
        bad = stores[STORE_BAD_CRC_SHARD]
        cid9, oid9 = cid_of(STORE_BAD_CRC_SHARD), ObjectId(store_oid(0), STORE_BAD_CRC_SHARD)
        bad.apply(Transaction().write(cid9, oid9, chunk, bytes(chunk)))
        up = {s: st for s, st in stores.items() if s != STORE_DOWN_SHARD}
        since = snapshot()
        t0 = time.perf_counter()
        reads = [read_shards_degraded(sinfo, codec, up, store_oid(i))
                 for i in range(STORE_OBJECTS)]
        t_read = time.perf_counter() - t0
        outs = await asyncio.gather(*(disp.decode_concat(sinfo, codec, chunks)
                                      for chunks, _ in reads))
        rwall = time.perf_counter() - t0
        for i, (o, got) in enumerate(zip(objs, outs)):
            if bytes(got[:OSD_OBJECT_SIZE]) != o.tobytes():
                raise AssertionError(f"stored op {i}: the degraded read differs")
        lost0 = set(range(n)) - set(reads[0][0])
        if reads[0][1] != {STORE_BITROT_SHARD, STORE_BAD_CRC_SHARD} or lost0 != {
                STORE_BITROT_SHARD, STORE_DOWN_SHARD, STORE_BAD_CRC_SHARD}:
            raise AssertionError(f"object 0 read failed {reads[0][1]}, survivors "
                                 f"{sorted(reads[0][0])}")
        if any(r[1] for r in reads[1:]):
            raise AssertionError(f"a shard failed outside object 0: "
                                 f"{[(i, r[1]) for i, r in enumerate(reads) if r[1]]}")
        launches["read"] = {nm: c - since[nm] for nm, c in snapshot().items()}
        log(f"  degraded read, shard {STORE_DOWN_SHARD} down, every object's bytes == "
            f"written: {nbytes / rwall / 1e9:.3f} GB/s ({rwall * 1e3:.1f} ms, host clock; "
            f"the stores' reads and crc checks {t_read * 1e3:.1f} ms "
            f"({t_read / rwall:.1%}), decode_concat {(rwall - t_read) * 1e3:.1f} ms); "
            f"object 0: shard {STORE_BITROT_SHARD} BitrotError, shard "
            f"{STORE_BAD_CRC_SHARD} failed StripeHashes.verify, decoded from "
            f"{sorted(reads[0][0])}; launches {launches['read']}")
        del outs, reads, written
        stores[STORE_DOWN_SHARD].mount()

        # 4. a crash and replay: shard 2's store is a WalStore
        wal_path = os.path.join(root, f"osd.{STORE_WAL_SHARD}.wal")
        wal = WalStore(wal_path, sync="fsync")
        wal.mkfs()
        wal.mount()
        wal.crash_after = STORE_CRASH_AFTER
        crash_stores = {**stores, STORE_WAL_SHARD: wal}
        committed.clear()
        first = STORE_OBJECTS
        written = []
        survivors = {s: st for s, st in crash_stores.items() if s != STORE_WAL_SHARD}
        crashed = False
        for i in range(first, first + STORE_CRASH_OBJECTS):
            # the crashed OSD takes no further writes: its process died
            written.append(await write(i, survivors if crashed else crash_stores))
            if not crashed and wal.crash_after <= 0:
                wal.crash_close()
                crashed = True
        journaled = list(range(first, first + STORE_CRASH_AFTER))
        wal = WalStore(wal_path, sync="fsync")
        wal.mount()
        crash_stores[STORE_WAL_SHARD] = wal
        cidw = cid_of(STORE_WAL_SHARD)
        for j, i in enumerate(range(first, first + STORE_CRASH_OBJECTS)):
            soid = ObjectId(store_oid(i), STORE_WAL_SHARD)
            if i in journaled:
                if wal.read(cidw, soid) != written[j][STORE_WAL_SHARD].tobytes():
                    raise AssertionError(f"WalStore write {i} is torn after the replay")
            elif wal.exists(cidw, soid):
                raise AssertionError(f"WalStore write {i} came after the crash but is there")
        wal_log = [e.version.version for e in read_log(wal, cidw, STORE_WAL_SHARD)]
        if wal_log != [i + 1 for i in journaled]:
            raise AssertionError(f"the WalStore's PG log after the replay: {wal_log}")
        acked = [i for i, a in committed if len(a) >= k]
        outs = []
        for i in acked:
            chunks, failed = read_shards_degraded(sinfo, codec, crash_stores, store_oid(i),
                                                  lost=STORE_WAL_LOST)
            if (STORE_WAL_SHARD in chunks) != (i in journaled):
                raise AssertionError(f"object {i}: survivors {sorted(chunks)}, failed {failed}")
            outs.append(disp.decode_concat(sinfo, codec, chunks))
        for i, got in zip(acked, await asyncio.gather(*outs)):
            if bytes(got[:OSD_OBJECT_SIZE]) != objs[i].tobytes():
                raise AssertionError(f"object {i}: the read over the WalStore differs")
        if len(acked) != STORE_CRASH_OBJECTS:
            raise AssertionError(f"{len(acked)} of {STORE_CRASH_OBJECTS} writes acknowledged")
        log(f"  crash and replay: shard {STORE_WAL_SHARD} on a WalStore (sync=fsync) "
            f"crashed after journaling {STORE_CRASH_AFTER} of {STORE_CRASH_OBJECTS} writes "
            f"(the last journaled but not applied); remounted, writes "
            f"{journaled[0]}..{journaled[-1]} read back whole and the "
            f"{STORE_CRASH_OBJECTS - STORE_CRASH_AFTER} later ones are absent; every "
            f"acknowledged object decodes with shards {list(STORE_WAL_LOST)} lost, through "
            f"the WalStore where it holds the object")
        wal.umount()

        # 5. nothing off the card
        off_card(disp.dump(), "phase 12")
        if sup.state != HEALTHY:
            raise AssertionError(f"supervisor {STATE_NAMES[sup.state]} at the end")
        await disp.stop()
        launches["phase"] = {nm: c - start[nm] for nm, c in snapshot().items()}
        log(f"  launches in the phase: {launches['phase']}; no op off the card "
            f"(dispatcher totals {disp.dump()['totals']})")
        if launches["phase"]["gf_matmul"] == 0:
            raise AssertionError("gf_matmul was not launched in phase 12")
        if dev.type == "cuda":
            log(f"  card: {nvidia_smi('name,power.limit')}")
        for st in stores.values():
            st.umount()

    try:
        asyncio.run(asyncio.wait_for(main(), STORE_PHASE_LIMIT_S))
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return launches["phase"]



CLUSTER_OSDS = 14  # cauchy_good's k+m
CLUSTER_OBJECT_SIZE = OSD_OBJECT_SIZE
CLUSTER_A_OBJECTS = 64
CLUSTER_B_OBJECTS = 16
CLUSTER_LATE_OBJECTS = 16  # pool A writes while three OSDs are down
CLUSTER_INFLIGHT = 16
CLUSTER_PG_NUM = {"a": 8, "b": 4}
# the pools' profiles, each naming its plugin, and their stripe units
# (pool A at Ceph's default 4096; pool B at its 32 KiB chunk)
CLUSTER_POOLS = {
    "a": ({"plugin": "isa", "k": "8", "m": "3"}, 4096),
    "b": ({"plugin": "jerasure", "technique": "cauchy_good", "k": "10", "m": "4",
           "packetsize": "4096"}, 32768),
}
CLUSTER_OP_TIMEOUT_S = 120.0
# recovery reservations per OSD (Config's default is 1, Ceph's too): every
# primary reserves a slot on each of its 11 or 14 members, so with one slot
# the primaries of the PGs to backfill queue behind each other until
# osd_recovery_reserve_timeout (30 s) and retry; an operator raises it to
# backfill PGs in parallel
CLUSTER_MAX_BACKFILLS = 16
CLUSTER_RECOVERY_LIMIT_S = 300.0
CLUSTER_PHASE_LIMIT_S = 900.0


async def create_ec_pools(cl, pools: dict, pg_num: dict) -> dict:
    """Each pool's profile (naming its plugin) and the pool, as phase 13
    makes them; pool ``a`` takes writes with m shards lost (``min_size``
    k).  Returns the pools as the client's map has them."""
    out = {}
    for name, (profile, stripe_unit) in pools.items():
        code, status, _ = await cl.command({
            "prefix": "osd erasure-code-profile set", "name": f"prof_{name}",
            "profile": dict(profile)})
        if code != 0:
            raise AssertionError(f"profile {name}: {status}")
        await cl.create_pool(name, "erasure", erasure_code_profile=f"prof_{name}",
                             pg_num=pg_num[name], stripe_unit=stripe_unit)
        out[name] = cl.osdmap.lookup_pool(name)
    if "a" in pools:
        code, status, _ = await cl.command({"prefix": "osd pool set", "pool": "a",
                                            "var": "min_size", "val": pools["a"][0]["k"]})
        if code != 0:
            raise AssertionError(f"min_size: {status}")
    return out


def served_off_card(what: str, totals: dict, ec: dict, card: bool = True) -> int:
    """No op left the card's lane: no failover, replay, host fallback or
    deadline in a dispatcher's ``totals`` or an OSD's ``ec`` counters,
    and with ``card`` no op on the host's native lane either (a CPU
    codec's own lane).  Returns the device lane's batches."""
    keys = ("failovers", "replayed_ops", "fallback_direct", "deadline_timeouts")
    ec_keys = ("engine_failovers", "replayed_ops", "launch_deadline_timeouts")
    if card:
        keys += ("native_direct",)
        ec_keys += ("dispatch_native_direct",)
    bad = {key: totals[key] for key in keys if totals[key]}
    bad.update({key: ec[key] for key in ec_keys if ec.get(key)})
    if bad:
        raise AssertionError(f"{what}: {bad}: an op was served off the card")
    return totals["lanes"]["device"]["batches"]


def osd_off_card(osd, what: str) -> int:
    """``served_off_card`` for an OSD of this process."""
    return served_off_card(f"{osd.name} in {what}", osd.ec_dispatch.dump()["totals"],
                           osd.perf.dump()["ec"])


def cluster_oid(pool: str, i: int) -> str:
    return f"rbd_data.{pool}13.{i:016x}"


def run_osd_cluster(dev, rng, root: str | None = None, figures: dict | None = None) -> dict:
    """Phase 13 (see the module docstring).  ``root`` holds the mon's and
    the OSDs' stores (a temporary directory when None); ``figures``, when
    given, gets each step's GB/s (phase 17 prints them beside its own).
    Returns the kernels' launch counts over the phase, counted from one
    reset."""
    import asyncio
    import shutil
    import tempfile

    import torch

    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_util import StripeHashes
    from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE
    from ceph_tpu_torch.rados import MiniCluster
    from ceph_tpu_torch.store import CollectionId, ObjectId

    size = CLUSTER_OBJECT_SIZE
    objs = {
        "a": [rng.integers(0, 256, size=size, dtype=np.uint8)
              for _ in range(CLUSTER_A_OBJECTS + CLUSTER_LATE_OBJECTS)],
        "b": [rng.integers(0, 256, size=size, dtype=np.uint8)
              for _ in range(CLUSTER_B_OBJECTS)],
    }
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_") if root is None else None
    root = root or tmp
    launches = {}
    figures = {} if figures is None else figures

    def snapshot():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return gf_cuda.launch_counts()

    async def main():
        cluster = MiniCluster(n_osds=CLUSTER_OSDS, store_kind="blue", store_dir=root,
                              config_overrides={"osd_max_backfills": CLUSTER_MAX_BACKFILLS},
                              device=dev)
        t0 = time.perf_counter()
        await cluster.start()
        log(f"  cluster: a mon and {CLUSTER_OSDS} OSDs on BlueStore (sync=flush) up in "
            f"{time.perf_counter() - t0:.2f} s")
        device_batches = 0
        try:
            cl = await cluster.client(op_timeout=CLUSTER_OP_TIMEOUT_S)
            # pool A takes writes with three shards lost (min_size = k)
            pools = await create_ec_pools(cl, CLUSTER_POOLS, CLUSTER_PG_NUM)
            log(f"  pools: a (isa k=8 m=3, {CLUSTER_PG_NUM['a']} PGs, min_size 8) and b "
                f"(cauchy_good k=10 m=4, {CLUSTER_PG_NUM['b']} PGs) after "
                f"{time.perf_counter() - t0:.2f} s")
            # the host's scalar CRUSH walk, which every op runs twice (the
            # client's and the primary's placement) and every OSD once a PG
            # a map epoch: one pg_to_up_acting_osds a PG of each pool
            m = cluster.mon.osdmap
            walk_ms = {}
            for name, pool in pools.items():
                pgs = m.pgs_of_pool(pool.id)
                t1 = time.perf_counter()
                for pg in pgs:
                    m.pg_to_up_acting_osds(pg)
                walk_ms[name] = (time.perf_counter() - t1) / len(pgs) * 1e3
            log(f"  the scalar CRUSH walk on the host: {walk_ms['a']:.3f} ms a pool-A placement "
                f"(11 of {CLUSTER_OSDS} OSDs), {walk_ms['b']:.3f} ms a pool-B one "
                f"({CLUSTER_OSDS} of {CLUSTER_OSDS}), the mean of one pg_to_up_acting_osds "
                f"a PG")
            ios = {name: cl.io_ctx(name) for name in pools}
            gate = asyncio.Semaphore(CLUSTER_INFLIGHT)
            names = [("a", i) for i in range(CLUSTER_A_OBJECTS)] + [
                ("b", i) for i in range(CLUSTER_B_OBJECTS)]
            nbytes = len(names) * size

            async def write(pool, i):
                async with gate:
                    await ios[pool].write_full(cluster_oid(pool, i), objs[pool][i].tobytes())

            async def read(pool, i):
                async with gate:
                    got = await ios[pool].read(cluster_oid(pool, i))
                if got != objs[pool][i].tobytes():
                    raise AssertionError(f"{cluster_oid(pool, i)}: the read differs")

            async def read_all(what, items):
                since = snapshot()
                t0 = time.perf_counter()
                await asyncio.gather(*(read(p, i) for p, i in items))
                wall = time.perf_counter() - t0
                launches[what] = {nm: c - since[nm] for nm, c in snapshot().items()}
                figures[what] = f"{len(items) * size / wall / 1e9:.3f} GB/s"
                log(f"  {what}: {len(items)} x {size / 2**20:g} MiB, every read == written: "
                    f"{figures[what]} ({wall * 1e3:.1f} ms, host clock); launches "
                    f"{launches[what]}")

            gf_cuda.reset_launches()
            start = snapshot()

            # 1. the writes
            t0 = time.perf_counter()
            await asyncio.gather(*(write(p, i) for p, i in names))
            wall = time.perf_counter() - t0
            launches["write"] = {nm: c - start[nm] for nm, c in snapshot().items()}
            figures["write"] = f"{nbytes / wall / 1e9:.3f} GB/s"
            log(f"  write: {CLUSTER_A_OBJECTS} x {size / 2**20:g} MiB to pool A (isa k=8 m=3, "
                f"stripe unit 4096) and {CLUSTER_B_OBJECTS} to pool B (cauchy_good k=10 m=4, "
                f"packetsize 4096, chunk 32768) through RadosClient, {CLUSTER_INFLIGHT} in "
                f"flight, {CLUSTER_OSDS} OSDs on BlueStore: {nbytes / wall / 1e9:.3f} GB/s "
                f"({wall * 1e3:.1f} ms, host clock); launches {launches['write']}")

            # 2. healthy, degraded and three-down reads
            await read_all("healthy read", names)
            pg0, acting0, primary0 = cl.osdmap.object_to_acting(cluster_oid("a", 0),
                                                                pools["a"].id)
            victims = [o for o in acting0 if o != primary0][:3]
            for n_down, group in ((1, victims[:1]), (3, victims[1:])):
                t0 = time.perf_counter()
                for v in group:
                    device_batches += osd_off_card(cluster.osds[v], "the run before its kill")
                    await cluster.kill_osd(v)
                    await cluster.wait_for_osd_down(v)
                log(f"  killed {['osd.%d' % v for v in group]}, marked down in "
                    f"{time.perf_counter() - t0:.2f} s")
                what = ("degraded read, 1 OSD down" if n_down == 1
                        else "three-down read, 3 OSDs down")
                await read_all(what, names)
            log(f"  down: osd.{victims[0]}, then osd.{victims[1]} and osd.{victims[2]} "
                f"(pg {pg0} of pool A loses three shards; every pool B PG loses three)")

            # 3. writes while three are down, then the rejoin and the backfill
            late = [("a", i) for i in range(CLUSTER_A_OBJECTS,
                                            CLUSTER_A_OBJECTS + CLUSTER_LATE_OBJECTS)]
            since = snapshot()
            t0 = time.perf_counter()
            await asyncio.gather(*(write(p, i) for p, i in late))
            wall = time.perf_counter() - t0
            launches["degraded write"] = {nm: c - since[nm] for nm, c in snapshot().items()}
            log(f"  degraded write: {len(late)} x {size / 2**20:g} MiB to pool A with "
                f"3 OSDs down: {len(late) * size / wall / 1e9:.3f} GB/s "
                f"({wall * 1e3:.1f} ms, host clock); launches {launches['degraded write']}")
            since = snapshot()
            pushes0 = sum(o.perf.get("recovery").get("pushes") for o in cluster.osds.values())
            t0 = time.perf_counter()
            for v in victims:
                await cluster.restart_osd(v)
            for v in victims:
                await cluster.wait_for_osd_up(v)
            every = names + late

            def version(osd, pg, shard, oid):
                cid, soid = CollectionId(f"{pg}s{shard}"), ObjectId(oid, shard)
                try:
                    return json.loads(cluster.stores[osd].getattr(cid, soid, OI_KEY))["version"]
                except KeyError:
                    return None

            placed = {}  # the scalar CRUSH walk is costly: once per map epoch

            def stale():
                m = cluster.mon.osdmap
                if placed.get("epoch") != m.epoch:
                    placed.clear()
                    placed["epoch"] = m.epoch
                    for p, i in every:
                        oid = cluster_oid(p, i)
                        placed[oid] = m.object_to_acting(oid, pools[p].id)
                out = []
                for p, i in every:
                    oid = cluster_oid(p, i)
                    pg, acting, primary = placed[oid]
                    want = version(primary, pg, acting.index(primary), oid)
                    out += [(oid, s) for s, o in enumerate(acting) if o != CRUSH_ITEM_NONE
                            and (want is None or version(o, pg, s, oid) != want)]
                return out

            try:
                async with asyncio.timeout(CLUSTER_RECOVERY_LIMIT_S):
                    while left := stale():
                        await asyncio.sleep(0.1)
            except TimeoutError:
                raise AssertionError(
                    f"recovery left {len(left)} shard chunks stale after "
                    f"{CLUSTER_RECOVERY_LIMIT_S:g} s, e.g. {left[:6]}; recovery counters "
                    f"{ {o.name: o.perf.get('recovery').dump() for o in cluster.osds.values()} }"
                ) from None
            recovery_s = time.perf_counter() - t0
            launches["recovery"] = {nm: c - since[nm] for nm, c in snapshot().items()}
            pushes = sum(o.perf.get("recovery").get("pushes")
                         for o in cluster.osds.values()) - pushes0
            if not pushes:
                raise AssertionError(f"no recovery push after the rejoin ({left})")
            log(f"  recovery: osd.{victims[0]}, osd.{victims[1]} and osd.{victims[2]} "
                f"restarted; every stale or missing shard chunk at its primary's version "
                f"after {recovery_s:.3f} s (host clock), {pushes} pushes; launches "
                f"{launches['recovery']}")
            await read_all("read after recovery", every)

            # 4. every stored chunk against the host engine's encode
            t0 = time.perf_counter()
            osd0 = next(iter(cluster.osds.values()))
            for p in pools:
                codec, sinfo = osd0._pool_codec(pools[p])
                if dev.type == "cuda" and codec.device != dev:
                    raise AssertionError(f"pool {p}'s codec on {codec.device}, expected {dev}")
                for q, i in every:
                    if q != p:
                        continue
                    oid = cluster_oid(p, i)
                    want = ec_util.encode_fallback(
                        sinfo, codec, sinfo.pad_to_stripe(objs[p][i].tobytes()))
                    pg, acting, _primary = cluster.mon.osdmap.object_to_acting(oid, pools[p].id)
                    for s, o in enumerate(acting):
                        if o == CRUSH_ITEM_NONE:
                            continue  # a slot CRUSH left empty holds no chunk
                        cid, soid = CollectionId(f"{pg}s{s}"), ObjectId(oid, s)
                        chunk = np.frombuffer(cluster.stores[o].read(cid, soid), dtype=np.uint8)
                        if not np.array_equal(chunk, want[s]):
                            raise AssertionError(f"{oid} shard {s} on osd.{o} differs from "
                                                 "the host engine's encode")
                        hashes = StripeHashes.from_dict(json.loads(
                            cluster.stores[o].getattr(cid, soid, StripeHashes.XATTR_KEY)))
                        if not hashes.verify(s, 0, chunk):
                            raise AssertionError(f"{oid} shard {s}: StripeHashes.verify fails")
            log(f"  stores: every shard chunk of the {len(every)} objects on every OSD == "
                f"the host engine's encode, every crc table verifies "
                f"({time.perf_counter() - t0:.2f} s)")

            # 5. nothing off the card
            for osd in cluster.osds.values():
                device_batches += osd_off_card(osd, "phase 13")
            launches["phase"] = {nm: c - start[nm] for nm, c in snapshot().items()}
            log(f"  launches in the phase: {launches['phase']}; {device_batches} device-lane "
                f"launches over the OSDs' dispatchers, no op off the card")
            for name in gf_cuda.EC_KERNELS:
                if launches["phase"][name] == 0:
                    raise AssertionError(f"{name} was not launched in phase 13")
            if launches["three-down read, 3 OSDs down"]["gf_matmul"] == 0:
                raise AssertionError("no gf_matmul decode in the three-down read")
            if launches["recovery"]["gf_matmul"] == 0:
                raise AssertionError("no gf_matmul in the recovery")
            if dev.type == "cuda":
                log(f"  card: {nvidia_smi('name,power.limit')}")
        finally:
            # the mon first: OSDs stopped under a live mon would each make
            # a map epoch, and every epoch costs each survivor a walk of
            # its PGs' placements
            t0 = time.perf_counter()
            for rank in list(cluster.mons):
                await cluster.kill_mon(rank)
            await cluster.stop()
            log(f"  cluster stopped in {time.perf_counter() - t0:.2f} s")

    try:
        asyncio.run(asyncio.wait_for(main(), CLUSTER_PHASE_LIMIT_S))
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return launches["phase"]


SCRUB_OBJECTS = 32
SCRUB_OBJECT_SIZE = CLUSTER_OBJECT_SIZE
SCRUB_CHUNK = CLUSTER_POOLS["a"][1]
# pool A object: (the shards rotted behind the OSDs' backs, the kind scrub
# must name).  Object 3 loses three shards: phase 6's three-erasure
# gf_matmul decode; a single lost data shard takes the XOR program (§4 of
# PERF.md), a lost parity shard gf_matmul
SCRUB_FAULTS = {
    0: ((1,), "crc"),
    1: ((9,), "size"),
    2: ((5,), "attr"),
    3: ((1, 5, 9), "crc"),
    4: ((0,), "crc"),
}
SCRUB_BACKGROUND_OBJECT = 5
SCRUB_BACKGROUND_SHARD = 10  # a parity shard: its repair is a gf_matmul
SCRUB_BACKGROUND_INTERVAL_S = 0.5
SCRUB_BACKGROUND_LIMIT_S = 120.0
TIER_OBJECTS = 16
TIER_CACHE_SIZE = 3
TIER_CACHE_PG_NUM = 4  # pool B's
TIER_HIT_SET_PERIOD_S = 0.2
TIER_HIT_SET_COUNT = 2
TIER_TARGET_MAX_OBJECTS = 4  # below TIER_OBJECTS: the agent evicts
TIER_LIMIT_S = 300.0
# (class, method, input, the reference's answer): the answers are those of
# the reference package's OSD to the same calls in this order on one object
# (tests/test_torch_cls.py holds them against it)
CLS_CALLS = (
    ("lock", "lock", {"name": "L", "entity": "client.a", "cookie": "c1"}, {}),
    ("lock", "get_info", {"name": "L"},
     {"type": 1, "tag": "", "lockers": [{"entity": "client.a", "cookie": "c1",
                                        "description": "", "expires": 0}]}),
    ("lock", "unlock", {"name": "L", "entity": "client.a", "cookie": "c1"}, {}),
    ("lock", "list_locks", {}, {"names": []}),
    ("refcount", "get", {"tag": "t1"}, {"count": 1}),
    ("refcount", "get", {"tag": "t2"}, {"count": 2}),
    ("refcount", "put", {"tag": "t1"}, {"count": 1, "last": False}),
    ("refcount", "read", {}, {"refs": ["t2"]}),
    ("version", "set", {"ver": 5, "tag": "t1"}, {"objv": {"ver": 5, "tag": "t1"}}),
    ("version", "inc", {}, {"objv": {"ver": 6, "tag": "t1"}}),
    ("version", "read", {}, {"objv": {"ver": 6, "tag": "t1"}}),
    ("numops", "add", {"key": "n", "value": 5}, {"value": "5"}),
    ("numops", "add", {"key": "n", "value": -2}, {"value": "3"}),
)
EOPNOTSUPP = 95
SCRUB_TIER_PHASE_LIMIT_S = 900.0


def scrub_tier_oid(pool: str, i: int) -> str:
    return f"rbd_data.{pool}14.{i:016x}"


def run_osd_scrub_tier(dev, rng, root: str | None = None) -> dict:
    """Phase 14 (see the module docstring).  ``root`` holds the mon's and
    the OSDs' stores (a temporary directory when None).  Returns the
    kernels' launch counts over the phase, counted from one reset."""
    import asyncio
    import shutil
    import tempfile

    import torch

    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_util import StripeHashes
    from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE
    from ceph_tpu_torch.osd.tiering import DIRTY_KEY
    from ceph_tpu_torch.rados import MiniCluster, RadosError
    from ceph_tpu_torch.store import CollectionId, ObjectId, Transaction

    size = SCRUB_OBJECT_SIZE
    objs = {
        "a": [rng.integers(0, 256, size=size, dtype=np.uint8) for _ in range(SCRUB_OBJECTS)],
        "b": [rng.integers(0, 256, size=size, dtype=np.uint8) for _ in range(TIER_OBJECTS)],
    }
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scrub_tier_") if root is None else None
    root = root or tmp
    launches = {}

    def snapshot():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return gf_cuda.launch_counts()

    def since(what, before):
        launches[what] = {nm: c - before[nm] for nm, c in snapshot().items()}
        return launches[what]

    async def wait_for(what, pred, limit):
        try:
            async with asyncio.timeout(limit):
                while not pred():
                    await asyncio.sleep(0.1)
        except TimeoutError:
            raise AssertionError(f"{what}: not within {limit:g} s") from None

    async def main():
        cluster = MiniCluster(n_osds=CLUSTER_OSDS, store_kind="blue", store_dir=root,
                              config_overrides={"osd_max_backfills": CLUSTER_MAX_BACKFILLS},
                              device=dev)
        t0 = time.perf_counter()
        await cluster.start()
        log(f"  cluster: a mon and {CLUSTER_OSDS} OSDs on BlueStore (sync=flush) up in "
            f"{time.perf_counter() - t0:.2f} s")
        device_batches = 0
        try:
            cl = await cluster.client(op_timeout=CLUSTER_OP_TIMEOUT_S)
            pools = {}
            for name, (profile, stripe_unit) in CLUSTER_POOLS.items():
                code, status, _ = await cl.command({
                    "prefix": "osd erasure-code-profile set", "name": f"prof_{name}",
                    "profile": dict(profile)})
                if code != 0:
                    raise AssertionError(f"profile {name}: {status}")
                await cl.create_pool(name, "erasure", erasure_code_profile=f"prof_{name}",
                                     pg_num=CLUSTER_PG_NUM[name], stripe_unit=stripe_unit)
                pools[name] = cl.osdmap.lookup_pool(name)
            for name, pg_num in (("cache", TIER_CACHE_PG_NUM), ("cls", 1)):
                await cl.create_pool(name, "replicated", size=TIER_CACHE_SIZE, pg_num=pg_num)
                pools[name] = cl.osdmap.lookup_pool(name)
            ios = {name: cl.io_ctx(name) for name in pools}
            gate = asyncio.Semaphore(CLUSTER_INFLIGHT)
            codecs = {p: next(iter(cluster.osds.values()))._pool_codec(pools[p]) for p in "ab"}
            for p, (codec, _sinfo) in codecs.items():
                if dev.type == "cuda" and codec.device != dev:
                    raise AssertionError(f"pool {p}'s codec on {codec.device}, expected {dev}")

            async def write(pool, i):
                async with gate:
                    await ios[pool].write_full(scrub_tier_oid(pool, i), objs[pool][i].tobytes())

            async def read(pool, i):
                async with gate:
                    got = await ios[pool].read(scrub_tier_oid(pool, i))
                if got != objs[pool][i].tobytes():
                    raise AssertionError(f"{scrub_tier_oid(pool, i)}: the read differs")

            def placed(pool, i):
                m = cluster.mon.osdmap
                return m.object_to_acting(scrub_tier_oid(pool, i), pools[pool].id)

            def shard(pool, i, s):
                """(store, cid, oid) of shard s of object i; None for a slot
                CRUSH left empty, which holds no chunk."""
                pg, acting, _primary = placed(pool, i)
                if acting[s] == CRUSH_ITEM_NONE:
                    return None
                oid = scrub_tier_oid(pool, i)
                return cluster.stores[acting[s]], CollectionId(f"{pg}s{s}"), ObjectId(oid, s)

            def check_shards(pool, i, what):
                """Every shard of object i == the host engine's encode of what
                was written, under a crc table that verifies and that every
                shard of the object shares."""
                codec, sinfo = codecs[pool]
                want = ec_util.encode_fallback(
                    sinfo, codec, sinfo.pad_to_stripe(objs[pool][i].tobytes()))
                tables = set()
                for s in range(codec.get_chunk_count()):
                    if shard(pool, i, s) is None:
                        continue
                    store, cid, soid = shard(pool, i, s)
                    chunk = np.frombuffer(store.read(cid, soid), dtype=np.uint8)
                    if not np.array_equal(chunk, want[s]):
                        raise AssertionError(f"{what}: {soid.name} shard {s} differs from the "
                                             "host engine's encode")
                    raw = store.getattr(cid, soid, StripeHashes.XATTR_KEY)
                    if not StripeHashes.from_dict(json.loads(raw)).verify(s, 0, chunk):
                        raise AssertionError(f"{what}: {soid.name} shard {s}: its crc table "
                                             "does not verify")
                    tables.add(bytes(raw))
                if len(tables) != 1:
                    raise AssertionError(f"{what}: {scrub_tier_oid(pool, i)}: the shards' crc "
                                         "tables differ")

            gf_cuda.reset_launches()
            start = snapshot()

            # 1. pool A's writes
            t0 = time.perf_counter()
            await asyncio.gather(*(write("a", i) for i in range(SCRUB_OBJECTS)))
            wall = time.perf_counter() - t0
            log(f"  write: {SCRUB_OBJECTS} x {size / 2**20:g} MiB to pool A (isa k=8 m=3, "
                f"stripe unit {SCRUB_CHUNK}, {CLUSTER_PG_NUM['a']} PGs): "
                f"{SCRUB_OBJECTS * size / wall / 1e9:.3f} GB/s ({wall * 1e3:.1f} ms, host clock); "
                f"launches {since('write', start)}")

            # 2. rot shards behind the OSDs' backs
            expected = set()
            for i, (shards, kind) in SCRUB_FAULTS.items():
                for s in shards:
                    store, cid, soid = shard("a", i, s)
                    if kind == "crc":
                        head = bytes(store.read(cid, soid, 0, 8))
                        store.apply(Transaction().write(cid, soid, 0,
                                                        bytes(b ^ 0xFF for b in head)))
                    elif kind == "size":
                        store.apply(Transaction().truncate(
                            cid, soid, store.stat(cid, soid) - SCRUB_CHUNK))
                    else:
                        store.apply(Transaction().setattr(cid, soid, StripeHashes.XATTR_KEY,
                                                          b"{not json"))
                    expected.add((soid.name, s, kind))
            log(f"  rotted {len(expected)} shards: " + "; ".join(
                f"object {i} shard{'s' * (len(sh) > 1)} {', '.join(map(str, sh))} ({kind})"
                for i, (sh, kind) in SCRUB_FAULTS.items()))

            # 3. scrub with repair, each repair decode timed
            decode_ms = []
            plain_decode = ec_util.decode

            def timed_decode(*a, **kw):
                t1 = time.perf_counter()
                out = plain_decode(*a, **kw)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                decode_ms.append((time.perf_counter() - t1) * 1e3)
                return out

            before = snapshot()
            ec_util.decode = timed_decode
            try:
                t0 = time.perf_counter()
                reports = await cl.scrub_pool("a")
                scrub_s = time.perf_counter() - t0
            finally:
                ec_util.decode = plain_decode
            since("scrub", before)
            found = {(e["oid"], e["shard"], e["kind"]) for r in reports for e in r["errors"]}
            repaired = sum(r["repaired"] for r in reports)
            if found != expected:
                raise AssertionError(f"scrub found {sorted(found)}, expected {sorted(expected)}")
            if repaired != len(expected):
                raise AssertionError(f"scrub repaired {repaired} of {len(expected)} bad shards")
            if sum(r["objects"] for r in reports) != SCRUB_OBJECTS:
                raise AssertionError(f"scrub saw {sum(r['objects'] for r in reports)} objects")
            if launches["scrub"]["gf_matmul"] == 0:
                raise AssertionError("no gf_matmul launch in the scrub's repair decodes")
            log(f"  scrub with repair of pool A's {CLUSTER_PG_NUM['a']} PGs: "
                f"{SCRUB_OBJECTS * size / scrub_s / 1e9:.3f} GB/s of objects scrubbed "
                f"({scrub_s * 1e3:.1f} ms, host clock); every fault named with its kind, "
                f"{repaired} of {len(expected)} bad shards repaired; {len(decode_ms)} repair "
                f"decodes, ms {[round(ms, 3) for ms in decode_ms]} (host clock, "
                f"ec_util.decode on the card and the copy back); launches {launches['scrub']}")
            for i in SCRUB_FAULTS:
                check_shards("a", i, "repair")
            t0 = time.perf_counter()
            again = await cl.scrub_pool("a")
            if any(r["errors"] for r in again) or sum(r["repaired"] for r in again):
                raise AssertionError(f"a second scrub found {[r for r in again if r['errors']]}")
            log(f"  every repaired shard == the host engine's encode, its crc table verifies "
                f"and equals its object's other shards'; a second scrub clean "
                f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
            await asyncio.gather(*(read("a", i) for i in range(SCRUB_OBJECTS)))
            log(f"  all {SCRUB_OBJECTS} reads == written")

            # 4. the background scrub on one PG's primary
            i, s = SCRUB_BACKGROUND_OBJECT, SCRUB_BACKGROUND_SHARD
            pg, _acting, primary = placed("a", i)
            osd = cluster.osds[primary]
            store, cid, soid = shard("a", i, s)
            head = bytes(store.read(cid, soid, 0, 8))
            store.apply(Transaction().write(cid, soid, 0, bytes(b ^ 0xFF for b in head)))
            repaired0 = osd.perf.get("scrub").get("repaired")
            before = snapshot()
            t0 = time.perf_counter()
            osd.config.set("osd_scrub_interval", SCRUB_BACKGROUND_INTERVAL_S)
            try:
                await wait_for(f"{osd.name}'s background scrub repairing object {i} shard {s}",
                               lambda: osd.perf.get("scrub").get("repaired") > repaired0,
                               SCRUB_BACKGROUND_LIMIT_S)
            finally:
                osd.config.set("osd_scrub_interval", 0.0)
            log(f"  background scrub: osd_scrub_interval {SCRUB_BACKGROUND_INTERVAL_S} on "
                f"{osd.name} (primary of pg {pg}); object {i} shard {s} rotted and repaired "
                f"{time.perf_counter() - t0:.2f} s later; launches "
                f"{since('background scrub', before)}")
            check_shards("a", i, "background repair")
            await read("a", i)

            # 5. a writeback cache tier over pool B
            for cmd in (
                {"prefix": "osd tier add", "pool": "b", "tierpool": "cache"},
                {"prefix": "osd tier cache-mode", "pool": "cache", "mode": "writeback",
                 "hit_set_period": TIER_HIT_SET_PERIOD_S,
                 "hit_set_count": TIER_HIT_SET_COUNT, "cache_min_flush_age": 0},
                {"prefix": "osd tier set-overlay", "pool": "b", "tierpool": "cache"},
                {"prefix": "osd pool set", "pool": "cache", "var": "target_max_objects",
                 "val": str(TIER_TARGET_MAX_OBJECTS)},
            ):
                code, status, _ = await cl.command(cmd)
                if code != 0:
                    raise AssertionError(f"{cmd['prefix']}: {status}")

            def tiered(m):
                c = m.lookup_pool("cache") if m is not None else None
                return (c is not None and c.cache_mode == "writeback"
                        and c.target_max_objects == TIER_TARGET_MAX_OBJECTS
                        and m.lookup_pool("b").read_tier == c.id)

            await wait_for("the tier in every map", lambda: tiered(cl.osdmap) and all(
                tiered(o.osdmap) for o in cluster.osds.values()), 30.0)
            # the agents wait while the writes land, so that each can be
            # seen dirty in the cache before its flush
            for o in cluster.osds.values():
                o.tiering.stop()

            def cached(i):
                """(store, cid, oid) of the cache's primary copy of object i."""
                oid = scrub_tier_oid("b", i)
                pg, _acting, primary = cluster.mon.osdmap.object_to_acting(
                    oid, pools["cache"].id)
                return cluster.stores[primary], CollectionId(str(pg)), ObjectId(oid)

            def in_base(i):
                return any(at is not None and at[0].exists(*at[1:]) for at in (
                    shard("b", i, s) for s in range(codecs["b"][0].get_chunk_count())))

            before = snapshot()
            t0 = time.perf_counter()
            await asyncio.gather(*(write("b", i) for i in range(TIER_OBJECTS)))
            wall = time.perf_counter() - t0
            for i in range(TIER_OBJECTS):
                store, cid, oid = cached(i)
                if not store.exists(cid, oid) or DIRTY_KEY not in store.getattrs(cid, oid):
                    raise AssertionError(f"{oid.name}: not dirty in the cache after its write")
                if in_base(i):
                    raise AssertionError(f"{oid.name}: in pool B before its flush")
            log(f"  tier: pool cache (replicated, size {TIER_CACHE_SIZE}) over pool B "
                f"(cauchy_good k=10 m=4), writeback, overlay, hit sets {TIER_HIT_SET_COUNT} x "
                f"{TIER_HIT_SET_PERIOD_S} s, target_max_objects {TIER_TARGET_MAX_OBJECTS}; "
                f"{TIER_OBJECTS} x {size / 2**20:g} MiB written through pool B's name: "
                f"{TIER_OBJECTS * size / wall / 1e9:.3f} GB/s ({wall * 1e3:.1f} ms, host "
                f"clock), every one dirty in the cache and absent from pool B; launches "
                f"{since('tier write', before)}")

            def stat(key):
                return sum(o.tiering.stats[key] for o in cluster.osds.values())

            def dirty(i):
                store, cid, oid = cached(i)
                try:
                    return DIRTY_KEY in store.getattrs(cid, oid)
                except KeyError:
                    return False  # evicted: flushed first

            flushes0, evictions0 = stat("flushes"), stat("evictions")
            before = snapshot()
            t0 = time.perf_counter()
            for o in cluster.osds.values():
                o.tiering.start()
            await wait_for("the agents' flushes", lambda: stat("flushes") - flushes0
                           >= TIER_OBJECTS and not any(map(dirty, range(TIER_OBJECTS))),
                           TIER_LIMIT_S)
            flush_s = time.perf_counter() - t0
            since("flush", before)
            if launches["flush"]["bitmatrix_xor"] == 0:
                raise AssertionError("no bitmatrix_xor launch in the flushes")
            for i in range(TIER_OBJECTS):
                check_shards("b", i, "flush")
            log(f"  flush: the agents wrote back all {TIER_OBJECTS} in {flush_s:.3f} s "
                f"({TIER_OBJECTS * size / flush_s / 1e9:.3f} GB/s, host clock, from the agents' "
                f"start, their 1 s tick included); every pool B shard == the host engine's "
                f"encode; launches {launches['flush']}")

            def resident(i):
                pg, acting, _primary = cluster.mon.osdmap.object_to_acting(
                    scrub_tier_oid("b", i), pools["cache"].id)
                oid = ObjectId(scrub_tier_oid("b", i))
                return any(cluster.stores[o].exists(CollectionId(str(pg)), oid)
                           for o in acting if o != CRUSH_ITEM_NONE and o in cluster.osds)

            t0 = time.perf_counter()
            await wait_for("the agents' evictions",
                           lambda: not any(map(resident, range(TIER_OBJECTS))), TIER_LIMIT_S)
            log(f"  evict: all {TIER_OBJECTS} cold and out of the cache "
                f"{time.perf_counter() - t0:.3f} s after the flush "
                f"({stat('evictions') - evictions0} evictions)")

            # 6. one pool B OSD down, every object promoted by a degraded read
            m = cluster.mon.osdmap
            k_b = codecs["b"][0].get_data_chunk_count()
            base_pgs = {}
            for i in range(TIER_OBJECTS):
                pg, acting, primary = placed("b", i)
                base_pgs[str(pg)] = (acting, primary)
            primaries = {p for _a, p in base_pgs.values()} | {
                m.pg_to_up_acting_osds(pg)[3] for pg in m.pgs_of_pool(pools["cache"].id)}
            data_slots = {o: sum(o in acting[:k_b] for acting, _p in base_pgs.values())
                          for o in cluster.osds if o not in primaries}
            if not data_slots:
                raise AssertionError("every OSD is a primary of pool B or the cache")
            victim = max(data_slots, key=lambda o: (data_slots[o], -o))
            degraded = sum(victim in placed("b", i)[1][:k_b] for i in range(TIER_OBJECTS))
            device_batches += osd_off_card(cluster.osds[victim], "the run before its kill")
            await cluster.kill_osd(victim)
            await cluster.wait_for_osd_down(victim)
            promotes0 = stat("promotes")
            before = snapshot()
            t0 = time.perf_counter()
            await asyncio.gather(*(read("b", i) for i in range(TIER_OBJECTS)))
            wall = time.perf_counter() - t0
            since("promote", before)
            if stat("promotes") - promotes0 != TIER_OBJECTS:
                raise AssertionError(f"{stat('promotes') - promotes0} promotes for "
                                     f"{TIER_OBJECTS} reads")
            if degraded and launches["promote"]["bitmatrix_xor"] == 0:
                raise AssertionError("no bitmatrix_xor decode in the degraded promotes")
            log(f"  promote: osd.{victim} down (a data shard of {degraded} of the "
                f"{TIER_OBJECTS} objects); every read promoted from pool B and == written: "
                f"{TIER_OBJECTS * size / wall / 1e9:.3f} GB/s ({wall * 1e3:.1f} ms, host clock); "
                f"launches {launches['promote']}")

            # 7. object classes on a replicated pool, and still none on EC
            io = ios["cls"]
            await io.write_full("obj", b"x")
            for kls, method, inp, want in CLS_CALLS:
                got = await io.exec("obj", kls, method, inp)
                if got != want:
                    raise AssertionError(f"{kls}.{method}: {got}, the reference answers {want}")
            try:
                await ios["a"].exec(scrub_tier_oid("a", 0), "lock", "lock",
                                    {"name": "L", "entity": "client.a", "cookie": "c1"})
                raise AssertionError("a call on pool A was served")
            except RadosError as e:
                if e.code != -EOPNOTSUPP:
                    raise
            log(f"  object classes: {len(CLS_CALLS)} calls of lock, refcount, version and "
                f"numops on pool cls == the reference's answers; a call on pool A answers "
                f"-EOPNOTSUPP")

            # 8. nothing off the card
            for o in cluster.osds.values():
                device_batches += osd_off_card(o, "phase 14")
            launches["phase"] = {nm: c - start[nm] for nm, c in snapshot().items()}
            log(f"  launches in the phase: {launches['phase']}; {device_batches} device-lane "
                f"launches over the OSDs' dispatchers, no op off the card")
            if dev.type == "cuda":
                log(f"  card: {nvidia_smi('name,power.limit')}")
        finally:
            t0 = time.perf_counter()
            for rank in list(cluster.mons):
                await cluster.kill_mon(rank)
            await cluster.stop()
            log(f"  cluster stopped in {time.perf_counter() - t0:.2f} s")

    try:
        asyncio.run(asyncio.wait_for(main(), SCRUB_TIER_PHASE_LIMIT_S))
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return launches["phase"]


# -- phase 15: the storm, and the OSDs in their own processes -----------------------

# (a) phase 13's cluster and pools under the storm driver's load: 2 writers
# of 4 MiB objects, 8 object names each
STORM_OSDS = CLUSTER_OSDS
STORM_POOLS = CLUSTER_POOLS
STORM_PG_NUM = CLUSTER_PG_NUM
STORM_OBJECT_SIZE = CLUSTER_OBJECT_SIZE
STORM_WRITERS = 2
STORM_OBJECTS = 8
STORM_PAUSE_S = 0.01
# acked writes in each window of a scenario: before each kill, and
# issued after the victim is marked down and before its restart; and
# the longest a window may take to gather them
STORM_WINDOW_WRITES = 20
STORM_WINDOW_S = 120.0
# wait_clean's budget on a loaded host (tests/test_churn_storm.py:256)
STORM_CLEAN_TIMEOUT_S = 150.0
# (b) a mon and 14 OSD processes on BlueStore, pool A; the heartbeat of
# tests/test_multiprocess.py:46-49 (single-core interpreters miss faster
# pings), and longer waits: each OSD process starts torch and the card
PROC_OSDS = CLUSTER_OSDS
PROC_OBJECTS = 64
PROC_STORM_OBJECTS = 16
PROC_HEARTBEAT_S = 2.0
PROC_HEALTHY_S = 240.0
PROC_UP_S = 120.0
PROC_KILL_AFTER_S = 0.2
PROC_BENCH_S = 5
STORM_PHASE_LIMIT_S = 900.0
BENCH_LINE = r"^(write|seq): \d+ ops, \d+\.\d MB in \d+\.\d\ds = \d+\.\d\d MB/s, \d+\.\d ops/s$"


def card_memory() -> str:
    """The card's memory in use, all processes together (the CUDA
    driver's count, through torch; nvidia-smi lists no per-process
    figure in a container)."""
    import torch

    free, total = torch.cuda.mem_get_info()
    return f"{(total - free) / 2**30:.2f} GiB of {total / 2**30:.2f} GiB in use"


class TimedWrites:
    """An ``IoCtx`` whose ``write_full`` keeps the host-clock start of
    each write it saw acked; every other call goes through."""

    def __init__(self, io):
        self.io = io
        self.acked: list[float] = []

    async def write_full(self, name, data):
        t0 = time.perf_counter()
        await self.io.write_full(name, data)
        self.acked.append(t0)

    def __getattr__(self, name):
        return getattr(self.io, name)

    def since(self, t: float) -> int:
        """The acked writes that started at ``t`` or later."""
        return sum(1 for t0 in self.acked if t0 >= t)


def run_storm(dev, rng, root: str | None = None) -> dict:
    """Phase 15 (a) (see the module docstring).  ``root`` holds the
    stores (a temporary directory when None).  Returns the kernels'
    launch counts over the part, counted from one reset."""
    import asyncio
    import shutil
    import tempfile

    import torch

    from ceph_tpu_torch.crush.mapper_torch_hier import fused_rule
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.rados import ClientLoad, MiniCluster, StormDriver

    tmp = tempfile.mkdtemp(prefix="chip_smoke_storm_") if root is None else None
    root = root or tmp
    launches = {}

    def snapshot():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return gf_cuda.launch_counts()

    async def main():
        cluster = MiniCluster(n_osds=STORM_OSDS, store_kind="blue", store_dir=root,
                              config_overrides={"osd_max_backfills": CLUSTER_MAX_BACKFILLS},
                              device=dev)
        device_batches = [0]
        # the scenario in hand: its load's writes, when the last victim
        # came back up (or the load started), when the victim was marked
        # down, and its windows as (what, acked writes, seconds)
        now = {}
        kill, down = cluster.kill_osd, cluster.wait_for_osd_down
        restart, up = cluster.restart_osd, cluster.wait_for_osd_up

        async def window(what, since):
            io = now["io"]
            deadline = since + STORM_WINDOW_S
            while io.since(since) < STORM_WINDOW_WRITES:
                if time.perf_counter() > deadline:
                    raise AssertionError(
                        f"{io.since(since)} writes acked in {STORM_WINDOW_S:g} s {what}, "
                        f"not {STORM_WINDOW_WRITES}; failed ops {now['load'].failed[:2]}")
                await asyncio.sleep(0.05)
            now["windows"].append((what, io.since(since), time.perf_counter() - since))

        async def kill_osd(osd_id, crash=False):
            await window(f"before the kill of osd.{osd_id}", now["up"])
            # the victim's counters go with it: read them first
            device_batches[0] += osd_off_card(cluster.osds[osd_id], "the run before its kill")
            await kill(osd_id, crash=crash)

        async def wait_for_osd_down(osd_id, timeout=10.0):
            await down(osd_id, timeout)
            now["down"] = time.perf_counter()

        async def restart_osd(osd_id):
            await window(f"while osd.{osd_id} was down", now["down"])
            return await restart(osd_id)

        async def wait_for_osd_up(osd_id, timeout=10.0):
            await up(osd_id, timeout)
            now["up"] = time.perf_counter()

        cluster.kill_osd, cluster.wait_for_osd_down = kill_osd, wait_for_osd_down
        cluster.restart_osd, cluster.wait_for_osd_up = restart_osd, wait_for_osd_up
        t0 = time.perf_counter()
        await cluster.start()
        try:
            cl = await cluster.client(op_timeout=CLUSTER_OP_TIMEOUT_S)
            await create_ec_pools(cl, STORM_POOLS, STORM_PG_NUM)
            log(f"  cluster: a mon and {STORM_OSDS} OSDs on BlueStore with pools a and b up "
                f"in {time.perf_counter() - t0:.2f} s")
            gf_cuda.reset_launches()
            start = snapshot()
            for pool, scenario, kills in (("a", "single_kill", 1), ("b", "rolling", 2)):
                io = TimedWrites(cl.io_ctx(pool))
                load = ClientLoad(io, prefix=f"storm-{pool}",
                                  objects=STORM_OBJECTS, size=STORM_OBJECT_SIZE,
                                  pause=STORM_PAUSE_S, seed=SEED)
                driver = StormDriver(cluster, cl, [pool], clean_timeout=STORM_CLEAN_TIMEOUT_S)
                if driver.device != dev:
                    raise AssertionError(f"the storm plans on {driver.device}, not {dev}")
                since = snapshot()
                t0 = time.perf_counter()
                now.update(io=io, load=load, up=t0, windows=[])
                load.start(writers=STORM_WRITERS)
                result = await getattr(driver, f"scenario_{scenario}")(load)
                wall = time.perf_counter() - t0
                launches[scenario] = {nm: c - since[nm] for nm, c in snapshot().items()}
                windows = now["windows"]
                if len(windows) != 2 * kills or result["ops_acked"] < STORM_WINDOW_WRITES * len(windows):
                    raise AssertionError(
                        f"scenario_{scenario}: {result['ops_acked']} acked writes over the windows "
                        f"{windows}, not {STORM_WINDOW_WRITES} in each of {2 * kills}")
                who = (f"osd.{result['victim']}" if "victim" in result
                       else ", ".join(f"osd.{v}" for v in result["victims"]))
                ms = sorted(load.latencies)
                log(f"  scenario_{scenario} on pool {pool} ({who} killed and restarted): "
                    f"{result['ops_acked']} acked {STORM_OBJECT_SIZE / 2**20:g} MiB writes "
                    f"from {STORM_WRITERS} writers over the scenario's {wall:.2f} s (host clock); "
                    f"client latency over those {len(ms)}: p50 {ms[len(ms) // 2] * 1e3:.3f} ms, "
                    f"p99 {result['client_p99_ms']} ms, max {ms[-1] * 1e3:.3f} ms; "
                    f"{result['objects']} objects read back byte-identical, "
                    f"{result['pgs_scrubbed']} PGs scrubbed clean, no failed op; "
                    f"launches {launches[scenario]}")
                for what, n, secs in windows:
                    log(f"    {what}: {n} writes acked in {secs:.2f} s, "
                        f"{n * STORM_OBJECT_SIZE / secs / 1e9:.3f} GB/s (host clock)")
                if scenario == "single_kill":
                    churn = result["churn"]
                    if churn["predicted"] != churn["actual"] or not churn["predicted"]:
                        raise AssertionError(
                            f"the device plan {sorted(churn['predicted'])} != the live remap "
                            f"{sorted(churn['actual'])}")
                    log(f"  the plan on {driver.device}: {len(churn['predicted'])} PGs remapped "
                        f"== the live remap; {churn['plan']}")
                else:
                    log(f"  rolling: {result['kicks']} recovery kicks on the survivors, "
                        f"{result['coalesced_kicks']} coalesced")
            for osd in cluster.osds.values():
                device_batches[0] += osd_off_card(osd, "phase 15 (a)")
            launches["part"] = {nm: c - start[nm] for nm, c in snapshot().items()}
            log(f"  launches in the part: {launches['part']}; {device_batches[0]} device-lane "
                f"launches over the OSDs' dispatchers, no op off the card")
            # the plans' CRUSH kernel: crush_choose for a single-step rule,
            # the step engine's crush_straw2 otherwise
            m = cl.osdmap
            crush = set()
            for pool in m.pools.values():
                ruleno = m.crush.find_rule(pool.crush_ruleset, pool.type, pool.size)
                single = fused_rule(m.crush, ruleno, pool.size) is not None
                crush.add("crush_choose" if single else "crush_straw2")
            for name in (*gf_cuda.EC_KERNELS, *sorted(crush)):
                if launches["part"][name] == 0:
                    raise AssertionError(f"{name} was not launched in phase 15 (a)")
        finally:
            # the cluster's own stop kills its OSDs with no window
            cluster.kill_osd, cluster.wait_for_osd_down = kill, down
            cluster.restart_osd, cluster.wait_for_osd_up = restart, up
            t0 = time.perf_counter()
            for rank in list(cluster.mons):
                await cluster.kill_mon(rank)
            await cluster.stop()
            log(f"  cluster stopped in {time.perf_counter() - t0:.2f} s")

    try:
        asyncio.run(asyncio.wait_for(main(), STORM_PHASE_LIMIT_S))
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return launches["part"]


def log_daemon_trouble(pc) -> None:
    """On a failure of phase 15 (b): the tail of the log of each daemon
    process that has exited or logged an error or a markdown."""
    marks = ("Traceback", "ERROR", "suicide", "marked down", "wrongly", "-> reporting")
    for path in sorted(Path(pc.log_dir).glob("*.log")):
        name = path.stem
        role, _, n = name.partition(".")
        procs = pc.osd_procs if role == "osd" else pc.mon_procs
        proc = procs.get(int(n)) if n.isdigit() else None
        text = path.read_text(errors="replace")
        if proc is None or proc.poll() is not None or any(m in text for m in marks):
            state = ("gone" if proc is None else "running" if proc.poll() is None
                     else f"exited {proc.poll()}")
            log(f"  --- {name} ({state}), the end of its log:\n{text[-3000:]}")


def check_osd_window(result: dict) -> dict:
    """A trace window of one OSD process, over its admin socket: whole
    (every launch that process counted in it captured, no tap interval
    without a device event) and with ``gf_matmul`` in it.  Returns the
    captured launches."""
    if "error" in result or "unavailable" in result:
        raise AssertionError(f"the trace window failed: {result}")
    capture = result["capture"]
    kernels = capture["kernels"]
    if capture["short"] or capture["intervals_without_device_events"] or any(
            k["captured"] != k["launched"] for k in kernels.values()):
        raise AssertionError(f"the trace window's capture is short: {capture}")
    if kernels["gf_matmul"]["launched"] == 0:
        raise AssertionError(f"no gf_matmul in the traced OSD's window: {capture}")
    return {name: k["captured"] for name, k in kernels.items()}


def run_proc_cluster(dev, rng, root: str | None = None) -> dict:
    """Phase 15 (b) (see the module docstring).  ``root`` holds the
    stores, the daemons' logs and their admin sockets (a temporary
    directory when None).  On the CPU the OSD processes run ``--device
    cpu`` and the checks that need the card are left out.  Returns the
    traced OSD's captured launches (zeros on the CPU)."""
    import asyncio
    import contextlib
    import io
    import os
    import re
    import shutil
    import tempfile
    from collections import Counter

    import torch

    from ceph_tpu_torch.common import admin_command
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.rados import ProcCluster, StormDriver
    from ceph_tpu_torch.tools import ceph_cli, rados_cli

    card = dev.type == "cuda"
    size = STORM_OBJECT_SIZE
    objs = [rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            for _ in range(PROC_OBJECTS)]
    storm = [rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
             for _ in range(PROC_STORM_OBJECTS)]
    names = [f"rbd_data.a15.{i:016x}" for i in range(PROC_OBJECTS)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_proc_") if root is None else None
    root = root or tmp
    sockdir = os.path.join(root, "asok")
    os.makedirs(sockdir, exist_ok=True)
    captured = {name: 0 for name in gf_cuda.SOURCES}

    async def asok(name, prefix, **kw):
        return await asyncio.wait_for(
            admin_command(os.path.join(sockdir, f"{name}.asok"), prefix, **kw), 60)

    async def sockets_up(osd_ids):
        """An OSD opens its admin socket last, after it is up in the map."""
        async with asyncio.timeout(PROC_UP_S):
            while not all(os.path.exists(os.path.join(sockdir, f"osd.{i}.asok"))
                          for i in osd_ids):
                await asyncio.sleep(0.2)

    def cli(fn, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = fn(argv)
        if rc != 0:
            raise AssertionError(f"{argv} exited {rc}: {out.getvalue()}")
        return out.getvalue()

    async def socket_checks(osd_id, what):
        """The process names its device, and no op left the card."""
        arch, perf, disp = await asyncio.gather(
            asok(f"osd.{osd_id}", "arch"), asok(f"osd.{osd_id}", "perf dump"),
            asok(f"osd.{osd_id}", "dump_ec_dispatch"))
        if card and (arch["platform"] != "gpu"
                     or arch["device_kind"] != torch.cuda.get_device_name(dev)):
            raise AssertionError(f"osd.{osd_id}'s arch names {arch['platform']} "
                                 f"{arch['device_kind']}, not the card")
        return served_off_card(f"osd.{osd_id} in {what}", disp["totals"], perf["ec"], card)

    async def main():
        pc = ProcCluster(os.path.join(root, "c"), n_osds=PROC_OSDS, store_kind="blue",
                         heartbeat_interval=PROC_HEARTBEAT_S, log_dir=os.path.join(root, "logs"),
                         osd_config={"osd_max_backfills": CLUSTER_MAX_BACKFILLS},
                         device=None if card else "cpu")
        if card:
            log(f"  before the processes: {card_memory()}")
        t0 = time.perf_counter()
        try:
            await pc.start(timeout=PROC_HEALTHY_S)
            await sockets_up(range(PROC_OSDS))
            log(f"  cluster: a mon and {PROC_OSDS} OSD processes (`python -m "
                f"ceph_tpu_torch.tools.daemon osd ... --device {pc.device}`) on BlueStore, "
                f"heartbeat {PROC_HEARTBEAT_S:g} s, all up with their admin sockets in "
                f"{time.perf_counter() - t0:.2f} s")
            cl = await pc.client(op_timeout=CLUSTER_OP_TIMEOUT_S)
            pool = (await create_ec_pools(cl, {"a": STORM_POOLS["a"]}, STORM_PG_NUM))["a"]
            io_a = cl.io_ctx("a")
            m = cl.osdmap
            led = Counter(m.pg_to_up_acting_osds(pg)[3] for pg in m.pgs_of_pool(pool.id))
            traced = max(led, key=lambda o: (led[o], -o))
            gate = asyncio.Semaphore(CLUSTER_INFLIGHT)

            async def write(i, data):
                async with gate:
                    await io_a.write_full(names[i], data)

            async def read(i):
                # no retry: the client retargets and resends by itself,
                # so an error that reaches here is a failed read
                async with gate:
                    return await io_a.read(names[i])

            def rate(n, wall):
                return f"{n * size / wall / 1e9:.3f} GB/s ({wall * 1e3:.1f} ms, host clock)"

            # 1. the writes, under a trace window on the OSD that leads
            # the most pool-A PGs
            if card:
                opened = await asok(f"osd.{traced}", "kernel trace start",
                                    duration=TRACE_ASK_S, label="phase 15")
                if not opened.get("success"):
                    raise AssertionError(f"kernel trace start on osd.{traced}: {opened}")
            t0 = time.perf_counter()
            await asyncio.gather(*(write(i, objs[i]) for i in range(PROC_OBJECTS)))
            wall = time.perf_counter() - t0
            profile, stripe_unit = STORM_POOLS["a"]
            log(f"  write: {PROC_OBJECTS} x {size / 2**20:g} MiB to pool A ({profile}, stripe "
                f"unit {stripe_unit}, {STORM_PG_NUM['a']} PGs) through RadosClient, "
                f"{CLUSTER_INFLIGHT} in flight, each OSD its own process: {rate(PROC_OBJECTS, wall)}")
            if card:
                window = await asok(f"osd.{traced}", "kernel trace stop")
                captured.update(check_osd_window(window))
                log(f"  kernel trace window on osd.{traced} (leads {led[traced]} of "
                    f"{STORM_PG_NUM['a']} pool-A PGs) around the write: wall {window['wall_s']} s, "
                    f"capture {window['capture']}; buckets {window['buckets']}; occupancy "
                    f"{window.get('occupancy')}, so that process's card idle share >= "
                    f"{1 - window.get('occupancy', 0):.4f} (its own view only: CUPTI in one "
                    f"process does not see the other {PROC_OSDS - 1} processes' kernels)")
                log(f"  after the write: {card_memory()}")

            # 2. read back, healthy
            t0 = time.perf_counter()
            got = await asyncio.gather(*(read(i) for i in range(PROC_OBJECTS)))
            wall = time.perf_counter() - t0
            if any(g != objs[i] for i, g in enumerate(got)):
                raise AssertionError("a healthy read differs from its write")
            del got
            log(f"  healthy read: {PROC_OBJECTS} x {size / 2**20:g} MiB, every read == written: "
                f"{rate(PROC_OBJECTS, wall)}")

            # 3. kill -9 of that OSD with a storm of overwrites in flight
            victim = traced
            batches = await socket_checks(victim, "the run before its kill")
            driver = StormDriver(pc, cl, ["a"], clean_timeout=STORM_CLEAN_TIMEOUT_S, device=dev)
            pre = driver.snapshot_map()
            acked = dict(enumerate(objs))
            versions = {i: [objs[i]] for i in range(PROC_OBJECTS)}

            async def storm_put(j):
                versions[j].append(storm[j])
                await write(j, storm[j])
                acked[j] = storm[j]

            t0 = time.perf_counter()
            writers = [asyncio.ensure_future(storm_put(j)) for j in range(PROC_STORM_OBJECTS)]
            await asyncio.sleep(PROC_KILL_AFTER_S)
            pc.kill9_osd(victim)
            # a killed daemon leaves its socket file behind: the restarted
            # one binds a new one at the same path
            os.unlink(os.path.join(sockdir, f"osd.{victim}.asok"))
            await pc.wait_osd_state(cl, victim, up=False, timeout=PROC_UP_S)
            down_s = time.perf_counter() - t0 - PROC_KILL_AFTER_S
            results = await asyncio.gather(*writers, return_exceptions=True)
            wall = time.perf_counter() - t0
            failed = [j for j, r in enumerate(results) if isinstance(r, BaseException)]
            churn = driver.plan_between(pre, driver.snapshot_map())
            if churn["predicted"] != churn["actual"] or not churn["predicted"]:
                raise AssertionError(f"the device plan {sorted(churn['predicted'])} != the "
                                     f"live remap {sorted(churn['actual'])}")
            log(f"  kill -9 of osd.{victim} {PROC_KILL_AFTER_S:g} s into {PROC_STORM_OBJECTS} x "
                f"{size / 2**20:g} MiB overwrites: marked down in {down_s:.2f} s; "
                f"{PROC_STORM_OBJECTS - len(failed)} acked, {len(failed)} failed "
                f"({[repr(results[j])[:80] for j in failed[:2]]}); "
                f"{rate(PROC_STORM_OBJECTS - len(failed), wall)} of acked writes; the plan on "
                f"{driver.device} from the client's maps: {len(churn['predicted'])} PGs "
                f"remapped == the live remap")

            # 4. restart, every PG clean, every object read back
            t0 = time.perf_counter()
            await pc.restart_osd(victim)
            await pc.wait_osd_state(cl, victim, up=True, timeout=PROC_UP_S)
            up_s = time.perf_counter() - t0
            await sockets_up([victim])
            reports = await driver.wait_clean()
            clean_s = time.perf_counter() - t0 - up_s
            t0 = time.perf_counter()
            got = await asyncio.gather(*(read(i) for i in range(PROC_OBJECTS)))
            wall = time.perf_counter() - t0
            for i, g in enumerate(got):
                if i in failed:
                    if g not in versions[i]:
                        raise AssertionError(f"{names[i]}: torn after the kill ({len(g)} bytes)")
                elif g != acked[i]:
                    raise AssertionError(f"{names[i]}: an acked write was lost")
            del got
            log(f"  restart: osd.{victim} up in {up_s:.2f} s, {len(reports)} PGs scrubbed clean "
                f"{clean_s:.2f} s later; read of all {PROC_OBJECTS}: every acked write "
                f"byte-identical, every unacked one a complete version: {rate(PROC_OBJECTS, wall)}")

            # 5. rados bench, write then seq
            loop = asyncio.get_running_loop()
            mon = ",".join(pc.monmap)
            for mode in ("write", "seq"):
                out = await loop.run_in_executor(None, cli, rados_cli.main, [
                    "-m", mon, "bench", "a", str(PROC_BENCH_S), mode])
                line = out.strip()
                if not re.match(BENCH_LINE, line):
                    raise AssertionError(f"rados bench {mode} printed {out!r}")
                log(f"  rados -m MON bench a {PROC_BENCH_S} {mode}: {line}")

            # 6. the ceph CLI against the cluster
            tree = await loop.run_in_executor(None, cli, ceph_cli.main, ["-m", mon, "osd", "tree"])
            rows = [ln for ln in tree.splitlines() if re.search(r"\bosd\.\d+\b", ln)]
            if len(rows) != PROC_OSDS or not all(" up " in ln for ln in rows):
                raise AssertionError(f"ceph osd tree:\n{tree}")
            dump = json.loads(await loop.run_in_executor(None, cli, ceph_cli.main,
                                                         ["-m", mon, "osd", "dump"]))
            if "a" not in {p["name"] for p in dump["pools"].values()}:
                raise AssertionError(f"ceph osd dump has no pool a: {dump['pools']}")
            log(f"  ceph osd tree: {len(rows)} OSDs up; ceph osd dump: epoch {dump['epoch']}, "
                f"pools {sorted(p['name'] for p in dump['pools'].values())}")

            # 7. every OSD process through its admin socket
            batches += sum(await asyncio.gather(*(
                socket_checks(i, "phase 15 (b)") for i in range(PROC_OSDS))))
            if card and batches == 0:
                raise AssertionError("no device-lane launch over the OSD processes")
            log(f"  admin sockets: {PROC_OSDS} OSD processes "
                + (f"each on {torch.cuda.get_device_name(dev)}, " if card else "")
                + f"no op off the card, {batches} device-lane launches over their dispatchers"
                + (" (a CUDA codec's batches take the kernel or raise: no failover, replay "
                   "or native-lane op)" if card else " (the CPU codecs' native lane)"))
            log(f"  launches_proc_cluster: osd.{victim}'s captured launches in its trace "
                f"window {captured} (this process's counts cannot see the OSD processes)")
            if card:
                log(f"  card: {nvidia_smi('name,power.limit')}")
        except BaseException:
            log_daemon_trouble(pc)
            raise
        finally:
            t0 = time.perf_counter()
            await pc.stop()
            log(f"  cluster stopped in {time.perf_counter() - t0:.2f} s")

    saved = os.environ.get("CEPH_TPU_ARGS")
    # every daemon process serves an admin socket: the children take
    # their options from the environment they inherit
    os.environ["CEPH_TPU_ARGS"] = f"--admin_socket {sockdir}/{{name}}.asok"
    try:
        asyncio.run(asyncio.wait_for(main(), STORM_PHASE_LIMIT_S))
    finally:
        if saved is None:
            os.environ.pop("CEPH_TPU_ARGS", None)
        else:
            os.environ["CEPH_TPU_ARGS"] = saved
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return captured


# -- phase 16: the mesh lane on the card ---------------------------------------

# (b): four lanes of the one card
MESH_LANES = 4
# (a)'s w=16 pool and (b)'s prime-k pool, 16 objects of 4 MiB each
MESH_W16_OPS = 16
POOL_K7 = ("isa", {"k": "7", "m": "3"}, 4096)
MESH_K7_OPS = 16
# the erasures of every degraded read in (a) and (b)
MESH_LOST = (1, 5, 9)
# (c): isa k=2 m=2 on 4 OSDs (an m=1 code would take the XOR program,
# not gf_matmul), 8 PGs
MESH_CLUSTER_OSDS = 4
MESH_CLUSTER_POOL = {"mesh": ({"plugin": "isa", "k": "2", "m": "2"}, 4096)}
MESH_CLUSTER_PG_NUM = {"mesh": 8}
MESH_CLUSTER_OBJECTS = 16
MESH_PHASE_LIMIT_S = 300.0


def run_mesh(dev, rng, in_process: dict) -> dict:
    """Phase 16 (see the module docstring).  ``in_process`` holds phase
    6's GB/s of the same pool-A steps, printed beside the mesh's.
    Returns the kernels' launch counts over the phase, counted from one
    reset."""
    import asyncio

    import torch

    from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.ops.device_trace import DeviceTracer
    from ceph_tpu_torch.ops.profiler import profiler
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_dispatch import ECDispatcher
    from ceph_tpu_torch.osd.ec_failover import HEALTHY, STATE_NAMES, EngineSupervisor
    from ceph_tpu_torch.osd.ec_perf import create_ec_perf
    from ceph_tpu_torch.parallel.engine import MeshEcEngine, get_mesh_engine
    from ceph_tpu_torch.rados import MiniCluster
    from ceph_tpu_torch.store import CollectionId, ObjectId

    def make_pool(spec):
        plugin, profile, chunk = spec
        codec = registry.instance().factory(plugin, dict(profile, plugin=plugin), device=dev)
        return codec, ec_util.StripeInfo(codec.get_data_chunk_count() * chunk, chunk)

    codec_a, sinfo_a = make_pool(POOL_A)
    codec_w, sinfo_w = make_pool(POOL_W16)
    codec_7, sinfo_7 = make_pool(POOL_K7)
    objs = [rng.integers(0, 256, size=OSD_OBJECT_SIZE, dtype=np.uint8)
            for _ in range(OSD_OPS)]
    objs_7 = [np.frombuffer(sinfo_7.pad_to_stripe(o.tobytes()), dtype=np.uint8)
              for o in objs[:MESH_K7_OPS]]
    card_mesh = get_mesh_engine(0, device=dev)
    lanes4 = MeshEcEngine(devices=[dev] * MESH_LANES)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if card_mesh.devices != cards:
            raise AssertionError(f"get_mesh_engine(0) took {card_mesh.devices}, not {cards}")
    geometry = {
        "card": (card_mesh.mesh_key(8), card_mesh.reconstruct_axis(8)),
        "lanes k=8": (lanes4.mesh_key(8), lanes4.reconstruct_axis(8)),
        "lanes k=7": (lanes4.mesh_key(7), lanes4.reconstruct_axis(7)),
    }
    log(f"  meshes (pg, shard) and gather axis: {geometry}")
    if geometry["lanes k=8"] != ((1, 4), "shard") or geometry["lanes k=7"] != ((4, 1), "pg"):
        raise AssertionError(f"the 4-lane mesh's geometry: {geometry}")
    launches = {}

    def snapshot():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return gf_cuda.launch_counts()

    def counted(what, since):
        got = launches[what] = {n: c - since[n] for n, c in snapshot().items()}
        if got["gf_matmul"] == 0:
            raise AssertionError(f"gf_matmul was not launched in {what}")
        log(f"  launches in {what}: {got}")

    def dispatcher(mesh):
        """A dispatcher built as phase 6's (the OSD's), with ``mesh`` as
        its mesh lane."""
        pec = create_ec_perf(PerfCountersCollection())
        sup = EngineSupervisor(enabled=True, perf=pec, probe_interval=OSD_PROBE_INTERVAL_S)
        return ECDispatcher(perf=pec, window=OSD_WINDOW_S, max_stripes=OSD_MAX_STRIPES,
                            bucket=True, max_workers=OSD_WORKERS, supervisor=sup,
                            launch_deadline=OSD_LAUNCH_DEADLINE_S, mesh_engine=mesh)

    def lane_only(disp, what, lane):
        """Every batch on ``lane``, none off the card, the breaker
        HEALTHY."""
        t = disp.dump()["totals"]
        served_off_card(what, t, {})
        other = "device" if lane == "mesh" else "mesh"
        if not t["lanes"][lane]["batches"] or t["lanes"][other]["batches"]:
            raise AssertionError(f"{what}: lanes {t['lanes']}")
        state = disp.engine_health()["state"]
        if state != STATE_NAMES[HEALTHY]:
            raise AssertionError(f"{what}: breaker {state}")

    async def timed(coros):
        t0 = time.perf_counter()
        out = await asyncio.gather(*coros)
        return out, time.perf_counter() - t0

    def rate(nbytes, seconds):
        return f"{nbytes / seconds / 1e9:.3f} GB/s ({seconds * 1e3:.1f} ms)"

    def lost(shards, erased=MESH_LOST):
        return {s: v for s, v in shards.items() if s not in erased}

    async def check_reads(what, disp, sinfo, codec, shard_sets, want):
        outs, s = await timed(disp.decode_concat(sinfo, codec, lost(sh))
                              for sh in shard_sets)
        for i, (o, got) in enumerate(zip(want, outs)):
            if bytes(got) != o.tobytes():
                raise AssertionError(f"{what} op {i}: decode_concat of {MESH_LOST} differs")
        return s

    total_a = OSD_OPS * OSD_OBJECT_SIZE

    async def part_a():
        """(a) the card's own mesh beside the device lane."""
        since = snapshot()
        mesh_d, dev_d = dispatcher(card_mesh), dispatcher(None)
        got, s_mesh = await timed(mesh_d.encode(sinfo_a, codec_a, o) for o in objs)
        ref, s_dev = await timed(dev_d.encode(sinfo_a, codec_a, o) for o in objs)
        for i, o in enumerate(objs):
            _check_shards(f"(a) pool A op {i}, mesh lane against the device lane",
                          got[i], ref[i])
            _check_shards(f"(a) pool A op {i}, mesh lane against ec_util.encode",
                          got[i], ec_util.encode(sinfo_a, codec_a, o))
        del ref
        s_dec = await check_reads("(a) pool A", mesh_d, sinfo_a, codec_a, got, objs)
        log(f"  (a) pool A, {OSD_OPS} x 4 MiB on the card's mesh, parity == the device "
            f"lane's == ec_util.encode: encode {rate(total_a, s_mesh)} (device lane "
            f"{rate(total_a, s_dev)}; phase 6: {in_process.get('pool A encode')}), "
            f"decode_concat of {list(MESH_LOST)} == written {rate(total_a, s_dec)} "
            f"(phase 6: {in_process.get('pool A decode [1, 5, 9]')}) (host clock)")
        objs_w = objs[:MESH_W16_OPS]
        got_w, s_w = await timed(mesh_d.encode(sinfo_w, codec_w, o) for o in objs_w)
        ref_w = await asyncio.gather(*(dev_d.encode(sinfo_w, codec_w, o) for o in objs_w))
        for i, o in enumerate(objs_w):
            _check_shards(f"(a) w=16 op {i}, mesh lane against the device lane",
                          got_w[i], ref_w[i])
            _check_shards(f"(a) w=16 op {i}, mesh lane against ec_util.encode",
                          got_w[i], ec_util.encode(sinfo_w, codec_w, o))
        s_wd = await check_reads("(a) w=16", mesh_d, sinfo_w, codec_w, got_w, objs_w)
        nw = MESH_W16_OPS * OSD_OBJECT_SIZE
        log(f"  (a) jerasure reed_sol_van k=8 m=3 w=16, {MESH_W16_OPS} x 4 MiB: encode "
            f"{rate(nw, s_w)}, decode_concat of {list(MESH_LOST)} {rate(nw, s_wd)} "
            f"(host clock); bytes as pool A's")
        lane_only(mesh_d, "(a) the mesh dispatcher", "mesh")
        lane_only(dev_d, "(a) the device-lane dispatcher", "device")
        log(f"  (a) mesh dispatcher: {mesh_d.dump()['totals']['lanes']['mesh']}, "
            f"buckets {mesh_d.dump()['mesh_buckets']}")
        await mesh_d.stop()
        await dev_d.stop()
        counted("(a)", since)
        return got

    async def part_b_d(got_a):
        """(b) four lanes of the card, with (d) the trace window over
        its reconstructs."""
        since = snapshot()
        d4 = dispatcher(lanes4)
        got, s_enc = await timed(d4.encode(sinfo_a, codec_a, o) for o in objs)
        for i in range(OSD_OPS):
            _check_shards(f"(b) pool A op {i} on 4 lanes against (a)", got[i], got_a[i])
        got7, s_enc7 = await timed(d4.encode(sinfo_7, codec_7, o) for o in objs_7)
        for i, o in enumerate(objs_7):
            _check_shards(f"(b) k=7 op {i} on 4 lanes against (a)'s mesh", got7[i],
                          card_mesh.encode(sinfo_7, codec_7, o))
            _check_shards(f"(b) k=7 op {i} against ec_util.encode", got7[i],
                          ec_util.encode(sinfo_7, codec_7, o))
        # (d): one trace window over the reconstructs
        DeviceTracer.prepare()
        svc = DeviceTracer()
        prof = profiler()

        def rec_calls():
            e = prof.dump()["engines"]
            return {n: e[n]["calls"] if n in e else 0
                    for n in ("mesh_reconstruct", "mesh_gather")}

        calls0 = rec_calls()
        opened = svc.start(duration=TRACE_MAX_S, label="phase 16", max_duration=TRACE_MAX_S,
                           device=dev)
        if not opened.get("success"):
            raise AssertionError(f"the trace window did not open: {opened}")
        s_dec = await check_reads("(b) pool A", d4, sinfo_a, codec_a, got, objs)
        s_dec7 = await check_reads("(b) k=7", d4, sinfo_7, codec_7, got7, objs_7)
        probe_len = OSD_MAX_STRIPES * sinfo_a.chunk_size
        lanes4.probe_gather(8, probe_len)
        lanes4.probe_gather(7, probe_len)
        window = svc.stop()
        calls = {n: c - calls0[n] for n, c in rec_calls().items()}
        n7 = sum(len(o) for o in objs_7)
        log(f"  (b) 4 lanes of the card: pool A encode {rate(total_a, s_enc)}, bytes == (a); "
            f"decode_concat of {list(MESH_LOST)} {rate(total_a, s_dec)} (gather over "
            f"'shard'); k=7 encode {rate(n7, s_enc7)}, bytes == (a)'s mesh and "
            f"ec_util.encode; k=7 decode_concat {rate(n7, s_dec7)} (prime-k gather over "
            f"'pg'); every read == written (host clock)")
        lane_only(d4, "(b) the 4-lane dispatcher", "mesh")
        await d4.stop()
        counted("(b)", since)
        # (d)
        if "error" in window or "unavailable" in window:
            raise AssertionError(f"the trace window failed: {window}")
        rec = window["engines"].get("mesh_reconstruct")
        gat = window["engines"].get("mesh_gather", {})
        log(f"  (d) trace window: buckets {window['buckets']}, capture "
            f"{window['capture']}, mesh calls {calls}")
        log(f"  (d) mesh_reconstruct: {rec}")
        log(f"  (d) mesh_gather: {gat}")
        if dev.type == "cuda":
            if not rec or not rec["collective"] > 0 or not rec["fused_op"] > 0:
                raise AssertionError(f"mesh_reconstruct without gather copies or kernel "
                                     f"time: {rec}")
            if window["capture"]["short"] or window["capture"]["intervals_without_device_events"]:
                raise AssertionError(f"the window's capture is short: {window['capture']}")
            log(f"  (d) the gather copies: {rec['collective'] * 1e3:.3f} ms over "
                f"{calls['mesh_reconstruct']} reconstructs "
                f"({rec['collective'] / calls['mesh_reconstruct'] * 1e3:.3f} ms each), beside "
                f"the rebuild's kernels {rec['fused_op'] * 1e3:.3f} ms and the host<->card "
                f"copies {rec['dma'] * 1e3:.3f} ms; the gather alone (probe_gather, "
                f"{calls['mesh_gather']} calls of {probe_len} bytes a row): "
                f"{gat.get('collective', 0.0) * 1e3:.3f} ms of lane copies, "
                f"{gat.get('dma', 0.0) * 1e3:.3f} ms of uploads (device time)")

    async def cluster_run(mesh_on):
        """(c) a 4-OSD MiniCluster on the card, the mesh lane on or off:
        16 x 4 MiB written; with it on, read back healthy and with one
        OSD down.  Returns each object's stored shards."""
        what = f"(c) mesh {'on' if mesh_on else 'off'}"
        cluster = MiniCluster(n_osds=MESH_CLUSTER_OSDS, device=dev,
                              config_overrides={"osd_ec_mesh": True} if mesh_on else None)
        await cluster.start()
        try:
            cl = await cluster.client(op_timeout=CLUSTER_OP_TIMEOUT_S)
            pool = (await create_ec_pools(cl, MESH_CLUSTER_POOL, MESH_CLUSTER_PG_NUM))["mesh"]
            io = cl.io_ctx("mesh")
            gate = asyncio.Semaphore(CLUSTER_INFLIGHT)
            names = [f"mesh.{i:04d}" for i in range(MESH_CLUSTER_OBJECTS)]
            nbytes = MESH_CLUSTER_OBJECTS * OSD_OBJECT_SIZE

            async def write(i):
                async with gate:
                    await io.write_full(names[i], objs[i].tobytes())

            async def read_all(step):
                async def read(i):
                    async with gate:
                        if await io.read(names[i]) != objs[i].tobytes():
                            raise AssertionError(f"{what}: {names[i]} differs in {step}")
                t0 = time.perf_counter()
                await asyncio.gather(*(read(i) for i in range(MESH_CLUSTER_OBJECTS)))
                return rate(nbytes, time.perf_counter() - t0)

            t0 = time.perf_counter()
            await asyncio.gather(*(write(i) for i in range(MESH_CLUSTER_OBJECTS)))
            w_rate = rate(nbytes, time.perf_counter() - t0)
            stored = {}
            for name in names:
                pg, acting, _p = cl.osdmap.object_to_acting(name, pool.id)
                stored[name] = {s: bytes(cluster.stores[o].read(CollectionId(f"{pg}s{s}"),
                                                                ObjectId(name, s)))
                                for s, o in enumerate(acting)}
            if not mesh_on:
                log(f"  {what}: write {w_rate} (host clock)")
                return stored

            def ec_sum(key):
                return sum(o.perf.get("ec").get(key) for o in cluster.osds.values())

            def mesh_batches():
                return sum(o.ec_dispatch.dump()["totals"]["lanes"]["mesh"]["batches"]
                           for o in cluster.osds.values())

            enc_calls, enc_batches = ec_sum("mesh_encode_calls"), mesh_batches()
            if not enc_calls or not enc_batches:
                raise AssertionError(f"{what}: mesh_encode_calls {enc_calls}, mesh batches "
                                     f"{enc_batches}")
            for o in cluster.osds.values():
                if o.ec_mesh is not card_mesh:
                    raise AssertionError(f"{o.name}: not the card's mesh engine")
                osd_off_card(o, what)
            r_rate = await read_all("the healthy read")
            _pg, acting, _p = cl.osdmap.object_to_acting(names[0], pool.id)
            victim = acting[0]
            await cluster.kill_osd(victim)
            await cluster.wait_for_osd_down(victim)
            d_rate = await read_all(f"the read with osd.{victim} down")
            dec_calls = ec_sum("mesh_decode_calls")
            if not dec_calls:
                raise AssertionError(f"{what}: the read with osd.{victim} down made no "
                                     "mesh reconstruct")
            for o in cluster.osds.values():
                osd_off_card(o, what)
            log(f"  {what}: write {w_rate}, healthy read {r_rate}, read with osd.{victim} "
                f"down {d_rate} (host clock); mesh_encode_calls {enc_calls}, mesh batches "
                f"{enc_batches}, mesh_decode_calls {dec_calls}; no op off the card")
            return stored
        finally:
            await cluster.stop()

    async def main():
        gf_cuda.reset_launches()
        start = snapshot()
        got_a = await part_a()
        await part_b_d(got_a)
        del got_a
        since = snapshot()
        plain = await cluster_run(False)
        on = await cluster_run(True)
        if on != plain:
            bad = [n for n in plain if on.get(n) != plain[n]]
            raise AssertionError(f"(c) stored shards differ from the mesh-off cluster's: {bad}")
        log(f"  (c) every stored shard of the {len(on)} objects == the mesh-off cluster's")
        counted("(c)", since)
        counted("the whole phase", start)

    asyncio.run(asyncio.wait_for(main(), MESH_PHASE_LIMIT_S))
    return launches["the whole phase"]


# -- phase 17: S3 on erasure-coded data pools on the card -------------------------

RGW_OSDS = 6  # k+m of both zones' data pools
# zone a: ISA k=4 m=2 (gf_matmul); zone b: jerasure cauchy_good k=4 m=2,
# packetsize 4096 (bitmatrix_xor).  Zone a's technique is ISA's cauchy:
# reed_sol_van's first parity row is all ones, so its one-shard decode is
# the XOR program and no gf_matmul, and this phase loses one OSD
RGW_ZONES = {
    "a": {"plugin": "isa", "technique": "cauchy", "k": "4", "m": "2"},
    "b": {"plugin": "jerasure", "technique": "cauchy_good", "k": "4", "m": "2",
          "packetsize": "4096"},
}
RGW_BUCKET = "chip17"
RGW_OBJECTS = 32
RGW_OBJECT_SIZE = 4 << 20  # the striper's default object size
RGW_PARTS = 8
RGW_PART_SIZE = 5 << 20  # S3's least part size
RGW_RANGE = (1_000_000, 3_000_000)  # one ranged GET of object 0: offset, length
RGW_INFLIGHT = 8
RGW_OP_TIMEOUT_S = 120.0
RGW_PHASE_LIMIT_S = 300.0
RGW_DATE = "Thu, 01 Jan 2026 00:00:00 GMT"


async def s3_request(addr: str, method: str, path: str, body=b"", headers=None,
                     creds=None) -> tuple[int, dict, bytes]:
    """One HTTP/1.1 request to a gateway, signed with AWS SigV2 when
    ``creds`` (a user record) is given; (status, headers, body)."""
    import asyncio

    from ceph_tpu_torch.rgw.http import auth_header

    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        h = {"content-length": str(len(body)), **(headers or {})}
        if creds is not None:
            h.setdefault("date", RGW_DATE)
            h["authorization"] = auth_header(creds["access_key"], creds["secret_key"],
                                             method, path, h)
        head = f"{method} {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in h.items()) + "\r\n"
        writer.write(head.encode())
        if len(body):
            writer.write(body)
        await writer.drain()
        status = int((await reader.readline()).decode().split()[1])
        out = {}
        while (line := await reader.readline()) not in (b"\r\n", b"\n", b""):
            k, _, v = line.decode().partition(":")
            out[k.strip().lower()] = v.strip()
        n = int(out.get("content-length", 0))
        payload = await reader.readexactly(n) if n and method != "HEAD" else b""
        return status, out, payload
    finally:
        writer.close()


def backing_bytes(data: np.ndarray, objectno: int) -> bytes:
    """The bytes the striper's default layout puts in backing object
    ``objectno`` of ``data`` (a whole number of object sets' stripe units,
    or less than one set)."""
    from ceph_tpu_torch.rados.striper import StripedLayout

    lay = StripedLayout()
    su, sc, spo = lay.stripe_unit, lay.stripe_count, lay.stripes_per_object
    units = data.reshape(-1, su)
    objset, pos = divmod(objectno, sc)
    first = objset * sc * spo + pos
    return units[first:(objset + 1) * sc * spo:sc].tobytes()


def run_rgw(dev, rng, cluster_figures: dict, figures: dict | None = None) -> dict:
    """Phase 17 (see the module docstring).  ``cluster_figures`` holds
    phase 13's GB/s, printed beside this phase's; ``figures``, if given,
    gets each step's GB/s (phase 18 prints them beside its own).  Returns
    the kernels' launch counts over the phase, counted from one reset."""
    import asyncio
    import hashlib

    import torch

    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE
    from ceph_tpu_torch.rados import MiniCluster
    from ceph_tpu_torch.rgw import RGWStore, ZoneSyncer
    from ceph_tpu_torch.rgw.http import S3Server
    from ceph_tpu_torch.store import CollectionId, ObjectId

    objs = {f"obj{i:03d}": rng.integers(0, 256, size=RGW_OBJECT_SIZE, dtype=np.uint8)
            for i in range(RGW_OBJECTS)}
    parts = [rng.integers(0, 256, size=RGW_PART_SIZE, dtype=np.uint8)
             for _ in range(RGW_PARTS)]
    objs["multipart"] = np.concatenate(parts)
    total = sum(o.size for o in objs.values())
    launches = {}

    def snapshot():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return gf_cuda.launch_counts()

    def step(what, since, wall, nbytes, beside="") -> None:
        launches[what] = {nm: c - since[nm] for nm, c in snapshot().items()}
        if figures is not None:
            figures[what] = f"{nbytes / wall / 1e9:.3f} GB/s"
        log(f"  {what}: {nbytes / 2**20:g} MiB, {nbytes / wall / 1e9:.3f} GB/s "
            f"({wall * 1e3:.1f} ms, host clock){beside}; launches {launches[what]}")

    async def main():
        cluster = MiniCluster(n_osds=RGW_OSDS, device=dev)
        t0 = time.perf_counter()
        await cluster.start()
        gateways = {}
        device_batches = 0
        try:
            cl = await cluster.client(op_timeout=RGW_OP_TIMEOUT_S)
            stores = {}
            for zone, profile in RGW_ZONES.items():
                code, status, _ = await cl.command({
                    "prefix": "osd erasure-code-profile set", "name": f"rgw_{zone}",
                    "profile": dict(profile)})
                if code != 0:
                    raise AssertionError(f"profile rgw_{zone}: {status}")
                stores[zone] = await RGWStore.create(cl, data_pool_type="erasure",
                                                     data_profile=f"rgw_{zone}", zone=zone)
                gateways[zone] = S3Server(stores[zone], stats_interval=0, device=dev)
            addrs = {zone: await g.start() for zone, g in gateways.items()}
            user = await stores["a"].create_user("chip", "phase 17")
            pools = {zone: cl.osdmap.lookup_pool(f".rgw.buckets.{zone}") for zone in stores}
            log(f"  cluster: a mon and {RGW_OSDS} OSDs on the card, zones a (isa cauchy k=4 "
                f"m=2) and b (cauchy_good k=4 m=2, packetsize 4096) with their data pools "
                f"erasure-coded, gateways at {addrs}, up in {time.perf_counter() - t0:.2f} s")
            gate = asyncio.Semaphore(RGW_INFLIGHT)

            async def req(zone, method, path, body=b"", headers=None, want=200):
                async with gate:
                    st, h, payload = await s3_request(addrs[zone], method, path, body,
                                                      headers, creds=user)
                if st != want:
                    raise AssertionError(f"{method} {path} via zone {zone}: {st} {payload[:200]}")
                return h, payload

            async def put(key):
                h, _ = await req("a", "PUT", f"/{RGW_BUCKET}/{key}", objs[key].tobytes())
                if h["etag"] != hashlib.md5(objs[key].tobytes()).hexdigest():
                    raise AssertionError(f"PUT {key}: etag {h['etag']}")

            async def get(zone, key):
                _h, payload = await req(zone, "GET", f"/{RGW_BUCKET}/{key}")
                if payload != objs[key].tobytes():
                    raise AssertionError(f"GET {key} via zone {zone}: the bytes differ")

            async def get_all(what, zones, beside=""):
                since = snapshot()
                t0 = time.perf_counter()
                await asyncio.gather(*(get(z, k) for z in zones for k in objs))
                step(what, since, time.perf_counter() - t0, total * len(zones), beside)

            gf_cuda.reset_launches()
            start = snapshot()

            # 1. PUTs: 32 objects and a multipart upload of 8 parts into zone a
            since = snapshot()
            t0 = time.perf_counter()
            await req("a", "PUT", f"/{RGW_BUCKET}")
            await asyncio.gather(*(put(k) for k in objs if k != "multipart"))
            _h, payload = await req("a", "POST", f"/{RGW_BUCKET}/multipart?uploads")
            up = json.loads(payload)["uploadId"]
            etags = await asyncio.gather(*(
                req("a", "PUT", f"/{RGW_BUCKET}/multipart?uploadId={up}&partNumber={n + 1}",
                    part.tobytes()) for n, part in enumerate(parts)))
            _h, payload = await req("a", "POST", f"/{RGW_BUCKET}/multipart?uploadId={up}")
            md5s = hashlib.md5(b"".join(bytes.fromhex(h["etag"]) for h, _ in etags))
            if json.loads(payload)["etag"] != f"{md5s.hexdigest()}-{RGW_PARTS}":
                raise AssertionError(f"multipart etag {json.loads(payload)['etag']}")
            step("PUT", since, time.perf_counter() - t0, total,
                 f"; {RGW_OBJECTS} x {RGW_OBJECT_SIZE >> 20} MiB and {RGW_PARTS} parts of "
                 f"{RGW_PART_SIZE >> 20} MiB, signed SigV2, {RGW_INFLIGHT} in flight (phase 13's "
                 f"write: {cluster_figures.get('write', 'not run')})")

            # 2. GETs through zone a, and one ranged GET
            await get_all("GET zone a", ["a"], f" (phase 13's healthy read: "
                          f"{cluster_figures.get('healthy read', 'not run')})")
            off, length = RGW_RANGE
            h, payload = await req("a", "GET", f"/{RGW_BUCKET}/obj000",
                                   headers={"range": f"bytes={off}-{off + length - 1}"},
                                   want=206)
            if payload != objs["obj000"][off:off + length].tobytes():
                raise AssertionError("the ranged GET differs")
            log(f"  ranged GET: {h['content-range']} == the original's slice")

            # 3. zone a's bucket synced into zone b, then read through b
            since = snapshot()
            t0 = time.perf_counter()
            res = await ZoneSyncer(stores["a"], stores["b"], "zone-a").sync()
            if res != {"phase": "full", "applied": len(objs)}:
                raise AssertionError(f"sync: {res}")
            step("sync a -> b", since, time.perf_counter() - t0, total,
                 f" (full sync, {res['applied']} objects read from a and written to b; "
                 f"phase 13's write: {cluster_figures.get('write', 'not run')})")
            await get_all("GET zone b", ["b"], f" (phase 13's healthy read: "
                          f"{cluster_figures.get('healthy read', 'not run')})")

            # 4. the stored shards of two data objects a zone against a CPU
            # codec's encode of their bytes
            t1 = time.perf_counter()
            for zone, profile in RGW_ZONES.items():
                cpu = registry.instance().factory(profile["plugin"], dict(profile),
                                                  device="cpu")
                chunk = cpu.get_chunk_size(pools[zone].stripe_width)
                sinfo = ec_util.StripeInfo(chunk * cpu.get_data_chunk_count(), chunk)
                for key in ("obj000", "multipart"):
                    oid = f"{RGW_BUCKET}/{key}.{0:016x}"
                    data = backing_bytes(objs[key], 0)
                    if await cl.io_ctx(pools[zone].name).read(oid) != data:
                        raise AssertionError(f"{oid} in zone {zone}: the read differs")
                    want = ec_util.encode_fallback(sinfo, cpu, sinfo.pad_to_stripe(data))
                    pg, acting, _p = cl.osdmap.object_to_acting(oid, pools[zone].id)
                    for s, o in enumerate(acting):
                        if o == CRUSH_ITEM_NONE:
                            continue
                        got = np.frombuffer(cluster.stores[o].read(
                            CollectionId(f"{pg}s{s}"), ObjectId(oid, s)), dtype=np.uint8)
                        if not np.array_equal(got, want[s]):
                            raise AssertionError(f"{oid} shard {s} on osd.{o} differs from "
                                                 f"the CPU codec's encode")
            log(f"  stores: the shards of 2 data objects a zone (4 MiB each) == a CPU "
                f"codec's encode from the zone's profile ({time.perf_counter() - t1:.2f} s)")

            # 5. one OSD down: every object of both zones, degraded
            oid = f"{RGW_BUCKET}/obj000.{0:016x}"
            _pg, acting, _p = cl.osdmap.object_to_acting(oid, pools["a"].id)
            victim = acting[0]  # data shard 0 of zone a's first backing object
            device_batches += osd_off_card(cluster.osds[victim], "phase 17 before its kill")
            t1 = time.perf_counter()
            await cluster.kill_osd(victim)
            await cluster.wait_for_osd_down(victim)
            log(f"  killed osd.{victim}, marked down in {time.perf_counter() - t1:.2f} s")
            await get_all("degraded GET, zones a and b", ["a", "b"],
                          f" (phase 13's degraded read: "
                          f"{cluster_figures.get('degraded read, 1 OSD down', 'not run')})")
            if launches["PUT"]["gf_matmul"] == 0:
                raise AssertionError(f"no gf_matmul encode in the PUTs: {launches['PUT']}")
            if launches["sync a -> b"]["bitmatrix_xor"] == 0:
                raise AssertionError(f"no bitmatrix_xor encode in the sync: "
                                     f"{launches['sync a -> b']}")
            for name in gf_cuda.EC_KERNELS:
                if launches["degraded GET, zones a and b"][name] == 0:
                    raise AssertionError(f"no {name} decode in the degraded GETs")

            # 6. nothing off the card
            for osd in cluster.osds.values():
                device_batches += osd_off_card(osd, "phase 17")
            launches["phase"] = {nm: c - start[nm] for nm, c in snapshot().items()}
            log(f"  launches in the phase: {launches['phase']}; {device_batches} device-lane "
                f"launches over the OSDs' dispatchers, no op off the card")
            if dev.type == "cuda":
                log(f"  card: {nvidia_smi('name,power.limit')}")
        finally:
            for g in gateways.values():
                await g.stop()
            for rank in list(cluster.mons):
                await cluster.kill_mon(rank)
            await cluster.stop()

    asyncio.run(asyncio.wait_for(main(), RGW_PHASE_LIMIT_S))
    return launches["phase"]


# -- phase 18: CephFS on an erasure-coded data pool, and RBD ---------------------

CEPHFS_OSDS = 6  # k+m of the data pool
# ISA's cauchy k=4 m=2: gf_matmul in the encodes and in a one-shard decode
# (reed_sol_van's would be the XOR program)
CEPHFS_PROFILE = {"plugin": "isa", "technique": "cauchy", "k": "4", "m": "2"}
CEPHFS_DIRS = 4
CEPHFS_FILES = 32
CEPHFS_FILE_SIZE = 4 << 20  # the striper's default object size
CEPHFS_OVERWRITE = 1 << 20
CEPHFS_INFLIGHT = 8
CEPHFS_OP_TIMEOUT_S = 120.0
CEPHFS_FAILOVER_S = 30.0
RBD_IMAGE_SIZE = 64 << 20
RBD_ORDER = 22  # 4 MiB objects
RBD_WRITE_SIZE = 4 << 20
RBD_MIRROR_WRITES = 4  # written after the bootstrap, replayed from the journal
RBD_MIRROR_WRITE_SIZE = 1 << 20
CEPHFS_PHASE_LIMIT_S = 300.0


def cephfs_path(i: int) -> str:
    return f"/d{i % CEPHFS_DIRS}/f{i:02d}"


def run_cephfs_rbd(dev, rng, rgw_figures: dict) -> dict:
    """Phase 18 (see the module docstring).  ``rgw_figures`` holds phase
    17's GB/s, printed beside this phase's.  Returns the kernels' launch
    counts over the phase, counted from one reset."""
    import asyncio
    import tempfile

    import torch

    from ceph_tpu_torch.mds import CephFSClient
    from ceph_tpu_torch.mds.daemon import DATA_POOL
    from ceph_tpu_torch.models import registry
    from ceph_tpu_torch.ops import gf_cuda
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE
    from ceph_tpu_torch.rados import MiniCluster
    from ceph_tpu_torch.rbd import RBD, Image, ImageMirrorer
    from ceph_tpu_torch.store import CollectionId, ObjectId
    from ceph_tpu_torch.tools import rbd_cli

    files = {cephfs_path(i): rng.integers(0, 256, size=CEPHFS_FILE_SIZE, dtype=np.uint8)
             for i in range(CEPHFS_FILES)}
    written = sum(f.size for f in files.values())
    # three unaligned overwrites into one file (the last runs past its end),
    # a truncate of another to an unaligned size, a rename across directories
    over_path, trunc_path, moved_path = (cephfs_path(CEPHFS_FILES - i) for i in (1, 2, 3))
    over_at = (CEPHFS_FILE_SIZE // 4 + 3, CEPHFS_FILE_SIZE // 2 + 1,
               CEPHFS_FILE_SIZE - CEPHFS_OVERWRITE // 2 + 5)
    overwrites = [rng.integers(0, 256, size=CEPHFS_OVERWRITE, dtype=np.uint8) for _ in over_at]
    trunc_to = CEPHFS_FILE_SIZE * 3 // 4 + 1
    moved_to = f"/d{(int(moved_path[2]) + 1) % CEPHFS_DIRS}/moved"
    rbd_writes = [rng.integers(0, 256, size=RBD_WRITE_SIZE, dtype=np.uint8)
                  for _ in range(RBD_IMAGE_SIZE // RBD_WRITE_SIZE)]
    rbd_late = [(int(rng.integers(0, RBD_IMAGE_SIZE - RBD_MIRROR_WRITE_SIZE)),
                 rng.integers(0, 256, size=RBD_MIRROR_WRITE_SIZE, dtype=np.uint8))
                for _ in range(RBD_MIRROR_WRITES)]
    launches = {}

    def snapshot():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return gf_cuda.launch_counts()

    def step(what, since, wall, nbytes, beside="") -> None:
        launches[what] = {nm: c - since[nm] for nm, c in snapshot().items()}
        log(f"  {what}: {nbytes / 2**20:g} MiB, {nbytes / wall / 1e9:.3f} GB/s "
            f"({wall * 1e3:.1f} ms, host clock){beside}; launches {launches[what]}")

    async def main():
        cluster = MiniCluster(n_osds=CEPHFS_OSDS, device=dev)
        t0 = time.perf_counter()
        await cluster.start()
        device_batches = 0
        try:
            cl = await cluster.client(op_timeout=CEPHFS_OP_TIMEOUT_S)
            code, status, _ = await cl.command({
                "prefix": "osd erasure-code-profile set", "name": "fs_data",
                "profile": dict(CEPHFS_PROFILE)})
            if code != 0:
                raise AssertionError(f"profile fs_data: {status}")
            for name in ("mds.a", "mds.b"):  # mds.b stands by
                await cluster.start_mds(name, data_pool_type="erasure", data_profile="fs_data")
                await cluster.wait_for_active_mds()
            fs = await CephFSClient.mount(cl)
            pool = cl.osdmap.lookup_pool(DATA_POOL)
            if not pool.is_erasure() or cluster.mon.osdmap.mds_name != "mds.a":
                raise AssertionError(f"{DATA_POOL}: erasure {pool.is_erasure()}, active "
                                     f"{cluster.mon.osdmap.mds_name}")
            log(f"  cluster: a mon and {CEPHFS_OSDS} OSDs on the card, mds.a active and mds.b "
                f"standing by, {DATA_POOL} isa cauchy k=4 m=2, up in "
                f"{time.perf_counter() - t0:.2f} s")
            gate = asyncio.Semaphore(CEPHFS_INFLIGHT)

            async def write(path):
                async with gate:
                    await fs.write_file(path, files[path].tobytes())

            async def read(path):
                async with gate:
                    got = await fs.read_file(path)
                if got != files[path].tobytes():
                    raise AssertionError(f"{path}: the bytes differ")

            async def read_all(what, beside=""):
                since = snapshot()
                t0 = time.perf_counter()
                await asyncio.gather(*(read(p) for p in files))
                step(what, since, time.perf_counter() - t0,
                     sum(f.size for f in files.values()), beside)

            gf_cuda.reset_launches()
            start = snapshot()

            # 1. 32 files of 4 MiB across 4 directories
            since = snapshot()
            t0 = time.perf_counter()
            for d in range(CEPHFS_DIRS):
                await fs.mkdir(f"/d{d}")
            await asyncio.gather(*(write(p) for p in files))
            step("write", since, time.perf_counter() - t0, written,
                 f"; {CEPHFS_FILES} x {CEPHFS_FILE_SIZE / 2**20:g} MiB, {CEPHFS_INFLIGHT} in "
                 f"flight (phase 17's PUT: {rgw_figures.get('PUT', 'not run')})")

            # 2. three unaligned overwrites (read-modify-write in the OSDs),
            # a truncate and a rename across directories
            since = snapshot()
            t0 = time.perf_counter()
            f = await fs.open(over_path, create=False)
            for at, data in zip(over_at, overwrites):
                await f.write(data.tobytes(), at)
                grown = np.zeros(max(files[over_path].size, at + data.size), dtype=np.uint8)
                grown[:files[over_path].size] = files[over_path]
                grown[at:at + data.size] = data
                files[over_path] = grown
            await f.close()
            f = await fs.open(trunc_path, create=False)
            await f.truncate(trunc_to)
            await f.close()
            files[trunc_path] = files[trunc_path][:trunc_to]
            await fs.rename(moved_path, moved_to)
            files[moved_to] = files.pop(moved_path)
            step("overwrites", since, time.perf_counter() - t0, len(over_at) * CEPHFS_OVERWRITE,
                 f"; {len(over_at)} x {CEPHFS_OVERWRITE / 2**20:g} MiB at {list(over_at)}, then a "
                 f"truncate to {trunc_to} and a rename")
            if launches["write"]["gf_matmul"] == 0 or launches["overwrites"]["gf_matmul"] == 0:
                raise AssertionError(f"no gf_matmul encode in the writes: {launches}")

            # 3. every file reads back
            await read_all("read", f" (phase 17's GET: {rgw_figures.get('GET zone a', 'not run')})")

            # 4. the stored shards of two data objects against a CPU codec's encode
            t1 = time.perf_counter()
            cpu = registry.instance().factory(CEPHFS_PROFILE["plugin"], dict(CEPHFS_PROFILE),
                                              device="cpu")
            chunk = cpu.get_chunk_size(pool.stripe_width)
            sinfo = ec_util.StripeInfo(chunk * cpu.get_data_chunk_count(), chunk)
            for path in (cephfs_path(0), cephfs_path(1)):
                oid = f"data.{(await fs.stat(path))['ino']:x}.{0:016x}"
                data = backing_bytes(files[path], 0)
                if await cl.io_ctx(DATA_POOL).read(oid) != data:
                    raise AssertionError(f"{oid}: the read differs")
                want = ec_util.encode_fallback(sinfo, cpu, sinfo.pad_to_stripe(data))
                pg, acting, _p = cl.osdmap.object_to_acting(oid, pool.id)
                for s, o in enumerate(acting):
                    if o == CRUSH_ITEM_NONE:
                        continue
                    got = np.frombuffer(cluster.stores[o].read(
                        CollectionId(f"{pg}s{s}"), ObjectId(oid, s)), dtype=np.uint8)
                    if not np.array_equal(got, want[s]):
                        raise AssertionError(f"{oid} shard {s} on osd.{o} differs from the "
                                             f"CPU codec's encode")
            log(f"  stores: the shards of 2 data objects ({len(data) / 2**20:g} MiB each) "
                f"== a CPU codec's encode "
                f"({time.perf_counter() - t1:.2f} s)")

            # 5. the active MDS fails over to the standby: the namespace is the same
            dirs = [f"/d{d}" for d in range(CEPHFS_DIRS)]

            async def namespace():
                listing = {d: await fs.readdir(d) for d in ["/", *dirs]}
                stats = {p: await fs.stat(p) for p in [*dirs, *files]}
                return listing, stats

            before = await namespace()
            t1 = time.perf_counter()
            await cluster.kill_mds("mds.a")
            async with asyncio.timeout(CEPHFS_FAILOVER_S):
                while cluster.mon.osdmap.mds_name != "mds.b":
                    await asyncio.sleep(0.05)
            await cluster.wait_for_active_mds(CEPHFS_FAILOVER_S)
            failover_s = time.perf_counter() - t1
            after = await namespace()
            if after != before:
                raise AssertionError("the namespace differs after the failover")
            log(f"  mds.a killed, mds.b active in {failover_s:.2f} s; readdir of {len(dirs) + 1} "
                f"directories and stat of {len(dirs) + len(files)} paths equal to before")

            # 6. the OSD with data shard 0 of the first file's first object down
            oid = f"data.{before[1][cephfs_path(0)]['ino']:x}.{0:016x}"
            _pg, acting, _p = cl.osdmap.object_to_acting(oid, pool.id)
            victim = acting[0]
            device_batches += osd_off_card(cluster.osds[victim], "phase 18 before its kill")
            t1 = time.perf_counter()
            await cluster.kill_osd(victim)
            await cluster.wait_for_osd_down(victim)
            log(f"  killed osd.{victim}, marked down in {time.perf_counter() - t1:.2f} s")
            await read_all("degraded read, 1 OSD down",
                           f" (phase 17's degraded GET: "
                           f"{rgw_figures.get('degraded GET, zones a and b', 'not run')})")
            if launches["degraded read, 1 OSD down"]["gf_matmul"] == 0:
                raise AssertionError("no gf_matmul decode in the degraded reads")
            for osd in cluster.osds.values():
                device_batches += osd_off_card(osd, "phase 18's CephFS steps")

            # 7. RBD on two replicated pools: a journaled image, a snapshot, a
            # clone flattened, a mirror bootstrapped and replayed
            since = snapshot()
            t0 = time.perf_counter()
            for name in ("rbd_src", "rbd_dst"):
                await cl.create_pool(name, "replicated")
            sio, dio = cl.io_ctx("rbd_src"), cl.io_ctx("rbd_dst")
            rbd = RBD(sio)
            await rbd.create("vol", RBD_IMAGE_SIZE, order=RBD_ORDER, features=["journaling"])
            img = await Image.open(sio, "vol")
            for i, data in enumerate(rbd_writes):
                await img.write(i * RBD_WRITE_SIZE, data.tobytes())
            image = np.concatenate(rbd_writes)
            await img.snap_create("s1")
            await img.snap_protect("s1")
            await rbd.clone("vol", "s1", "vol-clone")
            child = await Image.open(sio, "vol-clone")
            await child.flatten()
            if child.parent is not None or await child.read(0, RBD_IMAGE_SIZE) != image.tobytes():
                raise AssertionError("the flattened clone differs from the snapshot")
            await child.close()
            mirror = ImageMirrorer(sio, dio, "vol")
            await mirror.bootstrap()
            for at, data in rbd_late:
                await img.write(at, data.tobytes())
                image[at:at + data.size] = data
            await img.close()
            applied = await mirror.sync()
            if applied < RBD_MIRROR_WRITES:
                raise AssertionError(f"the mirror replayed {applied} events")
            with tempfile.TemporaryDirectory() as tmp:
                exports = {}
                for pool_name in ("rbd_src", "rbd_dst"):
                    exports[pool_name] = Path(tmp) / pool_name
                    rc = await asyncio.get_running_loop().run_in_executor(
                        None, rbd_cli.main, ["-m", cluster.mon.addr, "-p", pool_name,
                                             "export", "vol", str(exports[pool_name])])
                    if rc != 0:
                        raise AssertionError(f"rbd export of {pool_name}/vol: rc {rc}")
                src, dst = (exports[n].read_bytes() for n in ("rbd_src", "rbd_dst"))
            if src != image.tobytes() or dst != src:
                raise AssertionError("the mirror's export differs from the source's")
            step("rbd", since, time.perf_counter() - t0, RBD_IMAGE_SIZE,
                 f"; a journaled {RBD_IMAGE_SIZE / 2**20:g} MiB image written in "
                 f"{len(rbd_writes)} x {RBD_WRITE_SIZE / 2**20:g} MiB, a snapshot, a clone "
                 f"flattened, a mirror bootstrapped and {applied} journal events replayed, "
                 f"both exports equal; replicated pools, so no kernel should launch")

            # 8. nothing off the card
            for osd in cluster.osds.values():
                device_batches += osd_off_card(osd, "phase 18")
            launches["phase"] = {nm: c - start[nm] for nm, c in snapshot().items()}
            log(f"  launches in the phase: {launches['phase']}; {device_batches} device-lane "
                f"launches over the OSDs' dispatchers, no op off the card")
            if dev.type == "cuda":
                log(f"  card: {nvidia_smi('name,power.limit')}")
        finally:
            for rank in list(cluster.mons):
                await cluster.kill_mon(rank)
            await cluster.stop()

    asyncio.run(asyncio.wait_for(main(), CEPHFS_PHASE_LIMIT_S))
    return launches["phase"]


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "ceph_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the ceph_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from ceph_tpu_torch.device import default_device
    from ceph_tpu_torch.ops import gf_cuda

    dev = default_device()
    rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()

    def phase(title: str) -> None:
        log(f"== {title} ({time.perf_counter() - t_start:.1f} s in)")


    phase("1. card")
    card = nvidia_smi("name,power.limit")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
        f"capability {torch.cuda.get_device_capability(0)}")

    phase("2. build")
    t0 = time.perf_counter()
    built = gf_cuda.build()
    log(f"  built {sorted(built) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s "
        f"(per library: { {n: round(s, 1) for n, s in built.items()} })")
    for name in gf_cuda.SOURCES:
        for line in gf_cuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    phase("3. kernels against their plain versions")
    inputs = check_kernels(dev, rng)
    log("  all kernel checks bit-exact")

    phase("4. main path through the registry")
    gf_cuda.reset_launches()
    run_main_path(dev, rng)
    torch.cuda.synchronize()
    launches = dict(gf_cuda.launches)
    log(f"  launches on the main path: {launches}")
    for name in gf_cuda.EC_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    phase("5. timing")
    rows = time_kernels(dev, inputs, launches)
    time_end_to_end(dev, rng)
    time_packet_layout(dev, rng)

    phase("6. OSD EC engine")
    osd_figures = {}
    osd_launches = run_osd_engine(dev, rng, osd_figures)

    phase("7. CRUSH bulk placement")
    rows.extend(run_crush(dev, rng))

    phase("8. cluster map and churn planning")
    churn_launches = run_churn(dev, rng)

    phase("9. shared accelerator service")
    service_figures = {}
    accel_launches = run_accel_service(dev, rng, osd_figures, service_figures)

    phase("10. accelerator fleet behind the mon")
    fleet_launches = run_accel_fleet(dev, rng, service_figures)

    phase("11. the operator surface: admin sockets, a kernel trace window, the mgr")
    obs_launches = run_observability(dev, rng)

    phase("12. the card's EC writes in the shard stores, a restart and a degraded read")
    store_launches = run_osd_stores(dev, rng)

    phase("13. the port's MiniCluster on the card: client EC writes, degraded reads, a backfill")
    cluster_figures = {}
    cluster_launches = run_osd_cluster(dev, rng, figures=cluster_figures)

    phase("14. scrub, repair and a cache tier on the port's MiniCluster")
    scrub_tier_launches = run_osd_scrub_tier(dev, rng)

    phase("15. the storm, and the OSDs in their own processes on the card")
    storm_launches = run_storm(dev, rng)
    proc_launches = run_proc_cluster(dev, rng)

    phase("16. the mesh lane on the card")
    mesh_launches = run_mesh(dev, rng, osd_figures)

    phase("17. S3 on erasure-coded data pools: the RGW gateway over the port's MiniCluster")
    rgw_figures = {}
    rgw_launches = run_rgw(dev, rng, cluster_figures, rgw_figures)

    phase("18. CephFS on an erasure-coded data pool, and RBD, over the port's MiniCluster")
    cephfs_launches = run_cephfs_rbd(dev, rng, rgw_figures)
    for row in rows:
        row["launches_osd_engine"] = osd_launches[row["name"]]
        row["launches_churn"] = churn_launches[row["name"]]
        row["launches_accel_service"] = accel_launches[row["name"]]
        row["launches_accel_fleet"] = fleet_launches[row["name"]]
        row["launches_observability"] = obs_launches[row["name"]]
        row["launches_osd_stores"] = store_launches[row["name"]]
        row["launches_osd_cluster"] = cluster_launches[row["name"]]
        row["launches_osd_scrub_tier"] = scrub_tier_launches[row["name"]]
        row["launches_storm"] = storm_launches[row["name"]]
        row["launches_proc_cluster"] = proc_launches[row["name"]]
        row["launches_mesh"] = mesh_launches[row["name"]]
        row["launches_rgw"] = rgw_launches[row["name"]]
        row["launches_cephfs"] = cephfs_launches[row["name"]]
    log(f"== done in {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
