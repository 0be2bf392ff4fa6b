"""ceph_tpu_torch — the erasure-code engine, CRUSH bulk placement, the
cluster map and churn planning of ``ceph_tpu`` on PyTorch and CUDA
(NVIDIA Hopper, sm_90a).

It mirrors ``ceph_tpu``'s layout and names so each module's counterpart
is easy to find:

- ``device``: the device probe; CUDA unless the caller asks for the CPU;
- ``ops``: GF(2^w) field tables and matrices (numpy), the plain torch
  region engines (``gf_torch``), CRUSH's batched primitives
  (``crush_torch``) and the hand-written Hopper kernels (``gf_cuda``,
  ``crush_cuda`` + ``csrc/``);
- ``crush``: CRUSH maps, the scalar mapper, the wire and text forms,
  the batched mapper over torch lanes and ``CrushTester``;
- ``models``: the codec interface, registry and plugins (jerasure, isa,
  lrc, shec, example);
- ``osd``: the OSD's EC engine: stripe math (``ec_util``), write plans
  (``ec_transaction``), the cross-op microbatch dispatcher
  (``ec_dispatch``), its engine supervisor (``ec_failover``) and the
  ``ec`` perf family (``ec_perf``); the cluster map (``osdmap``) and
  the device-planned churn (``churn``);
- ``accel``, ``store``, ``mon``: the fleet map the OSDMap carries
  (``accelmap``), the key-value store (``kv``) and the monitor's map
  store (``store``);
- ``common``: perf counters and the trace context the dispatcher reads;
- ``utils``: byte buffers and copy accounting, the native host engine
  (``csrc/host/ec_cpu.cc``, built with ``g++``) and the object-name
  hashes (``str_hash``);
- ``ops.profiler`` / ``ops.device_trace``: the kernel profiler and the
  launch flight recorder;
- ``tools``: ``ec_benchmark``, ``ec_non_regression``, ``crushtool`` and
  ``osdmaptool``.

It imports torch, numpy and the standard library, never jax and never
``ceph_tpu``.
"""
