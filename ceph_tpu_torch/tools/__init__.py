"""Operator CLIs: ec_benchmark, ec_non_regression, bench_sweep, crushtool,
osdmaptool, monmaptool, the store tools, rados, ceph, rbd, cephfs,
rgw_admin, vstart and the daemon launcher (``daemon``)."""
