"""Operator CLIs: ec_benchmark, ec_non_regression, crushtool, osdmaptool,
and the daemon launcher (``daemon``, the accel role)."""
