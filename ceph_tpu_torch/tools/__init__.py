"""Operator CLIs: ec_benchmark, ec_non_regression, crushtool."""
