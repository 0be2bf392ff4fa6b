"""Daemon-wide plumbing the EC engine reads: perf counters and the trace
context."""
