"""The OSD: the daemon (``daemon.OSD``) and its recovery
(``recovery``); its erasure-code engine: stripe math (``ec_util``),
write planning (``ec_transaction``), the cross-op microbatch dispatcher
(``ec_dispatch``) and its engine supervisor (``ec_failover``); the
cluster map (``osdmap``) and device-planned churn (``churn``); and the
PG-level helpers the OSD stands on: the PG log (``pg_log``), snapshots
(``snaps``), peering's info and past intervals (``peering``),
recovery reservations (``reservations``) and the per-client op ledger
(``client_ledger``).

``OSD`` is imported on first use, so that importing the engine's
modules does not load the daemon and its messenger."""

__all__ = ["OSD"]


def __getattr__(name: str):
    if name == "OSD":
        from .daemon import OSD

        return OSD
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
