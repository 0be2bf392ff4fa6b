"""The OSD's erasure-code engine: stripe math (``ec_util``), write
planning (``ec_transaction``), the cross-op microbatch dispatcher
(``ec_dispatch``) and its engine supervisor (``ec_failover``); the
cluster map (``osdmap``) and device-planned churn (``churn``)."""
