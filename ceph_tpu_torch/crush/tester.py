"""CrushTester: bulk placement simulation + distribution statistics.

Counterpart of ``ceph_tpu/crush/tester.py``: the engine behind
``crushtool --test`` (reference:src/crush/CrushTester.{h,cc}): map every
x in [min_x, max_x] for each rule × replica count, then report
per-device placement counts, expected vs observed utilization, and bad
(short) mappings (reference:CrushTester.cc:627-651 x-loop, batch
statistics in test()).

The x-loop — the reference's hot loop at 10^6 inputs — runs through the
batched path (:mod:`ceph_tpu_torch.crush.mapper_torch`) on the tester's
device when the map shape supports it, with the counts taken on the
device, and falls back to the scalar oracle mapper otherwise, with a
warning.  The device is the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np

from ..device import resolve
from . import mapper, mapper_torch
from .map import CRUSH_ITEM_NONE, CrushMap


@dataclasses.dataclass
class RuleReport:
    """Distribution stats for one (rule, numrep) combination."""

    rule: int
    numrep: int
    num_inputs: int
    device_counts: dict[int, int]
    bad_mappings: int  # inputs that got fewer than numrep devices
    expected_per_device: dict[int, float]
    elapsed_seconds: float
    backend: str  # "vectorized" | "scalar"

    def utilization(self) -> dict[int, float]:
        """observed/expected ratio per device (1.0 = perfectly even)."""
        out = {}
        for dev, expect in self.expected_per_device.items():
            if expect > 0:
                out[dev] = self.device_counts.get(dev, 0) / expect
        return out


class CrushTester:
    """reference:src/crush/CrushTester.h — the --test engine.  ``device``
    is where the batched path runs: the card by default (raising
    ``DeviceUnavailableError`` without one), ``"cpu"`` on request."""

    def __init__(self, cmap: CrushMap, device=None):
        self.cmap = cmap
        self.device = resolve(device)
        self.min_x = 0
        self.max_x = 1023  # reference default range (CrushTester.cc)
        self.min_rep = 1
        self.max_rep = 10
        self.ruleset: int | None = None  # None = all rules
        self.weight: list[int] | None = None
        self.force_scalar = False
        self._warned_scalar: set[int] = set()  # one warning per rule

    def _rules(self) -> list[int]:
        out = []
        for i, r in enumerate(self.cmap.rules):
            if r is None:
                continue
            if self.ruleset is not None and r.ruleset != self.ruleset:
                continue
            out.append(i)
        return out

    def _expected(self, total_slots: int) -> dict[int, float]:
        """Weight-proportional expectation over in devices."""
        weights = self.weight or self.cmap.get_weights()
        total_w = sum(weights)
        if total_w == 0:
            return {d: 0.0 for d in range(len(weights))}
        return {
            d: total_slots * w / total_w for d, w in enumerate(weights)
        }

    def test_rule(self, ruleno: int, numrep: int) -> RuleReport:
        xs = np.arange(self.min_x, self.max_x + 1, dtype=np.uint32)
        t0 = time.perf_counter()
        if not self.force_scalar and mapper_torch.supports(self.cmap, ruleno):
            backend = "vectorized"
            # stats are bincounted on the device: only the counts come back
            device_counts, bad = mapper_torch.vec_rule_stats(
                self.cmap, ruleno, xs, numrep, weight=self.weight,
                device=self.device,
            )
        else:
            backend = "scalar"
            if not self.force_scalar and ruleno not in self._warned_scalar:
                # loud, not silent — but once per rule, not once per
                # numrep sweep entry: a bulk sim quietly losing the
                # batched path is a perf bug the operator should see
                self._warned_scalar.add(ruleno)
                logging.getLogger("ceph_tpu_torch.crush").warning(
                    "CrushTester: rule %d fell back to the SCALAR mapper "
                    "(map/rule shape unsupported by the vectorized path) "
                    "— expect a far slower bulk simulation", ruleno,
                )
            ws = mapper.Workspace(self.cmap)
            device_counts = {}
            bad = 0
            for x in xs:
                res = mapper.crush_do_rule(
                    self.cmap, ruleno, int(x), numrep,
                    weight=self.weight, workspace=ws,
                )
                placed = 0
                for dev in res:
                    if dev != CRUSH_ITEM_NONE:
                        device_counts[dev] = device_counts.get(dev, 0) + 1
                        placed += 1
                if placed < numrep:
                    bad += 1
        elapsed = time.perf_counter() - t0
        total = sum(device_counts.values())
        return RuleReport(
            rule=ruleno,
            numrep=numrep,
            num_inputs=len(xs),
            device_counts=device_counts,
            bad_mappings=bad,
            expected_per_device=self._expected(total),
            elapsed_seconds=elapsed,
            backend=backend,
        )

    def test(self) -> list[RuleReport]:
        """All selected rules × replica counts (reference CrushTester::test)."""
        reports = []
        for ruleno in self._rules():
            rule = self.cmap.rules[ruleno]
            lo = max(self.min_rep, rule.min_size)
            hi = min(self.max_rep, rule.max_size)
            for nr in range(lo, hi + 1):
                reports.append(self.test_rule(ruleno, nr))
        return reports
