"""Learned per-plan policy store.

The doctor (obs/doctor.py) already diagnoses what ails a job — barrier-
dominated stages, locality misses, skew — and names the knob that fixes
each.  Today a human reads the finding and sets the knob.  This module
closes that loop: after every job it records the plan's *shape*
fingerprint (snapshot-free, so the same dashboard query matches across
data refreshes) together with the doctor's findings and the measured
latency; on the next submit of a matching plan it merges the learned knob
overrides *beneath* the session's explicit settings.

Safety rails, routing_table.json style — measured, never assumed:

* a ``shadow_fraction`` of submits (deterministic per job id) runs at
  baseline so there is always a live control population;
* an override whose applied-population median latency regresses past the
  shadow population's is auto-rolled-back and quarantined.

Inert unless ``ballista.cache.policy.enabled`` is set.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import threading
from typing import Any

from ..config import (
    AQE_ENABLED,
    AQE_SKEW_ENABLED,
    SHUFFLE_LOCALITY_ENABLED,
    SHUFFLE_PIPELINED,
)

__all__ = ["PolicyStore", "FINDING_OVERRIDES"]

# doctor finding code → the knob override it prescribes
FINDING_OVERRIDES: dict[str, dict[str, str]] = {
    "barrier_dominated_job": {SHUFFLE_PIPELINED: "true"},
    "locality_miss_stage": {SHUFFLE_LOCALITY_ENABLED: "true"},
    "skewed_stage": {AQE_ENABLED: "true", AQE_SKEW_ENABLED: "true"},
}

# rollback when applied median exceeds shadow median by this factor,
# with at least _MIN_SAMPLES observations on each side
_REGRESSION_FACTOR = 1.2
_MIN_SAMPLES = 3
_MAX_SAMPLES = 50  # per-population ring buffer


class PolicyStore:
    """Durable shape-fingerprint → learned-knob-overrides map."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        # fp → {"overrides": {key: val}, "baseline": [s], "applied": [s],
        #        "rolled_back": {key: reason}, "findings": [code],
        #        "jobs": int}
        self._plans: dict[str, dict] = {}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                self._plans = json.load(f)
        except (OSError, ValueError):
            self._plans = {}

    def _save_locked(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._plans, f)
        os.replace(tmp, self.path)

    # -- submit side ---------------------------------------------------------

    def overrides_for(
        self, job_id: str, shape_fp: str, shadow_fraction: float
    ) -> tuple[dict[str, str], str]:
        """Overrides to merge beneath session settings, and this job's arm.

        Returns ``({}, "baseline")`` for unknown plans, plans with nothing
        learned yet, and the shadow population (chosen deterministically
        from the job id so re-submits of one job are reproducible).
        """
        with self._lock:
            rec = self._plans.get(shape_fp)
            if not rec or not rec.get("overrides"):
                return {}, "baseline"
            if self._is_shadow(job_id, shadow_fraction):
                return {}, "shadow"
            return dict(rec["overrides"]), "applied"

    @staticmethod
    def _is_shadow(job_id: str, shadow_fraction: float) -> bool:
        if shadow_fraction <= 0:
            return False
        if shadow_fraction >= 1:
            return True
        h = int.from_bytes(
            hashlib.sha256(job_id.encode()).digest()[:4], "big"
        )
        return (h % 10_000) < shadow_fraction * 10_000

    # -- completion side -----------------------------------------------------

    def record_job(
        self,
        shape_fp: str,
        arm: str,
        latency_s: float,
        findings: list[dict | str] | None,
    ) -> list[dict]:
        """Fold one finished job into the plan's record.

        ``arm`` is what :meth:`overrides_for` returned at submit
        ("baseline" | "shadow" | "applied").  Baseline/shadow runs feed the
        control population and, via the doctor findings, may *learn* new
        overrides; applied runs feed the treatment population and may
        trigger rollback.  Returns a list of rollback events (possibly
        empty) for the caller to journal.
        """
        events: list[dict] = []
        with self._lock:
            rec = self._plans.setdefault(
                shape_fp,
                {
                    "overrides": {},
                    "baseline": [],
                    "applied": [],
                    "rolled_back": {},
                    "findings": [],
                    "jobs": 0,
                },
            )
            rec["jobs"] += 1
            pop = "applied" if arm == "applied" else "baseline"
            rec[pop].append(float(latency_s))
            del rec[pop][:-_MAX_SAMPLES]
            if arm != "applied":
                # learn: findings observed while running WITHOUT the
                # override are evidence the override is needed
                for f in findings or []:
                    # accept full finding dicts or bare code strings
                    code = f.get("code") if isinstance(f, dict) else f
                    for key, val in FINDING_OVERRIDES.get(code, {}).items():
                        if key in rec["rolled_back"]:
                            continue  # quarantined; needs operator reset
                        if rec["overrides"].get(key) != val:
                            rec["overrides"][key] = val
                            # new treatment ⇒ stale samples are meaningless
                            rec["applied"] = []
                    if code in FINDING_OVERRIDES and code not in rec["findings"]:
                        rec["findings"].append(code)
            else:
                events = self._maybe_rollback_locked(shape_fp, rec)
            self._save_locked()
        return events

    def _maybe_rollback_locked(self, shape_fp: str, rec: dict) -> list[dict]:
        base, appl = rec["baseline"], rec["applied"]
        if len(base) < _MIN_SAMPLES or len(appl) < _MIN_SAMPLES:
            return []
        base_med = statistics.median(base)
        appl_med = statistics.median(appl)
        if base_med <= 0 or appl_med <= base_med * _REGRESSION_FACTOR:
            return []
        events = []
        for key in list(rec["overrides"]):
            reason = (
                f"applied median {appl_med:.3f}s > "
                f"{_REGRESSION_FACTOR}x shadow median {base_med:.3f}s"
            )
            rec["rolled_back"][key] = reason
            events.append(
                {
                    "fingerprint": shape_fp,
                    "key": key,
                    "value": rec["overrides"].pop(key),
                    "reason": reason,
                }
            )
        rec["applied"] = []
        return events

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            plans = []
            for fp, rec in self._plans.items():
                base, appl = rec["baseline"], rec["applied"]
                plans.append(
                    {
                        "fingerprint": fp,
                        "jobs": rec["jobs"],
                        "overrides": dict(rec["overrides"]),
                        "rolled_back": dict(rec["rolled_back"]),
                        "findings": list(rec["findings"]),
                        "baseline_median_s": (
                            statistics.median(base) if base else None
                        ),
                        "applied_median_s": (
                            statistics.median(appl) if appl else None
                        ),
                        "baseline_n": len(base),
                        "applied_n": len(appl),
                    }
                )
        return {"plans": plans, "plan_count": len(plans)}
