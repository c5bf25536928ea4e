"""Serving control policies (counterpart of lightgbm_tpu/runtime/policy.py):
clock-free state machines that turn observations into decisions.

* `AutoscaleShedPolicy`: the queue-depth fraction turned into a control
  loop.  Sustained depth above the high watermark widens the micro-batch
  gather window (more rows per device dispatch) and flips load-shed mode
  for the lowest priority class (rejection ``load_shed``, retryable);
  ``patience`` consecutive observations past a watermark are needed for a
  transition and the band between the watermarks resets both counters,
  so a signal oscillating around one threshold cannot toggle the mode.
* `FleetScalePolicy`: the fleet's replica count from windowed p99 and
  queue depth, with the same hysteresis.
* `CanaryPolicy`: a newly published generation judged against the
  incumbent on live error and latency; sustained degradation rolls it
  back, sustained health promotes it.

Each transition lands in the metrics registry
(``lgbm_policy_decisions_total{action}``, ``lgbm_canary_events_total``
and the policy gauges) and in the returned decision records, which the
caller writes into its stage trail.  Given the same observations, the
decisions are the JAX package's, one for one.  No torch or numpy at
module scope.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

from . import telemetry
from .resilience import wallclock

__all__ = ["AutoscaleShedPolicy", "CanaryPolicy", "FleetScalePolicy"]


class AutoscaleShedPolicy:
    """Hysteresis controller over the admission-queue depth fraction.

    Parameters
    ----------
    high_watermark / low_watermark:
        Queue-depth fractions (of ``max_queue``) bounding the deadband.
        ``observe`` counts consecutive samples above high (pressure) or
        below low (slack); samples inside the band reset both counters.
    patience:
        Consecutive samples past a watermark required before acting.
    min_window_s / max_window_s / widen_factor:
        The gather-window range the controller walks: each widen
        multiplies by ``widen_factor`` (capped), each narrow divides
        (floored).  ``window_s`` starts at ``min_window_s``.
    interval_s:
        How often the serving runtime's policy thread samples the depth
        (the controller itself is clock-free).
    """

    def __init__(self,
                 high_watermark: float = 0.75,
                 low_watermark: float = 0.25,
                 patience: int = 3,
                 min_window_s: float = 0.002,
                 max_window_s: float = 0.064,
                 widen_factor: float = 2.0,
                 interval_s: float = 0.05):
        if not (0.0 <= low_watermark < high_watermark <= 1.0):
            raise ValueError("need 0 <= low_watermark < high_watermark <= 1,"
                             " got %r / %r" % (low_watermark, high_watermark))
        if widen_factor <= 1.0:
            raise ValueError("widen_factor must be > 1")
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.patience = max(int(patience), 1)
        self.min_window_s = float(min_window_s)
        self.max_window_s = float(max_window_s)
        self.widen_factor = float(widen_factor)
        self.interval_s = float(interval_s)

        self.window_s = self.min_window_s
        self.shed_active = False
        # a fleet controller that can still ADD REPLICAS revokes
        # this permission — shedding is the last resort, latched only once
        # the fleet is at max_replicas.  Single-replica deployments keep
        # it allowed.
        self.shed_allowed = True
        self._above = 0
        self._below = 0
        self.decisions: List[Dict[str, Any]] = []

    # -- the state machine ---------------------------------------------------
    def observe(self, depth_frac: float) -> List[Dict[str, Any]]:
        """Feed one queue-depth sample (fraction of max_queue); returns
        the decision records this sample triggered ([] for hold).  The
        deadband between the watermarks resets both streak counters —
        that reset IS the anti-flap guarantee."""
        out: List[Dict[str, Any]] = []
        if depth_frac > self.high_watermark:
            self._above += 1
            self._below = 0
        elif depth_frac < self.low_watermark:
            self._below += 1
            self._above = 0
        else:
            self._above = 0
            self._below = 0
            return out
        if self._above >= self.patience:
            self._above = 0
            if self.window_s < self.max_window_s:
                self.window_s = min(self.window_s * self.widen_factor,
                                    self.max_window_s)
                out.append(self._decide("widen", depth_frac))
            if not self.shed_active and self.shed_allowed:
                self.shed_active = True
                out.append(self._decide("shed_on", depth_frac))
        elif self._below >= self.patience:
            self._below = 0
            if self.window_s > self.min_window_s:
                self.window_s = max(self.window_s / self.widen_factor,
                                    self.min_window_s)
                out.append(self._decide("narrow", depth_frac))
            # shed releases only once the window is fully narrowed: the
            # cheap lever (coalescing) is given back before admission is
            elif self.shed_active:
                self.shed_active = False
                out.append(self._decide("shed_off", depth_frac))
        return out

    def _decide(self, action: str, depth_frac: float) -> Dict[str, Any]:
        rec = {"event": "policy_decision", "action": action,
               "window_s": round(self.window_s, 6),
               "shed_active": self.shed_active,
               "depth_frac": round(float(depth_frac), 4),
               "wallclock": wallclock()}
        self.decisions.append(rec)
        telemetry.counter("lgbm_policy_decisions_total").inc(action=action)
        telemetry.gauge("lgbm_policy_window_seconds").set(self.window_s)
        telemetry.gauge("lgbm_policy_shed_active").set(
            1.0 if self.shed_active else 0.0)
        return rec

    def allow_shed(self, allowed: bool) -> List[Dict[str, Any]]:
        """Grant or revoke the shed permission.  Revoking while shed
        is latched releases it immediately — a replica must not keep
        dropping its lowest class when the fleet has capacity to add."""
        self.shed_allowed = bool(allowed)
        if not self.shed_allowed and self.shed_active:
            self.shed_active = False
            return [self._decide("shed_off", 0.0)]
        return []

    def state(self) -> Dict[str, Any]:
        return {"window_s": self.window_s, "shed_active": self.shed_active,
                "shed_allowed": self.shed_allowed,
                "decisions": len(self.decisions)}


class FleetScalePolicy:
    """Hysteresis state machine over FLEET load: queue-depth fraction and
    windowed p99 latency (scraped from every replica's metrics registry)
    in, replica-count targets out.

    Same contract as `AutoscaleShedPolicy` — pure, clock-free, pinnable:

    * **Pressure** is mean queue-depth fraction above ``high_watermark``
      OR windowed p99 above ``slo_p99_s``; **slack** is depth below
      ``low_watermark`` AND p99 back under the SLO.  Anything in between
      is the deadband and resets both streak counters (the no-flap
      guarantee).
    * ``patience`` consecutive pressure samples raise ``target`` by one
      replica (capped at ``max_replicas``); ``scale_down_patience``
      consecutive slack samples lower it (floored at ``min_replicas``).
      Scale-down defaults to 2x the scale-up patience: capacity is
      cheap to keep for a few seconds and expensive to miss.
    * **Shed is the last resort**: only when ``target`` is pinned at
      ``max_replicas`` and pressure persists does the controller latch
      ``shed_on`` — the `FleetController` then grants the per-replica
      `AutoscaleShedPolicy` its shed permission.  On slack the shed
      latch releases BEFORE any replica is retired.

    Decision records carry the acting sample's evidence (depth fraction,
    p99, target) and land in ``lgbm_policy_decisions_total{action}``
    like every other policy decision.
    """

    def __init__(self,
                 min_replicas: int = 1,
                 max_replicas: int = 4,
                 slo_p99_s: float = 0.5,
                 high_watermark: float = 0.5,
                 low_watermark: float = 0.15,
                 patience: int = 3,
                 scale_down_patience: Optional[int] = None,
                 interval_s: float = 0.5):
        if not (1 <= int(min_replicas) <= int(max_replicas)):
            raise ValueError("need 1 <= min_replicas <= max_replicas, got"
                             " %r / %r" % (min_replicas, max_replicas))
        if not (0.0 <= low_watermark < high_watermark <= 1.0):
            raise ValueError("need 0 <= low_watermark < high_watermark <= 1,"
                             " got %r / %r" % (low_watermark, high_watermark))
        if slo_p99_s <= 0.0:
            raise ValueError("slo_p99_s must be > 0, got %r" % (slo_p99_s,))
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.slo_p99_s = float(slo_p99_s)
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.patience = max(int(patience), 1)
        self.scale_down_patience = (self.patience * 2
                                    if scale_down_patience is None
                                    else max(int(scale_down_patience), 1))
        self.interval_s = float(interval_s)

        self.target = self.min_replicas
        self.shed_latched = False
        self._above = 0
        self._below = 0
        self.decisions: List[Dict[str, Any]] = []

    # -- the state machine ---------------------------------------------------
    def observe(self, depth_frac: float,
                p99_s: Optional[float] = None) -> List[Dict[str, Any]]:
        """Feed one fleet sample (mean replica queue-depth fraction and
        the windowed p99 across replicas; None p99 = no completions in
        the window, judged on depth alone).  Returns the decision
        records this sample triggered ([] for hold)."""
        depth_frac = float(depth_frac)
        slo_breach = p99_s is not None and float(p99_s) > self.slo_p99_s
        pressure = depth_frac > self.high_watermark or slo_breach
        slack = depth_frac < self.low_watermark and not slo_breach
        out: List[Dict[str, Any]] = []
        if pressure:
            self._above += 1
            self._below = 0
        elif slack:
            self._below += 1
            self._above = 0
        else:
            self._above = 0
            self._below = 0
            return out
        if self._above >= self.patience:
            self._above = 0
            if self.target < self.max_replicas:
                self.target += 1
                out.append(self._decide("scale_up", depth_frac, p99_s))
            elif not self.shed_latched:
                # at max replicas with pressure still rising: the ONLY
                # remaining lever is admission — latch fleet-wide shed
                self.shed_latched = True
                out.append(self._decide("shed_on", depth_frac, p99_s))
        elif self._below >= self.scale_down_patience:
            self._below = 0
            if self.shed_latched:
                # give admission back before retiring any capacity
                self.shed_latched = False
                out.append(self._decide("shed_off", depth_frac, p99_s))
            elif self.target > self.min_replicas:
                self.target -= 1
                out.append(self._decide("scale_down", depth_frac, p99_s))
        return out

    def _decide(self, action: str, depth_frac: float,
                p99_s: Optional[float]) -> Dict[str, Any]:
        rec = {"event": "fleet_decision", "action": action,
               "target": self.target, "shed_latched": self.shed_latched,
               "depth_frac": round(float(depth_frac), 4),
               "p99_s": None if p99_s is None else round(float(p99_s), 6),
               "wallclock": wallclock()}
        self.decisions.append(rec)
        telemetry.counter("lgbm_policy_decisions_total").inc(action=action)
        return rec

    def state(self) -> Dict[str, Any]:
        return {"target": self.target, "shed_latched": self.shed_latched,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "slo_p99_s": self.slo_p99_s,
                "decisions": len(self.decisions)}


class CanaryPolicy:
    """Hysteresis state machine judging a canary generation against the
    incumbent.

    The serving runtime routes a configurable fraction of batches to a
    freshly published generation and feeds every batch outcome here:
    ``observe(kind, error=, latency_s=)`` with ``kind`` canary or
    incumbent, ``error`` the batch's observed prediction error (clients
    that submitted labels; None when no label rode the batch) and the
    batch latency.  The controller is pure and clock-free — decisions
    depend only on the observation sequence, so the hysteresis semantics
    are unit-testable without a runtime.

    * **Warm-up** — no judgment before ``min_samples`` canary AND
      ``min_samples`` incumbent observations (of each signal kind): a
      single unlucky batch must not kill a good model.
    * **Degradation** — a canary comparison round is degraded when its
      windowed mean error exceeds ``incumbent_mean * error_ratio +
      error_margin`` or its windowed mean latency exceeds
      ``incumbent_mean * latency_ratio``.  Means are over the last
      ``window`` observations per side (a bounded sliding window, so a
      canary that RECOVERS pulls its mean back down instead of being
      condemned by history).  ``patience`` CONSECUTIVE degraded rounds
      latch the ``rollback`` decision; any healthy round in between
      resets the streak (the anti-flap deadband, same contract as the
      autoscale controller).
    * **Promotion** — ``promote_after`` canary observations with no
      active degradation streak latch ``promote``: the canary becomes
      the incumbent and full traffic cuts over.

    Every decision lands in ``lgbm_canary_events_total{event}`` and in
    the returned records (the serving runtime writes them to its stage
    trail and, on rollback, into the publish directory's durable
    ROLLBACK marker).
    """

    def __init__(self,
                 min_samples: int = 8,
                 patience: int = 3,
                 error_ratio: float = 1.5,
                 error_margin: float = 0.02,
                 latency_ratio: float = 5.0,
                 promote_after: int = 64,
                 window: int = 64):
        if error_ratio < 1.0 or latency_ratio < 1.0:
            raise ValueError("error_ratio/latency_ratio must be >= 1")
        self.min_samples = max(int(min_samples), 1)
        self.patience = max(int(patience), 1)
        self.error_ratio = float(error_ratio)
        self.error_margin = float(error_margin)
        self.latency_ratio = float(latency_ratio)
        self.promote_after = max(int(promote_after), self.min_samples)
        self.window = max(int(window), self.min_samples)
        self.decisions: List[Dict[str, Any]] = []
        self.reset(None)

    def reset(self, generation: Optional[int]) -> None:
        """Arm for a new canary generation (old streaks must not carry
        over to a different model)."""
        self.generation = generation
        self._err = {"canary": collections.deque(maxlen=self.window),
                     "incumbent": collections.deque(maxlen=self.window)}
        self._lat = {"canary": collections.deque(maxlen=self.window),
                     "incumbent": collections.deque(maxlen=self.window)}
        self._streak = 0
        self._decided: Optional[str] = None
        self._canary_batches = 0

    # -- the state machine ---------------------------------------------------
    def observe(self, kind: str, error: Optional[float] = None,
                latency_s: Optional[float] = None) -> List[Dict[str, Any]]:
        """Feed one batch outcome; returns the decision records this
        observation triggered ([] for hold).  `kind` is "canary" or
        "incumbent"."""
        if kind not in self._err:
            raise ValueError("kind must be canary or incumbent, got %r"
                             % kind)
        if self._decided is not None:
            return []
        if error is not None:
            self._err[kind].append(float(error))
        if latency_s is not None:
            self._lat[kind].append(float(latency_s))
        if kind != "canary":
            return []
        self._canary_batches += 1
        degraded = None
        ce, ie = self._err["canary"], self._err["incumbent"]
        if len(ce) >= self.min_samples and len(ie) >= self.min_samples:
            can_err = sum(ce) / len(ce)
            inc_err = sum(ie) / len(ie)
            if can_err > inc_err * self.error_ratio + self.error_margin:
                degraded = {"signal": "error", "canary": round(can_err, 6),
                            "incumbent": round(inc_err, 6)}
        cl, il = self._lat["canary"], self._lat["incumbent"]
        if degraded is None and len(cl) >= self.min_samples \
                and len(il) >= self.min_samples:
            can_lat = sum(cl) / len(cl)
            inc_lat = sum(il) / len(il)
            if can_lat > inc_lat * self.latency_ratio:
                degraded = {"signal": "latency",
                            "canary": round(can_lat, 6),
                            "incumbent": round(inc_lat, 6)}
        out: List[Dict[str, Any]] = []
        if degraded is not None:
            self._streak += 1
            if self._streak >= self.patience:
                self._decided = "rollback"
                out.append(self._decide("rollback", degraded))
        else:
            self._streak = 0
            if self._canary_batches >= self.promote_after:
                self._decided = "promote"
                out.append(self._decide("promote", None))
        return out

    def _decide(self, event: str,
                evidence: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        rec = {"event": "canary_" + event, "generation": self.generation,
               "canary_batches": self._canary_batches,
               "evidence": evidence, "wallclock": wallclock()}
        self.decisions.append(rec)
        telemetry.counter("lgbm_canary_events_total").inc(event=event)
        return rec

    def note_start(self, generation: int) -> Dict[str, Any]:
        """Record (and count) the canary window opening for `generation`."""
        self.reset(generation)
        rec = {"event": "canary_start", "generation": generation,
               "wallclock": wallclock()}
        self.decisions.append(rec)
        telemetry.counter("lgbm_canary_events_total").inc(event="start")
        return rec

    @property
    def decided(self) -> Optional[str]:
        """"rollback"/"promote" once latched for this generation."""
        return self._decided

    def state(self) -> Dict[str, Any]:
        ce, ie = self._err["canary"], self._err["incumbent"]
        return {"generation": self.generation,
                "canary_batches": self._canary_batches,
                "streak": self._streak, "decided": self._decided,
                "canary_mean_error": sum(ce) / len(ce) if ce else None,
                "incumbent_mean_error": sum(ie) / len(ie) if ie else None}
