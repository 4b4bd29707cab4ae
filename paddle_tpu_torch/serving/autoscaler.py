"""SLO-driven elastic capacity for a replica fleet (port of
paddle_tpu/serving/autoscaler.py; host code, copied).

The autoscaler closes the loop between the gateway's admission-time SLO
signals (`ServingGateway.scale_signals`: estimated queue wait, lane
depths, shed counters) and fleet membership: sustained overload spawns
replicas, sustained idleness retires them — and a retirement is ALWAYS
a drain (`FleetRouter.drain` + deferred remove), never a kill, so no
stream is ever dropped for capacity reasons.

Three dampers keep it from flapping:

* **hysteresis** — scale-up needs `breach_ticks` CONSECUTIVE breached
  ticks (est-wait over threshold, or fresh sheds); scale-down needs
  `idle_ticks` consecutive idle ticks (empty queue, est-wait under the
  idle threshold, no sheds).  A single spiky tick resets the opposite
  streak and moves nothing.
* **cooldown** — after any action, no further action for `cooldown_s`
  (booting capacity must land before it can be judged insufficient).
* **bounds** — membership stays within [min_replicas, max_replicas];
  BOOTING replicas count toward the bound so one sustained breach
  cannot spawn a thundering herd while the first spawn warms.

Who-wins with concurrent fleet ops: the autoscaler never retires a
replica that is mid-weight-flip (`rep.flipping`) or already DRAINING,
and a replica it retires is skipped by the refresher's convergence
sweep (flips require liveness; a drained replica is removed).  The
`spawn` callable owns replica construction (an in-process engine
factory that warms the engine and adds it; on the card the warmup
captures the new replica's graphs on the autoscaler's thread while the
fleet serves), so scale-up capacity converges onto the current verified
weights via the refresher's sweep once warm.

Runs OFF the driving thread (like the refresher): `tick()` only calls
thread-safe fleet surfaces.  Drive it manually (tests inject `_clock`)
or with `start()`.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..core.errors import InvalidArgumentError
from .fleet import BOOTING, DEGRADED, DRAINING, HEALTHY

__all__ = ["Autoscaler"]


class Autoscaler:
    def __init__(self, fleet, signals: Callable[[], Dict],
                 spawn: Callable[[], Optional[int]],
                 min_replicas: int = 1, max_replicas: int = 4,
                 scale_up_est_wait_s: float = 0.5,
                 idle_est_wait_s: Optional[float] = None,
                 breach_ticks: int = 3, idle_ticks: int = 10,
                 cooldown_s: float = 10.0,
                 _clock=time.monotonic):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise InvalidArgumentError(
                "need 1 <= min_replicas <= max_replicas "
                f"(got {min_replicas}..{max_replicas})")
        self.fleet = fleet
        self.signals = signals
        self.spawn = spawn
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_est_wait_s = float(scale_up_est_wait_s)
        self.idle_est_wait_s = (float(idle_est_wait_s)
                                if idle_est_wait_s is not None
                                else self.scale_up_est_wait_s * 0.25)
        self.breach_ticks = max(1, int(breach_ticks))
        self.idle_ticks = max(1, int(idle_ticks))
        self.cooldown_s = float(cooldown_s)
        self._clock = _clock
        self._breach = 0
        self._idle = 0
        self._last_action_t: Optional[float] = None
        self._last_shed = 0
        self._last_error: Optional[str] = None
        # every action, for flap analysis: {"dir", "t", "replicas"}
        self.actions: List[Dict] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- introspection -------------------------------------------------
    def status(self) -> Dict:
        with self._lock:
            return {
                "breach_streak": self._breach,
                "idle_streak": self._idle,
                "actions": len(self.actions),
                "scale_ups": sum(1 for a in self.actions
                                 if a["dir"] == "up"),
                "scale_downs": sum(1 for a in self.actions
                                   if a["dir"] == "down"),
                "last_error": self._last_error,
            }

    def _counts(self):
        """(serving_or_booting, retiring): DRAINING replicas are
        already-decided retirements, not capacity."""
        reps = self.fleet.manager.replicas(
            (BOOTING, HEALTHY, DEGRADED, DRAINING))
        live = [r for r in reps if r.state != DRAINING]
        return live, [r for r in reps if r.state == DRAINING]

    # -- one decision cycle --------------------------------------------
    def tick(self) -> Optional[str]:
        """One decision: observe signals, advance the streaks, maybe
        act.  Returns "up"/"down" when an action was taken, else
        None."""
        now = self._clock()
        try:
            sig = self.signals()
        except Exception as e:  # noqa: BLE001 — a dead gateway is idle
            with self._lock:
                self._last_error = (
                    f"signals failed: {type(e).__name__}: {e}")
            return None
        est_wait = float(sig.get("est_wait_s") or 0.0)
        depth = int(sig.get("queue_depth") or 0)
        shed_total = int(sig.get("shed_total") or 0)
        with self._lock:
            shed_delta = shed_total - self._last_shed
            self._last_shed = shed_total
            breach = (est_wait > self.scale_up_est_wait_s
                      or shed_delta > 0)
            idle = (not breach and depth == 0
                    and est_wait <= self.idle_est_wait_s)
            if breach:
                self._breach += 1
                self._idle = 0
            elif idle:
                self._idle += 1
                self._breach = 0
            else:
                # the comfortable middle: demand matches capacity
                self._breach = 0
                self._idle = 0
            in_cooldown = (self._last_action_t is not None
                           and now - self._last_action_t
                           < self.cooldown_s)
            want_up = self._breach >= self.breach_ticks
            want_down = self._idle >= self.idle_ticks
        live, _ = self._counts()
        manager = self.fleet.manager
        action = None
        if want_up and not in_cooldown and len(live) < self.max_replicas:
            try:
                self.spawn()
                action = "up"
            except Exception as e:  # noqa: BLE001 — spawn host errors
                with self._lock:
                    self._last_error = (
                        f"spawn failed: {type(e).__name__}: {e}")
        elif want_down and not in_cooldown \
                and len(live) > self.min_replicas:
            victim = self._pick_victim(live)
            if victim is not None:
                # drain, never kill: residents migrate/finish, then the
                # deferred remove (remove-of-DRAINING) reaps it
                self.fleet.drain(victim.id)
                self.fleet.remove(victim.id)
                action = "down"
        if action is not None:
            with self._lock:
                self._last_action_t = now
                self._breach = 0
                self._idle = 0
                self.actions.append({"dir": action, "t": now,
                                     "replicas": len(live)})
            manager.note_scale(action == "up")
        live, _ = self._counts()
        manager.set_target_replicas(len(live))
        return action

    def _pick_victim(self, live):
        """Least-loaded routable replica that is not mid-flip; None
        defers the retirement a tick rather than racing a refresh."""
        cands = [r for r in live
                 if r.state == HEALTHY and not r.flipping]
        if not cands:
            return None
        return min(cands, key=lambda r: r.load())

    # -- background loop ----------------------------------------------
    def start(self, tick_interval_s: float = 0.25):
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — keep scaling
                    with self._lock:
                        self._last_error = (
                            f"tick failed: {type(e).__name__}: {e}")
                self._stop.wait(tick_interval_s)

        self._thread = threading.Thread(target=loop,
                                        name="fleet-autoscaler",
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
