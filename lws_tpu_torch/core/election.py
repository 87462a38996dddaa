"""Leader election over a Store-backed Lease.

Mirrors the semantics of client-go's leaderelection/resourcelock as used by
the reference's manager startup (cmd/main.go:95-106,186: `leader-elect`
defaults true; lease 15s, renew deadline 10s, retry 2s):

- the holder renews `spec.renew_time` every retry period;
- a candidate acquires the lease when it is unheld or expired
  (now - renew_time > lease_duration), bumping `lease_transitions`;
- all writes go through optimistic concurrency, so two candidates racing on
  an expired lease resolve via ConflictError — exactly one wins;
- a holder that cannot renew within the renew deadline must stop leading
  (the manager half: ControlPlane gates reconciliation on `is_leader()`);
- the default clock is wall time (NOT monotonic): leases persist in state
  files, and a restored monotonic timestamp from a previous boot would be
  meaningless. Timestamps from the future beyond one lease duration are
  treated as expired so a corrupt/skewed lease cannot deadlock election.

Deterministic by construction: the clock is injectable and `tick()` is a
plain method, so tests drive elections without threads or sleeps.

The port's copy of lws_tpu/core/election.py.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from lws_tpu_torch.api.lease import (
    DEFAULT_LEASE_DURATION_S,
    DEFAULT_LEASE_NAME,
    DEFAULT_RENEW_DEADLINE_S,
    DEFAULT_RETRY_PERIOD_S,
    Lease,
)
from lws_tpu_torch.api.meta import ObjectMeta
from lws_tpu_torch.api.node import CLUSTER_NAMESPACE
from lws_tpu_torch.core.store import AlreadyExistsError, ConflictError, NotFoundError, Store


class LeaderElector:
    def __init__(
        self,
        store: Store,
        identity: str,
        lease_name: str = DEFAULT_LEASE_NAME,
        lease_duration_s: float = DEFAULT_LEASE_DURATION_S,
        renew_deadline_s: float = DEFAULT_RENEW_DEADLINE_S,
        retry_period_s: float = DEFAULT_RETRY_PERIOD_S,
        clock: Callable[[], float] = time.time,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> None:
        self.store = store
        self.identity = identity
        self.lease_name = lease_name
        self.lease_duration_s = lease_duration_s
        self.renew_deadline_s = renew_deadline_s
        self.retry_period_s = retry_period_s
        self.clock = clock
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = False
        self._last_renew = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- observation ------------------------------------------------------

    def is_leader(self) -> bool:
        return self._leading

    def leader_identity(self) -> Optional[str]:
        lease = self._get_lease()
        if lease is None:
            return None
        if self._expired(lease, self.clock()):
            return None
        return lease.spec.holder_identity

    # -- the election step ------------------------------------------------

    def tick(self) -> bool:
        """One acquire-or-renew attempt; returns whether we lead afterwards.
        Call periodically (every retry_period_s) or from tests directly."""
        now = self.clock()
        was_leading = self._leading
        if self._try_acquire_or_renew(now):
            self._last_renew = now
            self._set_leading(True, was_leading)
        elif self._leading and now - self._last_renew > self.renew_deadline_s:
            # Could not renew within the deadline: step down hard. Another
            # candidate may already be leading; acting on stale leadership
            # would mean two active controllers.
            self._set_leading(False, was_leading)
        elif not self._leading:
            self._set_leading(False, was_leading)
        return self._leading

    def release(self) -> None:
        """Voluntarily give up the lease (clean shutdown → instant failover)."""
        was_leading = self._leading
        lease = self._get_lease()
        if lease is not None and lease.spec.holder_identity == self.identity:
            lease.spec.holder_identity = None
            lease.spec.renew_time = 0.0
            try:
                self.store.update(lease)
            except (ConflictError, NotFoundError):
                pass
        self._set_leading(False, was_leading)

    # -- background mode --------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.retry_period_s):
                self.tick()

        self._thread = threading.Thread(target=loop, daemon=True, name="leader-elector")
        self.tick()
        self._thread.start()

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if release:
            self.release()

    # -- internals --------------------------------------------------------

    def _get_lease(self) -> Optional[Lease]:
        obj = self.store.try_get("Lease", CLUSTER_NAMESPACE, self.lease_name)
        return obj if isinstance(obj, Lease) else None

    def _expired(self, lease: Lease, now: float) -> bool:
        if not lease.spec.holder_identity:
            return True
        if lease.spec.renew_time - now > lease.spec.lease_duration_s:
            return True  # far-future timestamp: clock skew / bad restore
        return now - lease.spec.renew_time > lease.spec.lease_duration_s

    def _try_acquire_or_renew(self, now: float) -> bool:
        lease = self._get_lease()
        if lease is None:
            lease = Lease(
                meta=ObjectMeta(namespace=CLUSTER_NAMESPACE, name=self.lease_name)
            )
            lease.spec.holder_identity = self.identity
            lease.spec.lease_duration_s = self.lease_duration_s
            lease.spec.acquire_time = now
            lease.spec.renew_time = now
            try:
                self.store.create(lease)
                return True
            except (AlreadyExistsError, ConflictError):
                return False  # lost the create race: retry next tick

        if lease.spec.holder_identity == self.identity:
            lease.spec.renew_time = now
            lease.spec.lease_duration_s = self.lease_duration_s
            try:
                self.store.update(lease)
                return True
            except (ConflictError, NotFoundError):
                return False

        if not self._expired(lease, now):
            return False

        # Expired under another holder: take over.
        lease.spec.holder_identity = self.identity
        lease.spec.lease_duration_s = self.lease_duration_s
        lease.spec.acquire_time = now
        lease.spec.renew_time = now
        lease.spec.lease_transitions += 1
        try:
            self.store.update(lease)
            return True
        except (ConflictError, NotFoundError):
            return False

    def _set_leading(self, leading: bool, was_leading: bool) -> None:
        self._leading = leading
        if leading and not was_leading and self.on_started_leading:
            self.on_started_leading()
        if not leading and was_leading and self.on_stopped_leading:
            self.on_stopped_leading()
