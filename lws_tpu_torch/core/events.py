"""Event recorder: the user-facing trace of controller decisions
(≈ k8s Events; ref leaderworkerset_controller.go:71-84 event reasons).

The port's copy of lws_tpu/core/events.py.
"""

from __future__ import annotations

import collections
import time
from collections import deque
from dataclasses import dataclass, field

from lws_tpu_torch.api.meta import TypedObject


@dataclass
class Event:
    object_key: tuple[str, str, str]
    type: str  # "Normal" | "Warning"
    reason: str
    message: str
    timestamp: float = field(default_factory=time.time)


class EventRecorder:
    def __init__(self, max_events: int = 10000, max_per_object: int = 256) -> None:
        # Global ring (the /events listing) PLUS a per-key deque index:
        # for_object() runs inside status passes, and a full-ring scan per
        # call is O(ring) — across a 512-group rollout's O(groups) status
        # reconciles that scan went quadratic. The index bounds memory per
        # object (`max_per_object`, oldest dropped) independently of the
        # global ring, so a chatty object can age out of the listing while
        # its own recent history stays queryable, and vice versa.
        self.events: list[Event] = []
        self._max = max_events
        # Bounded LRU over keys (DS rollouts churn uniquely-named child
        # objects forever — an unbounded key map would leak deques).
        self._by_key: "collections.OrderedDict[tuple[str, str, str], deque]" = (
            collections.OrderedDict()
        )
        self._max_per_object = max_per_object

    def event(self, obj: TypedObject, etype: str, reason: str, message: str) -> None:
        ev = Event(obj.key(), etype, reason, message)
        self.events.append(ev)
        if len(self.events) > self._max:
            del self.events[: len(self.events) - self._max]
        index = self._by_key.get(ev.object_key)
        if index is None:
            index = self._by_key[ev.object_key] = deque(maxlen=self._max_per_object)
        else:
            self._by_key.move_to_end(ev.object_key)
        index.append(ev)
        while len(self._by_key) > 8192:
            self._by_key.popitem(last=False)

    def for_object(self, obj: TypedObject) -> list[Event]:
        return list(self._by_key.get(obj.key(), ()))

    def reasons(self, obj: TypedObject) -> list[str]:
        return [e.reason for e in self.for_object(obj)]
