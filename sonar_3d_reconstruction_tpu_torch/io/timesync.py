"""Approximate time synchronization of the ping and pose streams (a copy of
``sonar_3d_reconstruction_tpu.io.timesync``).

Line-faithful port of the pairing algorithm of ROS2 message_filters'
``ApproximateTimeSynchronizer`` as the reference uses it
(scripts/3d_mapper_node.py:191-212: two topics, queue_size=10, slop=0.1 s).
The matching algorithm decides WHICH ping/pose pairs exist — i.e. the map
itself, not just performance (SURVEY.md section 7 hard part 5) — so the
behavioral details below are reproduced exactly:

  * per-topic queues are stamp-keyed dicts: a message with a stamp equal to
    a queued one OVERWRITES it;
  * eviction removes the SMALLEST stamp (not the oldest arrival) whenever a
    queue exceeds ``queue_size``, after each insertion;
  * a set is searched only on arrival, and always contains the newly
    arrived message; candidate partners are every queued stamp with
    ``|delta| <= slop`` (inclusive scan), tried in increasing-delta order
    (ties in arrival order — Python's stable sort over dict iteration);
  * a set fires iff its stamp spread is STRICTLY below slop (so a pair at
    exactly ``slop`` apart never fires, even though it survives the scan);
  * the fired stamps are deleted from their queues; everything else stays
    queued (no head-dropping, no older-than-pair cleanup).

Consequence vs the round-1 approximation: messages are never discarded for
being "stale" — they either pair, get overwritten, or fall off the
queue_size window.  ``flush`` is therefore a no-op: any pair that is valid
at end-of-stream already fired when its later member arrived (the arrival
search is exhaustive over queued partners).

For OFFLINE replay use ``pair_streams`` — it feeds both fully-known streams
through this same synchronizer in stamp order, so offline and live replay
of one bag map identical frame sets.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Tuple

import numpy as np


class ApproximateTimeSync:
    """Streaming two-queue approximate synchronizer (message_filters port).

    ``callback(ping_msg, pose_msg)`` fires exactly when the reference node's
    synchronized_callback would (node:207-212 -> 294).  Messages are any
    objects; stamps are float seconds supplied separately (the upstream uses
    integer nanoseconds; comparisons are identical).
    """

    def __init__(
        self,
        callback: Callable,
        queue_size: int = 10,
        slop: float = 0.1,
    ):
        self.callback = callback
        self.queue_size = queue_size
        self.slop = slop
        # stamp -> msg; dict preserves arrival order for delta-tie breaking
        self.queues: List[Dict[float, object]] = [{}, {}]
        self.dropped = 0  # queue_size evictions + same-stamp overwrites
        # (our addition — the reference cannot distinguish "no data" from
        # "sync failure", SURVEY 5.3)

    def add_ping(self, msg, stamp: float) -> None:
        self._add(0, msg, stamp)

    def add_pose(self, msg, stamp: float) -> None:
        self._add(1, msg, stamp)

    def _add(self, my_queue_index: int, msg, stamp: float) -> None:
        my_queue = self.queues[my_queue_index]
        if stamp in my_queue:
            self.dropped += 1  # overwritten, never paired
        my_queue[stamp] = msg
        while len(my_queue) > self.queue_size:
            del my_queue[min(my_queue)]
            self.dropped += 1

        # candidate stamps per OTHER queue, nearest-first
        search_queues = [
            q for i, q in enumerate(self.queues) if i != my_queue_index
        ]
        stamps = []
        for queue in search_queues:
            topic_stamps = []
            for s in queue:
                delta = abs(s - stamp)
                if delta > self.slop:
                    continue  # inclusive scan: delta == slop stays
                topic_stamps.append((s, delta))
            if not topic_stamps:
                return
            topic_stamps = sorted(topic_stamps, key=lambda x: x[1])
            stamps.append([s for s, _ in topic_stamps])

        for vv in itertools.product(*stamps):
            vv = list(vv)
            vv.insert(my_queue_index, stamp)
            qt = list(zip(self.queues, vv))
            if (max(vv) - min(vv)) < self.slop and all(
                t in q for q, t in qt
            ):
                msgs = [q[t] for q, t in qt]
                for q, t in qt:
                    del q[t]
                self.callback(*msgs)

    def flush(self) -> None:
        """End-of-stream hook: a no-op by construction (see module doc)."""


def pair_streams(
    ping_stamps: np.ndarray,
    pose_stamps: np.ndarray,
    slop: float = 0.1,
    queue_size: int = 10,
) -> List[Tuple[int, int]]:
    """Offline pairing: run the faithful synchronizer over both streams in
    stamp order (pose fed first on equal stamps), returning (ping_index,
    pose_index) pairs in emission order.  Replaying a bag offline therefore
    maps the exact frame set live streaming of the same bag would."""
    ping_stamps = np.asarray(ping_stamps, np.float64)
    pose_stamps = np.asarray(pose_stamps, np.float64)
    pairs: List[Tuple[int, int]] = []
    sync = ApproximateTimeSync(
        lambda a, b: pairs.append((int(a), int(b))), queue_size, slop
    )
    events = sorted(
        [(t, 0, j) for j, t in enumerate(pose_stamps)]
        + [(t, 1, i) for i, t in enumerate(ping_stamps)]
    )
    for t, kind, i in events:
        if kind:
            sync.add_ping(i, t)
        else:
            sync.add_pose(i, t)
    return pairs
