"""Lockstep of a serving mesh's ranks: one engine a rank, the same host
decisions on every rank.

JAX drives a mesh from one process.  The port runs one process a device
(``parallel/mesh.py``), and every rank builds the same ``Engine`` over its
own slices.  Each forward issues collectives that every rank of a group
must join, so every rank must take the same decisions in the same order:
admission, block tables, prefill and ring widths, burst lengths, reaps and
the sampling generator's draws (same seed everywhere; the logits are whole
on every rank, so the draws give the same tokens).  The engine's decisions
are functions of its state, except what reads the clock or the outside:
requests, cancellations, the SLO plane's class pressure and the deadline
clock.  Those are taken on rank 0, whose ``AsyncEngine`` driver is the
``Leader``: before each step it broadcasts what it applied since the last
one (as data), the pressure it set and its ``time.monotonic()`` reading,
then steps with that reading.  The other ranks run ``follow``: apply the
same, step with the same clock.

The messages travel over a gloo group of the whole world (``control_group``,
made collectively on every rank), so a world on NCCL needs no device
round trip for them.  An idle leader sends an empty message every
``IDLE_S`` seconds, so a follower's wait never reaches the group's timeout
while rank 0 lives; a rank that raises leaves its peers' next collective
to fail at that finite timeout (``parallel/distributed.py``), and the
world goes down instead of hanging.
"""

from __future__ import annotations

import logging
import time

import torch.distributed as dist

from githubrepostorag_tpu_torch.parallel.distributed import group_timeout

logger = logging.getLogger(__name__)

IDLE_S = 1.0  # the leader's longest silence


def control_group(ranks: list[int] | None = None):
    """The gloo group of the lockstep messages over ``ranks`` (the whole
    world by default; the leader is the first); every rank of the world
    calls this, in the same order as its other group creations."""
    return dist.new_group(ranks=ranks, backend="gloo", timeout=group_timeout())


class Leader:
    """Rank 0's side: ``AsyncEngine.lockstep``.  ``publish`` runs on the
    driver thread before each step."""

    def __init__(self, group) -> None:
        self.group = group
        self.messages = 0
        self._last = time.monotonic()

    def _send(self, msg: dict) -> None:
        dist.broadcast_object_list([msg], group_src=0, group=self.group)
        self.messages += 1
        self._last = time.monotonic()

    def publish(self, applied: list[tuple], pressure: dict | None, now: float,
                step: bool) -> None:
        """Send what the followers must apply before this step: ``applied``
        (("add", prompt, sampling, id, deadline, priority) or ("cancel",
        id)), the class ``pressure`` set this iteration (or None), the clock
        ``now`` and whether the engine steps.  An idle iteration with nothing
        to say sends nothing, unless ``IDLE_S`` passed."""
        if not (applied or pressure or step) and time.monotonic() - self._last < IDLE_S:
            return
        self._send({"ops": applied, "pressure": pressure, "now": now, "step": step})

    def close(self) -> None:
        """Tell the followers to return (after the driver stopped)."""
        try:
            self._send({"stop": True})
        except Exception:  # noqa: BLE001 - a follower already gone: nothing to tell
            logger.exception("lockstep: the stop message did not reach every rank")


def follow(engine, group) -> int:
    """A follower rank's loop: apply rank 0's operations to ``engine`` in
    its order and step with its clock, until its stop message.  Returns the
    steps taken; raises what the engine raised (the process then exits and
    its peers' next collective fails at the group timeout)."""
    steps = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, group_src=0, group=group)
        msg = box[0]
        if msg.get("stop"):
            return steps
        for op in msg["ops"]:
            try:
                apply_op(engine, op)
            except Exception:  # noqa: BLE001 - rank 0 reports it to the caller
                logger.exception("lockstep: %s refused", op[0])
        if msg["pressure"] is not None:
            engine.set_class_pressure(msg["pressure"])
        if msg["step"]:
            engine.step(now=msg["now"])
            steps += 1


def apply_op(engine, op: tuple, on_token=None) -> None:
    """One inbox operation on ``engine``: ("add", prompt, sampling, id,
    deadline, priority) or ("cancel", id).  Rank 0's ``AsyncEngine`` runs
    its inbox through this (``on_token``: its stream's sink) and the
    followers run the leader's operations through it, so every rank applies
    the same data the same way.  What the engine refuses raises on every
    rank alike; rank 0 ends that request with the error."""
    if op[0] == "add":
        _, prompt, sampling, rid, deadline_s, priority = op
        engine.add_request(prompt, sampling, on_token=on_token, request_id=rid,
                           deadline_s=deadline_s, priority=priority)
    elif op[0] == "cancel":
        engine.cancel(op[1])
    else:
        raise ValueError(f"unknown lockstep operation {op[0]!r}")
