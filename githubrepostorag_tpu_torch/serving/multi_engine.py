"""dp engine replicas in one server process behind a prefix-affinity
router; port of ``githubrepostorag_tpu/serving/multi_engine.py``.

``MESH_SHAPE=dp:N`` runs N ``Engine`` replicas, each behind its own
``AsyncEngine`` driver thread, sharing the one loaded weight tree.  The
JAX package gives each replica a disjoint submesh and refuses more
replicas than devices; the port's target is one card, so ``dp_devices``
maps replica i to ``devices[i % len(devices)]``: on one H100 every
replica shares ``cuda:0`` (its own KV pools and workspaces, the same
weights), and on the CPU every replica shares the CPU.  Every replica
launches onto the device's current stream, the default one: kernels B's
and E's arrival counters are one buffer per device (``ops/paged_decode.py``
``_counters``), correct only while the launches sharing them run one at
a time, so no replica gets a stream of its own.  The replicas of one
device also take their engine steps one at a time, under one step lock
(``AsyncEngine.step_lock``): a step is host dispatch, one torch op after
another, each releasing the interpreter lock, and two drivers
dispatching at once hand that lock to each other at every op; on the
card their launches queue on one stream either way.  A driver waiting
for the lock keeps its heartbeat fresh, and ``fence`` hands the fenced
replica's peers a fresh lock, so a replica wedged inside its step stalls
its peers only until the controller fences it.

Routing is prefix-affinity first: the request's chain hashes (the
allocator's page identity, ``serving/chain_hash.py``) are scored against
each replica's published digest and the request goes to the replica with
the longest matchable prefix run, so a shared RAG prefix warms one
replica instead of every one.  With no hit, or with the hit replica more
than ``affinity_slack`` requests deeper than the idlest, the router falls
back to least-loaded weighted by each replica's ledger limiter (a replica
limited by ``hbm_pages`` or ``swap_wait`` is a bad target even with a
short queue), and skips replicas whose circuit breaker is open.  Each
pick's ``router.pick`` event also says whether a hit was passed over for
load (``slack_spill``, which JAX's event lacks).  A
request never migrates once routed, except under ``DISAGG=on``, where it
migrates exactly once: a prefill replica computes the prompt's KV, the
finished pages ship to an affinity-chosen decode replica through
``serving/disagg.py``'s transport, and the request resumes there token
for token (any handoff failure finishes fused on the prefill replica).

Replicas have a lifecycle (active | draining | drained | spare):
``drain`` stops admission, lets in-flight work finish and writes cached
pages back to the host tier; ``activate`` brings a drained replica or a
warm spare into rotation; ``fence`` fails a dead replica's in-flight
requests; ``retire`` force-stops it.  ``/debug/fleet`` and
``/debug/timeline`` render all of it through the SLO plane's router seam
and the timeline's fleet-event seam.

Duck-types AsyncEngine for OpenAIServer: start/stop/stream/generate/
cancel/stats.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import threading
import time
from collections import deque
from typing import Any, AsyncIterator

import torch

from githubrepostorag_tpu_torch import metrics
from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.obs.slo import get_slo_plane
from githubrepostorag_tpu_torch.obs.timeline import set_fleet_events_provider
from githubrepostorag_tpu_torch.obs.trace import NOOP_SPAN, current_span
from githubrepostorag_tpu_torch.resilience.faults import InjectedFault, fire_async
from githubrepostorag_tpu_torch.resilience.policy import get_breaker
from githubrepostorag_tpu_torch.serving.async_engine import AsyncEngine, StreamEvent
from githubrepostorag_tpu_torch.serving.chain_hash import chain_hashes
from githubrepostorag_tpu_torch.serving.disagg import InProcessTransport, assign_roles
from githubrepostorag_tpu_torch.serving.engine import Engine, GenerationResult
from githubrepostorag_tpu_torch.serving.routing import (
    AFFINITY_LOAD_SLACK,
    score_prefix,
    weighted_load,
)
from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams

logger = logging.getLogger(__name__)

_LIFECYCLE_GAUGE = {"active": 0, "draining": 1, "drained": 2, "spare": 3}

DECISIONS = ("affinity_hit", "affinity_miss", "skipped_breaker_open", "skipped_limiter")


def _span():
    """Active flight-recorder span, or the no-op sink outside a trace."""
    return current_span() or NOOP_SPAN


def dp_devices(dp: int, devices=None) -> list[torch.device]:
    """The device of each of ``dp`` replicas: replica i gets
    ``devices[i % len(devices)]`` (default: every visible GPU, else the
    CPU).  Replicas outnumbering the devices share them, where the JAX
    package's ``dp_submeshes`` refuses."""
    if dp < 1:
        raise ValueError(f"dp must be at least 1, got {dp}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)] or ["cpu"]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no devices to place replicas on")
    return [devices[i % len(devices)] for i in range(dp)]


class MultiAsyncEngine:
    """Prefix-affinity fleet router over dp engine replicas.

    Every method runs on the event loop; the cross-thread reads are the
    replicas' ``load()`` and ``ReplicaDigest.snapshot()`` (each under its
    own lock).  ``policy`` pins the routing policy for A/B runs
    ("affinity" | "least_loaded" | "round_robin"); ``spares`` marks the
    last N replicas as warm spares that admit nothing until activated."""

    def __init__(self, engines: list[Engine], *, spares: int = 0,
                 policy: str | None = None) -> None:
        if not engines:
            raise ValueError("need at least one engine")
        if spares >= len(engines):
            raise ValueError("spares must leave at least one active replica")
        # replica ids r0..rN-1: each driver writes its own metric series
        # and registers its own ledger / monitor / digest with the planes
        self._engines = [AsyncEngine(e, replica=f"r{i}") for i, e in enumerate(engines)]
        self._by_id = {ae.replica: ae for ae in self._engines}
        # one step lock for the replicas of each device (module docstring)
        step_locks: dict[Any, threading.Lock] = {}
        for ae in self._engines:
            ae.step_lock = step_locks.setdefault(getattr(ae.engine, "device", None),
                                                 threading.Lock())
        # bounded fleet-event ring for /debug/timeline: router picks,
        # lifecycle transitions, fences (with the failed request ids),
        # handoffs; made before the spares below record into it
        self._timeline_events: deque[dict] = deque(maxlen=512)
        self._route: dict[str, AsyncEngine] = {}
        # in-flight lifecycle operation per replica: a second drain() or
        # activate() awaits the running task instead of racing it
        self._ops: dict[str, asyncio.Task] = {}
        # the controller's actuator for swap_wait: a lower slack abandons
        # a prefix-hot replica sooner
        self.affinity_slack: float = AFFINITY_LOAD_SLACK
        self._ids = itertools.count()
        self._rr = itertools.count()  # round_robin cursor
        self._policy = policy
        # picked-but-not-yet-submitted requests per replica: counted at
        # _pick, retired by AsyncEngine.stream's on_admit
        self._pending: dict[str, int] = {ae.replica: 0 for ae in self._engines}
        self._breakers = {ae.replica: get_breaker(f"replica-{ae.replica}")
                          for ae in self._engines}
        self._decisions = {d: 0 for d in DECISIONS}
        self._routed = {ae.replica: 0 for ae in self._engines}
        self._prefix_hits = {ae.replica: 0 for ae in self._engines}
        self._matched_resident = {ae.replica: 0 for ae in self._engines}
        self._matched_host = {ae.replica: 0 for ae in self._engines}
        for ae in self._engines[len(engines) - spares:]:
            self._set_lifecycle(ae, "spare")
        for ae in self._engines:
            metrics.FLEET_LIFECYCLE.labels(replica=ae.replica).set(
                _LIFECYCLE_GAUGE[ae.lifecycle])
        # the prefill / decode split: roles are set once, here; the
        # handoff counters live with the router, which owns the request
        self._disagg = assign_roles(self._engines, get_settings())
        self._transport = (InProcessTransport(get_settings().disagg_transfer_burst)
                           if self._disagg else None)
        self._handoffs = 0
        self._handoff_pages_shipped = 0
        self._handoff_pages_deduped = 0
        self._handoff_fallbacks: dict[str, int] = {}
        get_slo_plane().set_router_info(self.router_stats)
        set_fleet_events_provider(lambda: list(self._timeline_events))

    def _tl(self, kind: str, **attrs: Any) -> None:
        ev = {"t": time.monotonic(), "kind": kind}
        ev.update(attrs)
        self._timeline_events.append(ev)

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        for eng in self._engines:
            if eng.lifecycle != "spare":
                await eng.start()

    async def stop(self) -> None:
        for eng in self._engines:
            await eng.stop()

    def _set_lifecycle(self, ae: AsyncEngine, state: str) -> None:
        ae.lifecycle = state
        metrics.FLEET_LIFECYCLE.labels(replica=ae.replica).set(_LIFECYCLE_GAUGE[state])
        self._tl("fleet.lifecycle", replica=ae.replica, state=state)

    def _in_flight(self, ae: AsyncEngine) -> int:
        return ae.load() + self._pending.get(ae.replica, 0)

    async def _lifecycle_op(self, replica: str, verb: str, impl) -> dict[str, Any]:
        """Serialize lifecycle verbs per replica and make repeats no-ops: a
        second ``drain`` (or ``activate``) while one runs awaits the same
        task and returns its result; an opposing verb queues behind the
        running one.  Shielded, so one cancelled caller cannot abort the
        shared operation."""
        name = f"{verb}-{replica}"
        while True:
            op = self._ops.get(replica)
            if op is None or op.done():
                break
            if op.get_name() == name:
                return await asyncio.shield(op)
            try:
                await asyncio.shield(op)
            except Exception:  # noqa: BLE001 - the first caller surfaces it
                pass
        task = asyncio.get_running_loop().create_task(impl(), name=name)
        self._ops[replica] = task
        return await asyncio.shield(task)

    async def drain(self, replica: str) -> dict[str, Any]:
        """Stop admitting on ``replica``, let in-flight requests finish,
        then write cached pages back to the host tier.  Resolves even if
        the replica dies mid-drain (seam ``fleet.drain``): the corpse is
        force-stopped and counts as drained.  A concurrent drain of the
        same replica joins this one."""
        ae = self._by_id[replica]
        return await self._lifecycle_op(replica, "drain", lambda: self._drain_impl(ae))

    async def _drain_impl(self, ae: AsyncEngine) -> dict[str, Any]:
        replica = ae.replica
        if ae.lifecycle == "drained":
            return {"replica": replica, "lifecycle": "drained", "waited": 0}
        self._set_lifecycle(ae, "draining")
        span = _span()
        span.add_event("fleet.drain", replica=replica)
        waited = 0
        try:
            await fire_async("fleet.drain")
            while self._in_flight(ae) > 0:
                waited += 1
                await asyncio.sleep(0.01)
                await fire_async("fleet.drain")
            # the writeback is engine state: under the driver lock, off-loop
            await asyncio.get_running_loop().run_in_executor(
                None, self._writeback_host_tier, ae)
        except InjectedFault as exc:
            self._breakers[replica].record_failure()
            span.add_event("fleet.drain.fault", replica=replica, error=str(exc))
            await ae.stop()
            self._set_lifecycle(ae, "drained")
            return {"replica": replica, "lifecycle": "drained", "waited": waited,
                    "fault": str(exc)}
        self._set_lifecycle(ae, "drained")
        return {"replica": replica, "lifecycle": "drained", "waited": waited}

    def _writeback_host_tier(self, ae: AsyncEngine) -> None:
        with ae._lock:
            if getattr(ae.engine, "_kv_tier_on", False):
                # the whole LRU into the host pool (to its cap), every
                # migration landed
                ae.engine.flush_kv_migrations()

    async def activate(self, replica: str) -> dict[str, Any]:
        """Bring a warm spare or a drained replica (back) into rotation.
        Activating an active replica is a no-op; a concurrent activate
        joins this one."""
        ae = self._by_id[replica]
        return await self._lifecycle_op(replica, "activate", lambda: self._activate_impl(ae))

    async def _activate_impl(self, ae: AsyncEngine) -> dict[str, Any]:
        replica = ae.replica
        if ae.lifecycle == "active" and ae.driver_alive():
            return {"replica": replica, "lifecycle": "active"}
        self._set_lifecycle(ae, "active")
        await ae.start()
        _span().add_event("fleet.activate", replica=replica)
        return {"replica": replica, "lifecycle": "active"}

    async def fence(self, replica: str) -> dict[str, Any]:
        """Isolate a dead or wedged replica: stop admission (lifecycle ->
        draining, so ``_pick`` skips it) and fail its in-flight work with
        the standard error frame, so callers can retry through the router
        instead of waiting on a driver that will never step again.  Never
        waits on the victim, nor lets its peers wait on its step lock."""
        ae = self._by_id[replica]
        if ae.lifecycle in ("active", "spare"):
            self._set_lifecycle(ae, "draining")
        # a victim wedged inside its step holds its device's step lock:
        # its peers (and a spare activated in its place) take a fresh one
        held, fresh = ae.step_lock, threading.Lock()
        for peer in self._engines:
            if peer.step_lock is held:
                peer.step_lock = fresh
        failed = ae.fail_in_flight(f"replica {replica} fenced by fleet controller")
        for rid in failed:
            self._route.pop(rid, None)
        self._breakers[replica].record_failure()
        _span().add_event("fleet.fence", replica=replica, failed=len(failed))
        # the failed ids ride the event (capped) so the timeline marks each
        # on the dead replica's track
        self._tl("fleet.fence", replica=replica, failed=len(failed),
                 failed_requests=failed[:32])
        return {"replica": replica, "lifecycle": ae.lifecycle, "failed": len(failed)}

    async def retire(self, replica: str) -> dict[str, Any]:
        """Force-stop a fenced corpse without waiting for in-flight work
        (``fence`` already failed it)."""
        ae = self._by_id[replica]
        await ae.stop()
        self._set_lifecycle(ae, "drained")
        _span().add_event("fleet.retire", replica=replica)
        return {"replica": replica, "lifecycle": "drained"}

    def replicas(self) -> list[AsyncEngine]:
        """The fleet's AsyncEngine rows (the controller's sense loop reads
        lifecycle, heartbeat and driver_alive off them)."""
        return list(self._engines)

    def spare_replicas(self) -> list[str]:
        return [ae.replica for ae in self._engines if ae.lifecycle == "spare"]

    def set_affinity_slack(self, slack: float) -> float:
        """The controller's swap_wait actuator: set the affinity slack,
        floored at 0.5 so affinity never degrades into least-loaded."""
        self.affinity_slack = max(0.5, float(slack))
        return self.affinity_slack

    # ------------------------------------------------------------- routing

    def _affinity_enabled(self) -> bool:
        if self._policy == "affinity":
            return True
        if self._policy in ("least_loaded", "round_robin"):
            return False
        mode = get_settings().route_affinity
        if mode == "on":
            return True
        if mode == "off":
            return False
        # auto: affinity iff any replica can serve a prefix hit
        return any(hasattr(ae.engine._allocator, "resident_chain_hashes")
                   for ae in self._engines)

    def _pick(self, prompt_ids: list[int],
              roles: tuple[str, ...] | None = None) -> tuple[AsyncEngine, bool]:
        """Choose a replica; returns (target, breaker_granted).

        Ranking first, breaker second: ``allow()`` consumes the single
        half-open probe, so only the replica about to be used is asked.
        ``roles`` restricts the candidates under disaggregation; with no
        replica of the wanted role left, any active replica serves fused."""
        cands = [ae for ae in self._engines if ae.lifecycle == "active"
                 and (roles is None or ae.role in roles)]
        if not cands and roles is not None:
            cands = [ae for ae in self._engines if ae.lifecycle == "active"]
        if not cands:
            raise RuntimeError("no active replicas (all drained or spare)")

        decision = None
        spill = False  # a prefix hit passed over for load (the slack)
        matched = {}
        if self._policy == "round_robin":
            ranked = [cands[next(self._rr) % len(cands)]]
            ranked += [ae for ae in cands if ae is not ranked[0]]
        elif self._affinity_enabled():
            min_pages = get_settings().route_min_prefix_pages
            hashes_by_ps: dict[int, list[bytes]] = {}
            scored = []
            for ae in cands:
                ps = ae.engine.page_size
                if ps not in hashes_by_ps:
                    hashes_by_ps[ps] = chain_hashes(prompt_ids, ps)
                res, hst, score = score_prefix(hashes_by_ps[ps], *ae.digest.snapshot())
                matched[ae.replica] = (res, hst)
                scored.append((ae, res + hst, score))
            hits = [t for t in scored if t[1] >= max(1, min_pages)]
            if hits:
                # longest weighted run wins; ties go to the lighter replica
                ranked = [t[0] for t in sorted(hits, key=lambda t: (-t[2], self._load(t[0])))]
                floor = min(self._load(ae) for ae in cands)
                if self._load(ranked[0]) - floor > self.affinity_slack:
                    # the hit replica is saturated: the queue wait behind
                    # the burst costs more than the saved prefill
                    decision, spill = "affinity_miss", True
                    ranked = self._rank_fallback(cands)
                else:
                    decision = "affinity_hit"
                    ranked += [ae for ae in cands if ae not in ranked]
            else:
                decision = "affinity_miss"
                ranked = self._rank_fallback(cands)
        else:
            ranked = self._rank_fallback(cands)

        target, granted = ranked[0], False
        for ae in ranked:
            if self._breakers[ae.replica].allow():
                target, granted = ae, True
                break
            self._count("skipped_breaker_open")
        # every breaker refused: fail open to the best-ranked replica (a
        # fleet-wide outage degrades to normal routing, not an error)

        if decision is not None:
            self._count(decision)
        self._routed[target.replica] += 1
        metrics.ROUTER_ROUTED.labels(replica=target.replica).inc()
        res, hst = matched.get(target.replica, (0, 0))
        if res + hst > 0:
            self._prefix_hits[target.replica] += 1
            self._matched_resident[target.replica] += res
            self._matched_host[target.replica] += hst
            if res:
                metrics.ROUTER_PREFIX_PAGES.labels(replica=target.replica, tier="resident").inc(res)
            if hst:
                metrics.ROUTER_PREFIX_PAGES.labels(replica=target.replica, tier="host").inc(hst)
        attrs = dict(replica=target.replica, decision=decision or self._policy or "least_loaded",
                     resident_pages=res, host_pages=hst, breaker_granted=granted,
                     slack_spill=spill)
        _span().add_event("router.pick", **attrs)
        self._tl("router.pick", **attrs)
        return target, granted

    def _load(self, ae: AsyncEngine) -> float:
        """Load in request units: queue depth, picks not yet submitted, and
        claimed-but-unregistered prefill pages (as sequences), so a burst
        of simultaneous admissions does not all land on one replica that
        still looks idle."""
        e = ae.engine
        load = float(ae.load() + self._pending.get(ae.replica, 0))
        claim_fn = getattr(e._allocator, "pending_claim_pages", None)
        if callable(claim_fn):
            pages_per_seq = max(1, e.max_seq_len // max(1, e.page_size))
            load += claim_fn() / pages_per_seq
        return load

    def _rank_fallback(self, cands: list[AsyncEngine]) -> list[AsyncEngine]:
        """Least-loaded weighted by the ledger's limiter attribution."""
        raw = min(cands, key=self._load)
        ranked = sorted(cands, key=lambda ae: weighted_load(self._load(ae),
                                                             ae.ledger.current_limiter()))
        if ranked[0] is not raw:
            # the shortest queue was passed over: its limiter says
            # admissions there stall on pages or swap, not compute
            self._count("skipped_limiter")
        return ranked

    def _count(self, decision: str) -> None:
        self._decisions[decision] += 1
        metrics.ROUTER_DECISIONS.labels(decision=decision).inc()

    # ------------------------------------------------------------- serving

    async def stream(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        request_id: str | None = None,
        deadline_s: float | None = None,
        priority: str | None = None,
    ) -> AsyncIterator[StreamEvent]:
        # engines would mint per-engine ids; a fleet-unique one instead
        rid = request_id or f"mreq-{next(self._ids)}"
        priority = priority or getattr(self._engines[0].engine, "default_priority",
                                       "interactive")
        if self._disagg:
            events = self._stream_disagg(prompt_ids, sampling, rid, deadline_s, priority)
        else:
            target, granted = self._pick(prompt_ids)
            events = self._stream_on(target, granted, prompt_ids, sampling, rid, deadline_s,
                                     priority)
        async for event in events:
            yield event

    async def _stream_on(
        self,
        target: AsyncEngine,
        granted: bool,
        prompt_ids: list[int],
        sampling: SamplingParams | None,
        rid: str,
        deadline_s: float | None,
        priority: str,
    ) -> AsyncIterator[StreamEvent]:
        """Run ``rid`` on the picked ``target``, owning the route map, the
        pending claim and the breaker bookkeeping end to end."""
        self._route[rid] = target
        self._pending[target.replica] += 1
        admitted = False

        def on_admit(_rid: str) -> None:
            nonlocal admitted
            if not admitted:
                admitted = True
                self._pending[target.replica] -= 1

        breaker = self._breakers[target.replica]
        recorded = False
        try:
            async for event in target.stream(prompt_ids, sampling, request_id=rid,
                                             deadline_s=deadline_s, priority=priority,
                                             on_admit=on_admit):
                if event.type == "final":
                    # settle breaker and route at the final token, not in
                    # the finally below: generator finalization is deferred
                    if granted and not recorded:
                        recorded = True
                        breaker.record_success()
                    self._route.pop(rid, None)
                yield event
        except Exception:
            if granted and not recorded:
                recorded = True
                breaker.record_failure()
            raise
        finally:
            # an abandoned stream is the caller's choice, not a replica
            # fault, and a granted half-open probe must resolve
            if granted and not recorded:
                breaker.record_success()
            if not admitted:
                on_admit(rid)
            self._route.pop(rid, None)

    async def generate(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None = None,
        request_id: str | None = None,
        deadline_s: float | None = None,
        priority: str | None = None,
    ) -> GenerationResult:
        async for event in self.stream(prompt_ids, sampling, request_id, deadline_s=deadline_s,
                                       priority=priority):
            if event.type == "final":
                return event.result
        raise RuntimeError("stream ended without a final event")  # pragma: no cover

    async def cancel(self, request_id: str) -> None:
        target = self._route.get(request_id)
        if target is not None:
            await target.cancel(request_id)

    # ------------------------------------------------------ disagg handoff

    async def _stream_disagg(
        self,
        prompt_ids: list[int],
        sampling: SamplingParams | None,
        rid: str,
        deadline_s: float | None,
        priority: str,
    ) -> AsyncIterator[StreamEvent]:
        """Prefill on a prefill replica, ship the KV, decode elsewhere.

        The prefill pass is a one-token greedy request whose token is
        dropped: the full prefix pages it leaves in the prefill replica's
        cache are the product.  The decode replica admits the original
        request against the shipped pages (``share`` and the fault-in
        scatters), recomputes only the tail page and emits every token the
        fused path would have.  Any failure before the decode replica has
        emitted anything finishes the request fused on the prefill
        replica, whose cache holds the whole prefix."""
        # a disagg fleet is one page size (assign_roles needs every replica
        # tiered), so these chain hashes are the identity on both ends
        ps = self._engines[0].engine.page_size
        # only full pages ship: the tail page (and the page the prompt's
        # last token lands on) is recomputed by the decode replica, the
        # cap share() itself applies
        shippable = max(0, (len(prompt_ids) - 1) // ps)
        if shippable == 0:
            # nothing a peer could reuse: a decode replica prefills itself
            target, tgrant = self._pick(prompt_ids, roles=("decode",))
            async for event in self._stream_on(target, tgrant, prompt_ids, sampling, rid,
                                               deadline_s, priority):
                yield event
            return
        pre, granted = self._pick(prompt_ids, roles=("prefill",))
        if pre.role != "prefill":
            # the prefill tier is gone and _pick fell back: serve fused
            async for event in self._stream_on(pre, granted, prompt_ids, sampling, rid,
                                               deadline_s, priority):
                yield event
            return
        hashes = chain_hashes(prompt_ids, ps)[:shippable]

        pre_sampling = SamplingParams(temperature=0.0, max_tokens=1)
        final = None
        try:
            async for event in self._stream_on(pre, granted, prompt_ids, pre_sampling,
                                               f"{rid}-pre", deadline_s, priority):
                if event.type == "final":
                    final = event.result
        except Exception as exc:
            # the prefill replica itself failed: retry fused anywhere
            self._handoff_fallback("prefill_error")
            _span().add_event("disagg.prefill.fault", error=str(exc))
            target, tgrant = self._pick(prompt_ids)
            async for event in self._stream_on(target, tgrant, prompt_ids, sampling, rid,
                                               deadline_s, priority):
                yield event
            return
        if final is None or final.finish_reason == "deadline":
            # reaped mid-pass: the fused path gives the deadline result
            self._handoff_fallback("prefill_deadline")
            async for event in self._fallback_fused(pre, prompt_ids, sampling, rid,
                                                    deadline_s, priority):
                yield event
            return

        dest, dgrant = self._pick_decode(hashes)
        if dest is None:
            self._handoff_fallback("no_decode_replica")
            async for event in self._fallback_fused(pre, prompt_ids, sampling, rid,
                                                    deadline_s, priority):
                yield event
            return

        # ship only what the destination cannot already serve
        res, hst = dest.digest.snapshot()
        need = [h for h in hashes if h not in res and h not in hst]
        try:
            exported, stored = await self._transport.transfer(pre, dest, need)
        except Exception as exc:  # InjectedFault or a dead peer
            if dgrant:
                # the granted half-open probe must resolve (cf. _stream_on)
                self._breakers[dest.replica].record_failure()
            self._handoff_fallback("transfer_error")
            _span().add_event("disagg.transfer.fault", decode=dest.replica, error=str(exc))
            async for event in self._fallback_fused(pre, prompt_ids, sampling, rid,
                                                    deadline_s, priority):
                yield event
            return

        deduped = (len(hashes) - len(need)) + (exported - stored)
        self._handoffs += 1
        self._handoff_pages_shipped += stored
        self._handoff_pages_deduped += deduped
        metrics.DISAGG_HANDOFFS.labels(outcome="shipped").inc()
        if stored:
            metrics.DISAGG_PAGES.labels(kind="shipped").inc(stored)
        if deduped:
            metrics.DISAGG_PAGES.labels(kind="deduped").inc(deduped)
        _span().add_event("disagg.handoff", prefill=pre.replica, decode=dest.replica,
                          shipped=stored, deduped=deduped)
        self._tl("disagg.handoff", prefill=pre.replica, decode=dest.replica,
                 shipped=stored, deduped=deduped)

        yielded = False
        parked = False
        try:
            async for event in self._stream_on(dest, dgrant, prompt_ids, sampling, rid,
                                               deadline_s, priority):
                if event.type == "parked" and not yielded:
                    # preempted before its first token: cancel it there and
                    # finish fused on the prefill replica, which holds the
                    # prefix hot.  Once tokens flowed a park is latency only
                    parked = True
                    break
                yielded = True
                yield event
            if not parked:
                return
            await dest.cancel(rid)
            self._handoff_fallback("preempted")
        except Exception:
            if yielded:
                # tokens reached the caller: a replay would duplicate them
                raise
            self._handoff_fallback("decode_error")
        async for event in self._fallback_fused(pre, prompt_ids, sampling, rid, deadline_s,
                                                priority):
            yield event

    async def _fallback_fused(self, pre: AsyncEngine, prompt_ids, sampling, rid, deadline_s,
                              priority) -> AsyncIterator[StreamEvent]:
        """Finish ``rid`` fused on the prefill replica that holds its
        prefix (the handoff's escape hatch)."""
        granted = self._breakers[pre.replica].allow()
        async for event in self._stream_on(pre, granted, prompt_ids, sampling, rid,
                                           deadline_s, priority):
            yield event

    def _pick_decode(self, hashes: list[bytes]) -> tuple[AsyncEngine | None, bool]:
        """Decode-side target: longest matchable run of the shipped hashes
        first, then limiter-weighted load, breaker last (failing open);
        (None, False) only when no decode replica is active."""
        cands = [ae for ae in self._engines if ae.lifecycle == "active" and ae.role == "decode"]
        if not cands:
            return None, False

        def key(ae: AsyncEngine) -> tuple[float, float]:
            _, _, score = score_prefix(hashes, *ae.digest.snapshot())
            return (-score, weighted_load(self._load(ae), ae.ledger.current_limiter()))

        ranked = sorted(cands, key=key)
        target, granted = ranked[0], False
        for ae in ranked:
            if self._breakers[ae.replica].allow():
                target, granted = ae, True
                break
            self._count("skipped_breaker_open")
        self._routed[target.replica] += 1
        metrics.ROUTER_ROUTED.labels(replica=target.replica).inc()
        self._tl("router.pick_decode", replica=target.replica, breaker_granted=granted)
        return target, granted

    def _handoff_fallback(self, reason: str) -> None:
        self._handoff_fallbacks[reason] = self._handoff_fallbacks.get(reason, 0) + 1
        metrics.DISAGG_HANDOFFS.labels(outcome=f"fallback_{reason}").inc()
        _span().add_event("disagg.fallback", reason=reason)
        self._tl("disagg.fallback", reason=reason)

    def disagg_stats(self) -> dict[str, Any]:
        """Handoff counts and the role census (router_stats and
        /debug/fleet render this)."""
        return {
            "enabled": self._disagg,
            "prefill_replicas": [ae.replica for ae in self._engines if ae.role == "prefill"],
            "decode_replicas": [ae.replica for ae in self._engines if ae.role == "decode"],
            "handoffs": self._handoffs,
            "pages_shipped": self._handoff_pages_shipped,
            "pages_deduped": self._handoff_pages_deduped,
            "fallbacks": dict(self._handoff_fallbacks),
            "transport": self._transport.payload() if self._transport is not None else None,
        }

    # ------------------------------------------------------------- reading

    def router_stats(self) -> dict[str, Any]:
        """Decision counters and the per-replica routing view (stats(), the
        SLO plane's fleet payload and /debug/fleet render this)."""
        per = {}
        for ae in self._engines:
            r = ae.replica
            routed = self._routed[r]
            per[r] = {
                "lifecycle": ae.lifecycle,
                "role": ae.role,
                "routed": routed,
                "prefix_hit_rate": self._prefix_hits[r] / max(1, routed),
                "matched_resident_pages": self._matched_resident[r],
                "matched_host_pages": self._matched_host[r],
                "pending": self._pending[r],
                "breaker": self._breakers[r].state,
                "digest": ae.digest.payload(),
            }
        return {
            "policy": self._policy or get_settings().route_affinity,
            "affinity_slack": self.affinity_slack,
            "decisions": dict(self._decisions),
            "per_replica": per,
            "disagg": self.disagg_stats(),
        }

    @staticmethod
    def _merge_rows(rows: list[dict], mean_rows: list[dict] | None = None) -> dict[str, Any]:
        """Union of keys; numbers merge across replicas: counters sum,
        rate / ratio / utilization keys average (over ``mean_rows`` when
        given: the fleet passes the decode-capable replicas, so a prefill
        replica's idle decode rates do not drag the means).  Other values
        stay under per_replica."""
        mean_rows = rows if mean_rows is None else mean_rows
        keys = sorted(set().union(*(s.keys() for s in rows))) if rows else []
        merged: dict[str, Any] = {}
        for key in keys:
            is_mean = key.endswith(("_rate", "_ratio", "_utilization"))
            nums = [s[key] for s in (mean_rows if is_mean else rows)
                    if isinstance(s.get(key), (int, float)) and not isinstance(s.get(key), bool)]
            if nums:
                merged[key] = sum(nums) / len(nums) if is_mean else sum(nums)
        return merged

    def stats(self) -> dict[str, Any]:
        per = [eng.stats() for eng in self._engines]
        roles = [s.get("role", "fused") for s in per]
        # prefill replicas never decode: the mean-merged keys leave them out
        decodeish = [s for s, r in zip(per, roles) if r != "prefill"] or per
        merged = self._merge_rows(per, mean_rows=decodeish)
        merged["replicas"] = len(per)
        merged["per_replica"] = per
        if getattr(self, "_disagg", False):
            by_role: dict[str, list[dict]] = {}
            for s, r in zip(per, roles):
                by_role.setdefault(r, []).append(s)
            merged["per_role"] = {r: self._merge_rows(rows) for r, rows in by_role.items()}
        if hasattr(self, "_decisions"):  # absent on bare merge-rule stubs
            merged["router"] = self.router_stats()
        return merged

    def fleet(self) -> dict[str, Any]:
        """The pod at a glance: per-replica ledgers, SLO states and router
        decisions through the process SLO plane (GET /debug/fleet's
        payload)."""
        return get_slo_plane().fleet_payload()
