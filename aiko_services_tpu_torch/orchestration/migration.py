"""Drain-free live migration of in-flight requests between replicas.

The port's copy of ``aiko_services_tpu/orchestration/migration.py`` (it
has no JAX in it); its imports point at the port's own modules.

A :class:`MigrationController` rides inside the
:class:`~.serving.ReplicaRouter` and moves ONE live request's decode
stream from a source replica to a destination mid-generation: the
full-head-width KV wire carries the request's chain, the async import
path lands it behind the RESTORING sentinel while the destination keeps
serving, and the router's token-offset dedup is the cutover mechanism
that makes the handoff invisible to the client — zero lost tokens, zero
duplicates, greedy output bit-exact vs an unmigrated control.

Protocol (three phases, each a seeded fault point)::

    prepare    router → source   (migrate_prepare mid reply {request_id})
               source registers the request's LIVE chain — prompt plus
               every committed token, bounded by shareable_blocks — in
               its prefix index, flips its lifecycle to ``migrating``
               (digest ``/migrating`` flag: routers stop scoring it for
               NEW prefix placement), answers (migrate_ready mid swag).
    transfer   router → dest     (infer mid {router}/migrate resume)
               the RESUME request: original prompt + tokens delivered
               so far, remaining generation budget, ``kv_source`` at
               the source — the destination pulls the chain over the
               KV wire and lands it via the async import while its
               other slots keep decoding.  The source KEEPS
               serving the original request: this is the drain-free
               double-delivery window.
    cutover    the destination's first token arrives on the router's
               migrate reply topic → the router cancels the source and
               the token-offset dedup absorbs whatever the source
               delivered in the window (greedy streams are identical
               token-for-token, so count-based dedup is exact).

Failure semantics (chaos-gated by :func:`~..tools.loadgen
.run_migration_chaos` and tests/test_torch_fleet.py):

* source finishes first → migration ABORTS, its terminal forwards
  normally, the destination resume is cancelled.
* destination dies / errors before cutover → ABORT; the source never
  stopped serving, nothing was lost.
* source dies after the resume was dispatched → the destination is
  PROMOTED: its resume already covers the full remaining budget, so
  the stream continues with at most the un-ACKed window re-deduped.
* source dies before the resume was dispatched → ABORT and fall back
  to the plain re-dispatch replay (the router's zero-lost path).

Every decision here is host-side router bookkeeping: no engine, no
traced code, and the only fault site (``stall_cutover``) sits behind
the standard zero-cost ``PLAN is not None`` guard.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from ..pipeline.codec import decode_swag, encode_swag
from ..runtime import faults
from ..utils.sexpr import generate

__all__ = ["MigrationController"]

#: Migration record states, in order.
PREPARE, TRANSFER, CUTOVER = "prepare", "transfer", "cutover"


class MigrationController:
    """Per-router migration table + cutover state machine.

    One instance per :class:`~.serving.ReplicaRouter`; every method
    runs on the router's event thread (no locking).  The record for a
    live migration hangs off the in-flight entry as
    ``entry["migration"]`` — it dies with the entry, so a terminal
    response can never leak a migration."""

    def __init__(self, router):
        self.router = router
        self._seq = 0
        #: migration id -> request id (destination replies carry the
        #: migration id; this maps them back to the client request).
        self._by_mid: Dict[str, str] = {}
        #: completed cutover latencies (ms) — bench/loadgen rigs read
        #: this for p50/p95 without scraping shares.
        self.cutover_ms: List[float] = []

    # -- helpers --------------------------------------------------- #

    def _now(self) -> float:
        return self.router.process.event.now()

    def _publish(self, topic: str, payload: str) -> None:
        self.router.process.message.publish(topic, payload)

    def _record(self, entry: Dict) -> Optional[Dict]:
        return entry.get("migration")

    # -- start ------------------------------------------------------ #

    def start(self, request_id: str, entry: Dict,
              dest: str) -> bool:
        """Begin migrating one in-flight request to ``dest``.  Returns
        False (with no side effects beyond a log line) when the
        request cannot migrate — already migrating, mid prefill leg,
        grammar-constrained (the DFA state cannot transfer), or its
        generation budget is unknown/exhausted."""
        router = self.router
        source = entry.get("replica")
        if source is None or source == dest \
                or entry.get("migration") is not None \
                or entry.get("phase") == "prefill":
            return False
        try:
            inputs = decode_swag(entry["payload"])
        except Exception:  # noqa: BLE001 - undecodable → unmigratable
            return False
        if inputs.get("automaton") is not None:
            # The token-DFA's live state is replica-local; a resume
            # would re-enter the grammar at its start state mid-output.
            router.logger.info(
                "%s: not migrating %s (grammar-constrained)",
                router.name, request_id)
            return False
        budget = inputs.get("max_new_tokens")
        if budget is None \
                or int(np.asarray(budget)) - entry["delivered"] <= 0:
            return False
        self._seq += 1
        mid = f"mg{self._seq}"
        entry["migration"] = dict(
            mid=mid, source=source, dest=dest, state=PREPARE,
            base=0, dest_sent=0, started=self._now(),
            inputs=inputs, kv=False)
        self._by_mid[mid] = request_id
        router._bump("migrations_started")
        self._publish(
            f"{source}/in",
            generate("migrate_prepare",
                     [mid, router.topic_migrate,
                      encode_swag({"request_id": request_id})]))
        router.logger.info("%s: migration %s of %s: %s -> %s",
                           router.name, mid, request_id, source, dest)
        return True

    # -- source prepare reply --------------------------------------- #

    def on_ready(self, mid: str, swag) -> None:
        """``(migrate_ready mid swag)`` from the source: its live
        chain is published (or it told us why not) — dispatch the
        resume to the destination.  An export-incapable source only
        downgrades the resume to a cold recompute; the request is gone
        only on ``migrate_unknown_request``."""
        router = self.router
        request_id = self._by_mid.get(mid)
        entry = router._inflight.get(request_id) \
            if request_id is not None else None
        record = self._record(entry) if entry is not None else None
        if record is None or record["mid"] != mid \
                or record["state"] != PREPARE:
            return
        try:
            outputs = decode_swag(swag)
        except Exception:  # noqa: BLE001 - treat as export-incapable
            outputs = {"error": "migrate_ready_corrupt"}
        error = outputs.get("error")
        if error is not None and str(error) == \
                "migrate_unknown_request":
            # The source no longer holds the request (finished or was
            # cancelled while prepare was in transit): its terminal is
            # on the way through the normal proxy path.
            self.abort(request_id, entry, "source_released")
            return
        record["kv"] = error is None
        if error is None:
            router._bump("migration_blocks_streamed",
                         by=int(np.asarray(outputs.get("blocks", 0))))
        self._dispatch_resume(request_id, entry, record)

    def _dispatch_resume(self, request_id: str, entry: Dict,
                         record: Dict) -> None:
        """Transfer phase: send the destination a resume request —
        original prompt + every token delivered so far, the remaining
        budget, and (when the source could publish its chain) a
        ``kv_source`` hint so the prefix lands over the wire instead
        of recomputing.  Replies arrive on the router's migrate
        topic under the migration id, which is what attributes them
        to the destination during the double-delivery window."""
        router = self.router
        inputs = record["inputs"]
        base = int(entry["delivered"])
        remaining = int(np.asarray(inputs["max_new_tokens"])) - base
        if remaining <= 0:
            self.abort(request_id, entry, "budget_exhausted")
            return
        prompt = np.asarray(inputs["tokens"], np.int32).reshape(-1)
        resume = dict(inputs)
        resume["tokens"] = np.concatenate(
            [prompt, np.asarray(entry["tokens"][:base], np.int32)]) \
            if base else prompt
        resume["max_new_tokens"] = remaining
        for stale in ("trace", "kv_source", "kv_tier_hint",
                      "prefill_only", "kv_migrate"):
            resume.pop(stale, None)
        if record["kv"]:
            resume["kv_source"] = record["source"]
            resume["kv_migrate"] = 1
        record["base"] = base
        record["state"] = TRANSFER
        self._publish(
            f"{record['dest']}/in",
            generate("infer", [record["mid"], router.topic_migrate,
                               encode_swag(resume)]))
        if faults.PLAN is not None:
            params = faults.PLAN.check("stall_cutover",
                                        key=request_id)
            if params is not None:
                # Wedge the router thread inside the double-delivery
                # window: the source keeps decoding and its partials
                # queue up — the offset dedup must absorb all of them
                # when the thread resumes.
                time.sleep(float(params.get("ms", 50)) / 1e3)

    # -- destination stream ----------------------------------------- #

    def on_dest_partial(self, mid: str, swag) -> None:
        """First destination token = CUTOVER: cancel the source and
        hand the entry over.  Every destination partial dedups at
        ``base + dest_sent`` against ``delivered`` — the same offset
        arithmetic re-dispatch replay uses, shifted by the tokens the
        client already had at resume-dispatch time."""
        router = self.router
        request_id = self._by_mid.get(mid)
        entry = router._inflight.get(request_id) \
            if request_id is not None else None
        record = self._record(entry) if entry is not None else None
        if record is None or record["mid"] != mid \
                or record["state"] == PREPARE:
            return
        try:
            increment = [int(t) for t in np.asarray(
                decode_swag(swag)["tokens_out"])]
        except Exception:  # noqa: BLE001 - final is authoritative
            return
        if record["state"] != CUTOVER:
            self._cutover(request_id, entry, record)
        sent = record["dest_sent"]
        record["dest_sent"] = sent + len(increment)
        skip = max(0, entry["delivered"] - (record["base"] + sent))
        fresh = increment[skip:]
        if not fresh:
            return
        entry["delivered"] += len(fresh)
        entry["tokens"].extend(fresh)
        self._publish(
            entry["client_topic"],
            generate("infer_partial",
                     [request_id,
                      encode_swag({"tokens_out":
                                   np.asarray(fresh, np.int32)})]))

    def _cutover(self, request_id: str, entry: Dict,
                 record: Dict) -> None:
        router = self.router
        record["state"] = CUTOVER
        source, dest = record["source"], record["dest"]
        entry["replica"] = dest
        router._routed[request_id] = dest
        if source in router._replicas:
            self._publish(f"{source}/in",
                          generate("infer_cancel", [request_id]))
        elapsed_ms = round((self._now() - record["started"]) * 1e3, 2)
        self.cutover_ms.append(elapsed_ms)
        router._bump("migrations_completed")
        router.share["migration_cutover_ms"] = elapsed_ms
        if router.ec_producer is not None:
            router.ec_producer.update("migration_cutover_ms",
                                      elapsed_ms)
        router.logger.info(
            "%s: migration %s cutover %s -> %s after %.1fms "
            "(%d tokens carried)", router.name, record["mid"],
            source, dest, elapsed_ms, record["base"])

    def on_dest_final(self, mid: str, swag) -> None:
        """Destination terminal: rebuild the client's final token
        stream as ``delivered[:base] + destination tokens`` (the
        resume regenerated everything past base) and close the entry.
        A pre-cutover destination failure aborts instead — the source
        never stopped serving."""
        router = self.router
        request_id = self._by_mid.get(mid)
        entry = router._inflight.get(request_id) \
            if request_id is not None else None
        record = self._record(entry) if entry is not None else None
        if record is None or record["mid"] != mid:
            self._by_mid.pop(mid, None)
            return
        try:
            outputs = decode_swag(swag)
        except Exception:  # noqa: BLE001 - corrupt destination final
            outputs = {"error": "corrupt_response"}
        error = outputs.get("error")
        if record["state"] != CUTOVER:
            if error is not None:
                # Destination failed (or echoed our own abort cancel)
                # before producing a token: the source still serves —
                # nothing was lost, the migration just didn't happen.
                self.abort(request_id, entry, str(error),
                           cancel_dest=False)
                return
            # Non-streaming resume: the terminal IS the first
            # destination delivery — cut over now.
            self._cutover(request_id, entry, record)
        elif error is not None and str(error) != "cancelled":
            # Post-cutover destination failure: clear the migration
            # and let the plain re-dispatch replay recover (replica
            # replay from prompt + offset dedup).
            self._finish(entry, record, aborted=True)
            router._schedule_redispatch(request_id, entry)
            return
        dest_tokens = [int(t) for t in
                       np.asarray(outputs.get("tokens_out",
                                              []), np.int32).reshape(-1)]
        # The client's final stream: what it held at resume-dispatch
        # time plus everything the destination regenerated past it —
        # by greedy determinism identical to the unmigrated stream.
        full = list(entry["tokens"][:record["base"]]) + dest_tokens
        outputs["tokens_out"] = np.asarray(full, np.int32)
        self._finish(entry, record, aborted=False)
        router._inflight.pop(request_id, None)
        payload = generate("infer_response",
                           [request_id, encode_swag(outputs)])
        if entry.get("spans"):
            rebuilt = router._finish_trace(request_id, entry,
                                           encode_swag(outputs))
            if rebuilt is not None:
                payload = rebuilt
        self._publish(entry["client_topic"], payload)

    # -- source stream during the window ----------------------------- #

    def absorb_source_final(self, request_id: str,
                            entry: Dict) -> bool:
        """Called by the router's reply proxy when a terminal arrives
        on the MAIN reply topic for a migrating request (main-topic
        terminals are always the source's — the destination answers
        on the migrate topic).  After cutover the source's terminal —
        the cancel acknowledgement, a natural finish that raced it,
        or even a watchdog error — is SWALLOWED: the destination owns
        the stream.  Before cutover the migration aborts and the
        terminal proceeds normally (returns False)."""
        record = self._record(entry)
        if record is None:
            return False
        if record["state"] == CUTOVER:
            return True
        self.abort(request_id, entry, "source_finished")
        return False

    # -- failure handling -------------------------------------------- #

    def on_owner_lost(self, request_id: str, entry: Dict,
                      replica: str) -> bool:
        """The replica currently OWNING the entry died or went
        unhealthy.  Returns True when the migration machinery handled
        it (destination promoted — skip the re-dispatch), False when
        the caller should re-dispatch as usual."""
        record = self._record(entry)
        if record is None:
            return False
        if replica == record["source"] and record["state"] == TRANSFER:
            # kill_source_mid_migration, resume already dispatched:
            # PROMOTE the destination — its resume covers the full
            # remaining budget, so nothing is lost; tokens the source
            # delivered after dispatch dedup out at base + dest_sent.
            entry["replica"] = record["dest"]
            self.router._routed[request_id] = record["dest"]
            self.router.logger.info(
                "%s: migration %s source %s died mid-transfer — "
                "destination %s promoted", self.router.name,
                record["mid"], replica, record["dest"])
            return True
        # Source died before the resume existed, or the entry's owner
        # IS the destination (post-cutover death): abort and let the
        # plain re-dispatch replay recover.
        self.abort(request_id, entry, f"owner_lost:{replica}",
                   cancel_dest=replica != record["dest"])
        return False

    def on_replica_down(self, replica: str) -> None:
        """Sweep for migrations whose DESTINATION died before cutover
        — their entries still point at the (healthy) source, so the
        router's drain loop never visits them.  Abort each; the
        source never stopped serving."""
        for request_id, entry in list(self.router._inflight.items()):
            record = self._record(entry)
            if record is not None and record["dest"] == replica \
                    and record["state"] != CUTOVER:
                self.abort(request_id, entry,
                           f"dest_lost:{replica}", cancel_dest=False)

    def cancel_dest(self, entry: Dict) -> None:
        """Client-initiated cancel of a migrating request: the router
        forwards the cancel to the owning replica; this forwards it to
        the destination leg too, so neither stream survives."""
        record = self._record(entry)
        if record is not None and record["state"] != PREPARE:
            self._publish(f"{record['dest']}/in",
                          generate("infer_cancel", [record["mid"]]))

    def abort(self, request_id: Optional[str], entry: Optional[Dict],
              reason: str, cancel_dest: bool = True) -> None:
        """Tear one migration down (idempotent).  The source keeps
        serving the original request — aborting a migration never
        touches the primary stream."""
        record = self._record(entry) if entry is not None else None
        if record is None:
            return
        if cancel_dest and record["state"] != PREPARE \
                and record["dest"] in self.router._replicas:
            self._publish(f"{record['dest']}/in",
                          generate("infer_cancel", [record["mid"]]))
        self._finish(entry, record, aborted=True)
        self.router.logger.info("%s: migration %s aborted (%s)",
                                self.router.name, record["mid"],
                                reason)

    def _finish(self, entry: Dict, record: Dict,
                aborted: bool) -> None:
        self._by_mid.pop(record["mid"], None)
        entry["migration"] = None
        if aborted:
            self.router._bump("migrations_aborted")
