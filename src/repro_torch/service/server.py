"""Service front end: tenant admission control over the query scheduler.

``FilterService`` is the deployable face of one session: it owns the
scheduler, a ``SessionStore`` for checkpoint/restore, and per-tenant
oracle budgets.  A tenant registers with an ``ExecutionPolicy`` whose
``max_oracle_calls`` is read as the tenant's AGGREGATE budget: every
submission's closed-form worst-case estimate (``Query.worst_case_calls``,
zero oracle calls to compute, memo-aware — replayable queries reserve ~0)
is reserved against it, and ``gather`` settles reservations to actual
spend.  A submission whose reservation would overflow the remaining
budget is rejected up front with ``TenantBudgetError`` — no partial
execution, no oracle calls.  The per-query ``max_oracle_calls`` pre-flight
inside ``collect()`` still applies on top (a single runaway query is
rejected even under an ample tenant budget).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from repro_torch.api.policy import ExecutionPolicy, OracleBudgetError
from repro_torch.obs.trace import get_tracer
from repro_torch.service.scheduler import QueryTicket
from repro_torch.service.store import RestoreReport, SessionStore


class TenantBudgetError(OracleBudgetError):
    """A submission's worst-case estimate overflows the tenant's
    aggregate ``max_oracle_calls`` budget."""


@dataclasses.dataclass
class TenantAccount:
    """Aggregate oracle accounting for one tenant."""
    name: str
    policy: ExecutionPolicy
    reserved: float = 0.0      # worst-case estimates of in-flight queries
    spent: int = 0             # actual calls of settled queries
    n_admitted: int = 0
    n_rejected: int = 0

    @property
    def budget(self) -> Optional[int]:
        return self.policy.max_oracle_calls

    @property
    def remaining(self) -> Optional[float]:
        if self.budget is None:
            return None
        return self.budget - self.spent - self.reserved


class FilterService:
    """Concurrent multi-tenant semantic-filter service over one Session.

        service = FilterService(session, store_dir="/var/lib/csv")
        service.register_tenant("alice", ExecutionPolicy(
            n_clusters=4, max_oracle_calls=10_000))
        t1 = service.submit("alice", table.filter("positive"))
        t2 = service.submit("alice", table.filter("spam") & ...)
        r1, r2 = service.gather(t1, t2)   # settles alice's budget
        service.checkpoint()              # restartable: see store.py
    """

    def __init__(self, session, store_dir=None, log_dir=None):
        if store_dir is not None and log_dir is not None:
            raise ValueError("pass store_dir (whole-session snapshots) OR "
                             "log_dir (append-only log), not both")
        if log_dir is None:
            log_dir = session.policy.log_dir
        self.session = session
        self.store = SessionStore(store_dir) if store_dir is not None \
            else None
        self.log = None
        if log_dir is not None:
            from repro_torch.service.log import SessionLogStore
            self.log = SessionLogStore(
                log_dir,
                compact_bytes=session.policy.log_compact_bytes,
                compact_records=session.policy.log_compact_records)
            if not self.log.exists():
                # fresh directory: start recording now; with prior state
                # the caller decides when to restore() (it must register
                # tables/oracles first), and restore() attaches after
                self.log.attach(session)
        self._tenants: Dict[str, TenantAccount] = {}
        # idempotent settlement closures of in-flight tickets, by index;
        # each removes itself once run (done-callback or gather)
        self._settlers: Dict[int, object] = {}
        # admission is check-then-reserve: concurrent submits/settlements
        # for one tenant must serialize or both could fit a budget that
        # only holds one of them
        self._lock = threading.Lock()

    @property
    def scheduler(self):
        # read through the session every time: Session.close() retires its
        # scheduler and a later submit builds a fresh one — a cached
        # reference would keep pointing at the closed instance
        return self.session.scheduler

    # ------------------------------------------------------------- tenants
    def register_tenant(self, name: str,
                        policy: Optional[ExecutionPolicy] = None
                        ) -> TenantAccount:
        """Admit a tenant.  ``policy`` is its default execution policy AND
        its budget: ``policy.max_oracle_calls`` caps the tenant's aggregate
        reserved+spent oracle calls (None = unmetered)."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        acct = TenantAccount(name=name,
                             policy=policy or self.session.policy)
        self._tenants[name] = acct
        return acct

    def tenant(self, name: str) -> TenantAccount:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r}; register_tenant() "
                           "first") from None

    # ------------------------------------------------------------- queries
    def submit(self, tenant: str, query,
               policy: Optional[ExecutionPolicy] = None,
               label: Optional[str] = None) -> QueryTicket:
        """Admission-checked submit.  Resolution order for the effective
        policy: explicit ``policy`` > the query's own > the tenant's."""
        acct = self.tenant(tenant)
        pol = policy or getattr(query, "policy", None) or acct.policy
        est = query.worst_case_calls(pol)
        with self._lock:
            if acct.budget is not None and \
                    acct.spent + acct.reserved + est > acct.budget:
                acct.n_rejected += 1
                raise TenantBudgetError(
                    f"tenant {tenant!r}: worst-case {est:.0f} calls do not "
                    f"fit the remaining budget ({acct.remaining:.0f} of "
                    f"{acct.budget}; {acct.spent} spent, "
                    f"{acct.reserved:.0f} reserved)")
            acct.reserved += est
            acct.n_admitted += 1
            self._export_budget_gauge_locked()
        try:
            ticket = self.scheduler.submit(query, policy=pol,
                                           label=label or f"{tenant}/q")
        except BaseException:
            with self._lock:   # submission failed: hand the budget back
                acct.reserved = max(0.0, acct.reserved - est)
                acct.n_admitted -= 1
            raise

        settled = [False]

        def _settle(future):
            # settlement rides on query COMPLETION, not on gather(): a
            # client consuming the ticket via result() must still free the
            # reservation, or the tenant's budget leaks.  Idempotent —
            # gather() also invokes it synchronously so budgets are
            # settled the moment gather returns (done-callbacks race the
            # woken waiter).  Failed queries settle at zero spend.
            with self._lock:
                self._settlers.pop(ticket.index, None)
                if settled[0]:
                    return
                settled[0] = True
                acct.reserved = max(0.0, acct.reserved - est)
                if future.exception() is None:
                    acct.spent += int(future.result().n_llm_calls)
                self._export_budget_gauge_locked()
        with self._lock:
            self._settlers[ticket.index] = _settle
        ticket.add_done_callback(_settle)
        return ticket

    def _export_budget_gauge_locked(self) -> None:
        """Export the worst (max) tenant budget-burn ratio as a gauge so
        the health monitor's ``tenant-budget-burn`` rule can alert before
        admissions start bouncing.  No-op under the null registry."""
        used = [
            (acct.spent + acct.reserved) / acct.budget
            for acct in self._tenants.values()
            if acct.budget is not None and acct.budget > 0
        ]
        if used:
            get_tracer().metrics.set("service.tenant_budget_used_ratio",
                                     max(used))

    def status_view(self) -> Dict[str, dict]:
        """statusz section: per-tenant budgets and admission counters."""
        with self._lock:
            tenants = {
                name: {
                    "budget": acct.budget,
                    "spent": acct.spent,
                    "reserved": acct.reserved,
                    "remaining": acct.remaining,
                    "admitted": acct.n_admitted,
                    "rejected": acct.n_rejected,
                }
                for name, acct in self._tenants.items()
            }
        return tenants

    def gather(self, *tickets) -> List:
        """Wait for tickets (all outstanding when none given).  Budget
        settlement happens when each query finishes (also when a client
        consumes a ticket via ``result()`` directly); the first failure
        re-raises after every ticket is collected."""
        results, first_error = [], None
        for tk in self.scheduler.take_outstanding(*tickets):
            try:
                res = tk.result()
            except BaseException as e:
                res = None
                if first_error is None:
                    first_error = e
            with self._lock:
                settle = self._settlers.get(tk.index)
            if settle is not None:
                settle(tk.future)
            results.append(res)
        if first_error is not None:
            raise first_error
        if self.log is not None and self.log.attached:
            # gather's return is a quiescent point for the gathered work:
            # fold the log tail into a snapshot when thresholds say so
            self.log.compact_if_due(self.session)
        return results

    # --------------------------------------------------------- persistence
    def checkpoint(self, tag: str = "session"):
        """Snapshot mode: write a whole-session snapshot.  Log mode: fold
        the log tail into a fresh snapshot (compaction) — continuous
        durability means there is nothing else to flush."""
        if self.log is not None:
            self.log.compact(self.session)
            return self.log.dir
        if self.store is None:
            raise ValueError("FilterService built without store_dir or "
                             "log_dir")
        return self.store.save(self.session, tag)

    def restore(self, tag: str = "session", strict: bool = False):
        """Rebuild session state.  Snapshot mode returns a
        ``RestoreReport``; log mode replays snapshot + log tail, starts
        recording, and returns a ``LogRestoreReport``.  Either way the
        session's tables and oracles must be registered first."""
        if self.log is not None:
            rep = None
            if not self.log.attached:
                if self.log.exists():
                    rep = self.log.restore(self.session, strict=strict)
                self.log.attach(self.session)
            return rep
        if self.store is None:
            raise ValueError("FilterService built without store_dir or "
                             "log_dir")
        return self.store.load(self.session, tag, strict=strict)

    def close(self) -> None:
        self.session.close()
        if self.log is not None:
            self.log.close()
