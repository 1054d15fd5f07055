"""repro_torch.service — concurrent, restartable semantic-filter serving.

Three layers over the lazy ``repro_torch.api`` surface (docs/service.md):

- ``QueryScheduler`` (scheduler.py): drives many submitted queries
  concurrently and merges their per-round oracle batches into cross-query
  dispatches — mean batch size grows with concurrency, per-query masks and
  call counts stay bit-identical to serial ``collect()``.
- ``SessionStore`` (store.py): session memo + caches to disk; a reloaded
  session replays previously-collected queries at zero oracle calls.
- ``SessionLogStore`` (log.py): the incremental alternative — every memo
  decision / cache insert / table mutation appends to a write-ahead log
  the moment it happens; restart = snapshot + log-tail replay
  (docs/distributed.md).
- ``FilterService`` (server.py): multi-tenant front end with aggregate
  ``max_oracle_calls`` admission control.

    from repro_torch.service import FilterService
    svc = FilterService(session, store_dir=".../state")
    svc.register_tenant("t0", ExecutionPolicy(max_oracle_calls=10_000))
    with session.scheduler.holding():
        tickets = [svc.submit("t0", q) for q in queries]
    results = svc.gather(*tickets)
"""
from repro_torch.service.log import (ConcurrentWriterError, LogRestoreReport,
                               SessionLogStore)
from repro_torch.service.scheduler import (BatchingOracleProxy, QueryScheduler,
                                     QueryTicket, ServiceStats)
from repro_torch.service.server import (FilterService, TenantAccount,
                                  TenantBudgetError)
from repro_torch.service.store import RestoreReport, SessionStore, STORE_SCHEMA

__all__ = [
    "BatchingOracleProxy", "QueryScheduler", "QueryTicket", "ServiceStats",
    "FilterService", "TenantAccount", "TenantBudgetError",
    "RestoreReport", "SessionStore", "STORE_SCHEMA",
    "ConcurrentWriterError", "LogRestoreReport", "SessionLogStore",
]
