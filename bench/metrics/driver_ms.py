"""Host time of the entry point, the plan and the CSV driver a query:
each ``query`` span less the ``engine_tick`` spans inside it, in ms."""


def read(ctx):
    queries = [s for s in ctx.spans if s.name == "query"]
    ticks = [s for s in ctx.spans if s.name == "engine_tick"]
    if not queries:
        return None
    total = 0.0
    for q in queries:
        inner = sum(t.t1 - t.t0 for t in ticks
                    if t.t0 >= q.t0 and t.t1 <= q.t1)
        total += (q.t1 - q.t0) - inner
    return 1000.0 * total / len(queries)
