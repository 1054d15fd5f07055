"""One run of one cell: set-up, the measured window, the check.

Set-up builds one ``Session`` with one table (the mix's embeddings; the
texts reach the oracle, which is the only reader of them), the served
weights, a ``ServingEngine`` and the policy, then runs one untimed query
that fills the table's clustering cache and serves the cell's shapes.
The window runs queries back to back, one client in a closed loop, each
a fresh predicate (its own text, oracle and name, so nothing is answered
from another query's memo; the mix's label sets in turn); a query
started inside the window runs to its end and counts.  After the window the program's state
is freed and the reference judges what the window produced.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from benchkit import csv_ref, data, reference, spec, text
from benchkit.data import stream_seed

WARM_QUERY = 1 << 40  # the warm-up's query index, outside the window's


def policy(mix: dict):
    from repro_torch.api import ExecutionPolicy
    return ExecutionPolicy(method="csv-sim", **mix["policy"])


class RouteLog:
    """The experts that the program's router chose in every batch the
    engine served while it is installed: each ``lm.first_logits_select``
    call opens a batch (its tokens and lengths), and each
    ``layers.moe_route`` call inside it adds its (B, T, K) choice.  The
    tensors stay on the device, unread, until the check."""

    def __init__(self):
        self.batches: list = []
        self._host: dict = {}

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.models import layers, lm
        select, route = lm.first_logits_select, layers.moe_route

        def logged_select(cfg, params, tokens, lens, *a, **k):
            self.batches.append((tokens, lens, []))
            return select(cfg, params, tokens, lens, *a, **k)

        def logged_route(*a, **k):
            out = route(*a, **k)
            if self.batches:
                self.batches[-1][2].append(out[2])
            return out
        lm.first_logits_select, layers.moe_route = logged_select, logged_route
        try:
            yield self
        finally:
            lm.first_logits_select, layers.moe_route = select, route

    def find(self, span, toks: list, T: int, n_moe: int):
        """The (n_moe, T, K) experts of the prompt ``toks`` served at
        bucket T in the batches ``span``, or None."""
        for j in range(*span):
            tokens, lens, topi = self.batches[j]
            if tokens.shape[1] != T or len(topi) != n_moe:
                continue
            if j not in self._host:
                self._host[j] = (tokens.cpu().numpy(), lens.cpu().numpy())
            ht, hl = self._host[j]
            hit = np.nonzero((hl == len(toks))
                             & (ht[:, :len(toks)] == toks).all(1))[0]
            if len(hit):
                return torch.stack([t[hit[0]] for t in topi])
        return None


class Cell:
    """The cell's program objects, built once per process, and its
    architecture module (``arch``), which gives the sizes, the program's
    config, the weights and the reference."""

    def __init__(self, cell: dict, device, table: data.Table = None):
        from repro_torch.data import HashTokenizer
        self.conf, self.mix = cell["config"], cell["mix"]
        self.limits, self.name = cell["limits"], cell["workload"]["name"]
        self.device = torch.device(device)
        self.arch = spec.arch(self.conf)
        self.d = self.arch.dims(self.conf)
        self.mcfg = self.arch.program_config(self.conf, self.d)
        self.table = table or data.Table(self.mix, self.device)
        self.tok = HashTokenizer(self.d["V"])
        self.n_moe = sum(f == "moe" for _, f in self.d["layers"])
        self.params = None

    # ------------------------------------------------------------ set-up
    def build(self, seed: int) -> None:
        from repro_torch.api import Session
        from repro_torch.serving import ServingEngine
        self.seed = seed
        self.params = self.routes = None
        gc.collect()
        self.params = self.arch.make_params(
            self.d, seed, getattr(torch, self.conf["serving"]["dtype"]),
            self.device)
        self.engine = ServingEngine(self.mcfg, self.params,
                                    max_batch=self.conf["serving"]["max_batch"],
                                    device=self.device)
        self.session = Session(policy=policy(self.mix), engine=self.engine,
                               device=self.device)
        self.handle = self.session.table(embeddings=self.table.emb_host,
                                         name="t")
        lab = self.mix["labels"]
        self.labels = [data.query_labels(self.table, self.mix, lab["seed"], i)
                       for i in range(lab["sets"])]
        self.query(WARM_QUERY, self.labels[0])
        self._sync()

    def recording(self):
        """Log the program's routing from here on (where it routes)."""
        if not self.n_moe:
            return contextlib.nullcontext()
        self.routes = RouteLog()
        return self.routes.installed()

    def labels_of(self, q: int) -> np.ndarray:
        return self.labels[q % len(self.labels)]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def query(self, q: int, labels: np.ndarray) -> dict:
        from benchkit.oracle import LabelOracle
        oracle = LabelOracle(self.engine, self.tok, data.predicate(self.mix, q),
                             self.table.texts, labels, self.routes)
        t0 = time.perf_counter()
        res = self.handle.filter(f"q{q}", oracle).collect()
        t1 = time.perf_counter()
        return {"q": q, "t0": t0, "t1": t1, "mask": res.mask,
                "calls": res.n_llm_calls, "oracle": oracle, "labels": labels}

    # ------------------------------------------------------------ window
    def window(self, seconds: float, tracer=None, devtrace=None) -> dict:
        from repro_torch.obs.trace import use_tracer
        b0 = dict(self.engine.batcher.stats)
        p0 = self.engine.stats["batched_prompts"]
        queries = []
        with use_tracer(tracer), self.recording():
            if devtrace is not None:
                devtrace.begin()
            t0 = time.perf_counter()
            q = 0
            while q == 0 or time.perf_counter() - t0 < seconds:
                queries.append(self.query(q, self.labels_of(q)))
                q += 1
            t1 = time.perf_counter()
            if devtrace is not None:
                devtrace.end()
        b1 = self.engine.batcher.stats
        return {"queries": queries, "t0": t0, "t1": t1,
                "real_tokens": b1["real_tokens"] - b0["real_tokens"],
                "padded_tokens": b1["padded_tokens"] - b0["padded_tokens"],
                "served": self.engine.stats["batched_prompts"] - p0,
                "assign": self.handle.precluster(
                    self.mix["policy"]["n_clusters"],
                    self.mix["policy"]["seed"])}

    def release(self) -> None:
        """Free the program's state; the weights stay for the reference."""
        for k in ("engine", "session", "handle"):
            setattr(self, k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def end_to_end(win: dict, n_rows: int) -> dict:
    qs = win["queries"]
    tp = fp = fn = 0
    for r in qs:
        m, y = r["mask"], r["labels"]
        tp += int(np.sum(m & y))
        fp += int(np.sum(m & ~y))
        fn += int(np.sum(~m & y))
    calls = sum(r["calls"] for r in qs)
    return {"query_s": (win["t1"] - win["t0"]) / len(qs),
            "llm_calls_per_krow": 1000.0 * calls / (len(qs) * n_rows),
            "f1": 2 * tp / max(1, 2 * tp + fp + fn)}


# ---------------------------------------------------------------- check
def served_prompts(cell: Cell, qs: list) -> list:
    """Every prompt the window served: (query record, call index,
    position in the call)."""
    return [(r, k, i) for r in qs for k, ids in enumerate(r["oracle"].asked)
            for i in range(len(ids))]


def _prompt(cell: Cell, r: dict, row: int) -> list:
    return text.prompt_ids(data.predicate(cell.mix, r["q"]),
                           cell.table.texts[row], cell.d["V"])


def logit_errors(cell: Cell, qs: list, seed: int, program=None) -> dict:
    """The served yes/no logits of a seed-drawn sample of the window's
    prompts (the longest among them) against the reference's, rebuilt
    from the texts at the buckets the program served them in, with each
    MoE layer dispatched to the experts that the program's router chose
    (where the model routes): for each prompt the wider error of its two
    logits (``err``) and the largest excess of those choices over the
    reference's own router (``excess``: inf where the program's choices
    were not found).  ``program(tokens, lens, token_ids)`` replaces the
    served logits and choices (the control): -> (logits, [(B, T, K)] a
    MoE layer, or None)."""
    allp = served_prompts(cell, qs)
    n = min(cell.mix["check"]["prompts"], len(allp))
    rng = np.random.default_rng(stream_seed(seed, 4))
    pick = set(rng.choice(len(allp), size=n, replace=False).tolist())
    lens_of = {}
    longest, best = None, -1
    for j, (r, k, i) in enumerate(allp):
        key = (id(r), k)
        if key not in lens_of:
            lens_of[key] = [len(_prompt(cell, r, int(x)))
                            for x in r["oracle"].asked[k]]
        if lens_of[key][i] > best:
            longest, best = j, lens_of[key][i]
    pick.add(longest)
    groups: dict = {}
    for j in sorted(pick):
        r, k, i = allp[j]
        T = int(text.plan_buckets(lens_of[(id(r), k)],
                                  cell.conf["serving"]["max_batch"])[i])
        toks = _prompt(cell, r, int(r["oracle"].asked[k][i]))
        served = r["oracle"].logits[k][i]
        route = None
        if cell.n_moe and program is None:
            route = cell.routes.find(r["oracle"].spans[k], toks, T,
                                     cell.n_moe)
        groups.setdefault(T, []).append((toks, served, route))
    layers = cell.arch.layer_list(cell.params)
    tid = torch.tensor([text.YES, text.NO], device=cell.device)
    K = cell.d["K"]
    got, want, excess = [], [], []
    block = cell.mix["check"]["block"]
    for T, items in sorted(groups.items()):
        for b in range(0, len(items), block):
            part = items[b:b + block]
            toks = torch.zeros((len(part), T), dtype=torch.long,
                               device=cell.device)
            for row, (t, _, _) in enumerate(part):
                toks[row, :len(t)] = torch.tensor(t)
            lens = torch.tensor([len(t) for t, _, _ in part],
                                device=cell.device)
            if program is None:
                got.append(np.stack([s for _, s, _ in part]))
                given = None
                if cell.n_moe:
                    none = torch.full((cell.n_moe, T, K), -1,
                                      dtype=torch.long, device=cell.device)
                    g = torch.stack([none if rt is None else rt
                                     for _, _, rt in part], 1)
                    given = list(g)
            else:
                logits, given = program(toks, lens, tid)
                got.append(logits)
            route = reference.Route(given)
            ref = cell.arch.yes_no_logits(cell.d, cell.params, layers, toks,
                                          lens, tid, route=route)
            want.append(ref.cpu().numpy())
            ex = np.zeros(len(part), np.float32)
            if route.excess:
                real = (torch.arange(T, device=cell.device)[None]
                        < lens[:, None])
                ex = torch.stack([(e * real).amax(1) for e in route.excess]
                                 ).amax(0).cpu().numpy()
            if program is None and cell.n_moe:
                ex[[rt is None for _, _, rt in part]] = np.inf
            excess.append(ex)
    err = np.abs(np.concatenate(got) - np.concatenate(want)).max(1)
    return {"err": err, "excess": np.concatenate(excess)}


def logit_stat(cell: Cell, e: dict) -> dict:
    """The widest served-logit error over the sampled prompts, and, where
    the model routes, the number of them in which the program chose an
    expert that the reference's router puts more than the limits'
    ``router_margin`` below its own choice (or whose choices were not
    found)."""
    out = {"logit_err": float(e["err"].max()), "prompts_checked": len(e["err"])}
    if cell.n_moe:
        out["route_diff"] = int(np.sum(e["excess"]
                                       > cell.limits["router_margin"]))
    return out


def logit_numbers(cell: Cell, qs: list, seed: int, program=None) -> dict:
    return logit_stat(cell, logit_errors(cell, qs, seed, program))


def csv_numbers(cell: Cell, win: dict, seed: int, program=None) -> dict:
    """The window's masks, oracle calls and pre-clustering against the
    reference CSV, followed up to its first tie.  ``program(labels)``
    replaces the program's run of a query (the control: a reference
    run in lower precision, returning a ``csv_ref.Run``)."""
    pol = dict(cell.mix["policy"])
    emb = cell.table.emb.double()
    host = cell.table.emb_host
    assign0, tie0 = csv_ref.kmeans(pol["seed"], emb, host, pol["n_clusters"],
                                   pol["kmeans_iters"], csv_ref.plusplus,
                                   "f64")
    qs = win["queries"]
    out = {"assign_diff": 0 if tie0 else int(np.sum(win["assign"] != assign0)),
           "ids_diff": 0, "rows_diff": 0, "label_diff": 0,
           "calls_followed": 0, "calls_total": 0}
    for r in qs:
        for ids in r["oracle"].asked:
            out["label_diff"] += int(np.sum(r["mask"][ids] != r["labels"][ids]))
    asked = sum(len(ids) for r in qs for ids in r["oracle"].asked)
    calls = sum(r["calls"] for r in qs)
    out["engine_diff"] = abs(calls - win["served"]) + abs(calls - asked)
    rng = np.random.default_rng(stream_seed(seed, 5))
    n = min(cell.mix["check"]["queries"], len(qs))
    pick = [0] + sorted(rng.choice(np.arange(1, len(qs)), size=n - 1,
                                   replace=False).tolist()) if n > 1 else [0]
    refs: dict = {}  # one reference run per label set
    for j in pick:
        r = qs[j]
        key = id(r["labels"])
        if key not in refs:
            refs[key] = csv_ref.csv_filter(emb, host, r["labels"], assign0,
                                           pol, csv_ref.plusplus, "f64", tie0)
        ref = refs[key]
        mine_calls, mask = r["oracle"].asked, r["mask"]
        if program is not None:
            run = program(r["labels"])
            mine_calls, mask = run.calls, run.mask
        f = ref.followed
        for k in range(f):
            a = mine_calls[k] if k < len(mine_calls) else np.zeros(0, int)
            out["ids_diff"] += len(np.setxor1d(a, ref.calls[k]))
        if f == len(ref.calls):
            out["ids_diff"] += sum(len(c) for c in mine_calls[f:])
        cmp = (ref.decided_at >= 0) & (ref.decided_at < f) & ref.decisive
        out["rows_diff"] += int(np.sum(cmp & (mask != ref.mask)))
        out["calls_followed"] += sum(len(c) for c in ref.calls[:f])
        out["calls_total"] += sum(len(c) for c in ref.calls)
    return out


def checks(numbers: dict, limits: dict) -> list:
    """[(name, value, limit, ok)] for every number that has a limit."""
    return [(k, numbers[k], lim, numbers[k] <= lim)
            for k, lim in limits["compare"].items()]


def load_reader(name: str):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py",
                            f"bench_metric_{name}").read
