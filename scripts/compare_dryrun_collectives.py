"""The smoke dry-run cells' collectives from both packages, side by side.

    PYTHONPATH=src python scripts/compare_dryrun_collectives.py [--json OUT]
    PYTHONPATH=src python scripts/compare_dryrun_collectives.py --residual
    PYTHONPATH=src python scripts/compare_dryrun_collectives.py --production \
        [--tag sandbox] [--arch A] [--shape S] [--mesh pod|multipod] [--force]

Runs on the CPU and needs both packages (a comparison, as the tests are):
each (arch x step kind x mesh) cell of qwen1.5-0.5b, jamba-v0.1-52b and
whisper-base at smoke width (batch 32, length 32) is built by the port's
dry run (a DTensor program on a ``fake`` group of 256 or 512 ranks) and
by the reference's (compiled for 512 forced host devices; its mesh is
made with Auto axes, which its dry run needs under the installed JAX).
For each it prints one device's collective operand bytes by kind and in
all, the port's counts, and the reference's bytes with while-loop trip
counts expanded (``cost_expanded``, what its roofline divides) beside
its HLO counts (loop bodies once).

``--residual`` measures instead what the port's one constraint that the
reference lacks costs: ``lm._residual`` pins the residual stream to its
batch split after every block (the reference constrains it once, at the
stack's input).  The port's cells (the smoke cells of qwen1.5-0.5b and
jamba-v0.1-52b on the pod mesh, and qwen1.5-0.5b x train_4k at full
size on both meshes) are built with the constraint and with a plain
``h + out`` in its place; their collective operand bytes, temporary
bytes, memory term and trace seconds are printed side by side (about 12
minutes, most of it the multipod cell without the constraint).

``--production`` puts the full matrix side by side: the ten assigned
archs x the four shapes x pod and multipod, 80 cells.  For each cell
the reference's ``build_cell`` is compiled here (the same Auto-axis
mesh; 2-20 s a cell on a CPU) and a summary of its artifact is kept in
``build/dryrun_reference/`` (a cell already there is not compiled
again without ``--force``; nothing is written under ``benchmarks/`` nor
into the reference's artifact directory).  The port's side is read from
``build/dryrun/*__TAG.json``, which ``python -m repro_torch.launch.dryrun
--all --mesh both --tag TAG`` writes.  One markdown row a cell: both
packages' compute, memory and collective terms (the reference's FLOPs,
bytes and collective bytes over the port's denominators, one H100's, so
that the dominant terms compare), the dominant term, argument and
temporary GiB a device, collective GB by kind, FLOPs a device and the
port's trace seconds; then the cells where the port's temporaries
exceed the reference's by more than 2x, the dominant terms differ, or
the FLOPs a device differ by more than 1.5x.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

CELLS = [(a, k, m) for a in ("qwen1.5-0.5b", "jamba-v0.1-52b", "whisper-base")
         for k in ("train", "prefill", "decode") for m in ("pod", "multipod")]
KINDS = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute"]


def port_cells():
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeCell
    out = {}
    for arch, kind, mesh in CELLS:
        art = dryrun.build_cell(arch, f"smoke_{kind}", mesh,
                                cfg=smoke_config(arch),
                                shape=ShapeCell(f"smoke_{kind}", 32, 32, kind))
        out[(arch, kind, mesh)] = {
            "bytes": art["collectives"]["bytes"],
            "total": art["collectives"]["total_bytes"],
            "counts": art["collectives"]["counts"]}
    return out


def _reference_dryrun():
    """The reference's dry-run module (it forces 512 host devices before
    JAX starts), its production mesh made with Auto axes."""
    import jax

    import repro.launch.dryrun as ref

    def auto_mesh(*, multi_pod=False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        n = 512 if multi_pod else 256
        return jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                             axis_types=(jax.sharding.AxisType.Auto,)
                             * len(axes))

    ref.make_production_mesh = auto_mesh
    return ref


def reference_cells():
    from repro.configs import smoke_config
    from repro.models.config import ShapeCell

    ref = _reference_dryrun()
    ref.get_config = smoke_config
    ref.SHAPES = {f"smoke_{k}": ShapeCell(f"smoke_{k}", 32, 32, k)
                  for k in ("train", "prefill", "decode")}
    out = {}
    for arch, kind, mesh in CELLS:
        art = ref.build_cell(arch, f"smoke_{kind}", mesh)
        exp = art["cost_expanded"]
        out[(arch, kind, mesh)] = {
            "bytes": {k: int(exp["coll_bytes"].get(k, 0)) for k in KINDS},
            "total": int(exp["total_coll_bytes"]),
            "counts": art["collectives"]["counts"]}
    return out


def residual_share():
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeCell
    constrained = lm._residual
    cells = [(a, f"smoke_{k}", "pod", smoke_config(a),
              ShapeCell(f"smoke_{k}", 32, 32, k))
             for a in ("qwen1.5-0.5b", "jamba-v0.1-52b")
             for k in ("train", "prefill", "decode")]
    cells += [("qwen1.5-0.5b", "train_4k", m, None, None)
              for m in ("pod", "multipod")]
    print("| cell (constrained; plain) | collective bytes AR/AG/RS/A2A "
          "| total | temp bytes | memory_s | trace s |")
    print("| --- | --- | --- | --- | --- | --- |")
    try:
        for arch, shape_name, mesh, cfg, shape in cells:
            arts = []
            for fn in (constrained, lambda h, out: h + out):
                lm._residual = fn
                arts.append(dryrun.build_cell(arch, shape_name, mesh,
                                              cfg=cfg, shape=shape))
            col = lambda a: "/".join(  # noqa: E731
                str(a["collectives"]["bytes"][k]) for k in KINDS[:4])
            both = lambda f: "; ".join(str(f(a)) for a in arts)  # noqa
            print(f"| {arch} x {shape_name} x {mesh} | {both(col)} | "
                  f"{both(lambda a: a['collectives']['total_bytes'])} | "
                  f"{both(lambda a: a['memory']['temp_size_in_bytes'])} | "
                  f"{both(lambda a: a['roofline_terms']['memory_s'])} | "
                  f"{both(lambda a: a['trace_s'])} |", flush=True)
    finally:
        lm._residual = constrained


ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_DIR = ROOT / "build" / "dryrun_reference"
PORT_DIR = ROOT / "build" / "dryrun"
# the port's roofline denominators (launch/dryrun.py), applied to both
PEAK_FLOPS, HBM_BW, NET_BW = 989e12, 3.35e12, 50e9
TERMS = ("compute_s", "memory_s", "collective_s")


def production_cells(arch=None, shape=None, mesh=None):
    from repro_torch.launch.dryrun import ASSIGNED
    from repro_torch.models.config import SHAPES
    return [(a, s, m) for a in ASSIGNED for s in SHAPES
            for m in ("pod", "multipod")
            if arch in (None, a) and shape in (None, s) and mesh in (None, m)]


def _cell_name(arch, shape, mesh):
    return f"{arch.replace('.', '_')}__{shape}__{mesh}"


def production_reference(cells, force=False):
    """Compile the reference's cells one by one, each summary kept in
    ``REF_DIR`` as it is made."""
    ref = _reference_dryrun()
    import jax
    REF_DIR.mkdir(parents=True, exist_ok=True)
    for arch, shape, mesh in cells:
        path = REF_DIR / f"{_cell_name(arch, shape, mesh)}.json"
        if path.exists() and not force:
            continue
        print(f"reference {arch} x {shape} x {mesh}", flush=True)
        t0 = time.monotonic()
        try:
            art = ref.build_cell(arch, shape, mesh)
        except Exception as e:  # noqa: BLE001 - a failed cell is a row
            art = {"ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-3000:]}
        keep = {k: art[k] for k in (
            "ok", "skipped_by_design", "reason", "error", "traceback",
            "chips", "lower_s", "compile_s", "memory", "cost",
            "cost_expanded",
            "dominant", "sharding_warnings") if k in art}
        keep.update(jax=jax.__version__,
                    wall_s=round(time.monotonic() - t0, 2))
        path.write_text(json.dumps(keep, indent=1))


def _summary(art, flops, nbytes, coll_bytes, temp, args):
    t = {"compute_s": flops / PEAK_FLOPS, "memory_s": nbytes / HBM_BW,
         "collective_s": sum(coll_bytes.values()) / NET_BW}
    return {"terms": t, "dominant": max(TERMS, key=t.get), "flops": flops,
            "coll": coll_bytes, "temp": temp, "args": args}


def _port_summary(art):
    c = art["cost"]
    return _summary(art, c["flops_per_device"], c["bytes_per_device"],
                    art["collectives"]["bytes"],
                    art["memory"]["temp_size_in_bytes"],
                    art["memory"]["argument_size_in_bytes"])


def _reference_summary(art):
    x = art["cost_expanded"]
    return _summary(art, x["flops"], x["bytes"],
                    {k: x["coll_bytes"].get(k, 0) for k in KINDS},
                    art["memory"]["temp_size_in_bytes"],
                    art["memory"]["argument_size_in_bytes"])


def divergences(port, ref) -> list:
    """Why a cell is named: temporaries over 2x the reference's, another
    dominant term, FLOPs a device off by more than 1.5x."""
    out = []
    if port["temp"] > 2 * ref["temp"]:
        out.append(f"temp {port['temp'] / ref['temp']:.2f}x")
    if port["dominant"] != ref["dominant"]:
        out.append("dominant")
    ratio = port["flops"] / ref["flops"] if ref["flops"] else float("inf")
    if not 1 / 1.5 <= ratio <= 1.5:
        out.append(f"FLOPs {ratio:.2f}x")
    return out


def production_table(cells, tag):
    """Print one row a cell, the port's figures beside the reference's,
    and return the named divergences."""
    gib, gb = 2 ** 30, 1e9
    short = {"compute_s": "C", "memory_s": "M", "collective_s": "N"}

    def side(s):
        t = s["terms"]
        return (" / ".join(f"{t[k]:.3g}" for k in TERMS)
                + f" | {short[s['dominant']]} | {s['args'] / gib:.3g} / "
                f"{s['temp'] / gib:.3g} | "
                + " / ".join(f"{s['coll'][k] / gb:.3g}" for k in KINDS)
                + f" | {s['flops']:.3g}")

    versions = set()
    print("| cell | port C / M / N s | dom | args / temp GiB | "
          "AR / AG / RS / A2A / CP GB | FLOPs/dev | trace s | reference "
          "C / M / N s | dom | args / temp GiB | AR / AG / RS / A2A / CP "
          "GB | FLOPs/dev | named |")
    print("|" + " --- |" * 14)
    named = []
    for arch, shape, mesh in cells:
        cell = f"{arch} x {shape} x {mesh}"
        pp = PORT_DIR / f"{_cell_name(arch, shape, mesh)}__{tag}.json"
        rp = REF_DIR / f"{_cell_name(arch, shape, mesh)}.json"
        port = json.loads(pp.read_text()) if pp.exists() else None
        ref = json.loads(rp.read_text()) if rp.exists() else None
        cols, sums = [], {}
        for pkg, art, summ, width in (("port", port, _port_summary, 6),
                                      ("reference", ref, _reference_summary,
                                       5)):
            if art is None or art.get("skipped_by_design") or \
                    not art.get("ok"):
                why = ("not run" if art is None else
                       f"skipped: {art['reason']}"
                       if art.get("skipped_by_design") else
                       f"failed: {art['error'][:80]}")
                cols.append(" | ".join([why] + [""] * (width - 1)))
                continue
            sums[pkg] = summ(art)
            versions.add(f"torch {art['torch']}" if pkg == "port"
                         else f"jax {art['jax']}")
            cols.append(side(sums[pkg])
                        + (f" | {art['trace_s']}" if pkg == "port" else ""))
        why = (divergences(sums["port"], sums["reference"])
               if len(sums) == 2 else [])
        if why:
            named.append((cell, why))
        print(f"| {cell} | {cols[0]} | {cols[1]} | {', '.join(why)} |")
    print()
    print("versions:", ", ".join(sorted(versions)))
    for cell, why in named:
        print(f"- {cell}: {', '.join(why)}")
    return named


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--residual", action="store_true",
                    help="the residual constraint's share, port only")
    ap.add_argument("--production", action="store_true",
                    help="the 80 production cells, port beside reference")
    ap.add_argument("--tag", default="sandbox",
                    help="the port's artifacts to read (--production)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=["pod", "multipod"])
    ap.add_argument("--force", action="store_true",
                    help="compile reference cells already kept")
    args = ap.parse_args(argv)
    if args.production:
        cells = production_cells(args.arch, args.shape, args.mesh)
        production_reference(cells, force=args.force)
        production_table(cells, args.tag)
        return
    if args.residual:
        import torch
        print(f"torch {torch.__version__}")
        residual_share()
        return
    port, ref = port_cells(), reference_cells()
    short = {"all-reduce": "AR", "all-gather": "AG", "reduce-scatter": "RS",
             "all-to-all": "A2A", "collective-permute": "CP"}
    print("| cell | port bytes (AR/AG/RS/A2A/CP) | port total | port counts "
          "| reference bytes, trips expanded | reference total | reference "
          "HLO counts |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for cell in CELLS:
        p, r = port[cell], ref[cell]
        fmt = lambda d: "/".join(str(d[k]) for k in KINDS)  # noqa: E731
        cnt = lambda d: " ".join(f"{short[k]} {d[k]}" for k in KINDS  # noqa
                                 if d[k])
        print(f"| {' x '.join(cell)} | {fmt(p['bytes'])} | {p['total']} | "
              f"{cnt(p['counts'])} | {fmt(r['bytes'])} | {r['total']} | "
              f"{cnt(r['counts'])} |")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"port": {"|".join(c): v for c, v in port.items()},
                       "reference": {"|".join(c): v
                                     for c, v in ref.items()}}, f, indent=1)


if __name__ == "__main__":
    main()
