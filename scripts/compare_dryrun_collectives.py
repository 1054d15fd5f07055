"""The smoke dry-run cells' collectives from both packages, side by side.

    PYTHONPATH=src python scripts/compare_dryrun_collectives.py [--json OUT]
    PYTHONPATH=src python scripts/compare_dryrun_collectives.py --residual

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
"""
from __future__ import annotations

import argparse
import json

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


def reference_cells():
    import jax

    import repro.launch.dryrun as ref
    from repro.configs import smoke_config
    from repro.models.config import ShapeCell

    def auto_mesh(*, multi_pod=False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        n = 512 if multi_pod else 256
        return jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                             axis_types=(jax.sharding.AxisType.Auto,)
                             * len(axes))

    ref.make_production_mesh = auto_mesh
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--residual", action="store_true",
                    help="the residual constraint's share, port only")
    args = ap.parse_args(argv)
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
