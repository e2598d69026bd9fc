"""Dry run of every arch x shape x mesh cell: placement, memory, FLOPs and
collective bytes on the production meshes, with nothing allocated -- a
redesign of the JAX package's ``launch/dryrun.py``.

The JAX package lowers and compiles each cell's program against 512
forced host devices and reads XLA's ``memory_analysis``,
``cost_analysis`` and the HLO's collectives.  The port has no compiler to
ask, so each cell is counted from its own placement and run on ``meta``
tensors (shapes, no storage) over a mesh that names ``meta`` at every
position (``launch.mesh.make_production_mesh``: 16 x 16, or 2 x 16 x 16):

  1. **Placement** -- ``steps.all_shardings``: every parameter, moment,
     input and (decode) cache leaf resolved against the mesh, the
     divisibility fallbacks logged (``fallbacks``).  ``memory`` counts the
     bytes each position holds from the shards' shapes (every position
     holds as much: a spec splits only dimensions it divides).
  2. **The production pass** -- the cell's step at full depth on
     ``meta``, under ``torch.utils.flop_counter.FlopCounterMode``: the
     FLOPs of the whole global batch (``cost_raw``; the placed step runs
     the same products, split by rows over its data positions).  For
     training, the placed step's communication on the mesh
     (``steps.make_placed_train_step(...).communicate``: its gathers,
     gradient sum and scatter, recorded by
     ``parallel.collectives.record_collectives``) gives
     ``collectives_raw``; the port places no prefill or decode step, so
     theirs are null.  ``compile_s`` is this pass's seconds with the
     placement's.
  3. **Metered** (single pod) -- the JAX package's three shallow variants
     (A = one period, B = two, C = one + the tail), run the same way, and
     ``F_total = F_fixed + n_periods * F_body + F_tail`` for FLOPs and
     collective bytes alike.  Each layer costs the same, so the
     extrapolation equals the production count; it is kept as the JAX
     package's cross-check.

Every pass runs with ``kv_chunk`` and ``ssd_unroll`` set very large, so
the port's Python block loops run one block at 32k-500k tokens.  The
port's attention computes every block, masked ones included, so one block
costs the chunked schedule's FLOPs exactly.

Fields with no counterpart are null, with the reason under
``null_reasons``: ``generated_code_size_in_bytes`` and
``temp_size_in_bytes`` (no compiler, no buffer assignment), ``bytes
accessed`` (no cost model of memory traffic).  The JAX package's
``_f16_standin`` has no use: ``meta`` tensors allocate nothing in any
dtype.  FLOPs count the matrix products (``FlopCounterMode``'s
registry: mm, bmm, convolutions, attention), where XLA's count also
takes elementwise work.  Collective bytes are the bytes the port's own
placed step moves, summed over the mesh's positions, where the JAX
package parses one device's HLO of GSPMD's schedule.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all          # every cell, both meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch

__all__ = ["run_cell", "position_bytes", "collective_bytes", "main"]

# wire multipliers: all-reduce ~ reduce-scatter + all-gather on a ring
_WIRE_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
              "all-to-all": 1.0, "collective-permute": 1.0}
_BIG = 1 << 30

NULL_REASONS = {
    "generated_code_size_in_bytes": "no compiler: the port runs eager "
                                    "PyTorch, no generated program",
    "temp_size_in_bytes": "no compiler buffer assignment: activations are "
                          "allocated as the step runs",
    "bytes accessed": "no cost model of memory traffic",
}
SERVING_COLLECTIVES = ("the port places no prefill or decode step: they run "
                       "at one position, with no collective")


def collective_bytes(notes) -> dict:
    """Per-kind bytes (received, summed over the positions), op counts
    and wire bytes (all-reduce 2x) of ``record_collectives`` notes."""
    out = {k: 0 for k in _WIRE_MULT}
    count = {k: 0 for k in _WIRE_MULT}
    for kind, nbytes, receivers in notes:
        out[kind] += nbytes * receivers
        count[kind] += 1
    wire = int(sum(out[k] * _WIRE_MULT[k] for k in out))
    return {"payload_bytes": out, "op_counts": count, "wire_bytes": wire}


def position_bytes(abstract, shardings) -> int:
    """Bytes each position holds of a tree (nested dicts, lists or an
    ``OptState``) of shape-only tensors under a congruent tree of
    shardings."""
    if dataclasses.is_dataclass(abstract):
        return sum(position_bytes(getattr(abstract, f.name),
                                  getattr(shardings, f.name))
                   for f in dataclasses.fields(abstract))
    if isinstance(abstract, dict):
        return sum(position_bytes(abstract[k], shardings[k])
                   for k in abstract)
    if isinstance(abstract, list):
        return sum(position_bytes(a, s) for a, s in zip(abstract, shardings))
    return shardings.shard_nbytes(tuple(abstract.shape), abstract.dtype)


def _meter_variants(cfg):
    """Three shallow configs -- A = one period of the pattern, B = two, C =
    one and the tail -- and the count of periods they extrapolate to.

    The JAX package's B is one period of the doubled pattern (a scan of
    trip count 1).  The port's is two periods: the port checkpoints each
    period, and a non-reentrant checkpoint stops its recompute after the
    last tensor the backward needs, so a doubled pattern's period would
    recompute one more trailing product than two periods do, and the
    body's count would not be one period's."""
    P = len(cfg.pattern)
    common = dict(kv_chunk=_BIG, ssd_unroll=_BIG)
    if cfg.enc_dec:
        A = dataclasses.replace(cfg, n_layers=1, **common)
        B = dataclasses.replace(cfg, n_layers=2, **common)
        return A, B, None, cfg.n_layers
    A = dataclasses.replace(cfg, n_layers=P, **common)
    B = dataclasses.replace(cfg, n_layers=2 * P, **common)
    C = None
    if cfg.n_layers % P:
        C = dataclasses.replace(cfg, n_layers=P + cfg.n_layers % P,
                                **common)
    return A, B, C, cfg.n_periods


def count_cell(shape_id, mesh, cfg) -> dict:
    """One pass of the cell's step for one config on ``meta``: ``flops``
    of the whole global batch (``FlopCounterMode`` over the plain step:
    the placed step's products are the same, split by rows over its data
    positions), and for training the placed step's ``collectives`` on
    ``mesh`` (``communicate``: its gathers, gradient sum and scatter) and
    its ``data_positions``; None otherwise."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import SHAPES
    from repro_torch.launch.steps import (batch_specs, make_decode_step,
                                          make_placed_train_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.collectives import record_collectives

    sh = SHAPES[shape_id]
    model = build_model(cfg, device="meta")
    specs = batch_specs(cfg, sh["kind"], sh["batch"], sh["seq"])
    out = {"collectives": None, "data_positions": None}
    with FlopCounterMode(display=False) as fc:
        if sh["kind"] == "train":
            step = make_train_step(model, cfg, lr_fn=lambda s: 3e-4,
                                   n_micro=cfg.n_micro)
            step(adamw_init(dict(model.named_parameters())), specs)
        elif sh["kind"] == "prefill":
            make_prefill_step(model, cfg, max_len=sh["seq"] + 1)(specs)
        else:
            cache = model.abstract_cache(sh["batch"], sh["seq"])
            make_decode_step(model, cfg)(cache, specs)
    out["flops"] = int(fc.get_total_flops())
    if sh["kind"] == "train":
        placed = make_placed_train_step(model, cfg, mesh=mesh,
                                        lr_fn=lambda s: 3e-4,
                                        n_micro=cfg.n_micro)
        with record_collectives() as notes:
            placed.communicate(specs)
        out["collectives"] = collective_bytes(notes)
        out["data_positions"] = len(placed.data_positions)
    return out


def _memory(cells: dict, kind: str) -> tuple[dict, dict]:
    """The JAX record's memory keys, per position, from the placement."""
    b = {"params": position_bytes(cells["abstract_params"],
                                  cells["param_sharding"]),
         "batch": position_bytes(cells["input_specs"],
                                 cells["batch_sharding"])}
    if kind == "train":
        b["opt"] = position_bytes(cells["abstract_opt"],
                                  cells["opt_sharding"])
    if kind == "decode":
        b["cache"] = position_bytes(cells["abstract_cache"],
                                    cells["cache_sharding"])
    # in place (the JAX package donates): the parameters and moments of a
    # train step, the cache of a decode step
    alias = {"train": b["params"] + b.get("opt", 0), "prefill": 0,
             "decode": b.get("cache", 0)}[kind]
    mem = {"generated_code_size_in_bytes": None,
           "argument_size_in_bytes": sum(b.values()),
           "output_size_in_bytes": alias,
           "alias_size_in_bytes": alias,
           "temp_size_in_bytes": None}
    return mem, b


def _apply_opts(cfg, opt: str):
    """The JAX package's hill-climb knobs, comma-separated, e.g.
    ``headpad16,kvchunk=2048,capacity=1.0,rules.expert=data``.  A knob
    the port cannot honour raises: ``remat=`` other than ``full``
    (``NotImplementedError``, as the model does), ``seqshard``
    (``NotImplementedError``: it sets an activation constraint, and the
    port's ``shard`` is the identity), an unknown knob (``ValueError``)."""
    for tok in (opt or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok.startswith("headpad"):
            cfg = dataclasses.replace(cfg, pad_heads_to=int(tok[7:]))
        elif tok.startswith("remat="):
            if tok[6:] != "full":
                raise NotImplementedError(
                    f"{tok}: the JAX package's dot-saving policies are not "
                    f"ported")
            cfg = dataclasses.replace(cfg, remat="full")
        elif tok.startswith("kvchunk="):
            cfg = dataclasses.replace(cfg, kv_chunk=int(tok[8:]))
        elif tok.startswith("capacity="):
            cfg = dataclasses.replace(cfg, capacity_factor=float(tok[9:]))
        elif tok.startswith("micro="):
            cfg = dataclasses.replace(cfg, n_micro=int(tok[6:]))
        elif tok == "cachef8":
            cfg = dataclasses.replace(cfg, cache_dtype=torch.float8_e4m3fn)
        elif tok == "seqshard":
            raise NotImplementedError(
                "seqshard constrains the residual stream's layout; the "
                "port's shard() is the identity")
        elif tok.startswith("rules."):          # rules.expert=data
            k, v = tok[6:].split("=")
            rules = dict(cfg.rules or {})
            rules[k] = None if v == "none" else v
            cfg = dataclasses.replace(cfg, rules=rules)
        else:
            raise ValueError(f"unknown opt {tok!r}")
    return cfg


def run_cell(arch, shape_id, mesh_kind="single", *, meter=True,
             out_dir="artifacts/dryrun", opt=None, smoke=False, mesh=None):
    """The dry run of one cell; writes its JSON record to ``out_dir`` and
    returns it.  ``smoke`` takes the arch's smoke config and ``mesh`` (a
    ``DeviceMesh``) replaces the production mesh: the tests' cut."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import all_shardings
    from repro_torch.parallel import sharding as shmod

    rec = {"arch": arch, "shape": shape_id, "mesh": mesh_kind,
           "opt": opt or "", "time": time.time()}
    ok, reason = shape_applicable(arch, shape_id)
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__opt-{opt}" if opt else ""
    path = os.path.join(
        out_dir,
        f"{arch}__{shape_id}__{mesh_kind}{suffix}.json".replace("/", "_"))

    def write():
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=1)
        return rec

    if not ok:
        rec.update(status="skipped", reason=reason)
        return write()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    kind = SHAPES[shape_id]["kind"]
    base = get_config(arch, smoke)
    try:
        cfg = _apply_opts(base, opt) if opt else base
        run_cfg = dataclasses.replace(cfg, kv_chunk=_BIG, ssd_unroll=_BIG)
        shmod.fallback_log.clear()
        t0 = time.time()
        cells = all_shardings(arch, shape_id, mesh, smoke=smoke, cfg=cfg)
        prod = count_cell(shape_id, mesh, run_cfg)
        rec["compile_s"] = round(time.time() - t0, 1)
        rec["memory"], rec["memory_by_part"] = _memory(cells, kind)
        rec["positions"] = mesh.size
        rec["cost_raw"] = {"flops": prod["flops"], "bytes accessed": None}
        if prod["data_positions"]:
            rec["cost_raw"]["data_positions"] = prod["data_positions"]
        rec["collectives_raw"] = prod["collectives"]
        rec["null_reasons"] = dict(NULL_REASONS)
        if prod["collectives"] is None:
            rec["null_reasons"]["collectives_raw"] = SERVING_COLLECTIVES
        rec["fallbacks"] = sorted({(n, a, d, str(m))
                                   for n, a, d, m in shmod.fallback_log})
        rec["status"] = "ok"
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        return write()

    if meter and mesh_kind == "single":
        try:
            A, B, C, n_periods = _meter_variants(cfg)
            res = {}
            for name, vcfg in (("A", A), ("B", B), ("C", C)):
                if vcfg is None:
                    continue
                got = count_cell(shape_id, mesh, vcfg)
                res[name] = {"flops": got["flops"]}
                if got["collectives"] is not None:
                    res[name]["wire"] = got["collectives"]["wire_bytes"]
            keys = res["A"]
            body = {k: res["B"][k] - res["A"][k] for k in keys}
            fixed = {k: 2 * res["A"][k] - res["B"][k] for k in keys}
            tail = ({k: res["C"][k] - res["A"][k] for k in keys}
                    if "C" in res else {k: 0 for k in keys})
            total = {k: fixed[k] + n_periods * body[k] + tail[k]
                     for k in keys}
            rec["metered"] = {"variants": res, "body": body, "fixed": fixed,
                              "tail": tail, "n_periods": n_periods,
                              "total": total}
        except Exception as e:
            rec["metered"] = {"status": "error",
                              "error": f"{type(e).__name__}: {e}",
                              "trace": traceback.format_exc()[-2000:]}
    return write()


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-meter", action="store_true")
    ap.add_argument("--opt", default=None,
                    help="hill-climb knobs, e.g. headpad16,kvchunk=2048")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--jobs", type=int, default=2)
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs import ARCH_IDS, SHAPES
        cells = [(a, s, m) for a in ARCH_IDS for s in SHAPES
                 for m in ("single", "multi")]
        procs, failures = [], []

        def drain(block=False):
            for p, cell in list(procs):
                if block:
                    p.wait()
                if p.poll() is not None:
                    procs.remove((p, cell))
                    if p.returncode != 0:
                        failures.append(cell)
                    print(("FAIL " if p.returncode else "ok   ")
                          + "%s %s %s" % cell, flush=True)

        for cell in cells:
            while len(procs) >= args.jobs:
                drain()
                time.sleep(2)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", cell[0], "--shape", cell[1], "--mesh", cell[2],
                   "--out", args.out]
            if args.no_meter:
                cmd.append("--no-meter")
            procs.append((subprocess.Popen(cmd), cell))
        while procs:
            drain(block=True)
        print(f"done; {len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    rec = run_cell(args.arch, args.shape, args.mesh,
                   meter=not args.no_meter, out_dir=args.out, opt=args.opt)
    print(json.dumps({k: v for k, v in rec.items() if k != "trace"},
                     indent=1)[:4000])
    if rec["status"] == "error":
        print(rec.get("trace", ""), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
