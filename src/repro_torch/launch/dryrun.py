"""Dry run of every (arch x input shape) on the production meshes, on
tensors without storage (port of ``repro.launch.dryrun``).  No card, no
allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b \\
        --shape train_4k [--multi-pod] [--out artifacts/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

It takes the JAX CLI's twelve flags and writes one record a combination
under the JAX package's file name (``{arch}_{shape}_{mesh}{tag}.json``)
and keys:

  * ``arch``, ``shape``, ``mesh`` (``16x16`` or ``2x16x16``), ``status``
    (``ok``, ``skipped`` with ``reason`` from ``configs/shapes.
    shape_applicable``, or ``error`` with ``error`` and ``traceback``),
    ``tag``, ``n_devices``, ``microbatches``, ``fsdp`` (``specs.
    choose_fsdp`` unless ``--fsdp``) and ``arg_bytes_per_device``: the
    bytes of the step's arguments a device holds under the rules of
    ``launch/sharding.py`` (``specs.arg_bytes_per_device``), the JAX
    package's to the byte;
  * ``cost_analysis`` (``flops``) and ``memory_analysis`` from one step
    at rank 0's share, run under ``FakeTensorMode`` and
    ``FlopCounterMode`` with a recording mesh (``launch/mesh.
    recording_mesh``): the model axis of 16, and the data axis of 16, or
    ``pod x data`` folded into one of 32 (the recording mesh has no pod
    axis; the byte count keeps the three axes, so FSDP over ``("pod",
    "data")`` counts as the JAX package's does).  The step holds rank 0's
    rows of the batch (the whole batch where the data axes do not divide
    it) and its share of the model axis; the port executes no FSDP, so
    under ``fsdp: true`` it holds the model-axis share of every parameter
    whole along the data axes (``step.param_bytes``).  Training steps run
    in float32 (``init_adamw`` keeps its moments in the parameters'
    dtype), prefill and decode in bf16 (``step.dtype``);
    ``memory_analysis.argument_size_in_bytes`` is
    ``arg_bytes_per_device``, ``output_size_in_bytes`` the step's outputs
    at that share;
  * ``collectives``: ``roofline/collectives.wire_bytes`` of the step's
    recorded collectives, and ``lower_s``, the seconds of the step pass.

Written as null, with no port counterpart: ``compile_s`` and
``hlo_bytes`` (nothing is compiled ahead of time), ``memory_analysis.
temp_size_in_bytes`` and ``generated_code_size_in_bytes`` (no compiler
plans temporaries or emits code); ``--save-hlo`` writes nothing (there
is no HLO); ``seq_parallel`` and ``vocab_shard``, whatever
``--no-seq-parallel`` and ``--no-vocab-shard`` say: they are GSPMD layout
hints with no counterpart (activations stay whole between blocks,
``serving/mesh_exec.py``).  ``--multi-pod``'s split of the pods is a
shape here, no process runs on either pod.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.configs.shapes import SHAPES_BY_NAME, shape_applicable
from repro_torch.launch import sharding as shardlib
from repro_torch.launch.specs import (arg_bytes_per_device, arg_shardings,
                                      choose_fsdp, input_specs, make_step_fn)
from repro_torch.models.cache_tree import cache_bytes
from repro_torch.roofline.collectives import wire_bytes

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def mesh_name(multi_pod: bool) -> str:
    return "x".join(str(d) for d in MESHES[multi_pod][0])


@torch.no_grad()
def lower_step(cfg, shape, mesh, microbatches: int = 1) -> dict:
    """One step of ``shape`` at rank 0's share of ``mesh`` (a
    ``MeshShape``) on tensors without storage: its FLOPs, output bytes,
    recorded collectives and what it held."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import recording_mesh
    from repro_torch.models.transformer import Model

    sizes = mesh.shape
    data = sizes.get("pod", 1) * sizes["data"]
    b, s = shape.global_batch, shape.seq_len
    axes = shardlib.batch_axes(mesh, b)
    rows = b // shardlib._axis_size(mesh, axes) if axes else b
    dtype = torch.float32 if shape.kind == "train" else torch.bfloat16
    saved = (dict(shardlib.COUNTS), dict(shardlib.SECONDS),
             dict(shardlib.CALLS))
    shardlib.reset_counts()
    try:
        with FakeTensorMode():
            rmesh = recording_mesh((data, sizes["model"]), "cpu")
            model = Model(cfg, device="cpu", dtype=dtype,
                          axis=rmesh.model_axis)
            params = sum(p.numel() * p.element_size()
                         for p in model.parameters())
            step = make_step_fn(model, shape.kind, microbatches)
            batch = {"tokens": torch.zeros((rows, s), dtype=torch.long)}
            if cfg.is_encdec:
                batch["frames"] = torch.zeros(
                    (rows, cfg.encoder_seq, cfg.d_model), dtype=dtype)
            if cfg.vision_tokens:
                batch["patches"] = torch.zeros(
                    (rows, cfg.vision_tokens, cfg.d_model), dtype=dtype)
            with FlopCounterMode(display=False) as fc:
                if shape.kind == "train":
                    from repro_torch.training.optim import init_adamw
                    batch["labels"] = torch.zeros((rows, s),
                                                  dtype=torch.long)
                    batch["mask"] = torch.ones((rows, s), dtype=dtype)
                    opt, metrics = step(init_adamw(model), batch)
                    state = [v for st in opt.state.values()
                             for v in st.values()
                             if isinstance(v, torch.Tensor)]
                    outs = [list(model.parameters()), state, metrics]
                elif shape.kind == "prefill":
                    outs = step(batch, model.init_cache(rows, s))
                else:
                    outs = step(batch["tokens"][:, :1],
                                model.init_cache(rows, s),
                                torch.zeros((), dtype=torch.int32))
            flops = int(fc.get_total_flops())
            out_bytes = cache_bytes(list(outs))
        records = shardlib.records()
    finally:
        for table, was in zip((shardlib.COUNTS, shardlib.SECONDS,
                               shardlib.CALLS), saved):
            table.clear()
            table.update(was)
    return {"flops": flops, "output_bytes": out_bytes, "records": records,
            "step": {"data": data, "model": sizes["model"], "rows": rows,
                     "dtype": str(dtype).replace("torch.", ""),
                     "param_bytes": params}}


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str, *,
            fsdp=None, seq_parallel=True, vocab_shard=True,
            save_hlo: bool = False, tag: str = "",
            microbatches: int = 1) -> dict:
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
           "status": "skipped", "tag": tag}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["reason"] = why
        return rec
    dims, names = MESHES[multi_pod]
    mesh = shardlib.MeshShape(dims, names)
    n = 1
    for d in dims:
        n *= d
    rec["n_devices"] = n
    rec["microbatches"] = microbatches
    args = input_specs(cfg, shape)
    if fsdp is None:
        fsdp = choose_fsdp(args[0], mesh)
    rec["fsdp"] = bool(fsdp)
    specs = arg_shardings(shape, mesh, args, fsdp=fsdp)
    rec["arg_bytes_per_device"] = arg_bytes_per_device(args, specs, mesh)
    rec["seq_parallel"] = rec["vocab_shard"] = None
    try:
        t0 = time.time()
        low = lower_step(cfg, shape, mesh, microbatches)
        rec["lower_s"] = round(time.time() - t0, 1)
        rec["compile_s"] = None
        rec["memory_analysis"] = {
            "argument_size_in_bytes": rec["arg_bytes_per_device"],
            "output_size_in_bytes": low["output_bytes"],
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None}
        rec["cost_analysis"] = {"flops": float(low["flops"])}
        rec["collectives"] = wire_bytes(low["records"])
        rec["hlo_bytes"] = None
        rec["step"] = low["step"]
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--no-vocab-shard", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save-hlo", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = (list(SHAPES_BY_NAME) if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    fsdp = None if args.fsdp is None else (args.fsdp == "on")
    results = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                rec = run_one(a, s, mp, args.out, fsdp=fsdp,
                              seq_parallel=not args.no_seq_parallel,
                              vocab_shard=not args.no_vocab_shard,
                              save_hlo=args.save_hlo, tag=args.tag,
                              microbatches=args.microbatches)
                results.append(rec)
                fname = os.path.join(
                    args.out, f"{a}_{s}_{mesh_name(mp)}{args.tag}.json")
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
                brief = {k: rec.get(k) for k in
                         ("arch", "shape", "mesh", "status", "lower_s",
                          "compile_s", "reason", "error")}
                print(json.dumps(brief), flush=True)
                if rec["status"] == "ok":
                    coll = {k: round(v["wire_bytes"] / 1e6, 1)
                            for k, v in rec["collectives"].items()}
                    print(f"  mem={rec['memory_analysis']}  "
                          f"flops={rec['cost_analysis']['flops']} "
                          f"coll={coll}MB", flush=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"DONE ok={n_ok} skipped={n_skip} "
          f"error={len(results) - n_ok - n_skip}")
    return 0 if all(r["status"] in ("ok", "skipped") for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
