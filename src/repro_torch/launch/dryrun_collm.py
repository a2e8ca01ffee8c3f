"""CE-CoLLM technique dry run: the two-tier deployment, lowered ahead of
time (port of ``repro.launch.dryrun_collm``).

The edge tier (layers 1..l_ee2 and the exit heads) and the cloud tier
(layers l_ee1+1..L) of ``--arch`` in bf16 are lowered by
``TwoTierRuntime.lower_tiers`` on tensors without storage, so the run
needs no card and allocates nothing, for every registered configuration.
The record holds the JAX package's keys: each tier's ``memory_analysis``
(argument, output and temporary bytes), ``cost_analysis`` (the FLOPs of
one decode step) and ``collectives`` (``roofline.collectives.wire_bytes``
of the calls recorded on a recording mesh), and the cross-tier wire bytes
per decode step for ``--wire``.  ``--cloud-tp`` / ``--cloud-dp`` put the
cloud tier on a (data, model) mesh: its record is rank 0's share and its
collectives, the way to size a cloud tier that no single card holds
(qwen1.5-110b).  ``roofline/analyze.py`` reads a tier's record.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_collm \\
        --arch ee-llm-7b --batch 128 --seq 32768 --wire float16 \\
        --out artifacts/dryrun

Not applicable, written as null: ``compile_s`` (the port compiles
nothing ahead of time), ``temp_size_in_bytes`` (no compiler plans the
temporaries).  ``edge_chips`` is 1 (the edge is one device) and
``cloud_chips`` the cloud mesh's ranks, where the JAX record has the two
256-chip pods of the 512-device production mesh.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.collm import CollmConfig
from repro_torch.core.disagg import TwoTierRuntime
from repro_torch.models.transformer import Model
from repro_torch.roofline.collectives import wire_bytes


def run(arch: str, batch: int, seq: int, wire: str, out_dir: str,
        cloud_tp: int = 1, cloud_dp: int = 1) -> dict:
    cfg = get_config(arch)
    model = Model(cfg, device="meta", dtype=torch.bfloat16)
    rt = TwoTierRuntime(model, CollmConfig(wire_format=wire), "cpu", "cpu",
                        split=True)
    mesh = (cloud_dp, cloud_tp) if cloud_tp * cloud_dp > 1 else None
    rec = {"arch": arch, "batch": batch, "seq": seq, "wire": wire,
           "l_ee1": cfg.exit_layers[0], "l_ee2": cfg.exit_layers[-1],
           "edge_chips": 1, "cloud_chips": cloud_tp * cloud_dp,
           "cloud_mesh": list(mesh) if mesh else None}
    t0 = time.time()
    edge, cloud, info = rt.lower_tiers(batch, seq, cloud_mesh=mesh)
    rec["lower_s"] = round(time.time() - t0, 1)
    rec["wire_bytes_per_token"] = info["wire_bytes_per_token"]
    for tier in (edge, cloud):
        rec[tier.name] = {
            "compile_s": None,
            "memory_analysis": tier.memory_analysis(),
            "cost_analysis": tier.cost_analysis(),
            "collectives": wire_bytes(tier.collectives),
            "param_bytes": tier.param_bytes,
            "cache_bytes": tier.cache_bytes}
    rec["status"] = "ok"
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = f"_tp{cloud_tp}dp{cloud_dp}" if mesh else ""
    path = os.path.join(out_dir, f"collm_{arch}_{batch}x{seq}_{wire}"
                                 f"{mesh_tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ee-llm-7b")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=32768)
    ap.add_argument("--wire", default="float16",
                    choices=["float32", "float16", "int8"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--cloud-tp", type=int, default=1,
                    help="the cloud mesh's model axis")
    ap.add_argument("--cloud-dp", type=int, default=1,
                    help="the cloud mesh's data axis")
    args = ap.parse_args(argv)
    rec = run(args.arch, args.batch, args.seq, args.wire, args.out,
              args.cloud_tp, args.cloud_dp)
    brief = {k: rec[k] for k in ("arch", "status", "lower_s",
                                 "wire_bytes_per_token")}
    for tier in ("edge", "cloud"):
        brief[tier] = {"compile_s": rec[tier]["compile_s"],
                       "flops": rec[tier]["cost_analysis"].get("flops"),
                       "mem": rec[tier]["memory_analysis"]}
    print(json.dumps(brief, indent=1))


if __name__ == "__main__":
    main()
