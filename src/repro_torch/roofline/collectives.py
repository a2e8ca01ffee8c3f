"""Wire bytes of the port's collectives (port of
``repro.roofline.collectives``).

The JAX package reads its collectives out of compiled HLO text; the
port's are explicit calls (``launch/sharding.py``: ``reduce_model``,
``embed_lookup``, ``gather_vocab``, ``merge_exits``, ``gather_heads``,
``sum_squares``, ``gather_rows``, ``share_column``, every one an
all-reduce), each recorded
with its group size and tensor bytes (``sharding.records()``).
``wire_bytes`` turns such records into the JAX package's per-device
estimate with its ring factors:

    all-gather          (N-1)/N * result_bytes
    reduce-scatter      (N-1)/N * operand_bytes (~ result * N -> (N-1)*res)
    all-reduce          2 (N-1)/N * operand_bytes
    all-to-all          (N-1)/N * operand_bytes
    collective-permute  operand_bytes

N is the record's group size.  A record is {"op" (the HLO collective),
"group", "bytes" (one call's result), "count"}.
"""
from __future__ import annotations

from typing import Dict, Iterable


def ring_factor(op: str, n: int) -> float:
    """Wire bytes a device per result byte of one ``op`` over ``n``."""
    frac = (n - 1) / n
    if op == "all-reduce":
        return 2 * frac
    if op == "reduce-scatter":
        return frac * n
    if op in ("all-gather", "all-to-all"):
        return frac
    if op == "collective-permute":
        return 1.0
    raise ValueError(f"no ring factor for {op!r}")


def wire_bytes(records: Iterable[Dict]) -> Dict[str, Dict]:
    """{op: {count, result_bytes, wire_bytes}} of ``records``, in the
    shape of the JAX package's ``parse_collectives``."""
    out: Dict[str, Dict] = {}
    for r in records:
        rec = out.setdefault(r["op"], {"count": 0, "result_bytes": 0,
                                       "wire_bytes": 0.0})
        rec["count"] += r["count"]
        rec["result_bytes"] += r["count"] * r["bytes"]
        rec["wire_bytes"] += (r["count"] * r["bytes"]
                              * ring_factor(r["op"], r["group"]))
    return out


def total_wire_bytes(coll: Dict[str, Dict]) -> float:
    return sum(v["wire_bytes"] for v in coll.values())
