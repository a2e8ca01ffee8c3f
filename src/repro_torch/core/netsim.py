"""Virtual-time discrete-event simulator for cloud-edge LLM serving.

A copy of ``repro.core.netsim`` (plain Python; the port imports nothing
of the JAX package), pricing packets and the cloud queue through the
port's ``transport``.

Reproduces the paper's experimental setting (§5): N edge clients, one
shared cloud server, a WiFi-class link per client.  Strategies:

  * ``cloud_llm``   — Cloud-based LLM Deployment (fig 1a): all layers in the
                      cloud; only tokens cross the network.
  * ``naive``       — Naive Cloud-Edge Deployment (fig 1b): model split at
                      l_ee2; per-token synchronous hidden-state transfer of
                      the FULL context (no content manager -> no cloud KV).
  * ``ce_collm``    — the paper's system: early exits at l_ee1/l_ee2,
                      parallel (async) upload at l_ee1, content-manager KV
                      caching, per-token cloud requests only below theta.
  * ``standalone``  — edge standalone mode (last exit is the output).

Ablation switches mirror Table 4: ``half_precision`` (fp16 wire),
``early_exit`` (θ effectively 1.0 when off), ``content_manager`` (off ->
synchronous full-context uploads per request).

Time accounting matches the paper's metrics: total / edge / cloud / comm
time costs, request-cloud rate, transmitted MB.  The cloud is a FIFO
resource shared by all clients (this produces Fig 4's saturation).

This simulator runs in *virtual time*: compute costs are supplied per
partition (measured on-CPU for the tiny end-to-end example, or set to
A100-class constants to replay the paper's tables).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence

# Single source of truth for wire accounting AND cloud-queue accounting:
# the simulator prices packets with the same helpers the serving engine
# uses, and books cloud service through the same CloudServicePoint the
# AsyncSimChannel uses (repro_torch.core.transport), so the two can never
# disagree on transmitted MB or on the batched-cloud saturation knee.
from repro_torch.core.transport import (TOKEN_BYTES, CloudServicePoint,
                                        hidden_wire_bytes)


@dataclasses.dataclass
class NetworkParams:
    up_bw: float = 4.0e6          # bytes/s (~32 Mbit/s WiFi uplink)
    down_bw: float = 8.0e6
    # per-REQUEST round trip (naive / ce_collm requests).  The cloud-based
    # API strategy streams over an open connection: bytes only, no per-token
    # RTT (this matches the paper's ~0.4 s comm for cloud deployment).
    rtt: float = 0.003


@dataclasses.dataclass
class ComputeParams:
    """Per-token per-layer compute costs (seconds)."""
    edge_layer_time: float
    cloud_layer_time: float
    exit_head_time: float = 0.0
    # edge-side wire serialization throughput (bytes/s); fp16 halves bytes
    serialize_bw: float = 2.0e9
    # prompt prefill processes the whole prompt in parallel: per-token cost
    # is a small fraction of decode cost (batched matmuls)
    prefill_discount: float = 0.05


@dataclasses.dataclass
class ModelSplit:
    n_layers: int
    l_ee1: int
    l_ee2: int
    d_model: int
    backfill: bool = False        # beyond-paper exact-KV mode


@dataclasses.dataclass
class TokenTrace:
    conf1: float
    conf2: float


@dataclasses.dataclass
class CaseTrace:
    prompt_len: int
    tokens: List[TokenTrace]      # generated tokens
    arrival_t: float = 0.0        # open-loop virtual arrival time; a case
                                  # never starts before it (workload.
                                  # stamp_arrivals attaches these)


@dataclasses.dataclass
class SimResult:
    total_time: float = 0.0       # makespan over all clients
    edge_time: float = 0.0        # summed edge busy time
    cloud_time: float = 0.0       # summed cloud busy time
    comm_time: float = 0.0        # summed time tokens were blocked on the wire
    request_cloud_rate: float = 0.0
    transmitted_mb: float = 0.0
    tokens: int = 0
    cloud_requests: int = 0
    per_client_finish: List[float] = dataclasses.field(default_factory=list)

    def as_row(self) -> Dict[str, float]:
        return {
            "total_s": round(self.total_time, 3),
            "edge_s": round(self.edge_time, 3),
            "cloud_s": round(self.cloud_time, 3),
            "comm_s": round(self.comm_time, 3),
            "request_rate_pct": round(self.request_cloud_rate * 100, 2),
            "transmitted_mb": round(self.transmitted_mb, 2),
        }


@dataclasses.dataclass
class _Client:
    cid: int
    cases: List[CaseTrace]
    now: float = 0.0
    case_idx: int = 0
    tok_idx: int = 0
    upload_link_free: float = 0.0
    upload_arrival: float = 0.0   # arrival time of the latest l_ee1 upload
    done: bool = False


def _hidden_bytes(d_model: int, half_precision: bool) -> int:
    return hidden_wire_bytes(d_model,
                             "float16" if half_precision else "float32")


def simulate(strategy: str, clients_cases: Sequence[List[CaseTrace]],
             net: NetworkParams, comp: ComputeParams, split: ModelSplit, *,
             theta: float = 0.8,
             half_precision: bool = True,
             early_exit: bool = True,
             content_manager: bool = True,
             cloud_batch_window: float = 0.0,
             cloud_max_batch: int = 1) -> SimResult:
    """Run one deployment strategy over per-client case lists.

    ``cloud_batch_window`` / ``cloud_max_batch`` configure the shared
    cloud service point: with the defaults every request occupies the
    server back-to-back (per-request FIFO — Fig 4's saturation knee);
    with batching on, requests arriving within the window share one
    batched service step, the accounting the live ``CloudBatcher``
    realizes (docs/async_transport.md)."""
    res = SimResult()
    clients = [_Client(cid=i, cases=list(cs))
               for i, cs in enumerate(clients_cases)]
    cloud = CloudServicePoint(0.0, batch_window_s=cloud_batch_window,
                              max_batch=cloud_max_batch)
    hb = _hidden_bytes(split.d_model, half_precision)
    theta_eff = theta if early_exit else 2.0   # never exit early

    heap = [(c.now, c.cid) for c in clients]
    heapq.heapify(heap)
    edge_layers_e1 = split.l_ee1
    edge_layers_e2 = split.l_ee2
    cloud_layers = split.n_layers - split.l_ee1
    pending_backfill: Dict[int, int] = {c.cid: 0 for c in clients}

    def upload_cost(nbytes: float) -> float:
        return nbytes / net.up_bw

    def serialize_cost(nbytes: float) -> float:
        return nbytes / comp.serialize_bw

    while heap:
        _, cid = heapq.heappop(heap)
        c = clients[cid]
        if c.case_idx >= len(c.cases):
            continue
        case = c.cases[c.case_idx]

        if c.tok_idx == 0:
            # open-loop replay: a case stamped with an arrival time in the
            # client's future starts then — the gap is idle, not busy
            if case.arrival_t > c.now:
                c.now = case.arrival_t
            # ---------------- prompt processing (batched prefill) ----------
            p = case.prompt_len
            pf = comp.prefill_discount
            if strategy == "cloud_llm":
                # prompt tokens to cloud, full prefill there
                wire = p * TOKEN_BYTES
                comm = wire / net.up_bw
                res.comm_time += comm
                res.transmitted_mb += wire / 1e6
                svc = p * split.n_layers * comp.cloud_layer_time * pf
                c.now = cloud.service(c.now + comm, svc)
            elif strategy == "naive":
                # edge prefills its partition, ships ALL prompt hiddens sync
                svc_e = p * edge_layers_e2 * comp.edge_layer_time * pf
                res.edge_time += svc_e
                wire = p * hb
                comm = net.rtt / 2 + upload_cost(wire)
                res.comm_time += comm
                res.transmitted_mb += wire / 1e6
                svc_c = (p * (split.n_layers - split.l_ee2)
                         * comp.cloud_layer_time * pf)
                c.now = cloud.service(c.now + svc_e + comm, svc_c) \
                    + net.rtt / 2
            elif strategy in ("ce_collm",):
                svc_e = (p * edge_layers_e2 * comp.edge_layer_time * pf
                         + serialize_cost(p * hb))
                res.edge_time += svc_e
                # prompt hiddens uploaded in parallel with edge prefill:
                # link time overlaps edge compute (content manager batches)
                wire = p * hb if content_manager else 0
                link = upload_cost(wire)
                c.upload_arrival = c.now + max(svc_e, link) + net.rtt / 2
                res.transmitted_mb += wire / 1e6
                # blocked-on-wire time is only the non-overlapped part
                res.comm_time += max(0.0, link - svc_e)
                c.now = c.now + max(svc_e, link if not content_manager else svc_e)
                # cloud prefills its partition from uploaded hiddens (async,
                # needed before the first cloud request)
                svc_c = p * cloud_layers * comp.cloud_layer_time * pf
                c.upload_arrival = cloud.service(c.upload_arrival, svc_c)
            elif strategy == "standalone":
                svc_e = p * edge_layers_e2 * comp.edge_layer_time * pf
                res.edge_time += svc_e
                c.now += svc_e

        if c.tok_idx < len(case.tokens):
            tok = case.tokens[c.tok_idx]
            res.tokens += 1
            if strategy == "cloud_llm":
                # streaming API connection: bytes only, no per-token RTT
                wire = 2 * TOKEN_BYTES
                comm = wire / net.up_bw
                res.comm_time += comm
                res.transmitted_mb += wire / 1e6
                svc = split.n_layers * comp.cloud_layer_time
                c.now = cloud.service(c.now + comm, svc)

            elif strategy == "naive":
                svc_e = edge_layers_e2 * comp.edge_layer_time
                res.edge_time += svc_e
                # the edge re-ships the FULL context's hidden states every
                # token (it does not track cloud state); the cloud keeps a
                # KV cache and only computes the new token.
                ctx = case.prompt_len + c.tok_idx + 1
                wire = ctx * hb
                comm = net.rtt + upload_cost(wire)
                res.comm_time += comm
                res.transmitted_mb += wire / 1e6
                svc_c = (split.n_layers - split.l_ee2) * comp.cloud_layer_time
                ready = c.now + svc_e + net.rtt / 2 + upload_cost(wire)
                c.now = cloud.service(ready, svc_c) + net.rtt / 2

            elif strategy == "standalone":
                svc_e = (edge_layers_e2 * comp.edge_layer_time
                         + 2 * comp.exit_head_time)
                res.edge_time += svc_e
                c.now += svc_e

            elif strategy == "ce_collm":
                # edge: layers 1..l_ee1 + exit head
                t_e1 = edge_layers_e1 * comp.edge_layer_time + comp.exit_head_time
                res.edge_time += t_e1
                now1 = c.now + t_e1
                # parallel upload dispatched at l_ee1 (content manager on)
                if content_manager:
                    wire = hb
                    link_start = max(now1, c.upload_link_free)
                    c.upload_link_free = link_start + upload_cost(wire)
                    upload_arr = c.upload_link_free + net.rtt / 2
                    res.transmitted_mb += wire / 1e6
                    res.edge_time += serialize_cost(wire)
                    now1 += serialize_cost(wire)
                else:
                    upload_arr = None
                if early_exit and tok.conf1 >= theta_eff:
                    c.now = now1
                    if not split.backfill:
                        pending_backfill[cid] = 0  # released by the manager
                    else:
                        pending_backfill[cid] += 1
                else:
                    t_e2 = ((edge_layers_e2 - edge_layers_e1)
                            * comp.edge_layer_time + comp.exit_head_time)
                    res.edge_time += t_e2
                    now2 = now1 + t_e2
                    if early_exit and tok.conf2 >= theta_eff:
                        c.now = now2
                        if not split.backfill:
                            pending_backfill[cid] = 0
                        else:
                            pending_backfill[cid] += 1
                    else:
                        # cloud request
                        res.cloud_requests += 1
                        if content_manager:
                            req_arr = now2 + net.rtt / 2
                            data_ready = max(req_arr, upload_arr)
                            res.comm_time += (data_ready - now2) + net.rtt / 2
                            res.transmitted_mb += TOKEN_BYTES / 1e6
                        else:
                            # sync full-context upload on request (Table 4
                            # "without content manager & parallel upload")
                            ctx = case.prompt_len + c.tok_idx + 1
                            wire = ctx * hb
                            comm = net.rtt + upload_cost(wire)
                            res.comm_time += comm
                            res.transmitted_mb += wire / 1e6
                            data_ready = now2 + net.rtt / 2 + upload_cost(wire)
                        nbf = pending_backfill[cid] if split.backfill else 0
                        svc_c = (1 + nbf) * cloud_layers * comp.cloud_layer_time
                        pending_backfill[cid] = 0
                        c.now = cloud.service(data_ready, svc_c) + net.rtt / 2

            c.tok_idx += 1
            if c.tok_idx >= len(case.tokens):
                c.case_idx += 1
                c.tok_idx = 0
            heapq.heappush(heap, (c.now, cid))
        else:
            c.case_idx += 1
            c.tok_idx = 0
            heapq.heappush(heap, (c.now, cid))

    res.per_client_finish = [c.now for c in clients]
    res.total_time = max(res.per_client_finish) if clients else 0.0
    # server busy time comes from the service point: a batched step serves
    # several requests with ONE service, so summing per request would lie
    res.cloud_time = cloud.busy_s
    if res.tokens:
        res.request_cloud_rate = (res.cloud_requests / res.tokens
                                  if strategy == "ce_collm" else
                                  (1.0 if strategy in ("cloud_llm", "naive")
                                   else 0.0))
    return res
