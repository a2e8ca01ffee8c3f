"""Edge<->cloud transport: wire formats, quantization, packet accounting and
the cloud channel protocol (paper §4.2/§4.3).

Port of ``repro.core.transport`` for the token-activation packet.  The
paper uploads hidden states in float16; int8 with a per-row absmax scale
is the beyond-paper format, quantized by the ``quantize`` kernel
(``repro_torch.kernels.quantize``).  Wire sizes are computed from shapes.
The recurrent-state packets (``quantize_tree``, ``dequantize_tree``,
``make_packet``, ``open_packet``) carry a state tree beside the hidden:
every leaf quantized alone, an int8 leaf with its own float32 scales.

``CloudChannel`` is the request path of both serving engines, in virtual
time:

  * ``submit(...) -> handle`` dispatches one cloud request; the engine
    keeps decoding while the reply is in flight;
  * ``poll(now)`` drains the replies that have arrived by ``now``, in
    arrival order;
  * every request carries a deadline; the engine commits the edge token
    when the reply misses it (the paper's latency-aware early exit).

``SyncChannel`` (zero latency, infinite deadline) is a blocking call;
``AsyncSimChannel`` prices each request with ``netsim.NetworkParams``-style
link parameters and a ``CloudServicePoint`` shared by every client;
``ScriptedChannel`` replays an explicit per-request latency trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.quantize.ops import quantize_int8
from repro_torch.models.cache_tree import map_tensors

Pytree = Any

FORMATS = ("float32", "float16", "int8")

# Wire size of one token id + framing, shared by every billing site.
TOKEN_BYTES = 8

_ITEMSIZE = {"float32": 4, "float16": 2, "int8": 1}


def draft_request_bytes(k: int) -> int:
    """Wire size of a k-token draft verification request: the k provisional
    token ids ride the request control message (the k hidden states were
    already billed by their per-tick uploads)."""
    return int(k) * TOKEN_BYTES


def hidden_wire_bytes(d_model: int, fmt: str, seq: int = 1) -> int:
    """Wire size of a ``seq``-long hidden-state upload in format ``fmt``:
    the payload, plus one float32 scale per row for int8."""
    if fmt not in _ITEMSIZE:
        raise ValueError(fmt)
    scale = 4 * seq if fmt == "int8" else 0
    return seq * d_model * _ITEMSIZE[fmt] + scale


def prompt_upload_bytes(d_model: int, fmt: str, prompt_len: int,
                        hit_tokens: int = 0) -> int:
    """Wire size of one stream's prompt hidden-state upload: only the
    ``prompt_len - hit_tokens`` positions not already held by the cloud
    cross the wire."""
    send = max(0, int(prompt_len) - int(hit_tokens))
    if send == 0:
        return 0
    return hidden_wire_bytes(d_model, fmt, seq=send)


def quantize(x: torch.Tensor, fmt: str) -> Dict[str, torch.Tensor]:
    if fmt == "float32":
        return {"data": x.float()}
    if fmt == "float16":
        return {"data": x.half()}
    if fmt == "int8":
        d = x.shape[-1]
        q, scale = quantize_int8(x.reshape(-1, d).contiguous())
        return {"data": q.reshape(x.shape),
                "scale": scale.reshape(*x.shape[:-1], 1)}
    raise ValueError(fmt)


def dequantize(packet: Dict[str, torch.Tensor],
               dtype=torch.float32) -> torch.Tensor:
    data = packet["data"]
    if data.dtype == torch.int8:
        return (data.float() * packet["scale"]).to(dtype)
    return data.to(dtype)


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def packet_bytes(packet: Pytree) -> int:
    """Wire size of a (possibly nested) packet in bytes."""
    return sum(packet_breakdown(packet).values())


def packet_breakdown(packet: Pytree) -> Dict[str, int]:
    """Wire bytes of a (possibly nested) packet split by role:
    ``{"data": ..., "scale": ...}`` — every int8 leaf packet's float32
    scale is billed explicitly."""
    out = {"data": 0, "scale": 0}

    def walk(node):
        if isinstance(node, dict) and "data" in node:
            for key, leaf in node.items():
                out["scale" if key == "scale" else "data"] += _nbytes(leaf)
            return
        if isinstance(node, dict):
            for child in node.values():
                walk(child)
        elif isinstance(node, (list, tuple)):
            for child in node:
                walk(child)
        else:
            out["data"] += _nbytes(node)

    walk(packet)
    return out


def quantize_tree(tree: Pytree, fmt: str) -> Pytree:
    """Quantize every tensor leaf of a state snapshot."""
    return map_tensors(tree, lambda x: quantize(x, fmt))


def dequantize_tree(tree: Pytree, dtype=torch.float32) -> Pytree:
    return map_tensors(tree, lambda p: dequantize(p, dtype),
                       lambda t: isinstance(t, dict) and "data" in t)


@dataclasses.dataclass
class StatePacket:
    """What crosses the edge->cloud boundary for one upload (paper fig 3
    step 3): the quantized l_ee1 token activation, and (SSM/hybrid only)
    boundary recurrent-state snapshots, each int8 leaf with its own
    float32 scales (billed under ``scale``)."""
    hidden: Dict[str, torch.Tensor]                # quantized (B,1,d)
    states: Optional[Pytree] = None                # quantized recurrent states
    pos: Any = None                                # token position(s)

    def nbytes(self) -> int:
        return sum(self.wire_breakdown().values())

    def wire_breakdown(self) -> Dict[str, int]:
        """Wire bytes split into ``{"data", "scale", "pos"}``; positions go
        over the wire as int32, one per row."""
        bd = packet_breakdown(self.hidden)
        if self.states is not None:
            sbd = packet_breakdown(self.states)
            bd = {k: bd[k] + sbd[k] for k in bd}
        bd["pos"] = (4 * int(np.asarray(self.pos).size)
                     if self.pos is not None else 0)
        return bd


def make_packet(hidden: torch.Tensor, fmt: str, *, states: Pytree = None,
                pos: Any = None) -> StatePacket:
    return StatePacket(
        hidden=quantize(hidden, fmt),
        states=quantize_tree(states, fmt) if states is not None else None,
        pos=pos)


def open_packet(pkt: StatePacket, dtype=torch.float32):
    """(hidden, states) back from a packet, in ``dtype``."""
    hidden = dequantize(pkt.hidden, dtype)
    states = (dequantize_tree(pkt.states, dtype)
              if pkt.states is not None else None)
    return hidden, states


# ---------------------------------------------------------------------------
# Cloud service point (the shared cloud server queue, in virtual time)
# ---------------------------------------------------------------------------
class CloudServicePoint:
    """The cloud server's service queue, shared by every client channel.

    With the default knobs (``batch_window_s=0``, ``max_batch=1``) every
    request occupies the server for ``service_s`` back to back: N
    concurrent clients serialize, the saturation knee of the paper's Fig 4.
    With batching on, requests that become ready within ``batch_window_s``
    of the first one (up to ``max_batch``) share ONE ``service_s``, the
    masked batched cloud step the ``CloudBatcher`` executes, so the knee
    moves from N*service_s to service_s + window.

    ``service(ready_t, service_s=None)`` books one request that is ready at
    virtual time ``ready_t`` and returns its completion time; a joining
    request with a larger service cost stretches the batch's completion.
    ``window_controller`` is duck-typed: anything with ``observe(ready_t,
    point) -> window`` and ``reset()`` retunes the window on every booking
    (``None`` keeps the static knob).  Both ``netsim.simulate`` and
    ``AsyncSimChannel`` price the cloud through this class."""

    def __init__(self, service_s: float = 0.0, *,
                 batch_window_s: float = 0.0, max_batch: int = 1,
                 window_controller: Any = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if batch_window_s > 0.0 and max_batch == 1:
            # the window would delay every request with nothing ever
            # joining a batch: strictly worse than FIFO
            raise ValueError("batch_window_s > 0 requires max_batch > 1 "
                             "(a window with max_batch=1 never coalesces)")
        self.service_s = float(service_s)
        self.batch_window_s = float(batch_window_s)
        self._init_window_s = self.batch_window_s
        self.max_batch = int(max_batch)
        self.window_controller = window_controller
        self.reset()

    def reset(self) -> None:
        """Forget all virtual-time state (a fresh run on a reused point)."""
        self._free = 0.0           # when the server is next idle
        self._close_t = -math.inf  # open batch's accumulation window end
        self._start_t = 0.0        # open batch's service start
        self._done_t = 0.0         # open batch's completion
        self._count = 0            # requests in the open batch
        self.batches = 0           # total batched service steps booked
        self.requests = 0
        self.busy_s = 0.0          # summed server busy time (per batch)
        self.batch_window_s = self._init_window_s
        if self.window_controller is not None:
            self.window_controller.reset()

    @property
    def batched(self) -> bool:
        return self.max_batch > 1 or self.batch_window_s > 0.0

    def service(self, ready_t: float, service_s: Optional[float] = None
                ) -> float:
        svc = self.service_s if service_s is None else float(service_s)
        self.requests += 1
        if self.window_controller is not None:
            self.batch_window_s = float(
                self.window_controller.observe(ready_t, self))
        if self._count and self._count < self.max_batch \
                and ready_t <= self._close_t:
            # join the open batch: one masked step serves this request too;
            # a costlier member (backfill ring) stretches the completion
            self._count += 1
            stretched = max(self._done_t, self._start_t + svc)
            self.busy_s += stretched - self._done_t
            self._done_t = stretched
            self._free = max(self._free, self._done_t)
            return self._done_t
        # open a new batch: wait out the accumulation window, then serve
        self.batches += 1
        self._count = 1
        self._close_t = ready_t + self.batch_window_s
        self._start_t = max(self._close_t, self._free)
        self._done_t = self._start_t + svc
        self._free = self._done_t
        self.busy_s += svc
        return self._done_t


# ---------------------------------------------------------------------------
# Cloud channel (edge->cloud request path)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CloudRequest:
    """One in-flight cloud request; ``reply`` is the caller's payload (the
    cloud logits, still on the device)."""
    handle: int
    slot: int
    seq: int
    pos: int
    reply: Any
    submit_t: float
    arrival_t: float
    deadline_t: float
    nbytes_up: int = 0
    nbytes_down: int = 0


@dataclasses.dataclass
class ChannelStats:
    requests: int = 0
    replies: int = 0
    dropped: int = 0            # submitted but never delivered
    bytes_up: int = 0           # requests + notified uploads
    bytes_down: int = 0         # delivered replies only
    flight_s: float = 0.0       # summed virtual in-flight time of delivered
                                # replies (billed at poll)

    def as_row(self) -> Dict[str, float]:
        return {"requests": self.requests, "replies": self.replies,
                "dropped": self.dropped,
                "bytes_up": self.bytes_up, "bytes_down": self.bytes_down,
                "flight_s": round(self.flight_s, 4)}


class CloudChannel:
    """Base channel: immediate arrival (a blocking call in disguise).

    Subclasses override ``_latency`` (virtual seconds between submit and
    reply arrival) and optionally ``notify_upload``.  ``deadline_s`` is the
    per-request reply budget; ``math.inf`` disables the latency-aware early
    exit."""

    def __init__(self, deadline_s: float = math.inf):
        self.deadline_s = float(deadline_s)
        self._next_handle = 0
        self._inflight: Dict[int, CloudRequest] = {}
        self.stats = ChannelStats()

    def submit(self, *, slot: int = 0, seq: int = 0, pos: int = 0,
               reply: Any = None, now: float = 0.0, nbytes_up: int = 0,
               nbytes_down: int = 0) -> int:
        handle = self._next_handle
        self._next_handle += 1
        arrival = now + self._latency(slot, now, nbytes_up, nbytes_down)
        self._inflight[handle] = CloudRequest(
            handle=handle, slot=slot, seq=seq, pos=pos, reply=reply,
            submit_t=now, arrival_t=arrival,
            deadline_t=now + self.deadline_s,
            nbytes_up=nbytes_up, nbytes_down=nbytes_down)
        # only the request side is billed here; the reply's bytes and
        # flight time are billed when ``poll`` delivers it
        self.stats.requests += 1
        self.stats.bytes_up += nbytes_up
        return handle

    def poll(self, now: float = math.inf) -> List[CloudRequest]:
        """Drain every reply that has arrived by virtual time ``now``, in
        arrival order."""
        due = sorted((r for r in self._inflight.values()
                      if r.arrival_t <= now), key=lambda r: r.arrival_t)
        for r in due:
            del self._inflight[r.handle]
            self.stats.bytes_down += r.nbytes_down
            self.stats.flight_s += r.arrival_t - r.submit_t
        self.stats.replies += len(due)
        return due

    def next_arrival(self) -> Optional[float]:
        if not self._inflight:
            return None
        return min(r.arrival_t for r in self._inflight.values())

    def arrival_of(self, handle: int) -> Optional[float]:
        """Arrival time of one in-flight request (None once drained): the
        blocking drain waits for a whole dispatch batch with this."""
        req = self._inflight.get(handle)
        return None if req is None else req.arrival_t

    def in_flight(self) -> int:
        return len(self._inflight)

    def notify_upload(self, slot: int, nbytes: int, now: float) -> None:
        """Account a parallel upload that is not itself a request."""
        del slot, now
        self.stats.bytes_up += nbytes

    def drop_in_flight(self) -> int:
        """Discard every in-flight request without billing it."""
        n = len(self._inflight)
        self._inflight.clear()
        self.stats.dropped += n
        return n

    def reset(self) -> None:
        """Forget virtual-time state between runs (stats survive)."""
        self.drop_in_flight()

    def _latency(self, slot: int, now: float, nbytes_up: int,
                 nbytes_down: int) -> float:
        del slot, now, nbytes_up, nbytes_down
        return 0.0


class SyncChannel(CloudChannel):
    """Zero-latency, infinite-deadline channel: a blocking call."""

    def __init__(self):
        super().__init__(deadline_s=math.inf)


class AsyncSimChannel(CloudChannel):
    """Virtual-time network channel priced by ``netsim.NetworkParams``.

    Each engine slot owns its WiFi-class link (paper §5: one link per edge
    client); the cloud is a ``CloudServicePoint`` shared by every request,
    the accounting ``netsim.simulate`` uses.  Passing one ``service`` to
    several channels models N edge clients sharing one cloud server.

      arrival = cloud_done + rtt/2 + nbytes_down / down_bw
      cloud_done = service.service(uplink_arrival)
      uplink_arrival = max(now, uplink_free[slot]) + nbytes_up/up_bw + rtt/2

    ``net`` is duck-typed: anything with up_bw / down_bw / rtt fields."""

    def __init__(self, net: Any, *, service_s: float = 0.0,
                 deadline_s: float = math.inf,
                 service: Optional[CloudServicePoint] = None):
        super().__init__(deadline_s=deadline_s)
        self.net = net
        self._own_service = service is None
        self.service = (CloudServicePoint(service_s) if service is None
                        else service)
        self._uplink_free: Dict[int, float] = {}

    def _latency(self, slot: int, now: float, nbytes_up: int,
                 nbytes_down: int) -> float:
        link_free = max(now, self._uplink_free.get(slot, 0.0))
        up_arr = link_free + nbytes_up / self.net.up_bw + self.net.rtt / 2
        self._uplink_free[slot] = link_free + nbytes_up / self.net.up_bw
        cloud_done = self.service.service(up_arr)
        arrival = (cloud_done + self.net.rtt / 2
                   + nbytes_down / self.net.down_bw)
        return arrival - now

    def notify_upload(self, slot: int, nbytes: int, now: float) -> None:
        super().notify_upload(slot, nbytes, now)
        # the l_ee1 upload occupies this client's uplink: a request issued
        # right after it queues behind it
        link_free = max(now, self._uplink_free.get(slot, 0.0))
        self._uplink_free[slot] = link_free + nbytes / self.net.up_bw

    def reset(self) -> None:
        super().reset()
        self._uplink_free.clear()
        # a shared service point is reset once per run by ``run_multi``,
        # not once per channel
        if self._own_service:
            self.service.reset()


class ScriptedChannel(CloudChannel):
    """Replay an explicit per-request latency trace (request i takes
    ``latencies[i % len]`` virtual seconds): the deterministic harness of
    the deadline-miss and reply-reordering tests."""

    def __init__(self, latencies, *, deadline_s: float = math.inf):
        super().__init__(deadline_s=deadline_s)
        self.latencies = list(latencies)
        if not self.latencies:
            raise ValueError("ScriptedChannel needs at least one latency")
        self._i = 0

    def _latency(self, slot: int, now: float, nbytes_up: int,
                 nbytes_down: int) -> float:
        lat = float(self.latencies[self._i % len(self.latencies)])
        self._i += 1
        return lat

    def reset(self) -> None:
        super().reset()
        self._i = 0          # a reused channel replays the trace from the top
