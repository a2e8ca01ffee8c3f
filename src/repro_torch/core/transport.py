"""Edge<->cloud transport: wire formats, quantization, packet accounting and
the cloud channel protocol (paper §4.2/§4.3).

Port of the wire half and the channel base of ``repro.core.transport``.
The paper uploads hidden states in float16; int8 with a per-row absmax
scale is the beyond-paper format, quantized by the ``quantize`` kernel
(``repro_torch.kernels.quantize``).  Wire sizes are computed from shapes.

``CloudChannel`` is the request path of both serving engines:
``submit(...) -> handle`` dispatches one cloud request, ``poll(now)``
drains the replies that have arrived by virtual time ``now``.
``SyncChannel`` (zero latency, infinite deadline) is a blocking call.  The
simulated and scripted channels and the shared cloud service point are not
ported yet (ROADMAP A.4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.quantize.ops import quantize_int8

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


@dataclasses.dataclass
class StatePacket:
    """What crosses the edge->cloud boundary for one upload (paper fig 3
    step 3): the quantized l_ee1 token activation, and (SSM/hybrid
    architectures, not ported yet) boundary recurrent-state snapshots."""
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
