"""Disaggregated two-tier CE-CoLLM runtime (port of ``repro.core.disagg``).

The edge tier runs layers 1..l_ee2 with the exit heads, the cloud tier
layers l_ee1+1..L, each with its own caches: the paper's edge/cloud split
as two programs.  The JAX package places the tiers on two submeshes, each
with its own parameters (``build(params_edge, params_cloud)``), and moves
the l_ee1 packet with ``jax.device_put``; here each tier has a device
(``edge_device``, ``cloud_device``) and, on CUDA, a stream of its own.

Tiers on two devices (the paper's deployment: an edge on the host CPU, the
cloud on a card), or in two dtypes, are two partition models
(``Model(tier="edge" | "cloud")``): each holds only its own layers, norms
and unembedding, in its own dtype, on its own device, and its ``CoLLM``
reaches nothing of the other's.  From a CPU edge a packet is staged in
one of a small ring of pinned host buffers and copied to the card with a
non-blocking copy on the cloud stream, so an exited token's "parallel
upload" does not hold the edge; the host waits for a reply's event only
where the edge materialises the reply token, which then comes back to
the edge (the downlink: 4 bytes a token, counted in ``decode``'s
``bytes_down``; the channel's row bills the uplink alone, as JAX's).

Tiers on one device and dtype run the one model's weights: on one card
both tiers are ``cuda:0`` and still two streams.  A packet crosses by a
non-blocking copy on the cloud stream after an event of the edge stream,
and the cloud step is queued behind it, so the edge stream keeps running
until the reply token is materialised (``poll``).  Every tensor handed
from one stream to the other is marked with ``record_stream``, so the
caching allocator never reuses its memory while the other stream may
still read it.  On the CPU both tiers run in program order, as the tests
need.

Cloud requests go through ``DeviceTransferChannel``, the
``transport.CloudChannel`` protocol (submit -> poll) over these copies.
Wire bytes are billed per packet as in the JAX package.

``lower_tiers`` is the ahead-of-time view of both tiers, the counterpart
of JAX's lowering: each tier's partition, caches and inputs built on
tensors without storage (``FakeTensorMode``: meta tensors that report the
tier's device as the CPU, so the step takes the plain versions' route),
nothing allocated; its argument and output bytes, and the FLOPs of one
step counted by ``torch.utils.flop_counter.FlopCounterMode``.  One
departure: JAX lowers each tier with the whole model's parameters
(``model.param_specs()``), so its ``argument_size_in_bytes`` counts every
leaf; a port tier holds its partition only, so its parameter bytes equal
the JAX leaves of the tier's layers, norms and unembedding.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.collm import CoLLM, CollmConfig
from repro_torch.core.transport import (CloudChannel, CloudRequest,
                                        dequantize, packet_bytes, quantize)
from repro_torch.models.cache_tree import cache_bytes
from repro_torch.models.transformer import Caches, Model

Packet = Dict[str, torch.Tensor]
PINNED_RING = 4                 # pinned host buffers a CPU edge cycles


def _tier_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    return torch.cuda.Stream(device=device) if device.type == "cuda" else None


def _on(stream: Optional[torch.cuda.Stream]):
    """Run the block on ``stream`` (the CPU's program order when None)."""
    return torch.cuda.stream(stream) if stream is not None else (
        contextlib.nullcontext())


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class DeviceTransferChannel(CloudChannel):
    """``CloudChannel`` over device copies: ``submit_packet`` copies the
    quantized packet to the cloud tier and queues the cloud step behind
    it, both on the cloud stream, and returns without a host sync;
    ``poll`` returns every submitted request with the edge made to wait
    for its reply: a card's edge stream waits on the reply's event, a CPU
    edge (no edge stream) waits on it on the host (the blocking point is
    the caller materialising the reply token, not the dispatch).  Wire
    bytes are billed per request from the packet.

    ``cloud_step(packet, caches, pos) -> (logits, caches)`` runs on the
    cloud stream.  ``host_edge``: the edge runs on the CPU (packets are
    staged through pinned memory, replies waited for on the host)."""

    def __init__(self, cloud_step, cloud_device, *,
                 edge_stream: Optional[torch.cuda.Stream] = None,
                 cloud_stream: Optional[torch.cuda.Stream] = None,
                 host_edge: bool = False):
        super().__init__()
        self._cloud = cloud_step
        self._dev = torch.device(cloud_device)
        self.edge_stream = edge_stream
        self.cloud_stream = cloud_stream
        self.host_edge = host_edge
        self._caches: Optional[Caches] = None
        self._ready: Dict[int, torch.cuda.Event] = {}
        # a CPU edge's staging ring: (pinned buffers by shape and dtype,
        # the event of the copy that last read them)
        self._ring: List[list] = [[{}, None] for _ in range(PINNED_RING)]
        self._next = 0

    def attach_caches(self, caches: Caches) -> None:
        self._caches = caches

    @property
    def caches(self) -> Optional[Caches]:
        return self._caches

    def put(self, packet: Packet) -> Packet:
        """Copy a packet to the cloud tier, the counterpart of
        ``jax.device_put``: on CUDA a non-blocking copy on the cloud stream
        into a buffer of its own, after everything the edge stream has
        queued so far; from host memory through a pinned staging buffer
        (``_stage``)."""
        if self.cloud_stream is None:
            return {k: t.to(self._dev, copy=True) for k, t in packet.items()}
        if self.host_edge:
            return self._stage(packet)
        src = self.edge_stream or torch.cuda.current_stream(self._dev)
        self.cloud_stream.wait_stream(src)
        with torch.cuda.stream(self.cloud_stream):
            out = {k: torch.empty_like(t, device=self._dev).copy_(
                t, non_blocking=True) for k, t in packet.items()}
        for t in packet.values():
            if t.device.type == "cuda":
                t.record_stream(self.cloud_stream)
        return out

    def _stage(self, packet: Packet) -> Packet:
        """A host packet into the next pinned buffers of the ring, then a
        non-blocking copy of each to the card on the cloud stream.  The
        host waits only if that slot's previous copy (``PINNED_RING``
        packets ago) is still in flight."""
        slot = self._ring[self._next]
        self._next = (self._next + 1) % PINNED_RING
        bufs, last = slot
        if last is not None:
            last.synchronize()
        out = {}
        with torch.cuda.stream(self.cloud_stream):
            for k, t in packet.items():
                key = (k, tuple(t.shape), t.dtype)
                host = bufs.get(key)
                if host is None:
                    host = bufs[key] = torch.empty(t.shape, dtype=t.dtype,
                                                   pin_memory=True)
                host.copy_(t)
                out[k] = torch.empty(t.shape, dtype=t.dtype,
                                     device=self._dev).copy_(
                    host, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self.cloud_stream)
        slot[1] = ev
        return out

    def submit_packet(self, packet: Packet, pos, *, slot: int = 0,
                      seq: int = 0, now: float = 0.0) -> int:
        """Transfer + dispatch one cloud request; returns the handle."""
        pkt = self.put(packet)
        with _on(self.cloud_stream):
            logits, self._caches = self._cloud(pkt, self._caches, int(pos))
        handle = self.submit(slot=slot, seq=seq, pos=int(pos), reply=logits,
                             now=now, nbytes_up=packet_bytes(packet))
        if self.cloud_stream is not None:
            ev = torch.cuda.Event()
            ev.record(self.cloud_stream)
            self._ready[handle] = ev
        return handle

    def poll(self, now: float = float("inf")) -> List[CloudRequest]:
        """Every arrived reply, each readable on the edge: on its stream,
        or for a CPU edge on the host."""
        due = super().poll(now)
        for r in due:
            ev = self._ready.pop(r.handle, None)
            if ev is None:
                continue
            if self.host_edge:
                ev.synchronize()
                continue
            edge = self.edge_stream or torch.cuda.current_stream(self._dev)
            edge.wait_event(ev)
            r.reply.record_stream(edge)
        return due

    def reset(self) -> None:
        super().reset()
        self._ready.clear()


def stream_prompt_upload(channel: DeviceTransferChannel, h1: torch.Tensor,
                         fmt: str, chunk: int,
                         dtype=torch.float32) -> torch.Tensor:
    """Pipeline the prompt hidden-state upload in ``chunk``-token slices
    instead of one monolithic packet: each slice is quantized and its copy
    queued at once (from a CPU edge through the pinned ring), so slice
    i+1's quantize overlaps slice i's transfer.  Wire bytes are billed
    per slice; int8 slices carry their own scales.  Returns the
    dequantized hidden sequence on the cloud tier (in ``dtype``), ready
    for ``cloud_prefill``."""
    parts = []
    for i in range(0, h1.shape[1], chunk):
        sl = quantize(h1[:, i:i + chunk], fmt)
        channel.notify_upload(0, packet_bytes(sl), 0.0)
        parts.append(channel.put(sl))
    with _on(channel.cloud_stream):
        return torch.cat([dequantize(p, dtype) for p in parts], dim=1)


@dataclasses.dataclass
class LoweredTier:
    """One tier lowered ahead of time on tensors without storage: what
    ``memory_analysis`` and ``cost_analysis`` of JAX's compiled tier
    report, counted from the port's partition.  ``collectives``: the
    ``sharding.records()`` of one step on a recording mesh (empty
    without a mesh)."""
    name: str
    cfg: object
    dtype: torch.dtype
    param_names: Tuple[str, ...]
    param_bytes: int
    cache_bytes: int
    input_bytes: int            # the token or the upload packet, and pos
    output_bytes: int
    flops: int
    collectives: List[Dict]

    @property
    def argument_bytes(self) -> int:
        return self.param_bytes + self.cache_bytes + self.input_bytes

    def memory_analysis(self) -> Dict[str, Optional[int]]:
        """JAX's keys; ``temp_size_in_bytes`` is None (no compiler plans
        the port's temporaries ahead of time)."""
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": None}

    def cost_analysis(self) -> Dict[str, float]:
        return {"flops": float(self.flops)}

    def materialize(self, device, dtype=None) -> Model:
        """The live partition on ``device`` (weights not yet set)."""
        return Model(self.cfg, device=device, dtype=dtype or self.dtype,
                     tier=self.name)


@torch.no_grad()
def _lower_tier(name: str, cfg, ccfg: CollmConfig, dtype, batch: int,
                max_seq: int, mesh: Optional[Tuple[int, int]] = None
                ) -> LoweredTier:
    """``name``'s partition, caches and inputs on tensors without storage,
    one step of it under a FLOP counter; with ``mesh`` (data, model) the
    cloud tier of rank 0 on a recording mesh of that shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import recording_mesh

    ccfg = dataclasses.replace(ccfg, cloud_mesh=None)
    with FakeTensorMode():
        cmesh = recording_mesh(mesh, "cpu") if mesh is not None else None
        model = Model(cfg, device="cpu", dtype=dtype, tier=name,
                      axis=cmesh.model_axis if cmesh is not None else None)
        co = CoLLM(model, ccfg, mesh=cmesh)
        pos = torch.zeros((), dtype=torch.int32)
        if name == "edge":
            caches = co.init_edge_cache(batch, max_seq)
            inputs = {"token": torch.zeros((batch, 1), dtype=torch.int32)}
        else:
            caches = co.init_cloud_cache(batch, max_seq)
            inputs = _upload(batch, cfg.d_model, ccfg.wire_format)
        saved = (dict(sharding.COUNTS), dict(sharding.SECONDS),
                 dict(sharding.CALLS))
        sharding.reset_counts()
        with FlopCounterMode(display=False) as fc:
            if name == "edge":
                out = co.edge_step(inputs["token"], caches, pos)
                outs = (out.token.to(torch.int32), out.exited, out.upload,
                        out.caches)
            else:
                logits, c = co.cloud_step(inputs, caches, pos)
                outs = (logits.argmax(-1).to(torch.int32), c)
        records = sharding.records()
        for table, was in zip((sharding.COUNTS, sharding.SECONDS,
                               sharding.CALLS), saved):
            table.clear()
            table.update(was)
        return LoweredTier(
            name=name, cfg=cfg, dtype=dtype,
            param_names=tuple(n for n, _ in model.named_parameters()),
            param_bytes=sum(p.numel() * p.element_size()
                            for p in model.parameters()),
            cache_bytes=cache_bytes(caches),
            input_bytes=cache_bytes(inputs) + cache_bytes(pos),
            output_bytes=cache_bytes(list(outs)),
            flops=int(fc.get_total_flops()), collectives=records)


def _upload(batch: int, d: int, fmt: str) -> Packet:
    """The l_ee1 packet of one decode step, as JAX's lowering shapes it."""
    dt = {"float32": torch.float32, "float16": torch.float16,
          "int8": torch.int8}[fmt]
    pkt = {"data": torch.zeros((batch, 1, d), dtype=dt)}
    if fmt == "int8":
        pkt["scale"] = torch.zeros((batch, 1, 1), dtype=torch.float32)
    return pkt


class TwoTierRuntime:
    """The edge partition on ``edge_device`` and the cloud partition on
    ``cloud_device``, each with its own stream and caches; only quantized
    packets move between them.

    On one device in the model's dtype both tiers run ``model``'s
    weights.  On two devices, or with ``edge_dtype`` / ``cloud_dtype``
    other than the model's, or with ``split=True``, ``build`` makes each
    tier a partition model of its own (``Model(tier=)``) on its device in
    its dtype, its weights copied from ``model`` or given to ``build``
    as the tier's state dict (``bridge.params_from_jax(tier=)``, JAX's
    ``build(params_edge, params_cloud)``); the runtime then keeps no
    reference to ``model``.  No tier runs on the meta device:
    ``lower_tiers`` is the ahead-of-time view."""

    def __init__(self, model: Model, ccfg: CollmConfig, edge_device,
                 cloud_device, *, edge_dtype: Optional[torch.dtype] = None,
                 cloud_dtype: Optional[torch.dtype] = None,
                 split: Optional[bool] = None):
        self.model = model
        self.cfg = model.cfg
        self.ccfg = ccfg
        self.edge_device = torch.device(edge_device)
        self.cloud_device = torch.device(cloud_device)
        self.edge_dtype = edge_dtype or model.dtype
        self.cloud_dtype = cloud_dtype or model.dtype
        if split is None:
            split = (self.edge_device != self.cloud_device
                     or self.edge_dtype != model.dtype
                     or self.cloud_dtype != model.dtype)
        self.split = split
        if split:
            for dev in (self.edge_device, self.cloud_device):
                if dev.type == "meta":
                    raise ValueError("a live tier on the meta device: "
                                     "lower_tiers is the tiers' view there")
            return
        for dev in (self.edge_device, self.cloud_device):
            if dev.type != model.device.type or (
                    dev.index is not None and dev.index != model.device.index):
                raise ValueError(f"a tier on {dev}, the model on "
                                 f"{model.device}: tiers on two devices "
                                 f"are two partitions (split=True)")
        self.edge_model = self.cloud_model = model
        self.collm = self.edge_collm = self.cloud_collm = CoLLM(model, ccfg)

    # -- lowering (also used by the technique dry run) ----------------------
    def lower_tiers(self, batch: int, max_seq: int,
                    cloud_mesh: Optional[Tuple[int, int]] = None
                    ) -> Tuple[LoweredTier, LoweredTier, Dict]:
        """Both tiers at ``batch`` rows of ``max_seq`` positions, on
        tensors without storage (module docstring): (edge, cloud,
        {"wire_bytes_per_token"}), the wire bytes of one decode step's
        upload of every row, as JAX's.  ``cloud_mesh`` (data, model): the
        cloud tier is rank 0's share on a recording mesh of that shape,
        its collectives recorded."""
        edge = _lower_tier("edge", self.cfg, self.ccfg, self.edge_dtype,
                           batch, max_seq)
        cloud = _lower_tier("cloud", self.cfg, self.ccfg, self.cloud_dtype,
                            batch, max_seq, cloud_mesh)
        wire = packet_bytes(_upload(batch, self.cfg.d_model,
                                    self.ccfg.wire_format))
        return edge, cloud, {"wire_bytes_per_token": wire}

    # -- live serving ------------------------------------------------------
    def build(self, params_edge: Optional[Dict[str, torch.Tensor]] = None,
              params_cloud: Optional[Dict[str, torch.Tensor]] = None
              ) -> None:
        """Make the tiers (split: each partition on its device, its
        weights from ``params_*`` or the model), their streams and the
        channel."""
        if self.split:
            whole = None
            if params_edge is None or params_cloud is None:
                whole = self.model.state_dict()
            self.edge_model = self._tier("edge", self.edge_device,
                                         self.edge_dtype, params_edge, whole)
            self.cloud_model = self._tier("cloud", self.cloud_device,
                                          self.cloud_dtype, params_cloud,
                                          whole)
            del whole
            self.model = None
            self.edge_collm = CoLLM(self.edge_model, self.ccfg)
            self.cloud_collm = CoLLM(self.cloud_model, self.ccfg)
        self.edge_stream = _tier_stream(self.edge_device)
        self.cloud_stream = _tier_stream(self.cloud_device)
        co = self.cloud_collm
        self.channel = DeviceTransferChannel(
            lambda pkt, caches, pos: co.cloud_step(pkt, caches, pos),
            self.cloud_device, edge_stream=self.edge_stream,
            cloud_stream=self.cloud_stream,
            host_edge=(self.edge_device.type == "cpu"
                       and self.cloud_stream is not None))

    def _tier(self, name, device, dtype, params, whole) -> Model:
        """The live ``name`` tier: ``params`` itself when it is that tier's
        model already (its weights shared, nothing copied), else a new
        partition loaded from ``params`` (a state dict) or ``whole``."""
        if isinstance(params, Model):
            if (params.tier, params.dtype) != (name, dtype) or \
                    not _same_device(params.device, device):
                raise ValueError(f"a {params.tier} tier in {params.dtype} "
                                 f"on {params.device} for the {name} tier "
                                 f"in {dtype} on {device}")
            return params
        return Model(self.cfg, device=device, dtype=dtype,
                     tier=name).load_whole(
            params if params is not None else whole)

    @property
    def _crosses(self) -> bool:
        """The tiers are on two devices."""
        return not _same_device(self.edge_device, self.cloud_device)

    def _downlink(self, tok: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """A cloud token on the edge device, and the bytes it crossed in
        (int32 ids; 0 on one device).  From a card to a CPU edge the copy
        runs on the cloud stream and blocks the host until it is there."""
        if not self._crosses:
            return tok, 0
        with _on(self.cloud_stream):
            tok = tok.to(torch.int32)
            return (tok.to(self.edge_device).long(),
                    tok.numel() * tok.element_size())

    def _reply_token(self, logits: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """A reply's greedy token on the edge, and its downlink bytes: on
        two devices the argmax runs on the cloud's stream first."""
        if not self._crosses:
            return logits.argmax(-1), 0
        with _on(self.cloud_stream):
            return self._downlink(logits.argmax(-1))

    @torch.no_grad()
    def decode(self, prompt, max_new: int, max_seq: int = 256,
               upload_chunk: int = 0):
        """Single-stream decode across the two tiers.  Every cloud request
        goes submit -> poll through ``self.channel``; the transfer and the
        cloud step are queued on the cloud stream and the edge only blocks
        when it materialises the reply token.  ``upload_chunk > 0``
        streams the prompt upload in that many-token slices
        (``stream_prompt_upload``) instead of one packet.

        Returns (tokens, info): ``wire_bytes`` after the prompt upload,
        the channel's row, ``tick_s``, the host seconds of each decode
        tick (edge step to materialised token), ``round_trip_s``, those
        of each cloud request (submit to the reply token on the edge),
        ``confidences``, each tick's (l_ee1, l_ee2) exit confidences, and
        ``bytes_down``, the reply tokens' bytes from the cloud's device to
        the edge's."""
        ec, cc, chan = self.edge_collm, self.cloud_collm, self.channel
        fmt, dtype = self.ccfg.wire_format, self.cloud_model.dtype
        with _on(self.edge_stream):
            prompt = torch.as_tensor(prompt, device=self.edge_device)
            prompt = prompt.reshape(1, -1).long()
            e_caches = ec.init_edge_cache(1, max_seq)
        with _on(self.cloud_stream):
            chan.attach_caches(cc.init_cloud_cache(1, max_seq))
        with _on(self.edge_stream):
            _, h1, e_caches = ec.edge_prefill({"tokens": prompt}, e_caches)
            if upload_chunk > 0:
                h1c = stream_prompt_upload(chan, h1, fmt, upload_chunk,
                                           dtype)
            else:
                h1q = quantize(h1, fmt)
                chan.notify_upload(0, packet_bytes(h1q), 0.0)
                h1q = chan.put(h1q)                  # prompt upload
                with _on(self.cloud_stream):
                    h1c = dequantize(h1q, dtype)
        with _on(self.cloud_stream):
            logits, c_caches = cc.cloud_prefill(h1c, chan.caches)
            chan.attach_caches(c_caches)
            tok = logits[:, 0].argmax(-1)
        if self.cloud_stream is not None and self.edge_stream is not None:
            self.edge_stream.wait_stream(self.cloud_stream)
            tok.record_stream(self.edge_stream)
        tok, down = self._downlink(tok)
        wire0 = chan.stats.bytes_up
        pos = prompt.shape[1]
        ticks, trips, confs = [], [], []
        l1, l2 = ec.l_ee1, ec.l_ee2
        with _on(self.edge_stream):
            toks = [int(tok[0])]
            for _ in range(max_new - 1):
                t0 = time.perf_counter()
                out = ec.edge_step(tok[:, None], e_caches, pos)
                e_caches = out.caches
                t1 = None
                if bool(out.exited[0]):
                    # parallel upload: queue the copy, the edge continues
                    chan.notify_upload(0, packet_bytes(out.upload), 0.0)
                    chan.put(out.upload)
                    tok = out.token.to(torch.long)
                else:
                    t1 = time.perf_counter()
                    chan.submit_packet(out.upload, pos)
                    (rep,) = chan.poll()
                    tok, nbytes = self._reply_token(rep.reply)
                    down += nbytes
                toks.append(int(tok[0]))
                now = time.perf_counter()
                if t1 is not None:
                    trips.append(now - t1)
                ticks.append(now - t0)
                confs.append((float(out.decisions[l1].confidence[0]),
                              float(out.decisions[l2].confidence[0])))
                pos += 1
        if self.cloud_stream is not None:
            self.cloud_stream.synchronize()
        return toks, {"wire_bytes": chan.stats.bytes_up - wire0,
                      "channel": chan.stats.as_row(), "tick_s": ticks,
                      "round_trip_s": trips, "confidences": confs,
                      "bytes_down": down}
