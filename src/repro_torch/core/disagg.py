"""Disaggregated two-tier CE-CoLLM runtime (port of ``repro.core.disagg``).

The edge tier runs layers 1..l_ee2 with the exit heads, the cloud tier
layers l_ee1+1..L, each with its own caches: the paper's edge/cloud split
as two programs.  The JAX package places the tiers on two submeshes and
moves the l_ee1 packet with ``jax.device_put``; here each tier has a
device (``edge_device``, ``cloud_device``) and, on CUDA, a stream of its
own.  On one card both tiers are ``cuda:0`` and still two streams: a
packet crosses by a non-blocking copy on the cloud stream after an event
of the edge stream, and the cloud step is queued behind it, so the edge
stream keeps running until the reply token is materialised (``poll``).
An exited token's "parallel upload" is such a copy that the edge never
waits for.  Every tensor handed from one stream to the other is marked
with ``record_stream``, so the caching allocator never reuses its memory
while the other stream may still read it.  On the CPU both tiers run in
program order, as the tests need.

Cloud requests go through ``DeviceTransferChannel``, the
``transport.CloudChannel`` protocol (submit -> poll) over these copies.
Wire bytes are billed per packet as in the JAX package.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

from repro_torch.core.collm import CoLLM, CollmConfig
from repro_torch.core.transport import (CloudChannel, CloudRequest,
                                        dequantize, packet_bytes, quantize)
from repro_torch.models.transformer import Caches, Model

Packet = Dict[str, torch.Tensor]


def _tier_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    return torch.cuda.Stream(device=device) if device.type == "cuda" else None


def _on(stream: Optional[torch.cuda.Stream]):
    """Run the block on ``stream`` (the CPU's program order when None)."""
    return torch.cuda.stream(stream) if stream is not None else (
        contextlib.nullcontext())


class DeviceTransferChannel(CloudChannel):
    """``CloudChannel`` over device copies: ``submit_packet`` copies the
    quantized packet to the cloud tier and queues the cloud step behind
    it, both on the cloud stream, and returns without a host sync;
    ``poll`` returns every submitted request with the edge stream made to
    wait for its reply (the blocking point is the caller materialising the
    reply token, not the dispatch).  Wire bytes are billed per request
    from the packet.

    ``cloud_step(packet, caches, pos) -> (logits, caches)`` runs on the
    cloud stream."""

    def __init__(self, cloud_step, cloud_device, *,
                 edge_stream: Optional[torch.cuda.Stream] = None,
                 cloud_stream: Optional[torch.cuda.Stream] = None):
        super().__init__()
        self._cloud = cloud_step
        self._dev = torch.device(cloud_device)
        self.edge_stream = edge_stream
        self.cloud_stream = cloud_stream
        self._caches: Optional[Caches] = None
        self._ready: Dict[int, torch.cuda.Event] = {}

    def attach_caches(self, caches: Caches) -> None:
        self._caches = caches

    @property
    def caches(self) -> Optional[Caches]:
        return self._caches

    def put(self, packet: Packet) -> Packet:
        """Copy a packet to the cloud tier, the counterpart of
        ``jax.device_put``: on CUDA a non-blocking copy on the cloud stream
        into a buffer of its own, after everything the edge stream has
        queued so far."""
        if self.cloud_stream is None:
            return {k: t.to(self._dev, copy=True) for k, t in packet.items()}
        src = self.edge_stream or torch.cuda.current_stream(self._dev)
        self.cloud_stream.wait_stream(src)
        with torch.cuda.stream(self.cloud_stream):
            out = {k: torch.empty_like(t, device=self._dev).copy_(
                t, non_blocking=True) for k, t in packet.items()}
        for t in packet.values():
            if t.device.type == "cuda":
                t.record_stream(self.cloud_stream)
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
        """Every arrived reply, each readable on the edge stream."""
        due = super().poll(now)
        for r in due:
            ev = self._ready.pop(r.handle, None)
            if ev is not None:
                edge = self.edge_stream or torch.cuda.current_stream(
                    self._dev)
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
    queued at once, so slice i+1's quantize overlaps slice i's transfer.
    Wire bytes are billed per slice; int8 slices carry their own scales.
    Returns the dequantized hidden sequence on the cloud tier (in
    ``dtype``), ready for ``cloud_prefill``."""
    parts = []
    for i in range(0, h1.shape[1], chunk):
        sl = quantize(h1[:, i:i + chunk], fmt)
        channel.notify_upload(0, packet_bytes(sl), 0.0)
        parts.append(channel.put(sl))
    with _on(channel.cloud_stream):
        return torch.cat([dequantize(p, dtype) for p in parts], dim=1)


class TwoTierRuntime:
    """The edge partition on ``edge_device`` and the cloud partition on
    ``cloud_device``, each with its own stream and caches; only quantized
    packets move between them.  Both tiers run ``model``'s weights, so
    both devices are the one it lives on (two devices need the cloud
    partition's weights placed on the second: ROADMAP A.11b, after the
    cloud mesh of A.11a)."""

    def __init__(self, model: Model, ccfg: CollmConfig, edge_device,
                 cloud_device):
        self.model = model
        self.ccfg = ccfg
        self.edge_device = torch.device(edge_device)
        self.cloud_device = torch.device(cloud_device)
        for dev in (self.edge_device, self.cloud_device):
            if dev.type != model.device.type or (
                    dev.index is not None and dev.index != model.device.index):
                raise ValueError(f"a tier on {dev}, the model on "
                                 f"{model.device}: tiers on two devices need "
                                 f"the two-device runtime (ROADMAP A.11b)")
        self.collm = CoLLM(model, ccfg)

    def lower_tiers(self, batch: int, max_seq: int):
        """Lowering both tiers onto meshes of their own (the JAX package's
        AOT ``lower_tiers``) comes with the two-device runtime (ROADMAP
        A.11b)."""
        raise NotImplementedError("lower_tiers needs the two-device "
                                  "runtime (ROADMAP A.11b)")

    # -- live serving ------------------------------------------------------
    def build(self) -> None:
        """Make the tier streams and the channel."""
        self.edge_stream = _tier_stream(self.edge_device)
        self.cloud_stream = _tier_stream(self.cloud_device)
        co = self.collm
        self.channel = DeviceTransferChannel(
            lambda pkt, caches, pos: co.cloud_step(pkt, caches, pos),
            self.cloud_device, edge_stream=self.edge_stream,
            cloud_stream=self.cloud_stream)

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
        the channel's row, and ``tick_s``, the host seconds of each decode
        tick (edge step to materialised token)."""
        co, chan = self.collm, self.channel
        fmt, dtype = self.ccfg.wire_format, self.model.dtype
        with _on(self.edge_stream):
            prompt = torch.as_tensor(prompt, device=self.edge_device)
            prompt = prompt.reshape(1, -1).long()
            e_caches = co.init_edge_cache(1, max_seq)
        with _on(self.cloud_stream):
            chan.attach_caches(co.init_cloud_cache(1, max_seq))
        with _on(self.edge_stream):
            _, h1, e_caches = co.edge_prefill({"tokens": prompt}, e_caches)
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
            logits, c_caches = co.cloud_prefill(h1c, chan.caches)
            chan.attach_caches(c_caches)
            tok = logits[:, 0].argmax(-1)
        if self.cloud_stream is not None:
            self.edge_stream.wait_stream(self.cloud_stream)
            tok.record_stream(self.edge_stream)
        wire0 = chan.stats.bytes_up
        pos = prompt.shape[1]
        ticks = []
        with _on(self.edge_stream):
            toks = [int(tok[0])]
            for _ in range(max_new - 1):
                t0 = time.perf_counter()
                out = co.edge_step(tok[:, None], e_caches, pos)
                e_caches = out.caches
                if bool(out.exited[0]):
                    # parallel upload: queue the copy, the edge continues
                    chan.notify_upload(0, packet_bytes(out.upload), 0.0)
                    chan.put(out.upload)
                    tok = out.token.to(torch.long)
                else:
                    chan.submit_packet(out.upload, pos)
                    (rep,) = chan.poll()
                    tok = rep.reply.argmax(-1)
                toks.append(int(tok[0]))
                ticks.append(time.perf_counter() - t0)
                pos += 1
        if self.cloud_stream is not None:
            self.cloud_stream.synchronize()
        return toks, {"wire_bytes": chan.stats.bytes_up - wire0,
                      "channel": chan.stats.as_row(), "tick_s": ticks}
