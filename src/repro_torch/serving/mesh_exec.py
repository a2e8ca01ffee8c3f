"""Mesh-aware serving execution (port of ``repro.serving.mesh_exec``).

One ``MeshContext`` per ``CoLLM`` owns

  * the cloud mesh built from ``CollmConfig.cloud_mesh`` (a
    ``launch.mesh.CloudMesh`` over the ranks of the current process
    group), or no mesh at all: the single-device default;
  * placement, done once: the model's parameters become the rank's share
    (``Model(axis=)``, the JAX package's rules), unless the model already
    is that share (a rank that built it sharded never holds the whole
    model); ``placements`` counts it, where the JAX package counts its
    traces, so a second fleet of engines on one ``CoLLM`` places nothing;
  * the rows of the data axis: a pooled cloud cache of a batch that the
    data axis divides (JAX's ``batch_axes``) holds only the column's
    contiguous share of the rows (``RowCaches``), the cloud steps run
    those rows, and the replies are gathered to every rank
    (``sharding.gather_rows``); a batch it does not divide runs whole in
    every column.  Paged pools have no batch axis and stay whole in every
    column; each column writes only its rows' pages, and a paged tree's
    dense per-row entries (recurrent state, cross caches: batch first)
    hold the column's rows only;
  * ``check_streams``: a run under a mesh ends by gathering every rank's
    token streams and raising if any differ.

Each rank runs the whole engine loop (SPMD): every host decision is a
function of tensors that are equal on every rank (the collectives give
every rank the same sums), and none reads the wall clock.

With ``cloud_mesh=None`` the context is inert: no mesh, no placement, no
copy of any parameter.  The JAX package's GSPMD layout hints
(``ShardingPolicy``'s sequence-parallel residual, vocabulary-sharded
logits) have no counterpart: activations stay whole between blocks.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import CloudMesh, make_cloud_mesh
from repro_torch.launch.sharding import batch_axes, gather_rows
from repro_torch.models.transformer import Model


class RowCaches(dict):
    """A pooled cache tree ({segment: [layer cache, ...]}) of ``batch``
    rows of which this data column holds rows [lo, hi)."""

    def __init__(self, tree: dict, lo: int, hi: int, batch: int):
        super().__init__(tree)
        self.rows = (lo, hi, batch)


class MeshContext:
    """The cloud mesh of one ``CoLLM`` and its placement."""

    def __init__(self, mesh: Optional[CloudMesh] = None):
        self.mesh = mesh
        self.placements = 0

    @property
    def active(self) -> bool:
        return self.mesh is not None

    # -- placement ---------------------------------------------------------
    def place(self, model: Model) -> Model:
        """The rank's share of ``model``: ``model`` itself without a mesh
        or when it already is this rank's share; else a sharded copy (each
        parameter's slice, on the mesh's device)."""
        if not self.active:
            return model
        axis = self.mesh.model_axis
        if model.axis is not None:
            if (model.axis.size, model.axis.index) != (axis.size, axis.index):
                raise ValueError(
                    f"the model is rank {model.axis.index} of a model axis "
                    f"of {model.axis.size}; the mesh puts this rank at "
                    f"{axis.index} of {axis.size}")
            return model
        if axis.size == 1 and model.device == self.mesh.device:
            return model
        shard = Model(model.cfg, device=self.mesh.device, dtype=model.dtype,
                      axis=axis, tier=model.tier)
        shard.load_whole(model.state_dict())
        self.placements += 1
        return shard

    def rows(self, batch: int) -> Tuple[int, int]:
        """[lo, hi) of a ``batch``-row pool that this data column holds."""
        if not self.active or batch_axes(self.mesh, batch) is None:
            return 0, batch
        return self.mesh.data_axis.block(batch)

    def row_caches(self, tree: dict, batch: int) -> dict:
        lo, hi = self.rows(batch)
        if (lo, hi) == (0, batch):
            return tree
        return RowCaches(tree, lo, hi, batch)

    def gather_rows(self, x: torch.Tensor, lo: int,
                    batch: int) -> torch.Tensor:
        return gather_rows(x, self.mesh.data_axis if self.active else None,
                           lo, batch)

    # -- the runs' outputs ---------------------------------------------------
    def check_streams(self, streams: Sequence[Optional[Sequence[int]]]
                      ) -> None:
        """Raise unless every rank produced ``streams`` (a list of token
        lists): each rank writes its flattened streams into its row of a
        zero buffer, and one sum over the process group shows all of them
        to every rank."""
        if not self.active or self.mesh.world == 1:
            return
        import torch.distributed as dist
        flat: List[int] = [len(streams)]
        for s in streams:
            s = list(s or [])
            flat += [len(s)] + [int(t) for t in s]
        dev = "cpu" if self.mesh.backend == "gloo" else self.mesh.device
        n = torch.tensor([len(flat)], dtype=torch.int64, device=dev)
        dist.all_reduce(n, op=dist.ReduceOp.MAX)
        buf = torch.full((self.mesh.world, int(n.item())), 0,
                         dtype=torch.int64, device=dev)
        buf[self.mesh.rank, :len(flat)] = torch.tensor(flat,
                                                       dtype=torch.int64)
        buf[self.mesh.rank, len(flat):] = -1
        dist.all_reduce(buf)
        rows = buf.cpu()
        bad = [r for r in range(self.mesh.world)
               if not torch.equal(rows[r], rows[self.mesh.rank])]
        if bad:
            raise RuntimeError(f"rank {self.mesh.rank}: the streams of ranks "
                               f"{bad} differ from this rank's")


def mesh_context(collm) -> MeshContext:
    """The CoLLM's MeshContext, built on first use from
    ``collm.ccfg.cloud_mesh`` on the model's device and cached on the
    object (all engines and batchers of one CoLLM share it)."""
    mc = getattr(collm, "_mesh_ctx", None)
    if mc is None:
        spec = collm.ccfg.cloud_mesh
        mesh = None
        if spec is not None:
            mesh = make_cloud_mesh(spec, device=_rank_device(collm.model))
        mc = collm._mesh_ctx = MeshContext(mesh)
    return mc


def _rank_device(model: Model):
    """The rank's device: its card (``cuda:(rank % count)``) for a model
    on a card, the CPU for a model on the CPU."""
    if model.device.type == "cuda":
        return None
    return model.device
