"""The rank programs of ``tests/test_torch_cloud_tp_families.py`` (the cloud
mesh for the recurrent, hybrid, encoder-decoder and vision-prefix models)
and the port's greedy stream composer that ``tests/_encdec_parity.py``
shares.  ``repro_torch.launch.mesh.spawn`` starts each rank in a fresh
process that imports this module by name, so it imports the port alone
(no JAX): the parent test passes the weights in as numpy arrays."""
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.core import transport
from repro_torch.core.collm import CoLLM, CollmConfig
from repro_torch.core.exits import first_confident_exit
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import make_cloud_mesh
from repro_torch.models.cache_tree import map_tensors
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import ServingSystem

MESHES = ((2, 2), (1, 4))
MAX_NEW = 6
# name: (θ, wire); "split" is the architecture's split θ, None the cloud
MODES = {"cloud": None, "collm-float16": ("split", "float16"),
         "collm-int8": ("split", "int8"),
         "standalone": ("split", "float16")}


def mode_args(mode, split_theta):
    theta, wire = MODES[mode] or (1.0, "float32")
    return (split_theta if theta == "split" else theta), wire


def engine_stream(model, spec, mode, cloud_mesh=None):
    """A token-prompt model's greedy streams of ``spec["prompts"]`` through
    ``ServingSystem.generate`` over two slots, in ``mode`` (the engine's
    mode is the name's first part): (tokens, cloud requests, exits)."""
    theta, wire = mode_args(mode, spec["theta"])
    system = ServingSystem(model, CollmConfig(
        theta=theta, wire_format=wire, cloud_mesh=cloud_mesh,
        **spec.get("ccfg", {})))
    r = system.generate(spec["prompts"], MAX_NEW, mode=mode.split("-")[0],
                        num_slots=2)
    st = r["stats"]
    return r["tokens"], int(st.cloud_requests), int(st.exits_l1
                                                    + st.exits_l2)


@torch.no_grad()
def compose_stream(m, batch, mode, theta, wire, max_new, max_seq,
                   cloud_mesh=None):
    """One greedy stream of ``max_new`` tokens of ``batch`` (numpy tokens,
    and frames or patches) through the port's calls on model ``m`` (a
    rank's share under ``cloud_mesh``): ``cloud`` is ``Model.prefill`` +
    ``full_step``; ``collm-*`` is ``edge_prefill``, ``Model.encode``
    uploaded once, ``cloud_prefill``, then ``edge_step`` and, below θ,
    ``cloud_step`` (the JAX package's ``generate_sequential``);
    ``standalone`` is ``edge_prefill`` + ``standalone_step``.  Neither
    package's engines take frames or patches.  Returns the tokens, exits,
    cloud requests, upload and ``enc_out`` bytes, and each edge tick's
    exit confidences."""
    cfg = m.cfg
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    st = dict(tokens=[], exits_l1=0, exits_l2=0, cloud_requests=0,
              upload_bytes=0, enc_bytes=0, confs=[])
    collm = CoLLM(m, CollmConfig(theta=theta, wire_format=wire,
                                 cloud_mesh=cloud_mesh))
    if mode == "cloud":
        caches = m.init_cache(1, max_seq)
        x, _, caches, _ = m.prefill(batch, caches)
        tok = m.logits(x[:, -1:])[:, 0].argmax(-1).to(torch.int32)
        pos = x.shape[1]
        st["tokens"].append(int(tok[0]))
        for _ in range(max_new - 1):
            tok, _, caches = collm.full_step(tok[:, None], caches, pos)
            st["tokens"].append(int(tok[0]))
            pos += 1
        return st
    ecache = collm.init_edge_cache(1, max_seq)
    decisions, h1, ecache = collm.edge_prefill(batch, ecache)
    pos = h1.shape[1]
    tok, exited, _ = first_confident_exit(decisions, theta)
    if mode == "standalone":
        tok = decisions[collm.l_ee2].token
        for _ in range(max_new - 1):
            st["tokens"].append(int(tok[0]))
            tok, _, ecache = collm.standalone_step(tok[:, None], ecache, pos)
            st["exits_l2"] += 1
            pos += 1
        st["tokens"].append(int(tok[0]))
        return st
    enc = m.encode(batch["frames"]) if cfg.is_encdec else None
    ccache = collm.init_cloud_cache(1, max_seq)
    plogits, ccache = collm.cloud_prefill(h1, ccache, enc_out=enc)
    st["upload_bytes"] += transport.hidden_wire_bytes(cfg.d_model, wire,
                                                      seq=h1.shape[1])
    if enc is not None:
        st["enc_bytes"] = transport.hidden_wire_bytes(cfg.d_model, wire,
                                                      seq=enc.shape[1])
    if not bool(exited[0]):
        st["cloud_requests"] += 1
        tok = plogits[:, 0].argmax(-1).to(torch.int32)
    st["tokens"].append(int(tok[0]))
    for _ in range(max_new - 1):
        out = collm.edge_step(tok[:, None], ecache, pos)
        c12 = tuple(float(out.decisions[l].confidence[0])
                    for l in (collm.l_ee1, collm.l_ee2))
        st["confs"].append(c12)
        if bool(out.exited[0]):
            st["exits_l1" if c12[0] >= theta else "exits_l2"] += 1
        st["upload_bytes"] += transport.StatePacket(
            hidden=out.upload, pos=torch.tensor(pos)).nbytes()
        if bool(out.exited[0]):
            tok = out.token
        else:
            logits, ccache = collm.cloud_step(out.upload, ccache, pos)
            st["cloud_requests"] += 1
            tok = logits.argmax(-1).to(torch.int32)
        st["tokens"].append(int(tok[0]))
        pos += 1
    return st


def family_stream(model, spec, mode, cloud_mesh=None):
    """``spec``'s streams in ``mode``: the engine's for a token-prompt
    model, ``compose_stream``'s of ``spec["max_new"]`` tokens
    (confidences dropped) for one with frames or patches."""
    if "batch" not in spec:
        return engine_stream(model, spec, mode, cloud_mesh)
    theta, wire = mode_args(mode, spec["theta"])
    st = compose_stream(model, spec["batch"], mode, theta, wire,
                        spec["max_new"], spec["max_seq"], cloud_mesh)
    st.pop("confs")
    return st


@torch.no_grad()
def state_packet(model, spec, cloud_mesh=None):
    """An int8 state packet after a cloud prefill of a recurrent model:
    the l_ee1 upload of the first prompt (from a seed) through the cloud
    partition, then its last hidden row and the whole recurrent state
    (``Model.whole_state``) quantized: ((codes, scales) of each state
    leaf as numpy, wire bytes)."""
    collm = CoLLM(model, CollmConfig(wire_format="int8",
                                     cloud_mesh=cloud_mesh))
    n = len(spec["prompts"][0])
    g = torch.Generator().manual_seed(9)
    h1 = torch.randn((1, n, model.cfg.d_model), generator=g)
    caches = collm.init_cloud_cache(1, n + 4)
    _, caches = collm.cloud_prefill(h1, caches)
    pkt = transport.make_packet(h1[:, -1:], "int8",
                                states=model.whole_state(caches))
    leaves = []
    map_tensors(pkt.states, lambda p: leaves.append(
        (p["data"].numpy(), p["scale"].numpy())),
        lambda t: isinstance(t, dict) and "data" in t)
    return leaves, pkt.nbytes()


@torch.no_grad()
def cloud_prefill_rows(model, spec, cloud_mesh=None):
    """``cloud_prefill``'s last-position logits of two uploaded rows (and,
    for an encoder-decoder, two encoder outputs) from a seed, into a
    two-row cloud cache: under a data axis of 2, each column prefills its
    row and the logits are gathered."""
    cfg = model.cfg
    collm = CoLLM(model, CollmConfig(cloud_mesh=cloud_mesh))
    n = cfg.vision_tokens + 12
    g = torch.Generator().manual_seed(11)
    h1 = torch.randn((2, n, cfg.d_model), generator=g)
    enc = (torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g)
           if cfg.is_encdec else None)
    caches = collm.init_cloud_cache(2, n + 4)
    logits, _ = collm.cloud_prefill(h1, caches, enc_out=enc)
    return logits.numpy()


def family_rank(rank, world, specs, swap_params=None):
    """Every spec's streams in every mode on one rank of each of
    ``MESHES`` in turn, with the rank's parameter bytes, its collectives,
    a two-row cloud prefill and, for a recurrent model, its state
    packet; with ``swap_params`` (tiny-ee-tp's, as numpy) also the swap
    scenarios of ``_cloud_tp_ranks`` on its share of (2, 2)."""
    out = {}
    for dims in MESHES:
        mesh = make_cloud_mesh(dims, device="cpu")
        if swap_params is not None and dims == (2, 2):
            from _cloud_tp_ranks import TP_CFG, swap_ranks
            tp = Model(TP_CFG, device="cpu", axis=mesh.model_axis)
            tp.load_state_dict(params_from_jax(swap_params, TP_CFG,
                                               mesh=dims, rank=rank))
            out["swap"] = swap_ranks(tp, dims)
        for spec in specs:
            cfg = spec["cfg"]
            model = Model(cfg, device="cpu", axis=mesh.model_axis)
            model.load_state_dict(params_from_jax(spec["np_params"], cfg,
                                                  mesh=dims, rank=rank))
            tsh.reset_counts()
            res = {"streams": {mode: family_stream(model, spec, mode, dims)
                               for mode in MODES},
                   "counts": dict(tsh.COUNTS),
                   "param_bytes": sum(p.numel() * p.element_size()
                                      for p in model.parameters())}
            if "batch" not in spec:
                res["packet"] = state_packet(model, spec, dims)
            res["prefill_rows"] = cloud_prefill_rows(model, spec, dims)
            out[(dims, spec["name"])] = res
    return out
