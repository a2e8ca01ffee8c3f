"""The rank programs of the cloud-mesh tests (``tests/test_torch_cloud_tp.py``,
``tests/test_torch_sharding.py``).  ``repro_torch.launch.mesh.spawn``
starts each rank in a fresh process that imports this module by name, so
it imports the port alone (no JAX): the parent test computes the JAX
package's side and passes the weights in as numpy arrays."""
import time

import numpy as np
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.core.collm import CoLLM, CollmConfig
from repro_torch.core.exits import evaluate_exits
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import make_cloud_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import ServingSystem
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint

# the JAX file's untrained tiny GQA model: 4 heads over model = 4, 2 KV
# heads (the head-aligned rule replicates wk / wv)
TP_CFG = ModelConfig(name="tiny-ee-tp", arch_type="dense", n_layers=4,
                     d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                     vocab_size=256, tie_embeddings=True,
                     exit_layers=(1, 2)).validate()
THETA = 0.85
MAX_NEW = 8
PS = 8                          # the prefix-sharing scenario's page size

# the JAX file's matrix: name -> (how it runs, CollmConfig fields)
SCENARIOS = {
    "dense": ("multi", {}),
    "paged": ("multi", {"kv_layout": "paged"}),
    "int8": ("multi", {"kv_layout": "paged", "kv_dtype": "int8"}),
    "spec4": ("multi", {"speculative": True, "spec_k": 4}),
    "int8-spec4": ("multi", {"kv_layout": "paged", "kv_dtype": "int8",
                             "speculative": True, "spec_k": 4}),
    "prefix": ("prefix", dict(kv_layout="paged", page_size=PS,
                              chunked_prefill=True, prefix_share=True)),
    "preempt": ("preempt", dict(kv_layout="paged", preemption="recompute")),
}


def tp_prompts():
    """The JAX file's prompts: (multi, prefix, preempt)."""
    rng = np.random.default_rng(0)
    multi = [rng.integers(0, 256, size=n).astype(np.int32)
             for n in (7, 12, 9)]
    rng = np.random.default_rng(7)
    sysp = rng.integers(0, 256, size=2 * PS + PS // 2).astype(np.int32)
    prefix = [np.concatenate([sysp, rng.integers(0, 256, size=n)
                              .astype(np.int32)]) for n in (5, 7)]
    rng = np.random.default_rng(11)
    preempt = [rng.integers(0, 256, size=n).astype(np.int32) for n in (7, 9)]
    return multi, prefix, preempt


def run_scenario(system, kind):
    """One scenario through ``system`` (either package's ServingSystem):
    (streams, prefix-hit tokens, preemptions)."""
    multi, prefix, preempt = tp_prompts()
    if kind == "multi":
        r = system.generate_multi(multi, MAX_NEW)
    elif kind == "prefix":
        r = system.generate(prefix, MAX_NEW)
    else:
        r = system.generate(preempt, MAX_NEW, num_slots=2,
                            preempt_schedule=[(2, 0)])
    st = r["stats"]
    return r["tokens"], int(st.prefix_hit_tokens), int(st.preemptions)


def exit_probe(model):
    """Hidden rows to run the exit heads on: (E=2, B=3, d) from a seed."""
    g = torch.Generator().manual_seed(5)
    return torch.randn((2, 3, model.cfg.d_model), generator=g)


TIE_TOKENS = (10, 84)       # on the model axis' ranks 0 and 1 at (2, 4)


def tie_probe(eps):
    """Two exits of two rows and a whole (256, 128) unembedding whose best
    logits, of ``TIE_TOKENS``, lie on two ranks' vocabulary slices one
    float32 step apart, far closer than a step of the lse: row 0's higher
    one on the lower rank, row 1's on the higher.  Each row is one-hot
    (row b on column b), and a token's logit is its weight there times the
    row's normed 1, a single rounding in any order of summation; every
    other logit is 0.  Returns (hiddens (E, B, d), weight (V, d), norm
    scales (E, d))."""
    d, v = TP_CFG.d_model, TP_CFG.vocab_size
    h = torch.zeros((2, 2, d))
    h[:, 0, 0] = h[:, 1, 1] = 1.0
    hn = float(torch.rsqrt(torch.tensor(1.0 / d) + eps))
    lo = torch.tensor(0.5 / hn, dtype=torch.float32)
    low = lo * torch.tensor(hn, dtype=torch.float32)
    hi = lo
    while hi * torch.tensor(hn, dtype=torch.float32) <= low:
        hi = torch.nextafter(hi, torch.tensor(1.0))
    w = torch.zeros((v, d))
    a, b = TIE_TOKENS
    w[a, 0], w[b, 0], w[a, 1], w[b, 1] = hi, lo, lo, hi
    return h, w, torch.zeros((2, d))


def tp_rank(rank, world, dims, np_params):
    """Everything the tiny-ee-tp tests read, from one rank of ``dims``."""
    mesh = make_cloud_mesh(dims, device="cpu")
    model = Model(TP_CFG, device="cpu", axis=mesh.model_axis)
    model.load_state_dict(params_from_jax(np_params, TP_CFG, mesh=dims,
                                          rank=rank))
    out = {"coords": mesh.coords, "backend": mesh.backend,
           "heads": model.layers[0].attn.split.heads,
           "kv_heads": model.kv_heads, "streams": {}}
    for name, (kind, ckw) in SCENARIOS.items():
        system = ServingSystem(model, CollmConfig(theta=THETA,
                                                  cloud_mesh=dims, **ckw))
        out["streams"][name] = run_scenario(system, kind)
        sched = next(iter(system._schedulers.values()), None)
        if name == "preempt":
            # the cloud pool of 2 rows is this column's 1 row (data = 2)
            out["cloud_rows"] = sched.cloud_caches.rows
    out["param_bytes"] = sum(p.untyped_storage().nbytes()
                             for p in model.parameters())
    # a whole model placed by the mesh context: once, however many fleets
    whole = Model(TP_CFG, device="cpu")
    whole.load_state_dict(params_from_jax(np_params, TP_CFG))
    system = ServingSystem(whole, CollmConfig(theta=THETA, cloud_mesh=dims))
    multi = tp_prompts()[0]
    fleets = [system.generate_multi(multi, MAX_NEW)["tokens"]
              for _ in range(2)]
    out["placements"] = system.collm.mesh_ctx.placements
    out["fleets"] = fleets
    out["placed_bytes"] = sum(p.untyped_storage().nbytes()
                              for p in system.model.parameters())
    out["whole_untouched"] = all(
        p.shape == q.shape for p, q in zip(whole.parameters(),
                                           Model(TP_CFG, device="meta")
                                           .parameters()))
    # the exit heads on the rank's vocabulary slice, merged
    dec = system.collm.exit_decisions({1: exit_probe(model)[0],
                                       2: exit_probe(model)[1]})
    out["exits"] = {l: (d.token, d.confidence) for l, d in dec.items()}
    # the same merge on two slices whose best logits nearly tie
    h, w, ns = tie_probe(TP_CFG.norm_eps)
    axis = mesh.model_axis
    lo, hi = axis.block(w.shape[0])
    decs, _ = evaluate_exits(list(h), w[lo:hi], ns, TP_CFG.norm_eps,
                             axis=axis)
    out["tie_exits"] = [(d.token, d.confidence) for d in decs]
    # the refusals that need a process group
    try:
        CoLLM(model, CollmConfig(cloud_mesh=(1, 2)))
    except ValueError as e:
        out["wrong_world"] = str(e)
    return out


def cloud_step_records(model, dims, batch, max_seq, wire="float16"):
    """``sharding.records()`` of one ``cloud_step`` of ``batch`` rows on
    ``model`` (a rank's share of ``dims``), from empty caches of
    ``max_seq`` positions: what ``TwoTierRuntime.lower_tiers`` records on
    a recording mesh of ``dims``."""
    from repro_torch.core.transport import quantize
    collm = CoLLM(model, CollmConfig(wire_format=wire, cloud_mesh=dims))
    caches = collm.init_cloud_cache(batch, max_seq)
    upload = quantize(torch.zeros((batch, 1, model.cfg.d_model)), wire)
    tsh.reset_counts()
    with torch.no_grad():
        collm.cloud_step(upload, caches, 0)
    out = tsh.records()
    tsh.reset_counts()
    return out


def moe_rank(rank, world, dims, np_params, tcfg, theta, prompts, x,
             max_new, tp_params=None):
    """A reduced MoE model on one rank of ``dims``: layer 0's MoE in both
    forms on ``x`` and greedy streams; with ``tp_params``, the collective
    records of one tiny-ee-tp cloud step of 2 rows on the same mesh."""
    mesh = make_cloud_mesh(dims, device="cpu")
    model = Model(tcfg, device="cpu", axis=mesh.model_axis)
    model.load_state_dict(params_from_jax(np_params, tcfg, mesh=dims,
                                          rank=rank))
    layer = model.layers[0].moe
    tx = torch.as_tensor(x)
    with torch.no_grad():
        local, aux = tmoe.moe_forward_local(layer, tcfg, tx)
        decode = tmoe.moe_forward_decode(layer, tcfg, tx)
    out = {"local": local.numpy(), "aux": float(aux),
           "decode": decode.numpy(),
           "d_ff": layer.w_gate.shape[-1]}
    system = ServingSystem(model, CollmConfig(theta=theta, cloud_mesh=dims,
                                              kv_layout="paged"))
    out["generate"] = system.generate(prompts, max_new, mode="collm",
                                      num_slots=2)["tokens"]
    seq = ServingSystem(model, CollmConfig(theta=theta, cloud_mesh=dims))
    r = seq.generate_sequential(prompts, max_new, mode="collm")
    out["sequential"] = r["tokens"]
    out["exits"] = int(r["stats"].exits_l1 + r["stats"].exits_l2)
    out["counts"] = dict(tsh.COUNTS)
    if tp_params is not None:
        tp = Model(TP_CFG, device="cpu", axis=mesh.model_axis)
        tp.load_state_dict(params_from_jax(tp_params, TP_CFG, mesh=dims,
                                           rank=rank))
        out["tp_records"] = cloud_step_records(tp, dims, 2, 64)
    return out


def ckpt_rank(rank, world, dims, path, np_params):
    """A whole tiny-ee-tp checkpoint at ``path`` loaded into one rank's
    share of ``dims``, against ``params_from_jax`` of the same leaves; and
    saving the share, which is refused."""
    mesh = make_cloud_mesh(dims, device="cpu")
    model = Model(TP_CFG, device="cpu", axis=mesh.model_axis)
    load_checkpoint(path, model)
    want = params_from_jax(np_params, TP_CFG, mesh=dims, rank=rank)
    got = model.state_dict()
    out = {"names": sorted(got) == sorted(want),
           "equal": all(torch.equal(got[k], want[k]) for k in want),
           "split": sorted(model.shards)}
    try:
        save_checkpoint(f"{path}-rank{rank}", model)
    except ValueError as e:
        out["refused"] = str(e)
    return out


def fail_rank(rank, world):
    """Rank 0 raises at once; the others wait long past the test."""
    if rank == 0:
        raise RuntimeError("rank 0 fails on purpose")
    time.sleep(120)


def stall_rank(rank, world):
    """Every rank waits past any test's deadline."""
    time.sleep(120)


def mesh_rank(rank, world):
    """The mesh's own checks on one rank of a 4-rank group."""
    out = {}
    try:
        make_cloud_mesh((4, 2), device="cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    mesh = make_cloud_mesh((2, 2), device="cpu")
    out["coords"] = mesh.coords
    out["again"] = make_cloud_mesh((2, 2), device="cpu") is mesh
    out["describe"] = mesh.describe()
    # the model group sums over a row, the data group over a column
    x = torch.tensor([float(rank)])
    out["row_sum"] = float(tsh.reduce_model(x, mesh.model_axis))
    out["rows"] = tsh.gather_rows(torch.tensor([[float(rank)]]),
                                  mesh.data_axis, mesh.coords["data"],
                                  2).flatten().tolist()
    return out
