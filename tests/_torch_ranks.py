"""One rank of the gloo world that ``tests/test_torch_mesh_ranks.py``
starts on the CPU: joins the process group from a ``FileStore``, builds
``make_host_mesh()`` and runs every scenario of the port over it, each
beside its one-rank run, then pickles what it saw for the test to hold.
With ``model`` last, the scenarios of ``tests/test_torch_model_axis.py``
instead: serving and the DSE task mesh on the (1, 4) and (2, 2)
('data', 'model') meshes (``model_axis_main``); with ``train``, those of
``tests/test_torch_model_axis_train.py``: training there
(``model_axis_train_main``); with ``recurrent``, those of
``tests/test_torch_model_axis_recurrent.py``: hymba, xlstm and whisper
served and trained there (``recurrent_main``); with ``steps``, those three
once on a (1, WORLD) mesh (``steps_main``, for
``tests/test_torch_shardings.py``); with ``costs``, those of
``tests/test_torch_dryrun_mesh.py``: the reduced steps on the (2, 2)
mesh counted by ``utils/op_cost``, then on rank 0 the same steps counted
on meta in ``counting_world`` (``costs_main``).

    python tests/_torch_ranks.py RANK WORLD STORE_PATH OUT_DIR \
        [model|train|recurrent|steps|costs]

Imports only ``torch`` and ``repro_torch``.
"""
import contextlib
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.baselines.drl import PolicyGradientDRL
from repro_torch.baselines.mlp import LargeMLP
from repro_torch.baselines.sa import SimulatedAnnealing
from repro_torch.core import gan as G
from repro_torch.core import prng
from repro_torch.core import shard
from repro_torch.core.dse_api import GANDSE
from repro_torch.core.explorer import (ExplorerConfig,
                                       enumerate_candidates_batch)
from repro_torch.core.fused_select import fused_select_batch
from repro_torch.core.selector import select_batch
from repro_torch.core.train import train_gan
from repro_torch.dataset.generator import generate_dataset, generate_tasks
from repro_torch.design_models.im2col import Im2colModel
from repro_torch.launch.mesh import init_process_group, make_host_mesh
from repro_torch.models import base as MB
from repro_torch.optim import tree_leaves
from repro_torch.serve import DSEServer, ServeConfig
from repro_torch.train import step as TS

#: the MoE batches: B = 4 splits over 4 ranks, B = 2 does not (every rank
#: then computes the whole batch in the reference's 4 token groups)
MOE_BATCHES = (4, 2)
SEQ = 32
#: explore_batch's task counts: aligned and ragged on 4 ranks
DSE_TASKS = (8, 6)
#: train_gan's (batch, epochs): 30 % 4 != 0 is the fallback
TRAIN_RUNS = ((32, 2), (30, 1))


def dse_cfg(gan, model, batch_size: int = 64):
    """The tiny GAN config of the DSE and train scenarios, from either
    package's ``core/gan`` module."""
    return gan.GANConfig(n_net=model.net_space.n_dims).scaled(
        layers=1, neurons=32, batch_size=batch_size, lr=1e-3)


def moe_batch(b: int, vocab: int):
    toks = np.random.default_rng(b).integers(0, vocab, (b, SEQ))
    return toks, np.roll(toks, -1, 1)


def flat(tree, path=()) -> dict:
    """{"a/b/0/c": numpy} of a params tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flat(tree[key], path + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in flat(t, path + (str(i),)).items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy().copy()
    return {"/".join(path): np.asarray(tree)}


def sel(s):
    """A Selection of either package as plain values."""
    return (None if s.cfg_idx is None else np.asarray(s.cfg_idx).tolist(),
            float(s.latency), float(s.power), bool(s.satisfied),
            int(s.n_candidates))


def _sels(results):
    return [sel(r.selection) for r in results]


GATHERS = [0]
_gather = shard.gather_objects


def _counted_gather(items, mesh=None):
    GATHERS[0] += 1
    return _gather(items, mesh)


shard.gather_objects = _counted_gather


def _both(mesh, fn):
    """(fn() with no mesh, fn() under the task mesh, the gathers the
    latter made)."""
    base = fn()
    before = GATHERS[0]
    with shard.task_mesh(mesh):
        sharded = fn()
    return base, sharded, GATHERS[0] - before


def dse(mesh):
    model = Im2colModel()
    cfg = dse_cfg(G, model)
    xcfg = ExplorerConfig(prob_threshold=0.1, max_candidates=128)
    ds = generate_dataset(model, 256, seed=0)
    eng = GANDSE(model, cfg, xcfg, device="cpu")
    eng.attach(ds, G.init_generator(prng.prng_key(torch.tensor(3)), cfg,
                                    model.space, "cpu"))
    out = {}
    for n in DSE_TASKS:
        tasks = generate_tasks(model, n, seed=2)
        out[f"explore {n}"] = _both(
            mesh, lambda: _sels(eng.explore_batch(tasks, seed=7)))
    tasks = generate_tasks(model, 8, seed=4)
    probs = eng._explorer.generator_probs_device(
        tasks.net_idx, tasks.lat_obj, tasks.pow_obj,
        seed=np.arange(8) + 11)
    cand, valid, counts = enumerate_candidates_batch(
        model.space, probs, xcfg.prob_threshold, xcfg.max_candidates)
    out["select_batch"] = _both(mesh, lambda: [sel(s) for s in select_batch(
        model, tasks.net_idx, cand, valid, counts, tasks.lat_obj,
        tasks.pow_obj)])
    out["fused_select"] = _both(mesh, lambda: [sel(s) for s in
                                               fused_select_batch(
        model, tasks.net_idx, probs, 0.05, 512, tasks.lat_obj,
        tasks.pow_obj, tile=16)])

    tasks = generate_tasks(model, 6, seed=3)
    sa = SimulatedAnnealing(model, cooling=0.6, device="cpu")
    drl = PolicyGradientDRL(model, hidden_layers=2, neurons=16,
                            rollout_len=4, device="cpu")
    drl.attach(ds, drl.init_params(0))
    lm = LargeMLP(model, hidden_layers=2, neurons=32, device="cpu")
    lm.attach(ds, lm.init_params(0))
    for e in (sa, drl, lm):
        out[e.method_name] = _both(
            mesh, lambda: _sels(e.explore_tasks(tasks, seed=5)))

    # single submissions through the serving stack
    tasks = generate_tasks(model, 5, seed=6)

    def serve(active):
        srv = DSEServer(ServeConfig(max_batch=64, cache_capacity=0))
        srv.register(eng)
        with shard.task_mesh(active):
            rids = [srv.submit(model.name, tasks.net_idx[i],
                               tasks.lat_obj[i], tasks.pow_obj[i],
                               seed=100 + i) for i in range(5)]
            srv.drain()
            in_mesh = srv.summary()["sharding"]
        return ([sel(srv.response(r).result.selection) for r in rids],
                srv.stats["padded_rows"], in_mesh,
                srv.summary()["sharding"])

    out["serve"] = (serve(None), serve(mesh))
    return out


def train(mesh):
    model = Im2colModel()
    out = {}
    for bs, iters in TRAIN_RUNS:
        cfg = dse_cfg(G, model, bs)
        ds = generate_dataset(model, 128, seed=0)
        out[f"train {bs}"] = _both(mesh, lambda: _state(
            train_gan(model, ds, cfg, iters=iters, seed=0,
                      device="cpu")))[:2]
    return out


def _state(st):
    """({"g/...": numpy} of G's and D's params, the loss_g history)."""
    return (flat({"g": st.g_params, "d": st.d_params}),
            [h["loss_g"] for h in st.history])


def lm(mesh):
    """Reduced stablelm's train step at B 4 (and 8 in 2 microbatches) on
    the mesh beside the one-rank step; reduced mixtral's prefill and one
    train step under the mesh at each of ``MOE_BATCHES``."""
    out = {}
    m = configs.get_reduced("stablelm-1.6b")
    for b, micro in ((4, 1), (8, 2)):
        toks = np.random.default_rng(b).integers(0, m.vocab, (b, SEQ))
        batch = {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(np.roll(toks, -1, 1))}

        def run(active):
            params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
            step, optim = TS.make_train_step(m, lr=1e-3, remat=False,
                                             mesh=active, microbatches=micro)
            opt = optim.init(params)
            losses = []
            for _ in range(2):
                params, opt, met = step(params, opt, batch)
                losses.append(float(met["loss"]))
            return [t.numpy().copy() for t in tree_leaves(params)], losses

        out[f"stablelm {b}x{micro}"] = (run(None), run(mesh))

    m = configs.get_reduced("mixtral-8x7b")
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    for b in MOE_BATCHES:
        toks, labels = moe_batch(b, m.vocab)
        tok = torch.from_numpy(toks)
        logits = TS.make_prefill_step(m, mesh=mesh)(params, {"tokens": tok})
        step, optim = TS.make_train_step(m, lr=1e-3, remat=False, mesh=mesh)
        p = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
        p, _, met = step(p, optim.init(p), {"tokens": tok,
                                            "labels": torch.from_numpy(labels)})
        out[f"mixtral {b}"] = (logits.numpy(), float(met["loss"]),
                               flat(p))
    return out


# ---------------------------------------------------------------------------
# serving and the DSE task mesh across a 'model' axis
# ---------------------------------------------------------------------------
#: the model-axis meshes on 4 ranks
MODEL_MESHES = ((1, 4), (2, 2))
#: the reduced archs served there: MHA, GQA, the ring (n_kv = 1 < m), MoE
MODEL_ARCHS = ("stablelm-1.6b", "qwen3-14b", "gemma3-1b", "mixtral-8x7b")
MODEL_BATCH, MODEL_SEQ = 4, 24
#: the Engine's run: 4 slots, 4 requests of 4 prompt tokens + 5 new (8
#: engine steps)
ENGINE = dict(slots=4, cache_len=32, requests=4, prompt=4, max_new=5)
#: gemma3's windowed tail layer alone, decoded past a ring of 16 slots
#: (S over 'model') and of 8 (dh over 'model', the larger dim there)
RING_CACHES, RING_STEPS = (16, 8), 24


class Sizes:
    """A mesh that the rules read and no collective runs on: the groups
    of a 'model'-1 mesh of the same batch axes (the one-rank runs)."""

    def __init__(self, **shape):
        self.shape = shape


def model_tokens(vocab: int, b: int = MODEL_BATCH, s: int = MODEL_SEQ):
    return np.random.default_rng(5).integers(0, vocab, (b, s))


def engine_prompts(vocab: int):
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab, ENGINE["prompt"]).tolist()
            for _ in range(ENGINE["requests"])]


def _engine_tokens(m, params, mesh):
    from repro_torch.launch.serve import Engine, Request

    eng = Engine(m, params, ENGINE["slots"], ENGINE["cache_len"], mesh=mesh,
                 device="cpu")
    for i, p in enumerate(engine_prompts(m.vocab)):
        eng.submit(Request(rid=i, prompt=p, max_new=ENGINE["max_new"]))
    iters = eng.run()
    return ({r.rid: r.out for r in eng.finished}, iters,
            _nbytes(eng.params), _nbytes(eng.states))


def _spec_list(specs) -> list:
    """A spec tree's leaves (``P``s) in ``tree_leaves``' order."""
    if isinstance(specs, dict):
        return [p for v in specs.values() for p in _spec_list(v)]
    if isinstance(specs, list):
        return [p for v in specs for p in _spec_list(v)]
    return [specs]


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor)))


def _ring(mesh, one):
    """The logits of RING_STEPS decode steps of gemma3's windowed tail
    layer from empty caches of each of RING_CACHES slots (rings narrower
    than the window, so they wrap), sharded and on one rank."""
    import dataclasses

    from repro_torch.train import shardings as SH

    m = configs.get_reduced("gemma3-1b")
    m = dataclasses.replace(m, segments=m.segments[1:])
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    toks = np.random.default_rng(7).integers(0, m.vocab, (2, RING_STEPS))
    out = {}
    for cache in RING_CACHES:
        for active, p in ((mesh, SH.shard_params(params, mesh)),
                          (one, params)):
            states = MB.init_decode_state(params, m, 2, cache)
            if active is mesh:
                states = SH.shard_states(states, mesh, 2)
            dec = TS.make_decode_step(m, mesh=active, cache_len=cache)
            seen = []
            for t in range(RING_STEPS):
                logits, states = dec(p, torch.from_numpy(toks[:, t:t + 1]),
                                     t, states)
                seen.append(logits[:, 0].numpy().copy())
            out[cache, active is mesh] = np.stack(seen, 1)
            if active is mesh:
                out[cache, "kv_shape"] = tuple(states[0][0]["kv"][0].shape)
    return out


def serving(mesh, shape):
    """Each arch: this rank's param and state bytes (and their blocks'
    shapes), the prefill logits and the Engine's tokens, sharded and on
    one rank holding the same MoE token groups."""
    from repro_torch.train import shardings as SH

    one = Sizes(data=shape[0], model=1)
    out = {}
    for arch in MODEL_ARCHS:
        m = configs.get_reduced(arch)
        params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
        tok = torch.from_numpy(model_tokens(m.vocab))
        local = SH.shard_params(params, mesh)
        specs = SH.param_specs(params, mesh)
        whole = [bool(torch.equal(SH.gather_leaf(t, s, mesh), full))
                 for t, s, full in zip(tree_leaves(local),
                                       _spec_list(specs),
                                       tree_leaves(params))]
        got = TS.make_prefill_step(m, mesh=mesh)(local, {"tokens": tok})
        want = TS.make_prefill_step(m, mesh=one)(params, {"tokens": tok})
        toks, iters, pbytes, sbytes = _engine_tokens(m, params, mesh)
        out[arch] = dict(
            param_bytes=_nbytes(local), engine_param_bytes=pbytes,
            state_bytes=sbytes, shapes=[tuple(t.shape)
                                        for t in tree_leaves(local)],
            gathered_whole=whole,
            logits=got.numpy(), one_logits=want.numpy(),
            tokens=toks, one_tokens=_engine_tokens(m, params, one)[0],
            iters=iters)
    out["ring"] = _ring(mesh, one)
    return out


def moe_layer(mesh, shape, e: int = 4):
    """The reference's expert-parallel test's layer (capacity factor 8)
    with `e` experts through ``moe_apply_sharded`` on this rank's blocks,
    and ``moe_apply`` on one rank in the same token groups.  E = 4 is
    expert parallel on both meshes; E = 6 on (1, 4) splits each expert's
    F instead."""
    from repro_torch.nn import moe as M
    from repro_torch.train import parallel as PAR
    from repro_torch.train import shardings as SH

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 16)).astype(np.float32))
    p = M.moe_init(prng.prng_key(torch.tensor(0)), e, 16, 32, "cpu")
    specs = SH.param_specs(p, mesh)
    local = SH.shard_params(p, mesh)
    with SH.use_mesh(mesh):
        y = M.moe_apply_sharded(PAR.unshard_data(local, specs), x,
                                PAR.model_axis(), n_experts=e, d_ff=32,
                                top_k=2, capacity_factor=8.0)
    with SH.use_mesh(Sizes(data=shape[0], model=1)):
        one = M.moe_apply(p, x, top_k=2, capacity_factor=8.0)
    return y.numpy(), one.numpy(), tuple(local["w_gate"].shape)


def heads_not_split(mesh, shape):
    """Reduced stablelm with 6 heads of 16: 'model' divides wq's 96
    columns but not its heads on (1, 4), so every rank forms every head
    and takes wo's row block; its prefill, sharded and on one rank."""
    import dataclasses

    from repro_torch.train import shardings as SH

    m = configs.get_reduced("stablelm-1.6b")
    seg = m.segments[0]
    spec = seg.pattern[0]
    cfg = dataclasses.replace(spec.cfg, n_heads=6, n_kv=6, head_dim=16)
    m = dataclasses.replace(m, segments=(dataclasses.replace(
        seg, pattern=(dataclasses.replace(spec, cfg=cfg),)),))
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    tok = {"tokens": torch.from_numpy(model_tokens(m.vocab))}
    got = TS.make_prefill_step(m, mesh=mesh)(SH.shard_params(params, mesh),
                                             tok)
    want = TS.make_prefill_step(m, mesh=Sizes(data=shape[0], model=1))(
        params, tok)
    return got.numpy(), want.numpy()


def task_mesh_dse(mesh):
    model = Im2colModel()
    eng = GANDSE(model, dse_cfg(G, model), ExplorerConfig(
        prob_threshold=0.1, max_candidates=128), device="cpu")
    eng.attach(generate_dataset(model, 256, seed=0), G.init_generator(
        prng.prng_key(torch.tensor(3)), dse_cfg(G, model), model.space,
        "cpu"))
    tasks = generate_tasks(model, 8, seed=2)
    out = {"explore": _both(mesh, lambda: _sels(eng.explore_batch(
        tasks, seed=7)))}
    ds = generate_dataset(model, 128, seed=0)
    out["train"] = _both(mesh, lambda: _state(train_gan(
        model, ds, dse_cfg(G, model, 32), iters=2, seed=0,
        device="cpu")))[:2]
    return out


def plane_group():
    """``axis_group`` over the batch axes of a (pod 2, data 2, model 1)
    mesh: this rank's coordinate on the plane, and the ranks gathered
    over its group in order."""
    from repro_torch.launch.mesh import axis_group
    from repro_torch.train import parallel as PAR

    mesh = make_host_mesh((2, 2, 1), device="cpu")
    group, coord = axis_group(mesh, ("pod", "data"))
    got = PAR.gather_dim(torch.tensor([dist.get_rank()]), 0, group)
    return coord, got.tolist(), axis_group(mesh, "model")


def model_axis_main(rank: int, world: int, store_path: str,
                    out_dir: str) -> None:
    torch.set_num_threads(1)
    init_process_group("gloo", dist.FileStore(store_path, world), rank,
                       world, timeout_s=120)
    out = {}
    try:
        meshes = {shape: make_host_mesh(shape, device="cpu")
                  for shape in MODEL_MESHES}
        for shape, mesh in meshes.items():
            out[shape] = dict(coord=tuple(mesh.get_coordinate()),
                              serving=serving(mesh, shape),
                              moe_layer=moe_layer(mesh, shape),
                              moe_layer_6=moe_layer(mesh, shape, e=6),
                              heads_6=heads_not_split(mesh, shape))
        out["dse"] = task_mesh_dse(meshes[2, 2])
        out["plane"] = plane_group()
        out["other_archs"] = recurrent(meshes[2, 2], (2, 2), OTHER_ARCHS)
    except Exception:
        out["error"] = traceback.format_exc()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# training across a 'model' axis
# ---------------------------------------------------------------------------
#: the train batch: B 4 splits over 'data' 2 on (2, 2) and not at all on
#: (1, 4); 24 positions (4 and 2 divide S and D = 64: 'seq' and 'model'
#: save points both cut)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 24, 1e-3
#: the act_shard policies held to each other
ACT_POLICIES = ("model", "seq", "none")


def train_batch(vocab: int, b: int = TRAIN_BATCH, s: int = TRAIN_SEQ):
    toks = np.random.default_rng(8).integers(0, vocab, (b, s))
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, 1))}


def _one_rank_grads(m, params, batch, one, micro: int = 1, remat=False):
    """The one-rank (loss, gradient tree) in the MoE groups of `one`, the
    microbatches accumulated as ``make_train_step``'s one-rank path
    does."""
    from repro_torch.optim import tree_unflatten
    from repro_torch.train import shardings as SH

    with SH.use_mesh(one):
        if micro == 1:
            return TS.loss_and_grads(m, params, batch, remat=remat)
        pieces = {k: TS._split(v, micro) for k, v in batch.items()}
        loss_sum, g_sum = torch.zeros(()), None
        for i in range(micro):
            loss, g = TS.loss_and_grads(
                m, params, {k: v[i] for k, v in pieces.items()}, remat=remat)
            loss_sum = loss_sum + loss
            g = tree_leaves(g)
            g_sum = g if g_sum is None else [a + b for a, b in zip(g_sum, g)]
        return loss_sum * (1.0 / micro), tree_unflatten(
            params, [t * (1.0 / micro) for t in g_sum])


def train_one(m, params, one, batch=None):
    """The world of one: the loss, gradients, clip scale and params after
    one AdamW step (``make_train_step``'s optimizer and update), on
    `batch` (default ``train_batch``)."""
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import clip_scale

    batch = train_batch(m.vocab) if batch is None else batch
    loss, grads = _one_rank_grads(m, params, batch, one)
    optim = adamw(TRAIN_LR, weight_decay=0.1, clip_norm=1.0)
    p = [t.clone() for t in tree_leaves(params)]
    from repro_torch.optim import tree_unflatten
    p = tree_unflatten(params, p)
    optim.update_in_place(grads, optim.init(p), p)
    return dict(loss=float(loss), grads=flat(grads),
                scale=float(clip_scale(grads, 1.0)),
                params=flat(p))


def train_sharded(m, params, mesh, batch=None, **kw):
    """This rank's run: the step's loss and gradient blocks before the
    clip, the clip scale from their global norm, then one step on the
    blocks: the params after it, and the bytes of params, mu and nu; on
    `batch` (default ``train_batch``)."""
    from repro_torch.train import shardings as SH

    local = SH.shard_params(params, mesh)
    step, optim = TS.make_train_step(m, lr=TRAIN_LR, mesh=mesh, **kw)
    batch = train_batch(m.vocab) if batch is None else batch
    loss, grads = step.loss_and_grads(local, batch)
    norm = step.grad_norm(grads)
    opt = optim.init(local)
    local, opt, met = step(local, opt, batch)
    return dict(loss=float(loss), step_loss=float(met["loss"]),
                grads=flat(grads),
                scale=float(torch.clamp(1.0 / (norm + 1e-9), max=1.0)),
                params=flat(local),
                bytes={"params": _nbytes(local), "mu": _nbytes(opt.mu),
                       "nu": _nbytes(opt.nu)},
                shapes=[tuple(t.shape) for t in tree_leaves(local)])


def act_shard_runs(m, params, mesh):
    """Remat on, each of ACT_POLICIES: the loss, the gradient blocks and
    the bytes and shapes of every tensor saved for the backward outside
    the checkpointed repeats (``saved_tensors_hooks``: a checkpoint's
    inputs, the save points, among them)."""
    from repro_torch.train import shardings as SH

    local = SH.shard_params(params, mesh)
    batch = train_batch(m.vocab)
    out = {}
    for policy in ACT_POLICIES:
        step, _ = TS.make_train_step(m, lr=TRAIN_LR, mesh=mesh, remat=True,
                                     act_shard=policy)
        saved = []

        def pack(t):
            saved.append((tuple(t.shape), t.numel() * t.element_size()))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, grads = step.loss_and_grads(local, batch)
        out[policy] = dict(loss=float(loss), grads=flat(grads),
                           saved=saved)
    return out


#: the microbatch counts held to one rank's: at 4 a microbatch's one row
#: does not split over 'data', so every rank computes it whole and FSDP's
#: gathers only cut their gradients
MICROBATCHES = (2, 4)


def micro_runs(m, params, mesh, one):
    """Each of MICROBATCHES on the blocks beside one rank's."""
    from repro_torch.train import shardings as SH

    out = {}
    for micro in MICROBATCHES:
        step, _ = TS.make_train_step(m, lr=TRAIN_LR, mesh=mesh, remat=False,
                                     microbatches=micro)
        loss, grads = step.loss_and_grads(SH.shard_params(params, mesh),
                                          train_batch(m.vocab))
        one_loss, one_grads = _one_rank_grads(
            m, params, train_batch(m.vocab), one, micro=micro)
        out[micro] = dict(loss=float(loss), grads=flat(grads),
                          one_loss=float(one_loss),
                          one_grads=flat(one_grads))
    return out


def collective_grads(mesh):
    """Each collective's backward on a (2, 2) mesh, on tensors whose
    gradients have closed forms (``tests/test_torch_model_axis_train``
    holds them): the f/g pair, the gather whose gradient is summed and
    cut, the gather whose gradient is only cut, FSDP's gather with the
    rows split and not, and a save point's block and its gather."""
    from repro_torch.train import parallel as PAR
    from repro_torch.train import shardings as SH

    coord = SH.coordinate(mesh)
    mr = coord["model"]
    grp = PAR.axis(mesh, "model").group
    base = torch.arange(8, dtype=torch.float64)
    out = {}
    # f/g: y = sum over 'model' of (x · w_r); loss = sum(y · c)
    x = base.clone().requires_grad_(True)
    w = base + 10 * mr
    y = PAR.sum_over(PAR.enter_local(x, grp) * w, grp)
    (y * (base + 1)).sum().backward()
    out["fg"] = (y.detach().numpy(), x.grad.numpy())
    # a gathered block summed and cut: loss = sum over ranks of
    # sum(gather(b_r) · a_r)
    b = (base[4 * mr:4 * mr + 4] + 0.5).requires_grad_(True)
    a = base * (mr + 1)
    loss = PAR.sum_over((PAR.gather_dim(b, 0, grp) * a).sum(), grp)
    loss.backward()
    out["gather_sum"] = b.grad.numpy()
    # gathered for a replicated consumer: only cut
    b2 = (base[4 * mr:4 * mr + 4] + 0.5).requires_grad_(True)
    (PAR.gather_dim(b2, 0, grp, grad_group=None) * (base + 1)).sum(
    ).backward()
    out["gather_cut"] = b2.grad.numpy()
    # FSDP: a leaf's dim 0 on 'data'; the consumer's rows on this rank
    dr = coord["data"]
    for split in (2, 1):
        leaf = (base[4 * dr:4 * dr + 4] + 1).requires_grad_(True)
        with SH.use_mesh(mesh, split=split):
            full = PAR.unshard_data({"w": leaf}, {"w": SH.P("data")})["w"]
        rows = base * (dr + 1) if split > 1 else base
        (full * rows).sum().backward()
        out[f"fsdp split {split}"] = leaf.grad.numpy()
    # a save point: the block kept, gathered back; the gradient whole
    z = (base.reshape(2, 4) + 1).requires_grad_(True)
    kept = PAR.keep_block(z, 1, grp)
    back = PAR.gather_dim(kept, 1, grp, grad_group=None)
    (back * back).sum().backward()
    out["keep"] = (tuple(kept.shape), z.grad.numpy())
    return out


def training(mesh, shape):
    """Every arch of MODEL_ARCHS trained one step on the blocks beside one
    rank, and its act_shard policies; stablelm's microbatches."""
    one = Sizes(data=shape[0], model=1)
    out = {}
    for arch in MODEL_ARCHS:
        m = configs.get_reduced(arch)
        params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
        out[arch] = dict(sharded=train_sharded(m, params, mesh, remat=False))
        if dist.get_rank() == 0:
            out[arch]["one"] = train_one(m, params, one)
        out[arch]["act_shard"] = act_shard_runs(m, params, mesh)
    m = configs.get_reduced("stablelm-1.6b")
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    out["micro"] = micro_runs(m, params, mesh, one)
    return out


def model_axis_train_main(rank: int, world: int, store_path: str,
                          out_dir: str) -> None:
    torch.set_num_threads(1)
    init_process_group("gloo", dist.FileStore(store_path, world), rank,
                       world, timeout_s=120)
    out = {}
    try:
        meshes = {shape: make_host_mesh(shape, device="cpu")
                  for shape in MODEL_MESHES}
        for shape, mesh in meshes.items():
            out[shape] = dict(coord=tuple(mesh.get_coordinate()),
                              training=training(mesh, shape))
        out["collectives"] = collective_grads(meshes[2, 2])
        out["other_archs"] = recurrent(meshes[2, 2], (2, 2), OTHER_ARCHS,
                                       serve=False)
    except Exception:
        out["error"] = traceback.format_exc()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# hymba, xlstm and whisper across a 'model' axis
# ---------------------------------------------------------------------------
#: the archs of ``tests/test_torch_model_axis_recurrent.py``: reduced
#: hymba; hymba with 5 heads and one KV head, which 'model' 2 and 4 do not
#: divide (every rank forms every head, wo's rows split mid-head); reduced
#: xlstm; xlstm with 2 heads, which 'model' 4 does not divide (every rank
#: runs every mLSTM head, the decode state's m whole); reduced whisper
RECURRENT_ARCHS = ("hymba-1.5b", "hymba-5-heads", "xlstm-1.3b",
                   "xlstm-2-heads", "whisper-small")
#: whisper's encoder frames, and its decode steps' cache and count
REC_FRAMES, REC_CACHE, REC_STEPS = 32, 16, 8


def recurrent_config(configs_mod, builders_mod, arch: str):
    """`arch`'s reduced config from either package's ``configs`` and
    ``models.builders``; "hymba-5-heads" is reduced hymba with 5 heads of
    16 and one KV head, "xlstm-2-heads" reduced xlstm with 2 heads of
    32."""
    if arch == "hymba-5-heads":
        return builders_mod.sandwich_arch(
            "hymba-5-heads", "hybrid", 5, 64, 5, 1, 128, 512, head_dim=16,
            local_window=32, ssm_state=8, n_globals=3, tied=True)
    if arch == "xlstm-2-heads":
        return builders_mod.xlstm_arch("xlstm-2-heads", 4, 64, 2, 512,
                                       slstm_every=2, tied=True)
    return configs_mod.get_reduced(arch)


def rec_batch(m, b: int = MODEL_BATCH, s: int = MODEL_SEQ) -> dict:
    """{"tokens", "labels"[, "frames" (B, REC_FRAMES, D) float32]} as
    numpy arrays."""
    toks = model_tokens(m.vocab, b, s)
    out = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if m.enc_segments is not None:
        out["frames"] = np.random.default_rng(9).normal(
            size=(b, REC_FRAMES, m.d_model)).astype(np.float32)
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@contextlib.contextmanager
def _heads_seen():
    """The q heads of every attention call through ``kernels/ops``."""
    from repro_torch.kernels import ops

    seen, fa = [], ops._fa

    class Rec:
        @staticmethod
        def flash_attention(q, k, v, **kw):
            seen.append(q.shape[1])
            return fa.flash_attention(q, k, v, **kw)

    ops._fa = Rec
    try:
        yield seen
    finally:
        ops._fa = fa


def whisper_decode(m, params, mesh, sharded: bool):
    """REC_STEPS decode steps of whisper from empty caches of REC_CACHE
    slots after one ``encode`` of the frames (every rank the whole
    batch's), the steps' logits (B, REC_STEPS, V) and the states'
    bytes."""
    from repro_torch.train import shardings as SH

    batch = _torch_batch(rec_batch(m))
    p = SH.shard_params(params, mesh) if sharded else params
    with torch.no_grad(), SH.use_mesh(mesh):
        enc = MB.encode(p, m, batch["frames"])
    states = MB.init_decode_state(params, m, MODEL_BATCH, REC_CACHE)
    if sharded:
        states = SH.shard_states(states, mesh, MODEL_BATCH)
    dec = TS.make_decode_step(m, mesh=mesh,
                              cache_len=REC_CACHE if sharded else None)
    seen = []
    for t in range(REC_STEPS):
        logits, states = dec(p, batch["tokens"][:, t:t + 1], t, states,
                             enc_out=enc)
        seen.append(logits[:, 0].numpy().copy())
    return np.stack(seen, 1), _nbytes(states)


#: the archs whose steps across 'model' raised before they were ported
#: there; ``tests/test_torch_model_axis.py``, ``_train.py`` and
#: ``test_torch_shardings.py`` run each once on a small mesh
OTHER_ARCHS = ("hymba-1.5b", "xlstm-1.3b", "whisper-small")


def recurrent(mesh, shape, archs=RECURRENT_ARCHS, serve: bool = True,
              train: bool = True):
    """Each arch of `archs` on this rank's blocks beside one rank: with
    `serve` the prefill's logits (and the q heads of its attention
    calls), the Engine's tokens (hymba, xlstm) or whisper's decode steps,
    the bytes and shapes of the blocks kept; with `train` one train step
    (remat on, act_shard 'model'; rank 0 also the world of one's)."""
    from repro_torch.models import builders
    from repro_torch.train import shardings as SH

    one = Sizes(data=shape[0], model=1)
    out = {}
    for arch in archs:
        m = recurrent_config(configs, builders, arch)
        params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
        rec = out[arch] = {}
        if train:
            tb = _torch_batch(rec_batch(m))
            rec["train"] = train_sharded(m, params, mesh, batch=tb,
                                         remat=True, act_shard="model")
            if dist.get_rank() == 0:
                rec["one"] = train_one(m, params, one, batch=tb)
        if not serve:
            continue
        local = SH.shard_params(params, mesh)
        batch = _torch_batch(rec_batch(m))
        del batch["labels"]
        with _heads_seen() as heads:
            got = TS.make_prefill_step(m, mesh=mesh)(local, batch)
        want = TS.make_prefill_step(m, mesh=one)(params, batch)
        rec.update(logits=got.numpy(), one_logits=want.numpy(),
                   heads=sorted(set(heads)), param_bytes=_nbytes(local),
                   shapes=[tuple(t.shape) for t in tree_leaves(local)])
        if m.enc_segments is None:
            toks, iters, pbytes, sbytes = _engine_tokens(m, params, mesh)
            rec.update(tokens=toks, iters=iters, state_bytes=sbytes,
                       one_tokens=_engine_tokens(m, params, one)[0])
        else:
            rec["decode"], rec["state_bytes"] = whisper_decode(
                m, params, mesh, True)
            rec["one_decode"] = whisper_decode(m, params, one, False)[0]
            try:        # the Engine passes no enc_out (ROADMAP Queue 3 item 7)
                _engine_tokens(m, params, mesh)
            except ValueError as e:
                rec["engine_error"] = str(e)
    return out


#: configs wide enough that ``state_spec`` puts 'data' on a recurrent
#: state's non-batch dim at one lane on (2, 2) (a dim of 1024 or more the
#: batch does not take): hymba's SSM Di = 2·512 and the sLSTM's D = 1024
WIDE_ARCHS = ("hymba-wide", "xlstm-wide")
WIDE_STEPS = 4


def wide_config(builders_mod, arch: str):
    if arch == "hymba-wide":
        return builders_mod.sandwich_arch(
            "hymba-wide", "hybrid", 5, 512, 4, 2, 128, 512, head_dim=16,
            local_window=32, ssm_state=8, n_globals=3, tied=True)
    return builders_mod.xlstm_arch("xlstm-wide", 2, 1024, 4, 512,
                                   slstm_every=2, tied=True)


def batch_one_decode(mesh, shape):
    """Each WIDE_ARCHS config decoded at one lane for WIDE_STEPS steps from
    empty states, on this rank's blocks and on one rank: the logits, the
    shapes of this rank's state blocks, and the new states (the blocks
    gathered into whole leaves)."""
    from repro_torch.models import builders
    from repro_torch.train import shardings as SH

    one = Sizes(data=shape[0], model=1)
    out = {}
    for arch in WIDE_ARCHS:
        m = wide_config(builders, arch)
        params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
        toks = torch.from_numpy(model_tokens(m.vocab, 1, WIDE_STEPS))
        rec = out[arch] = {}
        for active in (mesh, one):
            states = MB.init_decode_state(params, m, 1, REC_CACHE)
            p = params
            if active is mesh:
                specs = SH.state_specs(states, mesh, 1)
                states = SH.shard_states(states, mesh, 1)
                p = SH.shard_params(params, mesh)
                rec["shapes"] = [tuple(t.shape) for t in tree_leaves(states)
                                 if isinstance(t, torch.Tensor)]
            dec = TS.make_decode_step(
                m, mesh=active, cache_len=REC_CACHE if active is mesh
                else None)
            seen = []
            for t in range(WIDE_STEPS):
                logits, states = dec(p, toks[:, t:t + 1], t, states)
                seen.append(logits[:, 0].numpy().copy())
            if active is mesh:
                states = [SH.gather_leaf(t, sp, mesh).numpy() for t, sp in
                          zip([t for t in tree_leaves(states)
                               if isinstance(t, torch.Tensor)],
                              SH.spec_leaves(specs))]
            else:
                states = [t.numpy() for t in tree_leaves(states)
                          if isinstance(t, torch.Tensor)]
            key = "sharded" if active is mesh else "one"
            rec[key] = dict(logits=np.stack(seen, 1), states=states)
    return out


def recurrent_main(rank: int, world: int, store_path: str,
                   out_dir: str) -> None:
    torch.set_num_threads(1)
    init_process_group("gloo", dist.FileStore(store_path, world), rank,
                       world, timeout_s=120)
    out = {}
    try:
        for shape in MODEL_MESHES:
            mesh = make_host_mesh(shape, device="cpu")
            out[shape] = dict(coord=tuple(mesh.get_coordinate()),
                              runs=recurrent(mesh, shape))
            if shape[0] > 1:
                out[shape]["wide"] = batch_one_decode(mesh, shape)
    except Exception:
        out["error"] = traceback.format_exc()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def steps_main(rank: int, world: int, store_path: str,
               out_dir: str) -> None:
    """OTHER_ARCHS served and trained once on a (1, world) mesh."""
    torch.set_num_threads(1)
    init_process_group("gloo", dist.FileStore(store_path, world), rank,
                       world, timeout_s=120)
    out = {}
    try:
        mesh = make_host_mesh((1, world), device="cpu")
        out["runs"] = recurrent(mesh, (1, world), OTHER_ARCHS)
    except Exception:
        out["error"] = traceback.format_exc()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def drop_world() -> None:
    """No process group running in this process: a world that an earlier
    test in a pytest worker left (``make_host_mesh`` starts a world of one
    where none runs) is destroyed, with the groups built under it, so
    ``counting_world`` may start."""
    from repro_torch.launch import mesh as LM

    if dist.is_initialized():
        dist.destroy_process_group()
        LM._FLAT_GROUPS.clear()
        LM._PLANE_GROUPS.clear()


#: the steps counted on 4 gloo ranks and on meta: (arch, kind, fsdp) at
#: COST_BATCH x COST_SEQ, float32, on the (2, 2) mesh
COST_CASES = tuple([("stablelm-1.6b", k, f) for k in ("prefill", "train",
                                                      "decode")
                    for f in (False, True)]
                   + [(a, k, True) for a in ("mixtral-8x7b", "hymba-1.5b")
                      for k in ("prefill", "train", "decode")])
COST_BATCH, COST_SEQ = 4, 128
COST_MESH = (2, 2)


def _collectives(totals: dict) -> dict:
    return {k: v for k, v in totals.items() if k.startswith("coll")
            or k == "n_coll"}


def _real_case(m, kind: str, fsdp: bool, mesh):
    """(step, args) of a COST_CASES step on this rank's real blocks: the
    params from seed 0, a batch of tokens, the decode states of a cache
    of COST_SEQ."""
    from repro_torch.train import shardings as SH

    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    local = SH.shard_params(params, mesh, fsdp=fsdp)
    toks = torch.from_numpy(model_tokens(m.vocab, COST_BATCH, COST_SEQ)
                            ).to(torch.int32)
    if kind == "train":
        step, optim = TS.make_train_step(m, mesh=mesh, fsdp=fsdp)
        return step, (local, optim.init(local),
                      {"tokens": toks, "labels": toks.roll(-1, 1)})
    if kind == "prefill":
        return TS.make_prefill_step(m, mesh=mesh, fsdp=fsdp), (
            local, {"tokens": toks})
    states = SH.shard_states(MB.init_decode_state(params, m, COST_BATCH,
                                                  COST_SEQ),
                             mesh, COST_BATCH)
    return TS.make_decode_step(m, mesh=mesh, cache_len=COST_SEQ,
                               fsdp=fsdp), (local, toks[:, :1],
                                            COST_SEQ - 1, states)


def costs_main(rank: int, world: int, store_path: str,
               out_dir: str) -> None:
    """COST_CASES' reduced steps on this rank's blocks of the (2, 2) gloo
    mesh, each counted by ``utils/op_cost`` (its collectives); whether
    ``counting_world`` refuses to start inside the running group; then,
    on rank 0 with the group destroyed, the same steps built by
    ``build_case`` on meta and counted inside ``counting_world(4)``."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.mesh import counting_world, make_mesh
    from repro_torch.utils import op_cost

    torch.set_num_threads(1)
    init_process_group("gloo", dist.FileStore(store_path, world), rank,
                       world, timeout_s=120)
    out = {"gloo": {}, "fake": {}}
    try:
        mesh = make_host_mesh(COST_MESH, device="cpu")
        try:
            with counting_world(world):
                out["refused"] = False
        except RuntimeError as e:
            out["refused"] = str(e)
        for arch, kind, fsdp in COST_CASES:
            step, args = _real_case(configs.get_reduced(arch), kind, fsdp,
                                    mesh)
            out["gloo"][arch, kind, fsdp] = _collectives(
                op_cost.analyze(step, *args))
    except Exception:
        out["error"] = traceback.format_exc()
    dist.destroy_process_group()
    if rank == 0 and "error" not in out:
        try:
            with counting_world(world):
                mesh = make_mesh(COST_MESH, ("data", "model"), device="cpu")
                for arch, kind, fsdp in COST_CASES:
                    case = TS.build_case(
                        configs.get_reduced(arch),
                        Shape(f"{kind}_cost", COST_SEQ, COST_BATCH, kind),
                        mesh, dtype=torch.float32, fsdp=fsdp)
                    out["fake"][arch, kind, fsdp] = _collectives(
                        op_cost.analyze(case.fn, *case.args))
        except Exception:
            out["error"] = traceback.format_exc()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def main(rank: int, world: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    init_process_group("gloo", dist.FileStore(store_path, world), rank,
                       world, timeout_s=120)
    mesh = make_host_mesh(device="cpu")
    out = {"mesh": (tuple(mesh.shape), mesh.mesh_dim_names),
           "n_shards": shard.n_task_shards(mesh)}
    try:
        for part in (dse, train, lm):
            out.update(part(mesh))
    except Exception:
        out["error"] = traceback.format_exc()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    {("model",): model_axis_main, ("train",): model_axis_train_main,
     ("recurrent",): recurrent_main, ("steps",): steps_main,
     ("costs",): costs_main}.get(
        tuple(sys.argv[5:]), main)(
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
