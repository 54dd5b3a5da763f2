"""Rank bodies for the tests of training's data axis over ranks
(``launch/ranks.py``, ``launch/train.py --ranks``, with ``--fsdp`` the
parameters cut over the ranks too, and with ``--model-ranks`` over the
model axis across them; ``moe_forward``, a MoE block over the model
axis's ranks alone).

``steps`` runs in a rank, a child process forked from the port's
forkserver, as ``target(group, **kwargs)``, and in the test's own process
with ``group=None`` for the one-process run of the same steps on the
hosts' concatenated batches.  It imports torch and the port only (no jax,
no reference): the parameters come from an npz the test wrote (the
reference's, carried across by leaf path), and the batches from the
port's copy of the reference's pipeline, one host a rank.
"""
import numpy as np
import torch

from repro_torch.configs.base import config_from_dict
from repro_torch.core.tree import leaves_with_paths, map_tree
from repro_torch.launch import train
from repro_torch.models import layers as L
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.models.transformer import NULL_CTX
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compression import init_error_state

#: the steps' AdamW, as ``tests/torch_train_step.py``'s
LR, WD = 1e-3, 0.01


class Recording:
    """An optimizer that keeps a copy of the gradients the step hands it
    (``update`` scales them for the clip in place): over ranks, the
    gradients summed over the ranks."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, **kw):
        self.grads = map_tree(torch.clone, grads)
        return self.opt.update(grads, state, params, **kw)


def _npz(path: str) -> dict:
    with np.load(path) as arrays:
        return {k: arrays[k] for k in arrays.files}


def steps(group, *, cfg: dict, leaves: str, seq: int, batch: int,
          n_steps: int, hosts: int, out: str, seed: int = 0,
          compress: bool = False, fsdp: bool = False,
          model_ranks: int = 1) -> dict:
    """``n_steps`` of the launcher's AdamW step (``train.make_full_step``)
    from the parameters in ``leaves``, over ``hosts`` hosts' batches of
    the synthetic stream: as rank r of ``group`` (its host's slice, the
    step in ``sharding.data_parallel_ctx``, or with ``fsdp`` in
    ``sharding.fsdp_ctx`` from its blocks of the cut leaves, or with
    ``model_ranks`` M > 1 in ``sharding.tp_ctx`` on the (W/M, M) mesh,
    host r // M's slice, from its ``model`` blocks), or in this process on
    the hosts' concatenated batches (``group`` None).  Writes
    the new parameters (``p/<path>``), each step's gradients as the
    optimizer got them (``g<i>/<path>``: summed over the ranks, and
    compressed with ``compress``; a cut leaf's block) and the error state
    (``e/<path>``) to ``<out>_<rank>.npz`` (``<out>_one.npz`` in one
    process); returns each step's loss, ce and aux, the state's digest
    (with ``fsdp`` or ``model_ranks`` of the whole leaves) and the
    collectives' counts."""
    pcfg = config_from_dict(cfg)
    params = T.params_from_leaves(pcfg, _npz(leaves), device="cpu")
    if group is None:
        ctx = NULL_CTX
        sources = [train.host_data(pcfg, seq, batch, seed, hosts, h)
                   for h in range(hosts)]
    else:
        m = model_ranks
        assert group.world == hosts * m
        mesh = group.mesh((hosts, m), model_ranks=m)
        ctx = (S.tp_ctx(mesh, pcfg) if m > 1
               else S.fsdp_ctx(mesh, pcfg) if fsdp
               else S.data_parallel_ctx(mesh))
        sources = [train.host_data(pcfg, seq, batch, seed, hosts,
                                   group.rank // m)]
        if fsdp or m > 1:
            params = ctx.ranks.shard(params)
    opt = Recording(AdamW(lr=LR, weight_decay=WD))
    state = opt.init(params)
    err = init_error_state(params) if compress else None
    step = train.make_full_step(pcfg, opt, compress=compress, device="cpu",
                                ctx=ctx)
    doc = {"loss": [], "ce": [], "aux": []}
    arrays = {}
    for i in range(n_steps):
        b = train.batch_to(train.hosts_batch(sources, i), pcfg, "cpu")
        params, state, err, metrics = step(params, state, err, b, None)
        for name in doc:
            doc[name].append(float(metrics[name]))
        for path, g in leaves_with_paths(opt.grads):
            arrays[f"g{i}/{path}"] = g.float().numpy()
    for path, p in leaves_with_paths(params):
        arrays[f"p/{path}"] = p.float().numpy()
    if err is not None:
        for path, e in leaves_with_paths(err):
            arrays[f"e/{path}"] = e.numpy()
    np.savez(f"{out}_{'one' if group is None else group.rank}.npz",
             **arrays)
    r = ctx.ranks
    blocks = fsdp or model_ranks > 1
    doc["digest"] = train.state_digest(r.whole_leaves(params) if blocks
                                       else params, err)
    if r is not None:
        doc.update(gradient_bytes=r.gradient_bytes,
                   gradient_all_reduces=r.gradient_all_reduces,
                   loss_bytes=r.loss_bytes,
                   loss_all_reduces=r.loss_all_reduces)
    if fsdp:
        doc.update(gather_bytes=r.gather_bytes, gathers=r.gathers,
                   scatter_bytes=r.scatter_bytes, scatters=r.scatters)
    if model_ranks > 1:
        doc.update(model_bytes=r.model_bytes, model_calls=r.model_calls,
                   partial=sorted(r.partial),
                   fallbacks=[list(f) for f in r.fallbacks])
    if blocks:
        doc.update(gnorms=[float(g) for g in r.gnorms], cuts=r.cuts,
                   moment_shapes={path: list(m.shape) for path, m in
                                  leaves_with_paths(state["mu"])})
    return doc


def local_losses(group, *, cfg: dict, leaves: str, seq: int, batch: int,
                 hosts: int, seed: int = 0) -> dict:
    """The rank's loss over ranks (the whole batch's) and the loss of its
    own rows alone (a one-process loss of its host's slice): a mean of
    the latter over the ranks is the wrong global loss where masks
    differ."""
    pcfg = config_from_dict(cfg)
    params = T.params_from_leaves(pcfg, _npz(leaves), device="cpu")
    src = train.host_data(pcfg, seq, batch, seed, hosts, group.rank)
    b = train.batch_to(src.batch(0), pcfg, "cpu")
    ctx = S.data_parallel_ctx(group.mesh((group.world, 1)))
    with torch.no_grad():
        whole, _ = T.make_loss_fn(pcfg, ctx)(params, b)
        own, _ = T.make_loss_fn(pcfg)(params, b)
    return {"loss": float(whole), "own_loss": float(own),
            "mask_count": int(b["mask"].sum()) if "mask" in b else None}


def moe_forward(group, *, cfg: dict, x: str, out: str,
                model_ranks: int) -> dict:
    """The first MoE layer's block (``layers.moe_block``, the parameters
    drawn from seed 0) on the rows in ``x``, as rank r of ``group`` in
    ``sharding.tp_ctx`` on the (W/M, M) mesh from its ``model`` blocks:
    its output and load-balance loss to ``<out>_<rank>.npz``, and the
    collectives' counts."""
    pcfg = config_from_dict(cfg)
    params = T.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    m = model_ranks
    ctx = S.tp_ctx(group.mesh((group.world // m, m), model_ranks=m), pcfg)
    held = ctx.ranks.shard(params)
    moe = map_tree(lambda t: t[0], held["segments"][1][0]["moe"])
    with torch.no_grad():
        y, aux = L.moe_block(torch.from_numpy(_npz(x)["x"]), moe, pcfg, ctx)
    np.savez(f"{out}_{group.rank}.npz", y=y.numpy(), aux=aux.numpy())
    return {"model_bytes": ctx.ranks.model_bytes,
            "model_calls": ctx.ranks.model_calls}
