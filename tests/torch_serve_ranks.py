"""Rank bodies for the tests of serving over the model axis's ranks
(``launch/serve.py --ranks W --model-ranks M``, ``sharding.tp_ctx`` with
the caches cut per ``cache_specs``).

``probes`` runs in a rank, a child process forked from the port's
forkserver, as ``target(group, **kwargs)``.  It imports torch and the
port only (no jax, no reference): the parameters come from an npz the
test wrote (the reference's, carried across by leaf path), the tokens
from an npy.
"""
import numpy as np
import torch

from repro_torch.configs.base import config_from_dict
from repro_torch.launch import serve
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T


def _npz(path: str) -> dict:
    with np.load(path) as arrays:
        return {k: arrays[k] for k in arrays.files}


def probes(group, *, cases: dict) -> dict:
    """Each case of ``cases`` (name: {"cfg", "leaves", "tokens",
    "decode_len", "max_seq", "model_ranks", "out"}) on the (W/M, M) mesh
    over the group: the rank keeps its blocks of the parameters, and
    ``serve.run_probe`` runs the prefill of the tokens and the decode of
    their first ``decode_len`` positions through its block of the caches.
    Writes the rank's logits to ``out`` (``{rank}``, ``{phase}``) and
    returns, by case, the phases' docs (collectives by kind, the decode's
    first step apart, the cache's layout)."""
    out = {}
    for name, case in cases.items():
        cfg = config_from_dict(case["cfg"])
        m = case["model_ranks"]
        ctx = S.tp_ctx(group.mesh((group.world // m, m), model_ranks=m), cfg)
        params = ctx.ranks.shard(T.params_from_leaves(
            cfg, _npz(case["leaves"]), device="cpu"))
        tokens = torch.from_numpy(np.load(case["tokens"])).long()
        res = serve.run_probe(params, cfg, ctx, tokens,
                              decode_len=case["decode_len"],
                              max_seq=case["max_seq"])
        for phase in ("prefill", "decode"):
            np.save(case["out"].format(rank=group.rank, phase=phase),
                    res[phase].numpy())
        out[name] = {"prefill": res["prefill_doc"],
                     "decode": res["decode_doc"]}
    return out


def one_process(case: dict) -> dict:
    """The same probe in this process, over the whole parameters and
    caches: {"prefill", "decode"} logits."""
    cfg = config_from_dict(case["cfg"])
    params = T.params_from_leaves(cfg, _npz(case["leaves"]), device="cpu")
    tokens = torch.from_numpy(np.load(case["tokens"])).long()
    res = serve.run_probe(params, cfg, T.NULL_CTX, tokens,
                          decode_len=case["decode_len"],
                          max_seq=case["max_seq"])
    return {phase: res[phase].numpy() for phase in ("prefill", "decode")}
