"""Minimal AdamW: global-norm clip, bias-corrected moments in f32,
decoupled weight decay.

Port of ``repro/optim/adamw.py``::

    opt = AdamW(lr=3e-4)
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

The state is ``{"mu", "nu", "step"}``: the moments in f32, one per
parameter, and ``step`` a 0-d int32 tensor on the parameters' device.

What ``update`` consumes in place: the gradients (scaled for the clip)
and the moments ``mu`` and ``nu`` (the returned state holds the same
tensors, updated).  What it leaves: the parameters; it returns new
parameter tensors, as the reference does, so a caller can hold the old
and the new ones together (the line search of ``launch/train.py`` reads
both).  The work runs leaf by leaf and, within a leaf of more than
``SLICE_ELEMS`` elements, slice by slice along its leading axis, so its
f32 temporaries never stand whole beside the model: at h2o-danube-3's
published width a stacked MLP leaf is (24, 3840, 10240), 1.9 GB in bf16
and 3.8 GB as an f32 copy.  Nothing in ``update`` reads a device value on
the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.core.tree import leaves_with_paths, map_tree
from repro_torch.models.sharding import PartitionSpec as P

#: a leaf of more elements than this is updated in slices along its
#: leading axis, each of at most this many elements (256 MiB as f32)
SLICE_ELEMS = 1 << 26


def _slices(*tensors: torch.Tensor) -> Iterator[tuple]:
    """Matching slices of tensors of one shape: the tensors whole where
    they are small or 0-d, else views of at most ``SLICE_ELEMS`` elements
    along the leading axis."""
    x = tensors[0]
    if x.dim() == 0 or x.numel() <= SLICE_ELEMS:
        yield tensors
        return
    rows = max(1, SLICE_ELEMS // max(1, x.numel() // x.shape[0]))
    for r0 in range(0, x.shape[0], rows):
        yield tuple(t[r0:r0 + rows] for t in tensors)


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g²) in f32, a 0-d tensor on the gradients'
    device, with no f32 copy of a whole leaf (the reference sums leaf by
    leaf in a Python ``sum``; torch reduces each leaf in its own order, so
    the last bits may differ)."""
    total = None
    for _, g in leaves_with_paths(grads):
        for (part,) in _slices(g):
            x = part.to(torch.float32)
            s = torch.sum(x * x)
            total = s if total is None else total + s
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    # optional schedule: step (0-d int32 tensor) -> lr multiplier
    schedule: Optional[Callable[[torch.Tensor], Any]] = None

    def init(self, params) -> Any:
        """Zero f32 moments shaped like ``params`` and step 0, on the
        parameters' device."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = leaves_with_paths(params)[0][1].device
        return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, grads, state, params):
        """Returns (new_params, new_state).  ``grads`` (scaled for the clip)
        and the state's moments are updated in place; ``params`` is left
        as it is."""
        with torch.no_grad():
            return self._update(grads, state, params)

    def _update(self, grads, state, params):
        step = state["step"] + 1
        if self.grad_clip > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            for _, g in leaves_with_paths(grads):
                g.mul_(scale.to(g.dtype))
        lr = self.lr * (self.schedule(step) if self.schedule is not None
                        else 1.0)
        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.pow(self.b1, stepf)
        b2c = 1.0 - torch.pow(self.b2, stepf)

        def upd(p, g, mu, nu):
            out = torch.empty_like(p)
            for p_, g_, mu_, nu_, out_ in _slices(p, g, mu, nu, out):
                g32 = g_.to(torch.float32)
                mu_.mul_(self.b1).add_(g32, alpha=1 - self.b1)
                nu_.mul_(self.b2).addcmul_(g32, g32, value=1 - self.b2)
                del g32
                den = torch.div(nu_, b2c).sqrt_().add_(self.eps)
                delta = torch.div(mu_, b1c).div_(den)
                del den
                p32 = p_.to(torch.float32)
                if self.weight_decay:
                    delta.add_(p32, alpha=self.weight_decay)
                delta.mul_(lr)
                out_.copy_(torch.sub(p32, delta, out=delta))
            return out

        new_params = map_tree(upd, params, grads, state["mu"], state["nu"])
        return new_params, {"mu": state["mu"], "nu": state["nu"],
                            "step": step}


def opt_state_specs(param_specs_tree):
    """Optimizer-state ``PartitionSpec`` tree mirroring the parameters'
    specs (moments are sharded exactly like their parameters)."""
    return {"mu": param_specs_tree, "nu": param_specs_tree, "step": P()}
