"""The subspace chart: an anchor θ0, an orthonormal (k, P) basis V over
the raveled parameters, and the lift c ↦ θ0 + Σᵢ cᵢ·Vᵢ (DESIGN.md §11).

Port of ``repro/core/subspace.py`` for the LM-loss backend, sized for one
card at published widths, where the basis (k × P f32) is tens of GB:

* the basis is made in place: k rows of normal draws, orthonormalised by
  modified Gram–Schmidt with f64 dot products, not a QR of a (P, k)
  copy;
* ``basis_tree`` leaves are VIEWS of the flat basis
  (``basis[:, off:off+size]`` reshaped to (k, *leaf.shape)), not copies;
* the reference's ``flat0`` (the raveled θ0) and ``unravel`` serve the
  flat-space optimizer, which is not ported, and are left out;
* ``tree_lift`` may write into a given set of working parameters instead
  of allocating a fresh tree per lane (the JAX package's arrays are
  immutable; the port updates in place to keep one set on the card).

The lift is computed leaf by leaf in f32 and cast to each leaf's type,
as the reference's.  Leaves are taken in JAX's flatten order
(``core/tree.py``), so a reference basis carries across unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core.tree import leaves_with_paths, map_tree, map_with_paths

#: elements per f64 partial dot product when orthonormalising (bounds the
#: temporaries at 2 × 128 MB whatever P is)
_DOT_CHUNK = 1 << 24


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    acc = torch.zeros((), dtype=torch.float64, device=a.device)
    for s in range(0, a.numel(), _DOT_CHUNK):
        acc += torch.dot(a[s:s + _DOT_CHUNK].double(),
                         b[s:s + _DOT_CHUNK].double())
    return float(acc)


def orthonormalize_(rows: torch.Tensor) -> torch.Tensor:
    """Orthonormalise the rows of a (k, P) f32 tensor in place (modified
    Gram–Schmidt, f64 dot products); returns it."""
    for i in range(rows.shape[0]):
        for j in range(i):
            rows[i].sub_(rows[j], alpha=_dot(rows[i], rows[j]))
        rows[i].div_(math.sqrt(_dot(rows[i], rows[i])))
    return rows


def orthonormal_basis(n: int, k: int, generator: torch.Generator,
                      device="cuda") -> torch.Tensor:
    """(k, n) f32 orthonormal rows from normal draws of ``generator``."""
    rows = torch.randn((k, n), generator=generator, device=device,
                       dtype=torch.float32)
    return orthonormalize_(rows)


def basis_to_tree(basis: torch.Tensor, params: Any) -> Any:
    """Each leaf's slice of the flat (k, P) basis as a (k, *leaf.shape)
    view, in a tree shaped like ``params``."""
    k = basis.shape[0]
    views, off = {}, 0
    for path, leaf in leaves_with_paths(params):
        size = leaf.numel()
        views[path] = basis[:, off:off + size].view((k,) + tuple(leaf.shape))
        off += size
    if off != basis.shape[1]:
        raise ValueError(f"basis has {basis.shape[1]} columns, the "
                         f"parameters {off}")
    return map_with_paths(lambda path, _: views[path], params)


def tree_lift(theta0: Any, basis_tree: Any, c: torch.Tensor,
              out: Optional[Any] = None) -> Any:
    """θ0 + Σᵢ cᵢ·Vᵢ per leaf in f32, cast back to each leaf's type, written
    into ``out`` (a tree like θ0; a new one if None), which is returned.
    The largest temporary is one leaf in f32."""
    def lift(p, b, dst):
        delta = torch.matmul(c, b.reshape(b.shape[0], -1))     # (size,) f32
        delta.add_(p.reshape(-1))                              # + θ0 in f32
        dst.copy_(delta.view(p.shape))
    if out is None:
        out = map_tree(torch.empty_like, theta0)
    map_tree(lift, theta0, basis_tree, out)
    return out


@dataclasses.dataclass(frozen=True)
class SubspaceProjection:
    """One fixed k-dim affine chart through parameter space.

    ``theta0``: anchor parameters (their own types); ``basis``: (k, P) f32
    orthonormal rows over the raveled parameters (JAX's leaf order);
    ``basis_tree``: views of it leaf by leaf, (k, *leaf.shape).
    """
    theta0: Any
    basis: torch.Tensor
    basis_tree: Any

    @property
    def k(self) -> int:
        return int(self.basis.shape[0])

    @property
    def n_params(self) -> int:
        return int(self.basis.shape[1])

    @classmethod
    def create(cls, params: Any, k: int,
               generator: torch.Generator) -> "SubspaceProjection":
        n = sum(leaf.numel() for _, leaf in leaves_with_paths(params))
        device = leaves_with_paths(params)[0][1].device
        basis = orthonormal_basis(n, k, generator, device)
        return cls.from_basis(params, basis)

    @classmethod
    def from_basis(cls, params: Any,
                   basis: torch.Tensor) -> "SubspaceProjection":
        return cls(theta0=params, basis=basis,
                   basis_tree=basis_to_tree(basis, params))

    def lift(self, c: torch.Tensor, out: Optional[Any] = None) -> Any:
        """c (k,) → parameters at θ0 + c·V (into ``out`` if given)."""
        return tree_lift(self.theta0, self.basis_tree, c, out)
