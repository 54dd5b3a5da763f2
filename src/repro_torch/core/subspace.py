"""The subspace chart: an anchor θ0, an orthonormal (k, P) basis V over
the raveled parameters, and the lift c ↦ θ0 + Σᵢ cᵢ·Vᵢ (DESIGN.md §11).

Port of ``repro/core/subspace.py`` for the LM-loss backend, sized for one
card at published widths, where the basis (k × P f32) is tens of GB:

* the basis is made in place: k rows of normal draws, orthonormalised by
  modified Gram–Schmidt with f64 dot products kept on the device (no
  host read), not a QR of a (P, k) copy;
* ``basis_tree`` leaves are VIEWS of the flat basis
  (``basis[:, off:off+size]`` reshaped to (k, *leaf.shape)), not copies;
* ``flat0`` (the raveled θ0 in f32) is made when asked for, not held:
  the frozen chart of the LM backend never reads it, and at published
  width it is P × 4 bytes; ``unravel``, ``lift_flat`` and ``shift_flat``
  serve the flat-space optimizer (``core/subspace_newton.py``);
* an ``anchor`` row (the optimizer's momentum) is orthonormalised as the
  reference's Householder QR gives it: row 0 is a / β with
  β = −sign(a₀)·‖a‖ (sign(0) = +), and a zero anchor gives e₁ with
  coordinate 0 of every other row zeroed.  Those rows' signs are the
  port's own (Gram–Schmidt);
* ``tree_lift`` may write into a given set of working parameters instead
  of allocating a fresh tree per lane (the JAX package's arrays are
  immutable; the port updates in place to keep one set on the card).

The lift is computed leaf by leaf in f32 and cast to each leaf's type,
as the reference's.  Leaves are taken in JAX's flatten order
(``core/tree.py``), so a reference basis carries across unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.tree import leaves_with_paths, map_tree, map_with_paths

#: elements per f64 partial dot product when orthonormalising (bounds the
#: temporaries at 2 × 128 MB whatever P is)
_DOT_CHUNK = 1 << 24


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b as a 0-d f64 tensor on the device, summed chunk by chunk."""
    acc = torch.zeros((), dtype=torch.float64, device=a.device)
    for s in range(0, a.numel(), _DOT_CHUNK):
        acc += torch.dot(a[s:s + _DOT_CHUNK].double(),
                         b[s:s + _DOT_CHUNK].double())
    return acc


def ravel_tree(tree: Any) -> torch.Tensor:
    """The leaves of ``tree`` raveled into one (P,) f32 vector, in JAX's
    leaf order."""
    leaves = leaves_with_paths(tree)
    flat = torch.empty(sum(leaf.numel() for _, leaf in leaves),
                       dtype=torch.float32, device=leaves[0][1].device)
    off = 0
    for _, leaf in leaves:
        flat[off:off + leaf.numel()].copy_(leaf.reshape(-1))
        off += leaf.numel()
    return flat


def unravel_like(like: Any, v: torch.Tensor) -> Any:
    """(P,) → a tree shaped like ``like``: each leaf its slice of ``v``
    (JAX's leaf order) cast to that leaf's type, as a copy."""
    offsets, off = {}, 0
    for path, leaf in leaves_with_paths(like):
        offsets[path] = off
        off += leaf.numel()
    if off != v.numel():
        raise ValueError(f"a vector of {v.numel()} for {off} parameters")
    return map_with_paths(
        lambda path, leaf: v[offsets[path]:offsets[path] + leaf.numel()]
        .view(leaf.shape).to(leaf.dtype, copy=True), like)


def orthonormalize_(rows: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Orthonormalise rows ``start``.. of a (k, P) f32 tensor in place
    against every row before each (modified Gram–Schmidt, f64 dot products
    kept on the device); rows before ``start`` must be orthonormal
    already.  Returns ``rows``."""
    for i in range(start, rows.shape[0]):
        for j in range(i):
            rows[i].addcmul_(rows[j], _dot(rows[i], rows[j]).float(),
                             value=-1.0)
        rows[i].div_(torch.sqrt(_dot(rows[i], rows[i])).float())
    return rows


def _anchor_row_(rows: torch.Tensor) -> None:
    """Row 0 (the anchor a) as the reference's QR makes it: a / β with
    β = −sign(a₀)·‖a‖, or e₁ where a = 0 (and then coordinate 0 of every
    other row zeroed)."""
    a = rows[0]
    norm = torch.sqrt(_dot(a, a))
    zero = norm == 0
    beta = torch.where(a[0] < 0, norm, -norm)
    a.div_(torch.where(zero, torch.ones_like(beta), beta).float())
    a[0].add_(zero.float())
    rows[1:, 0].mul_((~zero).float())


def orthonormal_basis(n: int, k: int, generator: torch.Generator,
                      device="cuda",
                      anchor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(k, n) f32 orthonormal rows: ``anchor`` (the momentum) first when
    given, then normal draws of ``generator`` (k − 1 rows with an anchor,
    k without)."""
    if anchor is None:
        rows = torch.randn((k, n), generator=generator, device=device,
                           dtype=torch.float32)
        return orthonormalize_(rows)
    rows = torch.empty((k, n), device=device, dtype=torch.float32)
    rows[0].copy_(anchor)
    rows[1:].normal_(generator=generator)
    _anchor_row_(rows)
    return orthonormalize_(rows, start=1)


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
    ``basis_tree``: views of it leaf by leaf, (k, *leaf.shape);
    ``flat0``: θ0 raveled in f32, made at each access; ``unravel``:
    (P,) → parameters in θ0's shapes and types.
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

    @property
    def flat0(self) -> torch.Tensor:
        return ravel_tree(self.theta0)

    def unravel(self, v: torch.Tensor) -> Any:
        return unravel_like(self.theta0, v)

    @classmethod
    def create(cls, params: Any, k: int, generator: torch.Generator,
               anchor: Optional[torch.Tensor] = None
               ) -> "SubspaceProjection":
        n = sum(leaf.numel() for _, leaf in leaves_with_paths(params))
        device = leaves_with_paths(params)[0][1].device
        basis = orthonormal_basis(n, k, generator, device, anchor)
        return cls.from_basis(params, basis)

    @classmethod
    def from_basis(cls, params: Any,
                   basis: torch.Tensor) -> "SubspaceProjection":
        return cls(theta0=params, basis=basis,
                   basis_tree=basis_to_tree(basis, params))

    def lift(self, c: torch.Tensor, out: Optional[Any] = None) -> Any:
        """c (k,) → parameters at θ0 + c·V (into ``out`` if given)."""
        return tree_lift(self.theta0, self.basis_tree, c, out)

    def lift_flat(self, c: torch.Tensor) -> torch.Tensor:
        """c (k,) → the raveled (P,) f32 point θ0 + c·V."""
        return self.flat0 + c @ self.basis

    def shift_flat(self, c: torch.Tensor) -> torch.Tensor:
        """c (k,) → the raveled displacement c·V (momentum updates)."""
        return c @ self.basis
