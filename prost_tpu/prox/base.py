"""Prox operator base machinery.

Design (re-think of /root/reference/include/prost/prox/prox.hpp):

A prox operator owns the contiguous range ``[index, index+size)`` of a flat
variable vector and is a *pure function*

    eval_local(arg, tau_diag, tau_scal, invert_tau) -> result

on that segment.  There is no Eval/EvalLocal split with device iterators: the
solver slices the flat vector once per segment at trace time (static slices,
so XLA fuses the slice + prox + concatenate into the surrounding
element-wise work).

``ProxSeparableSum`` adds the (count, dim, interleaved) structure of
prox_separable_sum.hpp:36-44: ``size = count * dim`` vectors laid out either
interleaved (x1 y1 x2 y2 ...) or planar (x1 x2 ... y1 y2 ...).  Instead of
the reference's strided Vector<T> view (vector.hpp:42-48), each elem-op
receives the segment reshaped to ``(dim, count)``: component i of all
vectors is row i.  This puts the large ``count`` axis in the minor
(contiguous) dimension, so elementwise work over it is unit-stride; ``dim``
is typically tiny (2..32).  For planar data
the reshape is free; for interleaved data it is a transpose that XLA fuses
into the adjacent elementwise ops.

``diagsteps`` mirrors prox.hpp:133-134: whether the operator can handle
per-coordinate step sizes.  Where it can't, the Problem averages the
preconditioner over each vector (problem.cu:503-536) so that using the
first component of tau per vector is exact.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from ..common import pytree_dataclass, static_field
from ..config import ProstError


class Prox:
    """Base: subclasses are pytree dataclasses with at least index/size."""

    index: int
    size: int

    @property
    def end(self) -> int:
        return self.index + self.size - 1

    @property
    def diagsteps(self) -> bool:
        return False

    def get_separable_structure(self):
        """List of (start_index, count, stride) triples (absolute indices)
        describing groups whose preconditioner entries must be averaged when
        diagsteps is False.  Default: whole range, stride 1
        (prox.cu:74-78)."""
        return [(self.index, self.size, 1)]

    def average_precond(self, seg):
        """Vectorized preconditioner averaging over this prox's separable
        groups (equivalent to AveragePreconditioners, problem.cu:503-536,
        but as one fused op instead of a host loop over groups).  Called
        only when diagsteps is False."""
        return jnp.full_like(seg, jnp.mean(seg))

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau: bool):
        raise NotImplementedError

    def eval(self, arg, tau_diag, tau_scal, invert_tau: bool = False):
        """Slice the flat vectors to this operator's range and evaluate.

        Mirrors Prox<T>::Eval (prox.cu:27-43) minus the device plumbing.
        """
        lo, hi = self.index, self.index + self.size
        return self.eval_local(arg[lo:hi], tau_diag[lo:hi], tau_scal, invert_tau)


class ProxSeparableSum(Prox):
    """Prox with count x dim separable-sum structure."""

    count: int
    dim: int
    interleaved: bool

    def get_separable_structure(self):
        # One entry per dim-dimensional vector (prox_separable_sum.hpp:65-77).
        if self.interleaved:
            return [(self.index + i * self.dim, self.dim, 1) for i in range(self.count)]
        return [(self.index + i, self.dim, self.count) for i in range(self.count)]

    def average_precond(self, seg):
        vecs = self.to_vectors(seg)
        avg = jnp.broadcast_to(jnp.mean(vecs, axis=0, keepdims=True), vecs.shape)
        return self.from_vectors(avg)

    # -- layout helpers -----------------------------------------------------

    def to_vectors(self, seg):
        """Segment (size,) -> (dim, count): row i = component i of all vectors."""
        if self.interleaved:
            return seg.reshape(self.count, self.dim).T
        return seg.reshape(self.dim, self.count)

    def from_vectors(self, vecs):
        """(dim, count) -> flat segment (size,) in this prox's layout."""
        if self.interleaved:
            return vecs.T.reshape(self.size)
        return vecs.reshape(self.size)

    def vector_tau(self, tau_diag):
        """Per-vector step (count,): first component of each vector's tau.

        Exact when diagsteps is False because the Problem has averaged the
        preconditioner over each vector (problem.cu:503-536); matches the
        reference elem-ops reading tau_diag[0] (elem_operation_1d.hpp:40).
        """
        if self.interleaved:
            return tau_diag.reshape(self.count, self.dim)[:, 0]
        return tau_diag.reshape(self.dim, self.count)[0]


def effective_tau(tau_diag, tau_scal, invert_tau: bool):
    """Combined step size tau = tau_scal * tau_diag, optionally inverted.

    The invert_tau flip implements prox evaluation with step 1/tau, used by
    the Moreau identity (prox_moreau.cu) and ADMM's f-prox (backend_admm.cu:529).
    """
    tau = tau_scal * tau_diag
    return 1.0 / tau if invert_tau else tau


def check_domain(proxs: list[Prox], n: int, name: str) -> None:
    """Validate that prox operators tile [0, n) without gaps or overlap.

    Mirrors CheckDomainProx (problem.cu:48-89).
    """
    if not proxs:
        return
    s = sorted(proxs, key=lambda p: p.index)
    for a, b in zip(s[:-1], s[1:]):
        if a.end != b.index - 1:
            raise ProstError(
                f"{name}: prox operators overlap or leave a gap: "
                f"[{a.index}, {a.end}] and [{b.index}, {b.end}]."
            )
    if s[0].index != 0:
        raise ProstError(f"{name}: first prox starts at {s[0].index}, not 0.")
    if s[-1].end != n - 1:
        raise ProstError(
            f"{name}: last prox ends at {s[-1].end}, domain end is {n - 1}."
        )


def apply_proxs(proxs: list[Prox], arg, tau_diag, tau_scal, invert_tau: bool = False):
    """Apply a domain-covering list of proxs to the full flat vector.

    Segments are static slices; results are concatenated in index order.
    With a single whole-range prox this is a no-op wrapper.
    """
    if len(proxs) == 1 and proxs[0].index == 0 and proxs[0].size == arg.shape[0]:
        return proxs[0].eval_local(arg, tau_diag, tau_scal, invert_tau)
    pieces = []
    for p in sorted(proxs, key=lambda q: q.index):
        pieces.append(p.eval(arg, tau_diag, tau_scal, invert_tau))
    return jnp.concatenate(pieces)
