"""Wire format: serialize/deserialize problem specifications.

The reference's language bridge passes problems as positional cell arrays
(prox = {name, idx, size, diagsteps, data}, block = {name, row, col, data})
decoded by a string->constructor registry (factory.cpp:18-134).  This
module is that bridge's counterpart: a JSON-able dict format
using the SAME registry names, so problem descriptions can cross process
and language boundaries (or be stored alongside checkpoints) without
pickling Python objects.

    spec = to_spec(problem)            # JSON-able dict
    problem = from_spec(spec)          # rebuild (validates via the registry)
    save_spec(path, spec) / load_spec(path)

Custom operators register with ``register_prox`` / ``register_block``
(the analog of the reference's custom registries, factory.cpp:1014-1035
and custom.cpp).
"""

from __future__ import annotations

import json

import numpy as np

from ..config import ProstError
from ..linop import (
    BlockConv2D,
    BlockDense,
    BlockDiags,
    BlockGradient2D,
    BlockGradient3D,
    BlockIdKron,
    BlockKronId,
    BlockSparse,
    BlockZero,
    LinearOperator,
)
from ..problem import Problem
from ..prox import (
    ProxElem1D,
    ProxElemEigen2x2,
    ProxElemEigenNxN,
    ProxElemIndSimplex,
    ProxElemIndSum,
    ProxElemMassNorm,
    ProxElemNorm2,
    ProxElemSingularNx2,
    ProxIndEpiPolyhedral,
    ProxIndEpiQuad,
    ProxIndHalfspace,
    ProxIndRange,
    ProxIndSOC,
    ProxIndSum,
    ProxMoreau,
    ProxPermute,
    ProxTransform,
    ProxZero,
)

# ---------------------------------------------------------------------------
# array <-> JSON
# ---------------------------------------------------------------------------

def _enc(v):
    """Encode scalars inline and arrays as {"__array__": ..., dtype, shape}."""
    if v is None:
        return None
    a = np.asarray(v)
    if a.ndim == 0:
        return a.item()
    return {"__array__": a.ravel().tolist(), "dtype": str(a.dtype),
            "shape": list(a.shape)}


def _dec(v):
    if isinstance(v, dict) and "__array__" in v:
        return np.asarray(v["__array__"], dtype=v["dtype"]).reshape(v["shape"])
    return v


def _enc_coeffs(coeffs):
    return [_enc(c) for c in coeffs]


def _dec_coeffs(coeffs):
    return tuple(_dec(c) for c in coeffs)


# ---------------------------------------------------------------------------
# prox registry: name -> (to_data, from_data); names match factory.cpp:18-116
# ---------------------------------------------------------------------------

_PROX_REGISTRY: dict = {}
_BLOCK_REGISTRY: dict = {}


def register_prox(name, cls, to_data, from_data):
    """Register a prox kind: ``to_data(prox) -> dict`` (JSON-able),
    ``from_data(idx, size, data) -> prox``."""
    _PROX_REGISTRY[name] = (cls, to_data, from_data)


def register_block(name, cls, to_data, from_data):
    """Register a block kind: ``to_data(block) -> dict``,
    ``from_data(row, col, data) -> block``."""
    _BLOCK_REGISTRY[name] = (cls, to_data, from_data)


def _prox_name(p) -> str:
    for name, (cls, _, _) in _PROX_REGISTRY.items():
        if type(p) is cls:
            if cls is ProxElem1D:
                return f"elem_operation:1d:{p.fun}"
            if cls is ProxElemNorm2:
                return f"elem_operation:norm2:{p.fun}"
            if cls is ProxElemEigen2x2:
                return f"elem_operation:eigen_2x2:{p.fun}"
            if cls is ProxElemEigenNxN:
                return f"elem_operation:eigen_nxn:{p.fun}"
            if cls is ProxElemSingularNx2:
                return f"elem_operation:singular_nx2:{p.fun}"
            if cls is ProxElemMassNorm:
                kind = "ind_comass" if p.conjugate else "mass"
                return (f"elem_operation:{kind}{p.n}_ball" if p.conjugate
                        else f"elem_operation:mass{p.n}")
            return name
    raise ProstError(f"wire: unregistered prox type {type(p).__name__}")


def to_prox_spec(p) -> dict:
    name = _prox_name(p)
    base = name.split(":")[0] if name.startswith("elem_operation") else name
    key = _lookup_prox_key(name)
    _, to_data, _ = _PROX_REGISTRY[key]
    return {
        "name": name,
        "idx": int(p.index),
        "size": int(p.size),
        "diagsteps": bool(p.diagsteps),
        "data": to_data(p),
    }


def _lookup_prox_key(name: str):
    if name in _PROX_REGISTRY:
        return name
    # family names: elem_operation:1d:<fun> etc. -> registered by family
    parts = name.split(":")
    for k in (":".join(parts[:2]), parts[0]):
        if k in _PROX_REGISTRY:
            return k
    raise ProstError(f"wire: unknown prox kind '{name}'")


def from_prox_spec(spec: dict):
    name = spec["name"]
    key = _lookup_prox_key(name)
    _, _, from_data = _PROX_REGISTRY[key]
    return from_data(spec["idx"], spec["size"], spec["data"], name)


def to_block_spec(b) -> dict:
    for name, (cls, to_data, _) in _BLOCK_REGISTRY.items():
        if type(b) is cls:
            return {"name": name, "row": int(b.row), "col": int(b.col),
                    "data": to_data(b)}
    raise ProstError(f"wire: unregistered block type {type(b).__name__}")


def from_block_spec(spec: dict):
    name = spec["name"]
    if name not in _BLOCK_REGISTRY:
        raise ProstError(f"wire: unknown block kind '{name}'")
    _, _, from_data = _BLOCK_REGISTRY[name]
    return from_data(spec["row"], spec["col"], spec["data"])


# ---------------------------------------------------------------------------
# problem <-> spec
# ---------------------------------------------------------------------------

def to_spec(problem: Problem) -> dict:
    """Serialize a Problem to a JSON-able dict (scaling is re-derived on
    load for alpha/identity; custom scaling is stored)."""
    return {
        "nrows": problem.nrows,
        "ncols": problem.ncols,
        "linop": [to_block_spec(b) for b in problem.linop.blocks],
        "prox_g": [to_prox_spec(p) for p in problem.prox_g],
        "prox_f": [to_prox_spec(p) for p in problem.prox_f],
        "prox_gstar": [to_prox_spec(p) for p in problem.prox_gstar],
        "prox_fstar": [to_prox_spec(p) for p in problem.prox_fstar],
        "scaling_left": _enc(np.asarray(problem.scaling_left)),
        "scaling_right": _enc(np.asarray(problem.scaling_right)),
    }


def from_spec(spec: dict) -> Problem:
    """Rebuild a Problem from a spec produced by :func:`to_spec`."""
    linop = LinearOperator.create(
        [from_block_spec(b) for b in spec["linop"]]
    )
    kw = {}
    for side in ("prox_g", "prox_f", "prox_gstar", "prox_fstar"):
        kw[side] = [from_prox_spec(p) for p in spec.get(side, [])]
    sl = np.sqrt(np.asarray(_dec(spec["scaling_left"]), np.float64))
    sr = np.sqrt(np.asarray(_dec(spec["scaling_right"]), np.float64))
    return Problem.create(
        linop, nrows=spec["nrows"], ncols=spec["ncols"],
        scaling="custom", scaling_left=sl, scaling_right=sr, **kw,
    )


def save_spec(path: str, spec: dict) -> None:
    with open(path, "w") as fh:
        json.dump(spec, fh)


def load_spec(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# default registry entries
# ---------------------------------------------------------------------------

def _coeff_prox(cls, extra=()):
    def to_data(p):
        d = {"coeffs": _enc_coeffs(p.coeffs)}
        for fld in extra:
            d[fld] = getattr(p, fld)
        return d
    return to_data


def _seps(p):
    return {"count": p.count, "dim": p.dim, "interleaved": p.interleaved}


register_prox(
    "zero", ProxZero,
    lambda p: {},
    lambda idx, size, data, name: ProxZero(index=idx, size=size),
)
register_prox(
    "elem_operation:1d", ProxElem1D,
    lambda p: {"coeffs": _enc_coeffs(p.coeffs)},
    lambda idx, size, data, name: ProxElem1D(
        index=idx, size=size, fun=name.split(":")[2],
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    "elem_operation:norm2", ProxElemNorm2,
    lambda p: {**_seps(p), "coeffs": _enc_coeffs(p.coeffs)},
    lambda idx, size, data, name: ProxElemNorm2(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        interleaved=data["interleaved"], fun=name.split(":")[2],
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    "elem_operation:ind_simplex", ProxElemIndSimplex,
    _seps,
    lambda idx, size, data, name: ProxElemIndSimplex(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        interleaved=data["interleaved"]),
)
register_prox(
    "elem_operation:ind_sum", ProxElemIndSum,
    _seps,
    lambda idx, size, data, name: ProxElemIndSum(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        interleaved=data["interleaved"]),
)
register_prox(
    "elem_operation:eigen_2x2", ProxElemEigen2x2,
    lambda p: {"count": p.count, "interleaved": p.interleaved,
               "coeffs": _enc_coeffs(p.coeffs)},
    lambda idx, size, data, name: ProxElemEigen2x2(
        index=idx, size=size, count=data["count"],
        interleaved=data["interleaved"], fun=name.split(":")[2],
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    "elem_operation:eigen_nxn", ProxElemEigenNxN,
    lambda p: {"count": p.count, "n": p.n, "interleaved": p.interleaved,
               "coeffs": _enc_coeffs(p.coeffs)},
    lambda idx, size, data, name: ProxElemEigenNxN(
        index=idx, size=size, count=data["count"], n=data["n"],
        interleaved=data["interleaved"], fun=name.split(":")[2],
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    "elem_operation:singular_nx2", ProxElemSingularNx2,
    lambda p: {**_seps(p), "coeffs": _enc_coeffs(p.coeffs)},
    lambda idx, size, data, name: ProxElemSingularNx2(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        interleaved=data["interleaved"], fun=":".join(name.split(":")[2:]),
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    # reference alias: eigen_3x3 is the NxN spectral prox at n = 3
    # (factory.cpp registers elem_operation:eigen_3x3:<fun> separately;
    # here batched eigh covers all n — COVERAGE.md section 2.3)
    "elem_operation:eigen_3x3", ProxElemEigenNxN,
    lambda p: {"count": p.count, "n": p.n, "interleaved": p.interleaved,
               "coeffs": _enc_coeffs(p.coeffs)},
    lambda idx, size, data, name: ProxElemEigenNxN(
        index=idx, size=size, count=data["count"], n=3,
        interleaved=data["interleaved"], fun=name.split(":")[2],
        coeffs=_dec_coeffs(data["coeffs"])),
)
register_prox(
    "elem_operation", ProxElemMassNorm,  # mass4/5, ind_comass{4,5}_ball
    lambda p: {"count": p.count, "n": p.n, "interleaved": p.interleaved,
               "conjugate": p.conjugate, "cost": p.cost},
    # n / conjugate are inferable from the reference kind name
    # (elem_operation:mass4, elem_operation:ind_comass5_ball, ...)
    lambda idx, size, data, name: ProxElemMassNorm(
        index=idx, size=size, count=data["count"],
        n=data.get("n", 5 if "5" in name else 4),
        interleaved=data.get("interleaved", False),
        conjugate=data.get("conjugate", "comass" in name),
        cost=data.get("cost", 1.0)),
)
register_prox(
    "ind_soc", ProxIndSOC,
    lambda p: {"count": p.count, "dim": p.dim, "alpha": p.alpha},
    lambda idx, size, data, name: ProxIndSOC(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        alpha=data["alpha"]),
)
register_prox(
    "ind_halfspace", ProxIndHalfspace,
    lambda p: {"count": p.count, "dim": p.dim,
               "a": _enc(np.asarray(p.a)), "b": _enc(np.asarray(p.b))},
    lambda idx, size, data, name: ProxIndHalfspace(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        a=_wire_arr(data["a"]), b=_wire_arr(data["b"])),
)
register_prox(
    "ind_epi_quad", ProxIndEpiQuad,
    lambda p: {"count": p.count, "dim": p.dim,
               "a": _enc(np.asarray(p.a)), "b": _enc(np.asarray(p.b)),
               "c": _enc(np.asarray(p.c))},
    lambda idx, size, data, name: ProxIndEpiQuad(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        a=_wire_arr(data["a"]), b=_wire_arr(data["b"]),
        c=_wire_arr(data["c"])),
)
register_prox(
    "ind_epi_polyhedral", ProxIndEpiPolyhedral,
    lambda p: {"count": p.count, "dim": p.dim, "sweeps": p.sweeps,
               "tol": p.tol, "omega": p.omega,
               "a": _enc(np.asarray(p.a)), "b": _enc(np.asarray(p.b)),
               "mask": _enc(np.asarray(p.mask))},
    lambda idx, size, data, name: ProxIndEpiPolyhedral.create(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        a=_wire_arr(data["a"]).reshape(-1, data["dim"] - 1, data["count"]),
        b=_wire_arr(data["b"]).reshape(-1, data["count"]),
        mask=_wire_arr(data["mask"]).reshape(-1, data["count"]),
        sweeps=data["sweeps"], tol=data.get("tol", 5e-7),
        omega=data.get("omega", 1.7)),
)
register_prox(
    "ind_sum", ProxIndSum,
    lambda p: {
        "count": p.count, "dim": p.dim, "sum_target": p.sum_target,
        "count2": p.count2, "dim2": p.dim2, "sum_target2": p.sum_target2,
        "inds": _enc(np.asarray(p.inds)),
        "inds2": None if p.inds2 is None else _enc(np.asarray(p.inds2)),
    },
    lambda idx, size, data, name: ProxIndSum(
        index=idx, size=size, count=data["count"], dim=data["dim"],
        sum_target=data["sum_target"], count2=data["count2"],
        dim2=data["dim2"], sum_target2=data["sum_target2"],
        inds=_wire_arr(data["inds"], np.int32),
        inds2=(None if data["inds2"] is None
               else _wire_arr(data["inds2"], np.int32))),
)
def _ind_range_to(p):
    from jax.experimental import sparse as jsparse

    if isinstance(p.A, jsparse.BCOO):
        return {"A_sparse": {"data": _enc(np.asarray(p.A.data)),
                             "indices": _enc(np.asarray(p.A.indices)),
                             "shape": list(p.A.shape)}}
    return {"A": _enc(np.asarray(p.A))}


def _ind_range_from(idx, size, data, name):
    if "A_sparse" in data:
        import scipy.sparse as ssp

        sp = data["A_sparse"]
        ind = np.asarray(_dec(sp["indices"]))
        A = ssp.coo_matrix(
            (np.asarray(_dec(sp["data"])), (ind[:, 0], ind[:, 1])),
            shape=tuple(sp["shape"]))
        return ProxIndRange.create(idx, size, A)
    return ProxIndRange.create(idx, size, np.asarray(_dec(data["A"])))


register_prox(
    "ind_range", ProxIndRange,
    _ind_range_to,
    _ind_range_from,
)
register_prox(
    "moreau", ProxMoreau,
    lambda p: {"child": to_prox_spec(p.child)},
    lambda idx, size, data, name: ProxMoreau(
        index=idx, size=size, child=from_prox_spec(data["child"])),
)
register_prox(
    "transform", ProxTransform,
    lambda p: {"child": to_prox_spec(p.child),
               **{k: _enc(np.asarray(getattr(p, k)))
                  for k in ("a", "b", "c", "d", "e")}},
    lambda idx, size, data, name: ProxTransform(
        index=idx, size=size, child=from_prox_spec(data["child"]),
        a=_dec(data["a"]), b=_dec(data["b"]), c=_dec(data["c"]),
        d=_dec(data["d"]), e=_dec(data["e"])),
)
register_prox(
    "permute", ProxPermute,
    lambda p: {"child": to_prox_spec(p.child),
               "perm": _enc(np.asarray(p.perm))},
    lambda idx, size, data, name: ProxPermute(
        index=idx, size=size, child=from_prox_spec(data["child"]),
        perm=_wire_arr(data["perm"], np.int32)),
)


def _wire_arr(v, dtype=None):
    import jax.numpy as jnp

    from ..config import dtype as cfg_dtype

    a = np.asarray(_dec(v))
    return jnp.asarray(a, dtype or cfg_dtype())


# blocks ---------------------------------------------------------------------

register_block(
    "sparse", BlockSparse,
    lambda b: {
        "nrows": b.nrows, "ncols": b.ncols,
        "rows": _enc(np.asarray(b.rows_f)), "cols": _enc(np.asarray(b.cols_f)),
        "vals": _enc(np.asarray(b.vals_f)),
    },
    lambda row, col, data: BlockSparse.create(
        row, col, data["nrows"], data["ncols"],
        (np.asarray(_dec(data["rows"])), np.asarray(_dec(data["cols"])),
         np.asarray(_dec(data["vals"])))),
)
register_block(
    "dense", BlockDense,
    lambda b: {"data": _enc(np.asarray(b.data))},
    lambda row, col, data: BlockDense.create(
        row, col, np.asarray(_dec(data["data"]))),
)
register_block(
    "diags", BlockDiags,
    lambda b: {"nrows": b.nrows, "ncols": b.ncols,
               "factors": _enc(np.asarray(b.factors)),
               "offsets": list(b.offsets)},
    lambda row, col, data: BlockDiags.create(
        row, col, data["nrows"], data["ncols"],
        np.asarray(_dec(data["factors"])), data["offsets"]),
)
register_block(
    "gradient2d", BlockGradient2D,
    lambda b: {"nx": b.nx, "ny": b.ny, "L": b.L,
               "label_first": b.label_first},
    lambda row, col, data: BlockGradient2D(
        row=row, col=col, nx=data["nx"], ny=data["ny"], L=data["L"],
        label_first=data["label_first"]),
)
register_block(
    "gradient3d", BlockGradient3D,
    lambda b: {"nx": b.nx, "ny": b.ny, "L": b.L,
               "label_first": b.label_first},
    lambda row, col, data: BlockGradient3D(
        row=row, col=col, nx=data["nx"], ny=data["ny"], L=data["L"],
        label_first=data["label_first"]),
)
register_block(
    "sparse_kron_id", BlockKronId,
    lambda b: {"diaglength": b.diaglength, "data": _enc(np.asarray(b.data))},
    lambda row, col, data: BlockKronId.create(
        row, col, data["diaglength"], np.asarray(_dec(data["data"]))),
)
register_block(
    "id_kron_sparse", BlockIdKron,
    lambda b: {"ncopies": b.ncopies, "data": _enc(np.asarray(b.data))},
    lambda row, col, data: BlockIdKron.create(
        row, col, data["ncopies"], np.asarray(_dec(data["data"]))),
)
register_block(
    "conv2d", BlockConv2D,
    lambda b: {"nx": b.nx, "ny": b.ny, "L": b.L,
               "kernel": _enc(np.asarray(b.kernel).T)},
    lambda row, col, data: BlockConv2D.create(
        row, col, data["nx"], data["ny"], data["L"],
        np.asarray(_dec(data["kernel"]))),
)
# Reference-compat aliases (factory.cpp:118-129): the reference
# distinguishes sparse/dense kron blocks and ships identity as its own
# kind; here one class serves each kron orientation and identity is a
# single unit diagonal, so these names only need a from_data entry.
# to_block_spec resolves by class FIRST match, so aliases register after
# the canonical names.
register_block(
    "dense_kron_id", BlockKronId,
    lambda b: {"diaglength": b.diaglength, "data": _enc(np.asarray(b.data))},
    lambda row, col, data: BlockKronId.create(
        row, col, data["diaglength"], np.asarray(_dec(data["data"]))),
)
register_block(
    "id_kron_dense", BlockIdKron,
    lambda b: {"ncopies": b.ncopies, "data": _enc(np.asarray(b.data))},
    lambda row, col, data: BlockIdKron.create(
        row, col, data["ncopies"], np.asarray(_dec(data["data"]))),
)
register_block(
    "identity", BlockDiags,
    lambda b: {"nrows": b.nrows, "ncols": b.ncols,
               "factors": _enc(np.asarray(b.factors)),
               "offsets": list(b.offsets)},
    lambda row, col, data: BlockDiags.create(
        row, col, data.get("nrows", data.get("n")),
        data.get("ncols", data.get("n")),
        np.asarray(_dec(data.get("factors", [data.get("factor", 1.0)]))),
        data.get("offsets", [0])),
)
register_block(
    "zero", BlockZero,
    lambda b: {"nrows": b.nrows, "ncols": b.ncols},
    lambda row, col, data: BlockZero(
        row=row, col=col, nrows=data["nrows"], ncols=data["ncols"]),
)
