"""Every prox kind name of the reference's factory registry naming scheme
(factory.cpp:18-116, SURVEY.md section 2.5: the cross product of the
element-wise operations with the 1D functions, plus the standalone kinds)
must construct through the wire layer, evaluate, and round-trip.  This is
the line-by-line parity check for SURVEY.md section 2.5.

The names are written out here, one family per line, from the families
``modeling/wire.py`` registers (COVERAGE.md section 2.5).  The reference's
own registry counts 97 kinds; which of the families below it leaves out
cannot be read from this repository, so no count is asserted.
"""

import numpy as np
import pytest

from prost_tpu.modeling import wire

COEFFS = [1.0, 0.0, 1.0, 0.0, 0.0, 0.5, 0.5]  # (a,b,c,d,e,alpha,beta)

FUN_1D = ["zero", "abs", "square", "ind_leq0", "ind_geq0", "ind_eq0",
          "ind_box01", "max_pos0", "l0", "huber", "lq", "lq_plus_eps",
          "truncquad", "trunclin"]
FUN_2D = [f"sum_1d:{f}" for f in FUN_1D] + ["ind_l1_ball",
                                           "moreau:ind_l1_ball"]

REFERENCE_PROX_KINDS = (
    [f"elem_operation:1d:{f}" for f in FUN_1D]
    + [f"elem_operation:norm2:{f}" for f in FUN_1D]
    + [f"elem_operation:eigen_2x2:{f}" for f in FUN_1D]
    + [f"elem_operation:eigen_3x3:{f}" for f in FUN_1D]
    + [f"elem_operation:eigen_nxn:{f}" for f in FUN_1D]
    + [f"elem_operation:singular_nx2:{f}" for f in FUN_2D]
    + ["elem_operation:ind_simplex", "elem_operation:ind_sum",
       "elem_operation:mass4", "elem_operation:mass5",
       "elem_operation:ind_comass4_ball", "elem_operation:ind_comass5_ball"]
    + ["ind_epi_quad", "ind_halfspace", "ind_range", "ind_soc", "ind_sum",
       "moreau", "permute", "transform", "zero"]
)


def _spec_for(name):
    """A plausible wire spec for each reference kind family."""
    if name == "zero":
        return {"idx": 0, "size": 8, "data": {}}
    if name in ("moreau", "permute", "transform"):
        return None  # combinators: exercised below with an inner prox
    if name == "ind_range":
        # synthesize a well-conditioned tall basis (size x 3)
        A = np.linalg.qr(np.random.RandomState(3).randn(8, 3))[0]
        return {"idx": 0, "size": 8, "data": {"A": wire._enc(A)}}
    if name == "ind_soc":
        return {"idx": 0, "size": 9,
                "data": {"count": 3, "dim": 3, "alpha": 1.0}}
    if name == "ind_halfspace":
        return {"idx": 0, "size": 8,
                "data": {"count": 2, "dim": 4,
                         "a": [1.0, 0.0, 0.0, 1.0], "b": [1.0]}}
    if name == "ind_epi_quad":
        return {"idx": 0, "size": 9,
                "data": {"count": 3, "dim": 3, "a": [1.0],
                         "b": [0.0, 0.0], "c": [0.0]}}
    if name == "ind_sum":
        return {"idx": 0, "size": 8,
                "data": {"count": 2, "dim": 3, "sum_target": 1.0,
                         "count2": 0, "dim2": 0, "sum_target2": 1.0,
                         "inds": [0, 1, 2, 4, 5, 6], "inds2": None}}
    parts = name.split(":")
    if parts[1] == "1d":
        return {"idx": 0, "size": 8, "data": {"coeffs": COEFFS}}
    if parts[1] == "norm2":
        return {"idx": 0, "size": 8,
                "data": {"count": 4, "dim": 2, "interleaved": False,
                         "coeffs": COEFFS}}
    if parts[1] == "ind_simplex":
        return {"idx": 0, "size": 8,
                "data": {"count": 2, "dim": 4, "interleaved": False}}
    if parts[1] == "ind_sum":
        return {"idx": 0, "size": 8,
                "data": {"count": 2, "dim": 4, "interleaved": False}}
    if parts[1] == "eigen_2x2":  # dim = 4 (full symmetric 2x2, row-major)
        return {"idx": 0, "size": 8,
                "data": {"count": 2, "interleaved": False,
                         "coeffs": COEFFS}}
    if parts[1] == "eigen_3x3":  # dim = 9
        return {"idx": 0, "size": 18,
                "data": {"count": 2, "interleaved": False,
                         "coeffs": COEFFS}}
    if parts[1] == "eigen_nxn":  # dim = n*n
        return {"idx": 0, "size": 32,
                "data": {"count": 2, "n": 4, "interleaved": False,
                         "coeffs": COEFFS}}
    if parts[1] == "singular_nx2":
        return {"idx": 0, "size": 12,
                "data": {"count": 2, "dim": 6, "interleaved": False,
                         "coeffs": COEFFS}}
    if parts[1] in ("mass4", "ind_comass4_ball"):
        return {"idx": 0, "size": 12, "data": {"count": 2}}
    if parts[1] in ("mass5", "ind_comass5_ball"):
        return {"idx": 0, "size": 20, "data": {"count": 2}}
    raise AssertionError(f"no spec template for {name}")


@pytest.mark.parametrize("name", REFERENCE_PROX_KINDS)
def test_reference_prox_kind_constructs_and_evaluates(name):
    import jax.numpy as jnp

    tmpl = _spec_for(name)
    if tmpl is None:
        if name in ("moreau", "permute", "transform"):
            # combinator kinds wrap an inner spec
            inner = {"name": "elem_operation:1d:square", "idx": 0,
                     "size": 8, "data": {"coeffs": COEFFS}}
            if name == "moreau":
                spec = {"name": name, "idx": 0, "size": 8,
                        "data": {"child": inner}}
            elif name == "transform":
                spec = {"name": name, "idx": 0, "size": 8,
                        "data": {"child": inner, "a": [2.0], "b": [0.0],
                                 "c": [1.0], "d": [0.0], "e": [0.0]}}
            else:
                spec = {"name": name, "idx": 0, "size": 8,
                        "data": {"child": inner,
                                 "perm": list(range(7, -1, -1))}}
            p = wire.from_prox_spec(spec)
        else:
            raise AssertionError(f"no spec template for {name}")
    else:
        spec = {"name": name, **tmpl}
        p = wire.from_prox_spec(spec)

    size = spec["size"]
    arg = jnp.asarray(np.random.RandomState(0).randn(size),
                      dtype=jnp.float32)
    tau_diag = jnp.ones(size, jnp.float32)
    out = p.eval(arg, tau_diag, 0.7, False)
    assert out.shape == (size,)
    assert bool(jnp.all(jnp.isfinite(out)))

    # and the spec round-trips through to_prox_spec (possibly under an
    # equivalent family name, e.g. eigen_3x3 -> eigen_nxn)
    back = wire.to_prox_spec(p)
    p2 = wire.from_prox_spec(back)
    out2 = p2.eval(arg, tau_diag, 0.7, False)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out2), atol=1e-6)
