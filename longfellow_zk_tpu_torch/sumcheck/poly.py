"""Host-side dense polynomials in Lagrange basis over the standard
evaluation points (reference lib/algebra/poly.h:29-150).

Values are host field scalars (ints for Fp/GF2, tuples for Fp2).  The
verifier and its constraint replay (zk/common.py) interpolate round
polynomials with them; the prover's rounds run the same algebra on the
card (K10, random_oracle/device_fs.round_tail), which the tests hold to
these functions.
"""

from __future__ import annotations

from typing import List


def newton_of_lagrange(F, t: List) -> List:
    """Lagrange values at points 0..N-1 -> Newton forward differences."""
    t = list(t)
    N = len(t)
    for i in range(1, N):
        for k in range(N - 1, i - 1, -1):
            t[k] = F.mul_i(F.sub_i(t[k], t[k - 1]), F.newton_denominator(k, i))
    return t


def eval_newton(F, t: List, x):
    N = len(t)
    e = t[N - 1]
    for i in range(N - 2, -1, -1):
        e = F.add_i(F.mul_i(e, F.sub_i(x, F.poly_evaluation_point(i))), t[i])
    return e


def eval_lagrange(F, t: List, x):
    return eval_newton(F, newton_of_lagrange(F, t), x)


def eval_monomial(F, coefs: List, x):
    """Horner evaluation of sum coefs[i] x^i."""
    e = coefs[-1]
    for i in range(len(coefs) - 2, -1, -1):
        e = F.add_i(F.mul_i(e, x), coefs[i])
    return e


def evals_of_coefs(F, coefs: List) -> List:
    """Evaluate the monomial-basis poly at the standard points."""
    return [eval_monomial(F, coefs, F.poly_evaluation_point(k))
            for k in range(len(coefs))]
