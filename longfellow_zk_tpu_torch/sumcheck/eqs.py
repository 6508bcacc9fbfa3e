"""Equality-predicate (EQ) arrays on the host.

Twin of reference lib/arrays/eqs.h and eq.h: EQ[Q, i] =
prod_l (i_l Q_l + (1-i_l)(1-Q_l)), materialized to arbitrary length n
(non-power-of-2 fine; indices >= n are simply absent, and the binding
convention treats them as zero — the verifier compensates with the
closed-form Eq::eval, eq.h:53-71).

The prover's tensor EQ arrays are built in sumcheck/prover.py (_eq_dev).
"""

from __future__ import annotations

from typing import List



def eq_array_host(F, logn: int, n: int, q: List) -> List:
    """Host EQ array (for the verifier's quad binding)."""
    eq = [_one(F)]
    sizes = [n]
    for l in range(logn):
        sizes.append((sizes[-1] + 1) // 2)
    for l in range(logn - 1, -1, -1):
        nl = sizes[l]
        new = [None] * nl
        for i, v in enumerate(eq):
            qv = F.mul_i(q[l], v)
            if 2 * i < nl:
                new[2 * i] = F.sub_i(v, qv)
            if 2 * i + 1 < nl:
                new[2 * i + 1] = qv
        eq = new
    return eq


def raw_eq2_host(F, logn: int, n: int, g0: List, g1: List, alpha) -> List:
    e0 = eq_array_host(F, logn, n, g0)
    e1 = eq_array_host(F, logn, n, g1)
    return [F.add_i(a, F.mul_i(alpha, b)) for a, b in zip(e0, e1)]


def eq_eval_host(F, logn: int, n: int, I: List, J: List):
    """Closed-form bound EQ scalar with truncation (eq.h:53-71)."""
    one = _one(F)
    a = one
    b = one
    for rnd in range(logn):
        i1, j1 = I[rnd], J[rnd]
        i0 = F.sub_i(one, i1)
        j0 = F.sub_i(one, j1)
        i0j0 = F.mul_i(i0, j0)
        i1j1 = F.mul_i(i1, j1)
        if n % 2 == 0:
            b = F.add_i(F.mul_i(b, i1j1), F.mul_i(a, i0j0))
        else:
            b = F.mul_i(b, i0j0)
        a = F.mul_i(a, F.add_i(i0j0, i1j1))
        n = (n + 1) // 2
    return b


def _one(F):
    return F.of_scalar(1)
