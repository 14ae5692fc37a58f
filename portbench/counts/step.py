"""Floating-point operations of one physics step of one rollout, as the step
body computes it with a dense constraint Jacobian J of (nefc x nv): the
count of ``chip_smoke.py:step_flops``, frozen.

Per step: every pass over the dense J (assembly, about 20 operations per
element; the masking, b, the Jacobi scaling: 7; two passes per operator
apply: 4 per apply), the island inverses of M and M + hD (4 k^3 each) and
the island mat-vecs of every apply (2 k^2 per apply and 3 more), and APGD's
vector updates (12 per row and iteration). Applies per step: the
iterations, one for the final J^T f, and 3 more for a cold start. A sparse
J, or a step that skips rows, does less work than this counts: the count
is of the dense-J design the port has, and stays fixed so that a redesign
shows as a shorter time against the same operations.
"""


def step_flops(nefc: int, nv: int, islands: list, iterations: int, cold: bool = False) -> float:
    applies = iterations + 1 + (3 if cold else 0)
    return (nefc * nv * (4 * applies + 27) + sum(4 * k**3 + 2 * k * k * (applies + 3) for k in islands)
            + 12 * nefc * iterations)
