"""The paper's six-compartment SIARD model (arXiv:2012.14332, section 2.1),
as plain rows for the benchmark's reference.

X = [S, I, A, R, D, Ru], theta = [alpha0, alpha, n, beta, gamma, delta, eta,
kappa]:

    g = alpha0 + alpha / (1 + max(A + R + D, 0)^n)                  eq. (4)
    h = (g*S*I/P, gamma*I, beta*A, delta*A, beta*eta*I)             eq. (5)

Each product is written in the order the paper's equations give it, which
is also the order of the measured program, so that float32 rounds alike.
"""

import torch

COMPARTMENTS = ("S", "I", "A", "R", "D", "Ru")
OBSERVED = ("A", "R", "D")
COUPLED = ()
STOICHIOMETRY = (
    # S   I   A   R   D  Ru
    (-1, +1, 0, 0, 0, 0),  # S -> I   g*S*I/P
    (0, -1, +1, 0, 0, 0),  # I -> A   gamma*I
    (0, 0, -1, +1, 0, 0),  # A -> R   beta*A
    (0, 0, -1, 0, +1, 0),  # A -> D   delta*A
    (0, -1, 0, 0, 0, +1),  # I -> Ru  beta*eta*I
)


def hazard_rows(sc, pc, population):
    s, i, a, r, d, _ru = sc
    alpha0, alpha, n, beta, gamma, delta, eta, _kappa = pc
    g = alpha0 + alpha / (1.0 + torch.pow(torch.clamp_min(a + r + d, 0.0), n))
    return (g * s * i / population, gamma * i, beta * a, delta * a, beta * eta * i)


def initial_rows(pc, population, a0, r0, d0):
    """Ru = 0, I0 = kappa * A0, S = P - (A0 + R0 + D0 + I0)."""
    kappa = pc[7]
    i0 = kappa * a0
    s0 = population - (a0 + r0 + d0 + i0)
    zeros = torch.zeros_like(kappa)
    return (s0, i0, zeros + a0, zeros + r0, zeros + d0, zeros)
