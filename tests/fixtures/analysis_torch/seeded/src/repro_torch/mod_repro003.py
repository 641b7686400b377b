"""Seeded REPRO003 violations: float arithmetic in exact accounting."""


def wire_bytes(n_params, bits):
    return n_params * bits / 8.0          # REPRO003: true division


def spend(rounds):
    token_budget = rounds * 0.5           # REPRO003: float constant
    token_budget += float(rounds)         # REPRO003: float() cast
    return token_budget
