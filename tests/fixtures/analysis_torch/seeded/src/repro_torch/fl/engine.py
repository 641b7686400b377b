"""Seeded TORCH004 violation: per-client Python loop in the engine."""


def aggregate_round(clients, deltas):
    total = None
    for client in clients:                # TORCH004: per-client loop
        d = deltas[client]
        total = d if total is None else total + d
    return total
