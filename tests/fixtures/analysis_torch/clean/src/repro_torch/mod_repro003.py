"""Clean REPRO003 patterns: integer arithmetic, float at the edge."""


def wire_bytes(n_params, bits):
    return -(-n_params * bits // 8)       # exact ceil-div


def spend(rounds):
    token_budget = rounds * 3 // 2        # exact integers
    token_budget -= rounds
    return token_budget


def report_mb(nbytes):
    # reporting edge, not an accounting name: floats allowed here
    return nbytes / 1e6
