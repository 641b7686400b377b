"""Plain references for the benchmark's correctness checks.

Plain PyTorch and NumPy. Nothing here imports JAX, the JAX package or
the program (``repro_torch``); what the program derives from the inputs
(batches, knobs, wire codes, routing) is worked out again here.
"""
