"""The reference's ``examples/`` scripts on the port, one module each:
``python -m repro_torch.examples.<name>`` runs on the card, ``--device
cpu`` on the CPU; ``main(argv)`` runs it in-process.
``REPRO_EXAMPLE_ROUNDS`` trims the round (or step) budget where the
reference's script reads it."""
