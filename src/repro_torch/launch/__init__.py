"""Entry points of the port: ``train`` (the paper's experiment)."""
