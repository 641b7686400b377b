"""PyTorch / CUDA port of the CAFL-L reproduction (``repro``).

Module paths mirror ``repro`` one to one; the port imports neither
``jax`` nor ``repro``."""
