"""PyTorch + CUDA port of the fault-tolerant optimisation system in
``repro`` (the JAX package, which stays the reference).

The port keeps the JAX package's module names and parameter layout, and
runs on the card by default: entry points take ``device=`` and raise when
CUDA is asked for (the default) but missing.  It imports torch and numpy,
never jax and nothing of ``repro``."""
