"""Serving subsystem of the port: folded-BN bundles and their forward
(``export``), the bucketed engine (``engine``), and the batchers
(``batcher``, ``pipeline``, copied from the JAX package)."""
