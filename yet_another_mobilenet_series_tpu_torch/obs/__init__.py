"""Runtime telemetry of the port: the metrics registry and span tracer
(copies of the JAX package's), and the torch twin of its device layer."""
