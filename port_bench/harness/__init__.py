"""The benchmark's own code: the manifest, inputs, weights, the plain
reference, the judge of ``correct``, the tracer and the roofline arithmetic.
Nothing here imports the JAX package; only ``entries/`` and the metric
readers touch the program under test."""
