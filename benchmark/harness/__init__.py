"""The benchmark's general code: cells found by name, traffic, the measured
window, the trace's reduction and the guard against the JAX package."""
