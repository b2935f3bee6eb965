"""Input makers: a deployment's initial state made from the run's seed, on
the device, by the benchmark (so the reference can rebuild it)."""
