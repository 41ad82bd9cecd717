"""The harness: the run of a cell, tracing, weights and inputs."""
