"""The benchmark's harness: loading by name, generation, weights,
the device trace, operation counts and the run itself."""
