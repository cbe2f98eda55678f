"""The benchmark harness: cell specs found by name, seeded inputs, one run
of a cell, trace reduction and the correctness check."""
