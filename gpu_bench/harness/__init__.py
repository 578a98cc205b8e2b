"""The harness: cells, drivers, counts, traces."""
