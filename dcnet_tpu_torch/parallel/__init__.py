"""Data parallelism over processes (`parallel.mesh`)."""
