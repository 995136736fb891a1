"""Port command-line entry points: video eval, temporal post-processing,
single-image eval."""
