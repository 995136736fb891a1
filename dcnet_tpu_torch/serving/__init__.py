"""The streaming serving engine (`serving.engine`)."""
