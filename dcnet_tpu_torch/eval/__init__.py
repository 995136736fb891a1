"""Port evaluation helpers."""
