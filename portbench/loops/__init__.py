"""The loops that drive the program, one per kind of traffic."""
