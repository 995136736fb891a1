"""The work of the model counted from its shapes, and the chip's peaks."""
