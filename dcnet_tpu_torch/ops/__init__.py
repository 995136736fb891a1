"""Port ops: coordinates, einsum co-attention, boxes, decoding."""
