"""Port models: backbone, heads, language encoder, the eval DCNet."""
