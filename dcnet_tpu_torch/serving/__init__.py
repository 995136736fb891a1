"""Streaming serving: the engine (`serving.engine`), its state
(`serving.state`) and the exported bundle with its runtime
(`serving.export`)."""
