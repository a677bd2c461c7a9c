"""Checkpoints of the port: the msgpack manifest codec and the atomic,
keep-k, verified checkpoint manager."""
