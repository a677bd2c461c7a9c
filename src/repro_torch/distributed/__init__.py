"""Distributed helpers of the port: gradient compression, the tile and LM
meshes (`sharding`) and tensors laid out on an LM mesh (`placement`)."""
