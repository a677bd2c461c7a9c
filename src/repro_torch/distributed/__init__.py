"""Distributed helpers of the port: gradient compression, the tile and LM
meshes (`sharding`), tensors laid out on an LM mesh (`placement`) and
GPipe pipeline parallelism over an LM mesh axis (`pipeline`)."""
