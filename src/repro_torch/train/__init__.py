"""SimGNN training of the port: the optimizer, the swappable gradient
functions and the engine-routed train step."""
