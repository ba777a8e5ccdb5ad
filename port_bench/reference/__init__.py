"""The plain reference: R3M's networks, its pretraining step and its serving forward in
plain PyTorch, in true float32 (`precision.Arith`), written apart from the system under
test and importing nothing of it."""
