"""The plain reference: the pose model (each backbone family in
``families/``), the int8 scheme and the decode in plain PyTorch float32
(TF32 off), from the benchmark's own weights. Imports nothing of the
program."""
