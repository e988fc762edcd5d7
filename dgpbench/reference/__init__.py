"""The plain reference: the pose model, the int8 scheme and the decode in
plain PyTorch float32 (TF32 off), from the benchmark's own weights. Imports
nothing of the program."""
