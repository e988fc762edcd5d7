"""The benchmark's frozen yardstick: peaks, bounds, kernel classes and the
operations of each configuration's published architecture. Imports no part
of the program."""
