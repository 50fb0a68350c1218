"""The general part of the benchmark: the specification, the run of one
cell, weights and inputs from the seed, the trace and the comparisons."""
