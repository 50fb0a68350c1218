"""The plain reference: the two architectures' equations in plain PyTorch,
float32 with TF32 off, blocked so that they fit beside nothing else on one
card. It imports nothing of the program and takes nothing the program made:
it is given the benchmark's weights (drawn again from the seed) and inputs,
and reads the program's outputs only to judge them."""
