"""The benchmark's plain reference: plain PyTorch, fp32, every kernel in its
plain form. It imports neither JAX nor anything of the program, and takes
nothing the program made: the harness hands it the same seeded weights and
inputs it hands the program (see ../README.md)."""
