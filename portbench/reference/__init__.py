"""The plain reference the benchmark judges the program by: plain float32 nets and SGD steps. Imports neither the program nor JAX."""
