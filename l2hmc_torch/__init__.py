"""PyTorch port of the JAX package: trainable generalized-leapfrog HMC samplers for
2D U(1) lattice gauge theory, with the U(1) force kernel written in CUDA for
the H100. See README.md ("PyTorch port").
"""
