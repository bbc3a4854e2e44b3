"""The phase bodies of chip_smoke.py, the port's smoke run on one GPU: one
module for each group of phases. They import no JAX and nothing of the
JAX package; chip_smoke.py keeps main(), the phase order and names, and
the kernels and result lines."""
