"""The plain reference of the benchmark: SPEEDY's spectral dynamics, column
physics and slab coupling in plain PyTorch, eagerly, step by step, with no
compiled kernel and no captured graph.

It is a frozen copy of the modules of ``speedy_tpu_torch`` that one model
day is made of, taken at commit 8f72ba0 (``models/physics/fused.py``
reduced to the plain chain, ``ops/spectral.py`` without the latitude-band
all-reduce, ``models/model.py`` without the run drivers), kept here so that
later changes to the program cannot move the yardstick. It imports nothing
of the program, nor JAX, and builds every table from the configuration and
the boundary arrays it is given.
"""
