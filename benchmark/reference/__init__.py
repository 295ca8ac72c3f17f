"""The plain reference the benchmark holds the port to.

A frozen copy of the port's model, loss and training-step modules
(``next3d_tpu_torch/{nn,ops,render,models,train}``) as of the benchmark's
first commit, with every hand-written kernel replaced by the port's own
plain torch version (``ops/raster.py``: K1 and K2; ``ops/triplane.py``:
K4 as ``F.grid_sample``), the rasterizer selection cut to the binned path
the configurations select, and the random leaves drawn by ``init.py``.
It imports nothing of the port, JAX or the JAX package, and runs float32
with TF32 off unless a control asks for TF32. The module docstrings below
are the port's, kept with the code they describe; later changes to the
port do not reach this copy.
"""
