"""NumPy oracles the port is held to: copies of the JAX package's
``oracle.histeq``, ``oracle.interpolation``, ``oracle.motion``,
``oracle.pyramid`` and ``oracle.raisr``, kept equal
to them by ``tests/test_torch_port_imports.py``."""
