"""Scene models of the port: numpy-only copies of the JAX package's
``models.model``, ``models.mjcf`` and ``models.robots``."""
