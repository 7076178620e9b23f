"""Scene models of the port: numpy-only copies of the JAX package's
``models.model``, ``models.mjcf``, ``models.urdf``, ``models.robots``,
``models.franka`` and ``models.specs.franka_panda``, ``humanoid`` and
``anymal``."""
