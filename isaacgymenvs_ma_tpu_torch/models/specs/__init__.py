"""Robot specs of the port: numpy-only copies of the JAX package's
``models/specs`` modules (so far ``franka_panda``, ``humanoid``, ``anymal``,
``trifinger`` and ``kuka_allegro``)."""
