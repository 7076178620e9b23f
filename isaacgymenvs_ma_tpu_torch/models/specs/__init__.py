"""Robot specs of the port: numpy-only copies of the JAX package's
``models/specs`` modules (so far ``franka_panda``, ``humanoid``, ``anymal``,
``trifinger``, ``kuka_allegro``, ``shadow_hand`` and ``allegro_hand``)."""
