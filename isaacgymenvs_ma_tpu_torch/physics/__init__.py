"""Physics of the port: the engine and the CUDA kernels B1-B5 with their
plain twins.  ``KERNEL_WRAPPERS`` maps each kernel's name to its
dispatching wrapper (each counts its launches in ``.launches``)."""
from .contact_kernel import solve as _contact_solve
from .dyn_kernel import dyn_cached, dyn_forward, fk_motion
from .spd_kernel import sweep_inverse

KERNEL_WRAPPERS = {
    "fk_motion": fk_motion,
    "dyn_forward": dyn_forward,
    "dyn_cached": dyn_cached,
    "contact_solve": _contact_solve,
    "spd_inverse": sweep_inverse,
}
