from .pbt import PbtAlgoObserver, PbtParams, initial_pbt_check  # noqa: F401
from .mutation import mutate  # noqa: F401
