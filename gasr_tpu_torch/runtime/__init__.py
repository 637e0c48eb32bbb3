from gasr_tpu_torch.runtime.memory import MemoryMonitor  # noqa: F401
from gasr_tpu_torch.runtime.timer import CycleTimer, Timer  # noqa: F401
