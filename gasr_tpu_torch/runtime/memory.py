"""MemoryMonitor: device and host memory accounting (the port's copy of
`gasr_tpu/runtime/memory.py`, the reference's MemoryMonitor singleton,
MemoryMonitor.h:9-28).

On the card the caching allocator keeps the books: `device_stats` reads
`torch.cuda.memory_stats` (allocated bytes now and at peak) and the
card's total memory, `live_device_bytes` `torch.cuda.memory_allocated`,
and `live_array_table` lists the live CUDA tensors the garbage collector
can see. A monitor made for the CPU (`MemoryMonitor(device="cpu")`)
reports zeros and makes no CUDA call.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Optional

import torch


class MemoryMonitor:
    """Singleton matching the reference's instance() pattern
    (MemoryMonitor.h:12)."""

    _instance: Optional["MemoryMonitor"] = None

    def __init__(self, device: str = "cuda") -> None:
        self.device = torch.device(device)

    @classmethod
    def instance(cls) -> "MemoryMonitor":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def _cuda(self, device=None) -> Optional[torch.device]:
        dev = torch.device(device) if device is not None else self.device
        return dev if dev.type == "cuda" else None

    # ---- device side (gpuMalloc/printGpuMemory equivalents) ----

    def device_stats(self, device=None) -> Dict[str, int]:
        dev = self._cuda(device)
        if dev is None:
            return {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                    "bytes_limit": 0}
        stats = torch.cuda.memory_stats(dev)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev).total_memory),
        }

    def live_device_bytes(self, device=None) -> int:
        """Bytes the caching allocator holds for live tensors (this
        process)."""
        dev = self._cuda(device)
        return 0 if dev is None else int(torch.cuda.memory_allocated(dev))

    def live_array_table(self, top: int = 20) -> List[Dict]:
        """The largest live CUDA tensors the garbage collector tracks."""
        if self._cuda() is None:
            return []
        rows = []
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) and obj.is_cuda:
                    rows.append({"shape": tuple(obj.shape),
                                 "dtype": str(obj.dtype),
                                 "nbytes": obj.nelement()
                                 * obj.element_size()})
            except Exception:   # objects that fail isinstance checks
                continue
        rows.sort(key=lambda r: -r["nbytes"])
        return rows[:top]

    # ---- reporters (printCpuMemory/printGpuMemory equivalents,
    #      MemoryMonitor.h:19-20) ----

    def print_device_memory(self) -> None:
        s = self.device_stats()
        live = self.live_device_bytes()
        print(f"[MemoryMonitor] device bytes_in_use={s['bytes_in_use']:,} "
              f"peak={s['peak_bytes_in_use']:,} limit={s['bytes_limit']:,} "
              f"live_tensors={live:,}")

    def print_host_memory(self) -> None:
        import resource
        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(f"[MemoryMonitor] host peak_rss={peak_kb * 1024:,} bytes")

    def report(self) -> Dict:
        return {"device": self.device_stats(),
                "live_device_bytes": self.live_device_bytes()}
