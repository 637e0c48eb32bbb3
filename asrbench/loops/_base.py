"""The defaults of a loop (see `loops/__init__.py`)."""

from __future__ import annotations

from typing import Dict, List


class Loop:
    PRECISION = ""
    SPANS: tuple = ()
    NEAR_END = False
    min_calls = 1

    def near_end(self, i: int) -> None:
        pass

    def report(self, latencies: List[float], log) -> None:
        pass

    def after_window(self, spans) -> None:
        pass

    def fault_numbers(self, params) -> Dict[str, Dict]:
        return {}

    def leave(self) -> List[tuple]:
        """(card, peak memory bytes) of each rank but this process's, once
        they have left the group and ended: none for a loop of one
        process."""
        return []

    def close(self) -> None:
        pass

    def precision(self, which: str = "reference_precision"):
        return self.cell.config[which][self.PRECISION]
