"""Multi-item running average meter (reference: utils/average_meter.py:9-50)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

Number = Union[int, float]


class AverageMeter:
    """Tracks val/sum/count/avg for one or several items at once.

    Mirrors the reference semantics: constructed either empty (single item)
    or with a list of item names; ``update`` accepts a scalar or a list.
    """

    def __init__(self, items: Optional[Sequence[str]] = None):
        self.items = list(items) if items is not None else None
        self.n_items = 1 if items is None else len(items)
        self.reset()

    def reset(self) -> None:
        self._val: List[float] = [0.0] * self.n_items
        self._sum: List[float] = [0.0] * self.n_items
        self._count: List[int] = [0] * self.n_items

    def update(self, values: Union[Number, Sequence[Number]]) -> None:
        if isinstance(values, (list, tuple)):
            for i, v in enumerate(values):
                self._val[i] = float(v)
                self._sum[i] += float(v)
                self._count[i] += 1
        else:
            self._val[0] = float(values)
            self._sum[0] += float(values)
            self._count[0] += 1

    def val(self, idx: Optional[int] = None):
        if self.n_items == 1 and idx is None:
            return self._val[0]
        return self._val if idx is None else self._val[idx]

    def count(self, idx: Optional[int] = None):
        if self.n_items == 1 and idx is None:
            return self._count[0]
        return self._count if idx is None else self._count[idx]

    def avg(self, idx: Optional[int] = None):
        avgs = [s / c if c else 0.0 for s, c in zip(self._sum, self._count)]
        if self.n_items == 1 and idx is None:
            return avgs[0]
        return avgs if idx is None else avgs[idx]
