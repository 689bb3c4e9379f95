"""The numbers that decide ``correct``, each beside its limit."""

from __future__ import annotations

import statistics
from typing import Dict, List, NamedTuple, Optional

import torch


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit   # NaN fails


def checks(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """One check for each limit; a limit without its number is a fault of
    the harness."""
    missing = sorted(set(limits) - set(values))
    if missing:
        raise KeyError(f'no reading for the limit(s) {missing}')
    return [Check(k, float(values[k]), float(limits[k])) for k in limits]


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def norm_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger (``keep``: the leaves counted)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].double().norm()) for k in names}
    med = statistics.median(rn.values())
    return {k: abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
            for k in names}


def diff_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
              ) -> Dict[str, float]:
    """Each leaf's norm of the difference between the program and the
    reference, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    rn = {k: float(ref[k].double().norm()) for k in ref}
    med = statistics.median(rn.values())
    return {k: float((prog[k].double().reshape(ref[k].shape)
                      - ref[k].double()).norm()) / max(rn[k], med)
            for k in ref}
