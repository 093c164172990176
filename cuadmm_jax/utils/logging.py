"""Iteration-table logging in the reference's format.

Reference prints a row every 50 iterations up to 200 then every 100
(src/solver.cu:429-444) and a final summary block (src/solver.cu:445-461).
We print on the same cadence, evaluated at chunk boundaries.
"""

from __future__ import annotations

import numpy as np


class IterLogger:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._next_print = 1

    def header(self, norm_Corg: float, norm_borg: float) -> None:
        if not self.enabled:
            return
        print("\n " + "-" * 79)
        print("                                  cuADMM-JAX")
        print(" " + "-" * 79)
        print(f" norm of C = {norm_Corg:2.1e}, norm of b = {norm_borg:2.1e}\n")
        print("  it. | p infeas d infeas | primal obj.   dual obj. rel. gap |  time |   sigma | ")
        print(" " + "-" * 79)

    def row(self, it: int, state, seconds: float = 0.0) -> None:
        if not self.enabled:
            return
        print(
            f" {it:4d} | {float(state.errRp):3.2e} {float(state.errRd):3.2e} |"
            f" {float(state.pobj): 5.4e} {float(state.dobj): 5.4e} {float(state.relgap):3.2e} |"
            f" {seconds:5.1f} | {float(state.sig):2.1e} |"
        )

    def maybe_row(self, it: int, info_row: np.ndarray, seconds: float) -> None:
        """info_row = (pobj, dobj, errRp, errRd, relgap, sig, bscale, Cscale)."""
        if not self.enabled or it < self._next_print:
            return
        pobj, dobj, errRp, errRd, relgap, sig = info_row[:6]
        print(
            f" {it:4d} | {errRp:3.2e} {errRd:3.2e} |"
            f" {pobj: 5.4e} {dobj: 5.4e} {relgap:3.2e} |"
            f" {seconds:5.1f} | {sig:2.1e} |"
        )
        while self._next_print <= it:
            self._next_print += 50 if self._next_print <= 200 else 100

    def footer(self, result) -> None:
        if not self.enabled:
            return
        print("\n " + "-" * 79 + "\n")
        print(result.message)
        print(
            f"\n primal infeasibility = {result.errRp:2.1e}"
            f"\n dual   infeasibility = {result.errRd:2.1e}"
            f"\n relative gap         = {result.relgap:2.1e}"
            f"\n primal objective = {result.pobj: 9.8e}"
            f"\n dual   objective = {result.dobj: 9.8e}"
        )
        per_it = result.total_time / max(result.iterations, 1)
        print(
            f"\n time per iteration = {per_it:2.4f}s"
            f"\n total time         = {result.total_time:2.1f}s"
        )
        print("\n " + "-" * 79 + "\n")
