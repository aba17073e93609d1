"""Result container mirroring ``scipy.optimize.OptimizeResult`` semantics.

PyTorch-port counterpart of :mod:`zfista_tpu.core.result`, unchanged: it is
pure Python.  Fields (superset of the reference's):

x, fun, success, message, status, nit, time, weight,
nit_internal  (accumulated inner iterations),
allvecs / allfuns / allerrs  (histories when ``return_all``).
"""

from __future__ import annotations

from typing import Any


class SolveResult(dict):
    """Dict with attribute access, like ``scipy.optimize.OptimizeResult``."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    def __repr__(self) -> str:
        if self.keys():
            width = max(map(len, self.keys())) + 1
            return "\n".join(
                f"{k.rjust(width)}: {v!r}" for k, v in sorted(self.items())
            )
        return self.__class__.__name__ + "()"


TERMINATION_MESSAGES = {
    0: "Maximum number of iterations reached",
    1: "Optimization terminated successfully",
    # status 2 = line-search failure; "Error: " prefix matches the
    # reference's partial-result message format.
    2: "Error: Backtracking failed to find a suitable stepsize.",
}
