"""What decides ``correct``: every solve the run made on its timed path is
held, once the window has closed, to the guarantee its configuration
states, by the plain reference (:mod:`portbench.reference.residual`)."""

from __future__ import annotations

import math

from portbench.reference.residual import relative_residual


def check_solves(A, requests, solved, limit: float) -> dict:
    """``solved``: ``(request row, solution)`` pairs.  Returns the worst
    true relative residual (``inf`` when a solution is not finite), the
    number of solves checked, the number above ``limit``, and each
    solve's residual."""
    worst, failed, each = 0.0, 0, []
    for row, x in solved:
        r = relative_residual(A, requests[row], x)
        if not r <= limit:
            failed += 1
        worst = r if math.isnan(r) or r > worst else worst
        each.append(r)
    return {"rel_residual_max": worst, "checked": len(solved),
            "failed": failed, "residuals": each}
