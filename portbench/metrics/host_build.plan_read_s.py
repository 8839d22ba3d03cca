"""Host-clock seconds set-up spent reading the operator's plan files into
memory (a single-table plan is put on the card inside the read): the
program's lilac.build.plan.read total in its process-wide set-up timers,
which set-up leaves in the program's module. None where the program keeps
no such total, or where set-up built the plan instead of reading it (a
checkout's first run of the cell)."""

import sys


def read(r):
    mod = sys.modules.get("lilac_tpu_torch.utils.profiling")
    build = getattr(mod, "BUILD", None)
    total = getattr(build, "total", None)
    if not isinstance(total, dict) or "lilac.build.plan.route" in total:
        return None
    return total.get("lilac.build.plan.read")
