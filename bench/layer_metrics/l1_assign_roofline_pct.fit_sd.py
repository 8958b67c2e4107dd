"""l1_assign_roofline_pct.fit_sd: the traced SD fits' l1 assignments, counted
by ``bench/work/l1.py`` at the chip's peaks, over the device time of the
assign kernel's l1 instantiation (``assign_kernel<true, ...>``) in the
profiler's trace, in %. None off the card, for other traffic, and unless
the program's ``launch.apnc_assign.l1`` counter counted one launch a pass
(iterations + the final assignment) in each traced fit: the count then
covers exactly the launches the trace holds."""
import re

from bench.work import l1

L1_ASSIGN = re.compile(r"assign_kernel<\s*true\s*,")


def read(run):
    if run.mix["kind"] != "fit_sd" or not run.on_card or run.trace is None or not run.traced:
        return None
    if any(c.l1_launches != c.passes for c in run.traced):
        return None
    seconds = sum(s for name, s in run.trace.ops.items() if L1_ASSIGN.search(name))
    if seconds <= 0:
        return None
    n, m, k = (run.cfg[key] for key in ("n", "m", "k"))
    one = l1.assign(n, m, k).bound_s(run.cfg["precision"])
    return 100.0 * sum(c.passes * one for c in run.traced) / seconds
