"""host_view_s.fit: phase 1's copy of X to host float32, wall seconds a traced
fit, from the mean of the program's ``span.host_view.copy`` histogram. None
off the card, whose route it times, and where the program keeps no such
histogram."""
from repro_torch import obs


def read(run):
    if run.mix["kind"] != "fit" or not run.on_card:
        return None
    copy = obs.snapshot("span.host_view.copy").get("span.host_view.copy")
    return copy["mean"] if copy and copy["count"] else None
