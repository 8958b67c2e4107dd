"""sd_directions_ms.fit_sd: APNC-SD's directions in the traced fits (the draws
of S on the host, its copy to the card and the product S E H / sqrt(t)
enqueued), in ms, from the mean of the program's ``span.sd.directions``
histogram. None off the card, whose route it times, and where the program
keeps no such histogram."""
from repro_torch import obs


def read(run):
    if run.mix["kind"] != "fit_sd" or not run.on_card:
        return None
    span = obs.snapshot("span.sd.directions").get("span.sd.directions")
    return 1e3 * span["mean"] if span and span["count"] else None
