"""seed_draw_ms.fit: one k-means++ draw of the traced fits (its weights to the
host, the draw, the next distance pass enqueued), in ms, from the mean of the
program's ``span.seed.draw`` histogram. None off the card, whose route it
times, and where the program keeps no such histogram."""
from repro_torch import obs


def read(run):
    if run.mix["kind"] != "fit" or not run.on_card:
        return None
    draw = obs.snapshot("span.seed.draw").get("span.seed.draw")
    return 1e3 * draw["mean"] if draw and draw["count"] else None
