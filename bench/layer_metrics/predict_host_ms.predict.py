"""predict_host_ms.predict: a traced predict call's host time outside its one
wait for the card, in ms: the mean of the program's ``span.predict`` histogram
less the mean of its ``span.predict.wait``. None off the card, whose route it
times, and where the program keeps no such histograms."""
from repro_torch import obs


def read(run):
    if run.mix["kind"] != "predict" or not run.on_card:
        return None
    spans = obs.snapshot("span.predict")
    call, wait = spans.get("span.predict"), spans.get("span.predict.wait")
    if not call or not wait or not call["count"] or not wait["count"]:
        return None
    return 1e3 * (call["mean"] - wait["mean"])
