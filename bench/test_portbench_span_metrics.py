"""The per-layer metrics read from the program's span histograms: each reader
returns the mean that the histograms were given, and None off the card, for
the other kind of traffic, and where a histogram it reads is empty."""
import pytest

from bench.harness.runner import RunView, reader
from repro_torch import obs

# metric, its traffic's kind, the seconds observed by histogram, the reading
CASES = [
    ("predict_host_ms.predict", "predict",
     {"span.predict": [3e-3, 5e-3], "span.predict.wait": [1e-3, 2e-3]}, 2.5),
    ("host_view_s.fit", "fit", {"span.host_view.copy": [2.0, 2.4]}, 2.2),
    ("seed_draw_ms.fit", "fit", {"span.seed.draw": [4e-4, 6e-4, 5e-4]}, 0.5),
]
IDS = [c[0] for c in CASES]
OTHER = {"predict": "fit", "fit": "predict"}


@pytest.fixture(autouse=True)
def _empty_span_histograms():
    obs.reset_metrics("span.")
    yield
    obs.reset_metrics("span.")


def _view(kind: str, on_card: bool = True) -> RunView:
    return RunView(cfg={}, mix={"kind": kind}, traffic=None, calls=[], traced=[],
                   trace=None, on_card=on_card)


def _observe(observed: dict) -> None:
    for name, values in observed.items():
        for v in values:
            obs.histogram(name).observe(v)


@pytest.mark.parametrize("metric, kind, observed, want", CASES, ids=IDS)
def test_reads_the_mean_given(metric, kind, observed, want):
    _observe(observed)
    assert reader(metric)(_view(kind)) == pytest.approx(want)


@pytest.mark.parametrize("metric, kind, observed, want", CASES, ids=IDS)
def test_none_off_the_card(metric, kind, observed, want):
    _observe(observed)
    assert reader(metric)(_view(kind, on_card=False)) is None


@pytest.mark.parametrize("metric, kind, observed, want", CASES, ids=IDS)
def test_none_for_the_other_kind(metric, kind, observed, want):
    _observe(observed)
    assert reader(metric)(_view(OTHER[kind])) is None


@pytest.mark.parametrize("metric, kind, observed, want", CASES, ids=IDS)
def test_none_on_an_empty_histogram(metric, kind, observed, want):
    read = reader(metric)
    assert read(_view(kind)) is None
    # each histogram it reads, left empty while the others hold observations
    for empty in observed:
        _observe({name: v for name, v in observed.items() if name != empty})
        assert read(_view(kind)) is None
        obs.reset_metrics("span.")
