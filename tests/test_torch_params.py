"""Port parity: `repro_torch.core.params.SearchParams` has the reference's
fields, defaults, derived width and validation."""
import dataclasses
import warnings

import pytest
import torch

from repro.core.params import SearchParams as RefParams
from repro.core.params import WindowWidthWarning as RefWarning
from repro_torch.core.params import SearchParams, WindowWidthWarning

torch.set_num_threads(2)


def test_fields_and_defaults_match_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(SearchParams)]
    ref = [(f.name, f.default) for f in dataclasses.fields(RefParams)]
    assert ours == ref
    assert len(ours) == 16


@pytest.mark.parametrize("lam,width", [(1, None), (10, None), (64, None), (100, 100),
                                       (200, 64), (3, 2), (500, None)])
def test_resolved_width_and_warning_match(lam, width):
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        ref = RefParams(lam=lam, width=width)
    with warnings.catch_warnings(record=True) as w_ours:
        warnings.simplefilter("always")
        ours = SearchParams(lam=lam, width=width)
    assert ours.resolved_width() == ref.resolved_width()
    assert ([issubclass(x.category, WindowWidthWarning) for x in w_ours]
            == [issubclass(x.category, RefWarning) for x in w_ref])


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(lam=0), dict(probes=0), dict(skip_budget=0), dict(rerank_mult=0),
    dict(mode="bruteforce"), dict(width=0), dict(inner="segmented"), dict(shards=0),
])
def test_validation_matches(bad):
    with pytest.raises(ValueError):
        RefParams(**bad)
    with pytest.raises(ValueError):
        SearchParams(**bad)


@pytest.mark.parametrize("legacy", [
    dict(k=5, lam=50), dict(mode="bruteforce"), dict(probes=9),
    dict(probes=9, mode="narrowed"), dict(width=8, metric="angular"),
])
def test_from_legacy_and_replace_match(legacy):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RefWarning)
        warnings.simplefilter("ignore", WindowWidthWarning)
        ref = RefParams.from_legacy(**legacy)
        ours = SearchParams.from_legacy(**legacy)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert dataclasses.asdict(ours.replace(k=3)) == dataclasses.asdict(ref.replace(k=3))
    with pytest.raises(TypeError):
        SearchParams.from_legacy(bogus=1)
