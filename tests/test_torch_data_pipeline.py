"""The port's training data path (`repro_torch.data`: `DataPipeline`,
`data.dedup`) against the reference's (`repro.data`), on the CPU: batches
equal bit for bit across steps, shards and a restore; the embedder equal;
`NearDupFilter`'s keep masks, `n_dropped` and history equal to the
reference's over a stream of batches with exact and near repeats, with the
reference's LCCS family carried across (`core.lsh.family_from_arrays`)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data import DataPipeline as RefPipeline
from repro.data import lm_token_batches as ref_batches
from repro.data.dedup import NearDupFilter as RefFilter
from repro.data.dedup import default_embedder as ref_embedder
from repro_torch.core import lsh
from repro_torch.data import DataPipeline, lm_token_batches
from repro_torch.data.dedup import NearDupFilter, default_embedder

torch.set_num_threads(2)


def _carry(fam):
    fields = {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
              for f in dataclasses.fields(fam) for v in [getattr(fam, f.name)]}
    return lsh.family_from_arrays(type(fam).__name__, fields, "cpu")


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pipeline_batches_equal_reference_across_steps_shards_and_restore(n_shards):
    for shard in range(n_shards):
        mine = DataPipeline(lm_token_batches(97, seed=3), global_batch=8, seq_len=16,
                            shard_index=shard, n_shards=n_shards)
        ref = RefPipeline(ref_batches(97, seed=3), global_batch=8, seq_len=16,
                          shard_index=shard, n_shards=n_shards)
        got = [next(mine) for _ in range(4)]
        for b in got:
            want = next(ref)
            for key in ("tokens", "labels", "mask"):
                assert b[key].dtype == want[key].dtype
                np.testing.assert_array_equal(b[key], want[key])
        assert mine.state() == ref.state() == {"step": 4}
        again = DataPipeline(lm_token_batches(97, seed=3), global_batch=8, seq_len=16,
                             shard_index=shard, n_shards=n_shards)
        again.restore({"step": 2})
        np.testing.assert_array_equal(next(again)["tokens"], got[2]["tokens"])


def test_pipeline_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="shards"):
        DataPipeline(lm_token_batches(97), global_batch=6, seq_len=4, n_shards=4)


def test_default_embedder_equals_reference():
    toks = np.random.default_rng(0).integers(0, 50_000, (9, 40)).astype(np.int32)
    np.testing.assert_array_equal(default_embedder(toks, 64), ref_embedder(toks, 64))


def _stream(rng, vocab=1000):
    """Batches of 6 documents with exact repeats of earlier ones, near
    repeats (a few tokens changed) and repeats within a batch."""
    seen, out = [], []
    for step in range(6):
        rows = []
        for i in range(6):
            kind = rng.integers(0, 4) if seen else 0
            if kind == 1:
                rows.append(seen[rng.integers(0, len(seen))].copy())
            elif kind == 2:
                doc = seen[rng.integers(0, len(seen))].copy()
                doc[rng.integers(0, doc.size, 2)] = rng.integers(0, vocab, 2)
                rows.append(doc)
            elif kind == 3 and rows:
                rows.append(rows[-1].copy())
            else:
                rows.append(rng.integers(0, vocab, 64).astype(np.int32))
        batch = np.stack(rows).astype(np.int32)
        seen.extend(batch)
        out.append(batch)
    return out


@pytest.mark.parametrize("m,threshold,history", [(32, 32, 4096), (32, 12, 4096),
                                                 (16, 6, 10)])
def test_near_dup_filter_equals_reference(m, threshold, history):
    ref = RefFilter(dim=32, m=m, threshold=threshold, history=history)
    mine = NearDupFilter(dim=32, m=m, threshold=threshold, history=history,
                         family=_carry(ref.family))
    for batch in _stream(np.random.default_rng(m + threshold)):
        np.testing.assert_array_equal(
            mine.family.hash(torch.from_numpy(default_embedder(batch, 32))).numpy(),
            np.asarray(ref.family.hash(jax.numpy.asarray(ref_embedder(batch, 32)))))
        keep = mine.filter_batch(batch)
        np.testing.assert_array_equal(keep, ref.filter_batch(batch))
        assert mine.n_dropped == ref.n_dropped
        np.testing.assert_array_equal(mine._h.numpy(), ref._h)
    assert ref.n_dropped > 0  # the stream does exercise the filter


def test_near_dup_filter_drops_duplicates():
    """The reference's own case on the port's filter, family drawn by the
    port's seed."""
    rng = np.random.default_rng(0)
    f = NearDupFilter(dim=32, m=32, threshold=32, device="cpu")  # exact-dup threshold
    base = rng.integers(0, 1000, (4, 64)).astype(np.int32)
    assert f.filter_batch(base).all()
    batch2 = np.concatenate([base[:2], rng.integers(0, 1000, (2, 64)).astype(np.int32)])
    keep2 = f.filter_batch(batch2)
    assert not keep2[0] and not keep2[1]
    assert f.n_dropped == 2


def test_pipeline_masks_dropped_rows():
    fn = lm_token_batches(97, seed=1)
    dedup = NearDupFilter(dim=32, m=32, threshold=32, device="cpu")
    pipe = DataPipeline(lambda step, b, s: fn(0, b, s), global_batch=4, seq_len=16,
                        dedup=dedup)  # the same batch every step: all repeats after the first
    first, second = next(pipe), next(pipe)
    assert first["mask"].all() and not second["mask"].any()
    assert dedup.n_dropped >= 4
