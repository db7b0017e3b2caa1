"""LCCS-LSH near-duplicate filtering for the training data path (port of
`repro.data.dedup`): the paper's index as a pipeline stage.

Documents are embedded (a hashed bag of tokens by default), hashed with the
angular LCCS family (the pseudo rotation, plain torch), and a row is dropped
when its LCCS length against the recent history reaches a threshold: close
embeddings share long circular runs of hash values w.h.p., the paper's
insight used in reverse as a similarity detector.  The history check runs on
the filter's device through `core.bruteforce.circ_topk` -- on the card the
`circrun` scorer and `circrun_topk` kernels, one top-1 a row of the batch;
the within-batch check stays on the host, as the reference's."""
from __future__ import annotations

import numpy as np
import torch

from ..core.bruteforce import circ_topk
from ..core.device import resolve_device
from ..core.lsh import make_family


def default_embedder(tokens: np.ndarray, dim: int = 64) -> np.ndarray:
    """Cheap order-insensitive document embedding: hashed bag of tokens."""
    n, _ = tokens.shape
    out = np.zeros((n, dim), np.float32)
    cols = (tokens.astype(np.int64) * 2654435761 % dim).astype(np.int64)
    for i in range(n):
        np.add.at(out[i], cols[i], 1.0)
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-6)


class NearDupFilter:
    """`family`: an angular LCCS family to hash with (e.g. the reference's,
    carried across by `core.lsh.family_from_arrays`); else one drawn from
    `seed` by the port's own generator (not the reference's draw) on
    `device` (None = CUDA; raises without it).  The filter runs on the
    family's device."""

    def __init__(
        self,
        *,
        dim: int = 64,
        m: int = 32,
        threshold: int | None = None,
        history: int = 4096,
        seed: int = 0,
        embedder=default_embedder,
        family=None,
        device=None,
    ):
        self.family = (family if family is not None
                       else make_family("angular", seed, dim, m, device=resolve_device(device)))
        self.device = self.family.device
        self.m = m
        self.dim = dim
        self.threshold = threshold if threshold is not None else max(4, m // 2)
        self.history = history
        self.embedder = embedder
        self._h = torch.zeros((0, m), dtype=torch.int32, device=self.device)
        self.n_dropped = 0

    def filter_batch(self, tokens: np.ndarray) -> np.ndarray:
        """Returns the keep mask (B,) bool; adds the kept rows to the
        history."""
        emb = torch.from_numpy(self.embedder(tokens, self.dim)).to(self.device)
        h_dev = self.family.hash(emb)
        keep = np.ones(h_dev.shape[0], bool)
        if self._h.shape[0] and h_dev.shape[0]:
            best, _ = circ_topk(self._h, h_dev, 1)  # each row's longest run over the history
            keep = best[:, 0].cpu().numpy() < self.threshold
        h = h_dev.cpu().numpy()
        # also drop within-batch duplicates (later occurrence loses)
        for i in range(h.shape[0]):
            if not keep[i]:
                continue
            for j in range(i):
                if keep[j]:
                    e = np.concatenate([h[i] == h[j], h[i] == h[j]])
                    run = best_run = 0
                    for v in e:
                        run = run + 1 if v else 0
                        best_run = max(best_run, run)
                    if min(best_run, self.m) >= self.threshold:
                        keep[i] = False
                        break
        self.n_dropped += int((~keep).sum())
        kept = h_dev[torch.from_numpy(keep).to(self.device)]
        self._h = torch.cat([self._h, kept])[-self.history:]
        return keep
