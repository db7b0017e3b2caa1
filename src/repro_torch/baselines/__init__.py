"""The paper's comparison set (§6.3), PyTorch port of `repro.baselines`.

  * LinearScan        -- exact ground truth.
  * E2LSH             -- static concatenating framework (Indyk/Datar):
                         L tables of K concatenated functions.
  * MultiProbeLSH     -- E2LSH tables + Lv et al. probing sequence.
  * FALCONNLike       -- cross-polytope static tables + vertex probing.
  * C2LSH             -- dynamic collision counting framework (Gan et al.).

All share the LSH families of `repro_torch.core.lsh` and the same verify
(`core.index.verify_candidates`), so differences isolate the *search
framework*.  `build` places a method on CUDA unless the caller passes
device="cpu", and raises without CUDA.
"""
from .methods import C2LSH, E2LSH, FALCONNLike, LinearScan, MultiProbeLSH

__all__ = ["C2LSH", "E2LSH", "FALCONNLike", "LinearScan", "MultiProbeLSH"]
