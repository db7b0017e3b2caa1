"""The paper's own workload configs (copy of `repro.configs.lccs_ann`): ANN
index settings matched to the five SIGMOD'20 datasets (synthetic analogues).
w values are the paper's fine-tuned bucket widths (footnote 11)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class ANNConfig:
    name: str
    n: int
    d: int
    metric: str
    m: int = 64
    w: float = 4.0  # random-projection bucket width (Euclidean only)


DATASETS = {
    "msong": ANNConfig("msong", 992_272, 420, "euclidean", w=18.75),
    "sift": ANNConfig("sift", 1_000_000, 128, "euclidean", w=226.0),
    "gist": ANNConfig("gist", 1_000_000, 960, "euclidean", w=11294.0),
    "glove": ANNConfig("glove", 1_183_514, 100, "euclidean", w=4.65),
    "deep": ANNConfig("deep", 1_000_000, 256, "euclidean", w=0.66),
    # angular variants (cross-polytope family)
    "sift-angular": ANNConfig("sift-angular", 1_000_000, 128, "angular"),
    "glove-angular": ANNConfig("glove-angular", 1_183_514, 100, "angular"),
}
