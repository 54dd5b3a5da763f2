"""The paper's own experimental configuration (§VI).

Copy of ``repro/configs/paper_anm.py``.  8-parameter Sagittarius-stream +
background MLE over SDSS stripe data; 1000 evaluations per regression
phase and 1000 per line-search phase.  ``repro_torch.data.sdss``
generates the synthetic star catalogs ("stripes").
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class AnmPaperConfig:
    n_params: int = 8
    regression_points: int = 1000       # paper: 1000 per regression phase
    line_search_points: int = 1000      # paper: 1000 per line-search phase
    n_stars: int = 100_000              # paper: 92k-112k stars per stripe
    max_iterations: int = 20            # paper: stripe 79 -> 5, stripe 86 -> 20
    alpha_min: float = 0.0
    alpha_max: float = 2.0
    # volunteer grid shape (MilkyWay@Home ~35k hosts; simulator default smaller)
    n_hosts: int = 2048
    host_failure_prob: float = 0.05
    host_malicious_prob: float = 0.01
    validation_quorum: int = 2


CONFIG = AnmPaperConfig()


def smoke() -> AnmPaperConfig:
    return AnmPaperConfig(
        n_params=4, regression_points=64, line_search_points=64,
        n_stars=2_000, max_iterations=6, n_hosts=64,
    )
