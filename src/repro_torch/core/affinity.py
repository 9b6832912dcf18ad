"""Affinity calibration from the characterization database (paper §5.2).

The trade-off between aligning DP vs PP groups depends on model config and
GPU type (§4, Appendix E).  LPJs are pre-characterized: the database stores,
per profiled job, the fingerprint ratios

    r1 = mb * v_w / (v_d + v_p)     (computation-to-communication)
    r2 = v_d / v_p                  (DP-to-PP volume)

together with the measured improvements of DP-aligned / PP-aligned placement
``(j_dp, j_pp)``.  Online scheduling finds the nearest profiled job by
Euclidean distance in (r1, r2) and derives

    alpha = j_dp / (j_dp + j_pp),   beta = j_pp / (j_dp + j_pp).

The shipped database is seeded with the paper's published data points
(24B dense / 24B MoE on H800; 7B / 14B dense on L20, Appendix E Table 2).
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

from repro_torch.core.comm_matrix import CommMatrix


@dataclasses.dataclass(frozen=True)
class CharRecord:
    """One pre-characterization entry: <GPU_type, j_dp, j_pp> plus ratios."""

    gpu_type: str
    model_name: str
    r1: float
    r2: float
    j_dp: float  # % improvement of DP-aligned placement over worst
    j_pp: float  # % improvement of PP-aligned placement over worst
    unit: str = "pp"  # scheduling unit chosen for this profile

    def affinity(self) -> tuple[float, float]:
        tot = self.j_dp + self.j_pp
        if tot <= 0:
            return 0.5, 0.5
        return self.j_dp / tot, self.j_pp / tot


# Paper-published calibration points.  r1/r2 are recomputed from the
# analytical model for representative configs;
# j_dp/j_pp come from §4 (Fig. 5a) and Appendix E (Table 2).
_PAPER_SEED = [
    # H800: 24B dense -- PP dominates ("alpha set to zero"); dp-aligned no
    # speedup, pp-aligned +2.3%.
    CharRecord("H800", "dense-24b", r1=180.0, r2=60.0, j_dp=0.0, j_pp=2.3),
    # H800: 24B MoE -- alpha=0.3 / beta=0.7 in the paper.
    CharRecord("H800", "moe-24b", r1=40.0, r2=25.0, j_dp=0.3, j_pp=0.7),
    # L20 (Ada Lovelace, fp8 activations halve PP volume): 7B dense,
    # DP-aligned wins by 1.4%.
    CharRecord("L20", "dense-7b", r1=120.0, r2=130.0, j_dp=1.4, j_pp=0.0),
    # L20: 14B dense, PP-aligned wins by 0.5%.
    CharRecord("L20", "dense-14b", r1=150.0, r2=90.0, j_dp=0.0, j_pp=0.5),
]


class CharacterizationDB:
    """Nearest-neighbour lookup over profiled jobs (Euclidean in (r1, r2))."""

    def __init__(self, records: list[CharRecord] | None = None):
        self.records: list[CharRecord] = list(records) if records else list(_PAPER_SEED)

    def add(self, rec: CharRecord) -> None:
        self.records.append(rec)

    def lookup(self, r1: float, r2: float, gpu_type: str | None = None) -> CharRecord:
        cands = [
            r for r in self.records if gpu_type is None or r.gpu_type == gpu_type
        ] or self.records
        return min(
            cands, key=lambda r: math.hypot(r.r1 - r1, r.r2 - r2)
        )

    def affinity_for(self, comm: CommMatrix) -> tuple[float, float, str]:
        """(alpha, beta, scheduling_unit) for a job's communication matrix."""
        r1, r2 = comm.ratios()
        rec = self.lookup(r1, r2, comm.job.gpu_type)
        a, b = rec.affinity()
        return a, b, rec.unit

    # Persistence -- the paper stores characterization results in a database
    # consulted during online scheduling.
    def save(self, path: str | pathlib.Path) -> None:
        data = [dataclasses.asdict(r) for r in self.records]
        pathlib.Path(path).write_text(json.dumps(data, indent=2))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "CharacterizationDB":
        data = json.loads(pathlib.Path(path).read_text())
        return cls([CharRecord(**r) for r in data])
